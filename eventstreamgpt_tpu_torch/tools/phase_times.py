"""Wall seconds a phase of a ``chip_smoke.py`` run.

`time_phases` wraps every function of a module's namespace whose name ends
in ``_phase`` or ``_profiles``, so that each call adds its wall seconds to
``seconds[name]``; a call made inside another wrapped call counts only in
the outer one. ``chip_smoke.py`` applies it to itself and prints the
result. Run as a script, it times another copy of the smoke script (an
older commit's, say), which need not time itself:

    python3 eventstreamgpt_tpu_torch/tools/phase_times.py OTHER/chip_smoke.py

It prints that script's own output, then a line ``phase seconds {...}``
with the rest of its ``main()`` under ``"other"``, and exits with
``main()``'s code. This file imports only the standard library, so the
timed copy imports the package that lies beside it.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import sys
import time


def time_phases(namespace: dict, seconds: dict) -> None:
    """Replaces the phase functions of ``namespace`` by timed wrappers that
    add into ``seconds`` (a function already wrapped is left alone)."""
    depth = [0]

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

        run.timed_phase = True
        return run

    for name, fn in list(namespace.items()):
        if inspect.isfunction(fn) and name.endswith(("_phase", "_profiles")) and not hasattr(fn, "timed_phase"):
            namespace[name] = timed(name, fn)


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print("usage: phase_times.py PATH/chip_smoke.py", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", argv[0])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    seconds: dict = {}
    time_phases(vars(module), seconds)
    t0 = time.perf_counter()
    rc = module.main()
    seconds["other"] = time.perf_counter() - t0 - sum(seconds.values())
    print(f"phase seconds {json.dumps({k: round(v, 2) for k, v in seconds.items()})}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
