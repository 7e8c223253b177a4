"""Does a row's result depend on how many rows share its batch? Per operation, on one device.

The serving engine runs a request's prefill in a group of rows (the group
width) and its decode steps over all of an engine's slots. Every operation
of those programs is meant to be row-local, so a request's events should not
depend on the group width or the slot count; in floating point they can,
where a library picks its algorithm (its reduction order) by the shapes it
is given. This tool finds where.

It builds the serving benchmark's CI model (`data.synthetic.serving_config`,
numpy-seeded random weights, seed 0) behind a greedy `GenerationEngine`,
in bf16 and again in fp32 (the same weights), and makes ``--rows`` prompt
rows of ``--length`` real events (`data.synthetic.synthetic_prompt_batch`).
Then, for each precision:

* prefill, each power-of-two group width from 2 to ``--rows`` against 1:
  the model's cached forward of a group of rows
  (`GenerationEngine._prompt_forward`), as the engine's prefill groups of
  that width run it, against each of its rows alone;
* one decode step, ``--rows`` slots against half as many: the one-event
  view of each row's last prompt event with its time
  (`generation_utils._trim_to_event`), the input layer, kernel B
  (`ops.decode_step.decode_stack_step`) on caches holding the rows' other
  events, ``ln_f`` and the output layer, on all rows and on the first half;
  and kernel B alone on the first half of the full run's inputs.

For each, under a `torch.overrides.TorchFunctionMode`, every operation whose
inputs and float outputs lead with the batch's rows runs again on the first
rows alone (the in-place ones excepted), and the tool reports the operations
whose rows differ (by name, input shapes and type: calls, calls that differ,
the largest difference and the output's largest magnitude). Kernel B runs
outside that mode (a foreign call); its rows are compared directly. Last, it
compares what the engine takes from the two runs: every float of the
predictions at the row's last event (largest difference) and the greedy
draws (`generation.sampling.sample_head_draws`): the rows with another
decision (a categorical or Bernoulli draw) and the largest difference of the
drawn values.

Run on the card (the default) or, at a small size, on the CPU::

    python3 -m eventstreamgpt_tpu_torch.tools.row_invariance [--device cpu] [--rows 32] [--length 192]

It prints one JSON object a precision, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from ..convert import init_params_from_seed
from ..data.synthetic import log_time_stats, serving_config, synthetic_prompt_batch, synthetic_prompts
from ..generation.generation_utils import _slice_preds_at, _trim_to_event
from ..generation.sampling import sample_head_draws
from ..models.ci_model import CIPPTForGenerativeSequenceModeling
from ..ops.decode_step import decode_stack_step
from ..serving import GenerationEngine
from ..serving.engine import _named_floats

__all__ = ["RowCheck", "row_invariance", "main"]


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if torch.is_tensor(x)]


class RowCheck(TorchFunctionMode):
    """Runs each operation whose tensor inputs include one of ``rows`` rows,
    and whose outputs are all such, again on the first ``first`` rows of
    those inputs (of the wider ones where a 1-D input would broadcast), and
    records per (name, input shapes, output type) the calls, the calls whose
    first rows differ (NaNs equal to NaNs), the largest difference and the
    largest magnitude of those rows. In-place operations (a name ending in
    ``_``, ``__setitem__``, an ``out=``) are not rerun."""

    def __init__(self, rows: int, first: int):
        super().__init__()
        self.rows, self.first, self.seen = rows, first, {}

    def _leads(self, x) -> bool:
        return torch.is_tensor(x) and x.dim() > 0 and x.shape[0] == self.rows

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = getattr(func, "__name__", str(func))
        if name.endswith("_") or name in ("__setitem__", "__set__") or "out" in kwargs:
            return out
        inputs, outputs = _tensors((args, kwargs)), _tensors(out)
        if not any(self._leads(x) for x in inputs) or not outputs:
            return out
        if not all(self._leads(o) for o in outputs) or not any(o.is_floating_point() for o in outputs):
            return out
        # A 1-D input beside wider ones that lead with the rows is a vector
        # broadcast along the last axis (a bias), not a row's value.
        wide = any(self._leads(x) and x.dim() > 1 for x in inputs)
        cut = lambda x: x[: self.first] if self._leads(x) and not (wide and x.dim() == 1) else x  # noqa: E731
        try:
            small = _tensors(func(*tree_map(cut, args), **tree_map(cut, kwargs)))
        except Exception:  # an operation whose other inputs also lead with `rows` by chance
            return out
        key = (name, tuple(tuple(x.shape) for x in inputs), str(outputs[0].dtype))
        rec = self.seen.setdefault(key, dict(calls=0, differ=0, max_abs=0.0, magnitude=0.0))
        rec["calls"] += 1
        for o, s in zip(outputs, small):
            if not o.is_floating_point() or s.shape != o[: self.first].shape:
                continue
            a, b = o[: self.first].float(), s.float()
            if not torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)):
                rec["differ"] += 1
                rec["max_abs"] = max(rec["max_abs"], _max_abs(a, b))
            finite = a[torch.isfinite(a)]
            rec["magnitude"] = max(rec["magnitude"], float(finite.abs().max()) if finite.numel() else 0.0)
        return out

    def report(self) -> dict:
        differing = [dict(op=k[0], input_shapes=[list(s) for s in k[1]], dtype=k[2], **v)
                     for k, v in self.seen.items() if v["differ"]]  # fmt: skip
        return dict(ops_checked=len(self.seen), calls_checked=sum(v["calls"] for v in self.seen.values()),
                    ops_differing=sorted(differing, key=lambda r: -r["max_abs"]))  # fmt: skip


def _max_abs(a, b) -> float:
    d = (a.float() - b.float()).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def _compare_outputs(pairs) -> dict:
    """Pairs of prediction sets at one event, each pair with the same rows:
    the largest difference of every float, and of the greedy draws: the
    rows with another decision (a categorical's or a Bernoulli's draw) and
    the largest difference of the drawn values (time to event,
    regression)."""
    floats, rows, differ, float_draws = {}, 0, 0, 0.0
    for preds_a, preds_b in pairs:
        for (name, a), (_, b) in zip(_named_floats(preds_a), _named_floats(preds_b)):
            floats[name] = max(floats.get(name, 0.0), _max_abs(a, b))
        da, db = sample_head_draws(preds_a, None, greedy=True), sample_head_draws(preds_b, None, greedy=True)
        n = next(iter(da.values())).shape[0]
        other = torch.zeros(n, dtype=torch.bool, device=next(iter(da.values())).device)
        for k in da:
            if k == "tte" or k.startswith("reg:"):  # values; the rest are decisions (a Bernoulli's in floats)
                float_draws = max(float_draws, _max_abs(da[k], db[k]))
            else:
                other |= (da[k] != db[k]).reshape(n, -1).any(dim=1)
        rows, differ = rows + n, differ + int(other.sum())
    return dict(pred_floats_max_abs=floats, rows_with_other_decisions=differ, rows_compared=rows,
                float_draws_max_abs=float_draws)  # fmt: skip


def _prefill(engine, batch, group: int, first: int) -> dict:
    """Group width ``group`` against ``first``: the cached forward of the
    first ``group`` rows, op by op against its first ``first`` rows; then
    those rows run as a group of their own (``first`` 1: each of the
    ``group`` rows alone)."""
    last = torch.full((group,), batch.sequence_length - 1, dtype=torch.long, device=engine.device)

    def forward(lo, hi):
        out = engine._prompt_forward(engine._model, engine.config, batch.slice((slice(lo, hi), slice(None))),
                                     last[: hi - lo])[0]  # fmt: skip
        return _slice_preds_at(out.preds, last[: hi - lo])

    check = RowCheck(group, first)
    with torch.no_grad():
        with check:
            full = forward(0, group)
        spans = [(r, r + 1) for r in range(group)] if first == 1 else [(0, first)]
        pairs = [(full.map(lambda x, lo=lo, hi=hi: x[lo:hi]), forward(lo, hi)) for lo, hi in spans]
    return dict(rows=[group, first], ops=check.report(), outputs=_compare_outputs(pairs))


def _decode(engine, batch) -> dict:
    """One teacher-forced decode step of each row's last prompt event on all
    rows against the first half (the one-event view with its time, the input
    layer, kernel B on caches from the prefill of the other events, ``ln_f``
    and the output layer); kernel B also on the full run's input rows."""
    n, L = batch.batch_size, batch.sequence_length
    half = n // 2
    m, cfg = engine._model, engine.config
    idx = torch.full((n,), L - 1, dtype=torch.long, device=engine.device)
    with torch.no_grad():
        view = batch.slice((slice(None), slice(0, L - 1)))
        _, (key, value), mask, _ = engine._prompt_forward(m, cfg, view, idx - 1)
    start = idx.to(torch.int32)

    def step(rows: int, check=None, h0=None) -> tuple:
        with torch.no_grad():
            with check or contextlib.nullcontext():
                v = _trim_to_event(batch.slice((slice(0, rows), slice(None))), idx[:rows])
                h0 = m.encoder.input_layer(v)[:, 0] if h0 is None else h0
            h = decode_stack_step(engine._stacked, key[:, :rows].clone(), value[:, :rows].clone(), h0, start[:rows],
                                  v.event_mask[:, 0], mask[:rows].clone(), windows=engine._windows,
                                  activation=cfg.activation_function, layer_norm_eps=float(cfg.layer_norm_epsilon))[0]  # fmt: skip
            with check or contextlib.nullcontext():
                out = m.output_layer(v, m.encoder.ln_f(h[:, None, :]), is_generation=True)
        return h0, h, _slice_preds_at(out.preds, 0)

    check = RowCheck(n, half)
    h0, h, preds = step(n, check)
    h0_half, _, preds_half = step(half)
    _, h_same_input, _ = step(half, h0=h0[:half])
    return dict(rows=[n, half], ops=check.report(),
                input_layer_rows_equal=bool(torch.equal(h0[:half], h0_half)),
                kernel_b_same_input=dict(rows_equal=bool(torch.equal(h[:half], h_same_input)),
                                         max_abs=_max_abs(h[:half], h_same_input)),
                outputs=_compare_outputs([(preds.map(lambda x: x[:half]), preds_half)]))  # fmt: skip


def row_invariance(device: str = "cuda", rows: int = 32, length: int = 192, widths: dict | None = None) -> list:
    """The report of the module docstring, a dict a precision (bf16, then fp32)."""
    rng = np.random.default_rng(0)
    widths = widths or {}
    prompts = synthetic_prompts(rng, 16, serving_config(**widths), (length, length), (16, 16))
    mean_log, std_log = log_time_stats(prompts)
    out, state = [], None
    for precision in ("bf16", "fp32"):
        config = serving_config(precision=precision, mean_log=mean_log, std_log=std_log, **widths)
        model = CIPPTForGenerativeSequenceModeling(config)
        if state is None:
            state = init_params_from_seed(model, seed=0).state_dict()
        model.load_state_dict(state)
        batch = synthetic_prompt_batch(np.random.default_rng(1), rows, config, length)
        engine = GenerationEngine(model, config, template=batch.slice((slice(0, 1), slice(None))), device=device,
                                  n_slots=rows, max_len=length + 16, max_prompt_len=length, min_bucket=16,
                                  decode_chunk=2, greedy=True)  # fmt: skip
        batch = batch.map(lambda x: x.to(engine.device))
        out.append(dict(precision=precision, hidden=config.hidden_size, length=length,
                        prefill=[_prefill(engine, batch, 1 << k, 1) for k in range(1, rows.bit_length())],
                        decode=_decode(engine, batch)))  # fmt: skip
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=32)
    ap.add_argument("--length", type=int, default=192)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("row_invariance: no CUDA device is available (pass --device cpu for the CPU)", file=sys.stderr)
        return 2
    for rep in row_invariance(args.device, args.rows, args.length):
        print(json.dumps(rep), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=False).stdout.strip()  # fmt: skip
        print(f"({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
