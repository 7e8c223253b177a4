"""Functor measurements in the port's CI speculative rounds against the JAX package, on the CPU.

The configuration and prompts are `tests/test_torch_functor_generation.py`'s
(both functors, fp32, JAX's weights), the engines 2 slots, ``max_len`` 12,
chunks of 2:

* the strict greedy CI spec engine (a one-layer truncated draft, ``k`` 3,
  zero tolerances: every round commits the correction, whose functor
  elements come from the corrected time) against JAX's: every integer and
  structure field equal, floats within 1e-4;
* a perfect fp32 CI draft (the target itself, default tolerances, greedy):
  accepted proposals keep the draft's functor elements, each read off the
  draft's own prior event; its events equal the port's plain greedy engine's
  (integers exact, floats within 1e-4, but the last event's delta: a spec
  engine writes the time to its last proposal there, the plain engine the
  filler 1), acceptance above 0.9.

The NA engine and NA spec with functors are ``tests/test_torch_functor_na.py``'s.

Each generated event holds its functor elements, the time-of-day bucket that
of its time recomputed in fp64 (`assert_functor_elements`).
"""

import pytest
import torch

from eventstreamgpt_tpu_torch.serving import SpecConfig

from .test_torch_engine import EXACT
from .test_torch_functor_generation import assert_elements, assert_match_jax, build, jax_run, port_run, request_rows
from .test_torch_functor_generation import strict_specs

@pytest.fixture(scope="module")
def models():
    return {"ci": build()}


def test_strict_greedy_spec_with_functors_matches_jax(models):
    m = models["ci"]
    rows = request_rows(m[5])
    jspec, tspec = strict_specs(m, 3)
    tres, teng = port_run(m, rows, spec=tspec)
    assert_match_jax(jax_run(m, rows, spec=jspec), tres)
    assert teng.stats()["decode_step_impl"] == "spec_draft_verify"
    assert_elements(tres, m[3])


def test_perfect_draft_keeps_the_drafts_functor_elements(models):
    m = models["ci"]
    rows = request_rows(m[5])
    tres, teng = port_run(m, rows, spec=SpecConfig(model=m[4], config=m[3], k=3))
    assert teng.stats()["spec_acceptance_rate"] > 0.9
    base, _ = port_run(m, rows, decode_step_impl="xla")
    for i, b in base.items():
        t = tres[i]
        assert (t.n_events, t.n_generated) == (b.n_events, b.n_generated)
        for f in EXACT:
            torch.testing.assert_close(getattr(t.batch, f), getattr(b.batch, f), rtol=0, atol=0)
        last = t.n_events - 1
        torch.testing.assert_close(t.batch.time_delta[:, :last], b.batch.time_delta[:, :last], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(t.batch.dynamic_values, b.batch.dynamic_values, rtol=1e-4, atol=1e-4)
    assert_elements(tres, m[3])
