"""Functor measurements in the port's NA speculative rounds against the JAX package, on the CPU.

The configuration and prompts are `tests/test_torch_functor_generation.py`'s
(both functors, fp32, JAX's weights) on the NA model (levels ``[[],
["event_type"], ["multi_lab", "lab_vals"]]``; the functors map to level 0),
the engines 2 slots, ``max_len`` 12, chunks of 2:

* the strict greedy NA spec engine (a one-layer truncated draft, ``k`` 2,
  zero tolerances) against JAX's: every integer and structure field equal,
  floats within 1e-4.

The NA engine with functors is ``tests/test_torch_functor_na.py``'s.

Each generated event holds its functor elements, the time-of-day bucket that
of its time recomputed in fp64 (`assert_functor_elements`).
"""

import pytest

from .test_torch_functor_generation import assert_elements, assert_match_jax, build, jax_run, port_run, request_rows
from .test_torch_functor_generation import strict_specs

@pytest.fixture(scope="module")
def models():
    return {"na": build(na=True)}


def test_strict_greedy_na_spec_with_functors_matches_jax(models):
    m = models["na"]
    rows = request_rows(m[5])
    jspec, tspec = strict_specs(m, 2)
    tres, _ = port_run(m, rows, spec=tspec)
    assert_match_jax(jax_run(m, rows, spec=jspec), tres)
    assert_elements(tres, m[3])
