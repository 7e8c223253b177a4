"""Functor measurements in the port's NA engine against the JAX package, on the CPU.

The configuration and prompts are `tests/test_torch_functor_generation.py`'s
(both functors, fp32, JAX's weights) on the NA model (levels ``[[],
["event_type"], ["multi_lab", "lab_vals"]]``; the functors map to level 0),
the engines 2 slots, ``max_len`` 12, chunks of 2:

* the greedy NA engine against JAX's: every integer and structure field
  equal, floats within 1e-4.

The NA spec engine with functors is ``tests/test_torch_functor_na_spec.py``'s.

Each generated event holds its functor elements, the time-of-day bucket that
of its time recomputed in fp64 (`assert_functor_elements`).
"""

import pytest

from .test_torch_functor_generation import assert_elements, assert_match_jax, build, jax_run, port_run, request_rows

@pytest.fixture(scope="module")
def models():
    return {"na": build(na=True)}


def test_greedy_na_engine_with_functors_matches_jax(models):
    m = models["na"]
    rows = request_rows(m[5])
    tres, teng = port_run(m, rows)
    assert_match_jax(jax_run(m, rows), tres)
    assert teng.stats()["decode_step_impl"] == "unfused"
    assert_elements(tres, m[3])
