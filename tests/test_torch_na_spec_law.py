"""The PyTorch port's NA speculative engine: a perfect draft against JAX's, and the laws of its committed events, on the CPU.

Moved here from ``tests/test_torch_na_spec.py`` and
``tests/test_torch_na_spec_engine.py`` (unchanged; their fixtures: the NA
model of ``tests/test_torch_na_engine.py``, fp32, JAX's weights carried over
by `load_jax_params`, the one-layer truncated draft), so that no test file
runs much over a minute:

1. a perfect fp32 draft (the target, default tolerances) accepts above 0.95
   (JAX's rate, whose draft caches go stale, printed beside it), and its
   events equal the NA engine's (floats within the tolerances' envelope);
2. the committed ``event_type`` and time laws under the truncated and an
   adversarial draft equal the NA engine's by chi-square (96 requests of 3
   events each side, alpha 0.001).
"""

import numpy as np
import torch

from eventstreamgpt_tpu.serving import GenerationEngine as JaxEngine
from eventstreamgpt_tpu.serving import Request as JaxRequest
from eventstreamgpt_tpu.serving import SpecConfig as JaxSpecConfig
from eventstreamgpt_tpu_torch.convert import init_params_from_seed
from eventstreamgpt_tpu_torch.models.na_model import NAPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.serving import Request, SpecConfig

from .test_spec import assert_same_distribution, collect_head_samples
from .test_torch_engine import ENGINE, EXACT, to_torch
from .test_torch_na_spec import drafts, na, port_engine, port_spec, rows4  # noqa: F401


# ---------------------------------------------------------- (1) perfect draft
def test_perfect_draft_accepts_where_the_jax_draft_cache_goes_stale(na):
    """The target as its own draft, default tolerances, greedy, budgets of 11
    at ``max_len`` 16: the port accepts more than 0.95 and commits the NA
    engine's events (floats within the tolerance envelope, JAX's
    ``test_tolerant_greedy_perfect_draft_accepts``). JAX's draft keeps the
    walk of its last proposal and leaves its last proposal's sequence entry
    unwritten; its rate is printed (ROADMAP Queue 3)."""
    jcfg, jmodel, params, tcfg, tmodel, prompt = na
    rows = rows4(prompt)
    teng = port_engine(na, greedy=True, spec=SpecConfig(model=tmodel, config=tcfg, k=3), max_len=16)
    tres = teng.run([Request(prompt=to_torch(p), max_new_events=11, request_id=i) for p, i in rows])
    rate = teng.stats()["spec_acceptance_rate"]
    base = port_engine(na, greedy=True, max_len=16).run([Request(prompt=to_torch(p), max_new_events=11, request_id=i)
                                                          for p, i in rows])  # fmt: skip
    for a, b in zip(tres, base):
        assert (a.n_events, a.n_generated) == (b.n_events, b.n_generated)
        for f in EXACT[:4]:
            assert torch.equal(getattr(a.batch, f), getattr(b.batch, f)), f
        for f in ("time_delta", "dynamic_values"):
            torch.testing.assert_close(getattr(a.batch, f)[:, :-1], getattr(b.batch, f)[:, :-1], rtol=5e-3, atol=1e-4)
    jeng = JaxEngine(jmodel, params, jcfg, template=prompt, greedy=True,
                     spec=JaxSpecConfig(model=jmodel, params=params, config=jcfg, k=3), **dict(ENGINE, max_len=16))  # fmt: skip
    jeng.run([JaxRequest(prompt=p, max_new_events=11, request_id=i) for p, i in rows])
    print(f"perfect NA draft acceptance: port {rate}, JAX {jeng.stats()['spec_acceptance_rate']}")
    assert rate > 0.95


# ------------------------------------------------------------ (2) the law
def many_requests(prompt, n=96, budget=3, seed=1000):
    return [Request(prompt=prompt.slice((slice(i % 4, i % 4 + 1), slice(0, 4))), max_new_events=budget,
                    key=seed + i, request_id=i) for i in range(n)]  # fmt: skip


def test_sampled_na_spec_law_equals_the_na_engine_law(na, drafts):
    """The committed ``event_type`` and time laws (the baseline's quartile
    bins), spec against the NA engine, 96 requests of 3 events each side,
    alpha 0.001 (JAX's ``test_na_distribution_and_adversarial_draft``): at
    the truncated draft and at an adversarial one (another seed's weights),
    whose acceptance collapses."""
    _, _, _, tcfg, _, prompt = na
    prompt = to_torch(prompt)
    kw = dict(n_slots=4, decode_chunk=2)
    ref = collect_head_samples(port_engine(na, **kw).run(many_requests(prompt)))
    bad = init_params_from_seed(NAPPTForGenerativeSequenceModeling(tcfg), seed=999)
    edges = np.quantile(np.asarray(ref["tte"]), [0.25, 0.5, 0.75])
    rates = {}
    for name, sc in (("truncated", port_spec(drafts, k=2, value_rtol=1e-3, value_atol=1e-6)),
                     ("adversarial", SpecConfig(model=bad, config=tcfg, k=2))):  # fmt: skip
        eng = port_engine(na, spec=sc, **kw)
        got = collect_head_samples(eng.run(many_requests(prompt)))
        rates[name] = eng.stats()["spec_acceptance_rate"]
        assert_same_distribution(np.histogram(ref["event_type"], bins=np.arange(1, 5))[0],
                                 np.histogram(got["event_type"], bins=np.arange(1, 5))[0], f"na {name}: event_type")
        assert_same_distribution(np.histogram(np.digitize(ref["tte"], edges), bins=np.arange(5))[0],
                                 np.histogram(np.digitize(got["tte"], edges), bins=np.arange(5))[0],
                                 f"na {name}: tte (quartile bins)")  # fmt: skip
    assert rates["adversarial"] < 0.3 and rates["truncated"] >= rates["adversarial"], rates
