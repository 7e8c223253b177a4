"""The port's serving fleet and router against the JAX package's, on the CPU.

Fixtures: ``tests/test_fleet.py``'s tiny CI setup (``ci_config``,
``make_prompt(B=4, L=4)``, weights from PRNG keys 0 and 99, its
``engine_for`` with 2 slots, ``max_len`` 8 and chunks of 2, and
``mixed_requests``), with JAX's init jitted as in
``tests/test_torch_service.py`` (several times faster on the CPU than flax's
eager init; other values); the port gets the same weights through
`load_jax_params`. One pair of greedy hot-swap engines a package (``svc0``
paged with blocks of 4, ``svc1`` monolithic) serves one sequence of scenarios,
each a new fleet over them after ``reset()``, so that each JAX program
compiles once; the weights move with the promotions, the same in both.

1. The router: ``tests/fixtures/router_assignment.json`` (the assignment,
   the five-service one and the eviction one), JAX's ring on 1,000 random
   keys, ~1/N moved on a resize, JAX's validation messages.
2. JAX parity, greedy, scenario by scenario: every event and integer equal,
   floats within the engine's greedy tolerance, and each result's
   ``service``, ``lane``, ``replica``, ``fleet_index``, ``weights_version``
   and ``replays`` equal: undisturbed; a ``death`` of ``svc1`` at its third
   chunk (evictions, replays, results); a ``nan_slot``; rollbacks after a
   ``corrupt_shadow`` and a ``flip_failure`` (status and reason's prefix); an
   idle promotion; an armed promotion driven round by round with two routes
   held in its swap window; a fork on the paged service.
3. The port alone: a sampled fleet equals one engine serving the accepted
   set; a death of the last service raises, ``auto_evict=False`` raises on a
   death; the bad-chunk streak and a hang evict; a round that captures a
   program is not counted as hung (the watchdog's clock stopped but for the
   hangs and captures, so that its verdicts do not depend on the CPU's load); an armed ``at_time`` promotion under
   arrivals; a spec fleet's promotion; a promotion through a prefill stream;
   the scoreboard reads a lost held request as dropped.
"""

import contextlib
import dataclasses
import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from eventstreamgpt_tpu import reliability as jax_reliability
from eventstreamgpt_tpu import serving as jax_serving
from eventstreamgpt_tpu.models.ci_model import CIPPTForGenerativeSequenceModeling as JaxModel
from eventstreamgpt_tpu_torch import reliability
from eventstreamgpt_tpu_torch import serving
from eventstreamgpt_tpu_torch.convert import load_jax_params
from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
from eventstreamgpt_tpu_torch.serving import (
    FleetHealthConfig,
    GenerationEngine,
    PrefillStream,
    PromotionError,
    ReplicaDeadError,
    ReplicaHungError,
    Request,
    ServingFleet,
    ServingService,
    SpecConfig,
    truncated_draft,
)
from eventstreamgpt_tpu_torch.reliability import serving_faults as serving_faults_module
from eventstreamgpt_tpu_torch.serving import fleet as fleet_module
from eventstreamgpt_tpu_torch.utils.graphs import CapturedProgram, ProgramFamily

from .test_fleet import engine_for, mixed_requests
from .test_generation import ci_config, make_prompt
from .test_torch_engine import CLOSE, EXACT, assert_same_results, to_torch
from .test_torch_prefill import RerunGraph

MAX_LEN = 8
FIXTURE = Path(__file__).parent / "fixtures" / "router_assignment.json"
ENGINE = dict(n_slots=2, max_len=MAX_LEN, decode_chunk=2, min_bucket=2)  # test_fleet.py's engine_for
PAGED = dict(paged_kv=True, block_size=4)
GREEDY_FLOATS = dict(rtol=1e-4, atol=1e-4)  # the engine's greedy parity tolerance against JAX
ROUTING = ("service", "lane", "replica", "fleet_index", "weights_version", "replays")
N_ITEMS = 6


# ------------------------------------------------------------------ fixtures
@functools.cache
def build_ci():
    """``tests/test_fleet.py::build_ci``'s tuple with JAX's init jitted, and
    the port's models on the same weights; built once a process."""
    config, prompt = ci_config(), make_prompt(B=4, L=4)
    model = JaxModel(config)
    init = jax.jit(model.init)
    params, params2 = init(jax.random.PRNGKey(0), prompt), init(jax.random.PRNGKey(99), prompt)
    tcfg = StructuredTransformerConfig.from_dict(config.to_dict())
    tmodels = [load_jax_params(CIPPTForGenerativeSequenceModeling(tcfg), jax.tree_util.tree_map(np.asarray, p))
               for p in (params, params2)]  # fmt: skip
    return dict(jci=(config, model, params, params2, prompt), tcfg=tcfg, tmodels=tmodels, template=to_torch(prompt))


def port_engine(ci, model=None, **kw):
    return GenerationEngine(model or ci["tmodels"][0], ci["tcfg"], template=ci["template"], device="cpu",
                            **dict(ENGINE, **kw))  # fmt: skip


def port_items(jax_items):
    return [(s, Request(prompt=to_torch(r.prompt), max_new_events=r.max_new_events, request_id=r.request_id))
            for s, r in jax_items]  # fmt: skip


def items_for(ci, n=N_ITEMS, start=0):
    """``(subject-i, request)`` for test_fleet's ``mixed_requests``, JAX's and the port's."""
    jitems = [(f"subject-{i}", r) for i, r in enumerate(mixed_requests(ci["jci"][4], n=n, start_id=start), start)]
    return jitems, port_items(jitems)


# The package-specific names the scenarios use, by package.
PKG = {
    "jax": dict(Fleet=jax_serving.ServingFleet, Service=jax_serving.ServingService,
                Health=jax_serving.FleetHealthConfig, Fault=jax_reliability.ServingFault,
                Plan=jax_reliability.ServingFaultPlan, plan=jax_reliability.serving_fault_plan,
                PromotionError=jax_serving.PromotionError),
    "port": dict(Fleet=ServingFleet, Service=ServingService, Health=FleetHealthConfig,
                 Fault=reliability.ServingFault, Plan=reliability.ServingFaultPlan,
                 plan=reliability.serving_fault_plan, PromotionError=PromotionError),
}  # fmt: skip


def drive_armed_promotion(fleet, first, extras_pool, params):
    """``tests/test_fleet.py::test_swap_under_traffic_holds_routes_and_drops_nothing``'s
    round-by-round drive: ``first`` submitted, ``promote(params)`` armed
    (the fleet is busy), then rounds of the state machine and each
    service's step; in the first round with a draining service, the first
    two of ``extras_pool`` routing to it are submitted and held."""
    for s, r in first:
        assert fleet.submit(s, r)
    fleet.promote(params)
    assert fleet._promotion is not None
    results, held = [], []
    for _ in range(500):
        if fleet._promotion is None and not fleet._any_busy():
            break
        fleet._advance_promotion()
        draining = (fleet._promotion or {}).get("draining")
        if draining and not held:
            held = [(s, r) for s, r in extras_pool if fleet.route(s) == draining][:2]
            for s, r in held:
                assert fleet.submit(s, r)
            assert len(fleet._held[draining]) == 2
        for sid in sorted(fleet.services):
            results += [fleet._wrap(sr, sid) for sr in fleet.services[sid].step(lambda: 0.0)]
    assert held and fleet._promotion is None and not fleet._any_busy()
    return sorted(results, key=lambda r: r.fleet_index)


def run_scenarios(pkg: str, engines: list, params: list, ci) -> dict:
    """The scenario sequence over one package's ``engines`` (``svc0``,
    ``svc1``); ``params``: the two checkpoints in that package's form."""
    P = PKG[pkg]
    jitems, titems = items_for(ci)
    items = jitems if pkg == "jax" else titems
    jextra, textra = items_for(ci, n=40, start=100)
    extras = jextra if pkg == "jax" else textra

    def fleet(**kw):
        for e in engines:
            e.reset()
        return P["Fleet"]({"svc0": P["Service"]([engines[0]]), "svc1": P["Service"]([engines[1]])}, **kw)

    out = {}
    out["clean"] = fleet().run(items)
    f = fleet(health=P["Health"]())
    with P["plan"](P["Plan"]([P["Fault"]("death", service="svc1", chunk_index=2)])):
        out["death"] = f.run(items)
    out["death_stats"] = {k: f.stats()[k] for k in ("evictions", "evicted_services", "sessions_replayed_total")}
    out["death_dropped"] = f.swap_report()["swap_dropped_requests"]
    f = fleet(health=P["Health"]())
    with P["plan"](P["Plan"]([P["Fault"]("nan_slot", service="svc0", slot=0, chunk_index=1)])) as plan:
        out["nan"] = f.run(items)
    out["nan_fired"] = len(plan.fired)
    for name, fault in (("corrupt", P["Fault"]("corrupt_shadow", service="svc1")),
                        ("flip_failure", P["Fault"]("flip_failure", service="svc1"))):  # fmt: skip
        f = fleet()
        with P["plan"](P["Plan"]([fault])), pytest.raises(P["PromotionError"]) as err:
            f.promote(params[1])
        out[f"{name}_error"] = str(err.value)
        out[f"{name}_history"] = f.swap_report()["swap_history"]
        out[f"{name}_versions"] = [e.weights_version for e in engines]
        out[f"{name}_shadow"] = [e.shadow_loaded for e in engines]
        out[name] = f.run(items)
    f = fleet()
    f.promote(params[1])
    out["idle_history"] = f.swap_report()["swap_history"]
    out["idle"] = f.run(items)
    f = fleet()
    out["armed"] = drive_armed_promotion(f, items[:4], extras, params[0])
    out["armed_report"] = f.swap_report()
    f = fleet()
    subject = next(s for s, _ in extras if f.route(s) == "svc0")
    out["fork_indices"] = f.fork(subject, items[1][1].prompt, 2, 3, request_id="f")
    out["fork"] = f.run()
    return out


def jit_the_eager_probe(engine):
    """JAX's ``probe_shadow`` calls the engine's prefill forward outside any
    trace, so it runs op by op (~15 s on the CPU the first time); such calls
    run here under ``jax.jit`` (one compile of the same forward), the calls
    traced inside the engine's own programs as before."""
    forward = engine._prefill_forward_ci
    jitted = jax.jit(forward, static_argnums=0)

    def call(Lb, *args):
        traced = any(isinstance(x, jax.core.Tracer) for x in jax.tree_util.tree_leaves(args))
        return (forward if traced else jitted)(Lb, *args)

    engine._prefill_forward_ci = call
    return engine


@pytest.fixture(scope="module")
def jax_runs():
    ci = build_ci()
    jci = ci["jci"]
    engines = [engine_for(jci, greedy=True, hot_swap=True, **PAGED), engine_for(jci, greedy=True, hot_swap=True)]
    return run_scenarios("jax", [jit_the_eager_probe(e) for e in engines], [jci[2], jci[3]], ci)


@pytest.fixture(scope="module")
def port_runs():
    ci = build_ci()
    engines = [port_engine(ci, greedy=True, hot_swap=True, **PAGED), port_engine(ci, greedy=True, hot_swap=True)]
    return run_scenarios("port", engines, [m.state_dict() for m in ci["tmodels"]], ci)


def assert_fleet_matches_jax(jres, tres):
    """Every event and integer equal, floats within the greedy tolerance, and every routing field equal."""
    assert [r.fleet_index for r in tres] == [r.fleet_index for r in jres] and jres
    for j, t in zip(jres, tres):
        assert [getattr(t, k) for k in ROUTING] == [getattr(j, k) for k in ROUTING], j.fleet_index
        assert (t.request_id, t.subject) == (j.request_id, j.subject)
        assert type(t.error).__name__ == type(j.error).__name__
        assert (t.prompt_len, t.n_events, t.n_generated) == (j.prompt_len, j.n_events, j.n_generated)
        if j.error is not None:
            assert t.batch is None and j.batch is None
            continue
        for f in EXACT:
            np.testing.assert_array_equal(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f)
        for f in CLOSE:
            np.testing.assert_allclose(getattr(t.batch, f).numpy(), np.asarray(getattr(j.batch, f)), err_msg=f,
                                       **GREEDY_FLOATS)  # fmt: skip


# ------------------------------------------------------------------ (1) router
@pytest.fixture(scope="module")
def fixture():
    return json.loads(FIXTURE.read_text())


def test_router_reproduces_the_committed_assignments(fixture):
    subjects = sorted(fixture["assignment_4"])
    router = serving.ConsistentHashRouter(fixture["services_4"], n_vnodes=fixture["n_vnodes"])
    assert router.assignment(subjects) == fixture["assignment_4"]
    five = serving.ConsistentHashRouter(reversed(fixture["services_5"]), n_vnodes=fixture["n_vnodes"])
    assert five.assignment(subjects) == fixture["assignment_5"]
    router.add_service("svc4")
    assert router.assignment(subjects) == fixture["assignment_5"]
    evicted = serving.ConsistentHashRouter(fixture["services_4"], n_vnodes=fixture["n_vnodes"])
    evicted.remove_service(fixture["evicted_service"])
    assert evicted.assignment(subjects) == fixture["assignment_4_evict_svc1"]


@pytest.mark.parametrize("n_vnodes", [1, 64])
def test_router_equals_jax_on_random_keys(n_vnodes):
    rng = np.random.default_rng(0)
    keys = [f"subject-{k}" for k in rng.integers(0, 10**9, 500)] + [int(k) for k in rng.integers(0, 10**9, 500)]
    ids = ["svc0", "svc1", "svc2", "alpha"]
    port, ref = serving.ConsistentHashRouter(ids, n_vnodes), jax_serving.ConsistentHashRouter(ids, n_vnodes)
    assert port.assignment(keys) == ref.assignment(keys)
    assert all(serving.stable_hash(k, "s") == jax_serving.stable_hash(k, "s") for k in keys[:50])
    port.remove_service("svc1")
    ref.remove_service("svc1")
    assert port.assignment(keys) == ref.assignment(keys)


def test_router_moves_about_one_in_n_on_resize():
    keys = [f"u{i}" for i in range(1000)]
    ids = [f"svc{i}" for i in range(4)]
    before = serving.ConsistentHashRouter(ids).assignment(keys)
    after = serving.ConsistentHashRouter(ids + ["svc4"]).assignment(keys)
    moved = [k for k in keys if before[k] != after[k]]
    assert 0.1 * len(keys) <= len(moved) <= 0.3 * len(keys)  # 1/5 expected
    assert all(after[k] == "svc4" for k in moved)


def test_router_validation_in_jax_words():
    for Router in (serving.ConsistentHashRouter, jax_serving.ConsistentHashRouter):
        with pytest.raises(ValueError, match="duplicate service ids"):
            Router(["a", "a"])
        with pytest.raises(ValueError, match="at least one service id"):
            Router([])
        with pytest.raises(ValueError, match="n_vnodes must be >= 1"):
            Router(["a"], n_vnodes=0)
        r = Router(["a", "b"])
        with pytest.raises(ValueError, match="already on the ring"):
            r.add_service("a")
        with pytest.raises(KeyError):
            r.remove_service("zzz")
        r.remove_service("b")
        with pytest.raises(ValueError, match="cannot remove the last service"):
            r.remove_service("a")


# ------------------------------------------------------- (2) JAX parity
@pytest.mark.parametrize("scenario", ["clean", "death", "nan", "corrupt", "flip_failure", "idle", "armed", "fork"])
def test_fleet_matches_jax(jax_runs, port_runs, scenario):
    assert_fleet_matches_jax(jax_runs[scenario], port_runs[scenario])


def test_routing_splits_the_subjects_and_a_death_replays_them(jax_runs, port_runs):
    clean, dead = port_runs["clean"], port_runs["death"]
    assert {r.service for r in clean} == {"svc0", "svc1"} and all(r.ok and r.replays == 0 for r in clean)
    assert all(r.service == "svc0" and r.ok for r in dead)
    assert [r.replays for r in dead] == [int(c.service == "svc1") for c in clean]
    assert_same_results([dataclasses.replace(r, request_id=r.fleet_index) for r in clean],
                        [dataclasses.replace(r, request_id=r.fleet_index) for r in dead], float_tol=1e-6)  # fmt: skip
    assert port_runs["death_stats"] == jax_runs["death_stats"]
    assert port_runs["death_stats"]["evicted_services"] == ["svc1"]
    assert port_runs["death_stats"]["sessions_replayed_total"] > 0 and port_runs["death_dropped"] == 0


def test_a_nan_slot_fails_its_request_alone(jax_runs, port_runs):
    bad = [r for r in port_runs["nan"] if not r.ok]
    assert len(bad) == 1 and isinstance(bad[0].error, serving.SlotHealthError) and bad[0].service == "svc0"
    assert port_runs["nan_fired"] == jax_runs["nan_fired"] == 1
    clean = {r.fleet_index: r for r in port_runs["clean"]}
    assert_same_results([dataclasses.replace(clean[r.fleet_index], request_id=r.fleet_index) for r in port_runs["nan"] if r.ok],
                        [dataclasses.replace(r, request_id=r.fleet_index) for r in port_runs["nan"] if r.ok])  # fmt: skip


@pytest.mark.parametrize("name", ["corrupt", "flip_failure"])
def test_rollbacks_match_jax(jax_runs, port_runs, name):
    j, t = jax_runs[f"{name}_history"], port_runs[f"{name}_history"]
    assert [h["status"] for h in t] == [h["status"] for h in j] == ["rolled_back"]
    prefix = {"corrupt": "shadow verification failed on service 'svc1': staged shadow checkpoint produced non-finite",
              "flip_failure": "flip failed on service 'svc1': injected flip failure"}[name]  # fmt: skip
    assert t[0]["reason"].startswith(prefix) and j[0]["reason"].startswith(prefix)
    assert port_runs[f"{name}_error"] == t[0]["reason"]
    assert port_runs[f"{name}_versions"] == jax_runs[f"{name}_versions"]
    assert port_runs[f"{name}_shadow"] == jax_runs[f"{name}_shadow"] == [False, False]
    # The rolled-back fleet serves the first checkpoint: the undisturbed run's events.
    assert_same_results([dataclasses.replace(r, request_id=r.fleet_index) for r in port_runs["clean"]],
                        [dataclasses.replace(r, request_id=r.fleet_index) for r in port_runs[name]])  # fmt: skip


def test_promotions_serve_the_new_checkpoint(port_runs):
    """Post-flip results equal a fresh port service on the new weights; the
    armed promotion's held routes release onto them, the rest finish on the
    weights they started on."""
    ci = build_ci()
    assert port_runs["idle_history"][-1] == {"status": "promoted", "services": ["svc0", "svc1"], "held_released": 0}
    idle = port_runs["idle"]
    for sid, kw in (("svc0", PAGED), ("svc1", {})):
        mine = [r for r in idle if r.service == sid]
        ref = port_engine(ci, ci["tmodels"][1], greedy=True, **kw).run(
            [dataclasses.replace(items_for(ci)[1][r.fleet_index][1], request_id=r.fleet_index) for r in mine]
        )
        assert mine
        assert_same_results(ref, [dataclasses.replace(r, request_id=r.fleet_index) for r in mine])
    armed, report = port_runs["armed"], port_runs["armed_report"]
    assert report["swap_dropped_requests"] == 0 and report["held_peak"] == 2
    assert report["swap_history"][-1]["status"] == "promoted" and report["swap_history"][-1]["held_released"] == 2
    held = [r for r in armed if r.fleet_index >= 4]
    assert len(held) == 2 and len(armed) == 6
    assert {r.weights_version for r in held} != {r.weights_version for r in armed if r.fleet_index < 4}
    # The held routes ran on checkpoint 1 (the armed promotion's), with the fleet's bound seeds.
    eng = port_engine(ci, greedy=True, **(PAGED if held[0].service == "svc0" else {}))
    _, textra = items_for(ci, n=40, start=100)
    by_subject = dict(textra)
    ref = eng.run([dataclasses.replace(by_subject[r.subject], request_id=r.fleet_index, key=derive_request_seed(0, r.fleet_index))
                   for r in held])  # fmt: skip
    assert_same_results(ref, [dataclasses.replace(r, request_id=r.fleet_index) for r in held])


def test_a_fork_through_the_fleet(port_runs):
    ci = build_ci()
    assert port_runs["fork_indices"] == [1, 2]  # the session took fleet index 0
    fork = port_runs["fork"]
    assert [r.request_id for r in fork] == [("f", 0), ("f", 1)] and {r.service for r in fork} == {"svc0"}
    session = derive_request_seed(0, 0)
    row = items_for(ci)[1][1][1].prompt
    ref = port_engine(ci, greedy=True, **PAGED).run(
        [Request(prompt=row, max_new_events=3, request_id=("f", j), key=derive_request_seed(session, j)) for j in range(2)]
    )
    assert_same_results(ref, fork)


# ------------------------------------------------------------ (3) port alone
def test_fleet_validation(fixture):
    ci = build_ci()
    s1 = ServingService([port_engine(ci)])
    with pytest.raises(ValueError, match="distinct"):
        ServingFleet([s1, s1])
    with pytest.raises(ValueError, match="share max_len"):
        ServingFleet([s1, ServingService([port_engine(ci, max_len=MAX_LEN + 2)])])
    with pytest.raises(ValueError, match="at least one service"):
        ServingFleet([])
    with pytest.raises(ValueError, match="base_key"):
        ServingFleet([s1], base_key=7)
    with pytest.raises(RuntimeError, match="hot_swap"):
        ServingFleet([s1]).promote(ci["tmodels"][1].state_dict())
    with pytest.raises(ValueError, match="new_draft_params on a fleet with no speculative engines"):
        ServingFleet([ServingService([port_engine(ci, hot_swap=True)])]).promote({}, new_draft_params={})
    fleet = ServingFleet([s1, ServingService([port_engine(ci)])])
    assert fleet.route("subject-3") == serving.ConsistentHashRouter(["svc0", "svc1"]).route("subject-3")
    assert all(e.fault_scope == sid for sid, s in fleet.services.items() for e in s.replicas)


def test_sampled_fleet_equals_a_single_engine():
    """A sampled fleet (local prefill and a prefill stream) gives each
    accepted request the events of one engine with the fleet's seed serving
    the accepted set in order (floats within 1e-5: group widths may differ)."""
    ci = build_ci()
    _, items = items_for(ci, n=8)
    ref = port_engine(ci, n_slots=4, seed=11).run([r for _, r in items])
    fleet = ServingFleet({"a": ServingService([port_engine(ci)], prefill_stream=PrefillStream(port_engine(ci))),
                          "b": ServingService([port_engine(ci), port_engine(ci, decode_chunk=3)])}, seed=11)  # fmt: skip
    got = fleet.run([(s, r, "batch" if i % 2 else "interactive") for i, (s, r) in enumerate(items)])
    assert {r.service for r in got} == {"a", "b"} and all(r.ok and r.service == fleet.route(r.subject) for r in got)
    assert [r.lane for r in got] == ["interactive", "batch"] * 4
    assert_same_results(ref, [dataclasses.replace(r, request_id=r.fleet_index) for r in got], float_tol=1e-5)
    s = fleet.stats()
    assert s["accepted_total"] == s["completed_total"] == 8 and s["swap"]["swap_dropped_requests"] == 0


def two_services(ci, **kw):
    return {"svc0": ServingService([port_engine(ci, **kw)]), "svc1": ServingService([port_engine(ci, **kw)])}


def test_the_last_death_raises_and_record_only_raises_on_a_death():
    ci = build_ci()
    _, items = items_for(ci, n=2)
    death = reliability.ServingFault("death", service="svc0", chunk_index=1)
    fleet = ServingFleet({"svc0": ServingService([port_engine(ci)])}, health=FleetHealthConfig())
    with reliability.serving_fault_plan(reliability.ServingFaultPlan([death])), pytest.raises(ReplicaDeadError):
        fleet.run(items)
    fleet = ServingFleet(two_services(ci), health=FleetHealthConfig(auto_evict=False))
    _, items = items_for(ci, n=N_ITEMS)
    with reliability.serving_fault_plan(reliability.ServingFaultPlan([death])), pytest.raises(ReplicaDeadError):
        fleet.run(items)
    assert fleet.stats()["replica_faults"][0]["kind"] == "dead" and not fleet.stats()["evictions"]
    fleet = ServingFleet(two_services(ci))  # no health policy: a death propagates
    with reliability.serving_fault_plan(reliability.ServingFaultPlan([death])), pytest.raises(ReplicaDeadError):
        fleet.run(items)
    fleet = ServingFleet(two_services(ci))  # an operator's eviction of a queued service
    for s, r in items:
        fleet.submit(s, r)
    on_svc1 = sum(fleet.route(s) == "svc1" for s, _ in items)
    assert fleet.evict_service("svc1") == on_svc1 > 0 and fleet.stats()["sessions_replayed_total"] == on_svc1
    assert all(r.ok and r.service == "svc0" for r in fleet.run())


class StoppedClock:
    """The fleet's and the fault plan's clock, moved only by what sleeps (a
    hang) or by `advance` (a capture): a round takes no time but theirs, so the
    watchdog's verdicts do not depend on how loaded the CPU is."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


@pytest.fixture
def stopped_clock(monkeypatch):
    clock = StoppedClock()
    for module in (fleet_module, serving_faults_module):
        monkeypatch.setattr(module, "time", clock)
    return clock


def test_a_bad_chunk_streak_and_a_hang_evict(stopped_clock):
    ci = build_ci()
    _, items = items_for(ci)
    fleet = ServingFleet(two_services(ci), health=FleetHealthConfig(max_consecutive_bad_chunks=1))
    plan = reliability.ServingFaultPlan([reliability.ServingFault("nan_slot", service="svc0", slot=0, chunk_index=c)
                                         for c in range(1, 4)])  # fmt: skip
    with reliability.serving_fault_plan(plan):
        res = fleet.run(items)
    assert len(res) == N_ITEMS and fleet.swap_report()["swap_dropped_requests"] == 0
    ev = fleet.stats()["evictions"]
    assert ev[0]["service"] == "svc0" and ev[0]["reason"].startswith("sick: 1 consecutive rounds")
    # A hang past the watchdog's bound after the warm-up: evicted as hung, every request completes.
    health = FleetHealthConfig(boundary_timeout_s=0.3, watchdog_warmup_chunks=1)
    fleet = ServingFleet(two_services(ci), health=health)
    subjects = [f"subject-{k}" for k in range(60)]
    victims = [s for s in subjects if fleet.route(s) == "svc0"][:5] + [s for s in subjects if fleet.route(s) == "svc1"][:3]
    reqs = [(s, r) for s, (_, r) in zip(victims, items_for(ci, n=8)[1])]
    hang = reliability.ServingFault("hang", service="svc0", chunk_index=2, seconds=0.6)
    with reliability.serving_fault_plan(reliability.ServingFaultPlan([hang])) as plan:
        res = fleet.run(reqs)
    assert plan.fired and len(res) == 8 and all(r.ok for r in res)
    ev = fleet.stats()["evictions"]
    assert ev[0]["service"] == "svc0" and ev[0]["reason"].startswith("hung: scheduling round took")
    # The last service hung: the watchdog raises its typed error.
    fleet = ServingFleet({"svc0": ServingService([port_engine(ci)])}, health=health)
    with reliability.serving_fault_plan(reliability.ServingFaultPlan([hang])), pytest.raises(ReplicaHungError):
        fleet.run(reqs)


def test_a_round_that_captures_is_not_hung(monkeypatch, stopped_clock):
    """The port's exemption: a round in which an engine captured a program
    (here every prefill and extraction key, each capture made to outlast the
    watchdog's bound) is not counted as hung, though the warm-up is over; a
    round that captures nothing is still watched."""
    ci = build_ci()
    replay, capture = CapturedProgram.replay, CapturedProgram.capture
    monkeypatch.setattr(CapturedProgram, "replay", lambda self: (self.fn(), replay(self))[1])
    monkeypatch.setattr(CapturedProgram, "capture", lambda self: (stopped_clock.sleep(0.25), capture(self))[1])

    def captured_engine():
        eng = port_engine(ci, n_slots=4)
        eng._families = {k: ProgramFamily(f"the {k} program", device="cpu", graph=RerunGraph,
                                          graph_context=lambda g, stream: contextlib.nullcontext())
                         for k in ("prefill", "extract")}  # fmt: skip
        return eng

    fleet = ServingFleet([ServingService([captured_engine()]), ServingService([captured_engine()])],
                         health=FleetHealthConfig(boundary_timeout_s=0.2, watchdog_warmup_chunks=0))  # fmt: skip
    _, items = items_for(ci, n=6)
    res = fleet.run(items)
    captures = [e.program_stats()["prefill_graph_captures"] for s in fleet.services.values() for e in s.replicas]
    assert all(r.ok for r in res) and len(res) == 6 and min(captures) > 0
    assert fleet.stats()["replica_faults"] == [] and fleet.stats()["n_services"] == 2
    hang = reliability.ServingFault("hang", service="svc1", chunk_index=1, seconds=0.3)
    for e in [e for s in fleet.services.values() for e in s.replicas]:
        e.reset()
    fleet = ServingFleet(list(fleet.services.values()),
                         health=FleetHealthConfig(boundary_timeout_s=0.2, watchdog_warmup_chunks=0))  # fmt: skip
    with reliability.serving_fault_plan(reliability.ServingFaultPlan([hang])):
        res = fleet.run(items)
    assert [f["kind"] for f in fleet.stats()["replica_faults"]] == ["hung"] and len(res) == 6


def test_an_armed_promotion_under_arrivals():
    """``promote(at_time=...)`` armed before an arrival trace: zero drops,
    both services flip, and every result equals a fresh engine on the
    checkpoint its ``weights_version`` names, with the fleet's seed."""
    ci = build_ci()
    fleet = ServingFleet(two_services(ci, hot_swap=True, greedy=True), seed=3)
    _, items = items_for(ci, n=12)
    trace = [(s, dataclasses.replace(r, arrival_time=0.01 * i)) for i, (s, r) in enumerate(items)]
    fleet.promote(ci["tmodels"][1].state_dict(), at_time=0.03)
    res = fleet.run(trace, use_arrival_times=True)
    report = fleet.swap_report()
    assert len(res) == 12 and all(r.ok for r in res) and report["swap_dropped_requests"] == 0
    assert report["swap_history"][-1]["status"] == "promoted"
    assert all(e.weights_version == 1 for s in fleet.services.values() for e in s.replicas)
    for version in (0, 1):
        mine = [r for r in res if r.weights_version == version]
        ref = port_engine(ci, ci["tmodels"][version], greedy=True).run(
            [dataclasses.replace(items[r.fleet_index][1], request_id=r.fleet_index, key=derive_request_seed(3, r.fleet_index))
             for r in mine])  # fmt: skip
        assert_same_results(ref, [dataclasses.replace(r, request_id=r.fleet_index) for r in mine])


def test_a_spec_fleet_promotes_draft_and_target_together():
    ci = build_ci()
    m1, m2 = ci["tmodels"]

    def spec_engine(model):
        dcfg, draft = truncated_draft(ci["tcfg"], model, 1)
        return port_engine(ci, model, hot_swap=True, spec=SpecConfig(model=draft, config=dcfg, k=2))

    fleet = ServingFleet([ServingService([spec_engine(m1)]), ServingService([spec_engine(m1)])], seed=5)
    with pytest.raises(ValueError, match="new_draft_params"):
        fleet.promote(m2.state_dict())
    fleet.promote(m2.state_dict(), new_draft_params=truncated_draft(ci["tcfg"], m2, 1)[1].state_dict())
    _, items = items_for(ci)
    got = fleet.run(items)
    assert all(r.weights_version == 1 for r in got)
    ref = spec_engine(m2).run([dataclasses.replace(r, key=derive_request_seed(5, i)) for i, (_, r) in enumerate(items)])
    assert_same_results(ref, [dataclasses.replace(r, request_id=r.fleet_index) for r in got])


def test_a_promotion_flips_the_prefill_engine():
    ci = build_ci()
    svc = ServingService([port_engine(ci, hot_swap=True, greedy=True)],
                         prefill_stream=PrefillStream(port_engine(ci, hot_swap=True, greedy=True)))  # fmt: skip
    fleet = ServingFleet([svc], seed=2)
    _, items = items_for(ci, n=4)
    fleet.run(items[:2])
    fleet.promote(ci["tmodels"][1].state_dict())
    assert svc.replicas[0].weights_version == svc.prefill_stream.engine.weights_version == 1
    post = fleet.run(items[2:])
    ref = port_engine(ci, ci["tmodels"][1], greedy=True).run(
        [dataclasses.replace(r, key=derive_request_seed(2, i)) for i, (_, r) in enumerate(items[2:], 2)]
    )
    assert_same_results(ref, [dataclasses.replace(r, request_id=r.fleet_index) for r in post])
    assert svc.stats()["prefill_stream"]["prefilled_total"] == 4


def test_the_scoreboard_reads_a_lost_held_request_as_dropped():
    """JAX's ``test_swap_scoreboard_detects_a_lost_held_request``."""
    ci = build_ci()
    fleet = ServingFleet({"s": ServingService([port_engine(ci)])})
    fleet._holding.add("s")
    ok = fleet.submit("subj", Request(prompt=ci["template"].slice((slice(0, 1), slice(0, 3))), max_new_events=2))
    rep = fleet.swap_report()
    assert ok and rep["in_flight"] == 1 and rep["swap_dropped_requests"] == 0 and rep["held_peak"] == 1
    fleet._held["s"].clear()
    assert fleet.swap_report()["swap_dropped_requests"] == 1
