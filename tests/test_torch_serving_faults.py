"""The port's serving fault plan, slot health, the service's fleet-facing
options and graceful preemption, on the CPU.

Fixtures: ``tests/test_torch_fleet.py``'s ``build_ci`` (``tests/test_fleet.py``'s
tiny CI setup, the port's models on JAX's weights; built once a process) and
its 2-slot engines; for the NA engine, ``tests/test_torch_service.py``'s
small port model. The JAX parity of the fleet's faults (a death, a
``nan_slot``, both rollbacks) is in ``tests/test_torch_fleet.py``.

1. The plan: JAX's ``tests/test_serving_faults.py`` units, each run on JAX's
   module and on the port's (kind validation, no-op hooks without a plan,
   scope and chunk matching, a sticky death and a one-shot hang, the context
   manager); ``corrupt_params_tree`` on a ``state_dict``.
2. Typed errors and the health policy's validation.
3. Slot health (CI and NA engines): a ``nan_slot`` fails exactly its
   request with `SlotHealthError` and the co-resident equals the clean run;
   a retry from the bound seed equals the clean run; with the sentinel off
   the poisoned row comes back non-finite (the write is not a no-op).
4. The service's options: ``force`` past a full lane, ``fork(request_ids=)``,
   ``step(place=False)``.
5. Preemption: an in-process drain of a service and of a fleet returns the
   completed results on `Preempted`; a subprocess that imports only the port
   exits 85 on SIGTERM.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from eventstreamgpt_tpu import reliability as jax_reliability
from eventstreamgpt_tpu.reliability import serving_faults as jax_sf
from eventstreamgpt_tpu_torch import reliability
from eventstreamgpt_tpu_torch.reliability import EXIT_PREEMPTED, GracefulShutdown, Preempted
from eventstreamgpt_tpu_torch.reliability import serving_faults as sf
from eventstreamgpt_tpu_torch.serving import (
    AdmissionRejected,
    DeadlineExceeded,
    FleetHealthConfig,
    GenerationEngine,
    LaneConfig,
    LaneQueues,
    MalformedPromptRejected,
    PromotionError,
    ReplicaDeadError,
    ReplicaHungError,
    Request,
    ServingError,
    ServingFleet,
    ServingService,
    SlotHealthError,
)

from .test_torch_engine import assert_same_results
from .test_torch_fleet import PAGED, build_ci, items_for, port_engine
from .test_torch_service import SMALL_ENGINE, small

REPO = Path(__file__).resolve().parents[1]
PLANS = {"jax": (jax_reliability, jax_sf), "port": (reliability, sf)}
PACKAGES = pytest.mark.parametrize("pkg", sorted(PLANS))


# ------------------------------------------------------------------ (1) the plan
@PACKAGES
def test_kind_validation(pkg):
    rel, _ = PLANS[pkg]
    with pytest.raises(ValueError, match="unknown serving fault kind"):
        rel.ServingFault("meteor_strike")
    with pytest.raises(ValueError, match="slot and chunk_index"):
        rel.ServingFault("nan_slot", slot=0)
    with pytest.raises(ValueError, match="chunk_index"):
        rel.ServingFault("death")
    with pytest.raises(ValueError, match="seconds"):
        rel.ServingFault("hang", chunk_index=1)


@PACKAGES
def test_no_plan_hooks_are_noops(pkg):
    rel, mod = PLANS[pkg]
    assert rel.active_serving_fault_plan() is None
    assert mod.poison_slots("svc0", 3) == []
    mod.maybe_hang("svc0", 3)
    mod.maybe_die("svc0", 3)
    mod.maybe_fail_flip("svc0")
    tree = {"w": np.ones(3, np.float32)}
    assert mod.maybe_corrupt_shadow("svc0", tree) is tree


@PACKAGES
def test_scope_and_chunk_matching(pkg):
    rel, _ = PLANS[pkg]
    plan = rel.ServingFaultPlan([rel.ServingFault("nan_slot", service="svc0", slot=1, chunk_index=2)])
    assert plan.poison_slots("svc1", 2) == [] and plan.poison_slots("svc0", 1) == []
    assert plan.poison_slots("svc0", 2) == [1] and plan.fired[0]["kind"] == "nan_slot"
    assert rel.ServingFaultPlan([rel.ServingFault("nan_slot", slot=0, chunk_index=0)]).poison_slots("any", 0) == [0]


@PACKAGES
def test_death_is_sticky_and_a_hang_fires_once(pkg):
    rel, _ = PLANS[pkg]
    plan = rel.ServingFaultPlan([rel.ServingFault("death", service="svc0", chunk_index=2),
                                 rel.ServingFault("hang", service="svc0", chunk_index=1, seconds=0.5),
                                 rel.ServingFault("flip_failure"), rel.ServingFault("corrupt_shadow")])  # fmt: skip
    assert not plan.is_dead("svc0", 1) and plan.is_dead("svc0", 2) and plan.is_dead("svc0", 5)
    assert plan.hang_seconds("svc0", 1) == 0.5 and plan.hang_seconds("svc0", 2) == 0.0
    assert plan.take_flip_failure("a") and not plan.take_flip_failure("b")
    assert plan.take_corrupt_shadow("a") and plan.take_corrupt_shadow("b") and not plan.take_corrupt_shadow("a")
    assert [f["kind"] for f in plan.fired] == ["death", "hang", "flip_failure", "corrupt_shadow", "corrupt_shadow"]


@PACKAGES
def test_the_context_manager_installs_and_clears(pkg):
    rel, mod = PLANS[pkg]
    plan = rel.ServingFaultPlan([rel.ServingFault("death", service="s", chunk_index=0)])
    with rel.serving_fault_plan(plan) as p:
        assert rel.active_serving_fault_plan() is p
        with pytest.raises(ReplicaDeadError if pkg == "port" else Exception, match="injected replica death"):
            mod.maybe_die("s", 0)
    assert rel.active_serving_fault_plan() is None
    rel.install_serving_fault_plan(plan)
    rel.clear_serving_fault_plan()
    assert rel.active_serving_fault_plan() is None


def test_corrupt_params_tree_poisons_the_first_floating_entry():
    tree = {"a": np.arange(3, dtype=np.int32), "b": np.ones(4, np.float32)}
    bad = sf.corrupt_params_tree(tree)
    assert np.isnan(bad["b"]).sum() == 1 and np.array_equal(bad["a"], tree["a"]) and not np.isnan(tree["b"]).any()
    model = build_ci()["tmodels"][0]
    state = model.state_dict()
    bad = sf.corrupt_params_tree(state)
    first = next(k for k, v in state.items() if v.is_floating_point())
    assert type(bad) is type(state) and list(bad) == list(state)
    assert torch.isnan(bad[first]).sum() == 1 and not torch.isnan(state[first]).any()
    assert all(bad[k] is v for k, v in state.items() if k != first)
    with pytest.raises(PromotionError, match="injected flip failure"):
        with reliability.serving_fault_plan(reliability.ServingFaultPlan([reliability.ServingFault("flip_failure")])):
            sf.maybe_fail_flip("svc0")


# ------------------------------------------------------------ (2) typed errors
def test_typed_errors_and_the_health_policy():
    assert issubclass(MalformedPromptRejected, AdmissionRejected)
    for cls in (SlotHealthError, DeadlineExceeded, ReplicaDeadError, ReplicaHungError, PromotionError):
        assert issubclass(cls, ServingError)
    for bad in (dict(boundary_timeout_s=0.0), dict(max_consecutive_bad_chunks=0), dict(watchdog_warmup_chunks=-1)):
        with pytest.raises(ValueError):
            FleetHealthConfig(**bad)
    assert FleetHealthConfig() == FleetHealthConfig(None, 2, 3, True)


# ------------------------------------------------------------- (3) slot health
def poisoned(make, reqs, slot=0, chunk=1, scope="svc0"):
    eng = make()
    eng.fault_scope = scope
    plan = reliability.ServingFaultPlan([reliability.ServingFault("nan_slot", service=scope, slot=slot, chunk_index=chunk)])
    with reliability.serving_fault_plan(plan):
        res = eng.run([dataclasses.replace(r) for r in reqs])
    assert plan.fired, "the injection never triggered"
    return eng, {r.request_id: r for r in res}


def ci_case():
    ci = build_ci()
    _, items = items_for(ci, n=2)
    return (lambda **kw: port_engine(ci, **kw)), [dataclasses.replace(r, key=40 + i) for i, (_, r) in enumerate(items)]


def na_case():
    model, config, prompts = small(na=True, seed=2, n=2)
    reqs = [Request(prompt=p, max_new_events=b, request_id=i, key=60 + i) for i, (p, b) in enumerate(prompts)]
    return (lambda **kw: GenerationEngine(model, config, template=prompts[0][0], device="cpu",
                                          **dict(SMALL_ENGINE, **kw))), reqs  # fmt: skip


@pytest.mark.parametrize("case", [ci_case, na_case], ids=["ci", "na"])
def test_a_nan_slot_fails_its_request_alone_and_a_retry_equals_the_clean_run(case):
    make, reqs = case()
    clean = {r.request_id: r for r in make().run([dataclasses.replace(r) for r in reqs])}
    eng, got = poisoned(make, reqs)
    bad = got[0]
    assert isinstance(bad.error, SlotHealthError) and bad.batch is None and bad.error.slot == 0
    assert all(r.ok for k, r in got.items() if k != 0)
    assert_same_results([clean[k] for k in got if k != 0], [got[k] for k in got if k != 0])
    s = eng.stats()
    assert s["health_quarantined_total"] == s["health_failed_total"] == 1
    eng, got = poisoned(lambda: make(health_retries=1), reqs)
    assert_same_results(list(clean.values()), list(got.values()))
    assert eng.stats()["health_retried_total"] == 1 and eng.stats()["health_failed_total"] == 0
    # The counterfactual: with the sentinel off the poisoned row completes with non-finite times.
    _, got = poisoned(lambda: make(health_sentinel=False), reqs)
    assert got[0].ok and not torch.isfinite(got[0].batch.time_delta).all()
    assert torch.isfinite(got[1].batch.time_delta).all()


def test_the_poison_is_written_in_place_where_the_next_forward_reads_it():
    make, reqs = ci_case()
    eng = make()
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    eng.plan_and_dispatch()
    buf, ptr = eng.big.time_delta, eng.big.time_delta.data_ptr()
    cursor = eng.cursor.clone()
    eng._poison_slots([1])
    assert eng.big.time_delta is buf and buf.data_ptr() == ptr
    assert torch.isnan(buf[1, max(int(cursor[1]) - 2, 0)]) and torch.isnan(buf).sum() == 1


# ------------------------------------------------------- (4) the service's options
def test_force_bypasses_a_full_lane():
    q = LaneQueues((LaneConfig("a", max_pending=1),))
    assert q.offer(1, "a") and not q.offer(2, "a") and q.offer(3, "a", force=True) and q.depth("a") == 2
    ci = build_ci()
    svc = ServingService([port_engine(ci)], lanes=(LaneConfig("interactive", max_pending=1),))
    _, items = items_for(ci, n=3)
    assert svc.submit(items[0][1]) and not svc.submit(items[1][1])
    assert svc.submit(items[2][1], force=True) and svc.lanes.depth("interactive") == 2 and svc._next_index == 2
    assert svc.stats()["lanes"]["interactive"]["rejected"] == 1


def test_fork_takes_request_ids_and_step_without_placement_places_nothing():
    ci = build_ci()
    svc = ServingService([port_engine(ci, **PAGED)], seed=3)
    row = items_for(ci)[1][1][1].prompt
    with pytest.raises(ValueError, match="request_ids has 1 entries for 2 branches"):
        svc.fork(row, 2, 3, request_ids=["x"])
    assert svc.fork(row, 2, 3, request_ids=["x", "y"]) == [1, 2]
    assert sorted(r.request_id for r in svc.run()) == ["x", "y"]
    svc = ServingService([port_engine(ci)])
    _, items = items_for(ci, n=2)
    for _, r in items:
        svc.submit(r)
    assert svc.step(lambda: 0.0, place=False) == [] and svc.lanes.pending == 2 and not svc.resident_busy()
    svc.step(lambda: 0.0)
    assert svc.lanes.pending == 0 and svc.resident_busy()


# ----------------------------------------------------------------- (5) preemption
def test_an_in_process_drain_returns_the_completed_results():
    """Requests placed before the shutdown complete; the lane backlog and the
    trace's later arrivals are abandoned (a service, then a fleet)."""
    ci = build_ci()
    svc = ServingService([port_engine(ci)], seed=4)
    _, items = items_for(ci, n=5)
    for _, r in items:
        svc.submit(r)
    svc.step(lambda: 0.0)  # places two requests on the engine's two slots
    shutdown = GracefulShutdown()
    shutdown.request()
    with pytest.raises(Preempted, match="drained 2 completed results; 3 queued") as exc:
        svc.run(shutdown=shutdown)
    assert [r.admission_index for r in exc.value.results] == [0, 1] and all(r.ok for r in exc.value.results)
    assert not svc.resident_busy() and svc.lanes.pending == 3
    ref = port_engine(ci, seed=4).run([r for _, r in items[:2]])
    assert_same_results(ref, [dataclasses.replace(r, request_id=r.admission_index) for r in exc.value.results])
    fleet = ServingFleet([ServingService([port_engine(ci)]), ServingService([port_engine(ci)])])
    for s, r in items:
        fleet.submit(s, r)
    for svc in fleet.services.values():
        svc.step(lambda: 0.0)
    with pytest.raises(Preempted, match="fleet preempted") as exc:
        fleet.run(items_for(ci, n=8, start=5)[1], use_arrival_times=True, shutdown=shutdown)
    done = exc.value.results
    assert 0 < len(done) < 5 and all(r.ok for r in done) and fleet.stats()["accepted_total"] == 5
    assert not any(s.resident_busy() for s in fleet.services.values())
    assert EXIT_PREEMPTED == 85


SERVE_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "eventstreamgpt_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import numpy as np
from eventstreamgpt_tpu_torch.convert import init_params_from_seed
from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
from eventstreamgpt_tpu_torch.reliability import EXIT_PREEMPTED, GracefulShutdown, Preempted
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, ServingFleet, ServingService
from eventstreamgpt_tpu_torch.training import build_model

config = serving_config(precision="fp32", sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64)
model = init_params_from_seed(build_model(config), seed=0)
prompts = synthetic_prompts(np.random.default_rng(0), 400, config, (5, 10), (3, 5))
engine = lambda: GenerationEngine(model, config, template=prompts[0][0], device="cpu", n_slots=4, max_len=16,
                                  min_bucket=4, decode_chunk=2)
fleet = ServingFleet([ServingService([engine()]), ServingService([engine()])])
trace = [(f"subject-{{i}}", Request(prompt=p, max_new_events=b, arrival_time=0.02 * i)) for i, (p, b) in enumerate(prompts)]
with GracefulShutdown() as shutdown:
    print("READY", flush=True)
    try:
        fleet.run(trace, use_arrival_times=True, shutdown=shutdown)
    except Preempted as e:
        print(f"DRAINED {{len(e.results)}}", flush=True)
        sys.exit(EXIT_PREEMPTED)
print("UNREACHED", flush=True)
"""


def test_sigterm_exits_85_with_the_completed_results(tmp_path):
    script = tmp_path / "serve.py"
    script.write_text(SERVE_SCRIPT.format(repo=str(REPO)))
    proc = subprocess.Popen([sys.executable, str(script)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))  # fmt: skip
    try:
        assert "READY" in proc.stdout.readline()
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == EXIT_PREEMPTED, out
    assert "DRAINED" in out and "UNREACHED" not in out
