"""What the port's captured programs depend on, checked on the CPU.

The serving engine's decode chunk and the train step run on the card as
CUDA graphs (`eventstreamgpt_tpu_torch.utils.graphs`): captured once,
replayed with every tensor they touch at the address it had at capture. No
graph can be captured here, so these tests hold the conditions capture
relies on:

* the engine's state tensors keep their addresses across chunks,
  admission of padded groups, harvests with their extraction, and
  ``reset()`` (float and int8 caches);
* the chunk function gives bit for bit what a loop of steps that rebind
  the engine's state gives (greedy and sampled);
* the salts kernel A bakes into a captured chunk are the same at every step;
* the replay-delta launch accounting, with a stub counted function and a
  stub graph, and the list of counted wrappers is complete;
* the train step keeps its parameters, gradients and AdamW state at fixed
  addresses, and the capturable optimizer's rate tensor follows
  ``schedule(step)``, written in place.
"""

import contextlib
import copy
import inspect

import numpy as np
import pytest
import torch

import eventstreamgpt_tpu_torch.serving.engine as engine_module
from eventstreamgpt_tpu_torch import ops
from eventstreamgpt_tpu_torch.convert import init_params_from_seed
from eventstreamgpt_tpu_torch.data.synthetic import (
    serving_config,
    synthetic_prompts,
    synthetic_training_batches,
    training_config,
)
from eventstreamgpt_tpu_torch.generation.generation_utils import _slice_preds_at, _trim_to_event
from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
from eventstreamgpt_tpu_torch.ops.tensor_ops import take_event
from eventstreamgpt_tpu_torch.generation.sampling import append_new_event, update_last_event_data
from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request
from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step, train_steps
from eventstreamgpt_tpu_torch.training.optimizer import make_capturable, polynomial_decay_with_warmup
from eventstreamgpt_tpu_torch.utils import graphs
from eventstreamgpt_tpu_torch.utils.graphs import COUNTED, CapturedProgram, counted_wrappers

SMALL = dict(sizes=(5, 8, 6, 3), hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4)
ENGINE = dict(n_slots=2, max_len=16, min_bucket=4, decode_chunk=3)
OPT = dict(init_lr=1e-3, end_lr=1e-6, lr_num_warmup_steps=2, lr_frac_warmup_steps=None, max_training_steps=6)


@pytest.fixture(scope="module")
def served():
    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, **SMALL)
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=0)
    prompts = synthetic_prompts(np.random.default_rng(0), 5, config, (6, 10), (3, 5))
    return config, model, prompts


def requests(prompts):
    return [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]


def engine(served, **kw):
    config, model, prompts = served
    return GenerationEngine(model, config, template=prompts[0][0], device="cpu", **dict(ENGINE, **kw))


def state_tensors(eng) -> dict:
    """Every tensor the decode chunk reads or writes outside its temporaries."""
    out = {f"big.{k}": v for k, v in vars(eng.big).items() if torch.is_tensor(v)}
    names = engine_module._CHUNK_STATE + ("base_len", "budget", "live", "seeds", "_boundary")
    names += ("key_cache", "value_cache", "key_scale", "value_scale")
    out.update({k: getattr(eng, k) for k in names if getattr(eng, k) is not None})
    return out


def addresses(eng) -> dict:
    return {k: t.data_ptr() for k, t in state_tensors(eng).items()}


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_engine_state_keeps_its_addresses(served, kv_cache_dtype):
    eng = engine(served, kv_cache_dtype=kv_cache_dtype)
    eng.scheduler.group_sizes = (2,)  # a lone request's group is padded to 2 rows
    widths, dispatch = [], eng._dispatch_group
    eng._dispatch_group = lambda g: (widths.append((len(g.requests), g.group_size)), dispatch(g))
    want = addresses(eng)
    assert ("key_scale" in want) == (kv_cache_dtype == "int8")
    for r in requests(served[2]):
        eng.submit(r)
    assert eng.plan_and_dispatch() > 0  # admission
    assert addresses(eng) == want
    eng.issue_chunk()
    eng.issue_chunk()
    assert addresses(eng) == want
    eng.resolve_chunk(0.0)
    assert addresses(eng) == want
    results = eng.run()  # the rest: harvests, refills, more chunks
    assert addresses(eng) == want
    assert all(r.error is None for r in results)
    assert (1, 2) in widths
    eng.reset()
    assert addresses(eng) == want
    assert all(r.error is None for r in eng.run(requests(served[2])))
    assert addresses(eng) == want
    s = eng.stats()
    assert (s["cuda_graph"], s["graph_captures"], s["graph_replays"]) == (False, 0, 0)
    assert (s["prefill_graph_captures"], s["extract_graph_captures"]) == (0, 0)


def per_step_chunk(eng) -> None:
    """The decode chunk as a loop of steps that each bind the engine's state
    names to new tensors, and its boundary stacked afresh (the stream words in
    int64 through the chunk, as the hash takes them)."""
    cfg, m = eng.config, eng._model
    seeds, eng.counters = eng.seeds.long(), eng.counters.long()
    for _ in range(eng.decode_chunk):
        active = eng.live & ~eng.done
        view = _trim_to_event(eng.big, eng.cursor - 1)
        h0 = m.encoder.input_layer(view)[:, 0]
        h, _, _, _, _, eng.cache_mask, eng.cache_len = decode_stack_step(
            eng._stacked, eng.key_cache, eng.value_cache, h0, eng.cache_len, view.event_mask[:, 0], eng.cache_mask,
            windows=eng._windows, activation=cfg.activation_function, layer_norm_eps=float(cfg.layer_norm_epsilon),
            active=active, key_scale=eng.key_scale, value_scale=eng.value_scale,
        )  # fmt: skip
        out = m.output_layer(view, m.encoder.ln_f(h[:, None, :]), is_generation=True)
        preds_last = _slice_preds_at(out.preds, 0)
        em_last = take_event(eng.big.event_mask, eng.cursor - 1)
        sample = eng._sample_rows(preds_last, em_last, seeds, eng.counters, active=active)
        append_new_event(eng.big, sample, eng.cursor, active)
        update_last_event_data(eng.big, sample, cfg, eng.cursor + 1, eng._to_fill, active)
        eng.cursor = torch.where(active, eng.cursor + 1, eng.cursor)
        eng.n_generated = eng.n_generated + (active & sample.event_mask).to(torch.int32)
        eng.counters = torch.where(active, eng.counters + 1, eng.counters)
        done = eng.done | (active & eng._row_done(eng.big, eng.cursor, eng.base_len, eng.n_generated, eng.budget))
        hit = active & eng._rows_nonfinite(preds_last, sample)
        eng.done, eng.health = done | hit, eng.health | hit
        eng.active_steps = eng.active_steps + active.sum()
    eng.counters, eng.active_steps = eng.counters.int(), eng.active_steps.int()
    eng._boundary = torch.stack(
        [eng.done.to(torch.int32), eng.cursor, eng.base_len, eng.n_generated, eng.health.to(torch.int32)]
    )


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_chunk_function_equals_the_per_step_loop(served, greedy):
    chunked = engine(served, greedy=greedy)
    looped = engine(served, greedy=greedy)
    looped._decode_chunk = lambda: per_step_chunk(looped)
    a, b = chunked.run(requests(served[2])), looped.run(requests(served[2]))
    assert len(a) == len(b) == len(served[2])
    for x, y in zip(a, b):
        assert (x.request_id, x.n_events, x.n_generated, x.error) == (y.request_id, y.n_events, y.n_generated, None)
        for k, t in vars(x.batch).items():
            if torch.is_tensor(t):
                assert torch.equal(t, getattr(y.batch, k)) or (t.is_floating_point() and torch.equal(
                    t.nan_to_num(-7.0), getattr(y.batch, k).nan_to_num(-7.0))), k  # fmt: skip
    for k, t in state_tensors(chunked).items():
        assert torch.equal(t, state_tensors(looped)[k]), k
    assert chunked.stats()["active_slot_steps"] == looped.stats()["active_slot_steps"] > 0


def test_row_stream_salts_are_the_same_at_every_step(served, monkeypatch):
    """Kernel A takes each draw's salt as a host integer, which capture bakes
    into the graph: it must depend on the head and the draw, not the step."""
    eng = engine(served, greedy=False)
    salts, real = [], engine_module.fused_categorical_stream

    def recording(logits, stream, keep=None, active=None, fill=0):
        if active is not None:  # a decode step (a prefill passes no active mask)
            salts.append(copy.copy(stream).next_draw_salt())
        return real(logits, stream, keep, active, fill)

    monkeypatch.setattr(engine_module, "fused_categorical_stream", recording)
    for r in requests(served[2]):
        eng.submit(r)
    eng.plan_and_dispatch()
    eng.issue_chunk()
    eng.issue_chunk()
    per_step = len(salts) // (2 * eng.decode_chunk)
    assert per_step >= 1 and len(salts) == per_step * 2 * eng.decode_chunk
    steps = [salts[i : i + per_step] for i in range(0, len(salts), per_step)]
    assert all(s == steps[0] for s in steps)


class StubGraph:
    def __init__(self):
        self.replayed, self.generators = 0, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replayed += 1


def stub_program(fn, counters, **kw):
    return CapturedProgram(fn, "the stub program", device="cpu", counters=counters, graph=StubGraph,
                           graph_context=lambda g, stream: contextlib.nullcontext(), **kw)  # fmt: skip


def test_replay_adds_the_capture_delta_to_the_launch_counters():
    def kernel():
        kernel.launches += 1

    def other():
        other.launches_int8 += 1

    kernel.launches, other.launches_int8 = 5, 0
    gen = torch.Generator()

    def program():
        kernel()
        kernel()
        return torch.zeros(())

    prog = stub_program(program, [(kernel, "launches"), (other, "launches_int8")], generators=(gen,))
    prog.warmup()  # eager: real launches
    assert kernel.launches == 7
    prog.capture()  # records, launches nothing
    assert kernel.launches == 7 and prog.graph.generators == [gen]
    assert prog.delta == [(kernel, "launches", 2)]
    for _ in range(3):
        out = prog.replay()
    assert kernel.launches == 13 and other.launches_int8 == 0
    assert prog.graph.replayed == 3 and (prog.warmups, prog.captures, prog.replays) == (1, 1, 3)
    assert out is prog.output
    with pytest.raises(RuntimeError, match="captured already"):
        prog.capture()


def test_a_failed_capture_raises_and_leaves_the_counters():
    def kernel():
        kernel.launches += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    kernel.launches = 0
    prog = stub_program(kernel, [(kernel, "launches")])
    with pytest.raises(RuntimeError, match="capturing the stub program into a CUDA graph failed"):
        prog.capture()
    assert kernel.launches == 0 and prog.graph is None and prog.captures == 0


def test_counted_wrappers_are_every_kernel_wrapper():
    """Every function of the ops modules with a launch counter is listed, and
    every listed counter exists (the default of `CapturedProgram`)."""
    listed = {(fn.__name__, attr) for fn, attr in counted_wrappers()}
    found = set()
    for module in {m for m, _, _ in COUNTED} | {"band_attention", "kv_quant", "tensor_ops", "build"}:
        mod = __import__(f"{ops.__name__}.{module}", fromlist=["_"])
        for _, fn in inspect.getmembers(mod, inspect.isfunction):
            found |= {(fn.__name__, a) for a in vars(fn) if a.startswith("launches")}
    assert listed == found
    assert graphs.counted_wrappers()[0][0].launches >= 0


@pytest.fixture(scope="module")
def trained():
    batch = next(synthetic_training_batches(np.random.default_rng(0), serving_config(**SMALL), 4, 24))
    return training_config([batch], precision="fp32", **SMALL), batch


def test_train_step_keeps_its_state_at_fixed_addresses(trained):
    config, batch = trained
    model = init_params_from_seed(build_model(config), seed=0)
    optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
    step = make_train_step(model, optimizer, scheduler, device="cpu", with_health=True)

    def snapshot():
        ptrs = {f"param.{n}": p.data_ptr() for n, p in model.named_parameters()}
        ptrs.update({f"grad.{n}": p.grad.data_ptr() for n, p in model.named_parameters() if p.grad is not None})
        for i, st in enumerate(optimizer.state.values()):
            ptrs.update({f"adam.{i}.{k}": v.data_ptr() for k, v in st.items()})
        return ptrs

    step(batch, 0)
    first = snapshot()
    assert any(k.startswith("grad.") for k in first) and any(k.startswith("adam.") for k in first)
    losses = [float(step(batch, 0)[0]) for _ in range(2)]
    assert snapshot() == first
    assert all(np.isfinite(losses)) and step.state.step == 3
    assert step.stats() == {"cuda_graph": False, "batch_signatures": 1, "graph_warmup_steps": 0,
                            "graph_captures": 0, "graph_replays": 0}  # fmt: skip


def test_train_step_is_the_same_whatever_the_grads_held(trained):
    """Grads are zeroed in place, not dropped: a step after other work gives
    what a fresh step gives, bit for bit."""
    config, batch = trained
    base = init_params_from_seed(build_model(config), seed=0)

    def losses(pre):
        model = copy.deepcopy(base)
        optimizer, scheduler = build_optimizer(model, OptimizationConfig(**OPT))
        step = make_train_step(model, optimizer, scheduler, device="cpu")
        for p in model.parameters():
            p.grad = torch.full_like(p, pre)  # whatever a caller left behind
        return train_steps(step, [batch] * 3, seed=1), [p.detach().clone() for p in model.parameters()]

    (a, pa), (b, pb) = losses(0.0), losses(3.0)
    assert a == b
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_capturable_learning_rate_follows_the_schedule():
    """`make_capturable`'s rate tensor holds ``schedule(step)`` before every
    step, written in place by the scheduler: the float path's rate, in fp32."""
    module = torch.nn.Linear(3, 2)
    twin = copy.deepcopy(module)
    optimizer, scheduler = build_optimizer(module, OptimizationConfig(**OPT))
    float_opt, float_sched = build_optimizer(twin, OptimizationConfig(**OPT))
    make_capturable(optimizer, "cpu")
    lr = optimizer.param_groups[0]["lr"]
    assert optimizer.param_groups[0]["capturable"] and lr.dtype == torch.float32 and lr.ndim == 0
    schedule = polynomial_decay_with_warmup(OPT["init_lr"], OPT["end_lr"], 2, OPT["max_training_steps"])
    for k in range(OPT["max_training_steps"] + 2):
        assert optimizer.param_groups[0]["lr"] is lr
        assert lr.item() == np.float32(float_opt.param_groups[0]["lr"])
        np.testing.assert_allclose(lr.item(), schedule(k), rtol=1e-6, atol=1e-12)
        optimizer.step()  # no gradients: nothing moves
        scheduler.step()
        float_opt.step()
        float_sched.step()
    with pytest.raises(ValueError, match="taken a step"):
        twin.weight.grad = torch.ones_like(twin.weight)
        float_opt.step()
        make_capturable(float_opt, "cpu")
