#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``eventstreamgpt_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (a failed phase exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit (``nvidia-smi``), TF32 off, the
   kernels built from the checkout's sources (one ``nvcc`` per ``csrc/``
   source, all at once).
2. Engine at full width: the serving benchmark's CI model (hidden 256,
   4 heads x 64, 2 layers local/global with window 32, intermediate 1024,
   lognormal-mixture TTE with 3 components, bf16, a 4,057-entry vocabulary
   laid out as ``data/synthetic.py`` writes it) with numpy-seeded random
   weights behind `GenerationEngine` (32 slots, ``max_len`` 256, prompts up to
   192 events, buckets from 32, chunks of 16), serving 64 requests with
   prompts of 128-192 events and budgets of 16-64 new events, once greedy
   and once sampled. Each engine serves them three times, as a benchmark
   times an engine: a warm pass, ``reset()``, a pass that fetches every
   row, ``reset()``, and a pass with ``fetch_results=False`` (its events/s
   are the ones a throughput benchmark reads). The engine captures its
   decode chunk at construction (one warm-up chunk run eagerly, then the
   capture), each prefill (bucket, group width) key and each extraction
   width at its first use in the warm pass (one warm-up on inert rows, then
   the capture), and replays them: one capture a key, none after
   ``reset()``, one decode replay a dispatched chunk and one prefill replay
   a prefill dispatch. Every request must finish without error, with
   ``n_events == prompt_len + n_generated`` and finite outputs; the passes
   after ``reset()`` give the warm pass's events, integers and floats bit for
   bit (the accounting pass no rows and the same accounting). Both kernels'
   launch counters, set to 0 before the engine is built and before each
   later pass and counting through the replays, must move (kernel A, which
   the engine calls as `fused_categorical_stream`, only samples); kernel B
   launches once a decode step run, warm-up chunk included; kernel A
   launches as often as in the eager engine, plus the warm-ups. The same
   engine with ``cuda_graph=False`` (every program run eagerly) must give
   every request's events, integers and floats bit for bit in every pass
   (the same kernels on the same inputs in the same order); the wall time,
   a chunk, a step and events/s of both are printed, with
   ``slots_report()`` at the card's memory. A small fp32 greedy engine on
   the card whose groups are padded (group sizes 4 and 8 at 8 slots) must
   also match the same engine on the CPU (plain PyTorch versions of the
   kernels).
3. Kernels against their plain versions, on the card, on inputs captured
   from the eager sampled run's first decode step (the logits, the stream's seeds,
   counters and draw salt, keep and active): kernel A's noise bit for bit
   ``gumbel(stream).to(dtype)`` (at the captured shape and on a 4,096 x
   4,057 plane), and the indices of both its entries (noise drawn inside,
   noise given) exactly equal to their plain versions' (fp32 and bf16, with
   and without keep and active masks; then 4,096 rows of fresh seeds and
   counters at V = 40 and 4,057 with NaN, +inf and all--inf rows). Kernel A
   is timed with the noise drawn inside beside its plain version (the ATen
   noise and the reference), ``torch.argmax`` of the given noise plus the
   logits, the ATen ``gumbel(stream)`` alone (what the kernel replaces) and
   the launch floor (an empty kernel, timed the same way); kernel
   B's ``h`` within rtol=atol=1e-4 in fp32 and atol=2e-2 in bf16, cache
   positions other than the cursor bit-equal, the cursor entries within the
   same tolerances, mask and length exact; B's cluster shape and CTAs.
3b. The quantized decode cache: phase 2's model and 64 requests served with
   ``kv_cache_dtype`` "int8" and then "fp8", greedy and sampled, at
   ``dispatch_depth=2``, in three passes each as in phase 2, on the captured
   programs (every request finishes with
   ``n_events == prompt_len + n_generated`` and finite outputs; kernel B's
   quantized launch counter for that dtype and, sampling, kernel A's counter
   move; the float entry never launches; kernel B launches once a decode step
   run; the captures and replays of phase 2; each pass after ``reset()``
   equal to the warm pass). Each sampled run is repeated with the eager
   programs and must give the same events, integers and floats bit for bit,
   and kernel A's launches as in phase 2. A small fp32 int8 engine on the card must
   match the same engine on the CPU (events and integers exact, floats within
   2e-2, the JAX package's quantized-cache tolerance). Quantized
   B against its plain version on the inputs captured from each sampled
   eager run's first decode step, fp32 and bf16: codes and scales off the cursor
   bit-equal, the dequantized cursor keys and values within phase 3's
   tolerances (of each row's largest) plus one quantisation step, ``h``
   within phase 3's tolerance
   on the rows whose cursor codes agree (a key one rounding apart can move
   a code by a step), mask and length exact. Printed, not checked: quantized
   B's time beside the bf16 B on the same rows (dequantized), its bound and
   its plain version's; the share of greedy requests whose events equal the
   bf16 run's; ``slots_report()`` at the card's own memory (int8 and fp8).
4. Training at full width: the same model with dropout 0.1 and fp32 master
   weights, AdamW with warmup (``bench.py``'s optimizer settings), 20 train
   steps through `make_train_step` on one fixed synthetic batch of 32
   subjects x 256 events (up to 24 data elements an event): the first step
   eager (its warm-up), the second captured, and that and every later step
   one replay. Every loss is finite, the loss falls from step 1 to step 20,
   and kernel C's forward and backward each launch exactly once a step,
   counted through the replays. 20 steps of the same model with
   ``cuda_graph=False`` must give the first 5 losses and ``[loss, grad
   norm]`` vectors bit for bit (a difference would mean the dropout stream
   or the learning rate went wrong under capture). Median step time and
   trained events/s (real events a step over the step time), captured and
   eager. A small fp32
   train step on the card must also match the same step on the CPU (loss
   and every gradient within 1e-4, dropout 0).
5. Kernel C against its plain version, on the card, on the regression
   plane, indices and cotangent captured from phase 4's first step, in bf16 and
   fp32: forward bit-exact; backward within one bf16 ulp (fp32: rtol 1e-6,
   atol 1e-6 of the largest cotangent), the plain version summing
   duplicates with atomics in no fixed order; the kernel's backward also
   equals the CPU's plain version (ordered sums) bit for bit. The backward's
   write rate of the plane beside its bound, the forward beside the launch
   floor.
6. Nested-attention training at full width: ``bench.py``'s NA model (the
   phase-4 widths with three dep-graph levels ``[[], ["event_type"], ["lab",
   "med"]]``, global dep-graph attention, bare sequence attention and a full
   dep-graph block) with dropout 0.1, 20 train steps through
   `make_train_step(build_model(...))` on the phase-4 batch. Every loss and
   gradient norm is finite, the loss falls from step 1 to step 20, kernel D's
   forward and backward each launch ``num_hidden_layers`` times a step and
   kernel C's once a step; captured and compared with the eager step as in
   phase 4. Median step time and trained events/s. A small
   fp32 NA train step on the card must also match the CPU's (loss and every
   gradient within 1e-4, dropout 0; hidden 32, one head of 32), and at hidden
   128 (4 heads of 32) the same step with kernels C and D must match the
   step with their plain versions on the card (loss within 1e-5, every
   gradient within 2e-5 of its tensor's largest magnitude).
7. Kernel D against its plain version, on the card, on the query (as the
   ``[:, 1:]`` view the model passes), key, value, keep-mask and output
   cotangent (scaled to a largest magnitude of 1) captured from phase 6's
   first step, in bf16 and fp32, with and without the keep-mask: forward and
   backward within 1e-5 of the largest magnitude in fp32; in bf16 within
   1e-2 of it, and the output also within 2e-2 absolute. Timed in bf16 with the
   keep-mask beside its bound, its plain version (autograd for the
   backward) and ``scaled_dot_product_attention`` with the same graph mask
   and no dropout (a yardstick only: it takes no external keep-mask).
8. Packed long-context training at full width: ``bench.py``'s packed model
   (the phase-4 widths under ``attention_implementation="pallas_flash"`` with
   attention dropout 0, input and residual dropout 0.1) on its packed batch:
   the first of ``packed_batches(synthetic_csr(seed 0, 512 subjects), 8,
   seq_len=1024, seed=1)``. 20 steps with the benchmark's local window of 32
   (the global layer on kernel E, the local one on the band product): kernel
   E and kernel C each launch once a step each way, kernel F never. Then 10
   steps with a local window of 256: kernels E and F each launch once a step
   each way. Every loss is finite and falls; each run captured and compared
   with the eager step as in phase 4. Small fp32 packed steps on the
   card must match the CPU's (hidden 32, one head of 32, windows 32 and 160,
   within 1e-4; both given the same float64-derived event time), and at
   hidden 128 (4 heads of 32, window 160) the step with kernels C, E and F
   must match the step with their plain versions on the card (loss within
   1e-5, every gradient within 2e-5 of its tensor's largest).
9. Kernels E and F against their plain versions, on the card, on the query,
   key, value, segment ids and output cotangent (scaled to a largest
   magnitude of 1) captured from a phase-8 run's first step (E from the window-32 run,
   F from the window-256 run), in fp32 (within 3e-5 of each tensor's
   largest) and bf16 (within 5e-2 of it: the kernel takes ``di`` from the
   rounded output, as the TPU kernels do), each version's distance from the
   function computed in fp64 printed beside; then timed in bf16 beside their
   bound (bytes of q, k, v, o, segment ids and each row's softmax statistics,
   plus do, dq, dk, dv backward; FLOPs of the batch's allowed pairs), their plain
   versions and ``scaled_dot_product_attention`` with the same boolean mask.
   Beside: the 64 x 64 tiles each kernel walked (forward, dq, dk/dv), counted
   on the card and held equal to what `tile_schedule` visits, on the batch
   and with one segment a row (every causal tile), their share of the causal
   (and window) tiles (``visited_share``), and each kernel's time on the same
   q, k, v with one segment a row, where no tile is skipped.
10. The device-resident chunked train step (``bench.py``'s training
   program): `data.synthetic.synthetic_csr` of 512 subjects (numpy seed 0,
   ``bench.py``'s cohort) in `data.device_dataset.DeviceDataset`s on the
   card (``max_seq_len`` 256 and 1,024), and `make_chunked_train_step`
   (captured) for phase 4's CI model and phase 6's NA model on padded
   plans of 32 x 256 in chunks of 16 (one epoch a chunk), and phase 8's
   packed model on packed plans of 8 x 1,024 in fixed-size chunks of 4,
   at local windows 32 and 256: one warm chunk (plan seed 0, the key's
   eager warm-up), then 2 epochs (plan seeds 1, 2), the first capturing
   each key, the second only replaying. The same plans,
   collated by `DeviceDataset.batches` / ``packed_batches``, run from the
   same initial weights as single captured steps of `make_train_step`.
   Every loss and ``[loss, grad norm]``, every parameter and every AdamW
   state tensor must be equal bit for bit; the losses finite and falling;
   one warm-up and one capture a key, none in the second epoch; kernels C,
   D, E and F launched, counted through the replays (counts set to 0 just
   before the chunked run and read just after), as often as the single
   steps launch them, which is the steps times one step's launches (C 1,
   D 2 (NA), E 1 (packed), F 1 (window 256)). Printed beside the card's
   name and power limit: trained events/s of each epoch, chunked and
   single-step (an epoch from its first call to a synchronise after its
   last, the events from the plans); the plan bytes a step; each key's
   capture and instantiation seconds; the peak memory of each run.
11. The paged copy-on-write cache and ``fork()`` at phase 2's width, on
   phase 2's model and 64 requests with ``paged_kv=True`` and blocks of 16
   (the default pool, 32 x 16 + 1 = 513 blocks): bf16 greedy at
   ``dispatch_depth`` 2, bf16 sampled at depth 1 and int8 sampled at depth 2,
   each in phase 2's three passes, captured. Every pass equal to the warm
   pass; the warm pass equal bit for bit to the same engine run eagerly and
   to the monolithic engine's unfused step (``decode_step_impl="xla"``);
   kernel B's counters 0 in every pass (a paged engine decodes through the
   model's cached forward, as JAX's does), kernel A's moving on sampled runs
   through the replays; block 0 of every pool plane zero after each pass;
   after ``reset()`` no block in use and the high-water mark kept. Then 16
   of the prompts forked 4 ways (sampled, session seeds 1000 + i), twice
   (warm, after ``reset()``): blocks shared after the first admission, one
   prefill replay a fork group (the group staged as its branches'
   independent submissions), every branch equal bit for bit to an
   independent request with ``derive_request_seed(session, j)`` on an engine
   whose groups are 4 wide (the fork's width), and the second pass equal to
   the first. Measured and printed, not checked: whether a batch-1 forward of
   each fork prompt (JAX's fork forward) gives row 0 of the 4-row group's
   forward bit for bit (predictions at the last prompt event, every layer's
   keys and values). Printed with
   the card's name and power limit: events/s of the paged, monolithic
   unfused and monolithic kernel-B engines on the same requests (captured,
   depth 1, accounting pass), the fork run's and ``slots_report()["paged"]``
   at the card's memory and branch factor 4 (the decode steps' profiles are
   phase 12's, after its captures: no capture follows a profile).
12. Speculative decoding at phase 2's width: phase 2's model as the target,
   ``bench.py``'s draft (`serving.spec.truncated_draft`, the first
   ``num_hidden_layers // 2`` = 1 layer) and ``k`` 4, on phase 2's 64
   requests: bf16 greedy at zero tolerances (depth 2), bf16 sampled at the
   default tolerances (depths 1 and 2) and int8 sampled (depth 2), captured:
   bf16 sampled at depth 1 in phase 2's three passes, the others in the warm
   and accounting passes only (to keep the script's time): every request
   finishes with ``n_events == prompt_len + n_generated`` and finite
   outputs, the fetching pass after ``reset()`` equals the warm pass bit for
   bit and every accounting pass has its accounting (each with the same
   per-request proposals and acceptances), one capture a key and none after
   ``reset()``, one spec-chunk replay a dispatched chunk (16 rounds each),
   kernel A's counter moving on sampled runs and kernel B's counters (every
   entry) 0 (captured against eager is the small engine's check below and the
   ``spec`` CUDA tests'; the full-width eager twins went to pay for phase 19). A
   perfect draft (the target itself, tolerant greedy) must accept more than
   0.9 in fp32 (the same weights); a small fp32 greedy spec engine (zero
   tolerances) on the card must match the same engine on the CPU (phase 2's
   small-engine tolerances). Printed, not checked, beside the card's name
   and power limit: each run's events/s (accounting pass), acceptance rate
   and committed events a slot and round; ``slots_report()`` with the draft
   charged; one profiled 16-step chunk of each decode step at 32 admitted
   slots (paged, monolithic unfused, kernel B; device ms and kernels a
   step), taken after phase 13's captures (no capture follows a profile).
   The bf16 perfect draft, the monolithic engines' events/s and the spec
   round's profiles, all measured and not checked, went to pay for phase 19
   (``tools/profile_decode.py --spec`` takes the round's).
13. Cohort ``generate()`` (`generation.generate`, ``bench.py``'s generation
   arm): phase 4's CI model and phase 6's NA model (bf16, numpy-seeded
   weights) on one batch of 32 prompts of 192 real events
   (`data.synthetic.synthetic_prompt_batch`, numpy seed 0), 64 new events
   (NA: 16), cached, sampled, seed 2. The first call warms up and captures
   the key's prefix and decode-step programs; a second call must capture
   nothing, replay the prefix once and the step ``max_new_events - 1``
   times, equal the first bit for bit, give every row its budget with finite
   values and launch kernel A once a categorical head a level (NA: also once
   a head at the prefix's full forward); the ``cuda_graph=False`` call must
   equal it bit for bit with kernel A launched as often; a run stopped by a
   custom criterion at 8 events must be a prefix of the full run. Small fp32
   CI and NA models (one head of 32): greedy on the card equals the CPU,
   cached and uncached (events and integers exact, floats within 1e-4);
   sampled cached equals uncached on the card (CI: indices exact, floats
   within 1e-3; NA: times within the JAX package's rtol 0.1 and atol 1e-3,
   the first new event's type exact, the share of equal events printed:
   later draws may differ by design, the cached walk having embedded each
   graph element before the event's later levels were written); the uncached NA run launches kernel D
   once a layer a level an event. Printed, not checked, beside the card's
   name and power limit: generated events/s of the second call, phase 2's
   sampled engine events/s, and one profiled replay of each model's prefix
   and decode-step programs (device ms and kernels), taken after every capture.
14. The nested-attention serving engine at phase 2's settings: phase 6's NA
   model (bf16, numpy-seeded weights, ``bench.py``'s three dep-graph levels)
   behind `GenerationEngine` (32 slots, ``max_len`` 256, prompts up to 192,
   buckets from 32, chunks of 16), serving 64 requests with prompts made for
   its config as phase 2 makes its own: bf16 greedy, bf16 sampled and int8
   sampled, captured (one capture a key, none after ``reset()``): bf16
   sampled in phase 2's three passes and against the same engine with
   ``cuda_graph=False`` (warm pass, bit for bit), the others in the warm and
   accounting passes (to pay for phase 19). Every request finishes with
   ``n_events == prompt_len + n_generated`` and finite outputs; each pass
   after ``reset()`` equals the warm pass (bit for bit, or in its
   accounting); kernel A launches (bf16 sampled) as often as the eager
   engine after ``reset()`` and that count plus the warm-ups in the warm
   pass; kernels B and D never
   launch (the NA step is the unfused level walk, the cached dep-graph
   attention the einsum path, as in JAX). A small fp32 greedy NA engine on
   the card must match the same engine on the CPU (groups padded; phase 2's
   tolerances). Printed, not checked, beside the card's name and power
   limit: each run's events/s (accounting pass), ``slots_report()`` at the
   card's memory, and one profiled 16-step chunk of the sampled engine at 32
   admitted slots (device ms and kernels a step), taken after every capture,
   beside phase 12's profile of phase 2's unfused CI step and phase 13's NA
   ``generate()`` step.
15. Speculative decoding on the NA engine at phase 14's settings: phase 14's
   NA model as the target, ``bench.py``'s draft (`serving.spec.truncated_draft`,
   the first ``num_hidden_layers // 2`` = 1 layer) and ``k`` 4, on the first
   32 of phase 14's 64 requests (one wave of the 32 slots): bf16 sampled at the default tolerances, int8 sampled and bf16
   greedy at zero tolerances (depth 2), captured: bf16 sampled in phase 2's
   three passes, the others in the warm and accounting passes: every request finishes with ``n_events == prompt_len +
   n_generated`` and finite outputs, each pass after ``reset()`` equals the
   warm pass bit for bit (with the same per-request proposals and
   acceptances), one capture a key and none after ``reset()``, one replay a
   dispatched chunk (16 rounds each) and a prefill dispatch, kernel A's
   counter moving on the sampled runs, kernels B and D at 0 (captured against
   eager is the small NA spec engine's check below and the ``na_spec`` CUDA
   tests'; the full-width eager twin went to pay for phase 19). A perfect draft (the target itself, tolerant greedy) must
   accept more than 0.9 in fp32; a small fp32 greedy NA spec engine (zero
   tolerances) on the card must match the same engine on the CPU (phase 2's
   small-engine tolerances). Printed, not checked, beside the card's name and
   power limit: each run's events/s (accounting pass), acceptance rate and
   committed events a slot and round; the bf16 sampled run's capture seconds
   and peak memory; the share of strict greedy requests whose events equal
   phase 14's greedy NA engine's; ``slots_report()`` with the draft charged.
   (Its profiled round went to pay for phase 19.)
16. The serving service at phase 2's settings: phase 2's model written with
   `training.save_pretrained` as checkpoint 1 and the same architecture
   from seed ``SEED + 1`` as checkpoint 2, both read back with
   `load_pretrained` (checkpoint 1 equal to phase 2's model bit for bit);
   phase 2's 64 requests, half in the ``interactive`` lane and half in
   ``batch``; sampled at the default settings, captured, depth 2, chunks of
   16, ``max_len`` 256. (a) `ServingService` over two 16-slot engines with a
   `PrefillStream` over a third, all on checkpoint 1, run twice (a new
   service over the same engines after ``reset()`` of each): every request
   finishes with ``n_events == prompt_len + n_generated`` and finite
   outputs, the second run equals the first bit for bit, the decode engines
   run no prefill program (one admission replay a handoff), the prefill
   engine one ``prefill_compute`` replay a dispatched group, kernels A and B
   count through the replays (B once a decode step of each replica); the
   same service greedy with and without the stream gives the same events
   and integers. (b) Hot swap under traffic: a 32-slot ``hot_swap`` engine
   on checkpoint 1 serves the second 32 requests (warming their program
   keys), then the first 32, with ``load_shadow(checkpoint 2)`` and
   ``probe_shadow()`` (``None``) while they decode; drained, ``flip()``,
   and the second 32 equal a fresh engine on checkpoint 2 bit for bit; a
   second ``flip()`` and they equal a fresh engine on checkpoint 1; no
   capture at or after either flip, every weight's address unchanged,
   kernel B launching after the flip; a shadow with one NaN fails the probe
   and leaves the live weights as they were; ``slots_report()`` doubles the
   weights once. (c) A small fp32 greedy service (hidden 32, two replicas
   and a stream) on the card matches the same service on the CPU (phase 2's
   small-engine tolerances). Printed, not checked, beside the card's name
   and power limit: the service's events/s and latency quantiles (p50 and
   p95 a lane and overall), the same service's events/s without the stream
   and a single 32-slot engine's; ``load_shadow``, ``probe_shadow`` and
   ``flip`` times (host wall, device ms by CUDA events); capture seconds;
   the service's and the stream's ``stats()``.
17. The serving fleet over phase 16's checkpoints 1 and 2: phase 2's 64
   requests under the subjects ``subject-000`` .. ``subject-031`` (two
   requests a subject), lanes alternating ``interactive`` and ``batch``,
   depth 2, chunks of 16, ``max_len`` 256, ``hot_swap=True`` on every
   engine; ``svc0`` two 16-slot replicas behind a `PrefillStream` over a third
   16-slot engine, ``svc1`` two 16-slot replicas with local prefill, one card.
   A request's results do not depend on the programs' shapes (its prefill
   group, the engine's slot count): the time cumsum accumulates in fp64 and
   the fp32 time-to-event product runs in fp64 on the card
   (`tools/row_invariance.py`), so runs of other shapes are held bit for bit.
   (a) Sampled, run twice (a new fleet over the same engines after
   ``reset()``): every request finished and finite, its ``service`` the
   ring's route, the second run equal to the first bit for bit, each
   service's requests equal to that service alone serving them with the
   fleet's seeds, kernels A and B counted through the replays (B once a
   decode step of each replica); greedy, run twice, bit for bit, and equal
   to one 32-slot engine serving the accepted set in order with the same
   seed. (b) On the greedy engines a ``death`` of ``svc1`` at its third
   chunk under `FleetHealthConfig()`: every request completes, ``svc1``
   evicted, sessions replayed, nothing dropped, every request (the replayed
   included) equal to (a)'s greedy run bit for bit. (c) On the greedy
   engines ``promote(checkpoint 2, at_time=0)`` armed for a run whose second
   32 requests arrive while ``svc0`` drains (first, an idle promotion to
   checkpoint 2, whose flipped weights equal a fresh engine's there, a run
   of those 32 there that captures the keys they need, and back to
   checkpoint 1, bit for bit): nothing dropped, both services and the
   prefill engine flip, every result on checkpoint 2 equal to a fresh
   32-slot engine there serving those requests with their bound seeds, the
   rest equal to (a)'s; no capture at or after a flip, every weight at its
   address, ``svc0`` decoding (kernel B) after its flip. (d) A
   ``corrupt_shadow`` on ``svc1`` makes an idle `promote` raise
   `PromotionError` with every live weight unchanged in contents and
   address; a ``flip_failure`` on ``svc1`` rolls ``svc0`` back onto
   checkpoint 1 bit for bit. (e) A ``nan_slot`` in slot 0 of ``svc0``'s
   first replica at its chunk 2 fails that request alone with
   `SlotHealthError`, the others equal to (a)'s bit for bit; the same fault
   on the 32-slot engine with ``health_retries=1`` retries from the bound
   seed, equal to (a)'s run; a 0.5 s ``hang`` of ``svc1`` under a 0.25 s
   watchdog evicts it as hung, every request equal to (a)'s; a sampled run
   under Poisson arrivals (40 requests/s, numpy-seeded gaps) on fresh
   engines, the watchdog at 10x the median round of (a)'s second run,
   records no fault while it captures program keys. (f) A small fp32 greedy
   fleet (hidden 32, two services, one behind a stream) on the card equals
   the same fleet on the CPU, one 12-slot engine serving the accepted set,
   its own run after a death's replays, and after an idle promotion one
   engine on the new weights; an engine's health retry equals its clean run
   (phase 2's small-engine tolerances). Printed, not checked, beside the
   card's name and power limit: the sampled fleet's events/s and latency
   (p50 and p95 a lane and overall) all at once and under the Poisson
   arrivals (a second run on the same engines); the promotion's staging,
   each service's drain wall and flip device ms, ``held_peak``; the
   eviction's replay count and wall; ``stats()``.
18. Pretraining from a DL cache: `data.synthetic.write_synthetic_cache`
   writes bench.py's cohort (512 train, 64 tuning and 64 held-out subjects;
   40 event types, 3,500 labs, 500 meds; mean length 200, at most 512; seed
   0) in the converted format, and `training.pretrain.train(cfg)` trains
   bench.py's CI model (phase 4's widths, bf16, dropout 0.1) on it from
   `TorchDataset` (``max_seq_len`` 256, ``min_seq_len`` 4) with bench.py's
   optimizer (rate 1e-3, batches of 32, 2 epochs of 16 steps, warmup 0.1),
   a log window every 4 steps and a kept checkpoint every 8. (a) Resident
   tables and the captured chunked step: tuning loss finite and lower after
   epoch 1; every log window with its split, step and a finite loss; one
   capture, in epoch 0 (the guard armed in epoch 1); kernel C forward 40
   times (32 steps and 8 eval forwards) and backward 32, through the
   replays; `load_pretrained` of the written weights onto the card equals
   the live weights (the last checkpoint's); the final validation's
   every metric finite. (b) Host collation with the prefetch thread feeding
   the captured single step: every weight, AdamW tensor, logged loss and
   final metric equal to (a)'s bit for bit (the later runs skip the final
   validation and are held by their weights and logs). (c) A save_dir seeded with (a)'s
   checkpoints 8, 16 and 24 resumes at epoch 1 past 8 batches and ends equal
   to (a); with step 24 corrupted it walks back to 16 and ends equal to (a).
   (d) A scripted SIGTERM at step 12 ends the run with `Preempted` after its
   final checkpoint; the relaunch ends equal to (a). (e) On the host path a
   NaN batch in epoch 1 rolls back to step 16 in place (every parameter and
   AdamW tensor at its address), excises the window, and the run ends finite
   without another capture. (f) Gradient accumulation 2 for an epoch: finite
   losses, 8 updates in 16 loop steps; a small fp32 run (hidden 32, no
   dropout, accumulation 2) on the card equals the same run on the CPU
   within 1e-4 (losses and weights). (g) Phase 6's NA model through
   `train()` for an epoch: kernel D twice a step each way plus twice in each
   of the 2 tuning forwards, through the replays; finite losses. pandas and pyarrow are never
   imported. Printed beside the card's name and power limit: trained
   events/s of each log window and epoch, each epoch's wall split into
   steps, tuning evaluation and checkpoint saves, the final validation's
   seconds, one checkpoint save's and one resume's seconds, peak memory.
19. Functor measurements in generation and zero-shot evaluation. (a) Phase
   2's serving model (its widths, random weights from the seed) over phase 2's
   vocabulary plus an ``age`` `AgeFunctor` (univariate regression, the fitted
   ``age.csv`` of the committed converted sample cohort) and a four-value
   ``tod`` `TimeOfDayFunctor` (4,063 entries), both built here, serving phase
   2's 64 requests (128-192 events, each event carrying an age and a time of
   day, start times in 2010) at 32 slots, depth 2, greedy (warm and
   accounting passes, a ``cuda_graph=False`` twin and a 16-slot engine, each
   equal bit for bit: a request's events do not depend on its batch) and
   sampled: every request finished and finite; each generated real event
   holds exactly one time-of-day element, its bucket that of the event's
   time recomputed in fp64 from the returned row (unless within 4 minutes
   of an edge), and one age element, the prior age plus the time to the
   event over a 365.25-day year (within 1e-4 years), or value-masked past
   ``age.csv``'s outlier thresholds; kernel B once a decode step and kernel
   A (sampled) counted through the replays. (b) Small fp32 greedy runs with
   both functors on the card equal the CPU's in every event and integer
   (floats within 1e-4): `generate()`, a paged engine with a fork, the strict
   CI spec engine and the NA engine. (c) `train(cfg)` trains phase 4's CI
   model on the committed converted sample cohort (``max_seq_len`` 128,
   batches of 32, 2 epochs; kernel C stays idle: it gathers a multivariate
   regression plane, and the cohort's numeric measurements are univariate), then
   `zero_shot_evaluation` on its ``high_utilization`` task (8 samples of 64
   new events a subject, 12 subjects a batch: 96 engine slots, ``max_len``
   192, left-padded prompts) through the paged engine (one fork a subject)
   and through `generate()`: both splits' metrics written; one subject's
   fork equals its 8 per-request runs with the fork's seeds bit for bit;
   pandas and pyarrow never imported. Printed beside the card's name and
   power limit: events/s, each generation call's wall, the unpredictable
   fractions, the metrics and kernel A's launches of each zero-shot run.
20. Fine-tuning and embeddings from phase 18's save_dirs (kept in one
   temporary directory for phases 18-20). (a) Two task frames written into
   phase 18's cohort in the converted format over each subject's whole
   record: ``long_history`` (more events than the median) and
   ``history_quartile`` (the event count's quartile). (b)
   `training.fine_tuning.train(cfg)` fine-tunes phase 18 (a)'s CI model on
   the binary task (``last`` pooling, ``max_seq_len`` 256, batches of 32, 2
   epochs of 16 steps, dropout 0.1): right after the graft every encoder
   weight equals the pretrained save_dir's bit for bit and the logit layer
   is flax ``Dense``'s fresh draw from the seed; one capture, replays after
   it; every logged loss finite; both metrics files written, loss,
   accuracy, AUROC and AUPRC finite; `load_pretrained` of the written
   weights equals the live weights; no kernel launched. (c) A save_dir
   seeded with (b)'s checkpoint 24 resumes and ends equal to (b) (weights,
   AdamW, log, metrics). (d) Phase 18 (g)'s NA model on the 4-class task
   (``mean`` pooling, one epoch): kernel D once a layer in every train step
   both ways and in each of the 2 tuning and 2 held-out forwards, through
   the replays. (e) (b)'s model under ``attention_implementation=
   "pallas_flash"``, attention dropout 0 (``max`` pooling, one epoch):
   kernel E in the global layer as D in (d); kernel F idle (the local
   window of 32 runs the band). (f) `get_embeddings` (``last``) of the CI
   and the NA save_dir: each split's file one row a subject, equal bit for
   bit to a ``cuda_graph=False`` pass, one capture and a replay a later
   batch, kernel D once a layer a batch (NA). (g) Small fp32 CI and NA
   classifiers (hidden 32, no dropout) fine-tuned 4 steps and their
   embeddings on the card equal the CPU's within 1e-4. Printed beside the
   card's name and power limit: trained events/s of each epoch, the
   captured step's ms, each epoch's wall split, the final validation's
   seconds, embeddings' subjects/s a split, peak memory, the metrics.
21. Remat and scan-over-layers at bench.py's width-1024 probe
   (`wide_config_for`, ``bench.py:1446-1463``: hidden 1,024, 12 layers
   local/global with window 32, 8 heads of 128, intermediate 4,096,
   ``pallas_flash``, attention dropout 0, residual and input dropout 0.1,
   bf16) set to phase 18's cohort, on its train split's first packed batch
   of 8 x 1,024 (`packed_batches`, seed 1), weights from the seed. (a) The
   captured single step under ``none``, ``block``, ``dots_no_batch`` and
   ``save_attention``, 3 steps each from the same weights (eager warm-up,
   capture, replay): every health vector, weight and AdamW tensor equal to
   ``none``'s bit for bit. (b) Kernel E's forward once a global layer a step
   (6) under ``none`` and ``save_attention``, twice under ``block`` and
   ``dots_no_batch`` (the recompute), its backward once, kernel C as under
   ``none``, counted through the replays. (c) ``block``'s peak memory (reset
   before each run's first step; above what was allocated then) below
   ``none``'s. (d) ``scan_layers=True``
   under the faster of ``dots_no_batch`` and ``save_attention``, its weights
   loaded through `convert.load_jax_params` from the stacked (``h_scan``)
   tree `convert.export_params` builds in numpy of (a)'s initial weights:
   equal to (a)'s run under that policy bit for bit. (e) Phase 6's NA model
   under ``block``, 3 captured steps, dropout 0.1: equal to ``none``'s bit
   for bit; kernel D's forward twice a layer a step, its backward once. (f)
   A small fp32 CI step (hidden 32) under ``block`` with dropout 0.1 on the
   card equals the CPU's within 1e-4 (loss and gradients; the keep masks
   drawn on the CPU for both). Then kernel E at D = 128 against its plain
   version on the inputs captured from (a)'s first ``none`` step
   (``(8, 8, 1024, 128)``), fp32 and bf16, and timed as phase 9 times it.
   Printed beside the card's name and power limit: each run's captured step
   in ms (median of 5 replays), trained events/s, peak memory and kernel E's
   forward launches a step.
22. Trajectories and the MCF evaluation: `evaluation.generate_trajectories`
   from phase 18 (a)'s save_dir over its cohort's tuning and held-out
   splits, 4 samples of 32 new events a subject, batches of 32: every split
   writes 4 files, one row a subject (`data.dl_cache.read_dl_reps` reads
   them back), each row's prompt events (indices, values, times) equal to
   its input row's, every generated time finite and later than the
   prompt's last; kernel A counted through `generate()`'s replays, at least
   once a categorical head a new event a call; pandas and pyarrow never
   imported. (b) `evaluation.get_MCF_coordinates` over the written samples
   for the prompts' most frequent lab code, aligned at each subject's last
   prompt event (64 timestamps drawn by a seeded generator): JAX's shapes,
   censor masks true in the first column, incidences finite where a
   subject's bucket is populated, and `crps` of the samples' incidences
   after the prompt finite. Printed beside the card's name and power limit:
   generated events/s of each split (each `generate` call's host clock) and
   the MCF step's seconds.
23. The entry points (`eventstreamgpt_tpu_torch.scripts`) on the card,
   each through its ``main(argv)`` with no device, at phase 4's CI widths
   (hidden 256, 4 heads x 64, 2 layers local/global, window 32,
   intermediate 1,024, bf16, dropout 0.1), every config read by
   `utils.yaml_subset` (PyYAML never imported). (a) The chain: `pretrain`
   with ``--config configs/pretrain_base.yaml`` and overrides (the widths,
   the committed converted sample cohort at rows of 128, batches of 32, 2
   epochs of 3 steps, a log window an epoch, ``save_dir=${experiment_dir}/pretrain``,
   the final metrics skipped): its ``pretrain_config.yaml`` reads back to the resolved
   config, losses finite, a capture; then `finetune`, `zeroshot` (8 samples
   of 64 new events, the paged engine), `get_embeddings` and
   `generate_trajectories` (4 samples of 32) on its ``high_utilization``
   task from that save_dir: JAX's files, finite values, kernel A counted
   in zero-shot and trajectories (kernel C idle: the cohort's numeric
   measurements are univariate). (b) `launch_hp_sweep --run` with a sweep
   YAML in the repository's dialect (``defaults: [_self_]``, the widths as
   ``value`` leaves, ``resid_dropout``, ``init_lr`` and ``weight_decay``
   sampled), 3 trials, ``early_terminate: {type: hyperband, min_iter: 1,
   eta: 3}``, 3 epochs on phase 18's cohort: two trials stopped at rung 0,
   the rung-0 best promoted and resumed in a fresh `pretrain.main` to
   epoch 3, its tuning loss and weights equal to the same trial run
   uninterrupted, bit for bit; kernel C counted. (c) ``python -m
   eventstreamgpt_tpu_torch.scripts.pretrain --config <yaml>`` as a
   subprocess on phase 18's cohort (the kernels found built), SIGTERM once
   ``train_log.jsonl`` has records: exit 85, the newest checkpoint verified
   and covering every logged step; a second launch resumes and finishes,
   its weights and logged losses equal to an uninterrupted in-process run
   bit for bit. Printed beside the card's name and power limit: each
   part's seconds, the chain's trained events/s a log window, the
   trajectories' generated events/s over the entry point's wall, each
   main's wall, the sweep's rung-0 losses and kernels A and C's launches.
24. The wall seconds of each phase function (`tools/phase_times.py`), one
   ``{"kernels": [...]}`` line, then the device line as the last line.

Timing: each kernel, its plain version and the nearest single PyTorch call
are timed by CUDA events around N back-to-back launches queued behind a
device-side sleep, so the device runs them without waiting on the host
(``ms``, per launch, median of 5); the time of one synchronised call, host
work included, is printed beside it.

It exits non-zero, printing no result, when no CUDA device is available or
when the repository is not beside it.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense tensor-core bf16; fp32 outside the tensor cores
N_REQUESTS, SEED = 64, 0
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, EQUAL_STEPS = 32, 256, 20, 5
PACKED_BATCH, PACKED_SEQ, WIDE_WINDOW, WIDE_STEPS = 8, 1024, 256, 10
COHORT, CHUNK, CHUNK_PACKED, CHUNK_EPOCHS = 512, 16, 4, 2  # bench.py's cohort and chunks (tools/profile_train.py's)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------- phase 1
def device_phase():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]  # fmt: skip
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from eventstreamgpt_tpu_torch.ops import (
        build,
        decode_step,
        dep_graph,
        flash_attention,
        fused_sampling,
        vocab_gather,
    )

    t0 = time.perf_counter()
    errors = []
    sources = [fused_sampling.SOURCE, decode_step.SOURCE, vocab_gather.SOURCE, dep_graph.SOURCE, flash_attention.SOURCE]
    nvcc = threading.Thread(target=lambda: errors.extend(_try(build.build_all, sources)))
    nvcc.start()
    torch.zeros(1, device="cuda")  # the CUDA context, while nvcc runs
    nvcc.join()
    if errors:
        raise errors[0]
    for source in sources:
        build.load_library(source)
    torch.cuda.synchronize()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    return smi


def _try(fn, *args):
    try:
        fn(*args)
        return []
    except Exception as e:  # re-raised by the caller's thread
        return [e]


# ---------------------------------------------------------------- phase 2
def check_results(results, requests, label):
    import torch

    check(len(results) == len(requests), f"{label}: {len(results)} results for {len(requests)} requests")
    for r in results:
        check(r.error is None, f"{label}: request {r.request_id} failed: {r.error!r}")
        check(r.n_events == r.prompt_len + r.n_generated, f"{label}: request {r.request_id} accounting")
        b = r.batch
        check(b.event_mask.shape == (1, r.n_events), f"{label}: request {r.request_id} shape {tuple(b.event_mask.shape)}")
        for f in ("time_delta", "dynamic_values", "start_time"):
            check(bool(torch.isfinite(getattr(b, f)).all()), f"{label}: request {r.request_id} non-finite {f}")


class Capture:
    """Wraps the engine's two kernel entry points to keep the inputs of the
    first call made while ``armed`` (cloned before the in-place cache write;
    for kernel A the stream's seeds, counters and the salt of the draw)."""

    def __init__(self, engine_module):
        self.mod, self.armed, self.a, self.b = engine_module, False, None, None
        self.orig_a, self.orig_b = engine_module.fused_categorical_stream, engine_module.decode_stack_step

        def a(logits, stream, keep=None, active=None, fill=0):
            if self.armed and self.a is None and active is not None:  # a decode step, not a prefill
                self.a = dict(logits=logits.clone(), seeds=stream.seeds.clone(), counters=stream.counters.clone(),
                              salt=copy.copy(stream).next_draw_salt(), keep=keep, active=active.clone())  # fmt: skip
            return self.orig_a(logits, stream, keep, active, fill)

        def b(weights, kc, vc, h0, start, em, mask, **kw):
            if self.armed and self.b is None:
                kept = {k: v.clone() if k.endswith("_scale") and v is not None else v for k, v in kw.items()}
                self.b = dict(weights=weights, kc=kc.clone(), vc=vc.clone(), h0=h0.clone(), start=start.clone(),
                              em=em.clone(), mask=mask.clone(), kw=kept)  # fmt: skip
            return self.orig_b(weights, kc, vc, h0, start, em, mask, **kw)

        engine_module.fused_categorical_stream, engine_module.decode_stack_step = a, b

    def restore(self):
        self.mod.fused_categorical_stream, self.mod.decode_stack_step = self.orig_a, self.orig_b


PASSES = ("warm", "fetching", "accounting")


def engine_run(model, config, prompts, counters, passes=PASSES, after_pass=None, **engine_kw):
    """One engine built and run three times on ``prompts`` (64 requests), as
    a benchmark warms, resets and times an engine: pass 1 (``warm``) captures
    every program key the schedule touches; ``reset()``; pass 2
    (``fetching``) fetches every finished row; ``reset()``; pass 3
    (``accounting``) runs with ``fetch_results=False`` (``passes`` may stop
    after the first). Every counter in ``counters`` (``name -> (wrapper,
    attribute)``) is set to 0 just before the engine is built (its warm-up
    and capture included) and before each later pass, and read just after
    each pass; ``after_pass(engine, name)`` then looks at the engine. Returns
    the engine and, per pass, its results, wall time, launches and the
    engine's stats; ``results``, ``wall_s`` and ``stats`` of pass 1 at the
    top, ``launches`` summed over the passes."""
    import torch

    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    zero()
    engine = GenerationEngine(model, config, template=prompts[0][0], **engine_kw)
    runs = {}
    for name in passes:
        if name != "warm":
            engine.reset()
            zero()
        reqs = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run(reqs, fetch_results=name != "accounting")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        runs[name] = dict(results=results, requests=reqs, wall_s=wall, launches=launches, stats=engine.stats())
        if after_pass is not None:
            after_pass(engine, name)
    warm = runs["warm"]
    total = {k: sum(p["launches"][k] for p in runs.values()) for k in counters}
    return dict(warm, launches=total, passes=runs, engine=engine)


def check_graph_counts(run, label, counter):
    """The captured engine's programs: the decode chunk captured once with
    one warm-up chunk and replayed once a dispatched chunk, kernel B's
    ``counter`` counting every decode step run through the replays (warm-up
    included; ``None`` for an engine whose decode step does not run B); one
    prefill capture (after one warm-up) a (bucket, group) key and one
    extraction capture a group width, all in the warm pass, one prefill
    replay a prefill dispatch; nothing captured after ``reset()``."""
    warm = run["passes"]["warm"]["stats"]
    check(warm["cuda_graph"] and warm["graph_captures"] == 1 and warm["graph_warmup_chunks"] == 1,
          f"{label}: the decode chunk was not captured once: {warm}")  # fmt: skip
    check(warm["prefill_graph_captures"] == warm["prefill_graph_warmups"] == warm["prefill_graph_keys"] > 0,
          f"{label}: not one prefill capture a key: {warm}")  # fmt: skip
    check(warm["extract_graph_captures"] == warm["extract_graph_keys"] > 0,
          f"{label}: not one extraction capture a width: {warm}")  # fmt: skip
    before = dict.fromkeys(("graph_replays", "prefill_graph_replays"), 0)
    for name, p in run["passes"].items():
        s = p["stats"]
        for k in ("graph_captures", "prefill_graph_captures", "extract_graph_captures", "prefill_graph_keys"):
            check(s[k] == warm[k], f"{label} [{name} pass]: {k} {s[k]} after the warm pass's {warm[k]}")
        check(s["graph_replays"] - before["graph_replays"] == s["dispatched_chunks"] > 0,
              f"{label} [{name} pass]: {s['graph_replays']} chunk replays for {s['dispatched_chunks']} chunks")  # fmt: skip
        check(s["prefill_graph_replays"] - before["prefill_graph_replays"] == s["prefill_dispatches"] > 0,
              f"{label} [{name} pass]: {s['prefill_graph_replays']} prefill replays for {s['prefill_dispatches']} "
              "prefill dispatches")  # fmt: skip
        before = {k: s[k] for k in before}
        steps = (s["dispatched_chunks"] + (s["graph_warmup_chunks"] if name == "warm" else 0)) * s["decode_chunk"]
        if counter is not None:
            got = p["launches"][counter]
            check(got == steps, f"{label} [{name} pass]: kernel B launched {got} times for {steps} decode steps run")
    *_, before_acct, acct = (p["stats"]["extract_graph_replays"] for p in run["passes"].values())
    check(acct == before_acct, f"{label}: the accounting pass extracted rows")


def check_eager_counts(run, label, counter, sampled):
    """The eager engine's kernel B launches once a decode step run, and kernel
    A, sampling, once a categorical head a prefill row group and a step."""
    for name in PASSES:
        p = run["passes"][name]
        s = p["stats"]
        check(not s["cuda_graph"] and s["prefill_graph_captures"] == 0, f"{label}: the eager engine captured")
        check(p["launches"][counter] == s["dispatched_chunks"] * s["decode_chunk"],
              f"{label} [{name} pass]: the eager engine's kernel B launches {p['launches']}")  # fmt: skip
        calls = s["prefill_dispatches"] + s["dispatched_chunks"] * s["decode_chunk"]
        a = p["launches"]["fused_categorical_stream"]
        check((a > 0 and a % calls == 0) if sampled else a == 0,
              f"{label} [{name} pass]: kernel A launched {a} times for {calls} prefills and steps")  # fmt: skip


def kernel_a_through_replays(captured, eager, label):
    """Kernel A counted through the captured programs' replays as eager: the
    same launches in the passes after ``reset()`` (no warm-up runs there), and
    in the warm pass the eager count plus the warm-up chunk's and each
    prefill key's warm-up."""
    for name in PASSES[1:]:
        a, b = (r["passes"][name]["launches"]["fused_categorical_stream"] for r in (captured, eager))
        check(a == b, f"{label} [{name} pass]: kernel A launched {a} times captured, {b} eager")
    s, e = captured["passes"]["warm"]["stats"], eager["passes"]["warm"]["stats"]
    per_call = eager["passes"]["warm"]["launches"]["fused_categorical_stream"] // (
        e["prefill_dispatches"] + e["dispatched_chunks"] * e["decode_chunk"])  # fmt: skip
    want = per_call * (s["prefill_dispatches"] + s["prefill_graph_warmups"]
                       + (s["dispatched_chunks"] + s["graph_warmup_chunks"]) * s["decode_chunk"])  # fmt: skip
    got = captured["passes"]["warm"]["launches"]["fused_categorical_stream"]
    check(got == want, f"{label} [warm pass]: kernel A launched {got} times captured, {want} expected")
    return per_call


def same_results(a_results, b_results, label, what="captured vs eager"):
    """Every request's events, integers and floats equal in two runs, bit for
    bit (NaN where NaN): the same kernels on the same inputs in the same
    order. On a difference, fails with the largest gap of each float field."""
    import torch

    gaps = {}
    check(len(a_results) == len(b_results), f"{label}: {len(a_results)} results against {len(b_results)}")
    for a, b in zip(a_results, b_results):
        check(a.request_id == b.request_id, f"{label}: results in another order")
        check((a.n_events, a.n_generated, a.prompt_len) == (b.n_events, b.n_generated, b.prompt_len),
              f"{label}: request {a.request_id} has {a.n_generated} events, {b.n_generated} ({what})")  # fmt: skip
        if a.batch is None and b.batch is None:  # accounting-only runs
            continue
        for k, t in vars(a.batch).items():
            if not torch.is_tensor(t):
                continue
            u = getattr(b.batch, k)
            if t.is_floating_point():
                if not torch.equal(t.nan_to_num(-7.0), u.nan_to_num(-7.0)):
                    gaps[k] = max(gaps.get(k, 0.0), (t - u).nan_to_num(0.0).abs().max().item())
            else:
                check(torch.equal(t, u), f"{label}: request {a.request_id}'s {k} differs ({what})")
    check(not gaps, f"{label}: floats differ ({what}); largest gaps {gaps}")


def check_passes(run, label):
    """The passes after ``reset()`` give the warm pass's results: bit for bit
    in the ``fetching`` pass (where the run makes one), and in the
    ``accounting`` pass no rows and the same accounting."""
    passes = run["passes"]
    if "fetching" in passes:
        same_results(passes["warm"]["results"], passes["fetching"]["results"], label,
                     "warm pass vs the pass after reset()")  # fmt: skip
    fetched, acct = passes["warm"]["results"], passes["accounting"]["results"]
    check(len(acct) == len(fetched) and all(r.batch is None and r.error is None for r in acct),
          f"{label}: the accounting pass fetched rows or failed")  # fmt: skip
    for a, b in zip(fetched, acct):
        check((a.request_id, a.n_events, a.n_generated, a.prompt_len) == (b.request_id, b.n_events, b.n_generated,
              b.prompt_len), f"{label}: request {a.request_id}'s accounting differs in the accounting pass")  # fmt: skip


def same_as_eager(captured, eager, label):
    """The captured engine's results equal the eager engine's, bit for bit, in every pass."""
    for name in PASSES:
        same_results(captured["passes"][name]["results"], eager["passes"][name]["results"], f"{label} [{name} pass]")


def walls_line(captured, eager, generated) -> str:
    """Wall time of the timed passes, a chunk and a decode step, and events/s,
    captured beside eager: the accounting pass (``fetch_results=False``, the
    events/s a throughput benchmark reads) and the fetching pass; the warm
    pass's wall (captures included) beside."""
    parts = []
    for name, run in (("captured", captured), ("eager", eager)):
        acct, fetch = (run["passes"][k] for k in ("accounting", "fetching"))
        s = acct["stats"]
        chunk_ms = acct["wall_s"] * 1e3 / s["dispatched_chunks"]
        parts.append(f"{name} {generated / acct['wall_s']:.1f} events/s ({acct['wall_s']:.4f} s, {chunk_ms:.3f} ms a "
                     f"chunk, {chunk_ms / s['decode_chunk']:.3f} ms a step; fetching {generated / fetch['wall_s']:.1f} "
                     f"events/s in {fetch['wall_s']:.4f} s; warm pass {run['passes']['warm']['wall_s']:.3f} s)")  # fmt: skip
    return "; ".join(parts)


def programs_line(run) -> str:
    s = run["passes"]["accounting"]["stats"]
    return (f"prefill programs {s['prefill_graph_keys']} keys ({s['prefill_graph_captures']} captures, "
            f"{s['prefill_graph_replays']} replays over the {len(run['passes'])} passes), extraction programs "
            f"{s['extract_graph_keys']} widths ({s['extract_graph_captures']} captures, {s['extract_graph_replays']} "
            f"replays), decode chunk {s['graph_captures']} capture, {s['graph_replays']} replays")  # fmt: skip


def engine_phase(smi):
    import numpy as np

    import eventstreamgpt_tpu_torch.serving.engine as engine_module
    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import log_time_stats, serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    rng = np.random.default_rng(SEED)
    prompts = synthetic_prompts(rng, N_REQUESTS, serving_config(), (128, 192), (16, 64))
    mean_log, std_log = log_time_stats(prompts)
    config = serving_config(mean_log=mean_log, std_log=std_log)
    model = init_params_from_seed(CIPPTForGenerativeSequenceModeling(config), seed=SEED)
    capture = Capture(engine_module)
    engine_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)
    counters = {"decode_stack_step": (decode_stack_step, "launches"),
                "fused_categorical_stream": (fused_categorical_stream, "launches"),
                "fused_categorical": (fused_categorical, "launches")}  # fmt: skip

    # Warm-up (cuBLAS handles, allocator) on a few requests, not counted.
    requests = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts[:4])]
    GenerationEngine(model, config, template=prompts[0][0], **engine_kw).run(requests)
    out = {}
    for mode in ("greedy", "sampled"):
        kw = dict(engine_kw, greedy=mode == "greedy")
        label = f"phase 2 [{mode}]"
        run = engine_run(model, config, prompts, counters, **kw)
        # The eager programs (``cuda_graph=False``) for comparison; kernel
        # inputs for phase 3 come from their first sampled decode step.
        capture.armed = mode == "sampled"
        eager = engine_run(model, config, prompts, counters, cuda_graph=False, **kw)
        capture.armed = False
        results, launches, stats = run["results"], run["launches"], run["stats"]
        check_results(results, run["requests"], mode)
        check(launches["decode_stack_step"] > 0, f"{mode}: the decode kernel was never launched")
        check(launches["fused_categorical"] == 0, f"{mode}: the engine launched kernel A with given noise")
        if mode == "sampled":
            check(launches["fused_categorical_stream"] > 0, "sampled: the sampling kernel was never launched")
        else:
            check(launches["fused_categorical_stream"] == 0, "greedy: the sampling kernel launched in greedy mode")
        check_graph_counts(run, label, "decode_stack_step")
        check_eager_counts(eager, label, "decode_stack_step", mode == "sampled")
        heads = kernel_a_through_replays(run, eager, label)
        check_passes(run, label)
        check_passes(eager, f"{label} eager")
        same_as_eager(run, eager, label)
        generated = sum(r.n_generated for r in results)
        out[mode] = dict(run, generated=generated, eager=eager)
        print(
            f"{label} {len(results)} requests, {generated} generated events, every event, integer and float equal "
            f"captured and eager and in each pass after reset(); {walls_line(run, eager, generated)}; "
            f"{programs_line(run)}; captured launches {launches} over three passes (warm pass "
            f"{run['passes']['warm']['launches']}; kernel A {heads} a prefill or step), dispatch_depth "
            f"{stats['dispatch_depth']}, wasted_decode_frac {stats['wasted_decode_frac']} ({smi})",
            flush=True,
        )  # fmt: skip
    print(f"phase 2: slots_report() at the card's memory (bf16 cache): {json.dumps(run['engine'].slots_report())} "
          f"({smi})", flush=True)  # fmt: skip
    capture.restore()
    check(capture.a is not None and capture.b is not None, "no decode-step inputs were captured")
    small_engine_matches_cpu()
    return model, config, capture, out


def small_engine_matches_cpu(spec_k=None, phase="phase 2", na=False, **engine_kw):
    """The whole path on the card against the same engine on the CPU (plain
    versions of both kernels), fp32 greedy at a small size: a small
    vocabulary (few Bernoulli draws that float noise could tip over 0.5) and
    a narrow log-time scale (moderate times for the sinusoidal encoding).
    ``engine_kw`` go to both engines (``kv_cache_dtype``); ``spec_k``: both
    speculative, the draft the model's first layer, zero tolerances; ``na``:
    the NA model of ``bench.py``'s three dep-graph levels."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft
    from eventstreamgpt_tpu_torch.training import build_model

    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3), hidden_size=32,
                            head_dim=8, intermediate_size=64, seq_window_size=4, **(NA_OVERRIDES if na else {}))  # fmt: skip
    # Weights of std ~ 1/sqrt(hidden): unit gain, so float noise is not amplified from event to event.
    model = init_params_from_seed(build_model(config), seed=1, std=0.15)
    with torch.no_grad():  # a near-constant TTE head: inter-event times of about e^1 minutes
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    prompts = synthetic_prompts(np.random.default_rng(1), 6, config, (6, 12), (4, 8))
    kw = dict(n_slots=8, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True, **engine_kw)
    if spec_k is not None:
        dcfg, draft = truncated_draft(config, model, 1)
        kw["spec"] = SpecConfig(model=draft, config=dcfg, k=spec_k, value_rtol=0.0, value_atol=0.0)
        engine_kw = dict(engine_kw, spec=f"k={spec_k}, strict")
    # A quantized cache: a key one rounding apart can move a code by a step,
    # and floats then agree to the JAX package's quantized-cache tolerance
    # (tests/test_kv_quant.py, 2e-2); float caches to 1e-4.
    float_tol, float_diff = (2e-2 if engine_kw.get("kv_cache_dtype") in QUANT_DTYPES else 1e-4), 0.0
    res = {}
    widths = []
    for dev in ("cuda", "cpu"):
        reqs = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]
        engine = GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw)
        engine.scheduler.group_sizes = (4, 8)  # groups of fewer than 4 requests padded to 4 rows
        dispatch = engine._dispatch_group
        engine._dispatch_group = lambda g, d=dispatch: (widths.append((dev, len(g.requests), g.group_size)), d(g))
        res[dev] = engine.run(reqs)
    padded = [(n, g) for dev, n, g in widths if dev == "cuda" and g > n]
    check(padded and padded == [(n, g) for dev, n, g in widths if dev == "cpu" and g > n],
          f"small engine: no padded group or not the same on both devices: {widths}")  # fmt: skip
    for g, c in zip(res["cuda"], res["cpu"]):
        check((g.n_events, g.n_generated, g.spec_proposed, g.spec_accepted)
              == (c.n_events, c.n_generated, c.spec_proposed, c.spec_accepted), f"small engine: request {g.request_id}")
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
            a, b = getattr(g.batch, f), getattr(c.batch, f)
            if not torch.equal(a, b):
                first = int((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1)[0].nonzero()[0])
                td = (g.batch.time_delta - c.batch.time_delta)[0, :first].abs().max().item() if first else 0.0
                fail(f"small engine: {f} of request {g.request_id} differs from event {first} of "
                     f"{a.shape[1]} (prompt {g.prompt_len}); max |time_delta diff| before it {td:.3g}; "
                     f"card {a[0, first].tolist()} cpu {b[0, first].tolist()}")  # fmt: skip
        for f in ("time_delta", "dynamic_values"):
            a, b = getattr(g.batch, f), getattr(c.batch, f)
            float_diff = max(float_diff, (a - b).abs().max().item())
            torch.testing.assert_close(a, b, rtol=float_tol, atol=float_tol)
    print(f"{phase}: small fp32 greedy {'NA ' if na else ''}engine {engine_kw or ''} on the card matches the CPU "
          f"engine, groups padded (requests, rows) {padded}: events and integers exact, floats within {float_tol} "
          f"(max |diff| {float_diff:.3g})", flush=True)  # fmt: skip


# ---------------------------------------------------------------- phase 3
def timings(kernel, plain, library=None, **kw) -> dict:
    """``ms``/``plain_ms``/``library_ms`` and their single-call times (`time_ms`)."""
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain), ("library_ms", library)):
        if fn is None:
            out[key], out[f"single_{key}"] = None, None
        else:
            t = time_ms(fn, **kw)
            out[key], out[f"single_{key}"] = t["ms"], t["single_ms"]
    return out


def fmt_times(t: dict) -> str:
    return ", ".join(
        f"{k} {t[k]:.4f} (one synchronised call {t['single_' + k]:.4f})" for k in ("ms", "plain_ms", "library_ms")
        if t[k] is not None
    )


# Kernel A's operations an element, each counted as one: the hash (key plus
# element, one mix32: 10), the uniform (shift, convert, add, multiply: 4), two
# logs and two negations, the cast to the logits' type, the add and its
# rounding, and the running max and index (3).
A_OPS_PER_ELEMENT = 24


def special_plane(rng, rows, V, dtype):
    """Normal logits (scale 3) with NaN, +inf, all--inf and all-equal rows, on the card."""
    import torch

    z = (rng.normal(size=(rows, V)) * 3).astype("float32")
    z[0::97, rng.integers(V)] = float("nan")
    z[1::97, rng.integers(V)] = float("inf")
    z[2::97] = -float("inf")
    z[3::97] = 1.0
    return torch.from_numpy(z).to(dtype).cuda()


def kernel_a_phase(capture):
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.distributions import gumbel
    from eventstreamgpt_tpu_torch.generation.sampling import RowStreams
    from eventstreamgpt_tpu_torch.ops.fused_sampling import (
        fused_categorical,
        fused_categorical_reference,
        fused_categorical_stream,
        gumbel_noise,
        launch_floor,
        topk_topp_mask,
    )
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    cap = capture.a
    logits, active = cap["logits"], cap["active"]
    rows, V = logits.shape

    def stream(seeds=cap["seeds"], counters=cap["counters"], salt=cap["salt"]):
        return RowStreams(seeds, counters, salt)  # its next draw is the captured one

    # The noise, bit for bit, at the captured shape and on a wide plane.
    rng = np.random.default_rng(SEED)
    wide = dict(seeds=torch.from_numpy(rng.integers(-(2**62), 2**62, size=4096)).cuda(),
                counters=torch.from_numpy(rng.integers(0, 2**40, size=4096)).cuda(), salt=12345)  # fmt: skip
    for kw, shape in ((dict(), (rows, V)), (wide, (4096, 4057))):
        for dt, bits in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
            got, want = gumbel_noise(stream(**kw), shape, dt), gumbel(stream(**kw), shape, "cuda").to(dt)
            differ = int((got.view(bits) != want.view(bits)).sum())
            check(differ == 0, f"kernel A's noise differs from gumbel(stream) in {differ} of {got.numel()} ({dt}, {shape})")
    print("phase 3: kernel A's noise equals gumbel(stream).to(dtype) bit for bit at "
          f"({rows}, {V}) and (4096, 4057), fp32 and bf16", flush=True)  # fmt: skip

    # Both entries against their plain versions, at the captured shape ...
    max_err = 0
    for dt in (torch.float32, torch.bfloat16):
        z = logits.to(dt)
        g = gumbel(stream(), z.shape, "cuda").to(dt)
        for keep in (None, topk_topp_mask(z, top_k=5)):
            for act in (None, active):
                want = fused_categorical_reference(z, g, keep, act, fill=0)
                for name, got in (("stream", fused_categorical_stream(z, stream(), keep, act, fill=0)),
                                  ("given noise", fused_categorical(z, g, keep, act, fill=0))):  # fmt: skip
                    max_err = max(max_err, (got.long() - want.long()).abs().max().item())
                    check(torch.equal(got, want), f"kernel A ({name}) disagrees ({dt}, keep={keep is not None}, "
                                                  f"active={act is not None})")  # fmt: skip
    # ... and on 4,096 rows of fresh streams with NaN, +inf and all--inf rows.
    for V_sweep in (40, 4057):
        for dt in (torch.float32, torch.bfloat16):
            z = special_plane(rng, 4096, V_sweep, dt)
            keep = torch.from_numpy(rng.random((4096, V_sweep)) < 0.5).cuda()
            act = torch.from_numpy(rng.random(4096) < 0.9).cuda()
            for k, a in ((None, None), (keep, act)):
                for trial in range(2):
                    kw = dict(seeds=torch.from_numpy(rng.integers(-(2**62), 2**62, size=4096)).cuda(),
                              counters=torch.from_numpy(rng.integers(0, 2**40, size=4096)).cuda(),
                              salt=int(rng.integers(0, 2**32)))  # fmt: skip
                    want = fused_categorical_reference(z, gumbel(stream(**kw), z.shape, "cuda").to(dt), k, a, fill=-1)
                    got = fused_categorical_stream(z, stream(**kw), k, a, fill=-1)
                    max_err = max(max_err, (got.long() - want.long()).abs().max().item())
                    check(torch.equal(got, want), f"kernel A (stream) disagrees on the sweep (V {V_sweep}, {dt}, "
                                                  f"keep and active {k is not None}, trial {trial})")  # fmt: skip
    torch.cuda.synchronize()
    print(f"phase 3: kernel A exact vs plain at ({rows}, {V}) (both entries) and on 4,096 rows at V 40 and 4057",
          flush=True)  # fmt: skip

    # Timing at the main path's shape and type (fp32 logits, an active mask, no keep).
    dt = logits.dtype
    g = gumbel(stream(), logits.shape, "cuda").to(dt)
    s_kernel, s_plain, s_noise = stream(), stream(), stream()
    t = timings(lambda: fused_categorical_stream(logits, s_kernel, None, active), None,
                lambda: torch.argmax(g + logits, dim=-1))  # fmt: skip
    # The ATen noise is about a hundred launches: 4 calls at a time keep the
    # stream's queue of pending launches short, so the device is what is timed
    # (`utils.timing.time_ms`).
    plain = time_ms(lambda: fused_categorical_reference(logits, gumbel(s_plain, logits.shape, "cuda").to(dt), None,
                                                        active), n=4)  # fmt: skip
    t["plain_ms"], t["single_plain_ms"] = plain["ms"], plain["single_ms"]
    extra = {"gumbel_ms": time_ms(lambda: gumbel(s_noise, logits.shape, "cuda").to(dt), n=4),
             "given_noise_ms": time_ms(lambda: fused_categorical(logits, g, None, active)),
             "launch_floor_ms": time_ms(launch_floor)}  # fmt: skip
    nbytes = rows * V * logits.element_size() + 2 * rows * 8 + rows + rows * 4  # logits, seeds, counters, active, out
    ops = A_OPS_PER_ELEMENT * rows * V
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["fp32"] * 1e3
    print(f"phase 3: kernel A (noise drawn inside) at ({rows}, {V}) {dt}: {fmt_times(t)}; "
          + "; ".join(f"{k} {v['ms']:.4f} (one synchronised call {v['single_ms']:.4f})" for k, v in extra.items())
          + f"; bound {max(bytes_ms, ops_ms):.7f} ms ({nbytes} bytes, {ops} operations)", flush=True)  # fmt: skip
    return dict(t, **{k: v["ms"] for k, v in extra.items()}, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", max_abs_err=float(max_err),
                shape=[rows, V])  # fmt: skip


def live_rows(start, event_mask, mask, window):
    """Per row, the cache positions kernel B's output depends on: those that
    pass the causal, window and padding tests (the padding mask already
    holding this event's bit at the cursor). Returns ``(live, cursor_live)``."""
    import torch

    pos = torch.arange(mask.shape[1], device=mask.device)[None, :]
    st = start.long()[:, None]
    ok = (pos <= st) & torch.where(pos == st, event_mask[:, None], mask)
    if window > 0:
        ok &= pos > st - window
    return ok.sum(1), (ok & (pos == st)).sum(1)


def kernel_b_phase(model, config, capture):
    import torch

    from eventstreamgpt_tpu_torch.ops.decode_step import (
        cluster_size,
        decode_stack_step,
        decode_stack_step_reference,
        stack_layer_weights,
    )

    cap = capture.b
    kw = cap["kw"]
    L, B, H, M, D = cap["kc"].shape
    blocks = model.to("cuda").encoder.blocks()
    max_err = 0.0
    for dt, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)), (torch.bfloat16, dict(rtol=0.0, atol=2e-2))):
        weights = cap["weights"] if dt == torch.bfloat16 else stack_layer_weights(blocks, dt)
        inputs = [cap["h0"].to(dt), cap["start"], cap["em"], cap["mask"]]

        def run(fn):
            kc, vc = cap["kc"].to(dt).clone(), cap["vc"].to(dt).clone()
            return fn(weights, kc, vc, *inputs, **kw)

        want, got = run(decode_stack_step_reference), run(decode_stack_step)
        torch.cuda.synchronize()
        err = (got[0].float() - want[0].float()).abs().max().item()
        torch.testing.assert_close(got[0].float(), want[0].float(), **tol)
        at = torch.arange(M, device="cuda")[None, :] == cap["start"][:, None].long()
        at = at[None, :, None, :, None].expand(L, B, H, M, D)
        for i in (1, 2):
            check(torch.equal(got[i][~at], want[i][~at]), f"kernel B ({dt}): cache changed off the cursor")
            torch.testing.assert_close(got[i][at].float(), want[i][at].float(), **tol)
        check(torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]), f"kernel B ({dt}): mask/length")
        print(f"phase 3: kernel B ({dt}) within {tol}: max |h diff| {err:.3g}", flush=True)
        if dt == torch.bfloat16:
            max_err = err
    weights = cap["weights"]
    kc, vc = cap["kc"].clone(), cap["vc"].clone()
    args = (weights, kc, vc, cap["h0"], cap["start"], cap["em"], cap["mask"])
    t = timings(lambda: decode_stack_step(*args, **kw), lambda: decode_stack_step_reference(*args, **kw), n=20)
    # The bound counts what the function needs on this run's inputs: the
    # weights once, K and V only at each row's live positions (the cursor's
    # are computed, not read; a row with none live averages V over all M),
    # the cursor writes and the small inputs and outputs.
    E, I, esz = H * D, weights["wfc"].shape[-1], kc.element_size()
    w_bytes = sum(t.numel() * t.element_size() for t in weights.values())
    k_rows = v_rows = attn_rows = 0
    for window in kw["windows"]:
        live, cursor = live_rows(cap["start"], cap["em"], cap["mask"], int(window))
        k_rows += int((live - cursor).sum())
        v_rows += int(torch.where(live > 0, live - cursor, M).sum())
        attn_rows += int(live.sum() + torch.where(live > 0, live, M).sum())
    written = int((cap["start"] < M).sum())
    small = 2 * B * E * esz + B * (4 + 1 + M + 1) + 4 * L + B * (M + 4)  # h0, h; start, em, mask, active; out
    nbytes = w_bytes + (k_rows + v_rows) * E * esz + 2 * L * written * E * esz + small
    flops = 2 * B * L * (4 * E * E + 2 * E * I) + 2 * H * D * attn_rows
    bound = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]) * 1e3
    C = cluster_size(H)
    print(f"phase 3: kernel B at (L={L}, B={B}, H={H}, M={M}, D={D}) in clusters of {C} CTAs, {B * C} CTAs; "
          f"{fmt_times(t)}, bound {bound:.4f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; whole cache "
          f"{2 * kc.numel() * esz / 1e6:.2f} MB)", flush=True)  # fmt: skip
    return dict(t, bound_ms=bound,
                bound_by="bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_FLOPS["bf16"] else "operations",
                max_abs_err=max_err, shape=[L, B, H, M, D], cluster=[C, 1, 1], blocks=B * C)  # fmt: skip


# ---------------------------------------------------------------- phase 3b
QUANT_DTYPES = ("int8", "fp8")


def quantized_engine_phase(smi, model, config, runs):
    """Phase 2's model and requests served with an int8 and an fp8 cache at
    ``dispatch_depth=2``, greedy and sampled, each sampled run also eagerly;
    returns the captured inputs of each eager sampled run's first decode step
    and the captured runs' launch counts."""
    import numpy as np

    import eventstreamgpt_tpu_torch.serving.engine as engine_module
    from eventstreamgpt_tpu_torch.data.synthetic import synthetic_prompts, serving_config
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream

    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, serving_config(), (128, 192), (16, 64))
    engine_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED,
                     dispatch_depth=2)  # fmt: skip
    entries = ("launches", "launches_int8", "launches_fp8")
    counters = {f"decode_stack_step.{c}": (decode_stack_step, c) for c in entries}
    counters.update(fused_categorical_stream=(fused_categorical_stream, "launches"),
                    fused_categorical=(fused_categorical, "launches"))  # fmt: skip
    captures, out = {}, {}
    for kv in QUANT_DTYPES:
        captures[kv] = capture = Capture(engine_module)
        for mode in ("greedy", "sampled"):
            kw = dict(engine_kw, greedy=mode == "greedy", kv_cache_dtype=kv)
            run = engine_run(model, config, prompts, counters, **kw)
            results, launches, stats, wall = run["results"], run["launches"], run["stats"], run["wall_s"]
            label = f"phase 3b [{kv} {mode}]"
            check_results(results, run["requests"], label)
            ours = launches[f"decode_stack_step.launches_{kv}"]
            check(ours > 0, f"{label}: the quantized decode kernel never ran")
            check(sum(launches[f"decode_stack_step.{c}"] for c in entries) == ours,
                  f"{label}: another entry of kernel B launched: {launches}")  # fmt: skip
            check(launches["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
            if mode == "sampled":
                check(launches["fused_categorical_stream"] > 0, f"{label}: the sampling kernel was never launched")
            else:
                check(launches["fused_categorical_stream"] == 0, f"{label}: the sampling kernel ran in greedy mode")
            check(stats["kv_cache_dtype"] == kv and stats["dispatch_depth"] == 2, f"{label}: {stats}")
            check_graph_counts(run, label, f"decode_stack_step.launches_{kv}")
            check_passes(run, label)
            generated = sum(r.n_generated for r in results)
            acct = run["passes"]["accounting"]["wall_s"]
            line = (f"{label} {len(results)} requests, {generated} generated events, each pass after reset() equal "
                    f"to the warm pass: {generated / acct:.1f} events/s in {acct:.4f} s (fetch_results=False; "
                    f"fetching {generated / run['passes']['fetching']['wall_s']:.1f}), launches {launches} over three "
                    f"passes, dispatched chunks {stats['dispatched_chunks']} a pass, {programs_line(run)}, "
                    f"wasted_decode_frac {stats['wasted_decode_frac']}, kv_cache_bytes {stats['kv_cache_bytes']}")  # fmt: skip
            if mode == "greedy":
                base = {r.request_id: r for r in runs["greedy"]["results"]}
                agree = [same_generated_events(r, base[r.request_id]) for r in results]
                same = sum(n == r.n_generated == base[r.request_id].n_generated for n, r in zip(agree, results))
                line += (f"; greedy requests whose events equal the bf16 cache's: {same} of {len(results)}, generated "
                         f"events equal before the first difference: median {float(np.median(agree))}, "
                         f"{sum(agree)} of {generated} (not checked)")  # fmt: skip
            else:  # the eager chunk, for equality; quantized B's inputs for this phase come from it
                capture.armed = True
                eager = engine_run(model, config, prompts, counters, cuda_graph=False, **kw)
                capture.armed = False
                check_eager_counts(eager, label, f"decode_stack_step.launches_{kv}", True)
                kernel_a_through_replays(run, eager, label)
                check_passes(eager, f"{label} eager")
                same_as_eager(run, eager, label)
                line += f"; every event, integer and float equal captured and eager: {walls_line(run, eager, generated)}"
            print(f"{line} ({smi})", flush=True)
            out[(kv, mode)] = dict(launches=launches, wall_s=wall, generated=generated)
            if mode == "sampled":
                print(f"phase 3b: slots_report() at the card's memory ({kv} cache): "
                      f"{json.dumps(run['engine'].slots_report())} ({smi})", flush=True)  # fmt: skip
        capture.restore()
        check(capture.b is not None, f"no quantized decode-step inputs were captured ({kv})")
    small_engine_matches_cpu(kv_cache_dtype="int8")
    return captures, out


def same_generated_events(a, b) -> int:
    """The generated events of two results of one request (same prompt) that
    are equal, event mask and every data element's index, before the first
    that differs."""
    import torch

    n = min(a.n_events, b.n_events)
    ea, eb = a.batch.event_mask[0, :n], b.batch.event_mask[0, :n]
    ia, ib = a.batch.dynamic_indices[0, :n], b.batch.dynamic_indices[0, :n]
    differ = torch.nonzero((ea != eb) | (ia != ib).flatten(1).any(-1)).flatten()
    first = int(differ[0]) if len(differ) else n
    return max(first - a.prompt_len, 0)


def quant_step(value, scale, kv):
    """One quantisation step at each dequantized value: the scale in int8; in
    e4m3 (3 mantissa bits) at most 2^-3 of the scaled value, 2^-9 among the
    subnormals, times the scale."""
    import torch

    if kv == "int8":
        return scale
    return scale * torch.clamp((value / scale).abs() * 2.0**-3, min=2.0**-9)


def kernel_b_quant_phase(model, captures, smi):
    """Quantized B against its plain version on the captured inputs, and timed."""
    import torch

    from eventstreamgpt_tpu_torch.ops.decode_step import (
        decode_stack_step,
        decode_stack_step_reference,
        stack_layer_weights,
    )
    from eventstreamgpt_tpu_torch.ops.kv_quant import dequantize_kv, storage
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    result = {}
    blocks = model.to("cuda").encoder.blocks()
    for kv in QUANT_DTYPES:
        cap = captures[kv].b
        kw = {k: v for k, v in cap["kw"].items() if not k.endswith("_scale")}
        scales = (cap["kw"]["key_scale"], cap["kw"]["value_scale"])
        L, B, H, M, D = cap["kc"].shape
        max_err = 0.0
        for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            weights = cap["weights"] if dt == torch.bfloat16 else stack_layer_weights(blocks, dt)
            inputs = [cap["h0"].to(dt), cap["start"], cap["em"], cap["mask"]]

            def run(fn):
                kc, vc, ks, vs = (t.clone() for t in (cap["kc"], cap["vc"], *scales))
                return fn(weights, kc, vc, *inputs, key_scale=ks, value_scale=vs, **kw)

            want, got = run(decode_stack_step_reference), run(decode_stack_step)
            torch.cuda.synchronize()
            at_s = torch.arange(M, device="cuda")[None, :] == cap["start"][:, None].long()
            at_s = at_s[None, :, None, :].expand(L, B, H, M)
            at = at_s[..., None].expand(L, B, H, M, D)
            same = torch.ones(B, dtype=torch.bool, device="cuda")
            for plane, scale in ((1, 3), (2, 4)):
                gb, wb = storage(got[plane]), storage(want[plane])
                check(torch.equal(gb[~at], wb[~at]), f"quantized B ({kv}, {dt}): codes changed off the cursor")
                check(torch.equal(got[scale][~at_s], want[scale][~at_s]),
                      f"quantized B ({kv}, {dt}): scales changed off the cursor")  # fmt: skip
                same &= (gb == wb).reshape(L, B, -1).all(-1).all(0)
                # A key one rounding apart can move a code by a step.
                # The layer's input differs by the earlier layers' roundings, a
                # share of its magnitude: the tolerance scales with each row's largest.
                gd = dequantize_kv(got[plane], got[scale], torch.float32)
                wd = dequantize_kv(want[plane], want[scale], torch.float32)
                top = wd.abs().amax(-1, keepdim=True).expand_as(wd)[at]
                gd, wd = gd[at], wd[at]
                limit = tol + tol * top + quant_step(wd, want[scale][..., None].expand(L, B, H, M, D)[at], kv)
                check(bool(((gd - wd).abs() <= limit).all()),
                      f"quantized B ({kv}, {dt}): a cursor key or value is off by more than {tol} plus a step")  # fmt: skip
            check(torch.equal(got[5], want[5]) and torch.equal(got[6], want[6]),
                  f"quantized B ({kv}, {dt}): mask/length")  # fmt: skip
            # h on the rows whose cursor codes agree: a moved code moves the scores by a step.
            check(bool(same.any()), f"quantized B ({kv}, {dt}): no row's cursor codes agree")
            g, w = got[0].float()[same], want[0].float()[same]
            err = (g - w).abs().max().item()
            torch.testing.assert_close(g, w, rtol=tol if dt == torch.float32 else 0.0, atol=tol)
            print(f"phase 3b: quantized B ({kv}, {dt}) within {tol} (+ one quantisation step at the cursor): max |h "
                  f"diff| {err:.3g} on the {int(same.sum())} of {B} rows whose cursor codes agree", flush=True)  # fmt: skip
            if dt == torch.bfloat16:
                max_err = err

        # Timing: quantized B, its plain version, and the bf16 B on the same rows (the caches dequantized).
        weights = cap["weights"]
        kc, vc, ks, vs = (t.clone() for t in (cap["kc"], cap["vc"], *scales))
        args = (weights, kc, vc, cap["h0"], cap["start"], cap["em"], cap["mask"])
        qkw = dict(kw, key_scale=ks, value_scale=vs)
        t = timings(lambda: decode_stack_step(*args, **qkw), lambda: decode_stack_step_reference(*args, **qkw), n=20)
        kd, vd = dequantize_kv(kc, ks, torch.bfloat16), dequantize_kv(vc, vs, torch.bfloat16)
        fargs = (weights, kd, vd, cap["h0"], cap["start"], cap["em"], cap["mask"])
        bf16_ms = time_ms(lambda: decode_stack_step(*fargs, **kw), n=20)["ms"]
        # The bound: the weights once, codes and scales at each row's live
        # positions (the cursor's are computed, not read; a row with none
        # live averages V over all M), the cursor's codes and scales written,
        # and the small inputs and outputs; the operations of the float B
        # plus one multiply a dequantized element.
        E, I = H * D, weights["wfc"].shape[-1]
        per_pos = E * kc.element_size() + H * 4  # codes and scales of one position, every head
        w_bytes = sum(x.numel() * x.element_size() for x in weights.values())
        k_rows = v_rows = attn_rows = 0
        for window in kw["windows"]:
            live, cursor = live_rows(cap["start"], cap["em"], cap["mask"], int(window))
            k_rows += int((live - cursor).sum())
            v_rows += int(torch.where(live > 0, live - cursor, M).sum())
            attn_rows += int(live.sum() + torch.where(live > 0, live, M).sum())
        written = int((cap["start"] < M).sum())
        esz = cap["h0"].element_size()
        small = 2 * B * E * esz + B * (4 + 1 + M + 1) + 4 * L + B * (M + 4)
        nbytes = w_bytes + (k_rows + v_rows) * per_pos + 2 * L * written * per_pos + small
        flops = 2 * B * L * (4 * E * E + 2 * E * I) + 2 * H * D * attn_rows + (k_rows + v_rows) * E
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
        print(f"phase 3b: quantized B ({kv}) at (L={L}, B={B}, H={H}, M={M}, D={D}): {fmt_times(t)}; the bf16 B on "
              f"the same rows {bf16_ms:.4f}; bound {max(bytes_ms, ops_ms):.5f} ms ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.3f} GFLOP; whole cache {2 * (kc.numel() + 4 * ks.numel()) / 1e6:.2f} MB) ({smi})",
              flush=True)  # fmt: skip
        result[kv] = dict(t, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                          max_abs_err=max_err, bf16_ms=bf16_ms, shape=[L, B, H, M, D])  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 4
class GatherCapture:
    """Wraps the regression head's `vocab_gather` to keep the plane, the
    indices and the cotangent of the first call made while ``armed``."""

    def __init__(self, layers_module):
        self.mod, self.armed, self.z, self.ci, self.g = layers_module, False, None, None, None
        self.orig = layers_module.vocab_gather

        def wrapped(z, ci):
            out = self.orig(z, ci)
            if self.armed and self.z is None:
                self.z, self.ci = z.detach().clone(), ci.clone()
                out.register_hook(lambda g: setattr(self, "g", g.detach().clone()))
            return out

        layers_module.vocab_gather = wrapped

    def restore(self):
        self.mod.vocab_gather = self.orig


def training_run(label, smi, config, batch, counters, capture=None, steps=TRAIN_STEPS):
    """``steps`` steps of a fresh model through `make_train_step` (after 2
    warm-up steps of another fresh model, not counted): the first runs
    eagerly (its warm-up), the second is captured, and every step from the
    second on is a replay. The counters in ``counters`` (launch-counted
    kernel entry points) are set to 0 just before the counted steps and
    read just after. ``capture.armed`` is set for the first step (eager:
    the captured steps run no Python). Then ``steps`` steps of a fresh
    model with ``cuda_graph=False``: their first `EQUAL_STEPS` losses and
    health vectors must equal the captured steps', bit for bit. Returns
    ``(losses, launches, step_ms, events, eager_step_ms)``."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step

    def fresh(**kw):
        model = init_params_from_seed(build_model(config), seed=SEED)
        oc = OptimizationConfig(init_lr=1e-3, batch_size=TRAIN_BATCH, max_epochs=3, lr_frac_warmup_steps=0.1)
        oc.set_to_dataset(range(512))  # a stand-in for bench.py's 512 training subjects
        optimizer, scheduler = build_optimizer(model, oc)
        return make_train_step(model, optimizer, scheduler, with_health=True, **kw)

    def run(step, arm=False):
        healths, walls = [], []
        for i in range(steps):
            if arm and capture is not None:
                capture.armed = i == 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, health = step(batch, SEED)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            healths.append(health.cpu())
        if arm and capture is not None:
            capture.armed = False
        return torch.stack(healths), walls

    warm = fresh()  # cuBLAS handles, allocator, kernel loads: not counted
    for _ in range(2):
        warm(batch, SEED)
    torch.cuda.synchronize()

    step = fresh()
    for fn in counters:
        fn.launches = 0
    healths, walls = run(step, arm=True)
    launches = {fn.__name__: fn.launches for fn in counters}
    if capture is not None:
        capture.restore()
    s = step.stats()
    check((s["graph_warmup_steps"], s["graph_captures"], s["graph_replays"]) == (1, 1, steps - 1),
          f"{label}: the train step was not warmed up once, captured once and replayed after: {s}")  # fmt: skip
    eager_healths, eager_walls = run(fresh(cuda_graph=False))
    n = EQUAL_STEPS
    check(torch.equal(healths[:n], eager_healths[:n]),
          f"{label}: the captured steps' [loss, grad norm] differ from the eager steps': {healths[:n].tolist()} vs "
          f"{eager_healths[:n].tolist()}")  # fmt: skip
    losses, norms = healths[:, 0].tolist(), healths[:, 1].tolist()
    check(all(math.isfinite(x) for x in losses + norms), f"{label}: a loss or gradient norm is not finite: {losses}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall over {steps} steps: {losses}")
    events = int(batch.event_mask.sum())
    step_ms, eager_ms = float(np.median(walls)) * 1e3, float(np.median(eager_walls)) * 1e3
    B, L = batch.event_mask.shape
    print(f"{label}: {steps} train steps at (B={B}, L={L}, n_data="
          f"{batch.dynamic_indices.shape[-1]}), {events} real events a step: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; captured: median step {step_ms:.3f} ms (min {min(walls) * 1e3:.3f}), "
          f"{events / (step_ms / 1e3):.1f} trained events/s; eager: median step {eager_ms:.3f} ms (min "
          f"{min(eager_walls) * 1e3:.3f}), {events / (eager_ms / 1e3):.1f} trained events/s; [loss, grad norm] "
          f"equal captured and eager over the first {n} steps (all {steps}: "
          f"{torch.equal(healths, eager_healths)}); launches {launches} ({s['graph_captures']} capture, "
          f"{s['graph_replays']} replays) ({smi})", flush=True)  # fmt: skip
    return losses, launches, step_ms, events, eager_ms


def training_batch():
    """The phase-4 batch: 32 subjects x 256 events, numpy seed 0, on the card."""
    import numpy as np

    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_training_batches

    return next(synthetic_training_batches(np.random.default_rng(SEED), serving_config(), TRAIN_BATCH, TRAIN_SEQ))


def training_phase(smi):
    import eventstreamgpt_tpu_torch.models.generative_layers as layers_module
    from eventstreamgpt_tpu_torch.data.synthetic import training_config
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    batch = training_batch()
    config = training_config([batch])  # bf16, dropout 0.1 (the config defaults)
    batch = batch.map(lambda t: t.cuda())  # resident, as a prefetching loader leaves it
    check(config.precision == "bf16" and config.resid_dropout == 0.1, "phase 4: not the benchmark's training config")
    capture = GatherCapture(layers_module)
    counters = (vocab_gather_fwd, vocab_gather_bwd)
    losses, launches, step_ms, events, eager_ms = training_run("phase 4", smi, config, batch, counters, capture)
    check(launches == {k: TRAIN_STEPS for k in launches}, f"phase 4: kernel C launches {launches}, not 1 a step")
    check(capture.z is not None and capture.g is not None, "phase 4: no regression-plane inputs were captured")
    small_train_step_matches_cpu()
    return dict(launches=launches, step_ms=step_ms, eager_step_ms=eager_ms, events=events, losses=losses), capture


def small_fp32_setup(na, **widths):
    """A small fp32 model (numpy seed 1, std-0.1 weights, dropout 0) and a
    4 x 24-event batch on the CPU."""
    import numpy as np

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        serving_config,
        synthetic_training_batches,
        training_config,
    )
    from eventstreamgpt_tpu_torch.training import build_model

    small = dict(sizes=(5, 40, 6, 3), intermediate_size=64, seq_window_size=4, attention_dropout=0.0,
                 input_dropout=0.0, resid_dropout=0.0, **widths)  # fmt: skip
    vocab = serving_config(precision="fp32", **small)
    batch = next(synthetic_training_batches(np.random.default_rng(1), vocab, 4, 24, mean_seq_len=16))
    config = (na_training_config if na else training_config)([batch], precision="fp32", **small)
    return init_params_from_seed(build_model(config), seed=1, std=0.1), batch


def one_fp32_step(base, batch, dev):
    """One train step of a copy of ``base`` on ``dev``: ``(loss, {name: grad on the CPU})``."""
    import copy

    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_optimizer, make_train_step

    model = copy.deepcopy(base)
    oc = OptimizationConfig(init_lr=1e-3, lr_num_warmup_steps=0, lr_frac_warmup_steps=None, max_training_steps=10)
    optimizer, scheduler = build_optimizer(model, oc)
    loss = float(make_train_step(model, optimizer, scheduler, device=dev)(batch, 0))
    return loss, {n: p.grad.cpu() for n, p in model.named_parameters()}


def steps_match(a, b, tol, what):
    """Loss and every gradient of two `one_fp32_step` results within ``tol`` (rtol = atol)."""
    import torch

    torch.testing.assert_close(a[0], b[0], rtol=tol, atol=tol, msg=lambda m: f"{what}, loss: {m}")
    # Gradients, not the updated parameters: Adam's first step moves each
    # element by about lr * sign(grad), so an element whose gradient is float
    # noise around 0 moves either way.
    for name, grad in b[1].items():
        torch.testing.assert_close(a[1][name], grad, rtol=tol, atol=tol, msg=lambda m: f"{what}, {name}: {m}")


def grad_diff(a, b, relative=False) -> float:
    """The largest gradient difference; with ``relative``, as a share of each tensor's largest |gradient|."""
    return max(
        (a[1][n] - g).abs().max().item() / (g.abs().max().item() if relative else 1.0) for n, g in b[1].items()
    )


def small_train_step_matches_cpu(na=False):
    """One fp32 train step at a small size on the card against the same step
    on the CPU (plain versions of kernels C and D), dropout 0, within 1e-4.

    The NA model keeps the CI check's hidden 32, as one head of 32 (kernel
    D's narrowest): at hidden 128 the card and the CPU differ by up to ~2e-3
    whichever versions of C and D the card runs. `na_kernels_match_plain_on_card`
    holds the kernels at hidden 128 on the card alone and prints those
    card-vs-CPU differences."""
    heads = dict(num_attention_heads=1, head_dim=32) if na else dict(head_dim=8)
    base, batch = small_fp32_setup(na, hidden_size=32, **heads)
    cuda, cpu = one_fp32_step(base, batch, "cuda"), one_fp32_step(base, batch, "cpu")
    steps_match(cuda, cpu, 1e-4, "card vs CPU")
    print(f"phase {6 if na else 4}: small fp32 {'NA ' if na else ''}train step on the card matches the CPU "
          f"(loss {cpu[0]:.6f}, max |grad diff| {grad_diff(cuda, cpu):.3g})", flush=True)  # fmt: skip


def dep_graph_attention_f64(query, key, value, q_offset=0, window=None, dropout_mask=None, dropout_rate=0.0):
    """Kernel D's function without dropout, computed in fp64 both ways and
    rounded once to the value dtype: one change of fp32 rounding, for the
    envelope `na_kernels_match_plain_on_card` prints."""
    import torch

    from eventstreamgpt_tpu_torch.ops.dep_graph import graph_mask

    check(dropout_mask is None, "the fp64 dep-graph attention takes no dropout")
    mask = graph_mask(query.shape[1], key.shape[1], q_offset, window, query.device)
    logits = (query.double()[:, :, None] * key.double()[:, None]).sum(dim=-1)  # (N, Q, S, H)
    probs = torch.softmax(logits.masked_fill(~mask[None, :, :, None], float("-inf")), dim=2)
    return (probs[..., None] * value.double()[:, None]).sum(dim=2).to(value.dtype)


def na_kernels_match_plain_on_card():
    """The small fp32 NA step at hidden 128 (4 heads of 32), dropout 0, held
    by `kernels_match_plain_on_card` with kernels C and D."""
    import eventstreamgpt_tpu_torch.models.generative_layers as layers_module
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_attention_reference, dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd, vocab_gather_reference

    base, batch = small_fp32_setup(True, hidden_size=128, num_attention_heads=4, head_dim=32)
    kernels_match_plain_on_card(
        "phase 6", "NA", base, batch, (dep_graph_fwd, dep_graph_bwd, vocab_gather_fwd, vocab_gather_bwd),
        [(transformer_module, "dep_graph_attention", dep_graph_attention_reference, dep_graph_attention_f64),
         (layers_module, "vocab_gather", vocab_gather_reference, vocab_gather_reference)],
    )  # fmt: skip


def kernels_match_plain_on_card(phase, what, base, batch, counters, swaps):
    """One small fp32 step on the card with the kernels in ``counters``
    against the same step on the card with their plain versions swapped in
    (``swaps``: ``(module, name, plain, fp64)``): the loss within 1e-5 of it
    and every gradient within 2e-5 of its tensor's largest. Rounding the
    attention kernel's output and gradients once from fp64 instead of the
    plain version's fp32 sums moves gradients by up to ~7e-6 of their
    tensor's largest at these widths (the model amplifies last-bit changes),
    so a kernel summing in another order moves them as far; a wrong kernel
    moves them by far more. The step with those fp64 versions and each card
    step's distance from the CPU's are printed, not checked."""
    before = [fn.launches for fn in counters]
    kernels = one_fp32_step(base, batch, "cuda")
    check(all(fn.launches > n for fn, n in zip(counters, before)), f"{phase}: the hidden-128 step missed a kernel")
    orig = [getattr(mod, name) for mod, name, _, _ in swaps]

    def plain_step(which):
        before = [fn.launches for fn in counters]
        for (mod, name, *versions) in swaps:
            setattr(mod, name, versions[which])
        try:
            out = one_fp32_step(base, batch, "cuda")
        finally:
            for (mod, name, _, _), fn in zip(swaps, orig):
                setattr(mod, name, fn)
        check([fn.launches for fn in counters] == before, f"{phase}: a plain hidden-128 step launched a kernel")
        return out

    plain, rounded = plain_step(0), plain_step(1)
    cpu = one_fp32_step(base, batch, "cpu")
    loss_err, rel = abs(kernels[0] - plain[0]), grad_diff(kernels, plain, relative=True)
    check(loss_err <= 1e-5 * abs(plain[0]) and rel <= 2e-5,
          f"{phase}: hidden 128, kernels vs plain versions on the card: loss {kernels[0]} vs {plain[0]}, largest "
          f"gradient difference {rel:.3g} of its tensor's largest (tolerance 2e-5)")  # fmt: skip
    print(f"{phase}: small fp32 {what} step at hidden 128 on the card, kernels vs plain versions: loss "
          f"{kernels[0]:.6f} vs {plain[0]:.6f}, max |grad diff| {grad_diff(kernels, plain):.3g} ({rel:.3g} of its "
          f"tensor's largest); not checked: plain with the attention rounded once from fp64 vs plain "
          f"{grad_diff(rounded, plain):.3g} ({grad_diff(rounded, plain, relative=True):.3g}); card vs CPU, kernels "
          f"{grad_diff(kernels, cpu):.3g}, plain versions {grad_diff(plain, cpu):.3g}; largest |grad| "
          f"{max(g.abs().max().item() for g in cpu[1].values()):.3g}", flush=True)  # fmt: skip


# ---------------------------------------------------------------- phase 5
def bf16_ulp(x):
    import torch

    mag = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def kernel_c_phase(capture):
    import torch

    from eventstreamgpt_tpu_torch.ops.fused_sampling import launch_floor
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd, vocab_gather_reference
    from eventstreamgpt_tpu_torch.utils.timing import time_ms

    V = capture.z.shape[-1]
    z0 = capture.z.reshape(-1, V)
    ci = capture.ci.reshape(-1, capture.ci.shape[-1]).contiguous()
    g = capture.g.reshape(ci.shape).float().contiguous()
    rows, M = ci.shape
    valid = (ci >= 0) & (ci < V)
    ci64 = ci.long()
    result = {}
    for dt in (torch.bfloat16, torch.float32):
        z = z0.to(dt).contiguous()
        zr = z.detach().requires_grad_(True)
        ref_out = vocab_gather_reference(zr, ci)
        got = vocab_gather_fwd(z, ci)
        check(torch.equal(got, ref_out.detach()), f"kernel C forward ({dt}) differs from its plain version")
        (want_dz,) = torch.autograd.grad(ref_out, zr, g, retain_graph=True)
        got_dz = vocab_gather_bwd(g, ci, V, dt)
        torch.cuda.synchronize()
        diff = (got_dz.float() - want_dz.float()).abs()
        if dt == torch.bfloat16:
            tol = bf16_ulp(torch.maximum(got_dz.float().abs(), want_dz.float().abs()))
        else:
            tol = 1e-6 * want_dz.abs() + 1e-6 * g.abs().max()
        check(bool((diff <= tol).all()), f"kernel C backward ({dt}) off its plain version by {diff.max().item():.3g}")
        cpu_z = z.detach().cpu().clone().requires_grad_(True)
        vocab_gather_reference(cpu_z, ci.cpu()).backward(g.cpu())
        check(torch.equal(got_dz.cpu(), cpu_z.grad), f"kernel C backward ({dt}) differs from the CPU's ordered sums")
        print(f"phase 5: kernel C ({dt}) at rows {rows}, V {V}, M {M}: forward bit-exact, backward max |diff| "
              f"{diff.max().item():.3g} vs the card's plain version, exact vs the CPU's", flush=True)  # fmt: skip
        if dt != torch.bfloat16:
            continue
        esz = z.element_size()
        # Forward: indices and outputs once, and each distinct in-range element once.
        s = torch.sort(torch.where(valid, ci, -1), dim=-1).values
        distinct = int((s[:, :1] >= 0).sum() + ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0)).sum())
        fwd_bytes = rows * M * 4 * 2 + distinct * esz
        fwd_ops = int(valid.sum())  # one conversion per gathered element
        # Backward: the whole dz plane once, g and ci once; one add per in-range slot.
        bwd_bytes = rows * V * esz + rows * M * 4 * 2
        bwd_ops = fwd_ops
        t_fwd = timings(lambda: vocab_gather_fwd(z, ci), lambda: vocab_gather_reference(z, ci),
                        lambda: torch.gather(z, -1, ci64).float(), n=100)  # fmt: skip
        floor = time_ms(launch_floor, n=100)
        t_bwd = timings(
            lambda: vocab_gather_bwd(g, ci, V, dt),
            lambda: torch.autograd.grad(ref_out, zr, g, retain_graph=True),
            lambda: torch.zeros_like(z).scatter_add_(-1, ci64, g.to(dt)),  # accumulates in z's dtype
        )
        for name, t, nbytes, ops in (("fwd", t_fwd, fwd_bytes, fwd_ops), ("bwd", t_bwd, bwd_bytes, bwd_ops)):
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["fp32"] * 1e3
            result[name] = dict(t, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                max_abs_err=0.0 if name == "fwd" else diff.max().item(), shape=[rows, V, M])  # fmt: skip
            if name == "bwd":  # the plane's write, the bound's bytes, at the kernel's time
                result[name]["write_GBps"] = rows * V * esz / (t["ms"] * 1e-3) / 1e9
                rate = f", the plane written at {result[name]['write_GBps']:.1f} GB/s"
            else:  # an empty kernel, timed the same way
                result[name]["launch_floor_ms"] = floor["ms"]
                rate = f"; launch floor {floor['ms']:.4f} ms (one synchronised call {floor['single_ms']:.4f})"
            print(f"phase 5: kernel C {name} (bf16): {fmt_times(t)}; bound {result[name]['bound_ms']:.5f} ms "
                  f"({nbytes / 1e6:.2f} MB, {distinct} distinct gathered elements){rate}", flush=True)  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 6
class DepGraphCapture:
    """Wraps the transformer's `dep_graph_attention` to keep the query, key,
    value, keep-mask and output cotangent of the first call made while ``armed``."""

    def __init__(self, transformer_module):
        self.mod, self.armed, self.args, self.g = transformer_module, False, None, None
        self.orig = transformer_module.dep_graph_attention

        def wrapped(query, key, value, q_offset=0, window=None, dropout_mask=None, dropout_rate=0.0):
            out = self.orig(query, key, value, q_offset, window, dropout_mask, dropout_rate)
            if self.armed and self.args is None:
                keep = None if dropout_mask is None else dropout_mask.clone()
                self.args = dict(q=query.detach().clone(), k=key.detach().clone(), v=value.detach().clone(),
                                 keep=keep, q_offset=q_offset, window=window, rate=dropout_rate)  # fmt: skip
                out.register_hook(lambda g: setattr(self, "g", g.detach().clone()))
            return out

        transformer_module.dep_graph_attention = wrapped

    def restore(self):
        self.mod.dep_graph_attention = self.orig


def na_training_phase(smi):
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.data.synthetic import na_training_config
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    batch = training_batch()
    config = na_training_config([batch])  # bf16, dropout 0.1, bench.py's three levels
    batch = batch.map(lambda t: t.cuda())
    check(config.hidden_size == 256 and config.attention_dropout == 0.1 and config.precision == "bf16",
          "phase 6: not the benchmark's NA training config")  # fmt: skip
    capture = DepGraphCapture(transformer_module)
    counters = (dep_graph_fwd, dep_graph_bwd, vocab_gather_fwd, vocab_gather_bwd)
    losses, launches, step_ms, events, eager_ms = training_run("phase 6 [NA]", smi, config, batch, counters,
                                                               capture)  # fmt: skip
    layers = config.num_hidden_layers
    want = {"dep_graph_fwd": layers * TRAIN_STEPS, "dep_graph_bwd": layers * TRAIN_STEPS,
            "vocab_gather_fwd": TRAIN_STEPS, "vocab_gather_bwd": TRAIN_STEPS}  # fmt: skip
    check(launches == want, f"phase 6: launches {launches}, expected {want}")
    check(capture.args is not None and capture.g is not None, "phase 6: no dep-graph inputs were captured")
    check(capture.args["keep"] is not None, "phase 6: the dep-graph attention ran without its dropout keep-mask")
    small_train_step_matches_cpu(na=True)
    na_kernels_match_plain_on_card()
    return dict(launches=launches, step_ms=step_ms, eager_step_ms=eager_ms, events=events, losses=losses), capture


# ---------------------------------------------------------------- phase 7
def kernel_d_phase(capture):
    import torch
    import torch.nn.functional as F

    from eventstreamgpt_tpu_torch.ops.dep_graph import (
        dep_graph_attention_reference,
        dep_graph_bwd,
        dep_graph_fwd,
        graph_mask,
    )

    a = capture.args
    q_offset, window, rate = a["q_offset"], a["window"], a["rate"]
    N, Q, H, D = a["q"].shape
    S = a["k"].shape[1]
    result, max_err = {}, {"fwd": 0.0, "bwd": 0.0}
    # The captured cotangent is small (the loss averages over ~8k rows); scaled
    # to a largest magnitude of 1 it gives O(1) gradients, which the bf16
    # tolerance below can tell from zeros.
    g_unit = capture.g / capture.g.float().abs().max()
    for dt in (torch.bfloat16, torch.float32):
        k, v, g = a["k"].to(dt), a["v"].to(dt), g_unit.to(dt)
        # The query as the model passes it: a [:, q_offset:] view of the (N, S, H, D) projection.
        q = torch.cat([k[:, :q_offset], a["q"].to(dt)], dim=1)[:, q_offset:]
        for keep in (a["keep"], None):
            keep_prob = 1.0 - rate if keep is not None else 1.0
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            want = dep_graph_attention_reference(*leaves, q_offset, window, keep, rate if keep is not None else 0.0)
            want_grads = torch.autograd.grad(want, leaves, g)
            got = dep_graph_fwd(q, k, v, q_offset, window, keep, keep_prob)
            got_grads = dep_graph_bwd(q, k, v, g, q_offset, window, keep, keep_prob)
            torch.cuda.synchronize()
            errs = []
            for name, x, y in zip(("out", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
                err = (x.float() - y.float()).abs().max().item()
                # fp32: 1e-5 of the largest magnitude. bf16: 1e-2 of it (the
                # card tests' rule), and 2e-2 absolute for the O(1) output.
                top = y.float().abs().max().item()
                tol = 1e-5 * top if dt == torch.float32 else 1e-2 * top
                if dt == torch.bfloat16 and name == "out":
                    tol = min(tol, 2e-2)
                check(err <= tol, f"kernel D {name} ({dt}, keep-mask={keep is not None}) off its plain version by "
                                  f"{err:.3g} (tolerance {tol:.3g})")  # fmt: skip
                errs.append(err)
                if dt == torch.bfloat16 and keep is not None:
                    max_err["fwd" if name == "out" else "bwd"] = max(max_err["fwd" if name == "out" else "bwd"], err)
            print(f"phase 7: kernel D ({dt}, keep-mask={keep is not None}) at N={N}, Q={Q}, S={S}, H={H}, D={D}: "
                  f"max |diff| out/dq/dk/dv {', '.join(f'{e:.3g}' for e in errs)} (largest |plain| "
                  f"{', '.join(f'{y.float().abs().max().item():.3g}' for y in (want, *want_grads))})", flush=True)  # fmt: skip

    # Timing at the main path's shapes and type: bf16, with the keep-mask, the strided query.
    dt, keep = torch.bfloat16, a["keep"]
    k, v, g = a["k"].to(dt), a["v"].to(dt), capture.g.to(dt)
    q = torch.cat([k[:, :q_offset], a["q"].to(dt)], dim=1)[:, q_offset:]
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = dep_graph_attention_reference(*leaves, q_offset, window, keep, rate)
    # Library yardstick: scaled_dot_product_attention on (N, H, Q|S, D) with the
    # same graph mask, unscaled, without dropout (it takes no external keep-mask).
    heads = [t.detach().transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    sdpa_mask = graph_mask(Q, S, q_offset, window, q.device)
    sdpa_out = F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask, scale=1.0)
    g_heads = g.transpose(1, 2).contiguous()
    keep_prob = 1.0 - rate
    t_fwd = timings(lambda: dep_graph_fwd(q, k, v, q_offset, window, keep, keep_prob),
                    lambda: dep_graph_attention_reference(q, k, v, q_offset, window, keep, rate),
                    lambda: F.scaled_dot_product_attention(*heads, attn_mask=sdpa_mask, scale=1.0))  # fmt: skip
    t_bwd = timings(lambda: dep_graph_bwd(q, k, v, g, q_offset, window, keep, keep_prob),
                    lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True),
                    lambda: torch.autograd.grad(sdpa_out, heads, g_heads, retain_graph=True))  # fmt: skip
    esz = q.element_size()
    pairs = int(graph_mask(Q, S, q_offset, window).sum())  # visible (query, position) pairs a row and head
    qo_bytes, kv_bytes, mask_bytes = N * Q * H * D * esz, N * S * H * D * esz, N * Q * S * H
    fwd_bytes = 2 * qo_bytes + 2 * kv_bytes + mask_bytes  # q, k, v, mask in; out
    bwd_bytes = 3 * qo_bytes + 4 * kv_bytes + mask_bytes  # q, k, v, g, mask in; dq, dk, dv out
    # fp32 arithmetic outside the tensor cores: per visible pair and head, a
    # D-long dot product and a D-long PV update (fwd); logits, dv, dP, dq and
    # dk, each D long (bwd); plus the softmax's handful per pair.
    fwd_ops = N * H * pairs * (4 * D + 6)
    bwd_ops = N * H * pairs * (10 * D + 10)
    for name, t, nbytes, ops in (("fwd", t_fwd, fwd_bytes, fwd_ops), ("bwd", t_bwd, bwd_bytes, bwd_ops)):
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FLOPS["fp32"] * 1e3
        result[name] = dict(t, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                            max_abs_err=max_err[name], shape=[N, Q, S, H, D])  # fmt: skip
        print(f"phase 7: kernel D {name} (bf16, keep-mask, strided query): {fmt_times(t)}; bound "
              f"{result[name]['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)", flush=True)  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 8
class FlashCapture:
    """Wraps the transformer's `flash_attention` to keep the query, key,
    value, segment ids and output cotangent of each window's first call
    made while ``armed`` (``args[window]``, ``None`` for a global layer)."""

    def __init__(self, transformer_module):
        self.mod, self.armed, self.args = transformer_module, False, {}
        self.orig = transformer_module.flash_attention

        def wrapped(query, key, value, segment_ids, window=None):
            out = self.orig(query, key, value, segment_ids, window)
            if self.armed and window not in self.args:
                a = dict(q=query.detach().clone(), k=key.detach().clone(), v=value.detach().clone(),
                         seg=segment_ids.clone(), g=None)  # fmt: skip
                self.args[window] = a
                out.register_hook(lambda g: a.__setitem__("g", g.detach().clone()))
            return out

        transformer_module.flash_attention = wrapped

    def restore(self):
        self.mod.flash_attention = self.orig


def with_segment_time(batch):
    """``batch`` with each event's minutes since its segment's first event,
    summed in float64 and rounded once to fp32. A packed row's fp32
    cumulative time runs on across its subjects (~3e4 minutes in 1,024
    events), where the card's and the CPU's cumulative sums differ by ulps
    of ~4e-3 minutes; given the same ``time``, card and CPU steps compare
    the rest of the model."""
    import torch

    td = torch.where(batch.event_mask, batch.time_delta.double(), 0.0)
    t = torch.cat([torch.zeros_like(td[:, :1]), td.cumsum(1)[:, :-1]], dim=1)
    seg = batch.segment_ids
    start = torch.cat([torch.ones_like(seg[:, :1], dtype=torch.bool), seg[:, 1:] != seg[:, :-1]], dim=1)
    offsets = torch.cummax(torch.where(start, t, -math.inf), dim=1).values
    return batch.replace(time=(t - offsets).float())


def packed_training_phase(smi):
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.data.synthetic import packed_batch, packed_training_config, serving_config
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    batch = packed_batch(serving_config(), 512, PACKED_BATCH, PACKED_SEQ, seed=SEED)
    n_seg = [int(s.max()) + 1 for s in batch.segment_ids]
    print(f"phase 8: packed batch {tuple(batch.event_mask.shape)}, {int(batch.event_mask.sum())} real events, "
          f"subjects a row {n_seg}", flush=True)  # fmt: skip
    batch = batch.map(lambda t: t.cuda())
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_window_fwd,
                fa.flash_attention_window_bwd, vocab_gather_fwd, vocab_gather_bwd)  # fmt: skip
    runs, args = {}, {}
    for window, steps in ((None, TRAIN_STEPS), (WIDE_WINDOW, WIDE_STEPS)):
        overrides = {} if window is None else {"seq_window_size": window}
        config = packed_training_config([batch.map(lambda t: t.cpu())], **overrides)
        check(config.precision == "bf16" and config.resid_dropout == 0.1 and config.attention_dropout == 0.0
              and config.seq_attention_layers == ["local", "global"] and config.hidden_size == 256,
              "phase 8: not the benchmark's packed training config")  # fmt: skip
        label = f"phase 8 [packed, local window {config.seq_window_size}]"
        capture = FlashCapture(transformer_module)  # restored by training_run
        losses, launches, step_ms, events, eager_ms = training_run(label, smi, config, batch, counters, capture,
                                                                   steps=steps)  # fmt: skip
        wide = window is not None
        want = {"flash_attention_fwd": steps, "flash_attention_bwd": steps, "vocab_gather_fwd": steps,
                "vocab_gather_bwd": steps, "flash_attention_window_fwd": steps if wide else 0,
                "flash_attention_window_bwd": steps if wide else 0}  # fmt: skip
        check(launches == want, f"{label}: launches {launches}, expected {want}")
        # Kernel E's inputs from the benchmark's run, F's from the wide-window one.
        a = capture.args.get(window)
        check(a is not None and a["g"] is not None, f"{label}: the attention inputs were not captured")
        runs[window] = dict(launches=launches, step_ms=step_ms, eager_step_ms=eager_ms, events=events, losses=losses)
        args[window] = a
    small_packed_step_matches_cpu()
    packed_kernels_match_plain_on_card()
    return runs, args


def small_packed_setup(**widths):
    """A small fp32 packed model (numpy seed 1, std-0.1 weights, dropout 0)
    and 2 packed rows of 256 events on the CPU, with float64-derived ``time``."""
    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import packed_batch, packed_training_config, serving_config
    from eventstreamgpt_tpu_torch.training import build_model

    small = dict(sizes=(5, 40, 6, 3), intermediate_size=64, input_dropout=0.0, resid_dropout=0.0, **widths)
    # Short subjects (16 events on average, as phase 4's small batch): event times of a few thousand minutes.
    batch = packed_batch(serving_config(precision="fp32", **small), 40, 2, 256, seed=SEED, mean_seq_len=16)
    config = packed_training_config([batch], precision="fp32", **small)
    return init_params_from_seed(build_model(config), seed=1, std=0.1), with_segment_time(batch)


def small_packed_step_matches_cpu():
    """One fp32 packed step at hidden 32 (one head of 32) on the card
    against the CPU, once with a local window of 32 (the band and kernel E)
    and once of 160 (kernels F and E), within 1e-4 as phase 4's small step."""
    for window in (32, 160):
        base, batch = small_packed_setup(hidden_size=32, num_attention_heads=1, head_dim=32, seq_window_size=window)
        cuda, cpu = one_fp32_step(base, batch, "cuda"), one_fp32_step(base, batch, "cpu")
        steps_match(cuda, cpu, 1e-4, f"packed, window {window}: card vs CPU")
        print(f"phase 8: small fp32 packed step (window {window}) on the card matches the CPU (loss {cpu[0]:.6f}, "
              f"max |grad diff| {grad_diff(cuda, cpu):.3g})", flush=True)  # fmt: skip


def flash_attention_f64(query, key, value, segment_ids, window=None):
    """Kernels E and F's function computed in fp64 and rounded once to the value dtype."""
    import torch

    from eventstreamgpt_tpu_torch.ops.flash_attention import attention_mask

    logits = torch.matmul(query.double(), key.double().transpose(-1, -2))
    probs = torch.softmax(logits.masked_fill(~attention_mask(segment_ids, window), float("-inf")), dim=-1)
    return torch.matmul(probs, value.double()).to(value.dtype)


def packed_kernels_match_plain_on_card():
    """The small fp32 packed step at hidden 128 (4 heads of 32), local window
    160, held by `kernels_match_plain_on_card` with kernels C, E and F."""
    import eventstreamgpt_tpu_torch.models.generative_layers as layers_module
    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd, vocab_gather_reference

    base, batch = small_packed_setup(hidden_size=128, num_attention_heads=4, head_dim=32, seq_window_size=160)
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, fa.flash_attention_window_fwd,
                fa.flash_attention_window_bwd, vocab_gather_fwd, vocab_gather_bwd)  # fmt: skip
    kernels_match_plain_on_card(
        "phase 8", "packed", base, batch, counters,
        [(transformer_module, "flash_attention", fa.flash_attention_reference, flash_attention_f64),
         (layers_module, "vocab_gather", vocab_gather_reference, vocab_gather_reference)],
    )  # fmt: skip


# ---------------------------------------------------------------- phase 9
def kernel_ef_phase(args, phase="phase 9", tag=""):
    """Kernels E (``window`` None) and F against their plain versions on the
    captured inputs, then timed in bf16 beside their bound and the library
    call; each row named with ``tag`` after the kernel's name."""
    import torch
    import torch.nn.functional as F

    from eventstreamgpt_tpu_torch.ops import flash_attention as fa

    result = {}
    for window, a in args.items():
        B, H, S, D = a["q"].shape
        seg = a["seg"]
        fwd = fa.flash_attention_fwd if window is None else fa.flash_attention_window_fwd
        bwd = fa.flash_attention_bwd if window is None else fa.flash_attention_window_bwd
        extra = () if window is None else (window,)
        name = ("flash_attention" if window is None else "flash_attention_window") + tag
        # The captured cotangent is small (the loss averages over ~8k events);
        # scaled to a largest magnitude of 1 it gives O(1) gradients.
        g_unit = a["g"] / a["g"].float().abs().max()
        max_err = {"fwd": 0.0, "bwd": 0.0}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, g = (t.to(dt) for t in (a["q"], a["k"], a["v"], g_unit))
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            want = fa.flash_attention_reference(*leaves, seg, window)
            want_grads = torch.autograd.grad(want, leaves, g)
            out, stats = fwd(q, k, v, seg, *extra)
            got_grads = bwd(q, k, v, seg, out, stats, g, *extra)
            # Not checked: each version's distance from the function computed in fp64.
            leaves64 = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
            exact = flash_attention_f64(*leaves64, seg, window)
            exact = (exact, *torch.autograd.grad(exact, leaves64, g.double()))
            # Not checked either: the kernel's backward given the fp64 output, so
            # that its di = sum(o * do) carries no rounding of o.
            exact_di = bwd(q, k, v, seg, exact[0].to(dt), stats, g, *extra)
            torch.cuda.synchronize()
            errs, tols, kernel64, plain64 = [], [], [], []
            for part, x, y, z in zip(("out", "dq", "dk", "dv"), (out, *got_grads), (want, *want_grads), exact):
                # fp32: 3e-5 of the largest magnitude; bf16: 5e-2 of it. The
                # kernel takes di = sum(o * do) from the rounded output, as the
                # TPU kernels do, where the plain version's autograd sums p * dP:
                # on trained activations, whose softmax rows are peaked, dP - di
                # cancels and leaves the output's rounding (fp32 ulps, or a bf16
                # ulp: 2^-9 of |o| |do|) in dS, which the plain version does not
                # carry. In bf16 the kernel also rounds the unnormalised
                # probabilities and the plain version the normalised ones and,
                # through its bf16 product, dP. Each version's distance from the
                # fp64 function is printed.
                top = y.float().abs().max().item()
                errs.append((x.float() - y.float()).abs().max().item())
                tols.append((3e-5 if dt == torch.float32 else 5e-2) * top)
                kernel64.append((x.double() - z).abs().max().item())
                plain64.append((y.double() - z).abs().max().item())
                if dt == torch.bfloat16:
                    key = "fwd" if part == "out" else "bwd"
                    max_err[key] = max(max_err[key], errs[-1])
            print(f"{phase}: {name} ({dt}) at (B={B}, H={H}, S={S}, D={D}), window {window}: max |diff| "
                  f"out/dq/dk/dv {', '.join(f'{e:.3g}' for e in errs)} (largest |plain| "
                  f"{', '.join(f'{y.float().abs().max().item():.3g}' for y in (want, *want_grads))}); not "
                  f"checked, vs fp64: kernel {', '.join(f'{e:.3g}' for e in kernel64)}, plain "
                  f"{', '.join(f'{e:.3g}' for e in plain64)}, kernel backward with di from the fp64 output "
                  f"{', '.join(f'{(x.double() - z).abs().max().item():.3g}' for x, z in zip(exact_di, exact[1:]))}",
                  flush=True)  # fmt: skip
            for part, err, tol in zip(("out", "dq", "dk", "dv"), errs, tols):
                check(err <= tol, f"kernel {name} {part} ({dt}) off its plain version by {err:.3g} "
                                  f"(tolerance {tol:.3g})")  # fmt: skip

        # Timing at the main path's shapes and type: bf16, the views the model passes.
        dt = torch.bfloat16
        q, k, v, g = (t.to(dt) for t in (a["q"], a["k"], a["v"], a["g"]))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = fa.flash_attention_reference(*leaves, seg, window)
        out, stats = fwd(q, k, v, seg, *extra)
        mask = fa.attention_mask(seg, window)  # (B, 1, S, S)
        lib = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib, attn_mask=mask, scale=1.0)
        t_fwd = timings(lambda: fwd(q, k, v, seg, *extra),
                        lambda: fa.flash_attention_reference(q, k, v, seg, window),
                        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0))  # fmt: skip
        t_bwd = timings(lambda: bwd(q, k, v, seg, out, stats, g, *extra),
                        lambda: torch.autograd.grad(ref_out, leaves, g, retain_graph=True),
                        lambda: torch.autograd.grad(lib_out, lib, g, retain_graph=True))  # fmt: skip
        # What tile skipping leaves, counted on the card: the tiles each kernel
        # walked in one forward and one backward, held equal to what
        # `tile_schedule` visits (H times), over the causal (and window) tiles;
        # and the time on the same q, k, v with one segment a row (no tile skipped).
        from eventstreamgpt_tpu_torch.utils.timing import time_ms

        one = torch.zeros_like(seg)
        in_range = fa.causal_tiles(S // fa.TILE, window).sum().item() * B * H
        walked = {}
        for label, ids in (("packed", seg), ("one-segment", one)):
            fa.tiles_walked()
            o_ids, stats_ids = fwd(q, k, v, ids, *extra)
            bwd(q, k, v, ids, o_ids, stats_ids, g, *extra)
            walked[label] = fa.tiles_walked()
            want = fa.tile_schedule(ids, window).sum().item() * H
            check(all(n == want for n in walked[label].values()),
                  f"kernel {name} walked {walked[label]} tiles on the {label} batch, where tile_schedule "
                  f"visits {want}")  # fmt: skip
        share = walked["packed"]["fwd"] / in_range
        one_out, one_stats = fwd(q, k, v, one, *extra)
        t_one = {"fwd": time_ms(lambda: fwd(q, k, v, one, *extra))["ms"],
                 "bwd": time_ms(lambda: bwd(q, k, v, one, one_out, one_stats, g, *extra))["ms"]}  # fmt: skip
        print(f"{phase}: {name} (window {window}) walked {walked['packed']} tiles (counted on the card; "
              f"tile_schedule's count) of {in_range} causal tiles over {B} rows x {H} heads: share {share:.4f}; "
              f"with one segment a row it walked {walked['one-segment']} (all) in forward {t_one['fwd']:.4f} ms, "
              f"backward {t_one['bwd']:.4f} ms against {t_fwd['ms']:.4f} / {t_bwd['ms']:.4f} ms on the packed batch",
              flush=True)  # fmt: skip
        esz = q.element_size()
        pairs = int(mask.sum()) * H  # allowed (query, key) pairs of this batch, every head
        tensor = B * H * S * D * esz
        small = B * S * 4 + 2 * B * H * S * 4  # segment ids; each row's m and l
        fwd_bytes, bwd_bytes = 4 * tensor + small, 8 * tensor + small  # q, k, v, o (+ do, dq, dk, dv)
        parts = (("fwd", t_fwd, fwd_bytes, 4 * D * pairs), ("bwd", t_bwd, bwd_bytes, 10 * D * pairs))
        for part, t, nbytes, flops in parts:
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bf16"] * 1e3
            result[f"{name}_{part}"] = dict(t, bound_ms=max(bytes_ms, ops_ms),
                                            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                                            max_abs_err=max_err[part], shape=[B, H, S, D], window=window,
                                            visited_share=share, one_segment_ms=t_one[part])  # fmt: skip
            print(f"{phase}: {name} {part} (bf16, window {window}): {fmt_times(t)}; bound "
                  f"{result[f'{name}_{part}']['bound_ms']:.5f} ms ({nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP over "
                  f"{pairs} allowed pairs, {pairs / (B * H * S * (S + 1) / 2):.3f} of the causal triangle)",
                  flush=True)  # fmt: skip
    return result


# ---------------------------------------------------------------- phase 10
def chunked_run(label, smi, config, dd, packed, n_epochs, counters):
    """Phase 10 for one model: the chunked run, then the same plans as single
    captured steps; the comparisons and checks of the module docstring."""
    import torch

    from eventstreamgpt_tpu_torch.tools.profile_train import epoch_batches, epoch_chunks, fresh_optimized
    from eventstreamgpt_tpu_torch.training import make_chunked_train_step, make_train_step
    from eventstreamgpt_tpu_torch.training.pretrain import _plan_event_count

    # bench.py's plan stream: the warm chunk (the first of plan seed 0), then
    # the epochs (plan seeds 1, 2, ...).
    epochs = [epoch_chunks(dd, packed, seed)[: 1 if seed == 0 else None] for seed in range(n_epochs + 1)]
    steps = [sum(len(next(iter(p.values()))) for p, _ in e) for e in epochs]
    k = CHUNK_PACKED if packed else CHUNK
    check(all(len(next(iter(p.values()))) == k for e in epochs for p, _ in e), f"{label}: a chunk is not {k} steps")
    # The single steps' batches: the same plan streams, collated on the card.
    batches = []
    for seed, (chunks, n) in enumerate(zip(epochs, steps)):
        batches.append(epoch_batches(dd, packed, seed, n))
        rows = [{f: v[i : i + 1] for f, v in p.items()} for p, _ in chunks for i in range(k)]
        check([int(b.event_mask.sum()) for b in batches[-1]] == [_plan_event_count(r, dd.dataset) for r in rows],
              f"{label}: the collated batches are not the chunks' plans")  # fmt: skip

    def run(call, epoch_items, reset):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step = reset()
        for fn in counters:  # just before the run
            fn.launches = 0
        healths, walls, captures = [], [], []
        for items in epoch_items:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for item in items:
                healths.append(call(step, item))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            captures.append(step.stats()["graph_captures"])
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        return step, torch.cat([h.reshape(-1, 2) for h in healths]).cpu(), walls, captures, launches, peak

    chunked = {}
    c_step, c_h, c_walls, c_caps, c_launches, c_peak = run(
        lambda st, item: st(item[0], SEED)[1], epochs,
        lambda: make_chunked_train_step(*chunked.setdefault("opt", fresh_optimized(config)), dd, packed=packed,
                                        with_health=True))  # fmt: skip
    single = {}
    s_step, s_h, s_walls, _, s_launches, s_peak = run(
        lambda st, b: st(b, SEED)[1], batches,
        lambda: make_train_step(*single.setdefault("opt", fresh_optimized(config)), with_health=True))  # fmt: skip

    n_steps = sum(steps)
    check(torch.equal(c_h, s_h), f"{label}: the chunked steps' [loss, grad norm] differ from the single steps': "
          f"{c_h[:4].tolist()} vs {s_h[:4].tolist()}")  # fmt: skip
    (cm, co, cs), (sm, so, ss) = chunked["opt"], single["opt"]
    for (name, a), b in zip(cm.named_parameters(), sm.parameters()):
        check(torch.equal(a, b), f"{label}: parameter {name} differs from the single steps'")
    for a, b in zip(co.state.values(), so.state.values()):
        check(all(torch.equal(a[f], b[f]) for f in a), f"{label}: an AdamW state tensor differs from the single steps'")
    check(c_step.state.step == s_step.state.step == n_steps and cs.last_epoch == ss.last_epoch == n_steps,
          f"{label}: the step counts differ: {c_step.state.step}, {s_step.state.step}, {cs.last_epoch}")  # fmt: skip
    losses, norms = c_h[:, 0].tolist(), c_h[:, 1].tolist()
    check(all(math.isfinite(x) for x in losses + norms), f"{label}: a loss or gradient norm is not finite: {losses}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall over {n_steps} steps: {losses}")
    st = c_step.stats()
    n_chunks = sum(len(e) for e in epochs)
    check((st["chunk_keys"], st["graph_warmup_chunks"], st["graph_captures"], st["graph_replays"])
          == (1, 1, 1, n_chunks - 1), f"{label}: not one warm-up and one capture of one key: {st}")  # fmt: skip
    check(c_caps[1] == c_caps[-1] == 1, f"{label}: captures after each epoch {c_caps}, not one in the first")
    check(c_launches == s_launches, f"{label}: chunked launches {c_launches}, single steps {s_launches}")
    per_step = {name: n // n_steps for name, n in s_launches.items()}
    check(all(n == per_step[name] * n_steps for name, n in c_launches.items()),
          f"{label}: launches {c_launches} are not {n_steps} times one step's")  # fmt: skip
    events = [sum(n for _, n in e) for e in epochs]
    key = next(iter(st["keys"].values()))
    plan_bytes = sum(v.nbytes for v in epochs[1][0][0].values()) / k
    c_rate, s_rate = events[-1] / c_walls[-1], events[-1] / s_walls[-1]
    print(f"{label}: {n_chunks} chunks of {k} steps ({n_steps} steps; warm chunk + {n_epochs} epoch(s) of "
          f"{len(epochs[1])} chunk(s), {events[1:]} real events), equal to {n_steps} single captured steps bit for bit "
          f"(losses, [loss, grad norm], parameters, AdamW state); loss {losses[0]:.4f} -> {losses[-1]:.4f}; trained "
          f"events/s by epoch chunked {[round(e / w, 1) for e, w in zip(events, c_walls)]}, single "
          f"{[round(e / w, 1) for e, w in zip(events, s_walls)]} (last epoch: {c_rate:.1f} vs {s_rate:.1f}, step "
          f"{c_walls[-1] / steps[-1] * 1e3:.3f} vs {s_walls[-1] / steps[-1] * 1e3:.3f} ms); plan bytes a step "
          f"{plan_bytes:.1f} (with the rates, in one copy a chunk: {key['plan_bytes'] / k:.1f}); capture and "
          f"instantiation of the {k}-step chunk {key['capture_s']:.2f} s (a single step's "
          f"{s_step.stats()['capture_s']:.2f} s); peak memory chunked {c_peak:.3f} GB, "
          f"single {s_peak:.3f} GB; captures after each epoch {c_caps}; launches {c_launches} "
          f"({per_step} a step) ({smi})", flush=True)  # fmt: skip
    return dict(launches=c_launches, per_step=per_step)


def chunked_training_phase(smi):
    import numpy as np

    from eventstreamgpt_tpu_torch.data.device_dataset import DeviceDataset
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        packed_training_config,
        serving_config,
        synthetic_csr,
        training_config,
    )
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.torch_dataset import CSRDataset
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd

    t0 = time.perf_counter()
    csr = synthetic_csr(np.random.default_rng(SEED), serving_config(), COHORT, mean_seq_len=200)
    padded = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=TRAIN_SEQ)))
    packed = DeviceDataset(CSRDataset(csr, PytorchDatasetConfig(max_seq_len=PACKED_SEQ)))
    for dd in (padded, packed):
        check(dd.nbytes == DeviceDataset.estimate_nbytes(dd.dataset) and dd.arrays["dynamic_indices"].is_cuda,
              "phase 10: the resident tables are not what estimate_nbytes predicts, or not on the card")  # fmt: skip
    print(f"phase 10: cohort of {COHORT} subjects, {len(csr.time_delta)} events, up to {padded.dataset.max_n_dynamic} "
          f"elements an event; resident tables {padded.nbytes / 1e6:.2f} MB (L={TRAIN_SEQ}) and "
          f"{packed.nbytes / 1e6:.2f} MB (L={PACKED_SEQ}) on the card, built in {time.perf_counter() - t0:.1f} s", flush=True)  # fmt: skip
    counters = (vocab_gather_fwd, vocab_gather_bwd, dep_graph_fwd, dep_graph_bwd, fa.flash_attention_fwd,
                fa.flash_attention_bwd, fa.flash_attention_window_fwd, fa.flash_attention_window_bwd)  # fmt: skip
    first = next(padded.batches(TRAIN_BATCH, seed=0)).map(lambda t: t.cpu())
    first_packed = next(packed.packed_batches(PACKED_BATCH, seq_len=PACKED_SEQ, seed=0)).map(lambda t: t.cpu())
    cases = (
        ("CI", training_config([first]), padded, False, CHUNK_EPOCHS, dict(vocab_gather_fwd=1, vocab_gather_bwd=1)),
        ("NA", na_training_config([first]), padded, False, CHUNK_EPOCHS,
         dict(vocab_gather_fwd=1, vocab_gather_bwd=1, dep_graph_fwd=2, dep_graph_bwd=2)),
        ("packed, local window 32", packed_training_config([first_packed]), packed, True, CHUNK_EPOCHS,
         dict(vocab_gather_fwd=1, vocab_gather_bwd=1, flash_attention_fwd=1, flash_attention_bwd=1)),
        ("packed, local window 256", packed_training_config([first_packed], seq_window_size=WIDE_WINDOW), packed, True,
         CHUNK_EPOCHS, dict(vocab_gather_fwd=1, vocab_gather_bwd=1, flash_attention_fwd=1, flash_attention_bwd=1,
                 flash_attention_window_fwd=1, flash_attention_window_bwd=1)),
    )  # fmt: skip
    runs = {}
    for label, config, dd, is_packed, n_epochs, want in cases:
        check(config.precision == "bf16" and config.resid_dropout == 0.1 and config.hidden_size == 256,
              f"phase 10 [{label}]: not the benchmark's training config")  # fmt: skip
        run = chunked_run(f"phase 10 [{label}]", smi, config, dd, is_packed, n_epochs, counters)
        want = {fn.__name__: want.get(fn.__name__, 0) for fn in counters}
        check(run["per_step"] == want, f"phase 10 [{label}]: launches a step {run['per_step']}, expected {want}")
        runs[label] = run
    return runs

# ---------------------------------------------------------------- phase 11
PAGED_BLOCK, FORK_PROMPTS, FORK_BRANCHES, FORK_SEED = 16, 16, 4, 1000
KERNEL_B_ENTRIES = ("launches", "launches_int8", "launches_fp8")


def zero_block_intact(engine) -> bool:
    """Block 0 of every pool plane all zero (and its scales, quantized, all one)."""
    import torch

    planes = (engine.key_cache[:, 0], engine.value_cache[:, 0])
    scales = [s[:, 0] for s in (engine.key_scale, engine.value_scale) if s is not None]
    return not any(bool(p.view(torch.uint8).any()) for p in planes) and all(bool((s == 1).all()) for s in scales)


def paged_runs(smi, model, config, prompts, counters, base_kw):
    """The paged engine on phase 2's requests (bf16 greedy at depth 2, bf16
    sampled at depth 1, int8 sampled at depth 2), each in phase 2's three
    passes, against the same engine run eagerly and the monolithic engine's
    unfused step (first pass, bit for bit), and, bf16 sampled, the three
    passes of the monolithic unfused and kernel-B engines for their events/s."""
    paged_kw = dict(paged_kv=True, block_size=PAGED_BLOCK)

    def kernel_b(launches):
        return sum(launches[f"decode_stack_step.{c}"] for c in KERNEL_B_ENTRIES)

    launches_a, rates = 0, {}
    for name, kv, mode, depth in (("bf16", None, "greedy", 2), ("bf16", None, "sampled", 1),
                                  ("int8", "int8", "sampled", 2)):  # fmt: skip
        label = f"phase 11 [paged {name} {mode}, depth {depth}]"
        kw = dict(base_kw, greedy=mode == "greedy", kv_cache_dtype=kv, dispatch_depth=depth)
        zero_ok = {}
        run = engine_run(model, config, prompts, counters, **kw, **paged_kw,
                         after_pass=lambda e, name: zero_ok.update({name: zero_block_intact(e)}))  # fmt: skip
        engine, stats = run["engine"], run["stats"]
        check_results(run["results"], run["requests"], label)
        pool = base_kw["n_slots"] * base_kw["max_len"] // PAGED_BLOCK + 1  # the default: every slot's full table
        check(stats["decode_step_impl"] == "unfused" and stats["block_pool_num_blocks"] == pool,
              f"{label}: not the paged unfused engine: {stats}")  # fmt: skip
        for p in run["passes"].values():
            check(kernel_b(p["launches"]) == 0, f"{label}: kernel B launched on a paged engine: {p['launches']}")
            a = p["launches"]["fused_categorical_stream"]
            check(a > 0 if mode == "sampled" else a == 0, f"{label}: kernel A launched {a} times ({mode})")
            check(p["launches"]["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
        check_graph_counts(run, label, None)
        check_passes(run, label)
        check(zero_ok == dict.fromkeys(PASSES, True), f"{label}: block 0 was written: {zero_ok}")
        high = run["passes"]["accounting"]["stats"]["block_pool_high_water"]
        engine.reset()
        rep = engine.scheduler.padding_report()
        check(rep["block_pool_in_use"] == 0 and rep["block_pool_high_water"] == high > 0,
              f"{label}: reset() left {rep['block_pool_in_use']} blocks in use, high water "
              f"{rep['block_pool_high_water']}")  # fmt: skip
        eager = engine_run(model, config, prompts, counters, passes=("warm",), cuda_graph=False, **kw, **paged_kw)
        same_results(run["results"], eager["results"], label)
        timed = mode == "sampled" and depth == 1
        mono = engine_run(model, config, prompts, counters, passes=PASSES if timed else ("warm",),
                          decode_step_impl="xla", **kw)  # fmt: skip
        check(kernel_b(mono["launches"]) == 0 and mono["stats"]["decode_step_impl"] == "unfused",
              f"{label}: the monolithic unfused engine ran kernel B")  # fmt: skip
        same_results(run["results"], mono["results"], label, "paged vs the monolithic unfused step")
        generated = sum(r.n_generated for r in run["results"])
        launches_a += run["launches"]["fused_categorical_stream"]
        acct = run["passes"]["accounting"]
        line = (f"{label} {len(run['results'])} requests, {generated} generated events, every event, integer and "
                f"float equal captured and eager, paged and monolithic unfused, and in each pass after reset(); "
                f"{generated / acct['wall_s']:.1f} events/s in {acct['wall_s']:.4f} s (fetch_results=False), warm pass "
                f"{run['passes']['warm']['wall_s']:.3f} s; {programs_line(run)}; launches over three passes "
                f"{run['launches']}; block 0 zero after each pass; pool {stats['block_pool_num_blocks']} blocks of "
                f"{PAGED_BLOCK}, high water {high}, kv_cache_bytes {stats['kv_cache_bytes']}")  # fmt: skip
        if timed:
            fused = engine_run(model, config, prompts, counters, **kw)
            check(kernel_b(fused["launches"]) > 0, f"{label}: the kernel-B engine never ran kernel B")
            for which, r in (("paged", run), ("monolithic unfused", mono), ("monolithic kernel B", fused)):
                a = r["passes"]["accounting"]
                rates[which] = dict(events_per_s=generated / a["wall_s"], wall_s=a["wall_s"],
                                    chunks=a["stats"]["dispatched_chunks"])  # fmt: skip
            line += f"; captured, depth 1, accounting pass, same requests: {json.dumps(rates)}"
        print(f"{line} ({smi})", flush=True)
    return launches_a, rates


def batch1_fork_forward(engine, forks) -> dict:
    """Each fork prompt's forward at its bucket on the engine's model, once
    at batch 1 (JAX's fork forward) and once as the 4 rows of its branches'
    group (what the port's fork runs): how many prompts give row 0 the same
    bits both ways in every prediction at the last prompt event and every
    layer's keys and values, and the largest difference of each."""
    import torch

    from eventstreamgpt_tpu_torch.generation.generation_utils import _slice_preds_at
    from eventstreamgpt_tpu_torch.models.transformer import init_kv_caches

    out = dict(prompts=len(forks), bit_identical=0, max_abs_diff_preds=0.0, max_abs_diff_kv=0.0)
    with torch.inference_mode():
        for p, _ in forks:
            n = p.sequence_length
            bucket = engine.scheduler.bucket_for(n)
            rows = {}
            for g in (1, FORK_BRANCHES):
                x = {f: torch.zeros(shape, dtype=dtype, device=engine.device)
                     for f, (shape, dtype) in engine._row_fields(g).items()}  # fmt: skip
                for i in range(g):
                    engine._stage_prompt(x, i, p)
                view = engine._staged_rows(x).slice((slice(None), slice(0, bucket)))
                res = engine._model(view, past=init_kv_caches(engine.config, g, engine.max_len, engine.device),
                                    use_cache=True)  # fmt: skip
                preds = []
                _slice_preds_at(res.preds, torch.full((g,), n - 1, device=engine.device)).map(
                    lambda t: preds.append(t[:1].contiguous()) or t
                )
                kv = [getattr(c, w)[:1].contiguous() for c in res.past_key_values for w in ("key", "value")]
                rows[g] = preds, kv
            same = True
            for i, key in enumerate(("max_abs_diff_preds", "max_abs_diff_kv")):
                for a, b in zip(rows[1][i], rows[FORK_BRANCHES][i]):
                    same &= torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    d = (a.float() - b.float()).abs().nan_to_num(0.0)
                    out[key] = max(out[key], float(d.max()) if d.numel() else 0.0)
            out["bit_identical"] += int(same)
    return out


def fork_runs(smi, model, config, prompts, counters, base_kw):
    """16 shared prompts forked 4 ways (sampled, session seeds 1000 + i) on the
    paged engine, two passes (warm, then after ``reset()``), against 64
    independent requests with ``derive_request_seed(session, j)`` on a paged
    engine whose groups are 4 wide (the fork group's width); then
    `batch1_fork_forward` on the fork prompts, measured."""
    import torch

    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    kw = dict(base_kw, paged_kv=True, block_size=PAGED_BLOCK)
    forks = prompts[:FORK_PROMPTS]
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    engine = GenerationEngine(model, config, template=prompts[0][0], **kw)
    out, before = [], 0
    for name in ("warm", "after reset()"):
        if name != "warm":
            engine.reset()
        for i, (p, b) in enumerate(forks):
            engine.fork(p, FORK_BRANCHES, b, key=FORK_SEED + i, request_id=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.plan_and_dispatch()
        shared = engine.scheduler.padding_report()["block_pool_shared_blocks"]
        results = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = engine.stats()
        label = f"phase 11 [fork, {name}]"
        check(shared > 0, f"{label}: no block was shared while the first groups were resident")
        check(s["fork_groups_admitted"] == FORK_PROMPTS and s["fork_branches_admitted"] == FORK_PROMPTS * FORK_BRANCHES
              and s["prefill_rows_computed"] == s["prefill_dispatches"] == FORK_PROMPTS,
              f"{label}: fork accounting {s}")  # fmt: skip
        replays = s["prefill_graph_replays"] - before
        check(replays == FORK_PROMPTS, f"{label}: {replays} prefill replays for {FORK_PROMPTS} fork groups")
        check(s["prefill_graph_captures"] == s["prefill_graph_keys"] and not any(
            k.startswith("fork_") and "_graph_" in k for k in s), f"{label}: programs not captured once a key: {s}")
        check(zero_block_intact(engine), f"{label}: block 0 was written")
        before = s["prefill_graph_replays"]
        out.append((results, wall, shared, s))
        check_results(results, range(FORK_PROMPTS * FORK_BRANCHES), label)
    same_results(out[0][0], out[1][0], "phase 11 [fork]", "warm pass vs the pass after reset()")
    ref = GenerationEngine(model, config, template=prompts[0][0], **kw)
    ref.scheduler.group_sizes = (FORK_BRANCHES,)
    reqs = [Request(prompt=p, max_new_events=b, request_id=(i, j), key=derive_request_seed(FORK_SEED + i, j))
            for i, (p, b) in enumerate(forks) for j in range(FORK_BRANCHES)]  # fmt: skip
    same_results(out[0][0], ref.run(reqs), "phase 11 [fork]", "fork vs independent submissions")
    results, wall, shared, s = out[1]
    generated = sum(r.n_generated for r in results)
    paged = engine.slots_report(branch_factor=FORK_BRANCHES)["paged"]
    print(f"phase 11 [fork] {FORK_PROMPTS} prompts x {FORK_BRANCHES} branches, {generated} generated events: every "
          f"branch equal bit for bit to an independent request with derive_request_seed(session, j) (groups "
          f"{FORK_BRANCHES} wide) and the pass after reset() to the warm pass; {generated / wall:.1f} events/s "
          f"({wall:.4f} s, fetching); {FORK_PROMPTS} prefill replays a pass ({s['prefill_graph_keys']} keys); "
          f"{shared} shared blocks after the first "
          f"admission; pool {json.dumps({k: v for k, v in s.items() if k.startswith('block_pool_')})}; "
          f"slots_report()['paged'] at the card's memory, branch factor {FORK_BRANCHES}: {json.dumps(paged)} ({smi})",
          flush=True)  # fmt: skip
    b1 = batch1_fork_forward(engine, forks)
    print(f"phase 11 [fork] measured, not checked: a batch-1 forward of each fork prompt (JAX's fork forward) against "
          f"row 0 of its {FORK_BRANCHES}-row group's forward (the port's fork), bf16, at the prompt's bucket: "
          f"{json.dumps(b1)} ({smi})", flush=True)  # fmt: skip
    return b1


def decode_profiles(smi, model, config, prompts, base_kw):
    """One profiled 16-step chunk of each decode step on 32 admitted slots
    (budgets of 64; `tools.profile_decode`'s filled engine): the paged
    engine, the monolithic unfused one and the kernel-B one, sampled, bf16,
    depth 1, each built (and captured) before the first profile. (The spec
    engines' round profiles went to keep the script's time:
    ``tools/profile_decode.py --spec`` takes them.)"""
    from eventstreamgpt_tpu_torch.tools.profile_decode import filled_engine, profiled_engine_chunk

    kw = dict(base_kw, greedy=False, dispatch_depth=1)
    engines = {
        "paged": filled_engine(model, config, prompts, **kw, paged_kv=True, block_size=PAGED_BLOCK),
        "monolithic unfused": filled_engine(model, config, prompts, **kw, decode_step_impl="xla"),
        "monolithic kernel B": filled_engine(model, config, prompts, **kw),
    }
    out = {}
    for name, engine in engines.items():
        summary = profiled_engine_chunk(engine)
        out[name] = {k: summary[k] for k in ("step_wall_ms", "active_slots", "device_busy_ms_per_step",
                                             "device_kernels_per_step", "host_launches_per_step",
                                             "device_idle_share_unprofiled", "committed_events_per_round_and_slot")
                     if k in summary}  # fmt: skip
        check(summary["device_kernels_per_step"] > 0, f"phase 12: no device kernel in the {name} profile")
    print(f"phase 12: decode step, one profiled captured chunk of 16 at 32 admitted slots (sampled, bf16): "
          f"{json.dumps(out)} ({smi})", flush=True)  # fmt: skip
    return out


def paged_phase(smi, model, config):
    """Phase 11: the paged copy-on-write cache and ``fork()`` at phase 2's width."""
    import numpy as np

    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream

    t0 = time.perf_counter()
    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, serving_config(), (128, 192), (16, 64))
    base_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)
    counters = {f"decode_stack_step.{c}": (decode_stack_step, c) for c in KERNEL_B_ENTRIES}
    counters.update(fused_categorical_stream=(fused_categorical_stream, "launches"),
                    fused_categorical=(fused_categorical, "launches"))  # fmt: skip
    launches_a, rates = paged_runs(smi, model, config, prompts, counters, base_kw)
    t1 = time.perf_counter()
    batch1 = fork_runs(smi, model, config, prompts, counters, base_kw)
    t2 = time.perf_counter()
    print(f"phase 11: passed in {t2 - t0:.1f} s (paged runs {t1 - t0:.1f}, fork {t2 - t1:.1f}; its profiles are "
          "phase 12's)", flush=True)  # fmt: skip
    return dict(launches_a=launches_a, rates=rates, batch1=batch1)


# ---------------------------------------------------------------- phase 12
SPEC_K = 4  # bench.py's spec arm (its SPEC_K)
SPEC_STRICT = dict(value_rtol=0.0, value_atol=0.0)


def spec_runs(smi, model, config, prompts, counters, base_kw, spec):
    """The spec engine on phase 2's requests (bf16 greedy at zero tolerances,
    depth 2; bf16 sampled at depths 1 and 2; int8 sampled at depth 2),
    captured: bf16 sampled at depth 1 in phase 2's three passes, the others
    in the warm and accounting passes. Captured against eager is the small
    engine's check (`small_engine_matches_cpu`: the card's captured programs
    against the CPU's eager ones) and the ``spec`` CUDA tests'."""

    def kernel_b(launches):
        return sum(launches[f"decode_stack_step.{c}"] for c in KERNEL_B_ENTRIES)

    out, launches_a = {}, 0
    for name, kv, mode, depth in (("bf16", None, "greedy", 2), ("bf16", None, "sampled", 1),
                                  ("bf16", None, "sampled", 2), ("int8", "int8", "sampled", 2)):  # fmt: skip
        label = f"phase 12 [spec {name} {mode}, depth {depth}]"
        t0 = time.perf_counter()
        sc = spec(**(SPEC_STRICT if mode == "greedy" else {}))
        kw = dict(base_kw, greedy=mode == "greedy", kv_cache_dtype=kv, dispatch_depth=depth, spec=sc)
        passes = PASSES if (name, mode, depth) == ("bf16", "sampled", 1) else ("warm", "accounting")
        run = engine_run(model, config, prompts, counters, passes=passes, **kw)
        stats = run["stats"]
        check_results(run["results"], run["requests"], label)
        check(stats["decode_step_impl"] == "spec_draft_verify", f"{label}: not the spec engine: {stats}")
        for pname, p in run["passes"].items():
            check(kernel_b(p["launches"]) == 0, f"{label}: kernel B launched on a spec engine: {p['launches']}")
            a = p["launches"]["fused_categorical_stream"]
            check(a > 0 if mode == "sampled" else a == 0, f"{label}: kernel A launched {a} times ({mode})")
            check(p["launches"]["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
            ps = p["stats"]
            check(ps["spec_rounds"] == ps["dispatched_chunks"] * ps["decode_chunk"] > 0,
                  f"{label} [{pname} pass]: {ps['spec_rounds']} rounds for {ps['dispatched_chunks']} chunks")  # fmt: skip
        check_graph_counts(run, label, None)
        check_passes(run, label)
        spec_counts = [(r.spec_proposed, r.spec_accepted) for r in run["results"]]
        for pname in passes[1:]:
            check([(r.spec_proposed, r.spec_accepted) for r in run["passes"][pname]["results"]] == spec_counts,
                  f"{label} [{pname} pass]: per-request proposals or acceptances differ from the warm pass")  # fmt: skip
        launches_a += run["launches"]["fused_categorical_stream"]
        acct = run["passes"]["accounting"]
        s = acct["stats"]
        generated = sum(r.n_generated for r in run["results"])
        rates = dict(events_per_s=generated / acct["wall_s"], wall_s=acct["wall_s"], chunks=s["dispatched_chunks"],
                     rounds=s["spec_rounds"], acceptance_rate=s["spec_acceptance_rate"],
                     committed_per_active_slot_round=s["spec_committed_events"] / max(s["active_slot_steps"], 1),
                     proposed=s["spec_proposed_events"], accepted=s["spec_accepted_events"],
                     committed=s["spec_committed_events"])  # fmt: skip
        out[(name, mode, depth)] = dict(run, rates=rates, generated=generated)
        equal = "every event, integer and float equal in the pass after reset()" if "fetching" in passes else (
            "the same accounting in the pass after reset()")  # fmt: skip
        print(f"{label} {len(run['results'])} requests, {generated} generated events, {equal}; "
              f"accounting pass {json.dumps(rates)}; {programs_line(run)}; launches over the {len(passes)} passes "
              f"{run['launches']}; warm pass {run['passes']['warm']['wall_s']:.3f} s; the run and its checks "
              f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)  # fmt: skip
    return out, launches_a


def spec_phase(smi, model, config):
    """Phase 12: speculative decoding at phase 2's width (module docstring)."""
    import numpy as np

    import torch

    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream
    from eventstreamgpt_tpu_torch.serving import SpecConfig, truncated_draft

    t0 = time.perf_counter()
    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, serving_config(), (128, 192), (16, 64))
    base_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)
    counters = {f"decode_stack_step.{c}": (decode_stack_step, c) for c in KERNEL_B_ENTRIES}
    counters.update(fused_categorical_stream=(fused_categorical_stream, "launches"),
                    fused_categorical=(fused_categorical, "launches"))  # fmt: skip
    dcfg, draft = truncated_draft(config, model, config.num_hidden_layers // 2)

    def spec(**tol):
        return SpecConfig(model=draft, config=dcfg, k=SPEC_K, **tol)

    runs, launches_a = spec_runs(smi, model, config, prompts, counters, base_kw, spec)
    t1 = time.perf_counter()
    # A perfect draft (the target itself), tolerant greedy: in fp32 (the same
    # weights) nearly every proposal is accepted. (The bf16 perfect draft, the
    # strict run's share equal to the non-spec engine's and the monolithic
    # engines' events/s, measured and not checked, went to keep the script's time.)
    config32 = copy.deepcopy(config)
    config32.precision = "fp32"
    model32 = type(model)(config32)
    model32.load_state_dict(model.state_dict())
    run = engine_run(model32, config32, prompts, counters, passes=("warm",), greedy=True,
                     **dict(base_kw, spec=SpecConfig(model=model32, config=config32, k=SPEC_K)))  # fmt: skip
    check_results(run["results"], run["requests"], "phase 12 [perfect draft, fp32]")
    st = run["stats"]
    perfect = {"fp32": dict(acceptance_rate=st["spec_acceptance_rate"],
                            committed_per_active_slot_round=st["spec_committed_events"] / max(st["active_slot_steps"], 1))}
    rate = perfect["fp32"]["acceptance_rate"]
    check(config32.compute_dtype == torch.float32 and rate > 0.9, f"phase 12 [perfect draft, fp32]: acceptance {rate}")
    rates = {"spec": runs[("bf16", "sampled", 1)]["rates"]}
    report = runs[("bf16", "sampled", 1)]["engine"].slots_report()
    print(f"phase 12: perfect draft (the target, tolerant greedy, fp32): {json.dumps(perfect)}; events/s, sampled, "
          f"depth 1, accounting pass: {json.dumps(rates)}; slots_report() with the draft at the card's memory: "
          f"{json.dumps({k: report[k] for k in ('spec', 'params_bytes', 'draft_params_bytes', 'draft_kv_bytes_per_slot', 'row_bytes_per_slot', 'per_dtype')})} "
          f"({smi})", flush=True)  # fmt: skip
    small_engine_matches_cpu(spec_k=SPEC_K, phase="phase 12")
    t2 = time.perf_counter()
    print(f"phase 12: passed in {t2 - t0:.1f} s (spec runs {t1 - t0:.1f}, perfect draft and small engine "
          f"{t2 - t1:.1f}; its profiles come after phase 13's captures)", flush=True)  # fmt: skip
    return dict(launches_a=launches_a, rates=rates, perfect=perfect,
                profile=lambda: decode_profiles(smi, model, config, prompts, base_kw))  # fmt: skip


# ---------------------------------------------------------------- phase 13
# bench.py's generation arm: 32 prompts of 192 events, 64 new events (NA: 16), cached.
GEN_ROWS, GEN_PROMPT, GEN_NEW, GEN_NEW_NA, GEN_SEED, GEN_STOP = 32, 192, 64, 16, 2, 8
GEN_SMALL_NEW = 5


def batches_equal(a, b) -> bool:
    """Every event, integer and float of two generated batches equal (NaN where NaN)."""
    import torch

    return all(torch.equal(getattr(a, f).nan_to_num(-7.0), getattr(b, f).nan_to_num(-7.0))
               for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices",
                         "dynamic_values", "dynamic_values_mask"))  # fmt: skip


def categorical_heads(model) -> int:
    modes = model.output_layer.classification_mode_per_measurement.values()
    return sum(m == "single_label_classification" for m in modes)


def stop_at(n_events: int):
    """A `StoppingCriteriaList` whose one (custom) criterion fires once a row holds ``n_events`` events."""
    from eventstreamgpt_tpu_torch.generation import StoppingCriteria, StoppingCriteriaList

    class StopAt(StoppingCriteria):
        def __init__(self, limit):
            self.limit = limit

        def __call__(self, batch, n_events=None, **kwargs) -> bool:
            return n_events >= self.limit

    return StoppingCriteriaList([StopAt(n_events)])


def generate_runs(smi, name, model, config, prompt, new) -> dict:
    """Phase 13's full-width runs of one model (module docstring)."""
    import torch

    from eventstreamgpt_tpu_torch.generation import generate
    from eventstreamgpt_tpu_torch.generation.generation_utils import program_stats
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical_stream

    label = f"phase 13 [{name}]"
    na = name == "NA"
    want_a = categorical_heads(model) * (new + (1 if na else 0))

    def timed(**extra):
        fused_categorical_stream.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(model, prompt, config, seed=GEN_SEED, max_new_events=new, **extra)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fused_categorical_stream.launches

    first, first_s, a1 = timed()
    s1 = program_stats(model)
    check((s1["keys"], s1["warmups"], s1["captures"], s1["replays"]) == (1, 2, 2, new),
          f"{label}: the first call's programs {s1}")  # fmt: skip
    second, second_s, a2 = timed()
    s2 = program_stats(model)
    check(s2["captures"] == 2 and s2["replays"] - s1["replays"] == new,
          f"{label}: the second call captured or replayed otherwise: {s1} -> {s2}")  # fmt: skip
    check(a2 == want_a > 0, f"{label}: kernel A launched {a2} times, not {want_a} (one a categorical head a level)")
    check(second.sequence_length == GEN_PROMPT + new and bool(second.event_mask.all()),
          f"{label}: a row did not generate its budget")  # fmt: skip
    check(all(bool(torch.isfinite(getattr(second, f)).all()) for f in ("time_delta", "dynamic_values")),
          f"{label}: non-finite generated values")  # fmt: skip
    check(batches_equal(first, second), f"{label}: the second call differs from the first")
    eager, eager_s, a3 = timed(cuda_graph=False)
    check(batches_equal(second, eager), f"{label}: captured and eager generate() differ")
    check(a3 == a2, f"{label}: kernel A launched {a3} times eager, {a2} captured")
    stopped, stopped_s, a4 = timed(stopping_criteria=stop_at(GEN_PROMPT + GEN_STOP))
    cut = GEN_PROMPT + GEN_STOP
    check(not bool(stopped.event_mask[:, cut:].any()) and bool(stopped.event_mask[:, :cut].all()),
          f"{label}: the stopped run is not cut at {GEN_STOP} events")  # fmt: skip
    for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values",
              "dynamic_values_mask"):  # fmt: skip
        n = cut - 1 if f == "time_delta" else cut  # the last event's delta is drawn with the next event
        check(torch.equal(getattr(stopped, f)[:, :n], getattr(second, f)[:, :n]),
              f"{label}: the stopped run's {f} is not a prefix of the full run's")  # fmt: skip
    rate = GEN_ROWS * new / second_s
    print(f"{label} {GEN_ROWS} prompts of {GEN_PROMPT} events, {new} new events each, sampled, cached: every row "
          f"its budget, finite; second call equal to the first and to the eager call bit for bit, no capture, "
          f"{s2['replays'] - s1['replays']} replays; kernel A {a2} launches a call (eager {a3}); stopped at "
          f"{GEN_STOP} events a prefix of the full run; generated events/s {rate:.1f} (second call "
          f"{second_s * 1e3:.2f} ms; first call with warm-ups and captures {first_s * 1e3:.1f} ms, eager "
          f"{eager_s * 1e3:.1f} ms, stopped {stopped_s * 1e3:.1f} ms) ({smi})", flush=True)  # fmt: skip
    return dict(events_per_s=rate, wall_ms=second_s * 1e3, eager_wall_ms=eager_s * 1e3, first_wall_ms=first_s * 1e3,
                launches_a=a1 + a2 + a3 + a4)  # fmt: skip


def small_generate_setup(na: bool):
    """A small fp32 model (one head of 32: kernel D's head widths) at a narrow
    log-time scale with a near-constant TTE head, and a 4 x 8 prompt."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompt_batch
    from eventstreamgpt_tpu_torch.training import build_model

    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3), hidden_size=32,
                            num_attention_heads=1, head_dim=32, intermediate_size=64, seq_window_size=4,
                            **(NA_OVERRIDES if na else {}))  # fmt: skip
    model = init_params_from_seed(build_model(config), seed=1, std=0.15)
    with torch.no_grad():
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    return config, model, synthetic_prompt_batch(np.random.default_rng(1), 4, config, 8)


def small_generate_checks() -> dict:
    """Small fp32 models: greedy on the card against the CPU (cached and
    uncached; events and integers exact, floats within phase 2's small-engine
    tolerance), sampled cached against uncached on the card (CI: indices
    exact, floats 1e-3 / 1e-4; NA: times within the JAX package's rtol 0.1,
    atol 1e-3, index agreement printed), and the uncached NA run's kernel D
    launches (a full forward a level an event, each layer once)."""
    import functools

    import torch

    import eventstreamgpt_tpu_torch.generation.generation_utils as gu
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_fwd

    out = {"launches_d": 0, "na_index_agreement": None}
    exact = ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask")
    for na in (False, True):
        name = "NA" if na else "CI"
        config, model, prompt = small_generate_setup(na)
        greedy, gu.sample_predictions = gu.sample_predictions, functools.partial(gu.sample_predictions, greedy=True)
        try:
            for cached in (True, False):
                runs = {dev: gu.generate(copy.deepcopy(model).to(dev), prompt, config, seed=3, use_cache=cached,
                                         max_new_events=GEN_SMALL_NEW, device=dev) for dev in ("cuda", "cpu")}  # fmt: skip
                a, b = runs["cuda"], runs["cpu"]
                for f in exact:
                    check(torch.equal(getattr(a, f).cpu(), getattr(b, f)), f"phase 13 [small {name}, cached={cached}]: "
                                                                          f"{f} differs card and CPU")  # fmt: skip
                for f in ("time_delta", "dynamic_values"):
                    torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f), rtol=1e-4, atol=1e-4)
        finally:
            gu.sample_predictions = greedy
        model = model.cuda()
        dep_graph_fwd.launches = 0
        uncached = gu.generate(model, prompt, config, seed=3, max_new_events=GEN_SMALL_NEW, use_cache=False)
        d = dep_graph_fwd.launches
        cached = gu.generate(model, prompt, config, seed=3, max_new_events=GEN_SMALL_NEW)
        if na:
            want = GEN_SMALL_NEW * len(config.measurements_per_dep_graph_level) * config.num_hidden_layers
            check(d == want, f"phase 13 [small NA]: kernel D launched {d} times uncached, not {want}")
            out["launches_d"] = d
            torch.testing.assert_close(cached.time_delta, uncached.time_delta, rtol=0.1, atol=1e-3)
            same = (cached.dynamic_indices == uncached.dynamic_indices).flatten(2).all(-1)[:, prompt.sequence_length:]
            n = prompt.sequence_length
            check(torch.equal(cached.dynamic_indices[:, n, 0], uncached.dynamic_indices[:, n, 0]),
                  "phase 13 [small NA]: the first new event's type differs cached and uncached")  # fmt: skip
            out["na_index_agreement"] = float(same.float().mean())
        else:
            check(d == 0, f"phase 13 [small CI]: kernel D launched {d} times")
            for f in exact:
                check(torch.equal(getattr(cached, f), getattr(uncached, f)), f"phase 13 [small CI]: {f} differs "
                                                                            "cached and uncached")  # fmt: skip
            for f in ("time_delta", "dynamic_values"):
                torch.testing.assert_close(getattr(cached, f), getattr(uncached, f), rtol=1e-3, atol=1e-4)
    print(f"phase 13: small fp32 CI and NA generate() on the card match the CPU (greedy, cached and uncached: events "
          f"and integers exact, floats within 1e-4); sampled cached vs uncached on the card: CI indices exact, floats "
          f"within 1e-3, NA times within rtol 0.1, the first new event's type exact and {out['na_index_agreement']:.3f} "
          f"of all new events' indices equal (measured, not checked: the cached walk embeds each graph element before "
          f"the event's later levels are written, the full forward the finished event, as in the JAX package); the "
          f"uncached NA run launched "
          f"kernel D {out['launches_d']} times", flush=True)  # fmt: skip
    return out


def generate_phase(smi, engine_rate) -> dict:
    """Phase 13: cohort ``generate()`` for phase 4's CI model and phase 6's NA model (module docstring)."""
    import numpy as np

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import (
        na_training_config,
        serving_config,
        synthetic_prompt_batch,
        training_config,
    )
    from eventstreamgpt_tpu_torch.training import build_model

    t0 = time.perf_counter()
    batch = training_batch()
    prompt = synthetic_prompt_batch(np.random.default_rng(SEED), GEN_ROWS, serving_config(), GEN_PROMPT)
    out = {"models": {}}
    for name, make_config, new in (("CI", training_config, GEN_NEW), ("NA", na_training_config, GEN_NEW_NA)):
        config = make_config([batch])
        check(config.precision == "bf16" and config.hidden_size == 256, f"phase 13: not phase {4 if name == 'CI' else 6}'s model")
        model = init_params_from_seed(build_model(config), seed=SEED).cuda()
        out[name] = generate_runs(smi, name, model, config, prompt, new)
        out["models"][name] = model
    t1 = time.perf_counter()
    out.update(small_generate_checks())
    print(f"phase 13: generated events/s (second call): CI {out['CI']['events_per_s']:.1f}, NA "
          f"{out['NA']['events_per_s']:.1f}; phase 2's sampled engine {engine_rate:.1f} (accounting pass); passed in "
          f"{time.perf_counter() - t0:.1f} s (full width {t1 - t0:.1f}) ({smi})", flush=True)  # fmt: skip
    return out


def generate_step_profiles(smi, gen) -> dict:
    """One profiled replay of each full-width prefix program and then of its
    decode-step program (after every capture of the run): device ms and kernels."""
    import torch

    from eventstreamgpt_tpu_torch.generation.generation_utils import _PROGRAMS
    from eventstreamgpt_tpu_torch.tools.profile_decode import _kernel_time_us

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for name, model in gen["models"].items():
        entry = next(g for g in _PROGRAMS.values() if g.model_ref() is model and g.step is not None)
        for part in ("prefix", "step"):  # the step from the state the prefix leaves
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                getattr(entry, part).replay()
                torch.cuda.synchronize()
            kernels = [(evt.count, _kernel_time_us(evt)) for evt in prof.key_averages()]
            kernels = [(c, us) for c, us in kernels if us > 0]
            out[f"{name} {part}"] = {"device_ms": sum(us for _, us in kernels) / 1e3,
                                     "kernels": sum(c for c, _ in kernels)}  # fmt: skip
            check(out[f"{name} {part}"]["kernels"] > 0, f"phase 13: no device kernel in the {name} {part} profile")
    print(f"phase 13: one profiled replay of each program at {GEN_ROWS} rows (sampled, bf16): {json.dumps(out)}; "
          f"generated events/s CI {gen['CI']['events_per_s']:.1f}, NA {gen['NA']['events_per_s']:.1f} ({smi})",
          flush=True)  # fmt: skip
    return out


# ---------------------------------------------------------------- phase 14
def na_engine_phase(smi) -> dict:
    """Phase 14: the NA engine at phase 2's settings (module docstring)."""
    import numpy as np

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import na_training_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream
    from eventstreamgpt_tpu_torch.tools.profile_decode import filled_engine
    from eventstreamgpt_tpu_torch.training import build_model

    t0 = time.perf_counter()
    config = na_training_config([training_batch()])
    check(config.precision == "bf16" and config.hidden_size == 256 and len(config.measurements_per_dep_graph_level) == 3,
          "phase 14: not phase 6's NA model")  # fmt: skip
    model = init_params_from_seed(build_model(config), seed=SEED)
    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, config, (128, 192), (16, 64))
    base_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)
    counters = {f"decode_stack_step.{c}": (decode_stack_step, c) for c in KERNEL_B_ENTRIES}
    counters.update(fused_categorical_stream=(fused_categorical_stream, "launches"),
                    fused_categorical=(fused_categorical, "launches"), dep_graph_fwd=(dep_graph_fwd, "launches"))  # fmt: skip
    out, launches_a, rates = {}, 0, {}
    for name, kv, mode in (("bf16", None, "greedy"), ("bf16", None, "sampled"), ("int8", "int8", "sampled")):
        label = f"phase 14 [NA {name} {mode}]"
        kw = dict(base_kw, greedy=mode == "greedy", kv_cache_dtype=kv)
        twin = (name, mode) == ("bf16", "sampled")  # one captured-vs-eager check for the path
        run = engine_run(model, config, prompts, counters, passes=PASSES if twin else ("warm", "accounting"), **kw)
        eager = engine_run(model, config, prompts, counters, passes=("warm",), cuda_graph=False, **kw) if twin else None
        check_results(run["results"], run["requests"], label)
        check(run["stats"]["decode_step_impl"] == "unfused", f"{label}: not the unfused step: {run['stats']}")
        for pname, p in list(run["passes"].items()) + ([("eager", eager)] if twin else []):
            kernels_bd = {k: v for k, v in p["launches"].items() if k.startswith("decode_stack_step") or k == "dep_graph_fwd"}
            check(not any(kernels_bd.values()), f"{label} [{pname}]: kernel B or D launched: {kernels_bd}")
            a = p["launches"]["fused_categorical_stream"]
            check(a > 0 if mode == "sampled" else a == 0, f"{label} [{pname}]: kernel A launched {a} times ({mode})")
            check(p["launches"]["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
        check_graph_counts(run, label, None)
        check_passes(run, label)
        per_call = None
        if twin:
            same_results(run["results"], eager["results"], label)
            # Kernel A through the replays: the pass after reset() (no warm-up)
            # launches it as often as the eager engine's one pass, and the warm
            # pass that count plus the warm-up chunk's and each prefill key's.
            s, e = run["passes"]["warm"]["stats"], eager["stats"]
            a_eager = eager["launches"]["fused_categorical_stream"]
            calls = e["prefill_dispatches"] + e["dispatched_chunks"] * e["decode_chunk"]
            check(a_eager % calls == 0, f"{label}: kernel A launched {a_eager} times eager for {calls} calls")
            per_call = a_eager // calls
            want = per_call * (s["prefill_dispatches"] + s["prefill_graph_warmups"]
                               + (s["dispatched_chunks"] + s["graph_warmup_chunks"]) * s["decode_chunk"])  # fmt: skip
            got = (run["passes"]["fetching"]["launches"]["fused_categorical_stream"],
                   run["passes"]["warm"]["launches"]["fused_categorical_stream"])  # fmt: skip
            check(got == (a_eager, want), f"{label}: kernel A launched {got} times (after reset(), warm), "
                                          f"{(a_eager, want)} expected")  # fmt: skip
        launches_a += run["launches"]["fused_categorical_stream"]
        acct = run["passes"]["accounting"]
        generated = sum(r.n_generated for r in run["results"])
        rates[f"{name} {mode}"] = dict(events_per_s=generated / acct["wall_s"], wall_s=acct["wall_s"],
                                       chunks=acct["stats"]["dispatched_chunks"],
                                       wasted_decode_frac=acct["stats"]["wasted_decode_frac"])  # fmt: skip
        out[(name, mode)] = run
        equal = "captured and eager and in each pass after reset()" if twin else "in the accounting pass"
        print(f"{label} {len(run['results'])} requests, {generated} generated events, every event, integer and float "
              f"equal {equal}; accounting pass {json.dumps(rates[f'{name} {mode}'])}; {programs_line(run)}; launches "
              f"over {len(run['passes'])} passes {run['launches']}, kernel A {per_call} a prefill group or step; eager "
              f"warm pass {eager['wall_s'] if twin else float('nan'):.3f} s, captured warm pass "
              f"{run['passes']['warm']['wall_s']:.3f} s ({smi})", flush=True)  # fmt: skip
    report = out[("bf16", "sampled")]["engine"].slots_report()
    print(f"phase 14: slots_report() of the NA engine at the card's memory (bf16 cache, the dep-graph caches in the "
          f"row): {json.dumps({k: report[k] for k in ('params_bytes', 'row_bytes_per_slot', 'per_dtype')})} ({smi})",
          flush=True)  # fmt: skip
    t1 = time.perf_counter()
    small_engine_matches_cpu(phase="phase 14", na=True)
    # The profiled engine is built (its programs captured) now; it is profiled after every capture of the run.
    profiled = filled_engine(model, config, prompts, **base_kw, greedy=False, dispatch_depth=1)
    t2 = time.perf_counter()
    print(f"phase 14: passed in {t2 - t0:.1f} s (full width {t1 - t0:.1f}; its profile comes last)", flush=True)
    return dict(launches_a=launches_a, rates=rates, profile=lambda: na_engine_profile(smi, profiled), model=model,
                config=config, prompts=prompts, greedy_results=out[("bf16", "greedy")]["results"])


def na_engine_profile(smi, engine) -> dict:
    """One profiled 16-step chunk of the sampled bf16 NA engine on 32 admitted
    slots (`tools.profile_decode.profiled_engine_chunk`): device ms and
    kernels a step."""
    from eventstreamgpt_tpu_torch.tools.profile_decode import profiled_engine_chunk

    summary = profiled_engine_chunk(engine)
    out = {k: summary[k] for k in ("step_wall_ms", "active_slots", "device_busy_ms_per_step", "device_kernels_per_step",
                                   "host_launches_per_step", "device_idle_share_unprofiled") if k in summary}  # fmt: skip
    check(summary["device_kernels_per_step"] > 0, "phase 14: no device kernel in the NA engine's profile")
    return out


# ---------------------------------------------------------------- phase 15
NA_SPEC_REQUESTS = 32  # the first 32 of phase 14's requests: one wave of the 32 slots


def na_spec_runs(smi, model, config, prompts, counters, base_kw, spec) -> tuple:
    """The NA spec engine on phase 14's requests: bf16 sampled at the default
    tolerances, int8 sampled and bf16 greedy at zero tolerances, each in phase
    2's three passes, captured. The bf16 sampled run's capture seconds and
    peak memory (above what was allocated before the engine was built) are
    kept. Captured against eager is the small NA spec engine's check
    (`small_engine_matches_cpu`) and the ``na_spec`` CUDA tests'."""
    import torch

    def measured(**kw):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = engine_run(model, config, prompts, counters, **kw)
        torch.cuda.synchronize()
        return run, (torch.cuda.max_memory_allocated() - before) / 1e9

    out, launches_a = {}, 0
    for name, kv, mode in (("bf16", None, "sampled"), ("int8", "int8", "sampled"), ("bf16", None, "greedy")):
        label = f"phase 15 [NA spec {name} {mode}]"
        kw = dict(base_kw, greedy=mode == "greedy", kv_cache_dtype=kv,
                  spec=spec(**(SPEC_STRICT if mode == "greedy" else {})))  # fmt: skip
        passes = PASSES if (name, mode) == ("bf16", "sampled") else ("warm", "accounting")
        run, peak = measured(passes=passes, **kw)
        stats = run["stats"]
        check_results(run["results"], run["requests"], label)
        check(stats["decode_step_impl"] == "spec_draft_verify", f"{label}: not the spec engine: {stats}")
        check(run["engine"].draft_dep_key is not None, f"{label}: not an NA spec engine")
        for pname, p in run["passes"].items():
            kernels_bd = {k: v for k, v in p["launches"].items() if k.startswith("decode_stack_step") or k == "dep_graph_fwd"}
            check(not any(kernels_bd.values()), f"{label} [{pname}]: kernel B or D launched: {kernels_bd}")
            a = p["launches"]["fused_categorical_stream"]
            check(a > 0 if mode == "sampled" else a == 0, f"{label} [{pname}]: kernel A launched {a} times ({mode})")
            check(p["launches"]["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
            ps = p["stats"]
            check(ps["spec_rounds"] == ps["dispatched_chunks"] * ps["decode_chunk"] > 0,
                  f"{label} [{pname} pass]: {ps['spec_rounds']} rounds for {ps['dispatched_chunks']} chunks")  # fmt: skip
        check_graph_counts(run, label, None)
        check_passes(run, label)
        spec_counts = [(r.spec_proposed, r.spec_accepted) for r in run["results"]]
        for pname in passes[1:]:
            check([(r.spec_proposed, r.spec_accepted) for r in run["passes"][pname]["results"]] == spec_counts,
                  f"{label} [{pname} pass]: per-request proposals or acceptances differ from the warm pass")  # fmt: skip
        extra = {}
        if (name, mode) == ("bf16", "sampled"):
            extra = dict(capture_s=run["engine"]._program.capture_s, peak_gb_captured=peak)
        launches_a += run["launches"]["fused_categorical_stream"]
        acct = run["passes"]["accounting"]
        s = acct["stats"]
        generated = sum(r.n_generated for r in run["results"])
        rates = dict(events_per_s=generated / acct["wall_s"], wall_s=acct["wall_s"], chunks=s["dispatched_chunks"],
                     rounds=s["spec_rounds"], acceptance_rate=s["spec_acceptance_rate"],
                     committed_per_active_slot_round=s["spec_committed_events"] / max(s["active_slot_steps"], 1),
                     **extra)  # fmt: skip
        out[(name, mode)] = dict(run, rates=rates, generated=generated)
        print(f"{label} {len(run['results'])} requests, {generated} generated events, "
              f"{'every event, integer and float equal in the pass after reset()' if 'fetching' in passes else 'the same accounting after reset()'}; "
              f"accounting pass {json.dumps(rates)}; {programs_line(run)}; launches over {len(passes)} passes "
              f"{run['launches']}; warm pass {run['passes']['warm']['wall_s']:.3f} s ({smi})", flush=True)  # fmt: skip
    return out, launches_a


def na_spec_phase(smi, na_engine) -> dict:
    """Phase 15: speculative decoding on the NA engine (module docstring)."""
    import torch

    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream
    from eventstreamgpt_tpu_torch.serving import SpecConfig, truncated_draft

    t0 = time.perf_counter()
    model, config, prompts = (na_engine[k] for k in ("model", "config", "prompts"))
    prompts = prompts[:NA_SPEC_REQUESTS]
    base_kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)
    counters = {f"decode_stack_step.{c}": (decode_stack_step, c) for c in KERNEL_B_ENTRIES}
    counters.update(fused_categorical_stream=(fused_categorical_stream, "launches"),
                    fused_categorical=(fused_categorical, "launches"), dep_graph_fwd=(dep_graph_fwd, "launches"))  # fmt: skip
    dcfg, draft = truncated_draft(config, model, config.num_hidden_layers // 2)

    def spec(**tol):
        return SpecConfig(model=draft, config=dcfg, k=SPEC_K, **tol)

    runs, launches_a = na_spec_runs(smi, model, config, prompts, counters, base_kw, spec)
    t1 = time.perf_counter()
    # A perfect draft (the target itself, tolerant greedy) in fp32, the same weights.
    config32 = copy.deepcopy(config)
    config32.precision = "fp32"
    model32 = type(model)(config32)
    model32.load_state_dict(model.state_dict())
    run = engine_run(model32, config32, prompts, counters, passes=("warm",), greedy=True,
                     **dict(base_kw, spec=SpecConfig(model=model32, config=config32, k=SPEC_K)))  # fmt: skip
    check_results(run["results"], run["requests"], "phase 15 [perfect NA draft, fp32]")
    st = run["stats"]
    perfect = dict(acceptance_rate=st["spec_acceptance_rate"],
                   committed_per_active_slot_round=st["spec_committed_events"] / max(st["active_slot_steps"], 1))
    check(config32.compute_dtype == torch.float32 and perfect["acceptance_rate"] > 0.9,
          f"phase 15 [perfect NA draft, fp32]: acceptance {perfect}")  # fmt: skip
    # Measured, not checked: the strict greedy spec engine's events against phase 14's greedy NA engine's.
    strict = runs[("bf16", "greedy")]["results"]
    equal = sum(same_generated_events(a, b) == a.n_generated == b.n_generated
                for a, b in zip(strict, na_engine["greedy_results"]))  # fmt: skip
    report = runs[("bf16", "sampled")]["engine"].slots_report()
    print(f"phase 15: perfect NA draft (the target, tolerant greedy, fp32): {json.dumps(perfect)}; measured, not "
          f"checked: {equal} of {len(strict)} strict greedy NA spec requests equal phase 14's greedy NA engine's in "
          f"every generated event; slots_report() with the draft at the card's memory: "
          f"{json.dumps({k: report[k] for k in ('spec', 'params_bytes', 'draft_params_bytes', 'draft_kv_bytes_per_slot', 'row_bytes_per_slot', 'per_dtype')})} "
          f"({smi})", flush=True)  # fmt: skip
    small_engine_matches_cpu(spec_k=SPEC_K, phase="phase 15", na=True)
    t2 = time.perf_counter()
    print(f"phase 15: passed in {t2 - t0:.1f} s (spec runs {t1 - t0:.1f}, perfect draft and small engine "
          f"{t2 - t1:.1f})", flush=True)  # fmt: skip
    rates = {f"{k[0]} {k[1]}": v["rates"] for k, v in runs.items()}
    return dict(launches_a=launches_a, rates=rates, perfect=perfect, greedy_equal=equal)


# ---------------------------------------------------------------- phase 16
SERVICE_LANES = ("interactive", "batch")


def capture_seconds(engine) -> float:
    """Seconds an engine spent capturing its programs (the decode chunk's and every keyed program's)."""
    programs = [engine._program] + [p for f in engine._families.values() for p in f.programs.values()]
    return sum(p.capture_s for p in programs if p is not None)


def device_timed(fn):
    """``(result, host wall s, device ms)`` of one call of ``fn``, the device time by CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def service_pass(replicas, pf, prompts, counters, label) -> dict:
    """One run of `ServingService` over ``replicas`` (a new service, and a new
    `PrefillStream` over ``pf`` unless None), the launch counters zeroed just
    before and read just after; the results checked finished and finite."""
    import torch

    from eventstreamgpt_tpu_torch.serving import PrefillStream, Request, ServingService, latency_quantiles

    svc = ServingService(replicas, prefill_stream=None if pf is None else PrefillStream(pf), seed=SEED)
    reqs = [(Request(prompt=p, max_new_events=b, request_id=i), SERVICE_LANES[i % 2]) for i, (p, b) in enumerate(prompts)]
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = svc.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    check_results(results, [r for r, _ in reqs], label)
    generated = sum(r.n_generated for r in results)
    return dict(results=results, wall_s=wall, launches=launches, stats=svc.stats(), generated=generated,
                rate=generated / wall, latency=latency_quantiles(results))  # fmt: skip


def check_service_programs(replicas, pf, passes, label) -> None:
    """The decode engines ran no prefill program, one admission replay a
    handoff; the prefill engine one ``prefill_compute`` replay a dispatched
    group; kernel B once a decode step of each replica in each pass."""
    for i, e in enumerate(replicas):
        s = e.stats()
        check(s["prefill_graph_keys"] == s["prefill_dispatches"] == 0, f"{label}: decode replica {i} prefilled: {s}")
        check(s["admit_graph_replays"] == s["handoffs_admitted"] > 0,
              f"{label}: decode replica {i}: {s['admit_graph_replays']} admission replays for {s['handoffs_admitted']} "
              "handoffs")  # fmt: skip
    p = pf.stats()
    groups = sum(run["stats"]["prefill_stream"]["dispatches"] for run in passes)
    check(p["prefill_compute_graph_replays"] == p["prefill_computes"] == groups > 0,
          f"{label}: {p['prefill_compute_graph_replays']} prefill_compute replays, {p['prefill_computes']} computes, "
          f"{groups} dispatched groups")  # fmt: skip
    for n, run in enumerate(passes):
        steps = sum(r["dispatched_chunks"] for r in run["stats"]["replicas"]) * replicas[0].decode_chunk
        got = run["launches"]["decode_stack_step"]
        check(got == steps, f"{label} [pass {n + 1}]: kernel B launched {got} times for {steps} decode steps")
        check(run["launches"]["fused_categorical_stream"] > 0, f"{label} [pass {n + 1}]: kernel A never launched")


def same_events(a_results, b_results, label) -> None:
    """Two runs' events and integers equal (floats not compared)."""
    import torch

    check(len(a_results) == len(b_results), f"{label}: {len(a_results)} results against {len(b_results)}")
    for a, b in zip(a_results, b_results):
        check((a.request_id, a.n_events, a.n_generated) == (b.request_id, b.n_events, b.n_generated),
              f"{label}: request {a.request_id} differs in its accounting")  # fmt: skip
        for f in ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask"):
            check(torch.equal(getattr(a.batch, f), getattr(b.batch, f)), f"{label}: request {a.request_id}'s {f}")


def weights_of(engine) -> list:
    return list(engine._model.parameters()) + list(engine._stacked.values())


def hot_swap_runs(smi, m1, m2, config, prompts, counters, kw) -> dict:
    """Phase 16 (b): hot swap under traffic on a 32-slot engine (module docstring)."""
    import torch

    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request

    def reqs(lo, hi):
        return [Request(prompt=p, max_new_events=b, request_id=i, key=derive_request_seed(SEED, i))
                for i, (p, b) in enumerate(prompts) if lo <= i < hi]  # fmt: skip

    def fresh(model):
        return GenerationEngine(model, config, template=prompts[0][0], n_slots=32, **kw).run(reqs(32, 64))

    eng = GenerationEngine(m1, config, template=prompts[0][0], n_slots=32, hot_swap=True, **kw)
    eng.run(reqs(32, 64))  # the second half's program keys, captured before any flip
    for r in reqs(0, 32):
        eng.submit(r)
    eng.plan_and_dispatch()
    eng.issue_chunk()
    eng.issue_chunk()  # decoding while the shadow is staged and probed
    times = {}
    _, times["load_shadow_s"], times["load_shadow_device_ms"] = device_timed(lambda: eng.load_shadow(m2.state_dict()))
    reason, times["probe_s"], times["probe_device_ms"] = device_timed(eng.probe_shadow)
    check(reason is None, f"phase 16 [hot swap]: the probe refused checkpoint 2: {reason}")
    check(eng.occupied > 0, "phase 16 [hot swap]: the shadow was not staged under traffic")
    first = eng.run()
    check(len(first) == 32 and all(r.error is None for r in first), "phase 16 [hot swap]: the first 32 failed")
    captures = eng.program_stats()
    ptrs = [t.data_ptr() for t in weights_of(eng)]
    _, times["flip_s"], times["flip_device_ms"] = device_timed(eng.flip)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    flipped = eng.run(reqs(32, 64))
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    steps = (eng.stats()["dispatched_chunks"] - captures["graph_replays"]) * eng.decode_chunk
    check(launches["decode_stack_step"] == steps > 0,
          f"phase 16 [hot swap]: kernel B launched {launches['decode_stack_step']} times after the flip, {steps} steps")  # fmt: skip
    check_results(flipped, reqs(32, 64), "phase 16 [hot swap, flipped]")
    same_results(fresh(m2), flipped, "phase 16 [hot swap]", "flipped vs a fresh engine on checkpoint 2")
    _, times["rollback_s"], times["rollback_device_ms"] = device_timed(eng.flip)
    rolled = eng.run(reqs(32, 64))
    same_results(fresh(m1), rolled, "phase 16 [hot swap]", "rolled back vs a fresh engine on checkpoint 1")
    after = eng.program_stats()
    for k in ("graph_captures", "prefill_graph_captures", "prefill_graph_keys", "extract_graph_captures"):
        check(after[k] == captures[k], f"phase 16 [hot swap]: {k} {captures[k]} before the flips, {after[k]} after")
    check([t.data_ptr() for t in weights_of(eng)] == ptrs, "phase 16 [hot swap]: a flip moved a weight")
    live = [t.clone() for t in weights_of(eng)]
    bad = {k: v.clone() for k, v in m2.state_dict().items()}
    bad["encoder.h0.attn.attention.q_proj.weight"][0, 0] = float("nan")
    eng.load_shadow(bad)
    reason = eng.probe_shadow()
    check(reason is not None and "non-finite" in reason, f"phase 16 [hot swap]: the NaN shadow passed the probe: {reason}")
    check(all(torch.equal(a, b) for a, b in zip(live, weights_of(eng))), "phase 16 [hot swap]: the probe touched live weights")
    eng.drop_shadow()
    plain = GenerationEngine(m1, config, template=prompts[0][0], n_slots=32, **kw).slots_report()
    report = eng.slots_report()
    check(report["params_bytes"] == 2 * plain["params_bytes"] and report["swap_scratch_bytes"] > 0,
          f"phase 16 [hot swap]: slots_report {report['params_bytes']} params bytes against {plain['params_bytes']}")  # fmt: skip
    print(f"phase 16 [hot swap]: the 32 requests after the flip equal a fresh engine on checkpoint 2 bit for bit, after "
          f"the rollback one on checkpoint 1; no capture at or after either flip ({after['prefill_graph_captures']} "
          f"prefill captures), every weight at its address; the NaN shadow refused ({reason}); times "
          f"{json.dumps({k: round(v, 4) for k, v in times.items()})}; kernel B {launches['decode_stack_step']} "
          f"launches after the flip; params bytes {plain['params_bytes']} -> {report['params_bytes']} with hot swap, "
          f"scratch {report['swap_scratch_bytes']} ({smi})", flush=True)  # fmt: skip
    return dict(launches=launches, times=times, capture_s=capture_seconds(eng))


def small_service_matches_cpu() -> None:
    """Phase 16 (c): a small fp32 greedy service (two replicas and a prefill
    stream) on the card against the same service on the CPU."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, PrefillStream, Request, ServingService
    from eventstreamgpt_tpu_torch.training import build_model

    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3), hidden_size=32,
                            head_dim=8, intermediate_size=64, seq_window_size=4)  # fmt: skip
    model = init_params_from_seed(build_model(config), seed=1, std=0.15)
    with torch.no_grad():
        model.output_layer.TTE_layer.proj.weight.mul_(0.02)
    prompts = synthetic_prompts(np.random.default_rng(1), 8, config, (6, 12), (4, 8))
    kw = dict(n_slots=4, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True)
    res = {}
    for dev in ("cuda", "cpu"):
        engines = [GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw) for _ in range(3)]
        svc = ServingService(engines[:2], prefill_stream=PrefillStream(engines[2]))
        res[dev] = svc.run([(Request(prompt=p, max_new_events=b, request_id=i), SERVICE_LANES[i % 2])
                            for i, (p, b) in enumerate(prompts)])  # fmt: skip
    diff = 0.0
    same_events(res["cuda"], res["cpu"], "phase 16 [small service, card vs CPU]")
    for g, c in zip(res["cuda"], res["cpu"]):
        check(g.replica == c.replica, f"phase 16 [small service]: request {g.request_id} on another replica")
        for f in ("time_delta", "dynamic_values"):
            a, b = getattr(g.batch, f), getattr(c.batch, f)
            diff = max(diff, (a - b).abs().max().item())
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    print(f"phase 16: small fp32 greedy service (two replicas and a prefill stream) on the card matches the CPU "
          f"service: events and integers exact, floats within 1e-4 (max |diff| {diff:.3g})", flush=True)  # fmt: skip


def service_phase(smi, model, config) -> dict:
    """Phase 16: checkpoints, the service with its prefill stream, and hot swap (module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical_stream
    from eventstreamgpt_tpu_torch.serving import GenerationEngine
    from eventstreamgpt_tpu_torch.training import load_pretrained, save_pretrained

    t0 = time.perf_counter()
    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, serving_config(), (128, 192), (16, 64))
    with tempfile.TemporaryDirectory() as tmp:
        save_pretrained(f"{tmp}/checkpoint-1", model, config)
        save_pretrained(f"{tmp}/checkpoint-2", init_params_from_seed(CIPPTForGenerativeSequenceModeling(config),
                                                                     seed=SEED + 1), config)  # fmt: skip
        m1, c1 = load_pretrained(f"{tmp}/checkpoint-1")
        m2, _ = load_pretrained(f"{tmp}/checkpoint-2")
    want = model.state_dict()
    check(c1.to_dict() == config.to_dict() and list(m1.state_dict()) == list(want)
          and all(torch.equal(v.cpu(), want[k].cpu()) for k, v in m1.state_dict().items()),
          "phase 16: checkpoint 1 read back is not phase 2's model bit for bit")  # fmt: skip
    counters = {"decode_stack_step": (decode_stack_step, "launches"),
                "fused_categorical_stream": (fused_categorical_stream, "launches")}  # fmt: skip
    kw = dict(max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)

    def engines(n, greedy=False):
        return [GenerationEngine(m1, config, template=prompts[0][0], n_slots=16, greedy=greedy, **kw)
                for _ in range(n)]  # fmt: skip

    # (a) two decode replicas and a prefill stream, run twice (the second after reset()).
    *replicas, pf = engines(3)
    passes = [service_pass(replicas, pf, prompts, counters, "phase 16 [service, stream]")]
    for e in replicas + [pf]:
        e.reset()
    passes.append(service_pass(replicas, pf, prompts, counters, "phase 16 [service, stream, after reset()]"))
    same_results(passes[0]["results"], passes[1]["results"], "phase 16 [service]", "second run vs first")
    check_service_programs(replicas, pf, passes, "phase 16 [service]")
    capture_s = sum(capture_seconds(e) for e in replicas + [pf])
    t1 = time.perf_counter()
    # Greedy, the same service with and without the stream: the same events and integers.
    *g_replicas, g_pf = engines(3, greedy=True)
    g_stream = service_pass(g_replicas, g_pf, prompts, counters, "phase 16 [greedy service, stream]")
    g_local = service_pass(engines(2, greedy=True), None, prompts, counters, "phase 16 [greedy service, local]")
    same_events(g_stream["results"], g_local["results"], "phase 16 [greedy service, stream vs local prefill]")
    t2 = time.perf_counter()
    # Measured, not checked: the sampled service without the stream (warmed), then two more timed runs each,
    # alternating with the stream (every engine reset before a run), and one 32-slot engine (its second run).
    local = engines(2)
    service_pass(local, None, prompts, counters, "phase 16 [service, local]")
    timed = {"stream": [passes[1]], "local": []}
    for _ in range(2):
        for name, (reps, prefill) in (("local", (local, None)), ("stream", (replicas, pf))):
            for e in reps + ([prefill] if prefill is not None else []):
                e.reset()
            timed[name].append(service_pass(reps, prefill, prompts, counters, f"phase 16 [service, {name}, timed]"))
    no_stream = timed["local"][-1]
    single = engine_run(m1, config, prompts, counters, passes=("warm", "fetching"), n_slots=32, **kw)
    single_rate = sum(r.n_generated for r in single["passes"]["fetching"]["results"]) / single["passes"]["fetching"]["wall_s"]
    t3 = time.perf_counter()
    swap = hot_swap_runs(smi, m1, m2, config, prompts, counters, kw)
    t4 = time.perf_counter()
    small_service_matches_cpu()
    run = timed["stream"][-1]
    rates = {k: [round(r["rate"], 1) for r in v] for k, v in timed.items()}
    stats = {k: v for k, v in run["stats"].items() if k != "replicas"}
    stats["replicas"] = [{k: r[k] for k in ("dispatched_chunks", "wasted_decode_frac", "handoffs_admitted",
                                             "admit_graph_keys", "admit_graph_replays", "prefill_dispatches")}
                         for r in run["stats"]["replicas"]]  # fmt: skip
    p = pf.stats()
    stream_engine = {k: p[k] for k in ("prefill_computes", "prefill_compute_graph_keys", "prefill_compute_graph_replays")}
    print(f"phase 16 [service]: 64 requests through two 16-slot replicas and a prefill stream, {run['generated']} "
          f"generated events; the run after reset() equals the first bit for bit; {run['rate']:.1f} events/s "
          f"({run['wall_s']:.4f} s; first run {passes[0]['rate']:.1f}); latency {json.dumps(run['latency'])}; "
          f"without the stream {no_stream['rate']:.1f} events/s (latency {json.dumps(no_stream['latency'])}); timed "
          f"runs after reset() in turns, events/s {json.dumps(rates)}; one "
          f"32-slot engine {single_rate:.1f} events/s; greedy with and without the stream: the same events and "
          f"integers ({g_stream['rate']:.1f} / {g_local['rate']:.1f} events/s); launches {run['launches']}; capture "
          f"{capture_s:.2f} s over the three engines, hot-swap engine {swap['capture_s']:.2f} s ({smi})", flush=True)  # fmt: skip
    print(f"phase 16 [service]: stats() {json.dumps(stats)}; the prefill engine {json.dumps(stream_engine)}", flush=True)
    t5 = time.perf_counter()
    print(f"phase 16: passed in {t5 - t0:.1f} s (service with the stream {t1 - t0:.1f}, greedy pair {t2 - t1:.1f}, "
          f"without the stream and one engine {t3 - t2:.1f}, hot swap {t4 - t3:.1f}, small service {t5 - t4:.1f})",
          flush=True)  # fmt: skip
    launches = {k: sum(r["launches"][k] for r in passes) + swap["launches"][k] for k in counters}
    return dict(launches_a=launches["fused_categorical_stream"], launches_b=launches["decode_stack_step"], m1=m1, m2=m2)


# ---------------------------------------------------------------- phase 17
FLEET_SUBJECTS, ARRIVALS_PER_S = 32, 40.0  # two requests a subject; Poisson arrivals at 40 requests/s


def fleet_items(prompts, lo=0, hi=None, arrivals=None) -> list:
    """Phase 2's requests ``lo <= i < hi`` as fleet items: subject
    ``subject-{i % 32:03d}`` (two requests a subject), lanes alternating, at
    ``arrivals[i]`` seconds (default 0)."""
    from eventstreamgpt_tpu_torch.serving import Request

    hi = len(prompts) if hi is None else hi
    return [(f"subject-{i % FLEET_SUBJECTS:03d}", Request(prompt=p, max_new_events=b, request_id=i,
             arrival_time=0.0 if arrivals is None else float(arrivals[i])), SERVICE_LANES[i % 2])
            for i, (p, b) in enumerate(prompts) if lo <= i < hi]  # fmt: skip


def new_fleet(engines, **kw):
    """``svc0``: ``engines[0:2]`` behind a `PrefillStream` over ``engines[2]``;
    ``svc1``: ``engines[3:5]`` with local prefill; every engine ``reset()``."""
    from eventstreamgpt_tpu_torch.serving import PrefillStream, ServingFleet, ServingService

    for e in engines:
        e.reset()
    return ServingFleet({"svc0": ServingService(engines[:2], prefill_stream=PrefillStream(engines[2])),
                         "svc1": ServingService(engines[3:5])}, seed=SEED, **kw)  # fmt: skip


def timed_rounds(fleet) -> list:
    """Wraps each service's ``step`` to append its wall seconds (the round
    the fleet's watchdog reads) to the returned list."""
    walls = []
    for svc in fleet.services.values():
        def step(*args, _step=svc.step, **kw):
            t0 = time.perf_counter()
            out = _step(*args, **kw)
            walls.append(time.perf_counter() - t0)
            return out

        svc.step = step
    return walls


def fleet_pass(fleet, items, counters, label, ok=True, **run_kw) -> dict:
    """One `ServingFleet.run`, the launch counters zeroed just before and read
    just after; with ``ok`` every request checked finished and finite."""
    import torch

    from eventstreamgpt_tpu_torch.serving import latency_quantiles

    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = fleet.run(items, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    if ok:
        check_results(results, items, label)
    generated = sum(r.n_generated for r in results)
    return dict(results=results, wall_s=wall, launches=launches, stats=fleet.stats(), generated=generated,
                rate=generated / wall, latency=latency_quantiles(results))  # fmt: skip


def check_fleet_kernels(run, label, sampled=True) -> None:
    """Kernel B once a decode step of each replica, through the replays; kernel A launched when sampled."""
    steps = sum(r["dispatched_chunks"] * r["decode_chunk"] for s in run["stats"]["services"].values()
                for r in s["replicas"])  # fmt: skip
    check(run["launches"]["decode_stack_step"] == steps > 0,
          f"{label}: kernel B launched {run['launches']['decode_stack_step']} times for {steps} decode steps")  # fmt: skip
    check(not sampled or run["launches"]["fused_categorical_stream"] > 0, f"{label}: kernel A never launched")


def fleet_captures(engines) -> int:
    from eventstreamgpt_tpu_torch.serving.fleet import _captures

    return _captures(engines)


def same_weights(engines, want, label) -> None:
    """Each engine's weights (the model's and kernel B's stacked copy) equal ``want[i]`` in contents and address."""
    import torch

    for i, e in enumerate(engines):
        ws = weights_of(e)
        check([t.data_ptr() for t in ws] == [p for p, _ in want[i]], f"{label}: engine {i} moved a weight")
        check(all(torch.equal(t, c) for t, (_, c) in zip(ws, want[i])), f"{label}: engine {i}'s weights changed")


def snapshot(engines) -> list:
    return [[(t.data_ptr(), t.clone()) for t in weights_of(e)] for e in engines]


def as_undisturbed(run, clean, label) -> dict:
    """Every request of a run a fault disturbed equals the undisturbed run's
    bit for bit, those replayed onto a survivor (re-prefilled in other
    groups, decoded in other slots) included."""
    same_results(clean, run["results"], label, "vs the undisturbed run")
    return dict(replayed=sum(r.replays > 0 for r in run["results"]))


def fleet_faults(smi, g, single, prompts, counters, greedy) -> dict:
    """Phase 17 (b), (d), (e) on the greedy engines ``g`` (``single``: the
    32-slot engine with one health retry): eviction, rollbacks and health
    (module docstring)."""
    from eventstreamgpt_tpu_torch.reliability import ServingFault, ServingFaultPlan, serving_fault_plan
    from eventstreamgpt_tpu_torch.serving import FleetHealthConfig, PromotionError, SlotHealthError

    items, out, clean = fleet_items(prompts), {}, greedy["results"]
    # (b) a death of svc1 at its third chunk: evicted, its sessions replayed on svc0.
    fleet = new_fleet(g, health=FleetHealthConfig())
    evict, evict_s = fleet.evict_service, []
    fleet.evict_service = lambda *a, **k: (evict_s.append(time.perf_counter()), evict(*a, **k),
                                           evict_s.append(time.perf_counter()))[1]  # fmt: skip
    with serving_fault_plan(ServingFaultPlan([ServingFault("death", service="svc1", chunk_index=2)])):
        dead = fleet_pass(fleet, items, counters, "phase 17 [death]")
    st = fleet.stats()
    check([e["service"] for e in st["evictions"]] == ["svc1"] and st["sessions_replayed_total"] > 0,
          f"phase 17 [death]: evictions {st['evictions']}")  # fmt: skip
    check(st["swap"]["swap_dropped_requests"] == 0, "phase 17 [death]: a request was dropped")
    check(all(r.service == "svc0" for r in dead["results"]), "phase 17 [death]: a result outside the survivor")
    out["eviction"] = dict(as_undisturbed(dead, clean, "phase 17 [death]"), evict_ms=1e3 * (evict_s[1] - evict_s[0]),
                           wall_s=dead["wall_s"], undisturbed_wall_s=greedy["wall_s"])  # fmt: skip
    # (e) a nan_slot in slot 0 of svc0's first replica at its chunk 2 (the second replica answers to its own scope).
    fleet = new_fleet(g, health=FleetHealthConfig())
    g[1].fault_scope = "svc0/replica1"
    with serving_fault_plan(ServingFaultPlan([ServingFault("nan_slot", service="svc0", slot=0, chunk_index=2)])) as plan:
        nan = fleet_pass(fleet, items, counters, "phase 17 [nan_slot]", ok=False)
    g[1].fault_scope = "svc0"
    bad = [r for r in nan["results"] if r.error is not None]
    check(len(plan.fired) == 1 and len(bad) == 1 and isinstance(bad[0].error, SlotHealthError)
          and (bad[0].service, bad[0].replica) == ("svc0", 0), f"phase 17 [nan_slot]: failed {[(r.request_id, r.error) for r in bad]}")  # fmt: skip
    healthy = [r for r in nan["results"] if r.error is None]
    check_results(healthy, healthy, "phase 17 [nan_slot, co-residents]")
    same_results([r for r in clean if r.request_id != bad[0].request_id], healthy, "phase 17 [nan_slot]",
                 "co-residents vs the clean run")  # fmt: skip
    # (e) the same fault on the 32-slot engine with one health retry: the retry from the bound seed equals the
    # fleet's clean run.
    single.reset()
    single.fault_scope = "svc0"
    retried = single.stats()["health_retried_total"]
    with serving_fault_plan(ServingFaultPlan([ServingFault("nan_slot", service="svc0", slot=0, chunk_index=2)])) as plan:
        retry = single.run([r for _, r, _ in items])
    check(len(plan.fired) == 1 and single.stats()["health_retried_total"] - retried == 1,
          f"phase 17 [retry]: {len(plan.fired)} faults fired, {single.stats()['health_retried_total'] - retried} retries")  # fmt: skip
    same_results(clean, retry, "phase 17 [retry]", "a retry on one 32-slot engine vs the fleet's clean run")
    # (e) a hang of 0.5 s under a 0.25 s watchdog: svc1 evicted as hung, every request served.
    fleet = new_fleet(g, health=FleetHealthConfig(boundary_timeout_s=0.25))
    with serving_fault_plan(ServingFaultPlan([ServingFault("hang", service="svc1", chunk_index=3, seconds=0.5)])) as plan:
        hung = fleet_pass(fleet, items, counters, "phase 17 [hang]")
    st = fleet.stats()
    check(plan.fired and [(f["service"], f["kind"]) for f in st["replica_faults"]] == [("svc1", "hung")]
          and st["evictions"][0]["reason"].startswith("hung: scheduling round took"), f"phase 17 [hang]: {st['replica_faults']}")  # fmt: skip
    out["hang"] = as_undisturbed(hung, clean, "phase 17 [hang]")
    # (d) rollbacks: a corrupt staged checkpoint refused before any flip; a flip failure flipped back.
    m2_state = greedy["m2"].state_dict()
    before = snapshot(g)
    fleet = new_fleet(g)
    try:
        with serving_fault_plan(ServingFaultPlan([ServingFault("corrupt_shadow", service="svc1")])):
            fleet.promote(m2_state)
        fail("phase 17 [corrupt_shadow]: the promotion was not refused")
    except PromotionError as e:
        check(str(e).startswith("shadow verification failed on service 'svc1'"), f"phase 17 [corrupt_shadow]: {e}")
        out["corrupt_reason"] = str(e)
    same_weights(g, before, "phase 17 [corrupt_shadow]")
    fleet = new_fleet(g)
    versions = [e.weights_version for e in g]
    try:
        with serving_fault_plan(ServingFaultPlan([ServingFault("flip_failure", service="svc1")])):
            fleet.promote(m2_state)
        fail("phase 17 [flip_failure]: the promotion was not refused")
    except PromotionError:
        pass
    check(fleet.swap_report()["swap_history"][-1]["status"] == "rolled_back", "phase 17 [flip_failure]: no rollback")
    check([e.weights_version - v for e, v in zip(g, versions)] == [2, 2, 2, 0, 0],
          f"phase 17 [flip_failure]: versions {versions} -> {[e.weights_version for e in g]}")  # fmt: skip
    same_weights(g, before, "phase 17 [flip_failure, svc0 back on checkpoint 1]")
    return out


def fleet_promotion(smi, g, prompts, counters, greedy) -> dict:
    """Phase 17 (c): ``promote(checkpoint 2, at_time=0)`` armed for a greedy
    run on ``g`` whose second half arrives while ``svc0`` drains; the
    results on checkpoint 2 against a fresh 32-slot engine there (module
    docstring)."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
    from eventstreamgpt_tpu_torch.serving import GenerationEngine

    m1, m2 = greedy["m1"], greedy["m2"]
    before = snapshot(g)
    # An idle promotion to checkpoint 2, whose weights equal a fresh engine's
    # there; the second half served from empty engines there (what a flipped
    # service serves, so every program key it needs is captured now, before
    # any flip); back to checkpoint 1.
    fleet = new_fleet(g)
    fleet.promote(m2.state_dict())
    check(fleet.swap_report()["swap_history"][-1]["status"] == "promoted", "phase 17 [idle promotion]: not promoted")
    fresh = GenerationEngine(m2, greedy["config"], template=prompts[0][0], n_slots=16, **greedy["kw"])
    for e in g:
        check(all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(weights_of(e), weights_of(fresh))),
              "phase 17 [idle promotion]: the flipped weights are not a fresh engine's on checkpoint 2")  # fmt: skip
    new_fleet(g).run(fleet_items(prompts, 32))
    new_fleet(g).promote(m1.state_dict())
    same_weights(g, before, "phase 17 [idle promotion to checkpoint 2 and back]")
    # Armed from the start: the first round submits the first 32 requests, then
    # stages and probes checkpoint 2 in every engine (~0.2 s) and starts
    # svc0's drain; the second 32 arrive at 0.05 s, so in the second round,
    # while svc0's first requests still decode: svc0's share is held and
    # released onto checkpoint 2 at its flip, svc1's is served on checkpoint 1
    # before svc1 drains and flips.
    start_version = [e.weights_version for e in g]
    arrivals = np.where(np.arange(len(prompts)) < 32, 0.0, 0.05)
    fleet = new_fleet(g)
    flips, drain = {}, {}
    ptrs = {id(e): [t.data_ptr() for t in weights_of(e)] for e in g}

    def timed_flip(e, sid):
        flip = e.flip

        def run():
            _, _, ms = device_timed(flip)
            flips.setdefault(sid, []).append(ms)
            e.captures_at_flip, e.chunks_at_flip = fleet_captures([e]), e._dispatched_chunks

        return run

    for sid, svc in fleet.services.items():
        for e in fleet._service_engines(svc):
            e.flip = timed_flip(e, sid)
    advance = fleet._advance_promotion

    def traced_advance():
        p = fleet._promotion
        draining, flipped, loaded = p["draining"], set(p["flipped"]), p["loaded"]
        t = time.perf_counter()
        advance()
        now = time.perf_counter()
        if not loaded:
            drain["stage and probe"] = [t, now]
        p = fleet._promotion
        if p is None:
            return
        if draining is None and p["draining"] is not None:
            drain[p["draining"]] = [now]
        for sid in set(p["flipped"]) - flipped:  # a service idle at its turn drains and flips in one call
            drain.setdefault(sid, [t]).append(now)

    fleet._advance_promotion = traced_advance
    fleet.promote(m2.state_dict(), at_time=0.0)
    items = fleet_items(prompts, arrivals=arrivals)
    run = fleet_pass(fleet, items, counters, "phase 17 [promotion]", use_arrival_times=True)
    for e in g:
        del e.flip
    report = fleet.swap_report()
    check(report["swap_dropped_requests"] == 0 and report["swap_history"][-1]["status"] == "promoted"
          and sorted(report["swap_history"][-1]["services"]) == ["svc0", "svc1"], f"phase 17 [promotion]: {report}")  # fmt: skip
    check([e.weights_version - v for e, v in zip(g, start_version)] == [1] * 5,
          "phase 17 [promotion]: not every engine flipped (the prefill engine included)")
    for e in g:
        check(fleet_captures([e]) == e.captures_at_flip, "phase 17 [promotion]: a capture at or after a flip")
        check([t.data_ptr() for t in weights_of(e)] == ptrs[id(e)], "phase 17 [promotion]: a flip moved a weight")
    after = sum(e._dispatched_chunks - e.chunks_at_flip for e in g[:2])
    check(after > 0 and run["launches"]["decode_stack_step"] > 0, "phase 17 [promotion]: svc0 decoded nothing after its "
          "flip")  # fmt: skip
    engine_of = {("svc0", 0): 0, ("svc0", 1): 1, ("svc1", 0): 3, ("svc1", 1): 4}
    new = [r for r in run["results"] if r.weights_version == start_version[engine_of[(r.service, r.replica)]] + 1]
    old = [r for r in run["results"] if r.weights_version == start_version[engine_of[(r.service, r.replica)]]]
    check(len(new) + len(old) == len(run["results"]), "phase 17 [promotion]: a result on neither checkpoint")
    check(0 < len(new) and report["held_peak"] > 0 and all(r.service == "svc0" and r.request_id >= 32 for r in new),
          f"phase 17 [promotion]: {len(new)} results on checkpoint 2, {report['held_peak']} held")  # fmt: skip
    by_id = {r.request_id: r for _, r, _ in fleet_items(prompts)}
    ref = GenerationEngine(m2, greedy["config"], template=prompts[0][0], n_slots=32, **greedy["kw"]).run(
        [dataclasses.replace(by_id[r.request_id], key=derive_request_seed(SEED, r.fleet_index)) for r in new])  # fmt: skip
    same_results(ref, new, "phase 17 [promotion]", "on checkpoint 2 vs a fresh 32-slot engine there with their seeds")
    clean = {r.request_id: r for r in greedy["results"]}
    same_results([clean[r.request_id] for r in old], old, "phase 17 [promotion]", "on checkpoint 1 vs the clean run")
    return dict(run=run, new=len(new), held_peak=report["held_peak"], chunks_after_flip=after, old=len(old),
                drain_ms={sid: round(1e3 * (t[1] - t[0]), 2) for sid, t in drain.items()},
                flip_device_ms={sid: round(sum(v), 4) for sid, v in flips.items()})  # fmt: skip


def small_fleet_checks() -> None:
    """Phase 17 (f): a small fp32 greedy fleet (two services, one behind a
    prefill stream) on the card: equal to the same fleet on the CPU and to one
    engine serving the accepted set; a death's replays, an idle promotion and
    a health retry against their undisturbed runs (floats within 1e-4)."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.reliability import ServingFault, ServingFaultPlan, serving_fault_plan
    from eventstreamgpt_tpu_torch.serving import (FleetHealthConfig, GenerationEngine, PrefillStream, ServingFleet,
                                                  ServingService)  # fmt: skip
    from eventstreamgpt_tpu_torch.training import build_model

    config = serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3), hidden_size=32,
                            head_dim=8, intermediate_size=64, seq_window_size=4)  # fmt: skip
    models = [init_params_from_seed(build_model(config), seed=s, std=0.15) for s in (1, 2)]
    with torch.no_grad():
        for m in models:
            m.output_layer.TTE_layer.proj.weight.mul_(0.02)
    prompts = synthetic_prompts(np.random.default_rng(2), 12, config, (6, 12), (4, 8))
    items = fleet_items(prompts)
    kw = dict(template=prompts[0][0], max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True)

    def fleet(dev="cuda", **fkw):
        e = [GenerationEngine(models[0], config, device=dev, n_slots=4, hot_swap=True, **kw) for _ in range(3)]
        return ServingFleet([ServingService(e[:1], prefill_stream=PrefillStream(e[1])), ServingService(e[2:])], **fkw)

    def one(model, **ekw):
        return GenerationEngine(model, config, device="cuda", n_slots=12, **kw, **ekw)

    diff = [0.0]

    def close(a_results, b_results, label):
        same_events(a_results, b_results, label)
        for a, b in zip(a_results, b_results):
            for f in ("time_delta", "dynamic_values"):
                x, y = getattr(a.batch, f), getattr(b.batch, f)
                diff[0] = max(diff[0], (x - y).abs().max().item())
                torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)

    res = {dev: fleet(dev).run(items) for dev in ("cuda", "cpu")}
    check({r.service for r in res["cuda"]} == {"svc0", "svc1"}, "phase 17 [small fleet]: one service took every request")
    check([(r.service, r.replica) for r in res["cuda"]] == [(r.service, r.replica) for r in res["cpu"]],
          "phase 17 [small fleet]: the card and the CPU placed a request differently")  # fmt: skip
    close(res["cuda"], res["cpu"], "phase 17 [small fleet, card vs CPU]")
    reqs = [r for _, r, _ in items]
    close(one(models[0]).run(reqs), res["cuda"], "phase 17 [small fleet vs one 12-slot engine]")
    f = fleet(health=FleetHealthConfig())
    with serving_fault_plan(ServingFaultPlan([ServingFault("death", service="svc1", chunk_index=1)])):
        dead = f.run(items)
    check(f.stats()["sessions_replayed_total"] > 0, "phase 17 [small fleet]: the death replayed nothing")
    close(res["cuda"], dead, "phase 17 [small fleet, replayed vs undisturbed]")
    f = fleet()
    f.promote(models[1].state_dict())
    close(one(models[1]).run(reqs), f.run(items), "phase 17 [small fleet after a promotion vs one engine there]")
    eng = one(models[0], health_retries=1)
    eng.fault_scope = "svc0"
    with serving_fault_plan(ServingFaultPlan([ServingFault("nan_slot", service="svc0", slot=0, chunk_index=1)])):
        retried = eng.run(reqs)
    check(eng.stats()["health_retried_total"] == 1, "phase 17 [small fleet]: no retry")
    close(res["cuda"], retried, "phase 17 [small fleet, a retry vs the clean run]")
    print(f"phase 17: small fp32 greedy fleet (two services, one behind a prefill stream) on the card: equal to the CPU "
          f"fleet, to one 12-slot engine, after a death's replays, after a promotion (to one engine there) and after a "
          f"retry (to the clean run): events and integers exact, floats within 1e-4 (max |diff| {diff[0]:.3g})",
          flush=True)  # fmt: skip


def fleet_phase(smi, config, m1, m2) -> dict:
    """Phase 17: the serving fleet over phase 16's checkpoints (module docstring)."""
    import numpy as np

    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical_stream
    from eventstreamgpt_tpu_torch.serving import FleetHealthConfig, GenerationEngine, PrefillStream, ServingService

    t0 = time.perf_counter()
    prompts = synthetic_prompts(np.random.default_rng(SEED), N_REQUESTS, serving_config(), (128, 192), (16, 64))
    counters = {"decode_stack_step": (decode_stack_step, "launches"),
                "fused_categorical_stream": (fused_categorical_stream, "launches")}  # fmt: skip
    kw = dict(max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED)

    def engines(**extra):
        return [GenerationEngine(m1, config, template=prompts[0][0], n_slots=16, hot_swap=True, **kw, **extra)
                for _ in range(5)]  # fmt: skip

    items, passes = fleet_items(prompts), []
    # (a) sampled, run twice over the same engines (the second after reset()); routes; kernels; each service
    # alone on the requests routed to it, with the fleet's seeds.
    s = engines()
    fleet = new_fleet(s)
    passes.append(fleet_pass(fleet, items, counters, "phase 17 [sampled fleet]"))
    fleet = new_fleet(s)
    walls = timed_rounds(fleet)
    passes.append(fleet_pass(fleet, items, counters, "phase 17 [sampled fleet, after reset()]"))
    same_results(passes[0]["results"], passes[1]["results"], "phase 17 [sampled fleet]", "second run vs first")
    check(all(r.service == fleet.route(r.subject) for r in passes[1]["results"])
          and {r.service for r in passes[1]["results"]} == {"svc0", "svc1"}, "phase 17 [sampled fleet]: routing")  # fmt: skip
    for n, run in enumerate(passes):
        check_fleet_kernels(run, f"phase 17 [sampled fleet, run {n + 1}]")
    round_ms = 1e3 * float(np.median(walls))
    by_index = {r.request_id: r for _, r, _ in items}
    for sid, reps, pf in (("svc0", s[:2], s[2]), ("svc1", s[3:5], None)):
        for e in s:
            e.reset()
        mine = [r for r in passes[1]["results"] if r.service == sid]
        alone = ServingService(reps, prefill_stream=None if pf is None else PrefillStream(pf), seed=SEED).run(
            [(dataclasses.replace(by_index[r.request_id], key=derive_request_seed(SEED, r.fleet_index)), r.lane)
             for r in mine])  # fmt: skip
        same_results(mine, alone, "phase 17 [sampled fleet]", f"{sid}'s requests vs {sid} alone with the fleet's seeds")
    t1 = time.perf_counter()
    # (e) the watchdog at 10x the round wall over a sampled run under Poisson arrivals on fresh engines
    # (program keys captured during it); then the same arrivals again, timed.
    gaps = np.random.default_rng(SEED + 17).exponential(1.0 / ARRIVALS_PER_S, N_REQUESTS)
    arrivals = np.cumsum(gaps) - gaps[0]
    w = engines()
    fleet = new_fleet(w, health=FleetHealthConfig(boundary_timeout_s=10 * round_ms / 1e3, watchdog_warmup_chunks=0))
    captured = fleet_captures(w)
    watched = fleet_pass(fleet, fleet_items(prompts, arrivals=arrivals), counters, "phase 17 [watchdog]",
                         use_arrival_times=True)  # fmt: skip
    captured = fleet_captures(w) - captured
    check(watched["stats"]["replica_faults"] == [] and captured > 0,
          f"phase 17 [watchdog]: faults {watched['stats']['replica_faults']}, {captured} captures during the run")  # fmt: skip
    passes.append(watched)
    poisson = fleet_pass(new_fleet(w), fleet_items(prompts, arrivals=arrivals), counters, "phase 17 [Poisson]",
                         use_arrival_times=True)  # fmt: skip
    passes.append(poisson)
    t2 = time.perf_counter()
    # (a) greedy: run twice; equal to one 32-slot engine serving the accepted set in order with the same seed.
    g = engines(greedy=True)
    single = GenerationEngine(m1, config, template=prompts[0][0], n_slots=32, greedy=True, health_retries=1, **kw)
    greedy = fleet_pass(new_fleet(g), items, counters, "phase 17 [greedy fleet]")
    check_fleet_kernels(greedy, "phase 17 [greedy fleet]", sampled=False)
    passes.append(greedy)
    again = fleet_pass(new_fleet(g), items, counters, "phase 17 [greedy fleet, after reset()]")
    same_results(greedy["results"], again["results"], "phase 17 [greedy fleet]", "second run vs first")
    same_results(single.run([r for _, r, _ in items]), greedy["results"], "phase 17 [greedy fleet]",
                 "one 32-slot engine vs the fleet")  # fmt: skip
    greedy.update(m1=m1, m2=m2, config=config, kw=dict(kw, greedy=True))
    faults = fleet_faults(smi, g, single, prompts, counters, greedy)
    t3 = time.perf_counter()
    promo = fleet_promotion(smi, g, prompts, counters, greedy)
    passes.append(promo["run"])
    t4 = time.perf_counter()
    small_fleet_checks()
    t5 = time.perf_counter()
    run = passes[1]
    stats = {k: v for k, v in run["stats"].items() if k != "services"}
    stats["services"] = {sid: {k: v for k, v in st.items() if k in ("accepted_total", "rejected_total", "expired_total",
                                                                    "outstanding_budget", "prefill_stream")}
                         for sid, st in run["stats"]["services"].items()}  # fmt: skip
    print(f"phase 17 [fleet]: 64 requests over svc0 (two 16-slot replicas, a prefill stream) and svc1 (two 16-slot "
          f"replicas), {run['generated']} generated events; the run after reset() equals the first bit for bit, each "
          f"service's requests equal that service alone with the fleet's seeds; routes are the ring's; all at once "
          f"{run['rate']:.1f} events/s ({run['wall_s']:.4f} s; first run {passes[0]['rate']:.1f}), latency "
          f"{json.dumps(run['latency'])}; Poisson arrivals at {ARRIVALS_PER_S:.0f}/s (last at {arrivals[-1]:.3f} s) "
          f"{poisson['rate']:.1f} events/s ({poisson['wall_s']:.4f} s), latency {json.dumps(poisson['latency'])}; the "
          f"watchdog at 10x the median round ({round_ms:.2f} ms) saw no fault over {captured} captures; greedy "
          f"{greedy['rate']:.1f} events/s, equal to one 32-slot engine bit for bit; launches {run['launches']} "
          f"({smi})", flush=True)  # fmt: skip
    print(f"phase 17 [fleet]: promotion under traffic: {promo['new']} of 64 requests on checkpoint 2 (equal to a fresh "
          f"32-slot engine there), held_peak {promo['held_peak']}, {promo['old']} on checkpoint 1 (equal to the "
          f"undisturbed run), drain ms {json.dumps(promo['drain_ms'])}, "
          f"flip device ms a service {json.dumps(promo['flip_device_ms'])}, svc0 {promo['chunks_after_flip']} chunks "
          f"after its flip; eviction (every request equal to the undisturbed run, the replayed included) "
          f"{json.dumps({k: round(v, 4) for k, v in faults['eviction'].items()})}; hang (the same) "
          f"{json.dumps(faults['hang'])}; the corrupt checkpoint refused ({faults['corrupt_reason']}); stats() "
          f"{json.dumps(stats)} ({smi})", flush=True)  # fmt: skip
    launches = {k: sum(r["launches"][k] for r in passes) for k in counters}
    print(f"phase 17: passed in {t5 - t0:.1f} s (sampled fleet {t1 - t0:.1f}, watchdog and arrivals {t2 - t1:.1f}, "
          f"greedy, eviction, health and rollbacks {t3 - t2:.1f}, promotion {t4 - t3:.1f}, small fleet {t5 - t4:.1f}); "
          f"launches over the counted runs {launches}", flush=True)  # fmt: skip
    return dict(launches_a=launches["fused_categorical_stream"], launches_b=launches["decode_stack_step"])


# ---------------------------------------------------------------- phase 18
PRETRAIN_COHORT = {"train": 512, "tuning": 64, "held_out": 64}  # bench.py's cohort
PRETRAIN_SMALL = dict(sizes=(5, 40, 6, 16), hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4)


def pretrain_cfg(save_dir, data_dir, epochs=2, batch=None, seq=None, accumulation=None, final=False, **tc):
    """bench.py's optimization settings (16 steps an epoch on its cohort;
    batches of `TRAIN_BATCH`, rows of `TRAIN_SEQ`), a log record every 4
    steps and a kept checkpoint every 8; the final validation with ``final``."""
    batch, seq = batch or TRAIN_BATCH, seq or TRAIN_SEQ
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training.pretrain import PretrainConfig

    return PretrainConfig(
        seed=SEED, save_dir=str(save_dir),
        optimization_config=OptimizationConfig(init_lr=1e-3, batch_size=batch, validation_batch_size=batch,
                                               max_epochs=epochs, lr_frac_warmup_steps=0.1,
                                               gradient_accumulation=accumulation),
        data_config=PytorchDatasetConfig(save_dir=str(data_dir), max_seq_len=seq, min_seq_len=4),
        trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": 8, "max_checkpoints_to_keep": 100, **tc},
        do_final_validation_on_metrics=final,
    )  # fmt: skip


def read_train_log(save_dir) -> list:
    return [json.loads(line) for line in (Path(save_dir) / "train_log.jsonl").open()]


def pretrain_run(label, cfg, model_config, device="cuda", **kw) -> dict:
    """One `train(cfg)`: its outputs, log, weights and wall seconds."""
    import torch

    from eventstreamgpt_tpu_torch.training.pretrain import train

    t0 = time.perf_counter()
    out = train(cfg, model_config=model_config(), device=device, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    save = Path(cfg.save_dir)
    log = read_train_log(save)
    weights = torch.load(save / "pretrained_weights" / "model.pt", map_location="cpu", weights_only=True)
    return dict(label=label, out=out, log=log, weights=weights, wall=wall, save=save)


def train_losses(run, after=0) -> dict:
    """``(epoch, step) -> train_loss`` of the log windows wholly after step ``after``."""
    return {(r["epoch"], r["step"]): r["train_loss"] for r in run["log"] if r["split"] == "train"
            and r["step"] - 4 >= after}  # fmt: skip


def checkpoint_state(save_dir, step) -> dict:
    import torch

    return torch.load(Path(save_dir) / "model_checkpoints" / str(step) / "state.pt", map_location="cpu",
                      weights_only=True)  # fmt: skip


def same_tensors(a: dict, b: dict) -> bool:
    import torch

    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def same_as(run, ref, label, after=0, adam_step=None) -> None:
    """``run`` ended as ``ref`` bit for bit: weights, final metrics, the log
    windows wholly after ``after``, and (``adam_step``) the AdamW state of
    the checkpoint there."""
    check(same_tensors(run["weights"], ref["weights"]), f"{label}: the final weights differ from (a)'s")
    check(run["out"][0] is None or run["out"] == ref["out"],
          f"{label}: the final metrics differ from (a)'s: {run['out'][0]} vs {ref['out'][0]}")  # fmt: skip
    mine, theirs = train_losses(run, after), train_losses(ref, after)
    check(mine and all(mine[k] == theirs[k] for k in mine), f"{label}: logged losses {mine} differ from (a)'s {theirs}")
    if adam_step is not None:
        a, b = checkpoint_state(run["save"], adam_step)["adam"], checkpoint_state(ref["save"], adam_step)["adam"]
        check(all(same_tensors(a[f], b[f]) for f in a), f"{label}: the AdamW state at step {adam_step} differs")


def seed_save_dir(ref, dst, steps) -> Path:
    """A save_dir holding ``ref``'s config files and its checkpoints at ``steps``."""
    import shutil

    dst = Path(dst)
    (dst / "model_checkpoints").mkdir(parents=True)
    for name in ("config.json", "data_config.json"):
        shutil.copy(ref["save"] / name, dst / name)
    for step in steps:
        src = ref["save"] / "model_checkpoints"
        shutil.copytree(src / str(step), dst / "model_checkpoints" / str(step))
        for side in ("metadata", "manifest"):
            shutil.copy(src / f"{side}_{step}.json", dst / "model_checkpoints")
    return dst


def epochs_line(run) -> str:
    """Trained events/s of each window and epoch, each epoch's wall split, the final validation's seconds."""
    windows = [r for r in run["log"] if r["split"] == "train"]
    epochs = [r for r in run["log"] if r["split"] == "tuning"]
    final = next((r for r in run["log"] if r["split"] == "final"), {})
    parts = []
    for e in epochs:
        events = sum(w["events"] for w in windows if w["epoch"] == e["epoch"])
        parts.append(f"epoch {e['epoch']}: {events / e['steps_s']:.1f} trained events/s, wall {e['epoch_time_s']:.3f} s "
                     f"(steps {e['steps_s']:.3f}, tuning eval {e['eval_s']:.3f}, checkpoint saves "
                     f"{e['checkpoint_s']:.3f})")  # fmt: skip
    windows_s = [round(w["events_per_sec"], 1) for w in windows]
    return (f"windows' trained events/s {windows_s}; {'; '.join(parts)}; final validation "
            f"{final.get('validation_s', float('nan')):.3f} s; train() wall {run['wall']:.2f} s")


def pretrain_phase(smi, tmp: Path) -> dict:
    """Phase 18: `training.pretrain.train(cfg)` from a converted DL cache on the card (module docstring); its
    cache and save_dirs stay in ``tmp`` for phase 20."""
    import numpy as np
    import torch

    import eventstreamgpt_tpu_torch.training.pretrain as pretrain_module
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, write_synthetic_cache
    from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd
    from eventstreamgpt_tpu_torch.reliability import Fault, FaultPlan, Preempted, corrupt_checkpoint_step, fault_plan
    from eventstreamgpt_tpu_torch.reliability.integrity import ReliableCheckpointManager
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer
    from eventstreamgpt_tpu_torch.training.checkpoint import load_pretrained
    from eventstreamgpt_tpu_torch.training.optimizer import make_capturable

    counters = (vocab_gather_fwd, vocab_gather_bwd, dep_graph_fwd, dep_graph_bwd)
    ci = lambda: serving_config(precision="bf16")  # noqa: E731  (bench.py's CI training model, dropout 0.1)
    na = lambda: serving_config(precision="bf16", **NA_OVERRIDES)  # noqa: E731
    t0 = time.perf_counter()
    cache = write_synthetic_cache(tmp / "cache", PRETRAIN_COHORT, n_event_types=40, n_labs=3500, n_meds=500,
                                  mean_seq_len=200, max_seq_len=512, seed=SEED)  # fmt: skip
    cache_s = time.perf_counter() - t0

    # (a) resident tables, the captured chunked step
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what earlier phases still hold
    a = pretrain_run("(a)", pretrain_cfg(tmp / "a", cache, final=True), ci)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = {fn.__name__: fn.launches for fn in counters}
    tuning = [r for r in a["log"] if r["split"] == "tuning"]
    windows = [r for r in a["log"] if r["split"] == "train"]
    check([r["epoch"] for r in tuning] == [0, 1] and tuning[1]["tuning_loss"] < tuning[0]["tuning_loss"]
          and all(math.isfinite(r["tuning_loss"]) for r in tuning),
          f"phase 18 (a): tuning losses {[r['tuning_loss'] for r in tuning]} not finite and falling")  # fmt: skip
    check([r["step"] for r in windows] == [4, 8, 12, 16, 20, 24, 28, 32]
          and all(r["split"] == "train" and math.isfinite(r["train_loss"]) for r in windows),
          f"phase 18 (a): the train log's windows {windows}")  # fmt: skip
    check(tuning[0]["graph_captures"] == tuning[1]["graph_captures"] == 1,
          f"phase 18 (a): captures after each epoch {[r['graph_captures'] for r in tuning]}, not 1 and 1")  # fmt: skip
    steps, evals = 32, 2 * 2 + 2 + 2  # two tuning passes of 2 batches, then tuning and held_out
    want = {"vocab_gather_fwd": steps + evals, "vocab_gather_bwd": steps, "dep_graph_fwd": 0, "dep_graph_bwd": 0}
    check(launches == want, f"phase 18 (a): launches {launches}, expected {want}")
    live = checkpoint_state(a["save"], 32)["params"]  # the live state at the end, as its last checkpoint holds it
    loaded, _ = load_pretrained(a["save"], device="cuda")
    check(same_tensors({k: t.cpu() for k, t in loaded.state_dict().items()}, live),
          "phase 18 (a): load_pretrained's weights are not the live weights")  # fmt: skip
    loss, tuning_m, held_out_m = a["out"]
    metrics = {**tuning_m, **held_out_m}
    check(all(math.isfinite(v) for v in metrics.values()) and len(tuning_m) == len(held_out_m) >= 10
          and "tuning_TTE_MSE" in tuning_m and "held_out_lab_MSE" in held_out_m,
          f"phase 18 (a): final metrics {metrics}")  # fmt: skip

    # (b) host collation and the prefetch thread feeding the captured single step
    b = pretrain_run("(b)", pretrain_cfg(tmp / "b", cache, final=True, device_resident_data=False), ci)
    same_as(b, a, "phase 18 (b) [host path]", adam_step=32)
    check(train_losses(b) == train_losses(a), "phase 18 (b): a logged loss differs from (a)'s")

    # (c) resume at epoch 1 with 8 batches to skip, then a walk-back over a corrupt step 24
    meta = json.loads((a["save"] / "model_checkpoints" / "metadata_24.json").read_text())
    check(meta == {"epoch": 1, "epoch_complete": False, "step_in_epoch": 8}, f"phase 18 (c): step 24's metadata {meta}")
    t0 = time.perf_counter()
    c = pretrain_run("(c)", pretrain_cfg(seed_save_dir(a, tmp / "c", (8, 16, 24)), cache), ci)
    same_as(c, a, "phase 18 (c) [resume at 24]", after=24)
    walk = seed_save_dir(a, tmp / "c_walk", (8, 16, 24))
    corrupt_checkpoint_step(walk / "model_checkpoints", 24)
    c_walk = pretrain_run("(c walk-back)", pretrain_cfg(walk, cache), ci)
    check(not (walk / "model_checkpoints" / "24").exists() or checkpoint_state(walk, 24)["step"] == 24,
          "phase 18 (c): the corrupt step was neither removed nor rewritten")  # fmt: skip
    same_as(c_walk, a, "phase 18 (c) [walk back to 16]", after=16)
    resumes_s = time.perf_counter() - t0

    # (d) a scripted SIGTERM at step 12, then the relaunch
    plan = FaultPlan([Fault(kind="sigterm", step=12)])
    try:
        with fault_plan(plan):
            pretrain_run("(d)", pretrain_cfg(tmp / "d", cache), ci)
        fail("phase 18 (d): train() was not preempted")
    except Preempted as e:
        check(e.step == 12, f"phase 18 (d): preempted with its final checkpoint at {e.step}, not 12")
    d = pretrain_run("(d relaunch)", pretrain_cfg(tmp / "d", cache), ci)
    same_as(d, a, "phase 18 (d) [relaunch]", after=12)

    # (e) host path, a poisoned batch in epoch 1: rollback in place
    ptrs = {}
    original = pretrain_module.load_train_state

    def watched(sd, model, optimizer, scheduler, state):
        before = [p.data_ptr() for p in model.parameters()] + [t.data_ptr() for st in optimizer.state.values()
                                                               for t in st.values()]  # fmt: skip
        original(sd, model, optimizer, scheduler, state)
        ptrs.setdefault("same", []).append(before == [p.data_ptr() for p in model.parameters()] + [
            t.data_ptr() for st in optimizer.state.values() for t in st.values()])  # fmt: skip

    pretrain_module.load_train_state = watched
    plan = FaultPlan([Fault(kind="nan_batch", epoch=1, batch_index=2)])
    try:
        with fault_plan(plan):
            e = pretrain_run("(e)", pretrain_cfg(tmp / "e", cache, device_resident_data=False), ci)
    finally:
        pretrain_module.load_train_state = original
    events = [r for r in e["log"] if r["split"] == "reliability"]
    e_tuning = [r for r in e["log"] if r["split"] == "tuning"]
    check(plan.fired == [{"kind": "nan_batch", "epoch": 1, "batch_index": 2}] and len(events) == 1
          and events[0]["restored_step"] == 16, f"phase 18 (e): rollback events {events}, faults {plan.fired}")  # fmt: skip
    check(ptrs.get("same") == [True], f"phase 18 (e): a restore moved a parameter or AdamW tensor: {ptrs}")
    check(all(math.isfinite(r["tuning_loss"]) for r in e_tuning)
          and [r["graph_captures"] for r in e_tuning] == [1, 1],
          f"phase 18 (e): the run after the rollback {e_tuning}")  # fmt: skip

    # (f) gradient accumulation 2 for an epoch at full width; a small fp32 run, card against CPU
    f = pretrain_run("(f)", pretrain_cfg(tmp / "f", cache, epochs=1, accumulation=2), ci)
    f_state = checkpoint_state(f["save"], 16)
    check(f_state["step"] == 16 and f_state["scheduler_step"] == 8
          and all(math.isfinite(r["train_loss"]) for r in f["log"] if r["split"] == "train"),
          f"phase 18 (f): loop steps {f_state['step']}, scheduler steps {f_state['scheduler_step']}")  # fmt: skip
    small_cache = write_synthetic_cache(tmp / "small_cache", {"train": 32, "tuning": 8, "held_out": 8},
                                        n_event_types=5, n_labs=40, n_meds=6, n_static=16, mean_seq_len=20,
                                        max_seq_len=40, seed=SEED)  # fmt: skip
    small = lambda: serving_config(precision="fp32", attention_dropout=0.0, input_dropout=0.0,  # noqa: E731
                                   resid_dropout=0.0, **PRETRAIN_SMALL)  # fmt: skip
    small_runs = {dev: pretrain_run(f"(f small {dev})", pretrain_cfg(tmp / f"f_{dev}", small_cache, epochs=2,
                                                                      batch=4, seq=16, accumulation=2), small,
                                    device=dev) for dev in ("cuda", "cpu")}  # fmt: skip
    gpu_l, cpu_l = train_losses(small_runs["cuda"]), train_losses(small_runs["cpu"])
    check(sorted(gpu_l) == sorted(cpu_l) and all(abs(gpu_l[k] - cpu_l[k]) <= 1e-4 * max(1, abs(cpu_l[k]))
                                                  for k in cpu_l),
          f"phase 18 (f): the small run's losses on the card {gpu_l} vs the CPU {cpu_l}")  # fmt: skip
    w_gpu, w_cpu = small_runs["cuda"]["weights"], small_runs["cpu"]["weights"]
    worst = max(float((w_gpu[k] - w_cpu[k]).abs().max()) for k in w_cpu)
    check(worst <= 1e-4, f"phase 18 (f): the small run's weights differ by {worst} between the card and the CPU")

    # (g) phase 6's NA model through train() for one epoch
    for fn in counters:
        fn.launches = 0
    g = pretrain_run("(g)", pretrain_cfg(tmp / "g", cache, epochs=1), na)
    g_launches = {fn.__name__: fn.launches for fn in counters}
    layers = na().num_hidden_layers
    g_evals = 2  # one tuning pass of 2 batches
    want_g = {"vocab_gather_fwd": 16 + g_evals, "vocab_gather_bwd": 16, "dep_graph_fwd": layers * (16 + g_evals),
              "dep_graph_bwd": layers * 16}  # fmt: skip
    check(g_launches == want_g, f"phase 18 (g): launches {g_launches}, expected {want_g}")
    check(all(math.isfinite(r[k]) for r in g["log"] for k in ("train_loss", "tuning_loss") if k in r),
          "phase 18 (g): a loss is not finite")  # fmt: skip

    # One checkpoint save and one resume (a read, verified, written into a model on the card in place).
    state = checkpoint_state(a["save"], 32)
    mgr = ReliableCheckpointManager(tmp / "timing")
    t0 = time.perf_counter()
    mgr.save(32, state, metadata={"epoch": 1, "epoch_complete": True})
    save_s = time.perf_counter() - t0
    model = build_model(StructuredTransformerConfig.from_json_file(a["save"] / "config.json")).cuda()
    oc = pretrain_cfg(tmp, cache).optimization_config
    oc.set_to_dataset(range(PRETRAIN_COHORT["train"]))
    opt, sched = build_optimizer(model, oc)
    make_capturable(opt, "cuda")
    t0 = time.perf_counter()
    restored, _ = mgr.restore_latest_verified(require_metadata=True)
    original(restored, model, opt, sched, pretrain_module.TrainState())
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    ckpt_mb = sum(p.stat().st_size for p in (tmp / "timing" / "32").rglob("*")) / 1e6

    check("pandas" not in sys.modules and "pyarrow" not in sys.modules, "phase 18: pandas or pyarrow was imported")
    print(f"phase 18: train(cfg) from a converted DL cache ({PRETRAIN_COHORT} subjects written in {cache_s:.2f} s), "
          f"bench.py's CI model (bf16, dropout 0.1), 2 epochs of 16 steps (B={TRAIN_BATCH}, L={TRAIN_SEQ}): tuning loss "
          f"{tuning[0]['tuning_loss']:.4f} -> {tuning[1]['tuning_loss']:.4f}, final tuning loss {loss:.4f}; (a) resident: "
          f"{epochs_line(a)}; (b) host path + prefetch: {epochs_line(b)}; (b) equals (a) bit for bit (weights, AdamW, "
          f"log, metrics); (c) resume at 24 and walk-back to 16, (d) preemption at 12 and relaunch equal (a) "
          f"({resumes_s:.1f} s for the two resumed runs); (e) rollback to step 16 in place; (f) accumulation 2: "
          f"8 updates in 16 steps, small fp32 card vs CPU max weight diff {worst:.2e}; (g) NA: {epochs_line(g)}; "
          f"launches (a) {launches}, (g) {g_launches}; one checkpoint save {save_s:.3f} s and one resume "
          f"{resume_s:.3f} s ({ckpt_mb:.1f} MB); peak memory (a) {peak_gb:.3f} GB ({smi})", flush=True)  # fmt: skip
    return dict(launches={k: launches[k] + g_launches[k] for k in launches}, cache=cache, save_a=a["save"],
                save_g=g["save"])


# ---------------------------------------------------------------- phase 19
FUNCTOR_DATA = REPO / "sample_data" / "converted" / "sample"  # the committed conversion of the sample cohort
TOD_VOCAB = {"vocabulary": ["UNK", "EARLY_AM", "AM", "PM", "LATE_PM"], "obs_frequencies": [0.0, 0.2, 0.3, 0.35, 0.15]}
TOD_EDGE_MIN = 4.0  # a time-of-day element this close to an edge is not recomputed (fp32 times and hours at 2010)
ZS_TASK, ZS_SAMPLES, ZS_BATCH, ZS_SEQ, ZS_NEW = "high_utilization", 8, 12, 128, 64


def with_functors(config):
    """``config`` with two functional-time-dependent measurements added at
    the end of its vocabulary: ``age``, an `AgeFunctor` (univariate
    regression, the sample cohort's fitted ``age.csv``), and ``tod``, a
    four-value `TimeOfDayFunctor`."""
    from eventstreamgpt_tpu_torch.data.config import MeasurementConfig
    from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig

    d = config.to_dict()
    V, n = config.vocab_size, max(config.measurements_idxmap.values())
    d["measurement_configs"] = dict(
        d["measurement_configs"],
        age=MeasurementConfig(name="age", temporality="functional_time_dependent", modality="univariate_regression",
                              functor={"class": "AgeFunctor", "params": {"dob_col": "dob"}},
                              _measurement_metadata=str(FUNCTOR_DATA / "inferred_measurement_metadata" / "age.csv"),
                              ).to_dict(),
        tod=MeasurementConfig(name="tod", temporality="functional_time_dependent",
                              modality="single_label_classification", functor={"class": "TimeOfDayFunctor",
                              "params": {}}, vocabulary=TOD_VOCAB).to_dict(),
    )  # fmt: skip
    d["vocab_sizes_by_measurement"] = dict(d["vocab_sizes_by_measurement"], age=1, tod=5)
    d["vocab_offsets_by_measurement"] = dict(d["vocab_offsets_by_measurement"], age=V, tod=V + 1)
    d["measurements_idxmap"] = dict(d["measurements_idxmap"], age=n + 1, tod=n + 2)
    d["vocab_size"] = V + 6
    return StructuredTransformerConfig.from_dict(d)


def local_midnight_2010() -> float:
    from datetime import datetime

    return datetime(2010, 1, 1).timestamp() / 60


def tod_bucket(minutes: float) -> str:
    """The time-of-day bucket of an absolute time (minutes since the epoch), in fp64."""
    hour = ((minutes - local_midnight_2010()) / 60) % 24
    return "EARLY_AM" if hour < 6 else "AM" if hour < 12 else "PM" if hour < 21 else "LATE_PM"


def edge_distance(minutes: float) -> float:
    hour = ((minutes - local_midnight_2010()) / 60) % 24
    return min(abs(hour - h) * 60 for h in (0, 6, 12, 21, 24))


def with_functor_elements(prompts, config, rng):
    """``prompts`` with each event's age and time-of-day elements written
    after its other elements (two more data slots): a request starts in
    2010 (uniform over the year, local time), aged 20-90 years at its first
    event (an age growing with the event times, normalized with
    ``age.csv``), its time-of-day bucket that of each event's time."""
    import numpy as np
    import torch

    age_cfg, tod_cfg = config.measurement_configs["age"], config.measurement_configs["tod"]
    mm = age_cfg.measurement_metadata
    mean, std = mm["normalizer"]["mean_"], mm["normalizer"]["std_"]
    off, idx = config.vocab_offsets_by_measurement, config.measurements_idxmap
    vocab = tod_cfg.vocabulary_object
    out = []
    for p, budget in prompts:
        L, M = p.dynamic_indices.shape[1:]
        di, dm, dv, vm = (np.zeros((1, L, M + 2), a.dtype) for a in
                          (p.dynamic_indices.numpy(), p.dynamic_measurement_indices.numpy(),
                           p.dynamic_values.numpy(), p.dynamic_values_mask.numpy()))  # fmt: skip
        for a, src in ((di, p.dynamic_indices), (dm, p.dynamic_measurement_indices), (dv, p.dynamic_values),
                       (vm, p.dynamic_values_mask)):  # fmt: skip
            a[..., :M] = src.numpy()
        start = np.float32(local_midnight_2010() + rng.uniform(0, 365 * 1440))
        age0 = rng.uniform(20, 90)
        t = np.concatenate([[0.0], np.cumsum(p.time_delta.numpy()[0].astype(np.float64))])[:L] + float(start)
        for e in range(L):
            k = int((di[0, e] != 0).sum())
            age = age0 + (t[e] - t[0]) / (60 * 24 * 365.25)
            di[0, e, k : k + 2] = (off["age"], off["tod"] + vocab[tod_bucket(t[e])])
            dm[0, e, k : k + 2] = (idx["age"], idx["tod"])
            dv[0, e, k], vm[0, e, k] = (age - mean) / std, True
        out.append((p.replace(dynamic_indices=torch.from_numpy(di), dynamic_measurement_indices=torch.from_numpy(dm),
                              dynamic_values=torch.from_numpy(dv), dynamic_values_mask=torch.from_numpy(vm),
                              start_time=torch.tensor([start])), budget))  # fmt: skip
    return out


def check_functor_elements(results, config, label) -> dict:
    """Every generated real event of every result holds exactly one
    time-of-day element, whose bucket is that of the event's time recomputed
    in fp64 from the returned row (unless within `TOD_EDGE_MIN` of an edge),
    and exactly one age element: the prior event's age plus the time to
    this event over a 365.25-day year, normalized (within 1e-4 years), or
    value-masked where that age lies past ``age.csv``'s outlier thresholds.
    Returns the counts checked."""
    import numpy as np

    mm = config.measurement_configs["age"].measurement_metadata
    mean, std = mm["normalizer"]["mean_"], mm["normalizer"]["std_"]
    hi, lo = mm["outlier_model"]["thresh_large_"], mm["outlier_model"]["thresh_small_"]
    a_i, t_i, t_off = config.measurements_idxmap["age"], config.measurements_idxmap["tod"], \
        config.vocab_offsets_by_measurement["tod"]  # fmt: skip
    vocab = config.measurement_configs["tod"].vocabulary_object
    n = dict(events=0, tod_checked=0, tod_near_edge=0, ages=0, ages_masked=0)
    for r in results:
        b = r.batch
        em, td = b.event_mask[0].numpy(), b.time_delta[0].numpy().astype(np.float64)
        di, dm = b.dynamic_indices[0].numpy(), b.dynamic_measurement_indices[0].numpy()
        dv, vm = b.dynamic_values[0].numpy().astype(np.float64), b.dynamic_values_mask[0].numpy()
        start = float(b.start_time[0])
        for e in range(r.prompt_len, r.n_events):
            if not em[e]:
                continue
            n["events"] += 1
            tod, age = dm[e] == t_i, dm[e] == a_i
            check(tod.sum() == 1 and age.sum() == 1, f"{label}: request {r.request_id} event {e} holds {tod.sum()} "
                                                     f"time-of-day and {age.sum()} age elements")  # fmt: skip
            t = start + td[:e][em[:e]].sum()
            if edge_distance(t) > TOD_EDGE_MIN:
                want = t_off + vocab[tod_bucket(t)]
                check(di[e][tod][0] == want, f"{label}: request {r.request_id} event {e} at {t:.1f} min: time of "
                                             f"day {di[e][tod][0]}, {want} expected")  # fmt: skip
                n["tod_checked"] += 1
            else:
                n["tod_near_edge"] += 1
            prior = dm[e - 1] == a_i
            if not (prior.any() and vm[e - 1][prior][0]):
                continue  # a masked prior age re-enters at the mean, as in JAX
            years = dv[e - 1][prior][0] * std + mean + td[e - 1] / (60 * 24 * 365.25)
            if vm[e][age][0]:
                got = dv[e][age][0] * std + mean
                check(abs(got - years) < 1e-4, f"{label}: request {r.request_id} event {e}: age {got}, {years} expected")
                n["ages"] += 1
            else:
                check(years > hi - 1e-4 or years < lo + 1e-4, f"{label}: request {r.request_id} event {e}: age "
                                                               f"{years} value-masked inside the thresholds")  # fmt: skip
                n["ages_masked"] += 1
    check(n["events"] > 0 and n["tod_checked"] > 0 and n["ages"] > 0, f"{label}: nothing checked: {n}")
    return n


def functor_serving_runs(smi, model, config) -> dict:
    """Phase 19 (a): phase 2's serving model with both functors (module docstring)."""
    import numpy as np

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.models.ci_model import CIPPTForGenerativeSequenceModeling
    from eventstreamgpt_tpu_torch.ops.decode_step import decode_stack_step
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical, fused_categorical_stream

    fcfg = with_functors(config)
    fmodel = init_params_from_seed(CIPPTForGenerativeSequenceModeling(fcfg), seed=SEED)
    rng = np.random.default_rng(SEED)
    prompts = with_functor_elements(synthetic_prompts(rng, N_REQUESTS, serving_config(), (128, 192), (16, 64)), fcfg,
                                    rng)  # fmt: skip
    counters = {"decode_stack_step": (decode_stack_step, "launches"),
                "fused_categorical_stream": (fused_categorical_stream, "launches"),
                "fused_categorical": (fused_categorical, "launches")}  # fmt: skip
    kw = dict(n_slots=32, max_len=256, max_prompt_len=192, min_bucket=32, decode_chunk=16, seed=SEED, dispatch_depth=2)
    out = dict(launches_a=0, launches_b=0, rates={}, checked={})
    for mode in ("greedy", "sampled"):
        label = f"phase 19 (a) [functors, {mode}, depth 2]"
        run = engine_run(fmodel, fcfg, prompts, counters, passes=("warm", "accounting"), greedy=mode == "greedy", **kw)
        check_results(run["results"], run["requests"], label)
        check_graph_counts(run, label, "decode_stack_step")
        check_passes(run, label)
        a = run["launches"]["fused_categorical_stream"]
        check(a > 0 if mode == "sampled" else a == 0, f"{label}: kernel A launched {a} times")
        check(run["launches"]["fused_categorical"] == 0, f"{label}: the engine launched kernel A with given noise")
        out["checked"][mode] = check_functor_elements(run["results"], fcfg, label)
        if mode == "greedy":
            eager = engine_run(fmodel, fcfg, prompts, counters, passes=("warm",), cuda_graph=False, greedy=True, **kw)
            same_results(run["results"], eager["results"], label)
            # A request's events do not depend on its batch (phase 17's check): 16 slots give the 32 slots' bits.
            half = engine_run(fmodel, fcfg, prompts, counters, passes=("warm",), greedy=True, **dict(kw, n_slots=16))
            same_results(run["results"], half["results"], label, "32 slots vs 16")
        out["launches_a"] += a
        out["launches_b"] += run["launches"]["decode_stack_step"]
        acct = run["passes"]["accounting"]
        generated = sum(r.n_generated for r in run["results"])
        out["rates"][mode] = dict(events_per_s=generated / acct["wall_s"], wall_s=acct["wall_s"], generated=generated)
    print(f"phase 19 (a): phase 2's serving model with an AgeFunctor and a TimeOfDayFunctor (vocabulary "
          f"{fcfg.vocab_size}), {N_REQUESTS} requests at 32 slots, depth 2: every generated event's functor elements "
          f"checked {json.dumps(out['checked'])}; greedy captured = eager = 16 slots bit for bit; events/s (accounting pass) "
          f"{json.dumps(out['rates'])}; launches A {out['launches_a']}, B {out['launches_b']} ({smi})", flush=True)  # fmt: skip
    return out


def small_functor_engines_match_cpu() -> list:
    """Phase 19 (b): small fp32 greedy runs with both functors on the card
    against the CPU: `generate()`, a paged engine with a fork, the CI spec
    engine (strict) and the NA engine; events and integers exact, floats
    within phase 2's small-engine tolerance (1e-4)."""
    import functools

    import numpy as np
    import torch

    import eventstreamgpt_tpu_torch.generation.generation_utils as gu
    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, synthetic_prompts
    from eventstreamgpt_tpu_torch.data.types import EventStreamBatch
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request, SpecConfig, truncated_draft
    from eventstreamgpt_tpu_torch.training import build_model

    exact = ("event_mask", "dynamic_indices", "dynamic_measurement_indices", "dynamic_values_mask")
    done = []

    def same(a, b, what):
        for f in exact:
            check(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f"phase 19 (b) [{what}]: {f} differs card and CPU")
        for f in ("time_delta", "dynamic_values"):
            torch.testing.assert_close(getattr(a, f).cpu(), getattr(b, f).cpu(), rtol=1e-4, atol=1e-4)

    for na in (False, True):
        config = with_functors(serving_config(precision="fp32", mean_log=1.0, std_log=0.1, sizes=(5, 8, 6, 3),
                                              hidden_size=32, head_dim=8, intermediate_size=64, seq_window_size=4,
                                              **(NA_OVERRIDES if na else {})))  # fmt: skip
        model = init_params_from_seed(build_model(config), seed=1, std=0.15)
        with torch.no_grad():
            model.output_layer.TTE_layer.proj.weight.mul_(0.02)
        rng = np.random.default_rng(1)
        prompts = with_functor_elements(synthetic_prompts(rng, 6, config, (6, 12), (4, 8)), config, rng)
        variants = [("NA engine", {})] if na else [("CI engine, paged, a fork", dict(paged_kv=True, block_size=4)),
                                                   ("CI spec, strict", "spec")]  # fmt: skip
        if not na:
            rows = [p for p, _ in with_functor_elements(synthetic_prompts(rng, 4, config, (10, 10), (6, 6)), config, rng)]
            batch = EventStreamBatch(**{f: torch.cat([getattr(r, f) for r in rows]) for f, x in vars(rows[0]).items()
                                        if x is not None})  # fmt: skip
            greedy, gu.sample_predictions = gu.sample_predictions, functools.partial(gu.sample_predictions, greedy=True)
            try:
                got = {dev: gu.generate(copy.deepcopy(model).to(dev), batch, config, seed=3, max_new_events=6,
                                        device=dev) for dev in ("cuda", "cpu")}  # fmt: skip
            finally:
                gu.sample_predictions = greedy
            same(got["cuda"], got["cpu"], "generate()")
            done.append("CI generate()")
        for name, extra in variants:
            res = {}
            for dev in ("cuda", "cpu"):
                kw = dict(n_slots=8, max_len=24, max_prompt_len=16, min_bucket=4, decode_chunk=4, greedy=True)
                if extra == "spec":
                    dcfg, draft = truncated_draft(config, model, 1)
                    kw["spec"] = SpecConfig(model=draft, config=dcfg, k=3, value_rtol=0.0, value_atol=0.0)
                else:
                    kw.update(extra)
                eng = GenerationEngine(model, config, template=prompts[0][0], device=dev, **kw)
                reqs = [Request(prompt=p, max_new_events=b, request_id=i) for i, (p, b) in enumerate(prompts)]
                if kw.get("paged_kv"):
                    eng.fork(prompts[0][0], 3, 6, key=5, request_id="f")
                res[dev] = {r.request_id: r for r in eng.run(reqs)}
            check(sorted(res["cuda"], key=str) == sorted(res["cpu"], key=str), f"phase 19 (b) [{name}]: results")
            for i, r in res["cuda"].items():
                check(r.error is None and (r.n_events, r.n_generated) == (res["cpu"][i].n_events, res["cpu"][i].n_generated),
                      f"phase 19 (b) [{name}]: request {i}")  # fmt: skip
                same(r.batch, res["cpu"][i].batch, f"{name}, request {i}")
            check_functor_elements(list(res["cuda"].values()), config, f"phase 19 (b) [{name}]")
            done.append(name)
    return done


def zero_shot_runs(smi) -> dict:
    """Phase 19 (c): `train(cfg)` on the committed converted sample cohort,
    then `zero_shot_evaluation` on its ``high_utilization`` task through the
    paged engine and through `generate()` (module docstring)."""
    import tempfile

    import torch

    import eventstreamgpt_tpu_torch.training.zero_shot_evaluator as zs
    from eventstreamgpt_tpu_torch.data.synthetic import serving_config
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
    from eventstreamgpt_tpu_torch.generation.sampling import derive_request_seed
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical_stream
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd
    from eventstreamgpt_tpu_torch.serving import GenerationEngine, Request
    from eventstreamgpt_tpu_torch.training.checkpoint import load_pretrained
    from eventstreamgpt_tpu_torch.training.fine_tuning import FinetuneConfig

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for fn in (vocab_gather_fwd, vocab_gather_bwd):
            fn.launches = 0
        train = pretrain_run("phase 19 (c)", pretrain_cfg(tmp / "pretrained", FUNCTOR_DATA, epochs=2, batch=32,
                                                          seq=ZS_SEQ), lambda: serving_config(precision="bf16"))  # fmt: skip
        out["launches_c"] = {"fwd": vocab_gather_fwd.launches, "bwd": vocab_gather_bwd.launches}
        tuning = [r for r in train["log"] if r["split"] == "tuning"]
        check(len(tuning) == 2 and all(math.isfinite(r["tuning_loss"]) for r in tuning)
              and tuning[-1]["graph_captures"] >= 1, f"phase 19 (c): train(cfg) {tuning}")  # fmt: skip
        # Kernel C gathers the multivariate regression plane; the cohort's numeric measurements are univariate.
        config = json.loads((tmp / "pretrained" / "config.json").read_text())
        multivariate = any(m["modality"] == "multivariate_regression" for m in config["measurement_configs"].values())
        check((out["launches_c"]["bwd"] > 0) == multivariate,
              f"phase 19 (c): kernel C launched {out['launches_c']} times, multivariate regression {multivariate}")  # fmt: skip
        calls = []
        real = zs.get_generative_predictions

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = real(*args, **dict(kw, return_generated=True))
            torch.cuda.synchronize()
            gen = res[2]
            calls.append(dict(wall_s=time.perf_counter() - t0, rows=gen.batch_size,
                              generated=int(gen.event_mask[:, ZS_SEQ:].sum())))  # fmt: skip
            return res[:2]

        zs.get_generative_predictions = timed
        try:
            for use_engine in (True, False):
                name = "paged engine" if use_engine else "generate()"
                cfg = FinetuneConfig(load_from_model_dir=tmp / "pretrained", task_df_name=ZS_TASK, seed=SEED,
                                     save_dir=tmp / f"zs_{use_engine}",
                                     data_config_overrides={"seq_padding_side": "left",
                                                            "subsequence_sampling_strategy": "to_end"},
                                     config_overrides={"max_seq_len": ZS_SEQ + ZS_NEW},
                                     task_specific_params={"num_samples": ZS_SAMPLES},
                                     optimization_config={"validation_batch_size": ZS_BATCH})  # fmt: skip
                calls.clear()
                fused_categorical_stream.launches = 0
                t0 = time.perf_counter()
                tuning_m, held_out_m = zs.zero_shot_evaluation(cfg, use_engine=use_engine, device="cuda")
                wall = time.perf_counter() - t0
                for split, m in (("tuning", tuning_m), ("held_out", held_out_m)):
                    written = json.loads((cfg.save_dir / f"zero_shot_{split}_metrics.json").read_text())
                    check(written == m and f"{split}_frac_unpredictable" in m, f"phase 19 (c) [{name}]: {split} metrics")
                check(len(calls) == 2 and all(c["rows"] == ZS_BATCH * ZS_SAMPLES for c in calls),
                      f"phase 19 (c) [{name}]: generation calls {calls}")  # fmt: skip
                generated = sum(c["generated"] for c in calls)
                out[name] = dict(wall_s=wall, split_wall_s=[c["wall_s"] for c in calls], generated=generated,
                                 events_per_s=generated / sum(c["wall_s"] for c in calls),
                                 frac_unpredictable=[tuning_m["tuning_frac_unpredictable"],
                                                     held_out_m["held_out_frac_unpredictable"]],
                                 metrics={**tuning_m, **held_out_m}, launches_a=fused_categorical_stream.launches)  # fmt: skip
                check(out[name]["launches_a"] > 0, f"phase 19 (c) [{name}]: kernel A never launched")
        finally:
            zs.get_generative_predictions = real
        # One subject's fork equals its per-(subject, sample) requests with the fork's seeds.
        model, config = load_pretrained(tmp / "pretrained", device="cuda")
        config.max_seq_len = ZS_SEQ + ZS_NEW
        ds = TorchDataset(cfg.data_config, "tuning")
        batch = next(ds.batches(1, shuffle=False, seed=0))
        kw = dict(template=batch, n_slots=ZS_SAMPLES, max_len=ZS_SEQ + ZS_NEW, max_prompt_len=ZS_SEQ, paged_kv=True,
                  block_size=16, device="cuda")  # fmt: skip
        forked = zs._generate_via_engine(GenerationEngine(model, config, **kw), batch, 11, ZS_SAMPLES, ZS_NEW)
        ref = GenerationEngine(model, config, **kw)
        ref.scheduler.group_sizes = (ZS_SAMPLES,)
        res = {r.request_id: r for r in ref.run([
            Request(prompt=batch, max_new_events=ZS_NEW, request_id=j,
                    key=derive_request_seed(derive_request_seed(11, 0), j)) for j in range(ZS_SAMPLES)])}  # fmt: skip
        for j, r in res.items():
            for f in ("event_mask", "time_delta", "dynamic_indices", "dynamic_values"):
                check(torch.equal(getattr(forked, f)[j, : r.n_events], getattr(r.batch, f)[0]),
                      f"phase 19 (c): branch {j}'s {f} differs from its per-request run")  # fmt: skip
    check(not any(m in sys.modules for m in ("pandas", "pyarrow")), "phase 19 (c): pandas or pyarrow was imported")
    print(f"phase 19 (c): train(cfg) on the converted sample cohort ({ZS_SEQ}-event rows, batches of 32, 2 epochs) "
          f"in {train['wall']:.2f} s, kernel C {out['launches_c']} through the replays (it gathers a multivariate "
          f"regression plane: the cohort's numeric measurements are univariate); zero-shot on "
          f"{ZS_TASK}, {ZS_SAMPLES} samples of {ZS_NEW} new events a subject, {ZS_BATCH} subjects a batch "
          f"({ZS_BATCH * ZS_SAMPLES} rows): {json.dumps({k: out[k] for k in ('paged engine', 'generate()')})}; "
          f"one subject's fork equals its {ZS_SAMPLES} per-request runs bit for bit; no pandas or pyarrow ({smi})",
          flush=True)  # fmt: skip
    return out


def functor_phase(smi, model, config) -> dict:
    """Phase 19: functor measurements in generation and zero-shot evaluation (module docstring)."""
    t0 = time.perf_counter()
    a = functor_serving_runs(smi, model, config)
    t1 = time.perf_counter()
    b = small_functor_engines_match_cpu()
    t2 = time.perf_counter()
    print(f"phase 19 (b): small fp32 greedy runs with both functors on the card match the CPU ({', '.join(b)}): "
          f"events and integers exact, floats within 1e-4; every generated event's functor elements checked",
          flush=True)  # fmt: skip
    c = zero_shot_runs(smi)
    t3 = time.perf_counter()
    print(f"phase 19: passed in {t3 - t0:.1f} s ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f})", flush=True)
    return dict(launches_a=a["launches_a"] + c["paged engine"]["launches_a"] + c["generate()"]["launches_a"],
                launches_b=a["launches_b"], launches_c=c["launches_c"])


# ---------------------------------------------------------------- phase 20
FT_BINARY, FT_QUARTILE = "long_history", "history_quartile"  # phase 20's task frames


def write_task_frames(cache) -> dict:
    """Two task frames in the converted format (``task_dfs/{name}.npz``) over
    every subject's whole record: ``long_history`` (binary: more events than
    the cohort's median) and ``history_quartile`` (the quartile of the event
    count, 0-3). Returns each task's label counts."""
    import numpy as np

    from eventstreamgpt_tpu_torch.data.dl_cache import read_dl_cache

    cols = {"subject_id": [], "start_time": [], "end_time": [], "n": []}
    for split in ("train", "tuning", "held_out"):
        reps = read_dl_cache(cache, split)
        time_col = reps.lists["time"]
        off, vals = np.asarray(time_col.offsets, np.int64), np.asarray(time_col.values, np.float64)
        start = reps.scalars["start_time"].astype(np.int64)
        cols["subject_id"].append(reps.scalars["subject_id"].astype(np.int64))
        cols["start_time"].append(start)
        # The window ends a minute after the last event (minutes since the start, fp64), so it holds every event.
        cols["end_time"].append(start + ((vals[off[1:] - 1] + 1.0) * 60e9).astype(np.int64))
        cols["n"].append(np.diff(off))
    cols = {k: np.concatenate(v) for k, v in cols.items()}
    n = cols.pop("n")
    quartiles = np.quantile(n, [0.25, 0.5, 0.75])
    labels = {FT_BINARY: n > quartiles[1], FT_QUARTILE: np.searchsorted(quartiles, n, side="right").astype(np.int64)}
    (Path(cache) / "task_dfs").mkdir(exist_ok=True)
    for name, label in labels.items():
        np.savez(Path(cache) / "task_dfs" / f"{name}.npz", **cols, **{name: label})
    return {name: np.bincount(label.astype(np.int64)).tolist() for name, label in labels.items()}


def ft_cfg(pretrained_dir, save_dir, task, epochs, pooling, batch=TRAIN_BATCH, final=True, config_overrides=None,
           oc=None, **tc):  # fmt: skip
    """Fine-tuning from ``pretrained_dir`` with phase 18's optimizer settings
    (rate 1e-3, warmup 0.1), batches of ``batch``, a log record every 4 steps
    and a kept checkpoint every 8."""
    from eventstreamgpt_tpu_torch.training.fine_tuning import FinetuneConfig

    return FinetuneConfig(
        load_from_model_dir=pretrained_dir, task_df_name=task, seed=SEED, save_dir=Path(save_dir),
        optimization_config=dict(init_lr=1e-3, batch_size=batch, validation_batch_size=batch, max_epochs=epochs,
                                 lr_frac_warmup_steps=0.1, **(oc or {})),
        trainer_config={"log_every_n_steps": 4, "checkpoint_every_n_steps": 8, "max_checkpoints_to_keep": 100, **tc},
        task_specific_params={"pooling_method": pooling}, config_overrides=config_overrides or {},
        do_final_validation_on_metrics=final,
    )  # fmt: skip


def ft_run(label, cfg, device="cuda") -> dict:
    """One fine-tuning `train(cfg)`: its outputs, log, weights and wall seconds."""
    import torch

    from eventstreamgpt_tpu_torch.training.fine_tuning import train

    t0 = time.perf_counter()
    out = train(cfg, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    save = Path(cfg.save_dir)
    weights = torch.load(save / "pretrained_weights" / "model.pt", map_location="cpu", weights_only=True)
    return dict(label=label, out=out, log=read_train_log(save), weights=weights, wall=wall, save=save)


def check_ft_run(run, label, steps, captures=1) -> None:
    """Finite logged losses, a log window every 4 steps, ``captures`` captures
    after each epoch and, with the final validation, finite metrics files."""
    windows = [r for r in run["log"] if r["split"] == "train"]
    epochs = [r for r in run["log"] if r["split"] == "tuning"]
    check([r["step"] for r in windows] == list(range(4, steps + 1, 4))
          and all(math.isfinite(r["train_loss"]) for r in windows)
          and all(math.isfinite(r["tuning_loss"]) for r in epochs),
          f"{label}: the train log {run['log']}")  # fmt: skip
    check([r["graph_captures"] for r in epochs] == [captures] * len(epochs),
          f"{label}: captures after each epoch {[r['graph_captures'] for r in epochs]}, not {captures}")  # fmt: skip
    if run["out"][0] is None:
        return
    for split, metrics in (("tuning", run["out"][1]), ("held_out", run["out"][2])):
        written = json.loads((run["save"] / f"{split}_metrics.json").read_text())
        check(written == metrics and all(math.isfinite(v) for v in metrics.values())
              and f"{split}_loss" in metrics and any("accuracy" in k for k in metrics)
              and any("AUROC" in k for k in metrics) and any("AUPRC" in k for k in metrics),
              f"{label}: {split} metrics {metrics}")  # fmt: skip


def embeddings_run(label, pretrained_dir, device="cuda", batch=TRAIN_BATCH, **kw) -> tuple:
    """`get_embeddings` (``last`` pooling, the binary task's windows) of
    ``pretrained_dir``, overwriting: ``(arrays a split, stats)``."""
    import numpy as np

    from eventstreamgpt_tpu_torch.training.embedding import get_embeddings
    from eventstreamgpt_tpu_torch.training.fine_tuning import FinetuneConfig

    cfg = FinetuneConfig(load_from_model_dir=pretrained_dir, task_df_name=FT_BINARY, do_overwrite=True,
                         optimization_config={"validation_batch_size": batch},
                         task_specific_params={"pooling_method": "last"})  # fmt: skip
    stats: dict = {}
    files = get_embeddings(cfg, device=device, stats=stats, **kw)
    return {sp: np.load(f) for sp, f in files.items()}, stats, cfg


def small_fine_tuning_matches_cpu(tmp) -> dict:
    """Phase 20 (g): small fp32 CI and NA classifiers (hidden 32, dropout 0;
    the NA model one head of 32, kernel D's narrowest) fine-tuned 4 steps
    and their embeddings, on the card and on the CPU, within 1e-4."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.convert import init_params_from_seed
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.synthetic import NA_OVERRIDES, serving_config, write_synthetic_cache
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
    from eventstreamgpt_tpu_torch.training import build_model, save_pretrained

    cache = write_synthetic_cache(tmp / "small_cache", {"train": 32, "tuning": 8, "held_out": 8}, n_event_types=5,
                                  n_labs=40, n_meds=6, n_static=16, mean_seq_len=20, max_seq_len=40, seed=SEED)  # fmt: skip
    write_task_frames(cache)
    data_config = PytorchDatasetConfig(save_dir=cache, max_seq_len=16, min_seq_len=4)
    out = {}
    for mode, extra in (("CI", dict(head_dim=8)), ("NA", dict(num_attention_heads=1, head_dim=32, **NA_OVERRIDES))):
        config = serving_config(precision="fp32", attention_dropout=0.0, input_dropout=0.0, resid_dropout=0.0,
                                **{**PRETRAIN_SMALL, **extra})  # fmt: skip
        config.set_to_dataset(TorchDataset(data_config, "train"))
        pre = tmp / f"small_pre_{mode}"
        save_pretrained(pre, init_params_from_seed(build_model(config), seed=SEED, std=0.1), config)
        data_config.to_json_file(pre / "data_config.json", do_overwrite=True)
        runs, embs = {}, {}
        for dev in ("cuda", "cpu"):
            cfg = ft_cfg(pre, tmp / f"small_ft_{mode}_{dev}", FT_BINARY, 1, "last", batch=4,
                         oc={"max_training_steps": 4}, log_every_n_steps=2)  # fmt: skip
            runs[dev] = ft_run(f"phase 20 (g) {mode} {dev}", cfg, device=dev)
            embs[dev] = embeddings_run(f"(g) {mode} {dev}", pre, device=dev, batch=4)[0]
        gpu_l, cpu_l = ({r["step"]: r["train_loss"] for r in runs[dev]["log"] if r["split"] == "train"}
                        for dev in ("cuda", "cpu"))  # fmt: skip
        check(sorted(cpu_l) == [2, 4] and sorted(gpu_l) == sorted(cpu_l)
              and all(abs(gpu_l[k] - cpu_l[k]) <= 1e-4 * max(1, abs(cpu_l[k])) for k in cpu_l),
              f"phase 20 (g) {mode}: losses on the card {gpu_l} vs the CPU {cpu_l}")  # fmt: skip
        w_gpu, w_cpu = runs["cuda"]["weights"], runs["cpu"]["weights"]
        w_worst = max(float((w_gpu[k] - w_cpu[k]).abs().max()) for k in w_cpu)
        e_worst = max(float(np.abs(embs["cuda"][sp] - embs["cpu"][sp]).max()) for sp in embs["cpu"])
        check(w_worst <= 1e-4 and e_worst <= 1e-4,
              f"phase 20 (g) {mode}: card vs CPU: weights differ by {w_worst}, embeddings by {e_worst}")  # fmt: skip
        out[mode] = dict(weights=w_worst, embeddings=e_worst)
    return out


def fine_tuning_phase(smi, pre: dict) -> dict:
    """Phase 20: fine-tuning and embeddings from phase 18's save_dirs (module docstring)."""
    import numpy as np
    import torch

    import eventstreamgpt_tpu_torch.training.fine_tuning as ft_module
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
    from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
    from eventstreamgpt_tpu_torch.models.fine_tuning_model import ESTForStreamClassification, lecun_normal_
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_window_bwd,
        flash_attention_window_fwd,
    )
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd
    from eventstreamgpt_tpu_torch.training.checkpoint import load_pretrained

    counters = (dep_graph_fwd, dep_graph_bwd, flash_attention_fwd, flash_attention_bwd, flash_attention_window_fwd,
                flash_attention_window_bwd, vocab_gather_fwd, vocab_gather_bwd)  # fmt: skip

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts() -> dict:
        return {fn.__name__: fn.launches for fn in counters if fn.launches}

    tmp = Path(pre["cache"]).parent
    times = {}
    t0 = time.perf_counter()
    labels = write_task_frames(pre["cache"])
    times["a"] = time.perf_counter() - t0
    steps, evals = 16, 2  # an epoch of 512 subjects in batches of 32; 64 tuning (held-out) subjects, 2 batches

    # (b) CI, binary, `last` pooling, 2 epochs; the model right after the graft kept
    grafted = {}
    graft = ft_module.init_from_pretrained_encoder

    def watched(model, pretrained_dir):
        graft(model, pretrained_dir)
        grafted.update({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
        return model

    zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ft_module.init_from_pretrained_encoder = watched
    try:
        t0 = time.perf_counter()
        b = ft_run("(b)", ft_cfg(pre["save_a"], tmp / "ft_b", FT_BINARY, 2, "last"))
    finally:
        ft_module.init_from_pretrained_encoder = graft
    times["b"] = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(counts() == {}, f"phase 20 (b): the CI classifier launched {counts()} (no kernel is on its path)")
    check_ft_run(b, "phase 20 (b)", 2 * steps)
    pretrained = torch.load(pre["save_a"] / "pretrained_weights" / "model.pt", map_location="cpu", weights_only=True)
    encoder = [k for k in grafted if k.startswith("encoder.")]
    check(encoder and all(torch.equal(grafted[k], pretrained[k]) for k in encoder),
          "phase 20 (b): an encoder weight differs from the pretrained save_dir's after the graft")  # fmt: skip
    hidden = grafted["logit_layer.weight"].shape[1]
    check(torch.equal(grafted["logit_layer.weight"], lecun_normal_(torch.empty(1, hidden), SEED))
          and not grafted["logit_layer.bias"].any(), "phase 20 (b): the logit layer is not flax Dense's fresh draw")  # fmt: skip
    live = checkpoint_state(b["save"], 2 * steps)["params"]
    config = StructuredTransformerConfig.from_json_file(b["save"] / "config.json")
    loaded, _ = load_pretrained(b["save"], model=ESTForStreamClassification(config), device="cuda")
    check(same_tensors({k: t.cpu() for k, t in loaded.state_dict().items()}, live) and same_tensors(b["weights"], live),
          "phase 20 (b): load_pretrained's weights are not the live weights")  # fmt: skip

    # (c) resume at epoch 1 past 8 batches from (b)'s checkpoint 24
    meta = json.loads((b["save"] / "model_checkpoints" / "metadata_24.json").read_text())
    check(meta == {"epoch": 1, "epoch_complete": False, "step_in_epoch": 8}, f"phase 20 (c): step 24's metadata {meta}")
    t0 = time.perf_counter()
    c = ft_run("(c)", ft_cfg(pre["save_a"], seed_save_dir(b, tmp / "ft_c", (24,)), FT_BINARY, 2, "last"))
    times["c"] = time.perf_counter() - t0
    same_as(c, b, "phase 20 (c) [resume at 24]", after=24, adam_step=2 * steps)

    # (d) NA, 4 classes, `mean` pooling, one epoch: kernel D in every layer of every forward
    zero()
    t0 = time.perf_counter()
    d = ft_run("(d)", ft_cfg(pre["save_g"], tmp / "ft_d", FT_QUARTILE, 1, "mean"))
    times["d"] = time.perf_counter() - t0
    d_launches = counts()
    layers = json.loads((pre["save_g"] / "config.json").read_text())["num_hidden_layers"]
    want_d = {"dep_graph_fwd": layers * (steps + evals + evals), "dep_graph_bwd": layers * steps}
    check(d_launches == want_d, f"phase 20 (d): launches {d_launches}, expected {want_d} (16 steps, 2 tuning and 2 "
                                f"held-out batches, {layers} layers)")  # fmt: skip
    check_ft_run(d, "phase 20 (d)", steps)
    check(d["out"][1] is not None and "tuning_macro_AUROC" in d["out"][1], f"phase 20 (d): 4-class metrics {d['out']}")

    # (e) CI under pallas_flash, attention dropout 0, `max` pooling, one epoch: kernel E in the global layer
    zero()
    t0 = time.perf_counter()
    e = ft_run("(e)", ft_cfg(pre["save_a"], tmp / "ft_e", FT_BINARY, 1, "max",
                             config_overrides={"attention_implementation": "pallas_flash", "attention_dropout": 0.0}))  # fmt: skip
    times["e"] = time.perf_counter() - t0
    e_launches = counts()
    e_config = StructuredTransformerConfig.from_json_file(e["save"] / "config.json")
    n_global = e_config.seq_attention_layers.count("global")
    want_e = {"flash_attention_fwd": n_global * (steps + evals + evals), "flash_attention_bwd": n_global * steps}
    check(e_launches == want_e, f"phase 20 (e): launches {e_launches}, expected {want_e} (the local window "
                                f"{e_config.seq_window_size} <= 128 runs the band, not kernel F)")  # fmt: skip
    check_ft_run(e, "phase 20 (e)", steps)

    # (f) embeddings, `last` pooling: CI from (a)'s save_dir, NA (kernel D) from (g)'s; captured against eager
    emb = {}
    for mode, pre_dir in (("CI", pre["save_a"]), ("NA", pre["save_g"])):
        zero()
        t0 = time.perf_counter()
        captured, stats, cfg = embeddings_run(f"(f) {mode}", pre_dir)
        wall = time.perf_counter() - t0
        launches = counts()
        eager, _, _ = embeddings_run(f"(f) {mode} eager", pre_dir, cuda_graph=False)
        for sp, arr in captured.items():
            n = len(TorchDataset(cfg.data_config, sp))
            check(arr.shape == (n, cfg.config.hidden_size) and np.isfinite(arr).all(),
                  f"phase 20 (f) {mode}: {sp} embeddings {arr.shape}, {n} subjects")  # fmt: skip
            check(np.array_equal(arr, eager[sp]), f"phase 20 (f) {mode}: {sp}'s captured embeddings differ from eager")
        batches = sum(-(-stats[f"{sp}_subjects"] // TRAIN_BATCH) for sp in captured)
        check(stats["graph_captures"] == 1 and stats["graph_replays"] == batches - 1,
              f"phase 20 (f) {mode}: {stats}, {batches} batches")  # fmt: skip
        want = {"dep_graph_fwd": layers * batches} if mode == "NA" else {}
        check(launches == want, f"phase 20 (f) {mode}: launches {launches}, expected {want}")
        emb[mode] = dict(wall_s=wall, launches=launches, **{f"{sp} subjects/s": stats[f"{sp}_subjects"] / stats[f"{sp}_s"]
                                                            for sp in captured})  # fmt: skip
    times["f"] = sum(v["wall_s"] for v in emb.values())

    # (g) small fp32 classifiers, card against CPU
    t0 = time.perf_counter()
    small = small_fine_tuning_matches_cpu(tmp)
    times["g"] = time.perf_counter() - t0
    check("pandas" not in sys.modules and "pyarrow" not in sys.modules, "phase 20: pandas or pyarrow was imported")

    def windows_ms(run) -> list:
        return [round(r["step_time_ms"], 3) for r in run["log"] if r["split"] == "train"]

    metrics = {k: round(v, 4) for run in (b, d, e) for part in run["out"][1:] for k, v in part.items()}
    print(f"phase 20: fine-tuning from phase 18's save_dirs (task label counts {labels}), B={TRAIN_BATCH}, "
          f"L={TRAIN_SEQ}, bf16, dropout 0.1: (b) CI binary `last`, 2 epochs: {epochs_line(b)}; captured step ms a "
          f"window {windows_ms(b)}; graft bit for bit, logit layer fresh; (c) resume at 24 equals (b) bit for bit "
          f"(weights, AdamW, log, metrics); (d) NA 4-class `mean`: {epochs_line(d)}, step ms {windows_ms(d)}, kernel D "
          f"{d_launches}; (e) CI pallas_flash `max`: {epochs_line(e)}, step ms {windows_ms(e)}, kernel E "
          f"{e_launches}; (f) embeddings (captured = eager bit for bit): {json.dumps(emb)}; (g) small fp32 card vs "
          f"CPU max diffs {json.dumps(small)}; metrics {json.dumps(metrics)}; peak memory (b) {peak_gb:.3f} GB; "
          f"seconds {json.dumps({k: round(v, 2) for k, v in times.items()})} ({smi})", flush=True)  # fmt: skip
    return dict(launches={k: d_launches.get(k, 0) + e_launches.get(k, 0) + emb["NA"]["launches"].get(k, 0)
                          for k in ("dep_graph_fwd", "dep_graph_bwd", "flash_attention_fwd", "flash_attention_bwd")})


# ---------------------------------------------------------------- phase 21
# bench.py's production-width probe (`wide_config_for`, bench.py:1446-1463): hidden 1,024, 12 layers of
# 8 heads of 128, intermediate 4,096, on the packed rows under pallas_flash (attention dropout 0, bf16).
PROBE_WIDTHS = dict(hidden_size=1024, head_dim=128, num_attention_heads=8, num_hidden_layers=12,
                    intermediate_size=4096)
PROBE_POLICIES = ("none", "block", "dots_no_batch", "save_attention")
PROBE_STEPS, PROBE_TIMED = 3, 5  # the compared steps (warm-up, capture, replay), then replays timed


class HostMasks:
    """A dropout source whose keep masks are drawn on the CPU from a seeded
    generator and moved to the tensor's device: the card and the CPU draw the
    same masks (`ops.tensor_ops.keep_mask`)."""

    def __init__(self, seed: int):
        import torch

        self.generator = torch.Generator().manual_seed(seed)

    def keep(self, shape, keep_prob, device):
        import torch

        return (torch.rand(shape, generator=self.generator) < keep_prob).to(device)


def probe_config(ds, policy: str, scan: bool = False):
    """bench.py's `wide_config_for(policy)` over the synthetic cohort's vocabulary, set to its train split."""
    from eventstreamgpt_tpu_torch.data.synthetic import PACKED_OVERRIDES, serving_config

    config = serving_config(precision="bf16", **PACKED_OVERRIDES, **PROBE_WIDTHS,
                            gradient_checkpointing=policy, scan_layers=scan)  # fmt: skip
    config.set_to_dataset(ds)
    config.max_seq_len = PACKED_SEQ
    return config


def probe_run(label, config, batch, load, counters, capture=None) -> dict:
    """`PROBE_STEPS` captured steps (the first eager, the second captured) of
    the model ``load`` fills, then `PROBE_TIMED` timed replays; the peak
    memory of the steps above what was allocated before the first (the
    weights, and what earlier runs still hold; AdamW's state, made in the
    first step, counts), the launches of
    ``counters`` in the compared steps, and the final weights and AdamW
    tensors (on the card) of the compared steps."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.models.config import OptimizationConfig
    from eventstreamgpt_tpu_torch.training import build_model, build_optimizer, make_train_step

    with torch.device("cuda"):
        model = build_model(config)
    load(model)
    oc = OptimizationConfig(init_lr=1e-3, batch_size=PACKED_BATCH, max_epochs=3, lr_frac_warmup_steps=0.1)
    oc.set_to_dataset(range(COHORT))
    optimizer, scheduler = build_optimizer(model, oc)
    step = make_train_step(model, optimizer, scheduler, with_health=True)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    healths = []
    for i in range(PROBE_STEPS):
        if capture is not None:
            capture.armed = i == 0
        healths.append(step(batch, SEED)[1])
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = {fn.__name__: fn.launches for fn in counters}
    if capture is not None:
        capture.restore()
    s = step.stats()
    check((s["graph_warmup_steps"], s["graph_captures"], s["graph_replays"]) == (1, 1, PROBE_STEPS - 1),
          f"{label}: the step was not warmed up, captured and replayed: {s}")  # fmt: skip
    weights = [p.detach().clone() for p in model.parameters()]
    adam = [t.detach().clone() for p in model.parameters() for t in (optimizer.state[p]["exp_avg"],
                                                                      optimizer.state[p]["exp_avg_sq"])]  # fmt: skip
    walls = []
    for _ in range(PROBE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, SEED)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    healths = torch.stack(healths).cpu()
    check(bool(torch.isfinite(healths).all()), f"{label}: a loss or gradient norm is not finite: {healths.tolist()}")
    del step, optimizer, scheduler, model
    return dict(healths=healths, weights=weights, adam=adam, launches=launches, peak_gb=peak_gb,
                step_ms=float(np.median(walls)) * 1e3)


def same_run(a, b) -> bool:
    import torch

    return torch.equal(a["healths"], b["healths"]) and all(
        torch.equal(x, y) for x, y in zip(a["weights"] + a["adam"], b["weights"] + b["adam"]))


def free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def small_remat_step_matches_cpu():
    """(f): one fp32 step of the small CI model (hidden 32) under ``block``
    with dropout 0.1 on the card against the same step on the CPU, the keep
    masks drawn on the CPU for both (`HostMasks`): loss and every gradient
    within 1e-4 (gradients, as phase 4's small step: Adam's first update
    moves a noise-level gradient's element by the rate either way)."""
    import copy

    base, batch = small_fp32_setup(False, hidden_size=32, head_dim=8)
    base.config.gradient_checkpointing = "block"
    base.config.input_dropout = base.config.resid_dropout = base.config.attention_dropout = 0.1
    for mod in base.modules():
        for attr in ("input_dropout", "resid_dropout", "attention_dropout"):
            if hasattr(mod, attr):
                setattr(mod, attr, 0.1)
    out = []
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(base).to(dev)
        loss = model(batch.map(lambda t: t.to(dev)), is_generation=False, dropout=HostMasks(SEED)).loss
        loss.backward()
        out.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    steps_match(out[0], out[1], 1e-4, "phase 21 (f): small fp32 block-remat step with dropout, card vs CPU")
    return out[1][0], grad_diff(out[0], out[1])


def remat_scan_phase(smi, pre: dict) -> dict:
    """Phase 21: remat and scan at bench.py's width-1024 probe (module docstring)."""
    import numpy as np
    import torch

    import eventstreamgpt_tpu_torch.models.transformer as transformer_module
    from eventstreamgpt_tpu_torch.convert import export_params, init_params_from_seed, load_jax_params
    from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
    from eventstreamgpt_tpu_torch.data.synthetic import na_training_config
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
    from eventstreamgpt_tpu_torch.ops import flash_attention as fa
    from eventstreamgpt_tpu_torch.ops.dep_graph import dep_graph_bwd, dep_graph_fwd
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd
    from eventstreamgpt_tpu_torch.training import build_model

    t0 = time.perf_counter()
    ds = TorchDataset(PytorchDatasetConfig(save_dir=pre["cache"], max_seq_len=PACKED_SEQ, min_seq_len=4), "train")
    batch = next(ds.packed_batches(PACKED_BATCH, PACKED_SEQ, seed=1)).map(lambda t: t.cuda())
    events = int(batch.event_mask.sum())
    base = probe_config(ds, "none")
    check(base.seq_attention_layers == ["local", "global"] * 6 and base.seq_window_size == 32
          and base.attention_dropout == 0.0 and base.resid_dropout == 0.1 and base.precision == "bf16",
          "phase 21: not bench.py's width-1024 probe")  # fmt: skip
    init = init_params_from_seed(build_model(base), seed=SEED).state_dict()
    n_params = sum(t.numel() for t in init.values())

    def load_init(model):
        model.load_state_dict(init)

    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd, vocab_gather_fwd, vocab_gather_bwd)
    n_global = base.seq_attention_layers.count("global")
    runs, flash_args = {}, None
    for policy in PROBE_POLICIES:
        capture = FlashCapture(transformer_module) if policy == "none" else None
        runs[policy] = probe_run(f"phase 21 (a) [{policy}]", probe_config(ds, policy), batch, load_init, counters,
                                capture)  # fmt: skip
        if capture is not None:
            flash_args = capture.args.get(None)
        free_cuda()
    check(flash_args is not None and flash_args["g"] is not None, "phase 21: kernel E's inputs were not captured")
    none = runs["none"]
    for policy, run in runs.items():
        check(same_run(run, none), f"phase 21 (a): {policy}'s losses, weights or AdamW tensors differ from none's: "
                                   f"{run['healths'].tolist()} vs {none['healths'].tolist()}")  # fmt: skip
        twice = policy in ("block", "dots_no_batch")
        want = {"flash_attention_fwd": PROBE_STEPS * n_global * (2 if twice else 1),
                "flash_attention_bwd": PROBE_STEPS * n_global,
                "vocab_gather_fwd": none["launches"]["vocab_gather_fwd"],
                "vocab_gather_bwd": none["launches"]["vocab_gather_bwd"]}  # fmt: skip
        check(run["launches"] == want, f"phase 21 (b) [{policy}]: launches {run['launches']}, expected {want}")
    check(none["launches"]["vocab_gather_fwd"] == PROBE_STEPS, f"phase 21: kernel C launches {none['launches']}")
    check(runs["block"]["peak_gb"] < none["peak_gb"],
          f"phase 21 (c): block's peak {runs['block']['peak_gb']:.3f} GB is not below none's {none['peak_gb']:.3f}")

    # (d) scan_layers under the faster selective policy, from a scanned tree built in numpy
    faster = min(("dots_no_batch", "save_attention"), key=lambda p: runs[p]["step_ms"])
    scan_config = probe_config(ds, faster, scan=True)

    def load_scanned(model):
        with torch.device("cuda"):
            holder = build_model(scan_config)
        holder.load_state_dict(init)
        tree = export_params(holder)  # the stacked (h_scan) layout JAX's scanned model holds
        check("h_scan" in tree["params"]["encoder"] and not any(k.startswith("h") and k[1:].isdigit()
                                                                for k in tree["params"]["encoder"]),
              "phase 21 (d): the exported tree is not the scanned layout")  # fmt: skip
        load_jax_params(model, tree)

    scanned = probe_run(f"phase 21 (d) [scan, {faster}]", scan_config, batch, load_scanned, counters)
    check(same_run(scanned, runs[faster]), f"phase 21 (d): the scanned model's steps differ from {faster}'s")
    check(scanned["launches"] == runs[faster]["launches"], f"phase 21 (d): launches {scanned['launches']}")
    free_cuda()

    # (e) phase 6's NA model under block against none, dropout 0.1
    na_batch = training_batch()
    na_runs = {}
    for policy in ("none", "block"):
        na_config = na_training_config([na_batch], gradient_checkpointing=policy)
        na_runs[policy] = probe_run(f"phase 21 (e) [NA, {policy}]", na_config, na_batch.map(lambda t: t.cuda()),
                                   lambda m: init_params_from_seed(m, seed=SEED), (dep_graph_fwd, dep_graph_bwd))
        free_cuda()
    layers = na_config.num_hidden_layers
    check(same_run(na_runs["block"], na_runs["none"]), "phase 21 (e): the NA model under block differs from none")
    check(na_runs["none"]["launches"] == {"dep_graph_fwd": PROBE_STEPS * layers,
                                          "dep_graph_bwd": PROBE_STEPS * layers}
          and na_runs["block"]["launches"] == {"dep_graph_fwd": 2 * PROBE_STEPS * layers,
                                               "dep_graph_bwd": PROBE_STEPS * layers},
          f"phase 21 (e): kernel D launches {na_runs['none']['launches']} / "
          f"{na_runs['block']['launches']}")  # fmt: skip

    small_loss, small_diff = small_remat_step_matches_cpu()
    na_events = int(na_batch.event_mask.sum())

    def row(r, n_events, kernel):
        return dict(step_ms=round(r["step_ms"], 3), events_per_s=round(n_events / (r["step_ms"] / 1e3), 1),
                    peak_gb=round(r["peak_gb"], 3), **{f"{kernel}_a_step": r["launches"][kernel] / PROBE_STEPS})

    rows = {**{p: row(r, events, "flash_attention_fwd") for p, r in {**runs, f"scan+{faster}": scanned}.items()},
            **{f"NA {p}": row(r, na_events, "dep_graph_fwd") for p, r in na_runs.items()}}
    print(f"phase 21: bench.py's width-1024 probe ({n_params} parameters; packed batch "
          f"{tuple(batch.event_mask.shape)}, "
          f"{events} real events; 12 layers local/global, 8 heads of 128): (a) every policy's 3 captured steps equal "
          f"none's bit for bit (losses {none['healths'][:, 0].tolist()}, weights, AdamW); (b) kernel E launches as "
          f"expected; (c) block's peak below none's; (d) scan_layers under {faster} from the scanned tree equals it "
          f"bit for bit; (e) NA block equals none, kernel D twice a layer a step forward; (f) small fp32 block step "
          f"with dropout card vs CPU: loss {small_loss:.6f}, max |grad diff| {small_diff:.3g}; per run "
          f"{json.dumps(rows)}; {time.perf_counter() - t0:.1f} s ({smi})", flush=True)  # fmt: skip
    launches = {k: sum(r["launches"].get(k, 0) for r in (*runs.values(), scanned))
                for k in ("flash_attention_fwd", "flash_attention_bwd", "vocab_gather_fwd", "vocab_gather_bwd")}
    launches.update({k: sum(r["launches"][k] for r in na_runs.values()) for k in ("dep_graph_fwd", "dep_graph_bwd")})
    return dict(launches=launches, flash_args=flash_args, rows=rows)


# ---------------------------------------------------------------- phase 22
TRAJ_SAMPLES, TRAJ_NEW, TRAJ_BATCH = 4, 32, 32
TRAJ_LAB = "lab"  # the measurement whose most frequent code is the MCF predicate


def trajectories_phase(smi, pre: dict, tmp: Path) -> dict:
    """Phase 22: trajectories and the MCF evaluation (module docstring)."""
    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.data.dl_cache import concat_dl_reps, read_dl_reps
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
    from eventstreamgpt_tpu_torch.evaluation import (
        GenerateConfig,
        crps,
        dl_frame,
        generate_trajectories,
        get_MCF_coordinates,
    )
    from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical_stream
    from eventstreamgpt_tpu_torch.training import build_model

    t0 = time.perf_counter()
    cfg = GenerateConfig(load_from_model_dir=pre["save_a"], save_dir=tmp / "trajectories",
                         task_specific_params={"num_samples": TRAJ_SAMPLES, "max_new_events": TRAJ_NEW},
                         optimization_config={"validation_batch_size": TRAJ_BATCH})  # fmt: skip
    heads = categorical_heads(build_model(StructuredTransformerConfig.from_json_file(pre["save_a"] / "config.json")))
    fused_categorical_stream.launches = 0
    stats: dict = {}
    out = generate_trajectories(cfg, device="cuda", stats=stats)
    launches_a = fused_categorical_stream.launches
    gen_s = time.perf_counter() - t0
    calls = sum(len(v) for v in stats.values())
    check(launches_a >= heads * TRAJ_NEW * calls > 0,
          f"phase 22 (a): kernel A launched {launches_a} times over {calls} generate() calls")  # fmt: skip

    t1 = time.perf_counter()
    mcf = {}
    for split in ("tuning", "held_out"):
        files = sorted(p.name for p in (out / split).iterdir())
        check(files == [f"sample_{i}_local_rank_0.npz" for i in range(TRAJ_SAMPLES)],
              f"phase 22 (a): {split} files {files}")  # fmt: skip
        ds = TorchDataset(cfg.data_config, split=split)
        prompts = concat_dl_reps([b.convert_to_DL() for b in ds.batches(TRAJ_BATCH, shuffle=False, drop_last=False,
                                                                         seed=0)])  # fmt: skip
        n = len(ds)
        control = dl_frame(prompts.take(np.arange(n)))
        samples = []
        for i in range(TRAJ_SAMPLES):
            reps = read_dl_reps(out / split / f"sample_{i}_local_rank_0.npz")
            check(reps.n_rows == n, f"phase 22 (a): {split} sample {i} holds {reps.n_rows} rows, not {n}")
            frame = dl_frame(reps)
            for r in range(n):
                k = len(control["dynamic_indices"][r])
                same = (frame["subject_id"][r] == control["subject_id"][r]
                        and frame["dynamic_indices"][r][:k] == control["dynamic_indices"][r]
                        and frame["dynamic_values"][r][:k] == control["dynamic_values"][r]
                        and frame["time"][r][:k] == control["time"][r])  # fmt: skip
                check(same, f"phase 22 (a): {split} sample {i} row {r}'s prompt differs from its input row")
                times = np.asarray(frame["time"][r])
                check(len(times) > k and bool(np.isfinite(times).all()) and bool((times[k:] > times[k - 1]).all()),
                      f"phase 22 (a): {split} sample {i} row {r}'s generated times {times[k - 1:].tolist()}")
            samples.append(frame)
        # (b) one lab predicate (the prompts' most frequent lab code), aligned at each subject's last prompt event
        lab_lo = ds.vocabulary_config.vocab_offsets_by_measurement[TRAJ_LAB]
        lab_hi = lab_lo + ds.vocabulary_config.vocab_sizes_by_measurement[TRAJ_LAB]
        codes = np.concatenate([np.asarray(sum(r, []), np.int64) for r in control["dynamic_indices"]])
        codes = codes[(codes >= lab_lo) & (codes < lab_hi)]
        lab = int(np.bincount(codes).argmax())
        control["control_align_idx"] = [len(t) - 1 for t in control["time"]]
        ids, ts, idx, c_censor, c_mcf, s_censor, s_mcf = get_MCF_coordinates(
            control, samples, {lab: True}, n_timestamps=64, rng=np.random.default_rng(SEED))  # fmt: skip
        T = len(ts) + 1
        check(c_censor.shape == (1, n, T) and c_mcf.shape == (1, n, T, 1) and s_censor.shape == (TRAJ_SAMPLES, n, T)
              and s_mcf.shape == (TRAJ_SAMPLES, n, T, 1) and len(ids) == n and idx == [lab],
              f"phase 22 (b): {split} MCF shapes {c_censor.shape} {c_mcf.shape} {s_censor.shape} {s_mcf.shape}")
        check(bool(c_censor[..., 0].all() and s_censor[..., 0].all()), f"phase 22 (b): {split} censor masks")
        populated = ~np.isnan(s_mcf)
        check(bool(populated.any() and np.isfinite(s_mcf[populated]).all()),
              f"phase 22 (b): {split} sample incidences not finite where populated")  # fmt: skip
        after = np.asarray(ts) > 0
        counts = np.nansum(s_mcf[:, :, 1:][:, :, after], axis=2)  # (samples, subjects, 1) after the prompt
        score = crps(counts, np.nansum(c_mcf[:, :, 1:][:, :, after], axis=2)[0])
        check(score.shape == (n, 1) and bool(np.isfinite(score).all()), f"phase 22 (b): {split} CRPS {score}")
        mcf[split] = dict(lab=lab, timestamps=len(ts), crps_mean=float(score.mean()),
                          mean_incidences_after=float(counts.mean()))  # fmt: skip
    mcf_s = time.perf_counter() - t1
    check("pandas" not in sys.modules and "pyarrow" not in sys.modules, "phase 22: pandas or pyarrow was imported")
    rates = {split: sum(e for e, _ in v) / sum(s for _, s in v) for split, v in stats.items()}
    print(f"phase 22: generate_trajectories from phase 18 (a)'s save_dir, {TRAJ_SAMPLES} samples of {TRAJ_NEW} new "
          f"events a subject, batches of {TRAJ_BATCH}: every split {TRAJ_SAMPLES} files, one row a subject, prompts "
          f"equal, generated times finite and later; kernel A {launches_a} launches over {calls} calls; generated "
          f"events/s {json.dumps({k: round(v, 1) for k, v in rates.items()})} (each call's host clock: "
          f"{json.dumps({k: [round(s, 3) for _, s in v] for k, v in stats.items()})} s); generation {gen_s:.2f} s; "
          f"MCF and CRPS {mcf_s:.2f} s {json.dumps(mcf)} ({smi})", flush=True)  # fmt: skip
    return dict(launches_a=launches_a, rates=rates, mcf_s=mcf_s)


ENTRY_CONFIG = dict(hidden_size=256, head_dim=64, intermediate_size=1024, seq_window_size=32,
                    num_attention_heads=4, num_hidden_layers=2, seq_attention_types=["local", "global"],
                    TTE_generation_layer_type="log_normal_mixture", TTE_lognormal_generation_num_components=3,
                    precision="bf16")  # phase 4's CI model (bench.py's serving and training widths), dropout 0.1
ENTRY_TRAJ_SAMPLES, ENTRY_TRAJ_NEW = 4, 32
SWEEP_EPOCHS, SIGTERM_EPOCHS = 3, 6


def config_args(prefix: str, values: dict) -> list:
    """``prefix.key=value`` overrides, each value as the sweep writes it (JSON)."""
    return [f"{prefix}.{k}={v if isinstance(v, str) else json.dumps(v)}" for k, v in values.items()]


def entry_points_phase(smi, pre: dict, tmp: Path) -> dict:
    """Phase 23: the port's entry points on the card (module docstring)."""
    import os
    import signal

    import numpy as np
    import torch

    from eventstreamgpt_tpu_torch.data.dl_cache import read_dl_reps
    from eventstreamgpt_tpu_torch.data.torch_dataset import TorchDataset
    from eventstreamgpt_tpu_torch.evaluation import GenerateConfig
    from eventstreamgpt_tpu_torch.ops.fused_sampling import fused_categorical_stream
    from eventstreamgpt_tpu_torch.ops.vocab_gather import vocab_gather_bwd, vocab_gather_fwd
    from eventstreamgpt_tpu_torch.reliability import EXIT_PREEMPTED
    from eventstreamgpt_tpu_torch.reliability.integrity import ReliableCheckpointManager
    from eventstreamgpt_tpu_torch.scripts import (
        finetune,
        generate_trajectories,
        get_embeddings,
        launch_hp_sweep,
        parse_cli,
        pretrain,
        zeroshot,
    )
    from eventstreamgpt_tpu_torch.utils import yaml_subset
    from eventstreamgpt_tpu_torch.utils.config_tool import load_config

    counters = (fused_categorical_stream, vocab_gather_fwd, vocab_gather_bwd)
    root = tmp / "entry_points"
    runs: dict = {}

    def run(name, main, args):
        """``main(args)`` with the counters zeroed before; its wall and launches."""
        for fn in counters:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = main(args)
        torch.cuda.synchronize()
        runs[name] = dict(wall=time.perf_counter() - t0, launches={fn.__name__: fn.launches for fn in counters})
        return out

    def launches(*names, kernel):
        return sum(runs[n]["launches"][kernel] for n in names)

    # (a) the chain through each main() on the committed converted sample cohort
    t_a = time.perf_counter()
    chain = root / "chain"
    pre_args = ["--config", str(REPO / "configs" / "pretrain_base.yaml"), f"data_config.save_dir={FUNCTOR_DATA}",
                f"data_config.max_seq_len={ZS_SEQ}", "data_config.min_seq_len=4", *config_args("config", ENTRY_CONFIG),
                "optimization_config.init_lr=1e-3", "optimization_config.max_epochs=2", "optimization_config.batch_size=32",
                "optimization_config.validation_batch_size=32", "optimization_config.lr_frac_warmup_steps=0.1",
                "final_validation_metrics_config.do_skip_all_metrics=true", "trainer_config.log_every_n_steps=3",
                f"experiment_dir={chain}",
                "save_dir=${experiment_dir}/pretrain", "do_overwrite=true"]  # fmt: skip
    loss, tuning_m, held_out_m = run("pretrain", pretrain.main, pre_args)
    save = chain / "pretrain"
    yaml_fp, overrides, _ = parse_cli(pre_args)
    resolved = pretrain.resolved_config(load_config(pretrain.PretrainConfig, yaml_file=yaml_fp, overrides=overrides))
    check(yaml_subset.load_file(save / "pretrain_config.yaml") == resolved and resolved["save_dir"] == str(save),
          "phase 23 (a): pretrain_config.yaml does not read back to the resolved config")  # fmt: skip
    log = read_train_log(save)
    epochs = [r for r in log if r["split"] == "tuning"]
    check(math.isfinite(loss) and len(epochs) == 2 and all(math.isfinite(r["tuning_loss"]) for r in epochs)
          and epochs[-1]["graph_captures"] >= 1 and all(math.isfinite(v) for v in {**tuning_m, **held_out_m}.values()),
          f"phase 23 (a): pretrain {loss} {epochs}")  # fmt: skip
    config = json.loads((save / "config.json").read_text())
    check(config["hidden_size"] == 256 and config["precision"] == "bf16" and config["seq_attention_types"] == ["local", "global"],
          f"phase 23 (a): the written config.json {config}")  # fmt: skip
    multivariate = any(m["modality"] == "multivariate_regression" for m in config["measurement_configs"].values())
    check((launches("pretrain", kernel="vocab_gather_fwd") > 0) == multivariate,
          f"phase 23 (a): kernel C {runs['pretrain']['launches']}, multivariate regression {multivariate}")  # fmt: skip
    opt = ["optimization_config.init_lr=1e-3", "optimization_config.max_epochs=2", "optimization_config.batch_size=32",
           "optimization_config.validation_batch_size=32", "optimization_config.lr_frac_warmup_steps=0.1",
           "trainer_config.log_every_n_steps=3"]  # fmt: skip
    ft_loss, _, _ = run("finetune", finetune.main, [f"load_from_model_dir={save}", f"task_df_name={ZS_TASK}", *opt])
    ft_dir = save / "finetuning" / ZS_TASK
    check(math.isfinite(ft_loss) and (ft_dir / "tuning_metrics.json").exists() and (ft_dir / "held_out_metrics.json").exists(),
          f"phase 23 (a): finetune {ft_loss}")  # fmt: skip
    zs_tuning, zs_held_out = run("zeroshot", zeroshot.main, [
        f"load_from_model_dir={save}", f"task_df_name={ZS_TASK}", "data_config_overrides.seq_padding_side=left",
        f"config_overrides.max_seq_len={ZS_SEQ + ZS_NEW}", f"task_specific_params.num_samples={ZS_SAMPLES}",
        f"optimization_config.validation_batch_size={ZS_BATCH}", f"save_dir={chain / 'zeroshot'}"])  # fmt: skip
    for split, m in (("tuning", zs_tuning), ("held_out", zs_held_out)):
        written = json.loads((chain / "zeroshot" / f"zero_shot_{split}_metrics.json").read_text())
        check(written == m and f"{split}_frac_unpredictable" in m, f"phase 23 (a): zeroshot {split} metrics {m}")
    check(launches("zeroshot", kernel="fused_categorical_stream") > 0, f"phase 23 (a): zeroshot {runs['zeroshot']}")
    emb = run("get_embeddings", get_embeddings.main, [f"load_from_model_dir={save}", f"task_df_name={ZS_TASK}"])
    shapes = {split: np.load(fp).shape for split, fp in emb.items()}
    check(sorted(emb) == ["held_out", "train", "tuning"] and all(s[0] > 0 and s[1:] == (256,) for s in shapes.values())
          and all(np.isfinite(np.load(fp)).all() for fp in emb.values()), f"phase 23 (a): embeddings {shapes}")  # fmt: skip
    traj_args = [f"load_from_model_dir={save}", f"task_specific_params.num_samples={ENTRY_TRAJ_SAMPLES}",
                 f"task_specific_params.max_new_events={ENTRY_TRAJ_NEW}", "optimization_config.validation_batch_size=32",
                 f"save_dir={chain / 'trajectories'}"]  # fmt: skip
    out = run("generate_trajectories", generate_trajectories.main, traj_args)
    check(launches("generate_trajectories", kernel="fused_categorical_stream") > 0,
          f"phase 23 (a): generate_trajectories {runs['generate_trajectories']}")  # fmt: skip
    gcfg = load_config(GenerateConfig, overrides=traj_args)
    generated = 0
    for split in ("tuning", "held_out"):
        files = sorted(p.name for p in (out / split).iterdir())
        check(files == [f"sample_{i}_local_rank_0.npz" for i in range(ENTRY_TRAJ_SAMPLES)],
              f"phase 23 (a): {split} files {files}")  # fmt: skip
        prompt = sum(int(b.event_mask.sum()) for b in TorchDataset(gcfg.data_config, split).batches(
            32, shuffle=False, drop_last=False, seed=0))  # fmt: skip
        for name in files:
            total = int(read_dl_reps(out / split / name).lists["time_delta"].offsets[-1])
            check(total > prompt, f"phase 23 (a): {split} {name} holds {total} events, its prompts {prompt}")
            generated += total - prompt
    a_s = time.perf_counter() - t_a

    # (b) the sweep: ASHA over phase 18's cohort, the promoted trial against its uninterrupted run
    t_b = time.perf_counter()
    sweep = {
        "defaults": ["_self_"], "program": "pretrain.py", "method": "random", "name": "phase_23", "n_trials": 3,
        "seed": SEED, "sweep_dir": str(root / "sweep"), "metric": {"goal": "minimize", "name": "tuning_loss"},
        "early_terminate": {"type": "hyperband", "min_iter": 1, "eta": 3},
        "parameters": {
            "config": {**{k: {"value": v} for k, v in ENTRY_CONFIG.items()}, "resid_dropout": {"min": 0.0, "max": 0.2}},
            "optimization_config": {
                "init_lr": {"distribution": "log_uniform_values", "min": 1.0e-4, "max": 3.0e-3},
                "weight_decay": {"min": 0.0, "max": 0.1}, "max_epochs": {"value": SWEEP_EPOCHS},
                "batch_size": {"value": TRAIN_BATCH}, "validation_batch_size": {"value": TRAIN_BATCH},
                "lr_frac_warmup_steps": {"value": 0.1}},
            "data_config": {"save_dir": {"value": str(pre["cache"])}, "max_seq_len": {"value": TRAIN_SEQ},
                            "min_seq_len": {"value": 4}},
            "final_validation_metrics_config": {"do_skip_all_metrics": {"value": True}},
        },
    }  # fmt: skip
    yaml_subset.dump_file(sweep, root / "sweep.yaml")
    results = run("sweep", launch_hp_sweep.main, ["--run", "--config", str(root / "sweep.yaml")])
    stopped = [r for r in results if r["status"] != "completed"]
    done = [r for r in results if r["status"] == "completed"]
    check(len(results) == 3 and len(done) == 1 and all(r["status"] == "stopped_rung_0" and r["epochs_trained"] == 1
                                                       for r in stopped),
          f"phase 23 (b): statuses {[(r['status'], r['epochs_trained']) for r in results]}")  # fmt: skip
    survivor = done[0]
    rung0 = {r["trial"]: r["rungs"][0]["tuning_loss"] for r in results}
    check(survivor["epochs_trained"] == SWEEP_EPOCHS and [g["epochs"] for g in survivor["rungs"]] == [1, SWEEP_EPOCHS]
          and survivor["trial"] == min(rung0, key=rung0.get) and all(math.isfinite(v) for v in rung0.values()),
          f"phase 23 (b): the survivor {survivor}")  # fmt: skip
    trial = {k: v for k, v in survivor.items() if "." in k}
    full_epochs, full_steps = launch_hp_sweep._full_horizon(trial)
    ref_loss, _, _ = run("sweep reference", pretrain.main, launch_hp_sweep._trial_args(trial, {
        "optimization_config.max_epochs": full_epochs, "optimization_config.max_training_steps": full_steps,
        "save_dir": str(root / "sweep_reference")}))  # fmt: skip
    check(ref_loss == survivor["tuning_loss"],
          f"phase 23 (b): the promoted trial's tuning loss {survivor['tuning_loss']} differs from its uninterrupted "
          f"run's {ref_loss}")  # fmt: skip
    check(same_tensors(torch.load(Path(survivor["save_dir"]) / "pretrained_weights" / "model.pt", weights_only=True),
                       torch.load(root / "sweep_reference" / "pretrained_weights" / "model.pt", weights_only=True)),
          "phase 23 (b): the promoted trial's weights differ from its uninterrupted run's")  # fmt: skip
    check(launches("sweep", "sweep reference", kernel="vocab_gather_fwd") > 0 and launches(
        "sweep", "sweep reference", kernel="vocab_gather_bwd") > 0, f"phase 23 (b): kernel C {runs['sweep']}")  # fmt: skip
    b_s = time.perf_counter() - t_b

    # (c) the operator contract: SIGTERM, exit 85, a clean relaunch, against an uninterrupted run
    t_c = time.perf_counter()

    def operator_config(save_dir) -> Path:
        fp = root / f"{Path(save_dir).name}.yaml"
        yaml_subset.dump_file({
            "seed": SEED, "config": ENTRY_CONFIG, "experiment_dir": str(root), "save_dir": str(save_dir),
            "optimization_config": {"init_lr": 1e-3, "max_epochs": SIGTERM_EPOCHS, "batch_size": TRAIN_BATCH,
                                    "validation_batch_size": TRAIN_BATCH, "lr_frac_warmup_steps": 0.1},
            "data_config": {"save_dir": str(pre["cache"]), "max_seq_len": TRAIN_SEQ, "min_seq_len": 4},
            "pretraining_metrics_config": {"do_skip_all_metrics": True}, "do_final_validation_on_metrics": False,
            "trainer_config": {"log_every_n_steps": 4, "checkpoint_every_n_steps": 8, "max_checkpoints_to_keep": 100},
        }, fp)  # fmt: skip
        return fp

    def launch(fp, log_fp):
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)}
        return subprocess.Popen([sys.executable, "-m", "eventstreamgpt_tpu_torch.scripts.pretrain", "--config", str(fp)],
                                cwd=REPO, stdout=open(log_fp, "w"), stderr=subprocess.STDOUT, env=env)  # fmt: skip

    op = root / "operator"
    fp = operator_config(op)
    torch.cuda.empty_cache()
    proc = launch(fp, root / "operator_1.log")
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and proc.poll() is None:
            if (op / "train_log.jsonl").exists() and (op / "train_log.jsonl").read_text().count("\n") >= 2:
                break
            time.sleep(0.05)
        log1 = (root / "operator_1.log").read_text()
        check(proc.poll() is None, f"phase 23 (c): the run ended (rc {proc.poll()}) before SIGTERM: {log1[-2000:]}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log1 = (root / "operator_1.log").read_text()
    check(rc == EXIT_PREEMPTED and f"exiting {EXIT_PREEMPTED} for reschedule" in log1,
          f"phase 23 (c): SIGTERM gave exit {rc}: {log1[-2000:]}")  # fmt: skip
    mgr = ReliableCheckpointManager(op / "model_checkpoints")
    final_step = mgr.latest_step()
    logged = [r["step"] for r in read_train_log(op) if r["split"] == "train"]
    check(final_step is not None and mgr._verify_status(final_step) == "verified" and logged
          and final_step >= max(logged), f"phase 23 (c): checkpoint {final_step}, logged steps {logged}")  # fmt: skip
    mgr.close()
    proc2 = launch(fp, root / "operator_2.log")
    try:
        rc2 = proc2.wait(timeout=600)
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait()
    log2 = (root / "operator_2.log").read_text()
    check(rc2 == 0 and f"Resumed from checkpoint at step {final_step}" in log2,
          f"phase 23 (c): the relaunch gave exit {rc2}: {log2[-2000:]}")  # fmt: skip
    relaunch_s = time.perf_counter() - t_term - drain_s
    run("operator reference", pretrain.main, ["--config", str(operator_config(root / "operator_reference"))])
    ref = {"weights": torch.load(root / "operator_reference" / "pretrained_weights" / "model.pt", weights_only=True),
           "log": read_train_log(root / "operator_reference")}  # fmt: skip
    mine = {"weights": torch.load(op / "pretrained_weights" / "model.pt", weights_only=True), "log": read_train_log(op)}
    check(same_tensors(mine["weights"], ref["weights"]), "phase 23 (c): the relaunched run's weights differ from the "
          "uninterrupted run's")  # fmt: skip
    losses, ref_losses = train_losses(mine), train_losses(ref)
    check(set(losses) == set(ref_losses) and all(losses[k] == ref_losses[k] for k in losses),
          f"phase 23 (c): logged losses {losses} differ from the uninterrupted run's {ref_losses}")  # fmt: skip
    c_s = time.perf_counter() - t_c
    check(not any(m in sys.modules for m in ("pandas", "pyarrow", "yaml")), "phase 23: pandas, pyarrow or PyYAML was imported")

    trained = {name: [round(r["events_per_sec"], 1) for r in read_train_log(d) if r["split"] == "train"]
               for name, d in (("pretrain", save), ("finetune", ft_dir))}  # fmt: skip
    launches_c = {d: launches("sweep", "sweep reference", "operator reference", "pretrain", "finetune",
                              kernel=f"vocab_gather_{d}") for d in ("fwd", "bwd")}  # fmt: skip
    launches_a = sum(r["launches"]["fused_categorical_stream"] for r in runs.values())
    walls = {k: round(v["wall"], 2) for k, v in runs.items()}
    print(f"phase 23: the entry points' main(argv) on the card, phase 4's CI model. (a) the chain on the converted sample "
          f"cohort ({ZS_SEQ}-event rows, batches of 32, 2 epochs each) {a_s:.2f} s: trained events/s a log window "
          f"{json.dumps(trained)}; generate_trajectories {generated} events in {runs['generate_trajectories']['wall']:.2f} s "
          f"({generated / runs['generate_trajectories']['wall']:.1f} generated events/s over the entry point's wall, "
          f"{ENTRY_TRAJ_SAMPLES} samples of {ENTRY_TRAJ_NEW}); zero-shot ({ZS_SAMPLES} samples of {ZS_NEW}) "
          f"{runs['zeroshot']['wall']:.2f} s; pretrain_config.yaml reads back; (b) ASHA, 3 trials, eta 3, "
          f"{SWEEP_EPOCHS} epochs on phase 18's cohort, {b_s:.2f} s: rung-0 tuning losses {json.dumps(rung0)}, trial "
          f"{survivor['trial']} promoted and equal to its uninterrupted run bit for bit (loss {ref_loss}); (c) SIGTERM "
          f"at step >= 8: exit {rc} after {drain_s:.2f} s, checkpoint {final_step} verified, the relaunch resumed and "
          f"finished in {relaunch_s:.2f} s, equal to the uninterrupted run bit for bit, {c_s:.2f} s; each main's wall "
          f"{json.dumps(walls)}; kernel A {launches_a}, kernel C {json.dumps(launches_c)} launches ({smi})",
          flush=True)  # fmt: skip
    return dict(launches_a=launches_a, launches_c=launches_c, seconds={"a": a_s, "b": b_s, "c": c_s})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke run needs one", file=sys.stderr)
        return 2
    if not (REPO / "eventstreamgpt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the eventstreamgpt_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from eventstreamgpt_tpu_torch.tools.phase_times import time_phases

    phase_s: dict = {}
    time_phases(globals(), phase_s)
    t0 = time.perf_counter()
    smi = device_phase()
    model, config, capture, runs = engine_phase(smi)
    a = kernel_a_phase(capture)
    b = kernel_b_phase(model, config, capture)
    captures_q, runs_q = quantized_engine_phase(smi, model, config, runs)
    bq = kernel_b_quant_phase(model, captures_q, smi)
    train, gather_capture = training_phase(smi)
    c = kernel_c_phase(gather_capture)
    na_train, dep_capture = na_training_phase(smi)
    d_times = kernel_d_phase(dep_capture)
    packed, flash_args = packed_training_phase(smi)
    ef = kernel_ef_phase(flash_args)
    chunked = chunked_training_phase(smi)
    paged = paged_phase(smi, model, config)
    spec = spec_phase(smi, model, config)
    acct = runs["sampled"]["passes"]["accounting"]
    gen = generate_phase(smi, runs["sampled"]["generated"] / acct["wall_s"])
    na_engine = na_engine_phase(smi)
    na_spec = na_spec_phase(smi, na_engine)
    service = service_phase(smi, model, config)
    fleet = fleet_phase(smi, config, service.pop("m1"), service.pop("m2"))
    work = tempfile.TemporaryDirectory()  # phase 18's cache and save_dirs, which phase 20 fine-tunes from
    pretrain = pretrain_phase(smi, Path(work.name))
    functor = functor_phase(smi, model, config)
    finetune = fine_tuning_phase(smi, pretrain)
    remat = remat_scan_phase(smi, pretrain)
    ef128 = kernel_ef_phase({None: remat.pop("flash_args")}, phase="phase 21", tag="_d128")
    traj = trajectories_phase(smi, pretrain, Path(work.name))
    entry = entry_points_phase(smi, pretrain, Path(work.name))
    work.cleanup()
    # Profiles last: no capture follows a torch.profiler session.
    spec["profiles"] = spec.pop("profile")()
    gen["profiles"] = generate_step_profiles(smi, gen)
    na_engine["profiles"] = na_engine.pop("profile")()
    print(f"phase 14: one profiled captured chunk of 16 at 32 admitted slots (sampled, bf16), a step: NA engine "
          f"{json.dumps(na_engine['profiles'])}; phase 2's CI engine, unfused step "
          f"{json.dumps(spec['profiles']['monolithic unfused'])}; phase 13's NA generate() step "
          f"{json.dumps(gen['profiles']['NA step'])}; events/s (accounting pass) {json.dumps(na_engine['rates'])} "
          f"({smi})", flush=True)  # fmt: skip
    print(f"phase 15: events/s (accounting pass) {json.dumps(na_spec['rates'])} ({smi})", flush=True)

    def chunk_launches(name):
        return sum(run["launches"][name] for run in chunked.values())

    kernels = [
        dict(name="fused_categorical", route="cuda", source="eventstreamgpt_tpu_torch/csrc/fused_sampling.cu",
             replaces="eventstreamgpt_tpu/ops/fused_sampling.py:171", entry="fused_categorical_stream",
             launches=runs["sampled"]["launches"]["fused_categorical_stream"] + paged["launches_a"]
             + spec["launches_a"] + gen["CI"]["launches_a"] + gen["NA"]["launches_a"] + na_engine["launches_a"]
             + na_spec["launches_a"] + service["launches_a"] + fleet["launches_a"] + functor["launches_a"]
             + traj["launches_a"] + entry["launches_a"], **a),
        dict(name="decode_stack_step", route="cuda", source="eventstreamgpt_tpu_torch/csrc/decode_step.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_decode_step.py:297",
             launches=runs["greedy"]["launches"]["decode_stack_step"]
             + runs["sampled"]["launches"]["decode_stack_step"] + service["launches_b"] + fleet["launches_b"]
             + functor["launches_b"], **b),
    ] + [
        dict(name=f"decode_stack_step_{kv}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/decode_step.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_decode_step.py:297", entry="esgpt_decode_stack_step_quant",
             launches=sum(runs_q[(kv, m)]["launches"][f"decode_stack_step.launches_{kv}"]
                          for m in ("greedy", "sampled")),
             **bq[kv])
        for kv in QUANT_DTYPES
    ] + [
        dict(name=f"vocab_gather_{d}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/vocab_gather.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_heads.py:182",
             launches=train["launches"][f"vocab_gather_{d}"] + chunk_launches(f"vocab_gather_{d}")
             + pretrain["launches"][f"vocab_gather_{d}"] + functor["launches_c"][d]
             + remat["launches"][f"vocab_gather_{d}"] + entry["launches_c"][d], **c[d])
        for d in ("fwd", "bwd")
    ] + [
        dict(name=f"dep_graph_{k}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/dep_graph.cu",
             replaces="eventstreamgpt_tpu/ops/pallas_dep_graph.py:397",
             launches=na_train["launches"][f"dep_graph_{k}"] + chunk_launches(f"dep_graph_{k}")
             + (gen["launches_d"] if k == "fwd" else 0) + pretrain["launches"][f"dep_graph_{k}"]
             + finetune["launches"][f"dep_graph_{k}"] + remat["launches"][f"dep_graph_{k}"], **d_times[k])
        for k in ("fwd", "bwd")
    ] + [
        dict(name=f"{n}_{k}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/flash_attention.cu",
             replaces=f"eventstreamgpt_tpu/models/transformer.py:{line}",
             launches=sum(run["launches"][f"{n}_{k}"] for run in packed.values()) + chunk_launches(f"{n}_{k}")
             + finetune["launches"].get(f"{n}_{k}", 0), **ef[f"{n}_{k}"])
        for n, line in (("flash_attention", 864), ("flash_attention_window", 900))
        for k in ("fwd", "bwd")
    ] + [
        dict(name=f"flash_attention_d128_{k}", route="cuda", source="eventstreamgpt_tpu_torch/csrc/flash_attention.cu",
             replaces="eventstreamgpt_tpu/models/transformer.py:864",
             launches=remat["launches"][f"flash_attention_{k}"], **ef128[f"flash_attention_d128_{k}"])
        for k in ("fwd", "bwd")
    ]  # fmt: skip
    for k in kernels:
        check(all(isinstance(k[f], (int, float)) and math.isfinite(k[f]) for f in ("ms", "plain_ms", "bound_ms")),
              f"{k['name']}: a timing is missing")  # fmt: skip
        check(k["launches"] > 0, f"{k['name']}: never launched on the main path")
    single = {k["name"]: {f: k.pop(f"single_{f}") for f in ("ms", "plain_ms", "library_ms")} for k in kernels}
    print(f"chip_smoke: one synchronised call each, host work included: {json.dumps(single)}", flush=True)
    total = time.perf_counter() - t0
    phase_s["other"] = total - sum(phase_s.values())
    print(f"chip_smoke: seconds a phase {json.dumps({k: round(v, 2) for k, v in phase_s.items()})}", flush=True)
    print(f"chip_smoke: all phases passed in {total:.1f} s ({smi})", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)  # fmt: skip
    return 0


if __name__ == "__main__":
    sys.exit(main())
