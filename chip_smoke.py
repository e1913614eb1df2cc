#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
(one ``nvcc`` per source, all started together), holds every kernel against
its plain PyTorch version on the card, and drives the port's paths on the
I=16384 serving fleet, counting the kernel launches of each:

* main path 1 — ``simulate(EngineSpec(engine="cohort-fused",
  scheduler="potus", device="cuda"))``: the slot kernel (``potus_slot``);
* the dense route of the same engine, ``scheduler="potus-loop"``, on an
  I=1024 fleet (phase A): the price kernel (``potus_price``) and the drain
  kernel (``cohort_drain``); kernel 4 alone on dyadic and random inputs
  (B), once (C) and in 16 dense steps (D) at I=16384 from path 1's mid-run
  state; ``events=`` on the compact route, which launches no kernel (E);
  the ``benchmarks/disruption.py`` grid as one ``run_sweep`` (F);
* main path 2 — ``simulate(EngineSpec(engine="jax", scheduler="potus",
  device="cuda"))``, the plain scan engine (the Fig. 5 path): the fused
  schedule kernel (``potus_schedule``); and its ``scheduler="potus-loop"``
  route, on an I=1024 fleet: the price kernel;
* phase G, the serving path — ``PotusDispatcher`` on the card (the
  schedule kernel once per slot) over a ``ReplicaFleet`` of 4
  ``ServingEngine`` replicas sharing one qwen2.5-32b decoder at full width
  (2 of 64 layers, bf16, weights from a seeded ``torch.Generator``): the
  flash attention kernel (``flash_attention``, per prefill and layer) and
  the decode attention kernel (``decode_attention``, per decode round and
  layer); both kernels alone at qwen2.5-32b and zamba2-1.2b widths beside
  SDPA; the kernel route against the plain route teacher-forced, in bf16
  and in f32; one of the two served runs with a ``FlightRecorder`` on the
  dispatcher and one on the fleet (J4);
* phase H, the SSM and hybrid models at full width and depth in bf16,
  weights from a seeded ``torch.Generator``: the SSD intra-chunk kernel
  (``ssd_intra_chunk``) alone at mamba2-1.3b widths through
  ``ssd_chunked``'s kernel route; one mamba2-1.3b ``forward`` of 2048
  tokens (one launch per Mamba2 block), each block held to the plain route
  from the same input and 2 layers in f32 end to end; zamba2-1.2b serving
  two 512-token prompts through a ``ServingEngine`` (kernel 7 per Mamba2
  block and flash attention per shared-attention invocation in each
  prefill, decode attention per invocation in each decode round), its
  tokens against the entry points', every launch of the three kernels on
  that path held against its plain version on the path's own arguments
  in bf16 and f32, each block and attention invocation held to the plain
  route from the same input in bf16, the kernel route against the plain
  route end to end in f32, and prefill/decode against a forward;
* phase I, scenario sweeps — ``run_sweep(engine="cohort-fused")`` on the
  I=16384 fleet's V x W grid: the slot kernel once a launch for all the
  scenarios of a partition (its grid has a scenario axis), each scenario
  bitwise its own ``simulate``; the dyadic sweep against the CPU and every
  batched call against the batched plain version; the paper profile's
  Fig. 6ab and Fig. 5 grids (``benchmarks/torch_figures.py``) against the
  CPU (of Fig. 6ab, the last V column: 7 of its 28 scenarios; of Fig. 5,
  the W=0 column: 7 of 14), whose runs follow the card's;
* phase J, observability (``metrics=``, span tracing, the obs dump; no
  kernel of its own): J1 the metric streams of both ported engines on the
  dyadic system — the card's equal the CPU's, metrics on leave every
  trajectory bitwise as off, and a compact ``cohort-fused`` run with
  metrics (which takes ``compact_slot_step``, not the slot kernel, as the
  reference does) equals the plain and the kernel route; J2 the I=16384
  fleet with metrics on: path 2 (kernel 2 still once a slot) and the
  compact ``cohort-fused`` run (``potus_slot=0``), their wall beside the
  metrics-off paths in turns; J3 ``benchmarks/torch_figures.py``'s
  metrics dump through the k-failure transient, read back by
  ``tools/obs_report.py --recovery``, its Chrome trace, and a
  ``torch.profiler`` trace listing the span names;
* phase K, the host-loop oracles — ``simulate(EngineSpec(engine="cohort"))``
  (the Python event loop) and ``run_event_sim``, whose scheduler runs once a
  slot on the card: the schedule kernel (``potus``) or the price kernel
  (``potus-loop``), X copied back whole. K1 the dyadic system: the card
  equals the CPU bitwise for the four schedulers (mis-predicted, under a
  k-failure, with every cohort stream), the fluid event simulator equals
  the scan engine bitwise, one launch a slot; K2 the paper profile, the
  event loop against ``cohort-fused`` at the reference's floors; K3
  ``benchmarks/torch_systems.py``'s ``cohort_scale`` on the fleet at I=1024
  (shuffle, potus) and 16384 (potus) (the loop on a truncated horizon,
  extrapolated), each loop run profiled; K4 its event-gap rows, the card's events equal to the CPU's;
* phase L, the mixture-of-experts decoder (``models/moe.py``; no kernel of
  its own): L1 ``moe_ffn`` alone at granite-moe-1b widths in f32, on the
  card against the port on the CPU (selections, keep masks, loads and
  router states exact), for top-k and for POTUS with its state carried;
  L2 granite-moe-1b at full width in bf16, 2 of its 24 layers, served
  behind the dispatcher as phase G serves (kernel 5 per prefill and layer,
  kernel 6 per decode round and layer, kernel 2 per slot); L3 the kernel
  route against the plain route at full depth, each attention and MoE
  block from the same input in bf16, 2 layers end to end in f32, the
  full-depth bf16 gap recorded; L4 the POTUS router against top-k on a
  skewed batch at full width and depth;
* phase M, training (``repro_torch.training``, ``repro_torch.data``): M1
  the flash attention backward kernel (``flash_attention_bwd``) alone at
  internvl2-1b's (causal, 14/2 heads of 64) and hubert-xlarge's
  (bidirectional, 16/16 of 80) widths, B=2, S=1024, bf16 (its tensor-core
  route) and f32 (SIMT), against the autograd gradient of the plain
  version and, on the tensor cores, its arithmetic stated in plain
  PyTorch, the bf16 route timed beside SDPA's backward; M2 internvl2-1b at full width and depth
  in bf16 (weights from a seeded ``torch.Generator``), ``make_train_step``
  on one repeated ``TokenPipeline`` batch of 2 x 1024 (256 patches + 768
  tokens): kernels 5 and 5b (both on the tensor cores) once per layer and
  step, the loss falling, the kernel route against the plain route at full
  depth (recorded) and at 2 layers in f32 (held); M4 the state (weights,
  AdamW's moments) of its full width at 2 of its 24 layers after 4 steps
  through an ``AsyncCheckpointer``, restored on the card bitwise, and a run
  resumed from it against the uninterrupted one; M3
  hubert-xlarge (encoder, 48 layers, bf16, 1024 frame embeddings) likewise
  for two steps (kernel 5 on its SIMT route, 5b on the tensor cores at
  head_dim 80), its full-depth f32 witness held (the kernel route's bf16
  gap on the worst leaf within 1.5x the plain route's own);
* phase N, the instance-sharded engines (``core/sharded.py`` on
  ``torch.distributed``): N1 one NCCL rank in this process,
  ``simulate(EngineSpec(engine="cohort-fused", sharded=True,
  use_pallas=True))`` on the I=16384 fleet — the slot kernel once a slot,
  bitwise path 1; N2 four gloo ranks sharing the card
  (``distributed.world.spawn_world``): the I=16 dyadic cases of
  ``tests/test_torch_sharded.py`` (cohort-fused potus/shuffle/jsq with and
  without a restart, chunks, ``use_pallas``, ``engine="sharded"``) bitwise
  the dense port on the card on every rank, and the fleet at T=16 on the
  compact route within rtol 1e-4 a slot, its collectives' payload counted;
* phase O, expert-parallel MoE serving (``models/moe_ep.py`` on the model
  mesh of ``launch/mesh.py``; no kernel of its own): O1 one NCCL rank in
  this process, ``moe_ffn_ep`` on a 1x1 mesh at granite-moe-1b's widths
  against ``moe_ffn`` on the card (N=4 and 512, f32 and bf16, top-k and
  POTUS with its state carried); O2 four gloo ranks sharing the card,
  meshes 4x1 and 2x2, N=512 f32 at capacity factors 1.25 and 4.0, each
  rank's card result against its own CPU run; O3 granite-moe-1b at full
  width, 2 of its 24 layers, served on the 4x1 mesh
  (``examples/torch_moe_ep.py``'s ``serve_rank``) in f32 against a
  one-rank run without a mesh and in bf16, kernels 5, 6 and 2 counted on
  every rank. O2 and O3 run in phase N's world of four gloo ranks, after
  N2's cases (one start-up for both phases);
* phase P, data-parallel training (``training.make_train_step`` under a
  model mesh, ``distributed/sharding.py``, the elastic checkpoint,
  ``distributed/pipeline.py``): P1 one NCCL rank in this process,
  internvl2-1b at full width, 2 of its 24 layers, bf16, two steps on a
  1x1 mesh with ZeRO-1 moments and ``grad_specs`` bitwise the meshless
  steps (phase M's), kernels 5 and 5b once per layer a step; P2 four gloo
  ranks sharing the card on a 4x1 mesh in f32, one step on a global
  batch of 8 against the one-rank f32 step on the card (loss and grad
  norm within rel 1e-5, after the first step the parameters within the
  ``_param_bound`` rule of ``tests/test_torch_training.py`` and each rank's
  moment blocks within 1e-5 of scale), kernels 5 and 5b on every rank, the
  state saved across the ranks and restored onto one rank bitwise; P3
  ``pipeline_apply`` over the four ranks, one full-width block a stage
  (kernel 5 in each), against the blocks in turn within 1e-5. P1 and
  P2's one-rank reference run after phase M, P2 and P3 in phase N's world
  after O2 and O3;
* phase Q, MoE training across ranks (``models/moe.py``'s global-batch
  router and ``models/moe_ep.py``'s expert-parallel route under
  ``make_train_step``; no kernel of its own): Q1 one NCCL rank in this
  process, granite-moe-1b at full width (32 experts, top-8, capacity
  factor 1.25), 4 of its 24 layers, in bf16 on phase M's batch, two steps on a
  1x1 mesh bitwise the meshless steps, kernels 5 and 5b once
  per layer a step, then the kernel route against the plain route at 2
  layers in f32 (within 1e-4); Q2 four gloo ranks sharing the card on a
  4x1 mesh, full width at 2 of 24 layers, f32, a global batch of 8 x 256:
  one step by the global-batch router at capacity factor 1.25 and one by
  the expert-parallel route at 4.0 (nothing drops), each against the
  one-rank f32 step on the card (loss and grad norm within rel 1e-5, each
  layer's loads, ``dropped_frac`` and selections and the router state
  equal, the parameters within the ``_param_bound`` rule, the moment
  blocks within 1e-5 of scale), the expert-parallel state saved across the
  ranks and restored onto one rank bitwise. Q1 and Q2's references run
  after P1, Q2 in phase N's world after P2 and P3;
* phase R, tensor-parallel training of the dense decoder
  (``make_train_step`` on a ``"model"`` axis above 1; no kernel of its
  own): kernels 5 and 5b alone at the ranks' shapes (f32, 8 and 16 heads
  of 80, S=512) against their plain versions; R1 stablelm-3b at full
  width, 2 of its 32 layers, f32, one step without a mesh in this process
  on a global batch of 4 x 512; R2 four gloo ranks sharing the card on a
  (1, 4) mesh and R3 on a (2, 2) mesh (ZeRO-1 moments over both axes),
  one step each against R1 (loss and grad norm within rel 1e-5, each
  rank's parameter blocks within the ``_param_bound`` rule, its moment
  blocks within 1e-4 of scale, replicated parameters and gradients the
  same on the ranks), kernels 5 and 5b once per layer a step on every rank
  on its heads. R1 runs after Q1, R2 and R3 in phase N's world after Q2;
* phase S, tensor-parallel training of the MoE decoder (``make_train_step``
  on a ``"model"`` axis above 1 with an MoE config: ``models/moe.py``'s
  experts cut over "model", ``models/moe_ep.py``'s F-cut experts; no kernel
  of its own): four gloo ranks sharing the card, Q2's model, batch and
  one-rank f32 references (no new reference run), one step each: S1 the
  global-batch router at capacity factor 1.25 on (1, 4), S2 on (2, 2) with
  ZeRO-1 moments over both axes, S3 the expert-parallel route at 4.0 on
  (2, 2); each against its one-rank step (loss and grad norm within rel
  1e-5, each layer's loads, ``dropped_frac`` and selections and the router
  state equal, each rank's parameter blocks within the ``_param_bound``
  rule, its moment blocks within 1e-4 of scale, replicated parameters and
  gradients the same on the ranks), kernels 5 and 5b once per layer a step
  on every rank on its heads. S runs in phase N's world after R2 and R3;
* phase T, tensor-parallel training of the ``vision_stub`` and encoder
  configs (``make_train_step`` on a ``"model"`` axis above 1 for
  internvl2-1b and hubert-xlarge; no kernel of its own): kernels 5 and 5b
  alone at the ranks' shapes (f32; internvl2-1b's 7/1 heads of 64 causal,
  hubert-xlarge's 4 and 8 heads of 80 bidirectional, S=512) against their
  plain versions; T1 each config at full width, 2 layers, f32, one step
  without a mesh in this process on a global batch of 4 x 512
  (internvl2-1b's first 256 positions patches, their labels -1); four gloo
  ranks sharing the card, one step each: T2 internvl2-1b on (1, 2) (ranks
  2 and 3 off the mesh), T3 hubert-xlarge on (1, 4) and on (2, 2) (ZeRO-1
  moments over both axes); each against T1 (loss and grad norm within rel
  1e-5, the token count T1's, each rank's parameter blocks within the
  ``_param_bound`` rule, its moment blocks within 1e-4 of scale,
  replicated parameters and gradients the same on the ranks), kernels 5
  and 5b once per layer a step on every member rank on its heads. T1 runs
  after R1, T2 and T3 in phase N's world after S.

It checks the results and prints:

* the card's name and power limit, the torch/CUDA versions and build
  seconds;
* per check, the largest difference kernel vs plain version;
* per kernel, one call's kernel, plain and bound ms at the main path's
  shapes (for the drain kernel the library call's ms); for the slot and
  SSD kernels the device ms per call from a ``torch.profiler`` trace, split
  by device function, beside the event-timed ms; for the attention kernels
  the device ms per call of the kernel and of
  ``scaled_dot_product_attention`` beside their event-timed ms, the route
  each call took (tensor cores or SIMT) and the reached TFLOP/s or GB/s;
* per path, its wall ms per slot, its metrics, the device busy share, the
  top device items and (path 2, phase D) the peak device memory; each
  phase's seconds; for the served run its tokens, slots, wall seconds,
  tokens/s, ms per decode round, prefill ms per prompt token and peak
  device memory;
* each comparison of the kernel route with the plain route or with the
  port on the CPU;
* for phase I, the sweep's and a loop of ``simulate`` calls' wall s in
  turns and scenario-slots/s, the busy share, and the slot kernel's device
  ms per call at N=4 and N=1;
* for phase J, the wall ms/slot of path 2 and of the compact
  ``cohort-fused`` run with metrics on and off, in turns, the launches and
  route of each, the peak device memory and the recovery story of the dump;
* for phase K, the event loop's and the fused engine's wall ms a slot at
  I=1024 and 16384, and per loop run the device ms a slot of kernel 2, of
  the copy of X back and of the staged queues out, and the busy share;
* for phase L, ``moe_ffn``'s device ms and device items per call at N=4
  and N=512 with its top device items, the served run's numbers as phase
  G's, and each router's expert load max/mean and dropped fraction;
* for phase M, kernel 5b's route, device ms per call and per pass beside
  SDPA's backward and its bound, and its TFLOP/s on the bound's five
  products and on the nine it does; per trained model its steps' loss,
  grad norm and wall ms, the launches of kernels 5 and 5b, the busy share
  and top device items of a profiled step, the peak device memory, the
  route gaps, and the checkpoint's bytes and seconds and whether the
  resumed run is bitwise;
* for phase N, N1's and path 1's wall ms per slot in turns, N2's wall ms
  per slot on each rank, the share of it in collectives and the payload
  per slot;
* for phase O, ``moe_ffn_ep``'s device ms per call beside ``moe_ffn``'s on
  one rank, and per mesh and rank its ``"ep"`` payload, wall ms per call
  and share in collectives; per served run its slots, decode rounds, the
  decode rounds' median ms, the share in collectives and the launches;
* for phase P, P1's step wall ms with and without the mesh in turns, and
  per P2 step each rank's wall ms, share in collectives and ``"dp"``
  elements beside the one-rank step's wall ms, the checkpoint's save and
  restore seconds, and P3's wall ms per rank and ``"pp"`` elements;
* for phase Q, Q1's step wall ms with and without the mesh in turns, the
  peak device memory, each layer's ``dropped_frac`` and a profiled step's
  top device items; per Q2 route each rank's step wall ms, share in
  collectives and elements by tag (``"moe"``, ``"ep"``, ``"dp"``) beside
  the one-rank step's, and the checkpoint's save and restore seconds;
* for phase R, kernels 5 and 5b's event ms per call at the ranks' shapes,
  R1's step wall ms, and per mesh each rank's step wall ms, share in
  collectives, the collectives' seconds and elements by tag (``"tp"``,
  ``"dp"``) beside R1's;
* for phase S, per step each rank's step wall ms, share in collectives, the
  collectives' seconds and elements by tag (``"tp"``, ``"ep"``, ``"moe"``,
  ``"dp"``) beside Q2's one-rank step's;
* for phase T, kernels 5 and 5b's event ms per call at the ranks' shapes,
  T1's step wall ms, per step each member rank's step wall ms, share in
  collectives, the collectives' seconds and elements by tag beside T1's,
  and each rank's seconds in the phase;
* one JSON line ``{"kernels": [...]}`` (eight kernels: the seven TPU
  kernels' counterparts and the flash attention backward; the slot
  kernel's row carries its batched entry under ``"batched"`` and its
  launches on phase N's one-rank and four-rank runs under
  ``"sharded_launches"``, rows 2 and 3
  their launches on phase K's host loops under ``"cohort_launches"``, rows
  5 and 6 their launches on phase L's served run under ``"moe_launches"``,
  rows 2, 5 and 6 their launches on phase O's bf16 served run (rank 0) under
  ``"ep_launches"``, row 5 its launches on phase M's M2 and M3 steps under
  ``"train_launches"`` and ``"encoder_launches"``, rows 5 and 5b their
  launches on rank 0's P2 steps under ``"dp_launches"``, row 5 its P3
  launches under ``"pipeline_launches"``, rows 5 and 5b their launches on
  Q1's meshless steps under ``"moe_train_launches"`` and on rank 0's Q2
  steps under ``"moe_dp_launches"``, a step's on rank 0 of each phase R
  mesh under ``"tp_launches"``, of each phase S step under
  ``"moe_tp_launches"`` and of each phase T step under
  ``"frontend_tp_launches"``, the backward's row its
  M3 launches under ``"encoder_launches"``, its route under
  ``"kernel_route"`` and its passes' ms under ``"passes_ms"``), then, last,
  ``{"ok": true, "device": {...}}``.

Float32 matrix products run in full f32: TF32 is switched off for cuBLAS
and cuDNN before anything runs. Any failed check raises, so the exit code
is not 0 and the last line is not printed. Without a CUDA device it exits
with code 2 and prints no result. It imports nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the I=16384 serving fleet of benchmarks/systems_bench.py:137 (_cohort_fleet)
FLEET_I, FLEET_T, FLEET_W, FLEET_V, FLEET_AGE_CAP = 16384, 128, 4, 2.0, 64
# the potus-loop route runs max_succ argmin passes per slot (3072 at I=16384,
# seconds per slot), so its fleet is cut to I=1024 until the loop gets a kernel; route A
# (phase A) runs it LOOP_T slots (cut from 128 to make room for phase O)
LOOP_I, LOOP_T = 1024, 64
KERNELS = ("potus_slot", "potus_schedule", "potus_price", "cohort_drain", "flash_attention",
           "decode_attention", "ssd_intra_chunk", "flash_attention_bwd")
ZERO_COUNTS = dict.fromkeys(KERNELS, 0)
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 outside the tensor cores, bf16
# tensor cores (dense)
PEAK_BYTES_S, PEAK_F32_S, PEAK_BF16_S = 3.35e12, 67e12, 989e12
# phase G, the served run: qwen2.5-32b at full width, depth cut to 2 of 64 layers, bf16; a
# fleet of 4 replicas behind the dispatcher (examples/serving_demo.py's traffic, scaled up)
SERVE_ARCH, SERVE_LAYERS = "qwen2_5_32b", 2
SERVE_RATES = (4.0, 2.0, 2.0, 2.0)  # decode rounds per slot; replica 0 is the fast one
SERVE_BATCH, SERVE_MAX_LEN, SERVE_MAX_NEW, SERVE_REQUESTS = 4, 1024, 16, 32
SERVE_PROMPT_LENS = (32, 64, 128, 256, 512)
SERVE_STRAGGLE = (6, 12)  # replica 0 serves at 25% over slots [6, 12)
# phase H, the SSM and hybrid models at full width and depth, bf16: mamba2-1.3b forward
# (b=1, T=2048) and zamba2-1.2b served (2 prompts of 512 tokens, 16 decode rounds); kernel 7
# alone at mamba2-1.3b widths (H=64, P=64, S=128, chunk 256): (b, T, dtype) cases
SSD_ARCH, HYBRID_ARCH = "mamba2_1_3b", "zamba2_1_2b"
SSD_CASES = ((1, 2048, "bfloat16"), (1, 2048, "float32"), (2, 1000, "float32"))
# of max |ref|: tests/test_kernels.py:98-108; the f32 states are held at the f32 limit in every
# case (both sides compute them in f32), only a bf16 y_diag at the bf16 one
SSD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SSM_T, HYBRID_PROMPT, HYBRID_STEPS, HYBRID_MAX_LEN = 2048, 512, 16, 544
SSM_FORWARD_RUNS = 10  # timed forwards of H2
HYBRID_PREFILL_RUNS = 5  # warm prefills of each H3 prompt, timed
# phase L, the MoE decoder: granite-moe-1b at full width and depth in bf16, served as phase G
# serves, with 16 requests; moe_ffn alone at its widths in f32 at N=4 (a decode round) and
# N=512 (the longest served prompt), POTUS with its state carried over MOE_CALLS calls
MOE_ARCH, MOE_REQUESTS, MOE_TOKENS, MOE_CALLS = "granite_moe_1b", 16, (4, 512), 4
# L2 serves granite-moe-1b at 2 of its 24 layers (full width) to make room for phases M and O;
# L3's full-depth gap and L4 keep all 24
MOE_SERVE_LAYERS = 2
# phase M, training: kernel 5b alone at the trained models' widths, (B, Hq, Hkv, D, causal);
# internvl2-1b (24 layers, bf16) trained TRAIN_STEPS steps on one repeated TokenPipeline batch
# of TRAIN_B x TRAIN_S (256 patches + 768 tokens), its checkpoint restored and resumed for
# CKPT_RESUME_STEPS steps; hubert-xlarge (48 layers, bf16) ENCODER_STEPS steps on 1024 frames
BWD_DIMS = {"internvl2-1b": (2, 14, 2, 64, True), "hubert-xlarge": (2, 16, 16, 80, False)}
BWD_ENTRY = ("internvl2-1b", "bfloat16")  # the kernels line's case
# kernel 5b's device functions by route (the tensor-core route sums the G heads' partials
# only when G > 1); its tensor-core route against its arithmetic in plain PyTorch
# (flash_attention_bwd_tc_plain): both round P and dS to bf16 as operands and the gradients at
# the end, so they part where float32 sums in another order flip a rounding (one bf16 ulp of
# the largest element is at most 2^-7 of the scale)
BWD_PASSES = {"tc": ("flash_bwd_tc_dq_kernel", "flash_bwd_tc_dkv_kernel",
                     "flash_bwd_tc_reduce_kernel"),
              "simt": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}
BWD_TC_TOL = 1e-2
TRAIN_B, TRAIN_S, TRAIN_LR = 2, 1024, 1e-4
TRAIN_STEPS, ENCODER_STEPS, CKPT_RESUME_STEPS = 4, 2, 2
# M4 checkpoints internvl2-1b at full width cut to CKPT_LAYERS of its 24 layers, trained
# TRAIN_STEPS steps on M2's batch (its state ~1.7 GB: the 151655-row embedding leads)
CKPT_LAYERS = 2
# hubert-xlarge's full-depth witness, held: the kernel route's bf16 gradient on the worst leaf
# at most this many times as far from the f32 plain route as the plain route's bf16 gradient
WITNESS_FACTOR = 1.5


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def rel_diff(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))) if a.size else 0.0


# ---------------------------------------------------------------------------
# systems, rebuilt with the port's own modules
# ---------------------------------------------------------------------------

def dyadic_system(pt, T, W):
    """The dyadic-arithmetic system of tests/test_potus_slot.py:44."""
    C = pt.Component
    apps = [
        [C("src", 0, True, 2, successors=(1, 2), selectivity=(0.5, 0.5)),
         C("left", 0, False, 2, 4.0, successors=(3,)),
         C("right", 0, False, 4, 4.0, successors=(3,)),
         C("sink", 0, False, 2, 8.0)],
        [C("src", 1, True, 2, successors=(1,)),
         C("mid", 1, False, 4, 4.0, successors=(2,)),
         C("sink", 1, False, 2, 4.0)],
    ]
    topo = pt.build_topology(apps, gamma=64.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs("fat-tree", sd)
    placement = pt.t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                     max_per_container=4)
    rng = np.random.default_rng(3)
    unit = pt.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(T + W + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((T + W + 1, *unit.shape)) < 0.8
    return topo, net, placement, (arr * (unit > 0)).astype(np.float32)


def fleet_system(pt, I_target, T):
    """4 serving chains src -> serve -> sink (C=12, gamma=32) on fat_tree(4)
    with 8 containers per server; Poisson arrivals at utilization 0.85."""
    chains, per = 4, I_target // 4
    src = sink = max(per // 8, 1)
    C = pt.Component
    apps = [[C("src", a, True, parallelism=src, successors=(1,)),
             C("serve", a, False, parallelism=per - src - sink, proc_capacity=4.0,
               successors=(2,)),
             C("sink", a, False, parallelism=sink, proc_capacity=8.0)] for a in range(chains)]
    topo = pt.build_topology(apps, gamma=32.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs(f"cohort-fleet-{topo.n_instances}", sd, containers_per_server=8)
    rng = np.random.default_rng(0)
    placement = rng.integers(0, net.n_containers, topo.n_instances).astype(np.int32)
    rates = pt.feasible_rates(topo, utilization=0.85)
    return topo, net, placement, pt.poisson_arrivals(rng, rates, T + 8)


def paper_system(pt, T):
    """The paper's §5.1 profile of benchmarks/common.py:99 (fat-tree, seed 0)
    with Poisson arrivals of seed 7."""
    rng = np.random.default_rng(0)
    topo = pt.build_topology(pt.random_apps(rng, n_apps=5), gamma=24.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs("fat-tree", sd)
    rates = pt.feasible_rates(topo, utilization=0.7)
    placement = pt.t_heron_placement(topo, net, rates, max_per_container=8)
    arr = pt.poisson_arrivals(np.random.default_rng(7), rates, T + 64)
    return topo, net, placement, arr


def step_inputs(cf, topo, net, placement, arr, T, W, V, beta, age_cap, device):
    """StepConsts, initial state and (T, I, C) streams on ``device``."""
    import torch

    from repro_torch.core.compact import kernel_layout

    f32 = dict(dtype=torch.float32, device=device)
    prob = cf._compact_prob(topo, placement, device)
    cpt = cf._compact(topo)
    act, pred, nxt, q0 = cf._prep_streams(arr, None, T, W, cpt, cf._stream_mask(topo))
    dev = cf._device_inputs(topo, net, cpt, device)
    C = topo.n_components
    layout = tuple(torch.as_tensor(x, dtype=torch.int32, device=device)
                   for x in kernel_layout(topo.inst_comp, placement, C, net.U.shape[0]))
    onehot = torch.nn.functional.one_hot(prob.inst_comp.long(), C).to(torch.float32)
    consts = cf._step_consts(prob, onehot, dev["U"], dev["mu"], dev["inv_service"],
                             dev["sel_cmp"], dev["stream_cmp"], dev["valid_cmp"],
                             dev["succ_map"], dev["term_f"], dev["adj_rows"],
                             torch.tensor(V, **f32), torch.tensor(beta, **f32), layout)
    I, Sc, W1 = q0.shape
    A = age_cap + W1
    state = (torch.as_tensor(q0, **f32), torch.zeros((I, Sc), **f32),
             torch.zeros((I, A), **f32), torch.zeros((I, Sc, A), **f32),
             torch.zeros((I, A), **f32), torch.zeros((C, T + A), **f32),
             torch.zeros((C, T + A), **f32))
    streams = tuple(torch.as_tensor(np.ascontiguousarray(x), **f32) for x in (act, pred, nxt))
    return consts, state, streams


def run_slots(step, consts, state, streams, K, scheduler, age_cap, T=None):
    """T slots through ``step`` in launches of K; returns (state, (4, T)
    metrics), or (4, N, T) for a batch of N scenarios (streams (T, I, C)
    shared or (N, T, I, C) stacked)."""
    import torch

    act, pred, nxt = streams
    T = act.shape[-3] if T is None else T
    mets = []
    for t0 in range(0, T, K):
        n = min(K, T - t0)
        sl = (..., slice(t0, t0 + n), slice(None), slice(None))
        state, m = step(consts, state, act[sl], pred[sl], nxt[sl], t0,
                        scheduler=scheduler, age_cap=age_cap, n_slots=n)
        mets.append(torch.stack(m))
    return state, torch.cat(mets, dim=-1)


def batch_inputs(cf, sys_, T, W, Vs, betas, age_cap, device, stacked):
    """One partition's slot-kernel inputs for N = len(Vs) scenarios: the
    batched constants (V and beta (N,)), state and streams — shared, or
    stacked with scenario n's arrivals rolled by n slots — and each
    scenario's own (consts, state, streams)."""
    import torch

    topo, net, placement, arr = sys_
    one = [step_inputs(cf, topo, net, placement, np.roll(arr, n, axis=0) if stacked else arr,
                       T, W, V, beta, age_cap, device)
           for n, (V, beta) in enumerate(zip(Vs, betas))]
    f32 = dict(dtype=torch.float32, device=device)
    consts = one[0][0]._replace(V=torch.tensor(Vs, **f32), beta=torch.tensor(betas, **f32))
    state = tuple(torch.stack([o[1][q] for o in one]) for q in range(7))
    streams = (tuple(torch.stack([o[2][q] for o in one]) for q in range(3)) if stacked
               else one[0][2])
    return consts, state, streams, one


def max_abs(a_state, a_met, b_state, b_met) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in zip(tuple(a_state) + (a_met,), tuple(b_state) + (b_met,)))


def bytes_and_ops(consts, state, n_slots, stacked=False):
    """What one call must move (each input read once, each output written
    once) and the arithmetic it does, counted from the shapes. A batch of N
    scenarios (``state`` with its leading axis, ``consts.V`` (N,)) moves
    its state and metrics N times, the shared constants once, and the
    (K, I, C) arrival streams once if shared, N times if ``stacked``."""
    q_rem, admit, q_in, q_out, transit, rmass, rtime = state
    N = q_rem.shape[0] if q_rem.dim() == 4 else 1
    I, S, W1 = q_rem.shape[-3:]
    A = q_in.shape[-1]
    C = consts.adj_rows.shape[1]
    NK = consts.U.shape[0]
    state_floats = sum(x.numel() for x in state)
    const_floats = (sum(x.numel() for x in consts[:17]) - consts.comp_onehot.numel()
                    + sum(x.numel() for x in consts[17:]))
    stream_floats = (N if stacked else 1) * 3 * n_slots * I * C
    floats = 2 * state_floats + const_floats + stream_floats + 4 * N * n_slots
    ops = N * n_slots * (3 * NK * I + I * (2 * C * C + 10 * S * (A + 1) + 12 * A + 20 * C))
    return 4 * floats, ops


#: the records of its named functions a trace of :func:`device_ms` holds at least
TRACE_RECORDS = 200


def time_calls(fn, n):
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n, parts=None, expect=None):
    """Device ms per call of ``fn``, from a ``torch.profiler`` trace of ``n``
    calls: for each device function, its mean duration per record times its
    launches per call, summed. Unlike ``time_calls``, the host's cost of
    launching is left out, so a call that costs the host more than the card
    is not timed at the host's rate.

    On the card the profiler drops a number of each trace's device records
    as out of its window (kineto's "Out-of-range" count, seen with
    ``KINETO_LOG_LEVEL=1``): about the same number in a trace of 20 records
    as in one of 500,000, and more the longer the process has run (3 after
    a minute, 20-22 after five). A mean over the records kept is not
    shortened by that, but a function whose records are all dropped would
    leave the sum. So ``expect``, a dict {kernel name: launches per call}
    (the name without ``void``, template arguments and parameters), names
    the functions a call must show and gives their launches per call; ``n``
    is raised until the trace holds ``TRACE_RECORDS`` records of them; and a
    trace in which one of them has no record, or that has no device record
    at all, is printed (:func:`trace_window`) and taken again, failing the
    check after three. Functions not in ``expect`` count records / n
    launches per call, rounded, at least one. ``parts``, a dict, receives
    the ms per call of each name."""
    import torch

    fn()
    torch.cuda.synchronize()
    expect = expect or {}
    if expect:
        n = max(n, -(-TRACE_RECORDS // sum(expect.values())))
    for _attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = device_times(prof)
        seen = {kernel_base(name) for name, _, _ in rows}
        if rows and seen.issuperset(expect):
            per_call = {name.split("(")[0]: ms / count * expect.get(kernel_base(name),
                                                                    max(1, round(count / n)))
                        for name, count, ms in rows}
            if parts is not None:
                parts.update(per_call)
            return sum(per_call.values())
        print(f"  device_ms: a trace of {n} calls holds no record of "
              f"{sorted(set(expect) - seen) or 'any device function'}: "
              f"{trace_window(prof, expect)}")
    check(False, f"device_ms: three traces of {n} calls held no device records, or none of "
                 f"{sorted(expect)}")


def kernel_base(name):
    """A device function's name without ``void``, template arguments and
    parameters."""
    return name.removeprefix("void ").split("<")[0].split("(")[0]


def trace_window(prof, names):
    """Where a trace's device records fall, for a trace that lost some: the
    host span (first host event to last), the kernel launches in it, and,
    for each of ``names`` (all device functions when empty), its records,
    their first start and last end from the host span's start (ms)."""
    import torch

    host, launches, kept = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            base = kernel_base(e.name())
            if not names or base in names:
                kept.setdefault(base, []).append((e.start_ns(), e.end_ns()))
        else:
            host.append((e.start_ns(), e.end_ns()))
            if "LaunchKernel" in e.name():
                launches.append(e.start_ns())
    if not host:
        return "no host events"
    t0, t1 = min(h[0] for h in host), max(h[1] for h in host)
    at = lambda t: f"{(t - t0) / 1e6:.3f}"  # noqa: E731
    text = (f"host span {at(t1)} ms, {len(launches)} launches"
            + (f" from {at(min(launches))} to {at(max(launches))} ms" if launches else ""))
    for base, recs in kept.items():
        text += (f"; {base}: {len(recs)} records from {at(min(r[0] for r in recs))} to "
                 f"{at(max(r[1] for r in recs))} ms")
    return text


def device_times_raw(prof):
    """:func:`device_times` from the trace's raw device records, without
    building the profiler's event tree (which takes minutes for a trace of
    hundreds of thousands of launches); :func:`device_times` where the raw
    records are not exposed."""
    import torch

    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return device_times(prof)
    agg = {}
    for evt in results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA or evt.is_user_annotation():
            continue
        ns = evt.duration_ns() if hasattr(evt, "duration_ns") else evt.duration_us() * 1e3
        row = agg.setdefault(evt.name(), [0, 0.0])
        row[0] += 1
        row[1] += ns / 1e6
    return sorted(((name, count, ms) for name, (count, ms) in agg.items()), key=lambda r: -r[2])


def device_times(prof):
    """(name, count, device ms) per device-side event name, longest first.
    A ``record_function`` span shows on the device timeline too; it is a range
    over kernels already counted, so it is left out."""
    import torch

    rows = []
    for evt in prof.key_averages():
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((evt.key, evt.count, us / 1e3))
    return sorted(rows, key=lambda r: -r[2])


# ---------------------------------------------------------------------------
# the plain scan engine (engine="jax") and its two kernels
# ---------------------------------------------------------------------------

def sched_args(prob, U, state, pq):
    """The kernels' inputs at one slot: (U, q_in, q_out, kc, comp, mask)."""
    return (U, state.q_in, pq.effective_qout(prob, state), prob.inst_container,
            prob.inst_comp, prob.edge_mask)


def kernel_bound(args, gamma=None):
    """Bytes (each input read once, X or l written once) and operations
    (five per DAG edge of this state, plus the water-fill per row) of one
    call of the schedule (``gamma`` given) or the price kernel."""
    U, q_in, q_out, kc, comp, mask = args
    I, C = q_out.shape
    nbytes = sum(x.numel() * x.element_size() for x in args) + 4 * I * I
    nops = 5 * int(mask.sum())
    if gamma is not None:
        nbytes += gamma.numel() * 4
        nops += I * C * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, nops


def max_err(a, b) -> float:
    """Largest |a - b| over the entries finite in both; +inf must sit in the
    same places (checked by the caller)."""
    import torch

    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin].double() - b[fin].double()).abs().max()) if bool(fin.any()) else 0.0


def prices_close(lk, lp) -> bool:
    """+inf in the same places, finite entries within rtol/atol 1e-5."""
    import torch

    fin = torch.isfinite(lp)
    return (torch.equal(torch.isinf(lk), torch.isinf(lp))
            and torch.allclose(lk[fin], lp[fin], rtol=1e-5, atol=1e-5))


def check_price_and_schedule(kp, ks, args, gamma, V, beta, label, exact):
    """Kernel 3 and kernel 2 against their plain versions on one input;
    returns the two max_abs_err."""
    import torch

    lk, lp = kp.potus_price_call(*args, V, beta), kp.potus_price_plain(*args, V, beta)
    xk = ks.potus_schedule_call(*args, gamma, V, beta)
    xp = ks.potus_schedule_alloc_plain(*args, gamma, V, beta)
    torch.cuda.synchronize()
    check(torch.equal(torch.isinf(lk), torch.isinf(lp)), f"{label}: price +inf places differ")
    e_l, e_x = max_err(lk, lp), max_err(xk, xp)
    if exact:
        check(torch.equal(lk, lp), f"{label}: price kernel differs from the plain version")
        check(torch.equal(xk, xp), f"{label}: schedule kernel differs from the plain version")
    else:
        check(prices_close(lk, lp), f"{label}: price kernel beyond rtol/atol 1e-5")
        check(torch.allclose(xk, xp, rtol=1e-5, atol=1e-5),
              f"{label}: schedule kernel beyond rtol/atol 1e-5")
    return e_l, e_x


def random_problem(seed, I, K, C, cuda):
    """``tests/test_kernels.py:176-181`` inputs, from numpy: integer grids."""
    import torch

    rng = np.random.default_rng(seed)
    comp = rng.integers(0, C, I).astype(np.int32)
    mask = (rng.random((I, I)) < 0.25) & (comp[:, None] != comp[None, :])
    U = rng.integers(0, 5, (K, K)).astype(np.float32)
    q_in = rng.integers(0, 8, I).astype(np.float32)
    q_out = rng.integers(0, 8, (I, C)).astype(np.float32)
    gamma = rng.integers(1, 12, I).astype(np.float32)
    kc = rng.integers(0, K, I).astype(np.int32)
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    return (t(U), t(q_in), t(q_out), t(kc), t(comp), t(mask)), t(gamma)


def price_problem(seed, I, K, C, cuda):
    """``tests/test_kernels.py:127-131`` inputs, from numpy: uniform floats."""
    import torch

    rng = np.random.default_rng(seed)
    U = rng.uniform(0, 6, (K, K)).astype(np.float32)
    q_in = rng.uniform(0, 20, I).astype(np.float32)
    q_out = rng.uniform(0, 20, (I, C)).astype(np.float32)
    kc = rng.integers(0, K, I).astype(np.int32)
    comp = rng.integers(0, C, I).astype(np.int32)
    mask = rng.random((I, I)) < 0.2
    t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    return (t(U), t(q_in), t(q_out), t(kc), t(comp), t(mask)), None


def dyadic_scan_checks(pt, kp, ks, cuda):
    """Kernels 2 and 3 against their plain versions on every slot's state of
    a reference-length run of the dyadic system: bitwise."""
    import torch

    from repro_torch.core import potus as pp
    from repro_torch.core import queues as pq
    from repro_torch.core import simulator as psim
    from repro_torch.kernels import ops as kops

    T, W, V, beta = 120, 2, 2.0, 0.5
    topo, net, placement, arr = dyadic_system(pt, T, W)
    prob = pp.make_problem(topo, net, placement, cuda)
    state = pq.init_state(topo, W, arr[:W + 1], cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    U = torch.as_tensor(net.U, **f32)
    kc = prob.inst_container.long()
    u_pair = U[kc[:, None], kc[None, :]]
    mu = torch.as_tensor(topo.inst_mu, **f32)
    sel = torch.as_tensor(topo.selectivity[topo.inst_comp], **f32)
    sched = partial(pp._schedule_with, kops.plain)  # the run itself takes the plain route
    shipped = 0
    for t in range(T):
        args = sched_args(prob, U, state, pq)
        check_price_and_schedule(kp, ks, args, prob.gamma, V, beta, f"dyadic t={t}", True)
        shipped += int((ks.potus_schedule_alloc_plain(*args, prob.gamma, V, beta) > 0).sum())
        state, _ = psim.sim_step(prob, sched, U, u_pair, mu, sel, V, beta, state,
                                 torch.as_tensor(arr[t + W + 1], **f32))
    check(shipped > 0, "dyadic: the greedy shipped nothing; the check would be vacuous")
    print(f"dyadic scan engine T={T}: price and schedule kernels vs plain bitwise on every "
          f"slot (max_abs_err 0.0; {shipped} greedy allocations)")


def one_call(kp, ks, pq, convert, prob, U, mid_state, cuda, card):
    """Kernels 2 and 3 once at I=16384 from a mid-run state: bitwise equal to
    their plain versions (+inf in the same places), device ms per call (a
    ``torch.profiler`` trace) beside the event-timed ms (CUDA events, warmed
    up), plain ms, bound."""
    import torch

    state = convert.sim_state_from_numpy(mid_state, device=cuda)
    args = sched_args(prob, U, state, pq)
    out = {}
    for name, call, plain, gamma in (
            ("potus_schedule", ks.potus_schedule_call, ks.potus_schedule_alloc_plain,
             prob.gamma),
            ("potus_price", kp.potus_price_call, kp.potus_price_plain, None)):
        extra = () if gamma is None else (gamma,)
        k = call(*args, *extra, FLEET_V, 1.0)
        p = plain(*args, *extra, FLEET_V, 1.0)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(k), torch.isinf(p)),
              f"one {name} call at I={FLEET_I}: +inf places differ from the plain version")
        err = max_err(k, p)
        check(torch.equal(k, p), f"one {name} call at I={FLEET_I}: kernel differs from the "
              f"plain version (max_abs_err {err:.3e}); both repeat one operation order")
        del k, p
        dev_ms = device_ms(lambda: call(*args, *extra, FLEET_V, 1.0), 20)
        ms = time_calls(lambda: call(*args, *extra, FLEET_V, 1.0), 20)
        plain_ms = time_calls(lambda: plain(*args, *extra, FLEET_V, 1.0), 3)
        bound_ms, bound_by, nbytes, nops = kernel_bound(args, gamma)
        print(f"one {name} call at I={FLEET_I} (mid-run state, t=64): max_abs_err={err:.3e} "
              f"device ms per call: kernel {dev_ms:.4f}; event ms per call: kernel {ms:.4f}, "
              f"plain {plain_ms:.4f}; bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, "
              f"{nops} ops) [{card}]")
        out[name] = dict(max_abs_err=err, ms=dev_ms, device_ms=dev_ms, event_ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    return out


def profile_run(fn, top=8, suffix="", also=()):
    """Device busy share and the top device items of one profiled run, and
    the items whose name starts with one of ``also`` wherever they rank. The
    trace's raw device records are read (:func:`device_times_raw`), which
    keeps a run of hundreds of thousands of launches quick to read."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    t_read = time.perf_counter()
    rows = device_times_raw(prof)
    print(f"  trace read in {time.perf_counter() - t_read:.1f} s{suffix}")
    busy_ms = sum(r[2] for r in rows)
    if busy_ms > 0:
        print(f"  device busy {busy_ms:.3f} ms of {prof_ms:.3f} ms wall: "
              f"share {busy_ms / prof_ms:.4f} (profiled run){suffix}")
        for i, (name, count, ms) in enumerate(rows):
            if i < top or name.split("<")[0].split("(")[0].removeprefix("void ").startswith(also):
                print(f"    {ms:10.3f} ms  x{count:<6d} {name[:90]}{suffix}")
    else:
        print(f"  device busy share: not measured (the profiler saw no device time){suffix}")
    return busy_ms, prof_ms


def wall_and_issue(fn, n):
    """Wall ms of ``n`` synchronised calls of ``fn``, and the host's ms until
    each call returns (everything issued, before the synchronize): where the
    two meet, the host sets the wall."""
    import torch

    walls, issued = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        issued.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return np.array(walls), np.array(issued)


def timed_runs(fn, T, n):
    """Wall ms per slot of ``n`` synchronised runs."""
    return wall_and_issue(fn, n)[0] / T


SERIES = ("backlog", "comm_cost", "q_in_total", "q_out_total", "served_total")


def compare_scan_routes(label, psim, plain_ops, sys_, T, cfg, cuda, events=None,
                        kernel=None):
    """The kernel route (``kernel``: a result already run, else run here)
    against the plain route of ``_run_sim_impl``: per-slot backlog and cost
    within rtol 1e-4 over the first 16 slots, long-run means within 2%."""
    import torch

    topo, net, placement, arr = sys_
    t_a = time.perf_counter()
    a = kernel if kernel is not None else psim._run_sim_impl(topo, net, placement, arr, T,
                                                             cfg, events=events, device=cuda)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    b = psim._run_sim_impl(topo, net, placement, arr, T, cfg, events=events, device=cuda,
                           ops=plain_ops)
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]), rel_diff(a.comm_cost[:16],
                                                                  b.comm_cost[:16]))
    means = max(rel_diff(a.avg_backlog, b.avg_backlog), rel_diff(a.avg_cost, b.avg_cost))
    for name in SERIES:
        check(np.isfinite(getattr(a, name)).all() and getattr(a, name).shape == (T,),
              f"{label}: {name} not finite or of the wrong shape")
    kernel_ms = "ran above" if kernel is not None else f"{(t_b - t_a) * 1e3 / T:.3f} ms/slot"
    print(f"{label} {cfg.scheduler} T={T}: kernel route {kernel_ms}, plain route "
          f"{(t_c - t_b) * 1e3 / T:.3f} ms/slot; first 16 slots rel diff {r16:.3e}, means "
          f"{means:.3e}; avg_backlog {a.avg_backlog!r}/{b.avg_backlog!r} "
          f"avg_cost {a.avg_cost!r}/{b.avg_cost!r}")
    check(r16 <= 1e-4 and means <= 0.02, f"{label} {cfg.scheduler}: kernel route vs plain")


def scan_engine(pt, card, cuda):
    """Everything of the plain scan engine: checks, one call of each kernel,
    main path 2 and its loop route, the route comparisons. Returns the two
    kernels' entries of the kernels line."""
    import torch

    from repro_torch import convert
    from repro_torch.core import potus as pp
    from repro_torch.core import queues as pq
    from repro_torch.core import simulator as psim
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks

    # -- kernels 2 and 3 against their plain versions ----------------------------
    dyadic_scan_checks(pt, kp, ks, cuda)
    for shape in ((60, 8, 6), (128, 16, 10), (96, 4, 3), (250, 32, 24)):
        args, gamma = random_problem(0, *shape, cuda)
        e_l, e_x = check_price_and_schedule(kp, ks, args, gamma, 2.0, 1.0, f"random {shape}",
                                            False)
        print(f"random (I, K, C)={shape}: schedule max_abs_err={e_x:.3e}, price {e_l:.3e} "
              "(rtol/atol 1e-5)")
    for shape in ((60, 8, 12), (128, 32, 16), (256, 16, 24)):
        args, _ = price_problem(0, *shape, cuda)
        lk, lp = kp.potus_price_call(*args, 3.0, 1.0), kp.potus_price_plain(*args, 3.0, 1.0)
        check(prices_close(lk, lp), f"price {shape}: beyond rtol/atol 1e-5 or +inf elsewhere")
        err = max_err(lk, lp)
        print(f"random price (I, K, C)={shape}: max_abs_err={err:.3e} bitwise="
              f"{torch.equal(lk, lp)}")

    # -- one call of each at I=16384, from a mid-run state -----------------------
    sys_ = fleet_system(pt, FLEET_I, FLEET_T)
    topo, net, placement, arr = sys_
    cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus")
    mid = psim._run_sim_impl(topo, net, placement, arr, 64, cfg, device=cuda)
    prob = pp.make_problem(topo, net, placement, cuda)
    U = torch.as_tensor(net.U, dtype=torch.float32, device=cuda)
    calls = one_call(kp, ks, pq, convert, prob, U, mid.final_state, cuda, card)
    del prob, mid
    torch.cuda.empty_cache()

    # -- main path 2: engine="jax", potus, I=16384 -------------------------------
    spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                         engine="jax", scheduler="potus", V=FLEET_V, window=FLEET_W,
                         device="cuda")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = pt.simulate(spec)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / FLEET_T
    n = read_counts()
    n_sched = n["potus_schedule"]
    peak = torch.cuda.max_memory_allocated()
    print(f"main path 2: engine=jax potus I={FLEET_I} T={FLEET_T} launches: " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f"; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB, of which {held} bytes were held before the run)")
    check(n == dict(ZERO_COUNTS, potus_schedule=FLEET_T), f"main path 2 launches {n}")
    res2 = pt.simulate(spec)
    same = all(np.array_equal(getattr(res1, f), getattr(res2, f)) for f in SERIES) and all(
        np.array_equal(getattr(res1.final_state, f), getattr(res2.final_state, f))
        for f in ("q_in", "q_rem", "q_out_bolt", "transit"))
    print(f"  two runs bitwise identical: {same}")
    check(same, "main path 2: two runs differ")
    for name in SERIES:
        check(np.isfinite(getattr(res1, name)).all()
              and getattr(res1, name).shape == (FLEET_T,),
              f"main path 2: {name} not finite or of the wrong shape")
    check(float(res1.served_total.sum()) > 0, "main path 2: nothing was served")
    per_slot = timed_runs(lambda: pt.simulate(spec), FLEET_T, 4)
    print(f"  wall ms/slot over {len(per_slot)} timed runs: median {np.median(per_slot):.4f}, "
          f"min {per_slot.min():.4f}, max {per_slot.max():.4f} (first run {first_ms:.4f}) "
          f"[{card}]")
    setup = timed_runs(lambda: pt.simulate(dataclasses.replace(spec, T=0)), 1, 2)
    print(f"  set-up alone (a T=0 run: arrivals, problem, state and u_pair on the card): "
          f"{setup[0]:.3f} and {setup[1]:.3f} ms [{card}]")
    print(f"  avg_backlog={res1.avg_backlog!r} avg_cost={res1.avg_cost!r} "
          f"served_total_mean={float(res1.served_total.mean())!r} [{card}]")
    profile_run(lambda: pt.simulate(spec))

    # -- kernel route against plain route ----------------------------------------
    compare_scan_routes("fleet", psim, kops.plain, sys_, FLEET_T, cfg, cuda, kernel=res1)
    del res1, res2
    torch.cuda.empty_cache()

    # the potus-loop route (kernel 3), through the facade, counted
    loop_sys = fleet_system(pt, LOOP_I, FLEET_T)
    loop_spec = pt.EngineSpec(topo=loop_sys[0], net=loop_sys[1], placement=loop_sys[2],
                              arrivals=loop_sys[3], T=FLEET_T, engine="jax",
                              scheduler="potus-loop", V=FLEET_V, window=FLEET_W, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop_res = pt.simulate(loop_spec)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3 / FLEET_T
    n = read_counts()
    n_loop_price = n["potus_price"]
    print(f"potus-loop route: engine=jax I={LOOP_I} T={FLEET_T} launches: " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f"; {loop_ms:.3f} ms/slot [{card}]")
    check(n == dict(ZERO_COUNTS, potus_price=FLEET_T), f"potus-loop route launches {n}")
    loop_cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus-loop")
    compare_scan_routes(f"fleet I={LOOP_I}", psim, kops.plain, loop_sys, FLEET_T, loop_cfg,
                        cuda, kernel=loop_res)
    compare_scan_routes("paper", psim, kops.plain, paper_system(pt, 300), 300,
                        pt.SimConfig(V=2.0, window=2, scheduler="potus-loop"), cuda)
    compare_scan_routes("fleet rolling-restart", psim, kops.plain, sys_, 64, cfg, cuda,
                        events=fleet_restart(pt, topo, 64))

    entry = dict(route="cuda")
    return [
        {"name": "potus_schedule", **entry,
         "source": "src/repro_torch/kernels/csrc/potus_schedule.cu",
         "replaces": "src/repro/kernels/potus_schedule.py:35", "launches": n_sched,
         **calls["potus_schedule"], "library_ms": None},
        {"name": "potus_price", **entry, "source": "src/repro_torch/kernels/csrc/potus_price.cu",
         "replaces": "src/repro/kernels/potus_price.py:26", "launches": n_loop_price,
         **calls["potus_price"], "library_ms": None},
    ]


# ---------------------------------------------------------------------------
# the fused cohort engine's dense route (kernel 4) and its events route
# ---------------------------------------------------------------------------

def fleet_restart(pt, topo, T):
    """16 instances (a src and three serve per chain) restart 3 slots apart, 8
    slots each: the restarts run from slot 8 to slot 61 of a T=64 run."""
    restart = [int(i) for c in range(topo.n_components) if c % 3 < 2
               for i in topo.instances_of(c)[:1 if c % 3 == 0 else 3]]
    events = pt.rolling_restart(topo, start=8, down_slots=8, stagger=3,
                                instances=restart).compile(topo, T)
    check(len(restart) == 16 and (events.alive_t == 0).any(axis=1)[8:61].all(),
          "rolling restart: the restarts do not fall inside the run")
    return events


def drain_problem(seed, I, C, Atot, dyadic, cuda):
    """Kernel 4's inputs from numpy: the uniform draw of
    tests/test_cohort_fused.py:407-411, or a dyadic one (integer src and
    ship, ratio in {0, 1/4, 1/2, 1}); components at random."""
    import torch

    rng = np.random.default_rng(seed)
    comp = rng.integers(0, C, I).astype(np.int32)
    if dyadic:
        src = (rng.integers(0, 5, (I, C, Atot + 1))
               * (rng.random((I, C, Atot + 1)) < 0.5)).astype(np.float32)
        ship = rng.integers(0, 12, (I, C)).astype(np.float32)
        ratio = rng.choice(np.array([0.0, 0.25, 0.5, 1.0], np.float32), (I, I))
    else:
        src = (rng.uniform(0, 4, (I, C, Atot + 1))
               * (rng.random((I, C, Atot + 1)) < 0.4)).astype(np.float32)
        ship = rng.uniform(0, 10, (I, C)).astype(np.float32)
        ratio = (rng.uniform(0, 1, (I, I)) * (rng.random((I, I)) < 0.3)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=cuda) for x in (src, ship, ratio, comp))


def exact_inputs(src, ship, ratio) -> bool:
    """Inputs on which every product and partial sum of kernel 4 is exact:
    integral masses and split ratios that are multiples of 1/64."""
    import torch

    return all(torch.equal(x, torch.round(x)) for x in (src * 64, ship * 64, ratio * 64))


def check_drain(kd, args, age_bucket, label):
    """Kernel 4 against its plain version on one input: bitwise where the
    inputs are exact, else rtol/atol 1e-5; returns (max_abs_err, bitwise)."""
    import torch

    k = kd.cohort_drain_call(*args, age_bucket)
    p = kd.cohort_drain_split_plain(*args, age_bucket)
    k2 = kd.cohort_drain_call(*args, age_bucket)
    torch.cuda.synchronize()
    err = float((k.double() - p.double()).abs().max()) if k.numel() else 0.0
    check(torch.equal(k, k2), f"{label}: two kernel runs differ")
    if exact_inputs(*args[:3]):
        check(torch.equal(k, p), f"{label}: kernel differs from the plain version on exact "
              f"inputs (max_abs_err {err:.3e})")
    else:
        check(torch.allclose(k, p, rtol=1e-5, atol=1e-5),
              f"{label}: kernel beyond rtol/atol 1e-5 (max_abs_err {err:.3e})")
    return err, torch.equal(k, p)


def drain_checks(pt, cuda):
    """Kernel 4 against its plain version: on the random and dyadic draws of
    tests/test_torch_cohort_drain.py, and on every slot's inputs of a dyadic
    run of the dense route (which itself takes the plain route)."""
    from types import SimpleNamespace

    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import ops as kops

    for shape in ((24, 5, 13, 8), (40, 3, 21, 16), (64, 7, 9, 0), (300, 12, 69, 64)):
        I, C, Atot, ab = shape
        for dyadic in (False, True):
            err, same = check_drain(kd, drain_problem(0, I, C, Atot, dyadic, cuda), ab,
                                    f"drain {shape} dyadic={dyadic}")
            print(f"drain (I, C, Atot, age_bucket)={shape} {'dyadic' if dyadic else 'uniform'}: "
                  f"max_abs_err={err:.3e} bitwise={same}")
    T, W, AC = 40, 1, 16
    topo, net, placement, arr = dyadic_system(pt, T, W)
    seen = {"slots": 0, "exact": 0}

    def both(*args):
        err, same = check_drain(kd, args[:4], args[4], f"dyadic dense t={seen['slots']}")
        seen["slots"] += 1
        seen["exact"] += exact_inputs(*args[:3])
        return kops.plain.cohort_drain_split(*args)

    ops = SimpleNamespace(**vars(kops.plain))
    ops.cohort_drain_split = both
    cf._run_cohort_fused_impl(topo, net, placement, arr, None, T,
                              pt.SimConfig(V=2.0, window=W, scheduler="potus-loop"),
                              age_cap=AC, device=cuda, ops=ops)
    check(seen["slots"] == T, "dyadic dense run: the drain ran on fewer slots than T")
    print(f"dyadic dense route T={T}: drain kernel vs plain on every slot, {seen['exact']} of "
          f"{T} slots with exact inputs checked bitwise, the rest within 1e-5")


def drain_bound(args, age_bucket):
    """Bytes (each input read once, land written once) and operations (the
    drain, ~5 per bucket, and 2 * Atot per nonzero ratio entry of this
    input) of one kernel-4 call; also the dense own-plane count 2 * I^2 * Atot."""
    src, ship, ratio, comp = args
    I, C, Aext = src.shape
    Atot = Aext - 1
    nbytes = sum(x.numel() * x.element_size() for x in args) + 4 * I * Atot
    nnz = int((ratio != 0).sum())
    nops = 5 * src.numel() + 2 * Atot * nnz
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, nops / PEAK_F32_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes,
            nops, nnz, 2 * I * I * Atot / PEAK_F32_S * 1e3)


def fleet_inputs(pt, cf, cuda):
    """The I=16384 fleet, its step constants, initial state and streams."""
    fleet = fleet_system(pt, FLEET_I, FLEET_T)
    check(fleet[0].n_instances == FLEET_I, "fleet size")
    return (fleet, *step_inputs(cf, *fleet, FLEET_T, FLEET_W, FLEET_V, 1.0, FLEET_AGE_CAP,
                                cuda))


def fleet_mid(ps, consts, state0, streams):
    """Path 1's state after 64 slots of the slot kernel (launches of 8)."""
    return run_slots(ps.potus_slot_call, consts, state0, streams, 8, "potus", FLEET_AGE_CAP,
                     T=64)[0]


def dense_stepper(pt, cf, fleet, consts, streams, cuda):
    """``step(ops, state, t, drain_split=None)``: one slot of the dense
    potus-loop route's ``_fused_step`` on the I=16384 fleet, from any state,
    with the sort scheduler (kernel 2 on the kernel route)."""
    from repro_torch.core import potus as pp

    topo, net, placement, _ = fleet
    dense = pp.make_problem(topo, net, placement, cuda)
    edges = cf._compact(topo).edges
    u_pair = pp._u_pair(consts.U, dense.inst_container)
    act, pred, nxt = streams

    def step(ops, state, t, drain_split=None):
        sched = partial(pp._schedule_with, ops, method="sort")
        return cf._fused_step(consts, dense, sched, edges, u_pair, FLEET_V, 1.0, FLEET_AGE_CAP,
                              state, (act[t], pred[t], nxt[t], t),
                              drain_split=drain_split or ops.cohort_drain_split)

    return step


class _Captured(Exception):
    """Ends a run once the drain's inputs of the wanted slot are taken."""


def drain_args_fleet(step, mid):
    """Kernel 4's arguments at I=16384: one dense step from path 1's state at
    slot 64 (X from the sort scheduler). Returns ``(args, age_bucket)``."""
    from repro_torch.kernels import ops as kops

    captured = []

    def capture(*args):
        captured.append(args)
        return kops.plain.cohort_drain_split(*args)

    step(kops, mid, 64, drain_split=capture)
    return captured[0][:4], captured[0][4]


def drain_args_loop(pt, cf, cuda, t=64):
    """Kernel 4's arguments on route A's I=1024 fleet at slot ``t``: the dense
    potus-loop route on the card (kernel 3, the plain drain) run up to that
    slot. Returns ``(args, age_bucket)``."""
    from repro_torch.kernels import ops as kops

    topo, net, placement, arr = fleet_system(pt, LOOP_I, FLEET_T)
    seen = []

    def capture(*args):
        seen.append(args)
        if len(seen) > t:
            raise _Captured
        return kops.plain.cohort_drain_split(*args)

    ops = SimpleNamespace(**vars(kops.plain))
    ops.potus_price = kops.potus_price
    ops.cohort_drain_split = capture
    try:
        cf._run_cohort_fused_impl(topo, net, placement, arr, None, FLEET_T,
                                  pt.SimConfig(V=FLEET_V, window=FLEET_W,
                                               scheduler="potus-loop"),
                                  age_cap=FLEET_AGE_CAP, device=cuda, ops=ops)
    except _Captured:
        pass
    check(len(seen) == t + 1, f"route A ran {len(seen)} slots, not {t + 1}")
    return seen[t][:4], seen[t][4]


def drain_timing(kd, args, age_bucket, label, card):
    """Kernel 4 on one input: held against its plain version (bitwise on
    exact inputs, else rtol/atol 1e-5), two runs bitwise, something landed;
    then its device ms per call and per phase (a ``torch.profiler`` trace),
    the event-timed ms, the reached GB/s of the ratio read (its bytes over
    the phase that reads it) and that phase's ms on an all-zero ratio of the
    same shape (the stream without the products of the nonzeros), the plain
    version's ms, the library call's (``ratio.T @ land_src`` over all
    component planes, by device and by event) and the bound. Returns the
    numbers."""
    import torch

    from repro_torch.core.compact import drain_ages

    err, same = check_drain(kd, args, age_bucket, label)
    landed = float(kd.cohort_drain_split_plain(*args, age_bucket).sum())
    check(landed > 0, f"{label}: nothing landed")
    parts = {}
    dev = device_ms(lambda: kd.cohort_drain_call(*args, age_bucket), 20, parts=parts)
    ev = time_calls(lambda: kd.cohort_drain_call(*args, age_bucket), 20)
    plain_ms = time_calls(lambda: kd.cohort_drain_split_plain(*args, age_bucket), 5)
    src, ship, ratio, comp = args
    I, C, Aext = src.shape
    drained = drain_ages(src, ship)
    land_src = drained[:, :, :Aext - 1].clone()
    land_src[:, :, age_bucket] += drained[:, :, -1]
    lhs, rhs = ratio.T, land_src.reshape(I, C * (Aext - 1))
    lib_dev = device_ms(lambda: torch.matmul(lhs, rhs), 5)
    lib_ev = time_calls(lambda: torch.matmul(lhs, rhs), 5)
    del drained, land_src, lhs, rhs
    # the stream alone: the same call on an all-zero ratio, which has no products to take
    zero, stream_parts = torch.zeros_like(ratio), {}
    device_ms(lambda: kd.cohort_drain_call(src, ship, zero, comp, age_bucket), 20,
              parts=stream_parts)
    del zero
    bound_ms, bound_by, nbytes, nops, nnz, dense_ms = drain_bound(args, age_bucket)
    per_col = (ratio != 0).sum(dim=0)
    ratio_ms = sum(ms for name, ms in parts.items() if "phase_b" in name)
    stream_ms = sum(ms for name, ms in stream_parts.items() if "phase_b" in name)
    gb_s = ratio.numel() * ratio.element_size() / (ratio_ms * 1e-3) / 1e9 if ratio_ms else 0.0
    print(f"{label}: max_abs_err={err:.3e} bitwise={same}, two runs bitwise; device ms per "
          f"call: kernel {dev:.4f}; event ms per call: kernel {ev:.4f}, plain {plain_ms:.4f}; "
          f"ratio read at {gb_s:.1f} GB/s (phase B {ratio_ms:.4f} ms; on an all-zero ratio "
          f"{stream_ms:.4f}); library (the all-plane f32 matmul) device "
          f"{lib_dev:.4f} (event {lib_ev:.4f}); bound {bound_ms:.4f} ms ({bound_by}: {nbytes} "
          f"bytes, {nops} ops, {nnz} nonzero ratios of {I * I} in "
          f"{int((per_col > 0).sum())} columns, at most {int(per_col.max())} a column); dense "
          f"own-plane work 2*I^2*Atot would take {dense_ms:.4f} ms [{card}]")
    for name, ms in sorted(parts.items(), key=lambda r: -r[1]):
        print(f"  part {name[:60]}: {ms:.4f} ms per call")
    return dict(max_abs_err=err, device_ms=dev, event_ms=ev, parts=parts, ratio_gb_s=gb_s,
                stream_ms=stream_ms, plain_ms=plain_ms, library_ms=lib_dev,
                library_event_ms=lib_ev, bound_ms=bound_ms, bound_by=bound_by)


def drain_kernel(card, cuda, step=None, mid=None):
    """Kernel 4 alone at the shapes of its two paths, each held against its
    plain version and timed by device and by phase (:func:`drain_timing`):
    phase D's I=16384 input (path 1's state at slot 64, one dense step) and
    route A's I=1024 input at slot 64; and one dense step at I=16384 from
    slot 64, wall-timed. ``step`` (:func:`dense_stepper`) and
    ``mid`` come from the caller, or are built here from the fleet, so that
    two checkouts can be compared in turns on one card. Returns kernel 4's
    entry of the kernels line, its ``launches`` left to the caller."""
    import torch

    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import potus_slot as ps

    if step is None:
        fleet, consts, state0, streams = fleet_inputs(pt, cf, cuda)
        mid = fleet_mid(ps, consts, state0, streams)
        step = dense_stepper(pt, cf, fleet, consts, streams, cuda)
    args, age_bucket = drain_args_fleet(step, mid)
    big = drain_timing(kd, args, age_bucket, f"one cohort_drain call at I={FLEET_I} (path 1's "
                       "state at t=64, X from the sort scheduler)", card)
    del args
    walls, issued = wall_and_issue(lambda: step(kops, mid, 64), 8)
    print(f"one dense step at I={FLEET_I} from t=64 (kernels 2 and 4): wall ms over 8: median "
          f"{np.median(walls):.4f}, min {walls.min():.4f}, max {walls.max():.4f}; host ms to "
          f"issue it: median {np.median(issued):.4f} [{card}]")
    torch.cuda.empty_cache()
    args, age_bucket = drain_args_loop(pt, cf, cuda)
    small = drain_timing(kd, args, age_bucket, f"one cohort_drain call at I={LOOP_I} (route "
                         "A's state at t=64, X from the argmin loop)", card)
    return {"name": "cohort_drain", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cohort_drain.cu",
            "replaces": "src/repro/kernels/cohort_drain.py:38", "launches": None,
            "ms": big["device_ms"], **big, "dense_step_ms": float(np.median(walls)),
            f"at_I{LOOP_I}": small}


def compare_cohort(label, cf, pt, sys_, T, cfg, cuda, against="plain", kernel=None, other=None,
                   **kw):
    """The card's kernel route (``kernel``: a result already run, else run
    here) against the plain route on the card (``against="plain"``), the
    port on the CPU (``"cpu"``) or the kernel route (``"kernel"``, for a
    ``kernel`` result of another route), ``other`` when that one has run
    already: per-slot backlog and cost within rtol 1e-4 over the first 16
    slots, long-run means within 2%."""
    import torch

    from repro_torch.kernels import ops as kops

    topo, net, placement, arr = sys_
    run = partial(cf._run_cohort_fused_impl, topo, net, placement, arr, None, T, cfg, **kw)
    t_a = time.perf_counter()
    a = kernel if kernel is not None else run(device=cuda)
    torch.cuda.synchronize()
    t_b = time.perf_counter()
    b = other if other is not None else {
        "plain": lambda: run(device=cuda, ops=kops.plain), "cpu": lambda: run(device="cpu"),
        "kernel": lambda: run(device=cuda)}[against]()
    torch.cuda.synchronize()
    t_c = time.perf_counter()
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
              rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
    means = max(rel_diff(a.avg_backlog, b.avg_backlog), rel_diff(a.avg_cost, b.avg_cost))
    check(np.isfinite(a.backlog).all() and np.isfinite(a.comm_cost).all()
          and a.backlog.shape == (T,) and a.completed_mass > 0,
          f"{label}: result not finite, of the wrong shape, or nothing completed")
    kernel_ms = "ran above" if kernel is not None else f"{(t_b - t_a) * 1e3 / T:.3f} ms/slot"
    other_ms = "ran above" if other is not None else f"{(t_c - t_b) * 1e3 / T:.3f} ms/slot"
    print(f"{label} {cfg.scheduler} T={T}: card {kernel_ms}, {against} {other_ms}; "
          f"first 16 slots rel diff {r16:.3e}, means "
          f"{means:.3e}; avg_backlog {a.avg_backlog!r}/{b.avg_backlog!r} "
          f"avg_response {a.avg_response!r}/{b.avg_response!r}")
    check(r16 <= 1e-4 and means <= 0.02, f"{label} {cfg.scheduler}: card vs {against}")
    return a, b


def same_result(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("backlog", "comm_cost")) \
        and all(getattr(a, f) == getattr(b, f) or (np.isnan(getattr(a, f))
                                                   and np.isnan(getattr(b, f)))
                for f in ("avg_response", "p95_response", "completed_mass", "saturated_frac"))


def counters():
    from repro_torch.kernels import cohort_drain as kd
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import potus_price as kp
    from repro_torch.kernels import potus_schedule as ks
    from repro_torch.kernels import potus_slot as ps
    from repro_torch.kernels import ssd_scan as kss

    return {"potus_slot": ps.launches, "potus_schedule": ks.launches,
            "potus_price": kp.launches, "cohort_drain": kd.launches,
            "flash_attention": kfa.launches, "decode_attention": kda.launches,
            "ssd_intra_chunk": kss.launches, "flash_attention_bwd": kfa.launches_bwd}


def route_counters():
    """The route counters of kernels 5, 6 and 5b: {kernel: (tensor cores, SIMT)}."""
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import flash_attention as kfa

    return {"flash_attention": (kfa.launches_tc, kfa.launches_simt),
            "decode_attention": (kda.launches_tc, kda.launches_simt),
            "flash_attention_bwd": (kfa.launches_bwd_tc, kfa.launches_bwd_simt)}


def kernel_routes():
    """Launches of each route of kernels 5, 6 and 5b (tensor cores, SIMT)
    since the last reset: {kernel: {"tc": n, "simt": n}}."""
    return {name: {"tc": tc.n, "simt": simt.n} for name, (tc, simt) in route_counters().items()}


def all_on_tensor_cores(n):
    """The routes expected when every launch of kernels 5, 6 and 5b in the
    counts ``n`` took the tensor cores (bf16 at their tensor-core head_dims)."""
    return {name: {"tc": n[name], "simt": 0} for name in route_counters()}


def reset_counts():
    for c in counters().values():
        c.reset()
    for tc, simt in route_counters().values():
        tc.reset()
        simt.reset()


def read_counts():
    return {name: c.n for name, c in counters().items()}


# phase E's dyadic runs under events: the restart (slots 10-42) and the k-failure (20-49)
# fall inside T=60 (cut from 120 to make room for phase P)
DYADIC_EVENTS_T = 60


def dyadic_events_card_vs_cpu(pt, cf, cuda):
    """Both routes under events on the dyadic system (tests/test_torch_cohort_events.py):
    every sum is exact, so the card's run equals the port's run on the CPU
    bitwise, for every scheduler, under a rolling restart and a k-failure."""
    T, W = DYADIC_EVENTS_T, 2
    topo, net, placement, arr = dyadic_system(pt, T + 13, W)
    pairs = [int(i) for i in range(topo.n_instances)
             if topo.comp_parallelism[topo.inst_comp[i]] == 2]
    traces = {"rolling_restart": pt.rolling_restart(topo, start=10, down_slots=6, stagger=3,
                                                    instances=pairs).compile(topo, T),
              "k_failures": pt.k_failures(topo, 2, start=20, duration=30,
                                          rng=np.random.default_rng(1)).compile(topo, T)}
    kw = dict(age_cap=32, warmup=10, drain_margin=30)
    for sched in ("potus", "shuffle", "jsq", "potus-loop"):
        cfg = pt.SimConfig(V=2.0, beta=0.5, window=W, scheduler=sched)
        for name, ev in traces.items():
            a = cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg,
                                          device=cuda, events=ev, **kw)
            b = cf._run_cohort_fused_impl(topo, net, placement, arr, None, T, cfg,
                                          device="cpu", events=ev, **kw)
            check(same_result(a, b) and a.completed_mass > 0,
                  f"dyadic {sched} {name}: the card's run differs from the CPU's")
    print(f"dyadic system T={T} under a rolling restart and a k-failure: card equals CPU "
          "bitwise for potus, shuffle, jsq and potus-loop")


def hold_card_vs_cpu(label, scheduler, a, b):
    """A card's result ``a`` against the port's on the CPU ``b``, on the
    paper profile. Shuffle ignores queue state: per-slot backlog/cost within
    rtol 1e-4 over the first 16 slots, means within 2%. POTUS breaks the
    paper system's many exact price ties by the last bit of its queues,
    which the two devices round differently (the CPU's cumsum accumulates in
    double), so its trajectories part within a few slots (DESIGN.md §8): its
    first-16 rel diff is printed, and its means are held to the chaos floor
    of tests/test_cohort_fused.py::TestPotusPaperSystem (response and
    backlog 10%, cost 2%)."""
    r16 = max(rel_diff(a.backlog[:16], b.backlog[:16]),
              rel_diff(a.comm_cost[:16], b.comm_cost[:16]))
    means = {f: rel_diff(getattr(a, f), getattr(b, f))
             for f in ("avg_backlog", "avg_cost", "avg_response")}
    print(f"{label}: card vs CPU first 16 slots rel diff {r16:.3e}, means "
          + ", ".join(f"{f} {v:.3e}" for f, v in means.items()))
    check(np.isfinite(a.backlog).all() and a.completed_mass > 0, f"{label}: not finite")
    if scheduler == "shuffle":
        check(r16 <= 1e-4 and max(means.values()) <= 0.02, f"{label} shuffle: card vs CPU")
    else:
        floor = {"avg_response": 0.10, "avg_backlog": 0.10, "avg_cost": 0.02}
        check(all(v <= floor[f] for f, v in means.items()),
              f"{label} {scheduler}: beyond the chaos floor")


def cohort_dense(pt, card, cuda, fleet, consts, mid, streams):
    """Phases A-F: the dense potus-loop route end to end (A), kernel 4 on
    dyadic and random inputs (B), kernel 4 alone at I=16384 from path 1's
    mid-run state and at route A's I=1024 (C), 16 dense steps at I=16384 from
    path 1's mid-run state (D), events on the compact route at I=16384 (E),
    and the benchmarks/disruption.py grid as one sweep (F). Returns kernel 4's
    entry of the kernels line."""
    import torch

    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import ops as kops

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: plain products would round")

    # -- A. the dense potus-loop route end to end, I=1024 -----------------------
    t_phase = time.perf_counter()
    loop_sys = fleet_system(pt, LOOP_I, LOOP_T)
    # the response is measured over slots [16, LOOP_T - 16) of the cut horizon
    measured = dict(warmup=16, drain_margin=16)
    spec = pt.EngineSpec(topo=loop_sys[0], net=loop_sys[1], placement=loop_sys[2],
                         arrivals=loop_sys[3], T=LOOP_T, scheduler="potus-loop", V=FLEET_V,
                         window=FLEET_W, age_cap=FLEET_AGE_CAP, device="cuda", **measured)
    reset_counts()
    runs, walls = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(pt.simulate(spec))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / LOOP_T)
        if len(runs) == 1:
            n = read_counts()
    res1, res2 = runs
    print(f"route A: cohort-fused potus-loop I={LOOP_I} T={LOOP_T} launches: " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f" [{card}]")
    check(n == dict(ZERO_COUNTS, potus_price=LOOP_T, cohort_drain=LOOP_T),
          f"route A launches {n}")
    a_launches = n["cohort_drain"]
    same = same_result(res1, res2)
    print(f"  two runs bitwise identical: {same}")
    check(same, "route A: two runs differ")
    print(f"  wall ms/slot of the two runs: {walls[0]:.4f}, {walls[1]:.4f}; "
          f"avg_backlog={res1.avg_backlog!r} avg_cost={res1.avg_cost!r} "
          f"avg_response={res1.avg_response!r} completed_mass={res1.completed_mass!r} [{card}]")
    # ~2000 launches per slot: profile 8 slots, or reading the trace takes minutes
    print("  profiled: the first 8 slots")
    profile_run(lambda: pt.simulate(dataclasses.replace(spec, T=8)))
    cfg = pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler="potus-loop")
    compare_cohort(f"route A fleet I={LOOP_I}", cf, pt, loop_sys, LOOP_T, cfg, cuda,
                   kernel=res1, age_cap=FLEET_AGE_CAP, **measured)
    compare_cohort("route A paper", cf, pt, paper_system(pt, 300), 300,
                   pt.SimConfig(V=2.0, window=2, scheduler="potus-loop"), cuda, age_cap=64)
    print(f"  phase A {time.perf_counter() - t_phase:.1f} s")

    # -- B. kernel 4 against its plain version on dyadic and random inputs --------
    t_phase = time.perf_counter()
    drain_checks(pt, cuda)
    print(f"  phase B {time.perf_counter() - t_phase:.1f} s")

    # -- C. kernel 4 alone at I=16384 (path 1's state at t=64) and at I=1024 (route A) --
    t_phase = time.perf_counter()
    step = dense_stepper(pt, cf, fleet, consts, streams, cuda)
    entry = drain_kernel(card, cuda, step=step, mid=mid)
    print(f"  phase C {time.perf_counter() - t_phase:.1f} s")

    # -- D. 16 dense steps at I=16384, kernel route against plain route ------------
    t_phase = time.perf_counter()

    def dense_run(ops):
        state, mets = mid, []
        for t in range(64, 80):
            state, m = step(ops, state, t)
            mets.append(torch.stack(m))
        return torch.stack(mets).cpu().numpy()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk = dense_run(kops)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 16
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    mp = dense_run(kops.plain)
    r16 = max(rel_diff(mk[:, q], mp[:, q]) for q in (0, 1))
    print(f"phase D: 16 dense steps at I={FLEET_I} (sort scheduler): {step_ms:.3f} ms per step, "
          f"launches cohort_drain={n['cohort_drain']} potus_schedule={n['potus_schedule']}; "
          f"kernel vs plain route per-slot backlog/cost rel diff {r16:.3e}; peak device memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")
    check(n == dict(ZERO_COUNTS, potus_schedule=16, cohort_drain=16), f"phase D launches {n}")
    check(np.isfinite(mk).all() and r16 <= 1e-4, "phase D: kernel route vs plain route")
    profile_run(lambda: step(kops, mid, 64))
    del step
    torch.cuda.empty_cache()
    print(f"  phase D {time.perf_counter() - t_phase:.1f} s")

    # -- E. events on the compact route at I=16384 ---------------------------------
    t_phase = time.perf_counter()
    topo, net, placement, _ = fleet
    events = fleet_restart(pt, topo, 64)
    ev_spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=fleet[3], T=64,
                            scheduler="potus", V=FLEET_V, window=FLEET_W, age_cap=FLEET_AGE_CAP,
                            warmup=16, drain_margin=16, events=events, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e1 = pt.simulate(ev_spec)
    torch.cuda.synchronize()
    ev_ms = (time.perf_counter() - t0) * 1e3 / 64
    n = read_counts()
    e2 = pt.simulate(ev_spec)
    same = same_result(e1, e2)
    print(f"phase E: cohort-fused potus I={FLEET_I} T=64 rolling restart of 16: {ev_ms:.3f} "
          f"ms/slot, launches " + " ".join(f"{k}={v}" for k, v in n.items())
          + f"; two runs bitwise identical: {same} [{card}]")
    check(n == ZERO_COUNTS, f"phase E launched a kernel: {n}")
    check(same, "phase E: two runs differ")
    profile_run(lambda: pt.simulate(ev_spec))
    compare_cohort("phase E fleet rolling-restart", cf, pt, fleet, 64,
                   pt.SimConfig(V=FLEET_V, window=FLEET_W), cuda, against="cpu", kernel=e1,
                   age_cap=FLEET_AGE_CAP, warmup=16, drain_margin=16, events=events)
    dyadic_events_card_vs_cpu(pt, cf, cuda)
    print(f"  phase E {time.perf_counter() - t_phase:.1f} s")

    # -- F. the benchmarks/disruption.py grid, one sweep -----------------------------
    t_phase = time.perf_counter()
    disruption_sweep(pt, card, cuda)
    print(f"  phase F {time.perf_counter() - t_phase:.1f} s")

    return dict(entry, launches=a_launches)


# ---------------------------------------------------------------------------
# phase G: the serving path (dispatcher -> fleet -> engines -> dense decoder)
# ---------------------------------------------------------------------------

ATT_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:13
# kernels 5 and 6 alone at the served models' widths: flash (B, Hq, Hkv, D) and decode
# (B, S, Hq, Hkv, D); flash (widths, S, dtype, causal) cases, S=300 a ragged tile
FLASH_DIMS = {"qwen2.5-32b": (1, 40, 8, 128), "zamba2-1.2b": (1, 32, 32, 64)}
FLASH_CASES = (("qwen2.5-32b", 32, "bfloat16", True), ("qwen2.5-32b", 128, "bfloat16", True),
               ("qwen2.5-32b", 300, "bfloat16", True), ("qwen2.5-32b", 512, "bfloat16", True),
               ("qwen2.5-32b", 4096, "bfloat16", True), ("qwen2.5-32b", 512, "float32", True),
               ("qwen2.5-32b", 512, "bfloat16", False), ("zamba2-1.2b", 512, "bfloat16", True),
               ("zamba2-1.2b", 544, "bfloat16", True))
# the kernels line's case: the largest served prompt
FLASH_ENTRY = ("qwen2.5-32b", 512, "bfloat16", True)
DECODE_DIMS = {"qwen2.5-32b": (4, 1024, 40, 8, 128), "zamba2-1.2b": (2, 544, 32, 32, 64)}
DECODE_ENTRY = ("qwen2.5-32b", "bfloat16")
# the device function names of kernels 5 and 6, printed wherever they rank in a profile
ATTENTION_KERNELS = ("flash_tc_kernel", "flash_simt_kernel", "decode_split_tc_kernel",
                     "decode_split_kernel", "decode_merge_kernel")


def attention_bound(nbytes, flops, dtype):
    """The least time of one call: bytes over HBM, operations over the peak
    of their type (bf16 tensor cores, or f32 outside them)."""
    import torch

    peak = PEAK_BF16_S if dtype == torch.bfloat16 else PEAK_F32_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_close(label, got, want, dtype_name):
    """|got - want| <= tol + tol * |want| everywhere (assert_allclose's rule
    with rtol = atol = tol); returns the max abs error."""
    import torch

    tol = ATT_TOL[dtype_name]
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)),
          f"{label}: kernel vs plain beyond {tol} (max_abs_err {err:.3e})")
    return err


def library_sdpa(q, k, v, **kw):
    """One ``F.scaled_dot_product_attention`` call with GQA; the yardstick of
    ``library_ms`` (never called by the port)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)


def flash_kernel_checks(card, cuda):
    """Kernel 5 alone against its plain version at qwen2.5-32b widths (Hq=40,
    Hkv=8, D=128) and zamba2-1.2b widths (Hq=Hkv=32, D=64), B=1: two runs
    bitwise, the route each call took (tensor cores for bf16 at D 64 and 128,
    SIMT otherwise), the device ms per call of the kernel and of SDPA (and
    their event-timed ms), the plain version's ms, the bound and the reached
    TFLOP/s. Returns the kernels line's entry (``FLASH_ENTRY``)."""
    import torch

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ops as kops

    worst, entry = 0.0, None
    for widths, S, name, causal in FLASH_CASES:
        B, Hq, Hkv, D = FLASH_DIMS[widths]
        dtype = getattr(torch, name)
        g = torch.Generator(device=cuda).manual_seed(S)
        q, k, v = (torch.randn((B, h, S, D), generator=g, device=cuda).to(dtype)
                   for h in (Hq, Hkv, Hkv))
        reset_counts()
        out = kf.flash_attention_call(q, k, v, causal)
        want = kf.flash_attention_plain(q, k, v, causal)
        again = kf.flash_attention_call(q, k, v, causal)
        torch.cuda.synchronize()
        kernel_route = kf.route(dtype, D)
        label = f"flash {widths} S={S} {name} causal={causal} ({kernel_route})"
        routes = kernel_routes()["flash_attention"]
        check(routes == {r: 2 * (r == kernel_route) for r in ("tc", "simt")},
              f"{label}: routes {routes}")
        err = attention_close(label, out, want, name)
        check(torch.equal(out, again), f"{label}: two kernel runs differ")
        worst = max(worst, err)
        del want
        n = 20
        kernel = partial(kf.flash_attention_call, q, k, v, causal)
        sdpa = partial(library_sdpa, q, k, v, is_causal=causal)
        ms = device_ms(kernel, n, expect={f"flash_{kernel_route}_kernel": 1})
        event_ms = time_calls(kernel, n)
        library_ms, library_event_ms = device_ms(sdpa, n), time_calls(sdpa, n)
        plain_ms = time_calls(lambda: kf.flash_attention_plain(q, k, v, causal), 3)
        elem = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elem  # q, k, v in; out
        flops = 4 * B * Hq * D * S * S // (2 if causal else 1)
        bound_ms, bound_by = attention_bound(nbytes, flops, dtype)
        print(f"{label}: max_abs_err={err:.3e} (tol {ATT_TOL[name]}), two runs bitwise; device "
              f"ms per call: kernel {ms:.4f}, library (SDPA) {library_ms:.4f}; event ms per call: "
              f"kernel {event_ms:.4f}, SDPA {library_event_ms:.4f}, plain {plain_ms:.4f}; bound "
              f"{bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {flops} flops); kernel "
              f"{flops / ms / 1e9:.2f} TFLOP/s, SDPA {flops / library_ms / 1e9:.2f} [{card}]")
        if (widths, S, name, causal) == FLASH_ENTRY:
            entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms,
                         library_event_ms=library_event_ms)
        del q, k, v, out, again
        torch.cuda.empty_cache()
    # the model's (B, S, H, D) layout through kernels.ops: strided views, no copy
    B, Hq, Hkv, D = FLASH_DIMS["qwen2.5-32b"]
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 300, h, D), generator=g, device=cuda).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    got = kops.flash_attention(q, k, v, causal=True)
    want = kops.plain.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = attention_close("flash model layout B=2 S=300", got, want, "bfloat16")
    check(got.is_contiguous(), "flash model layout: the output is not contiguous")
    print(f"flash through kernels.ops, (B, S, H, D) views, B=2 S=300 (a ragged tile) bf16: "
          f"max_abs_err={err:.3e} [{card}]")
    worst = max(worst, err)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:24", "max_abs_err": worst,
            **entry}


def decode_pos_sets(B, S, L, rng):
    """The timed ``pos`` (0, S-1 and random values) and the batches that put
    every split edge of the plan's L (0, L-1, L, 2L-1, S-1) in some request."""
    timed = np.array([0, S - 1, *rng.integers(1, S - 1, B - 2)], np.int32)[:B]
    edges = [p for p in (0, L - 1, L, 2 * L - 1, S - 1) if p < S]
    edges += [S - 1] * (-len(edges) % B)
    return timed, [np.array(edges[i:i + B], np.int32) for i in range(0, len(edges), B)]


def decode_kernel_checks(card, cuda):
    """Kernel 6 alone against its plain version at qwen2.5-32b widths (B=4,
    S=1024, Hq=40, Hkv=8, D=128) and zamba2-1.2b widths (B=2, S=544,
    Hq=Hkv=32, D=64), bf16 and f32: on the timed ``pos`` and on every split
    edge of the plan (two runs bitwise each), the device ms per call of the
    kernel and of SDPA (and their event-timed ms), the plain version's ms, the
    bound and the reached GB/s. Returns the kernels line's entry
    (``DECODE_ENTRY``)."""
    import torch

    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf

    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    worst, entry = 0.0, None
    for widths, (B, S, Hq, Hkv, D) in DECODE_DIMS.items():
        L, splits = kd.decode_split_plan(B, Hkv, S, n_sm)
        pos_np, edges = decode_pos_sets(B, S, L, np.random.default_rng(0))
        pos = torch.as_tensor(pos_np, device=cuda)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            g = torch.Generator(device=cuda).manual_seed(6)
            q = torch.randn((B, Hq, D), generator=g, device=cuda).to(dtype)
            kc, vc = (torch.randn((B, S, Hkv, D), generator=g, device=cuda).to(dtype)
                      for _ in range(2))
            kernel_route = kf.route(dtype, D)
            label = (f"decode {widths} B={B} S={S} {name} ({kernel_route}, L={L}, {splits} "
                     f"splits, {B * Hkv * splits} blocks)")
            err = 0.0
            reset_counts()
            for p_np in (pos_np, *edges):
                p = torch.as_tensor(p_np, device=cuda)
                out = kd.decode_attention_call(q, kc, vc, p)
                again = kd.decode_attention_call(q, kc, vc, p)
                torch.cuda.synchronize()
                at = f"{label} pos={p_np.tolist()}"
                err = max(err, attention_close(at, out, kd.decode_attention_plain(q, kc, vc, p),
                                               name))
                check(torch.equal(out, again), f"{at}: two kernel runs differ")
            routes = kernel_routes()["decode_attention"]
            check(routes == {r: 2 * (1 + len(edges)) * (r == kernel_route) for r in ("tc", "simt")},
                  f"{label}: routes {routes}")
            worst = max(worst, err)
            kernel = partial(kd.decode_attention_call, q, kc, vc, pos)
            # SDPA on the kernel-native layout, made outside the timing
            qs = q[:, :, None]
            ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
            mask = (torch.arange(S, device=cuda)[None, :] <= pos[:, None].long())[:, None, None, :]
            sdpa = partial(library_sdpa, qs, ks, vs, attn_mask=mask)
            passes = {}
            ms, event_ms = device_ms(kernel, 50, passes), time_calls(kernel, 50)
            library_ms, library_event_ms = device_ms(sdpa, 50), time_calls(sdpa, 50)
            plain_ms = time_calls(lambda: kd.decode_attention_plain(q, kc, vc, pos), 10)
            elem = q.element_size()
            rows = int((pos_np.astype(np.int64) + 1).sum())
            nbytes = 2 * rows * Hkv * D * elem + 2 * q.numel() * elem + 4 * B
            flops = 4 * Hq * D * rows
            bound_ms, bound_by = attention_bound(nbytes, flops, dtype)
            print(f"{label}: max_abs_err={err:.3e} (tol {ATT_TOL[name]}) over pos "
                  f"{[pos_np.tolist(), *(e.tolist() for e in edges)]}, two runs bitwise; device "
                  f"ms per call (timed pos {pos_np.tolist()}): kernel {ms:.4f} ("
                  + ", ".join(f"{k.split('<')[0]} {v:.4f}" for k, v in passes.items())
                  + f"), library (SDPA, "
                  f"bool mask) {library_ms:.4f}; event ms per call: kernel {event_ms:.4f}, SDPA "
                  f"{library_event_ms:.4f}, plain {plain_ms:.4f}; bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes} bytes over the {rows} cache rows read, {flops} flops); "
                  f"kernel {nbytes / ms / 1e6:.1f} GB/s [{card}]")
            if (widths, name) == DECODE_ENTRY:
                entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             library_event_ms=library_event_ms)
            del q, kc, vc, ks, vs
            torch.cuda.empty_cache()
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:23", "max_abs_err": worst,
            **entry}


def timed_engine_class():
    """``ServingEngine`` that records the wall ms of each decode round and of
    each prefill (both end in a device-to-host copy of the greedy tokens,
    which waits for the device)."""
    from repro_torch.serving.engine import ServingEngine

    class TimedEngine(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.round_ms, self.prefill_ms, self.prefill_tokens = [], [], []

        def _decode_round(self):
            t0 = time.perf_counter()
            out = super()._decode_round()
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def _admit_one(self):
            plen = len(self.queue[0].tokens) if self.queue else 0
            t0 = time.perf_counter()
            admitted = super()._admit_one()
            if admitted:
                self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
                self.prefill_tokens.append(plen)
            return admitted

    return TimedEngine


def serve(cfg, model, cuda, engine_cls, recorders=False, n_requests=SERVE_REQUESTS):
    """The served run: ``n_requests`` requests, Poisson(1.5) per slot from numpy seed 0,
    prompts of {32, ..., 512} tokens and 16 new tokens each, routed by
    ``PotusDispatcher`` on the card over 4 ``ServingEngine`` replicas through
    a flash straggler on replica 0; until every request is done. With
    ``recorders`` the dispatcher and the fleet each get a ``FlightRecorder``
    (J4). Returns (requests, slots, fleet, dispatcher)."""
    from repro_torch.core import events as pev
    from repro_torch.obs import FlightRecorder
    from repro_torch.serving import dispatcher as pd
    from repro_torch.serving import fleet as pf
    from repro_torch.serving.engine import Request

    R = len(SERVE_RATES)
    horizon = 400
    rec = (lambda: FlightRecorder(capacity=horizon)) if recorders else (lambda: None)
    fleet = pf.ReplicaFleet([engine_cls(cfg, model, max_batch=SERVE_BATCH,
                                        max_len=SERVE_MAX_LEN, service_rate=r)
                             for r in SERVE_RATES], recorder=rec())
    disp = pd.PotusDispatcher(
        n_frontends=1, replica_hosts=np.arange(1, R + 1), frontend_hosts=np.array([0]),
        host_costs=(np.ones((R + 1, R + 1)) - np.eye(R + 1)).astype(np.float32),
        replica_rates=np.array(SERVE_RATES),
        cfg=pd.DispatcherConfig(V=1.0, gamma=16.0, tokens_per_request=float(SERVE_MAX_NEW)),
        recorder=rec(), device=cuda)
    trace = pev.flash_straggler(disp.topo, start=SERVE_STRAGGLE[0],
                                duration=SERVE_STRAGGLE[1] - SERVE_STRAGGLE[0], factor=0.25,
                                instance=disp.F).compile(disp.topo, horizon)
    rng = np.random.default_rng(0)
    waiting, reqs, t = [], [], 0
    while len(reqs) < n_requests or waiting or not all(r.done for r in reqs):
        check(t < horizon, f"served run: requests still open after {horizon} slots")
        made = len(reqs) + len(waiting)
        n_new = min(int(rng.poisson(1.5)), n_requests - made)
        for rid in range(made, made + n_new):
            prompt = rng.integers(0, cfg.vocab_size, int(rng.choice(SERVE_PROMPT_LENS)))
            waiting.append(Request(rid, prompt, max_new=SERVE_MAX_NEW))
        ev = (trace.mu_t[t], trace.gamma_t[t], trace.alive_t[t])
        assign = pd.integral_assign(disp.route(np.array([float(n_new)]), fleet.backlog_tokens,
                                               events_row=ev))
        for r in range(R):
            for _ in range(int(assign[0, r])):
                if waiting:
                    req = waiting.pop(0)
                    reqs.append(req)
                    fleet.dispatch(r, req)
        fleet.step(t, mu_row=trace.mu_t[t][disp.F:], alive_row=trace.alive_t[t][disp.F:])
        t += 1
    return reqs, t, fleet, disp


def served_run(cfg, model, cuda, n_requests, card):
    """The served run of :func:`serve` on timed engines, counted: its
    launches (kernel 5 once per prefill and layer, kernel 6 once per decode
    round and layer, kernel 2 once per slot, every launch of 5 and 6 on the
    tensor cores, no other kernel), every request done with
    ``SERVE_MAX_NEW`` tokens; prints tokens/s, the decode rounds' ms beside
    their bound, the prefill ms per prompt token and the peak device memory.
    Returns (launches, requests, slots, fleet)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    reqs, slots, fleet, _ = serve(cfg, model, cuda, timed_engine_class(), n_requests=n_requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, routes = read_counts(), kernel_routes()
    peak = torch.cuda.max_memory_allocated()
    rounds = sum(e.decode_rounds for e in fleet.replicas)
    tokens = fleet.tokens_served
    round_ms = np.concatenate([e.round_ms for e in fleet.replicas])
    prefill_ms = sum(sum(e.prefill_ms) for e in fleet.replicas)
    prefill_tok = sum(sum(e.prefill_tokens) for e in fleet.replicas)
    # a decode round's least time: every weight but the embedding table read once over HBM,
    # and of that table the max_batch rows it gathers (the KV cache reads are left out)
    emb = model.embed
    round_bytes = (sum(p.numel() * p.element_size() for p in model.parameters())
                   - emb.numel() * emb.element_size()
                   + SERVE_BATCH * emb.shape[1] * emb.element_size())
    round_bound_ms = round_bytes / PEAK_BYTES_S * 1e3
    print(f"served run: {len(reqs)} requests, {tokens} tokens in {slots} slots, {rounds} decode "
          f"rounds, wall {wall:.3f} s, {tokens / wall:.1f} tokens/s; decode round median "
          f"{np.median(round_ms):.3f} ms (min {round_ms.min():.3f}, max {round_ms.max():.3f}), "
          f"bound {round_bound_ms:.4f} ms ({round_bytes} weight bytes); "
          f"prefill {prefill_ms / prefill_tok:.4f} ms per prompt token ({prefill_tok} tokens); "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")
    print("  launches: " + " ".join(f"{k}={v}" for k, v in n.items()) + f"; routes {routes} "
          f"[{card}]")
    want = dict(ZERO_COUNTS, flash_attention=cfg.n_layers * n_requests,
                decode_attention=cfg.n_layers * rounds, potus_schedule=slots)
    check(n == want, f"served run launches {n}, expected {want}")
    check(routes == all_on_tensor_cores(n),
          f"served run: a bf16 attention launch missed the tensor cores: {routes}")
    check(len(reqs) == n_requests and all(
        r.done and len(r.generated) == SERVE_MAX_NEW for r in reqs),
        f"served run: a request did not finish with {SERVE_MAX_NEW} tokens")
    check(tokens == n_requests * SERVE_MAX_NEW, "served run: tokens served")
    return n, reqs, slots, fleet


def teacher_forced(cfg, model, cuda, n_steps=8):
    """The kernel route against ``kernels.ops.plain`` on one replica's model:
    4 prompts prefilled into a 4-slot cache, then ``n_steps`` decode steps
    fed the same tokens (numpy seed 1). Returns max |logit diff| / max |logit|
    over all prefill and decode logits."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz

    rng = np.random.default_rng(1)
    plens = SERVE_PROMPT_LENS[1:]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in plens]
    fed = rng.integers(0, cfg.vocab_size, (n_steps, len(plens), 1))
    logits = {}
    for name, route in (("kernel", kops), ("plain", kops.plain)):
        cache = pz.init_cache(cfg, len(plens), SERVE_MAX_LEN, cuda)
        rows = []
        for i, p in enumerate(prompts):
            tokens = torch.as_tensor(p, device=cuda)[None]
            lg, one = pz.prefill(model, cfg, {"tokens": tokens}, SERVE_MAX_LEN, ops=route)
            for key, dst in cache.items():
                dst[:, i] = one[key][:, 0]
            rows.append(lg[:, 0].float())
        pos = torch.as_tensor(plens, dtype=torch.int32, device=cuda)
        for s in range(n_steps):
            lg, cache = pz.decode_step(model, cfg, torch.as_tensor(fed[s], device=cuda), pos,
                                       cache, ops=route)
            rows.append(lg[:, 0].float())
            pos = pos + 1
        logits[name] = torch.cat(rows)
    diff = float((logits["kernel"] - logits["plain"]).abs().max())
    scale = float(logits["plain"].abs().max())
    check(np.isfinite(diff) and np.isfinite(scale) and scale > 0, "teacher-forced: not finite")
    return diff / scale, diff, scale


def serving_path(card, cuda):
    """Phase G: kernels 5 and 6 alone, then the served run of qwen2.5-32b at
    full width (``SERVE_LAYERS`` layers, bf16) behind the dispatcher, its
    checks and its numbers; its second run with a ``FlightRecorder`` on the
    dispatcher and on the fleet (J4). Returns the two kernels' entries of
    the kernels line."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model_zoo as pz
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    flash = flash_kernel_checks(card, cuda)
    decode = decode_kernel_checks(card, cuda)

    cfg = get_config(SERVE_ARCH).with_(n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase G model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_layers} of 64 layers, {cfg.param_dtype}: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB), drawn in {time.perf_counter() - t0:.2f} s [{card}]")

    # the kernel route against the plain route, teacher-forced (also the warm-up)
    rel, diff, scale = teacher_forced(cfg, model, cuda)
    print(f"teacher-forced kernel vs plain route, {SERVE_LAYERS} layers bf16, 4 prompts x 8 "
          f"decode steps: "
          f"max |dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (limit 5e-2) [{card}]")
    check(rel <= 5e-2, "teacher-forced bf16: kernel route vs plain beyond 5e-2 of max |logit|")

    # the served run, counted and timed
    n, reqs, slots, _ = served_run(cfg, model, cuda, SERVE_REQUESTS, card)
    first = {r.rid: list(r.generated) for r in reqs}

    reqs2, slots2, fleet2, disp2 = serve(cfg, model, cuda, ServingEngine, recorders=True)
    same = slots2 == slots and {r.rid: list(r.generated) for r in reqs2} == first
    print(f"  two runs give identical tokens: {same} (the second with flight recorders) "
          f"[{card}]")
    check(same, "served run: two runs differ")
    rows_d, rows_f = disp2.recorder.rows(), fleet2.recorder.rows()
    h_col = [r["h"] for r in rows_d]
    print(f"  J4 flight recorders: dispatcher {len(rows_d)} rows for {slots2} routed slots, "
          f"h column = h_history: {h_col == disp2.h_history}; fleet {len(rows_f)} rows, last "
          f"{rows_f[-1]} [{card}]")
    check(len(rows_d) == slots2 and [r["slot"] for r in rows_d] == list(range(slots2)),
          "J4: one dispatcher row per routed slot")
    check(h_col == disp2.h_history, "J4: the dispatcher rows' h differs from h_history")
    check(len(rows_f) == slots2 and rows_f[-1]["tokens_served"] == fleet2.tokens_served,
          "J4: one fleet row per slot")
    profile_run(lambda: serve(cfg, model, cuda, ServingEngine), top=10, suffix=f" [{card}]",
                also=ATTENTION_KERNELS)
    del model
    torch.cuda.empty_cache()

    # the same check at 2 layers in f32: the kernels' own error, without bf16's
    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    rel, diff, scale = teacher_forced(cfg32, model32, cuda)
    print(f"teacher-forced kernel vs plain route, 2 layers f32: max |dlogit| {diff:.4e} of "
          f"max |logit| {scale:.4e} = {rel:.4e} (limit 1e-4) [{card}]")
    check(rel <= 1e-4, "teacher-forced f32: kernel route vs plain beyond 1e-4 of max |logit|")
    del model32
    torch.cuda.empty_cache()
    print(f"  phase G {time.perf_counter() - t_phase:.1f} s [{card}]")
    return [dict(flash, launches=n["flash_attention"]),
            dict(decode, launches=n["decode_attention"])]


# ---------------------------------------------------------------------------
# phase H: the SSM and hybrid models (mamba2-1.3b forward, zamba2-1.2b served)
# ---------------------------------------------------------------------------

def ssd_inputs(seed, b, T, dtype, device, H=64, P=64, S=128):
    """(x, dt, A, B, C) of ``ssd_chunked`` at mamba2-1.3b widths, in the
    model's types: x, dt, B and C in ``dtype``, A float32. dt and A follow
    Mamba2's published initialisation ranges (dt about 0.001-0.1 from a
    shifted softplus, A in [-16, -1]), so the decay spans a 256-token chunk."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    x = randn(b, T, H, P).to(dtype)
    z = randn(b, T, H) - 4.0
    dt = torch.logaddexp(z, torch.zeros_like(z)).to(dtype)
    A = -(1.0 + 15.0 * torch.rand((H,), generator=g, device=device))
    return x, dt, A, randn(b, T, S).to(dtype), randn(b, T, S).to(dtype)


def ssd_kernel_inputs(x, dt, A, B, C, chunk):
    """The kernel's arguments as ``ssd_chunked`` hands them over (the dt=0 pad,
    the chunk reshape, the float32 ``dA_cum``): caught on its kernel route."""
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.models import mamba as pm

    caught = []

    def route(*args):
        caught.append(args)
        return kss.ssd_intra_chunk_call(*args)

    y = pm.ssd_chunked(x, dt, A, B, C, chunk, ops=SimpleNamespace(ssd_intra_chunk=route))
    check(len(caught) == 1, "ssd_chunked did not take its kernel route once")
    check(tuple(y.shape) == tuple(x.shape) and bool(y.isfinite().all()),
          "ssd_chunked: the output is not finite or of the wrong shape")
    return caught[0]


def ssd_bound(args, dtype):
    """Bytes (each input read once, y_diag and the states written once) and
    operations of one call: C·Bᵀ once per (b, chunk) over the causal
    triangle, the weighted (Q, Q) x (Q, P) product per head over the triangle,
    and the (P, Q) x (Q, S) state product per head; two per multiply-add."""
    xc, dtc, dA_cum, Bc, Cc = args
    b, nc, Q, H, P = xc.shape
    S = Bc.shape[-1]
    tri = Q * (Q + 1) // 2
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + xc.numel() * xc.element_size() + b * nc * H * P * S * 4)
    flops = 2 * b * nc * (tri * S + H * tri * P + H * Q * P * S)
    return (*attention_bound(nbytes, flops, dtype), nbytes, flops)


def ssd_kernel_checks(card, cuda, chunk):
    """H1: kernel 7 alone at mamba2-1.3b widths through ``ssd_chunked``'s
    kernel route, against its plain version on the same inputs. Returns the
    kernels line's entry (the bf16 b=1 T=2048 case, the H2 forward's calls)."""
    import torch

    from repro_torch.kernels import ssd_scan as kss

    worst, entry = 0.0, None
    for b, T, name in SSD_CASES:
        dtype = getattr(torch, name)
        args = ssd_kernel_inputs(*ssd_inputs(T + b, b, T, dtype, cuda), chunk)
        y, st = kss.ssd_intra_chunk_call(*args)
        y2, st2 = kss.ssd_intra_chunk_call(*args)
        yp, sp = kss.ssd_intra_chunk_plain(*args)
        torch.cuda.synchronize()
        check(y.dtype == args[0].dtype and st.dtype == torch.float32, "ssd: output types")
        label = (f"ssd b={b} T={T} {name} (nc={args[0].shape[1]}, types "
                 f"{'/'.join(str(t.dtype).split('.')[-1] for t in args)})")
        rels, err = [], 0.0
        for got, want in ((y, yp), (st, sp)):
            d = float((got.float() - want.float()).abs().max())
            rels.append(d / max(float(want.float().abs().max()), 1e-6))
            err = max(err, d)
        check(rels[0] <= SSD_TOL[name], f"{label}: y_diag kernel vs plain {rels[0]} beyond "
              f"{SSD_TOL[name]} of max |ref|")
        check(rels[1] <= SSD_TOL["float32"], f"{label}: states kernel vs plain {rels[1]} beyond "
              f"{SSD_TOL['float32']} of max |ref|")
        check(torch.equal(y, y2) and torch.equal(st, st2), f"{label}: two kernel runs differ")
        worst = max(worst, err)
        del yp, sp
        parts = {}
        ms = device_ms(lambda: kss.ssd_intra_chunk_call(*args), 20, parts=parts)
        event_ms = time_calls(lambda: kss.ssd_intra_chunk_call(*args), 20)
        plain_ms = time_calls(lambda: kss.ssd_intra_chunk_plain(*args), 3)
        bound_ms, bound_by, nbytes, flops = ssd_bound(args, dtype)
        split = ", ".join(f"{k[:40]} {v:.4f}" for k, v in sorted(parts.items(),
                                                                 key=lambda r: -r[1]))
        print(f"{label}: y rel {rels[0]:.3e} (limit {SSD_TOL[name]}), states rel {rels[1]:.3e} "
              f"(limit {SSD_TOL['float32']}) of max |ref|, max_abs_err={err:.3e}, two runs "
              f"bitwise; device ms per call: kernel {ms:.4f} ({split}); event ms per call: "
              f"kernel {event_ms:.4f}, plain {plain_ms:.4f}; bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes} bytes, {flops} flops); library: none, no one PyTorch "
              f"call computes the block [{card}]")
        if (b, T, name) == SSD_CASES[0]:
            entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
        torch.cuda.empty_cache()
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:23", "max_abs_err": worst, **entry,
            "library_ms": None}


def logit_gap(a, b):
    """max |a - b| / max |b|, both finite."""
    diff = float((a.float() - b.float()).abs().max())
    scale = float(b.float().abs().max())
    check(np.isfinite(diff) and np.isfinite(scale) and scale > 0, "logits not finite")
    return diff / scale, diff, scale


def rounded_plain(xc, dtc, dA_cum, Bc, Cc):
    """The plain version with y_diag rounded to ``xc``'s type, as the kernel
    returns it."""
    from repro_torch.kernels import ssd_scan as kss

    y, states = kss.ssd_intra_chunk_plain(xc, dtc, dA_cum, Bc, Cc)
    return y.to(xc.dtype), states


def layer_gaps(cfg, model, x, ops_a, ops_b):
    """Each Mamba2 block and each shared-attention invocation (its attention's
    output, before the residual) run by two routes from the same input
    (route b's residual stream, as teacher forcing feeds both the same
    tokens): the largest max |out_a - out_b| / max |out_b| over the Mamba2
    blocks, and over the attention invocations (0 without them)."""
    import torch

    from repro_torch.models import mamba as pm
    from repro_torch.models import model_zoo as pz

    positions = torch.arange(x.shape[1], device=x.device)
    ssm_worst = attn_worst = 0.0
    for gi, (s, e, attn_after) in enumerate(pz._hybrid_groups(cfg)):
        for block in model.blocks[s:e]:
            out_b = pm.mamba_block(block, x, cfg, ops=ops_b)
            ssm_worst = max(ssm_worst,
                            logit_gap(pm.mamba_block(block, x, cfg, ops=ops_a), out_b)[0])
            x = out_b + x
        if attn_after:
            shared = model.shared_attn[gi % cfg.n_shared_attn]
            h = shared.ln1(x)
            (out_a, _), (out_b, _) = (shared.attn(h, positions, o) for o in (ops_a, ops_b))
            attn_worst = max(attn_worst, logit_gap(out_a, out_b)[0])
            x, *_ = shared(x, positions, ops_b)
    return ssm_worst, attn_worst


def ssm_forward(card, cuda):
    """H2: mamba2-1.3b at full width and depth in bf16, one forward of b=1,
    T=2048 by the kernel route (counted, timed, profiled) and by the plain
    route. Every block is held to the plain route from the same input; the
    logits' gap after 48 bf16 layers is printed, not held: a one-ulp change
    of a bf16 activation grows through the random-weight stack, which the
    plain route shows against itself when only y_diag is rounded to x's
    type, as the kernel returns it (printed beside). Then 2 layers in f32,
    held end to end. Returns the kernel route's launch count of
    ``ssd_intra_chunk``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz

    cfg = get_config(SSD_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase H model: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} Mamba2 layers, "
          f"H={cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim} P={cfg.ssm_headdim} "
          f"S={cfg.ssm_state} chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.param_dtype}: "
          f"{n_params} parameters ({n_params * 2 / 1e9:.2f} GB) [{card}]")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, SSM_T)),
                             device=cuda)
    batch = {"tokens": tokens}
    reset_counts()
    logits, _ = pz.forward(model, cfg, batch)
    torch.cuda.synchronize()
    n = read_counts()
    print(f"  forward b=1 T={SSM_T}, kernel route: launches " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f" [{card}]")
    check(n == dict(ZERO_COUNTS, ssd_intra_chunk=cfg.n_layers), f"H2 launches {n}")
    check(tuple(logits.shape) == (1, SSM_T, cfg.vocab_size) and bool(logits.isfinite().all()),
          "H2: logits not finite or of the wrong shape")
    reset_counts()
    plain, _ = pz.forward(model, cfg, batch, ops=kops.plain)
    torch.cuda.synchronize()
    check(read_counts() == ZERO_COUNTS, "H2: the plain route launched a kernel")
    rel, diff, scale = logit_gap(logits, plain)
    print(f"  kernel vs plain route, {cfg.n_layers} layers bf16, end to end: max |dlogit| "
          f"{diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (recorded, not held) [{card}]")
    rounded, _ = pz.forward(model, cfg, batch, ops=SimpleNamespace(
        ssd_intra_chunk=rounded_plain))
    rel, diff, scale = logit_gap(rounded, plain)
    print(f"  plain route with y_diag rounded to x's type vs plain route, end to end: max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (recorded) [{card}]")
    del plain, rounded
    worst, _ = layer_gaps(cfg, model, model.embed[tokens], kops, kops.plain)
    print(f"  kernel vs plain route, each of the {cfg.n_layers} blocks from the same input, bf16: "
          f"largest max |dout| / max |out| {worst:.4e} (limit 5e-2) [{card}]")
    check(worst <= 5e-2, "H2 bf16: a block's kernel route beyond 5e-2 of its plain route")
    walls, issued = wall_and_issue(lambda: pz.forward(model, cfg, batch), SSM_FORWARD_RUNS)
    peak = torch.cuda.max_memory_allocated()
    print(f"  forward wall ms over {SSM_FORWARD_RUNS} runs: median {np.median(walls):.3f} (min "
          f"{walls.min():.3f}, max {walls.max():.3f}), {SSM_T / np.median(walls) * 1e3:.1f} "
          f"tokens/s; host ms to issue it: median {np.median(issued):.3f} (min "
          f"{issued.min():.3f}, max {issued.max():.3f}); peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) [{card}]")
    profile_run(lambda: pz.forward(model, cfg, batch), top=10, suffix=f" [{card}]")
    launches = n["ssd_intra_chunk"]
    del model, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    a, _ = pz.forward(model32, cfg32, batch)
    b, _ = pz.forward(model32, cfg32, batch, ops=kops.plain)
    rel, diff, scale = logit_gap(a, b)
    print(f"  kernel vs plain route, 2 layers f32: max |dlogit| {diff:.4e} of max |logit| "
          f"{scale:.4e} = {rel:.4e} (limit 1e-4) [{card}]")
    check(rel <= 1e-4, "H2 f32: kernel route vs plain beyond 1e-4 of max |logit|")
    del model32, a, b
    torch.cuda.empty_cache()
    return launches


class HeldRoute:
    """An ``ops`` namespace for the model that launches each kernel through
    ``kernels.ops`` and, on every call, holds it against its plain version on
    the same arguments (the path's own shapes, layouts and caches) and
    against a second launch (bitwise). Its launches are the comparison's:
    run it outside a counted run. ``worst`` holds each kernel's largest
    error (relative to max |plain| for the SSD block, absolute for
    attention) and ``calls`` its number of held calls."""

    def __init__(self):
        self.worst, self.calls = {}, {}

    def _held(self, name, err):
        self.worst[name] = max(self.worst.get(name, 0.0), err)
        self.calls[name] = self.calls.get(name, 0) + 1

    def ssd_intra_chunk(self, *args):
        import torch

        from repro_torch.kernels import ops as kops

        y, st = kops.ssd_intra_chunk(*args)
        y2, st2 = kops.ssd_intra_chunk(*args)
        yp, sp = kops.plain.ssd_intra_chunk(*args)
        name = str(args[0].dtype).split(".")[-1]
        label = f"H3 ssd_intra_chunk {name} at {tuple(args[0].shape)}"
        check(torch.equal(y, y2) and torch.equal(st, st2), f"{label}: two kernel runs differ")
        rel_y, rel_s = (float((a.float() - b.float()).abs().max())
                        / max(float(b.float().abs().max()), 1e-6) for a, b in ((y, yp), (st, sp)))
        check(rel_y <= SSD_TOL[name] and rel_s <= SSD_TOL["float32"],
              f"{label}: kernel vs plain y {rel_y:.3e}, states {rel_s:.3e} of max |ref|")
        self._held("ssd_intra_chunk", max(rel_y, rel_s))
        return y, st

    def flash_attention(self, q, k, v, causal=True):
        import torch

        from repro_torch.kernels import ops as kops

        out = kops.flash_attention(q, k, v, causal=causal)
        name = str(q.dtype).split(".")[-1]
        label = f"H3 flash_attention {name} at {tuple(q.shape)}"
        check(torch.equal(out, kops.flash_attention(q, k, v, causal=causal)),
              f"{label}: two kernel runs differ")
        self._held("flash_attention", attention_close(
            label, out, kops.plain.flash_attention(q, k, v, causal=causal), name))
        return out

    def decode_attention(self, q, k_cache, v_cache, pos):
        import torch

        from repro_torch.kernels import ops as kops

        out = kops.decode_attention(q, k_cache, v_cache, pos)
        name = str(q.dtype).split(".")[-1]
        label = f"H3 decode_attention {name} at {tuple(k_cache.shape)} pos {pos.tolist()}"
        check(torch.equal(out, kops.decode_attention(q, k_cache, v_cache, pos)),
              f"{label}: two kernel runs differ")
        self._held("decode_attention", attention_close(
            label, out, kops.plain.decode_attention(q, k_cache, v_cache, pos), name))
        return out

    def report(self, dtype_name, card):
        import torch

        torch.cuda.synchronize()
        limits = {"ssd_intra_chunk": f"rel of max |ref| {self.worst.get('ssd_intra_chunk', 0):.3e}"
                                     f" (limit y {SSD_TOL[dtype_name]}, states 1e-5)"}
        for name in ("ssd_intra_chunk", "flash_attention", "decode_attention"):
            check(self.calls.get(name, 0) > 0, f"H3 {dtype_name}: {name} was never held")
            worst = limits.get(name, f"max_abs_err {self.worst[name]:.3e} (rtol = atol = "
                                     f"{ATT_TOL[dtype_name]})")
            print(f"  {dtype_name} generation: {name} held on each of its {self.calls[name]} "
                  f"calls against its plain version, worst {worst}, two runs bitwise [{card}]")


def hybrid_generate(cfg, model, prompts, cuda, ops=None, feed=None):
    """Greedy generation by the model's own entry points, as ``ServingEngine``
    does it (batch-1 prefills copied into the slots of one cache, then decode
    steps over both), or, with ``feed`` (B, 1 + steps), those tokens fed in
    place of the argmax (teacher forcing). On the kernel route (``ops=None``)
    the launches of each prefill and decode step are checked, on
    ``kernels.ops.plain`` that there are none. Returns (tokens (B, 1 +
    steps), logits (B, 1 + steps, V))."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz

    n_inv = sum(1 for *_r, a in pz._hybrid_groups(cfg) if a)
    if ops is None:
        want_prefill = dict(ZERO_COUNTS, ssd_intra_chunk=cfg.n_layers, flash_attention=n_inv)
        want_step = dict(ZERO_COUNTS, decode_attention=n_inv)
    elif ops is kops.plain:
        want_prefill = want_step = ZERO_COUNTS
    else:
        want_prefill = want_step = None  # a held route: its launches are the comparison's
    max_len = HYBRID_MAX_LEN  # the engine's, so both runs see one cache size
    cache = pz.init_cache(cfg, len(prompts), max_len, cuda)
    rows, toks = [], []
    for i, p in enumerate(prompts):
        reset_counts()
        lg, one = pz.prefill(model, cfg, {"tokens": torch.as_tensor(p, device=cuda)[None]},
                             max_len, ops=ops)
        n = read_counts()
        check(want_prefill is None or n == want_prefill, f"H3: one prefill launched {n}")
        for key, dst in cache.items():
            dst[:, i] = one[key][:, 0]
        rows.append(lg[:, 0])
    logits = [torch.cat(rows)]
    toks.append(torch.argmax(logits[-1], dim=-1))
    pos = torch.full((len(prompts),), HYBRID_PROMPT, dtype=torch.int32, device=cuda)
    for step in range(HYBRID_STEPS):
        cur = toks[-1] if feed is None else feed[:, step]
        reset_counts()
        lg, cache = pz.decode_step(model, cfg, cur[:, None], pos, cache, ops=ops)
        n = read_counts()
        check(want_step is None or n == want_step, f"H3: one decode step launched {n}")
        logits.append(lg[:, 0])
        toks.append(torch.argmax(lg[:, 0], dim=-1))
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(logits, 1)


def handover_gap(cfg, model, prompts, toks, logits, cuda):
    """A forward over each prompt and its generated tokens against the
    prefill/decode logits at the generated positions: max |dlogit| / max
    |logit|, with the forward's launches checked."""
    import torch

    from repro_torch.models import model_zoo as pz

    n_inv = sum(1 for *_r, a in pz._hybrid_groups(cfg) if a)
    full = torch.cat([torch.as_tensor(np.stack(prompts), device=cuda), toks[:, :-1]], dim=1)
    reset_counts()
    fwd, _ = pz.forward(model, cfg, {"tokens": full})
    check(read_counts() == dict(ZERO_COUNTS, ssd_intra_chunk=cfg.n_layers,
                                flash_attention=n_inv), "H3: forward launches")
    return logit_gap(fwd[:, HYBRID_PROMPT - 1:], logits)


def hybrid_served(card, cuda):
    """H3: zamba2-1.2b at full width and depth. In bf16: two prompts of 512
    tokens served by a ``ServingEngine`` (prefill each, then 16 decode
    rounds), counted and timed; the same generation by the entry points,
    whose tokens must equal the engine's; once more with every launch of
    the three kernels held against its plain version on the path's own
    arguments (``HeldRoute``); and every Mamba2 block and shared-attention
    invocation held to the plain route from the same input. In f32 (the same
    model drawn in f32): the held generation again, the kernel route against
    the plain route end to end, and the hand-over from the chunked scan to
    the recurrence (a forward over each prompt and its generated tokens
    against the prefill/decode logits at the 17 generated positions), each
    within 5e-2 of max |logit|. In bf16 the hand-over is printed, not held:
    a one-ulp change grows through the random-weight stack."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz
    from repro_torch.serving.engine import Request

    cfg = get_config(HYBRID_ARCH)
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    n_params = sum(p.numel() for p in model.parameters())
    n_inv = sum(1 for *_r, a in pz._hybrid_groups(cfg) if a)
    print(f"phase H model: {cfg.name} d_model {cfg.d_model}, {cfg.n_layers} Mamba2 layers (S="
          f"{cfg.ssm_state}) + {cfg.n_shared_attn} shared attention blocks x {n_inv} "
          f"invocations ({cfg.n_heads} heads), d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}: {n_params} parameters ({n_params * 2 / 1e9:.2f} GB) [{card}]")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, HYBRID_PROMPT) for _ in range(2)]

    eng = timed_engine_class()(cfg, model, max_batch=2, max_len=HYBRID_MAX_LEN,
                               service_rate=float(HYBRID_STEPS))
    reqs = [Request(i, p, max_new=HYBRID_STEPS + 1) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n, routes = read_counts(), kernel_routes()
    print(f"  served: 2 prompts x {HYBRID_PROMPT} tokens, {eng.decode_rounds} decode rounds, "
          f"{eng.tokens_served} tokens in {wall:.3f} s; prefill "
          f"{sum(eng.prefill_ms) / sum(eng.prefill_tokens):.4f} ms per prompt token, decode "
          f"round median {np.median(eng.round_ms):.3f} ms (min {min(eng.round_ms):.3f}, max "
          f"{max(eng.round_ms):.3f}) [{card}]")
    print("  launches: " + " ".join(f"{k}={v}" for k, v in n.items()) + f"; routes {routes} "
          f"[{card}]")
    want = dict(ZERO_COUNTS, ssd_intra_chunk=2 * cfg.n_layers, flash_attention=2 * n_inv,
                decode_attention=HYBRID_STEPS * n_inv)
    check(n == want, f"H3 served launches {n}, expected {want}")
    check(routes == all_on_tensor_cores(n),
          f"H3: a bf16 attention launch at head_dim 64 missed the tensor cores: {routes}")
    check(all(r.done and len(r.generated) == HYBRID_STEPS + 1 for r in reqs),
          "H3: a request did not finish")
    served = [list(r.generated) for r in reqs]
    # the served run holds the process's first zamba2 prefills, with their first-use costs:
    # time each prompt's prefill again, warm
    pre, issued = [], []
    for p in prompts:
        batch = {"tokens": torch.as_tensor(p, device=cuda)[None]}
        w, i = wall_and_issue(lambda: pz.prefill(model, cfg, batch, HYBRID_MAX_LEN),
                              HYBRID_PREFILL_RUNS)
        pre.append(w / HYBRID_PROMPT)
        issued.append(i / HYBRID_PROMPT)
    pre, issued = np.concatenate(pre), np.concatenate(issued)
    print(f"  warm prefill over {len(pre)} runs: median {np.median(pre):.4f} ms per prompt token "
          f"(min {pre.min():.4f}, max {pre.max():.4f}); host ms per token to issue it: median "
          f"{np.median(issued):.4f} (min {issued.min():.4f}, max {issued.max():.4f}) [{card}]")

    toks, logits = hybrid_generate(cfg, model, prompts, cuda)
    same = served == toks.tolist()
    print(f"  the entry points give the engine's tokens: {same} [{card}]")
    check(same, "H3: two runs give different tokens")
    rel, diff, scale = handover_gap(cfg, model, prompts, toks, logits, cuda)
    print(f"  forward vs prefill/decode at the {HYBRID_STEPS + 1} generated positions, bf16: max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (recorded, not held) "
          f"[{card}]")
    held = HeldRoute()
    toks, _ = hybrid_generate(cfg, model, prompts, cuda, ops=held)
    held.report("bfloat16", card)
    check(served == toks.tolist(), "H3: the held route gives other tokens")
    x = model.embed[torch.as_tensor(prompts[0], device=cuda)[None]]
    ssm_worst, attn_worst = layer_gaps(cfg, model, x, kops, kops.plain)
    print(f"  kernel vs plain route from the same input, bf16: largest max |dout| / max |out| "
          f"{ssm_worst:.4e} over the {cfg.n_layers} Mamba2 blocks, {attn_worst:.4e} over the "
          f"{n_inv} attention invocations (limit 5e-2) [{card}]")
    check(max(ssm_worst, attn_worst) <= 5e-2,
          "H3 bf16: a block's kernel route beyond 5e-2 of its plain route")
    del model, eng, logits
    torch.cuda.empty_cache()

    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    held = HeldRoute()
    toks, logits = hybrid_generate(cfg32, model32, prompts, cuda, ops=held)
    held.report("float32", card)
    ptoks, plain = hybrid_generate(cfg32, model32, prompts, cuda, ops=kops.plain, feed=toks)
    rel, diff, scale = logit_gap(logits, plain)
    print(f"  kernel vs plain route, prefill and {HYBRID_STEPS} decode steps fed the kernel "
          f"route's tokens, end to end, f32: max |dlogit| {diff:.4e} of max |logit| "
          f"{scale:.4e} = {rel:.4e} (limit 5e-2); argmax tokens equal: "
          f"{bool(torch.equal(toks, ptoks))} [{card}]")
    check(rel <= 5e-2, "H3 f32: kernel route vs plain beyond 5e-2 of max |logit|")
    rel, diff, scale = handover_gap(cfg32, model32, prompts, toks, logits, cuda)
    print(f"  forward vs prefill/decode at the {HYBRID_STEPS + 1} generated positions, f32: max "
          f"|dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} (limit 5e-2) [{card}]")
    check(rel <= 5e-2, "H3: forward vs prefill/decode beyond 5e-2 of max |logit|")
    del model32, logits, plain
    torch.cuda.empty_cache()


def ssm_path(card, cuda):
    """Phase H: kernel 7 alone (H1), the mamba2-1.3b forward (H2), zamba2-1.2b
    served (H3). Returns kernel 7's entry of the kernels line."""
    import torch

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    entry = ssd_kernel_checks(card, cuda, get_config(SSD_ARCH).ssm_chunk)
    launches = ssm_forward(card, cuda)
    hybrid_served(card, cuda)
    torch.cuda.empty_cache()
    print(f"  phase H {time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(entry, launches=launches)


# ---------------------------------------------------------------------------
# phase F and phase I: scenario sweeps (core/sweep.py, run_fused_sweep)
# ---------------------------------------------------------------------------

#: the V columns of I3's Fig. 6ab grid that the CPU runs (the grid's last), and the
#: window of Fig. 5's V x W grid it runs (W=0: 7 of its 14 scenarios)
I3_CPU_VS, I3_CPU_FIG5_W = (20,), 0


def cpu_run(name):
    """The port's run on the CPU that phase F or I3 holds the card against:
    ``transient`` (phase F's W=2 scenarios), ``fig6ab`` (I3: the V columns
    ``I3_CPU_VS`` of the grid, all its predictors) or ``fig5`` (I3: its V
    column at ``W = I3_CPU_FIG5_W``); returns (sweep, wall s). It runs after the card's run it is held against, so no
    timed phase runs beside it."""
    import torch

    import benchmarks.torch_figures as tf

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the paper profile's tensors are tiny
    try:
        if name == "transient":
            grid = tf.transient_grid("cpu", T=300, windows=(2,))
            return grid[6], grid[7]
        if name == "fig6ab":  # the grid's last V column: 7 of its 28 scenarios
            return tf.fig6ab_sweep("cpu", vs=I3_CPU_VS)[3:]
        sys_ = tf.paper_system("fat-tree")  # fig5_sweep's grid at one window
        spec = tf.SweepSpec(V=tuple(float(v) for v in tf.FIG5_VS), window=(I3_CPU_FIG5_W,))
        return tf._sweep(sys_, tf.arrivals_for(sys_, "trace", tf.T_SIM), tf.T_SIM, spec, "cpu")
    finally:
        torch.set_num_threads(threads)


def disruption_sweep(pt, card, cuda):
    """Phase F: ``benchmarks/disruption.py``'s grid (potus and shuffle x W
    (0, 2, 6) x events (none, a k-failure), T=300 on the paper profile) as
    one ``run_sweep`` through ``benchmarks/torch_figures.py``; the W=2
    scenarios held against the port on the CPU, the rows printed beside
    ``BENCH_disruption.json`` (recorded, not checked)."""
    import torch

    import benchmarks.torch_figures as tf

    grid = tf.transient_grid(cuda, T=300)
    _, T, t_fail, dur, scen, Ws, sw, wall = grid
    torch.cuda.synchronize()
    print(f"phase F: one sweep of {len(sw)} scenarios in {sw.n_batches} partitions, T={T}, "
          f"{scen.name}: wall {wall:.3f} s [{card}]")
    cpu = cpu_run("transient")[0]
    for (scn, a) in sw.select(window=2):
        b = cpu.result(scheduler=scn.scheduler, window=2, events=scn.events)
        hold_card_vs_cpu(f"phase F {scn.scheduler} W=2 events={scn.events}", scn.scheduler, a,
                         b)
    bench = {(r["scheduler"], r["W"]): r for r in json.loads(
        (ROOT / "BENCH_disruption.json").read_text())["rows"] if r["section"] == "disruption"}
    for sched in ("potus", "shuffle"):
        for W in Ws:
            hurt = sw.result(scheduler=sched, window=W, events="kfail")
            got = dict(resp_transient=float(hurt.avg_response),
                       peak_backlog=float(hurt.backlog[t_fail:t_fail + dur + 10].max()),
                       recovery_slots=tf.recovery_slots(hurt.backlog, t_fail, t_fail + dur),
                       resp_degradation=tf.degradation(sw, sched, W))
            check(all(np.isfinite(v) for v in got.values()), f"phase F {sched} W={W}: not finite")
            ref = bench[(sched, W)]
            print(f"  disruption {sched} W={W}: " + ", ".join(
                f"{name} {v:.3f} (BENCH_disruption.json {ref[name]}, rel "
                f"{rel_diff(v, ref[name]):.3f})" for name, v in got.items()) + f" [{card}]")
    for row in tf.disruption_rows(grid):
        print(f"  {row.csv()}")


class HeldSlotRoute:
    """An ``ops`` namespace for the fused engine's compact partitions that
    launches the slot kernel through ``kernels.ops`` and holds every call,
    bitwise, against the plain version on the same batched arguments.
    ``calls`` counts the held calls."""

    def __init__(self):
        self.calls = 0

    def potus_slot_step(self, *args, **kw):
        import torch

        from repro_torch.kernels import ops as kops

        s_k, m_k = kops.potus_slot_step(*args, **kw)
        s_p, m_p = kops.plain.potus_slot_step(*args, **kw)
        same = (all(torch.equal(x, y) for x, y in zip(s_k, s_p))
                and all(torch.equal(x, y) for x, y in zip(m_k, m_p)))
        check(same, f"I2: a batched slot-kernel call (N={s_k[0].shape[0]}) differs from the "
              "batched plain version")
        self.calls += 1
        return s_k, m_k


SWEEP_V, SWEEP_W = (1.0, 2.0, 5.0, 10.0), (0, 4)


def sweep_path(card, cuda, fleet=None):
    """Phase I, scenario sweeps: I1 the I=16384 fleet's V x W grid through
    ``run_sweep(engine="cohort-fused")`` (2 partitions of N=4 sharing one
    arrival stream), each scenario bitwise against its own ``simulate``,
    the kernel's launches per partition, two runs, the sweep's and a loop of
    ``simulate``'s wall in turns, the busy share, kernel 1 at N=4 and N=1;
    I2 the dyadic system's sweep (potus, shuffle, jsq) bitwise against the
    CPU and every batched call against the batched plain version; I3 the
    paper profile's Fig. 6ab grid (one partition of N=28, stacked streams)
    and Fig. 5's V x W grid on the scan engine, held against the CPU at the
    chaos floor (the CPU's runs made after the card's). Returns kernel 1's
    batched entry for the kernels line."""
    import torch

    import benchmarks.torch_figures as tf
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

    # -- I1. the fleet, I=16384 ------------------------------------------------------
    t_phase = time.perf_counter()
    topo, net, placement, arr = fleet if fleet is not None else fleet_system(pt, FLEET_I, FLEET_T)
    spec = pt.SweepSpec(V=SWEEP_V, window=SWEEP_W, scheduler="potus", use_pallas=True)
    opts = {"age_cap": FLEET_AGE_CAP}

    def sweep():
        return pt.run_sweep(topo, net, placement, arr, FLEET_T, spec, engine="cohort-fused",
                            engine_opts=opts, device=cuda)

    def simulate(scn):
        return pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                         T=FLEET_T, scheduler="potus", V=scn.V,
                                         window=scn.window, age_cap=FLEET_AGE_CAP,
                                         device="cuda"))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    sw1 = sweep()
    torch.cuda.synchronize()
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_part = len(SWEEP_W)
    print(f"I1: sweep of {len(sw1)} scenarios (V {SWEEP_V} x W {SWEEP_W}) on the fleet "
          f"I={FLEET_I} T={FLEET_T}: n_batches={sw1.n_batches}, launches " + " ".join(
              f"{k}={v}" for k, v in n.items()) + f"; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) [{card}]")
    check(sw1.n_batches == n_part, f"I1: {sw1.n_batches} partitions, expected {n_part}")
    # each partition's kernel runs T calls, as one scenario's run does, not N x T
    check(n == dict(ZERO_COUNTS, potus_slot=n_part * FLEET_T), f"I1 launches {n}")
    sweep_launches = n["potus_slot"]
    sw2 = sweep()
    same = all(same_result(a, b) for (_, a), (_, b) in zip(sw1, sw2))
    print(f"  two runs bitwise identical: {same}")
    check(same, "I1: two sweeps differ")
    loop = [simulate(scn) for scn in sw1.scenarios]
    for (scn, res), one in zip(sw1, loop):
        check(same_result(res, one) and res.completed_mass > 0 and np.isfinite(res.avg_response),
              f"I1: scenario V={scn.V} W={scn.window} differs from its own simulate")
    print(f"  each of the {len(sw1)} scenarios bitwise equal to its own simulate: True; "
          + ", ".join(f"V={scn.V:g} W={scn.window}: avg_backlog {r.avg_backlog:.3f} "
                      f"avg_response {r.avg_response:.4f}" for scn, r in sw1))
    walls = {"sweep": [], "loop": []}
    for _ in range(3):
        for name, fn in (("sweep", sweep), ("loop", lambda: [simulate(scn)
                                                             for scn in sw1.scenarios])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    slots = len(sw1) * FLEET_T
    med = {k: float(np.median(v)) for k, v in walls.items()}
    for name, label in (("sweep", "the sweep"), ("loop", f"a loop of {len(sw1)} simulate")):
        print(f"  wall s of {label}, in turns: median {med[name]:.4f} "
              f"({', '.join(f'{w:.4f}' for w in walls[name])}); {slots / med[name]:.1f} "
              f"scenario-slots/s [{card}]")
    print(f"  sweep against the loop: {med['loop'] / med['sweep']:.3f}x (recorded) [{card}]")
    busy_ms, prof_ms = profile_run(sweep, top=6)

    # kernel 1 alone at N=4 (the V grid at W=4, shared stream) and N=1, from slot 64
    consts, state0, streams, one = batch_inputs(cf, (topo, net, placement, arr), FLEET_T,
                                                FLEET_W, list(SWEEP_V), [1.0] * len(SWEEP_V),
                                                FLEET_AGE_CAP, cuda, stacked=False)
    mid = run_slots(ps.potus_slot_call, consts, state0, streams, 8, "potus", FLEET_AGE_CAP,
                    T=64)[0]
    args = (consts, mid, *(x[64:65] for x in streams), 64)
    kw = dict(scheduler="potus", age_cap=FLEET_AGE_CAP, n_slots=1)
    s_k, m_k = ps.potus_slot_call(*args, **kw)
    s_p, m_p = ps.potus_slot_step_plain(*args, **kw)
    err = max_abs(s_k, torch.stack(m_k), s_p, torch.stack(m_p))
    check(err == 0.0, f"one batched call (N={len(SWEEP_V)}) at I={FLEET_I}: kernel vs plain "
          f"max_abs_err={err}")
    c1 = one[1][0]  # V=2: the main path's scenario
    args1 = (c1, tuple(x[1].contiguous() for x in mid), *(x[64:65] for x in streams), 64)
    s_1, m_1 = ps.potus_slot_call(*args1, **kw)
    check(all(torch.equal(x, y[1]) for x, y in zip(s_1, s_k))
          and all(torch.equal(x, y[1]) for x, y in zip(m_1, m_k)),
          "scenario 1 of the batched call differs from its own call")
    parts4, parts1 = {}, {}
    ms4 = device_ms(lambda: ps.potus_slot_call(*args, **kw), 50, parts=parts4)
    ms1 = device_ms(lambda: ps.potus_slot_call(*args1, **kw), 50, parts=parts1)
    ev4 = time_calls(lambda: ps.potus_slot_call(*args, **kw), 50)
    ev1 = time_calls(lambda: ps.potus_slot_call(*args1, **kw), 50)
    plain_ms = time_calls(lambda: ps.potus_slot_step_plain(*args, **kw), 5)
    N = len(SWEEP_V)
    nbytes, nops = bytes_and_ops(consts, mid, 1, stacked=False)
    bound_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= nops / PEAK_F32_S else "operations"
    print(f"one batched call at I={FLEET_I}, N={N}, K=1: max_abs_err={err:.3e}, scenario 1 "
          f"bitwise its own call; device ms per call: N={N} {ms4:.4f}, N=1 {ms1:.4f} (same "
          f"process); event ms per call: N={N} {ev4:.4f}, N=1 {ev1:.4f}, plain N={N} "
          f"{plain_ms:.4f}; bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes: the state "
          f"in and out and the metrics {N} times, the constants and the shared (1, I, C) "
          f"arrival streams once; {nops} ops) [{card}]")
    def bare(parts):  # a call of N > 1 runs the <true> instances, of one the <false>
        return {name.removeprefix("void ").split("<")[0]: ms for name, ms in parts.items()}

    parts1 = bare(parts1)
    for name, ms in sorted(bare(parts4).items(), key=lambda r: -r[1]):
        print(f"  part {name[:60]}: N={N} {ms:.4f}, N=1 {parts1.get(name, float('nan')):.4f} ms "
              "per call")
    del consts, state0, streams, one, mid, args, args1, s_k, s_p, s_1
    torch.cuda.empty_cache()
    print(f"  I1 {time.perf_counter() - t_phase:.1f} s")

    # -- I2. the dyadic system: card = CPU bitwise, each batched call = plain -----------
    t_phase = time.perf_counter()
    T_d = 40
    dtopo, dnet, dplace, darr = dyadic_system(pt, T_d + 8, 2)
    rng = np.random.default_rng(9)
    dpred = (darr * 2.0 ** rng.integers(-1, 2, size=darr.shape)).astype(np.float32)
    arrs = {"a": darr, "mis": (darr, dpred)}
    dspec = pt.SweepSpec(V=(1.0, 2.0), beta=0.5, window=(0, 2),
                         scheduler=("potus", "shuffle", "jsq"), arrival=("a", "mis"),
                         use_pallas=True)
    dopts = dict(age_cap=16, warmup=8, drain_margin=12)
    card_sw = pt.run_sweep(dtopo, dnet, dplace, arrs, T_d, dspec, engine="cohort-fused",
                           engine_opts=dopts, device=cuda)
    cpu_sw = pt.run_sweep(dtopo, dnet, dplace, arrs, T_d, dspec, engine="cohort-fused",
                          engine_opts=dopts, device="cpu")
    check(card_sw.n_batches == cpu_sw.n_batches == 6, "I2: partitions")
    check(all(same_result(a, b) and a.completed_mass > 0 for (_, a), (_, b)
              in zip(card_sw, cpu_sw)), "I2: the card's sweep differs from the CPU's")
    held = HeldSlotRoute()
    arr_map = {"a": (darr, None), "mis": (darr, dpred)}
    held_res, _ = cf.run_fused_sweep(dtopo, dnet, dplace, arr_map, T_d, dspec, device=cuda,
                                     ops=held, **dopts)
    check(held.calls == 6 * T_d and all(same_result(a, b) for a, (_, b)
                                        in zip(held_res, card_sw)), "I2: held route")
    print(f"I2: dyadic sweep of {len(card_sw)} scenarios (potus, shuffle, jsq x W (0, 2) x V "
          f"(1, 2) x arrivals (one mis-predicted), 6 partitions of N=4, T={T_d}): card equals "
          f"CPU bitwise; {held.calls} batched kernel calls each bitwise equal to the batched "
          f"plain version")
    print(f"  I2 {time.perf_counter() - t_phase:.1f} s")

    # -- I3. the paper profile: Fig. 6ab and Fig. 5 against the CPU at the chaos floor ---
    t_phase = time.perf_counter()
    _, p_arr, preds, sw6, wall6 = tf.fig6ab_sweep(cuda)
    sw6c, wall6c = cpu_run("fig6ab")
    check(sw6.n_batches == 1 and len(sw6) == len(tf.FIG6AB_VS) * len(preds), "I3: Fig. 6ab grid")
    check(len(sw6c) == len(I3_CPU_VS) * len(preds), "I3: the CPU's Fig. 6ab columns")
    worst = {}
    for scn, b in sw6c:
        a = sw6.result(V=scn.V, arrival=scn.arrival)
        for f in ("avg_backlog", "avg_cost", "avg_response"):
            worst[f] = max(worst.get(f, 0.0), rel_diff(getattr(a, f), getattr(b, f)))
    print(f"I3: Fig. 6ab grid, one partition of N={len(sw6)} with stacked streams, T="
          f"{tf.T_COHORT}, age_cap {tf.AGE_CAP['fig6ab']}: card {wall6:.3f} s; its {len(sw6c)} "
          f"scenarios at V {I3_CPU_VS} against the CPU's (one partition, {wall6c:.3f} s, one "
          f"thread): worst card vs CPU rel diff of the means " + ", ".join(
              f"{f} {v:.3e}" for f, v in worst.items()) + f" [{card}]")
    check(worst["avg_response"] <= 0.10 and worst["avg_backlog"] <= 0.10
          and worst["avg_cost"] <= 0.02, "I3 Fig. 6ab: beyond the chaos floor")
    for row in tf.fig6ab_rows(p_arr, preds, sw6, wall6):
        print(f"  card {row.csv()}")
    for row in tf.fig6ab_rows(p_arr, preds, sw6c, wall6c, vs=I3_CPU_VS):
        print(f"  CPU  {row.csv()}")
    sys5, arr5, _, sw5, wall5 = tf.fig5_sweep("fat-tree", cuda)
    sw5c, wall5c = cpu_run("fig5")
    worst = {}
    for scn, a in sw5:
        check(np.isfinite(a.backlog).all() and a.backlog.shape == (tf.T_SIM,), "I3 Fig. 5")
    for scn, b in sw5c:
        a = sw5.result(V=scn.V, window=scn.window)
        for f in ("avg_backlog", "avg_cost"):
            worst[f] = max(worst.get(f, 0.0), rel_diff(getattr(a, f), getattr(b, f)))
    print(f"I3: Fig. 5 grid on the scan engine, {len(sw5)} scenarios in {sw5.n_batches} "
          f"partitions, T={tf.T_SIM}: card {wall5:.3f} s; its {len(sw5c)} scenarios at W="
          f"{I3_CPU_FIG5_W} against the CPU's ({wall5c:.3f} s); worst card vs CPU "
          f"rel diff of the means " + ", ".join(f"{f} {v:.3e}" for f, v in worst.items())
          + f" [{card}]")
    check(worst["avg_backlog"] <= 0.10 and worst["avg_cost"] <= 0.02,
          "I3 Fig. 5: beyond the chaos floor")
    shuffle5 = tf._run_jax(sys5, arr5, tf.T_SIM, pt.SimConfig(V=1.0, scheduler="shuffle"), cuda)
    for row in tf.fig5_rows("fat-tree", sw5, shuffle5, wall5):
        print(f"  card {row.csv()}")
    print(f"  I3 {time.perf_counter() - t_phase:.1f} s")
    return {"N": N, "ms": ms4, "event_ms": ev4, "n1_ms": ms1, "n1_event_ms": ev1,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "sweep_launches": sweep_launches, "sweep_wall_s": med["sweep"],
            "loop_wall_s": med["loop"], "busy_share": busy_ms / prof_ms if busy_ms else None}


# ---------------------------------------------------------------------------
# phase J: observability — metric streams, span tracing, the obs dump
# ---------------------------------------------------------------------------

OBS_T = 40  # J1's horizon on the dyadic system


def frames_equal(a, b) -> bool:
    """Two ``MetricsFrame``s hold the same streams bitwise, but for the
    dispatch entropy (a log), within rel 1e-6."""
    if list(a.streams) != list(b.streams):
        return False
    for name, x in a.streams.items():
        y = b.streams[name]
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        if name == "dispatch":
            if not (np.array_equal(x[:, 0], y[:, 0]) and rel_diff(x[:, 1], y[:, 1]) <= 1e-6):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


def same_scan(a, b) -> bool:
    """Two scan-engine results with the same per-slot series and final
    state, bitwise."""
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in SERIES) and all(
        np.array_equal(getattr(a.final_state, f.name), getattr(b.final_state, f.name))
        for f in dataclasses.fields(a.final_state))


def streams_finite(frame) -> bool:
    return all(np.isfinite(x).all() for x in frame.streams.values())


def obs_launches(engine, scheduler, T):
    """The kernel launches of a metrics-on run: the streams change no route
    but the compact ``cohort-fused`` one (no slot kernel)."""
    if scheduler == "potus-loop":
        return dict(ZERO_COUNTS, potus_price=T,
                    **({"cohort_drain": T} if engine == "cohort-fused" else {}))
    if engine == "jax" and scheduler == "potus":
        return dict(ZERO_COUNTS, potus_schedule=T)
    return dict(ZERO_COUNTS)


def obs_dyadic(pt, cf, cuda):
    """J1: on the dyadic system (every sum exact), each engine x scheduler
    with every stream its engine serves, and a k-failure on
    ``cohort-fused``: the card's streams equal the port's on the CPU
    (entropy within rel 1e-6), metrics on leave the trajectories bitwise as
    off, the launches are the metrics-off routes' (``potus_slot=0`` on the
    compact ``cohort-fused`` route), and a compact ``cohort-fused`` run with
    metrics equals the plain route and the kernel route bitwise."""
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import ENGINE_STREAMS

    W = 2
    topo, net, placement, arr = dyadic_system(pt, OBS_T + 13, W)
    # the instances phase E's dyadic k-failure takes (rng seed 1): every split stays dyadic
    kfail = pt.k_failures(topo, 2, start=10, duration=12,
                          rng=np.random.default_rng(1)).compile(topo, OBS_T)
    cases = [(e, s, None) for e in ("jax", "cohort-fused")
             for s in ("potus", "shuffle", "jsq", "potus-loop")]
    cases.append(("cohort-fused", "potus", kfail))
    kw = {"jax": {}, "cohort-fused": dict(age_cap=32, warmup=10, drain_margin=10)}
    for engine, sched, ev in cases:
        label = f"J1 {engine} {sched}" + (" k-failure" if ev is not None else "")
        spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=OBS_T,
                             engine=engine, scheduler=sched, V=2.0, beta=0.5, window=W,
                             events=ev, metrics=tuple(sorted(ENGINE_STREAMS[engine])),
                             device="cuda", **kw[engine])
        reset_counts()
        on = pt.simulate(spec)
        n = read_counts()
        off = pt.simulate(dataclasses.replace(spec, metrics=None))
        cpu = pt.simulate(dataclasses.replace(spec, device="cpu"))
        same = same_scan if engine == "jax" else same_result
        ent = rel_diff(on.metrics.streams["dispatch"][:, 1], cpu.metrics.streams["dispatch"][:, 1])
        extra = ""
        check(n == obs_launches(engine, sched, OBS_T), f"{label}: launches {n}")
        check(frames_equal(on.metrics, cpu.metrics), f"{label}: the card's streams differ from "
              "the CPU's")
        check(same(on, off) and same(on, cpu), f"{label}: metrics on changed the trajectory, or "
              "the card's differs from the CPU's")
        check(off.metrics is None and on.metrics.n_slots == OBS_T and streams_finite(on.metrics),
              f"{label}: frame")
        if engine == "cohort-fused" and sched != "potus-loop" and ev is None:
            plain = cf._run_cohort_fused_impl(topo, net, placement, arr, None, OBS_T,
                                              spec.config(), device=cuda, ops=kops.plain,
                                              **kw[engine])
            check(same_result(on, plain), f"{label}: the metrics-on run differs from the plain "
                  "route")
            extra = ", = plain route, = kernel route"
        print(f"{label}: {len(on.metrics.streams)} streams, launches " + (" ".join(
            f"{k}={v}" for k, v in n.items() if v) or "none") + f" (potus_slot={n['potus_slot']}); "
              f"card = CPU bitwise (entropy rel {ent:.2e}); metrics on = off bitwise" + extra)


def obs_fleet(pt, cf, card, cuda, fleet):
    """J2: the I=16384 fleet, T=128, with metrics on: path 2 (kernel 2 once
    a slot, the trajectory bitwise as off, the backlog stream = the result's
    backlog) and the compact ``cohort-fused`` run with every fused stream
    (no slot kernel; = the plain route bitwise, the kernel route within
    compare_cohort's tolerances), each timed in turns with its metrics-off
    path, the streams finite, the peak device memory."""
    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.obs import ENGINE_STREAMS

    topo, net, placement, arr = fleet
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def turns(label, spec_off, spec_on):
        """Runs metrics on, off, off, on, each timed; returns the first on
        run (launches counted) and the first off run."""
        walls, runs = {"off": [], "on": []}, {}
        for k, which in enumerate(("on", "off", "off", "on")):
            if k == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pt.simulate(spec_on if which == "on" else spec_off)
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) * 1e3 / FLEET_T)
            runs.setdefault(which, res)
            if k == 0:
                runs["n"] = read_counts()
        print(f"  {label} wall ms/slot in turns (on, off, off, on): on " + ", ".join(
            f"{w:.4f}" for w in walls["on"]) + "; off " + ", ".join(
            f"{w:.4f}" for w in walls["off"]) + f"; medians off {np.median(walls['off']):.4f}, "
              f"on {np.median(walls['on']):.4f} [{card}]")
        return runs["on"], runs["off"], runs["n"]

    # -- path 2 with metrics on
    spec2 = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                          engine="jax", scheduler="potus", V=FLEET_V, window=FLEET_W,
                          device="cuda")
    on, off, n = turns("path 2", spec2, dataclasses.replace(spec2, metrics=True))
    print(f"J2 path 2 (engine=jax potus I={FLEET_I} T={FLEET_T}) metrics on: launches " + " ".join(
        f"{k}={v}" for k, v in n.items()) + f"; {len(on.metrics.streams)} streams; "
          f"= metrics off bitwise: {same_scan(on, off)}; backlog stream = backlog: "
          f"{np.array_equal(on.metrics.streams['backlog'][:, 0], on.backlog)} [{card}]")
    check(n == dict(ZERO_COUNTS, potus_schedule=FLEET_T), f"J2 path 2 launches {n}")
    check(same_scan(on, off), "J2 path 2: metrics on changed the trajectory")
    check(np.array_equal(on.metrics.streams["backlog"][:, 0], on.backlog),
          "J2 path 2: the backlog stream is not the result's backlog")
    check(streams_finite(on.metrics), "J2 path 2: a stream is not finite")
    del on, off
    torch.cuda.empty_cache()

    # -- cohort-fused potus with every fused stream: the compact step, not the slot kernel
    spec1 = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                          scheduler="potus", V=FLEET_V, window=FLEET_W, age_cap=FLEET_AGE_CAP,
                          device="cuda")
    on, off, n = turns("cohort-fused potus (off = path 1, the slot kernel)", spec1,
                       dataclasses.replace(spec1,
                                           metrics=tuple(sorted(ENGINE_STREAMS["cohort-fused"]))))
    cfg = spec1.config()
    plain = cf._run_cohort_fused_impl(topo, net, placement, arr, None, FLEET_T, cfg,
                                      age_cap=FLEET_AGE_CAP, device=cuda, ops=kops.plain)
    print(f"J2 cohort-fused potus I={FLEET_I} T={FLEET_T} metrics on: route compact_slot_step "
          f"(the slot kernel computes no streams), launches " + " ".join(
              f"{k}={v}" for k, v in n.items()) + f"; {len(on.metrics.streams)} streams; "
          f"= plain route bitwise: {same_result(on, plain)} [{card}]")
    check(n == ZERO_COUNTS, f"J2 cohort-fused metrics on launched a kernel: {n}")
    check(same_result(on, plain), "J2 cohort-fused: metrics on differs from the plain route")
    check(np.array_equal(on.metrics.streams["backlog"][:, 0], on.backlog)
          and streams_finite(on.metrics), "J2 cohort-fused: streams")
    compare_cohort("J2 metrics on vs kernel route", cf, pt, fleet, FLEET_T, cfg, cuda,
                   against="kernel", kernel=on, other=off, age_cap=FLEET_AGE_CAP)
    peak = torch.cuda.max_memory_allocated()
    print(f"  J2 peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")


def obs_dump(pt, card, cuda):
    """J3: ``benchmarks/torch_figures.py``'s metrics dump on the card at the
    QUICK sizes with tracing on, read back by ``tools/obs_report.py
    --recovery`` in a process of its own (stdlib only): its peak-backlog and
    recovery slots are the ones the result's backlog gives (rounded to the
    dump's 6 decimals); the Chrome trace holds the chunk spans; and a
    ``torch.profiler`` trace of traced runs lists the span names."""
    import torch

    import benchmarks.torch_figures as tf
    from repro_torch.obs import disable_tracing, enable_tracing

    with tempfile.TemporaryDirectory() as tmp:
        res, obs_file, trace_file, t0, dur, wall = tf.dump_obs(
            cuda, obs_path=str(Path(tmp) / "OBS_disruption_torch.json"),
            trace_path=str(Path(tmp) / "TRACE_disruption_torch.json"))
        frame = res.metrics
        check(len(frame.streams) == len(tf.OBS_STREAMS) and streams_finite(frame)
              and np.array_equal(frame.streams["backlog"][:, 0], res.backlog),
              "J3: the dump's streams")
        report = subprocess.run([sys.executable, str(ROOT / "tools" / "obs_report.py"), obs_file,
                                 "--recovery"], capture_output=True, text=True, check=True,
                                timeout=60).stdout
        story = dict(line.split() for line in report.split("recovery story")[1].splitlines()[1:]
                     if line.strip())
        want = tf.recovery_story(np.asarray(res.backlog, np.float64).round(6))
        spans = [e["name"] for e in json.loads(Path(trace_file).read_text())["traceEvents"]]
    got = (int(story["peak_backlog_slot"]), int(story["recovery_slot"]))
    print(f"J3 obs dump: {frame.n_slots} slots x {len(frame.streams)} streams, run {wall:.3f} s; "
          f"tools/obs_report.py --recovery: peak_backlog_slot {got[0]}, recovery_slot {got[1]} "
          f"(from the result's backlog: {want[0]}, {want[1]}; the failure at slot {t0} for "
          f"{dur}; the bench's recovery_slots "
          f"{tf.recovery_slots(res.backlog, t0, t0 + dur)}); Chrome trace: {len(spans)} spans "
          f"{sorted(set(spans))} [{card}]")
    check(got == want, "J3: obs_report's recovery story differs from the result's backlog")
    check("potus/cohort-fused/chunk" in spans, "J3: no chunk span in the Chrome trace")

    topo, net, placement, arr = dyadic_system(pt, OBS_T + 13, 2)
    tracer = enable_tracing()
    tracer.clear()
    try:
        # the spans are host ranges: a trace of the host's activity lists them
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for engine in ("jax", "cohort-fused"):
                pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr,
                                          T=OBS_T, engine=engine, window=2, chunk=8,
                                          metrics=True, device="cuda"))
            torch.cuda.synchronize()
    finally:
        disable_tracing()
    keys = {e.key for e in prof.key_averages()}
    names = {"potus/jax/problem-build", "potus/jax/chunk", "potus/cohort-fused/chunk"}
    print(f"  torch.profiler trace of two traced runs lists the spans {sorted(names & keys)}; "
          f"the tracer holds {len(tracer)} spans")
    check(names <= keys, f"J3: the profiler trace lacks spans {sorted(names - keys)}")


def obs_path(card, cuda, fleet=None):
    """Phase J, observability: J1 (:func:`obs_dyadic`), J2 (:func:`obs_fleet`)
    and J3 (:func:`obs_dump`); J4 runs in phase G. Builds the fleet when
    called alone."""
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf

    t0 = time.perf_counter()
    obs_dyadic(pt, cf, cuda)
    print(f"  J1 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs_fleet(pt, cf, card, cuda, fleet if fleet is not None
              else fleet_system(pt, FLEET_I, FLEET_T))
    print(f"  J2 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    obs_dump(pt, card, cuda)
    print(f"  J3 {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase K: the host-loop oracles — engine="cohort" and run_event_sim
# ---------------------------------------------------------------------------

ORACLE_T = 40  # K1's horizon on the dyadic system
ORACLE_SCHEDULERS = ("potus", "potus-loop", "shuffle", "jsq")
# K3's event-loop horizons on the fleet, extrapolated to FLEET_T as
# benchmarks/systems_bench.py:186-188 does (the loop's per-slot cost is T-independent)
ORACLE_PY_T = {1024: 8, 16384: 1}
# K3's cells, (sizes, schedulers): at I=16384 the potus loop only (a slot of the
# shuffle loop there took ~21 s and was cut; its I=1024 row stays)
ORACLE_CELLS = (((1024,), ("shuffle", "potus")), ((16384,), ("potus",)))
ORACLE_GAP_T = 200  # K4's horizon: the event-gap rows of benchmarks/workload.py:118-140


def oracle_launches(scheduler, T):
    """One launch of kernel 2 (``potus``) or kernel 3 (``potus-loop``) a
    slot on the host loops; Shuffle and JSQ launch no kernel."""
    kernel = {"potus": "potus_schedule", "potus-loop": "potus_price"}.get(scheduler)
    return dict(ZERO_COUNTS, **({kernel: T} if kernel else {}))


def same_oracle(a, b) -> bool:
    """Two event-loop results equal bitwise: the series, the response
    statistics, the cohort counts and the metric frame, every stream."""
    same = same_result(a, b) and a.n_cohorts == b.n_cohorts and (
        a.completed_frac == b.completed_frac)
    if a.metrics is None or b.metrics is None:
        return same and a.metrics is b.metrics
    return same and list(a.metrics.streams) == list(b.metrics.streams) and all(
        np.array_equal(x, b.metrics.streams[k]) for k, x in a.metrics.streams.items())


def same_events(a, b) -> bool:
    """Two ``run_event_sim`` results equal bitwise (its per-slot series carry
    the scan engine's names)."""
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in SERIES) and (
        a.n_events == b.n_events and a.completed_mass == b.completed_mass)


def counted(fn):
    """``fn()`` and the kernel launches it made."""
    reset_counts()
    out = fn()
    return out, read_counts()


def oracle_dyadic(pt, cuda):
    """K1: the dyadic system (every sum exact), T=40. ``engine="cohort"``
    for the four schedulers at W 0 and 2, with a mis-predicted stream and
    under a k-failure, every run with every cohort stream; ``run_event_sim``
    for the four at W 0 and 2, fluid and aligned, and with tuple service and
    jitter. The card's runs equal the CPU's bitwise, the fluid event
    simulator equals the scan engine on the card bitwise, and each run
    launches kernel 2 or 3 once a slot. Returns the launches of kernels 2
    and 3 on these paths."""
    from repro_torch.obs import ENGINE_STREAMS

    T, W2 = ORACLE_T, 2
    topo, net, placement, arr = dyadic_system(pt, T + 13, W2)
    rng = np.random.default_rng(9)
    pred = (arr * 2.0 ** rng.integers(-1, 2, size=arr.shape)).astype(np.float32)
    # the instances of J1's dyadic k-failure (rng seed 1): every split stays dyadic
    kfail = pt.k_failures(topo, 2, start=10, duration=12,
                          rng=np.random.default_rng(1)).compile(topo, T)
    streams = tuple(sorted(ENGINE_STREAMS["cohort"]))
    total = dict(potus_schedule=0, potus_price=0)

    def launched(label, sched, n):
        check(n == oracle_launches(sched, T), f"{label}: launches {n}")
        for k in total:
            total[k] += n[k]

    for sched in ORACLE_SCHEDULERS:
        cases = [(0, None, None, "W=0"), (W2, None, None, "W=2"),
                 (W2, pred, None, "W=2 mis-predicted"), (W2, None, kfail, "W=2 k-failure")]
        for W, p, ev, what in cases:
            spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=T,
                                 engine="cohort", scheduler=sched, V=2.0, beta=0.5, window=W,
                                 predicted=p, events=ev, warmup=8, drain_margin=12,
                                 metrics=streams, device="cuda")
            label = f"K1 cohort {sched} {what}"
            card_res, n = counted(lambda: pt.simulate(spec))
            launched(label, sched, n)
            cpu_res = pt.simulate(dataclasses.replace(spec, device="cpu"))
            check(same_oracle(card_res, cpu_res), f"{label}: the card's run differs from the "
                  "CPU's")
            check(card_res.completed_mass > 0 and np.isfinite(card_res.avg_response)
                  and card_res.metrics.n_slots == T and streams_finite(card_res.metrics),
                  f"{label}: result")
        want = oracle_launches(sched, T)
        line = [f"K1 cohort {sched}: W 0 and 2, mis-predicted, k-failure, {len(streams)} "
                f"streams: card = CPU bitwise (series, responses, n_cohorts, frame); launches a "
                f"run potus_schedule={want['potus_schedule']} potus_price={want['potus_price']}"]
        for W in (0, W2):
            cfg = pt.SimConfig(V=2.0, beta=0.5, window=W, scheduler=sched)
            label = f"K1 run_event_sim {sched} W={W}"
            fluid, n = counted(lambda: pt.run_event_sim(topo, net, placement, arr, T, cfg,
                                                        device="cuda"))
            launched(label, sched, n)
            scan = pt.simulate(pt.EngineSpec(topo=topo, net=net, placement=placement,
                                             arrivals=arr, T=T, engine="jax", scheduler=sched,
                                             V=2.0, beta=0.5, window=W, device="cuda"))
            check(all(np.array_equal(getattr(fluid, f), np.asarray(getattr(scan, f), np.float64))
                      for f in SERIES), f"{label}: fluid and aligned differs from the scan "
                  "engine")
            check(same_events(fluid, pt.run_event_sim(topo, net, placement, arr, T, cfg,
                                                      device="cpu")),
                  f"{label}: the card's fluid run differs from the CPU's")
            kw = dict(integral=True, jitter=0.5, seed=7)
            tuples, n = counted(lambda: pt.run_event_sim(topo, net, placement, 2 * arr, T, cfg,
                                                         device="cuda", **kw))
            launched(label, sched, n)
            check(same_events(tuples, pt.run_event_sim(topo, net, placement, 2 * arr, T, cfg,
                                                       device="cpu", **kw)),
                  f"{label}: the card's tuple-service run differs from the CPU's")
            check(tuples.n_events > 0 and tuples.completed_mass > 0, f"{label}: no events")
            line.append(f"run_event_sim W={W}: fluid = scan engine bitwise, card = CPU bitwise "
                        f"(fluid; tuple service with jitter 0.5: {tuples.n_events} events)")
        print("; ".join(line))
    return total


def oracle_paper(pt, card):
    """K2: the paper profile (I=83), T=300: ``engine="cohort"`` on the card
    held against the port's ``cohort-fused`` on the card — Shuffle within
    ``tests/test_cohort_fused.py:206-221``'s tolerances, POTUS within its
    chaos floor (``:229-242``: 10% on the means, 25% on p95, 2% on cost),
    ``n_cohorts`` equal."""
    T = 300
    topo, net, placement, arr = paper_system(pt, T)
    for sched, W in (("shuffle", 0), ("shuffle", 2), ("potus", 0), ("potus", 2)):
        spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=T,
                             engine="cohort", scheduler=sched, V=1.0, window=W, device="cuda")
        reset_counts()
        t0 = time.perf_counter()
        py = pt.simulate(spec)
        loop_ms = (time.perf_counter() - t0) * 1e3 / T
        n = read_counts()
        fu = pt.simulate(dataclasses.replace(spec, engine="cohort-fused"))
        label = f"K2 paper {sched} W={W}"
        check(n == oracle_launches(sched, T), f"{label}: launches {n}")
        check(fu.n_cohorts == py.n_cohorts, f"{label}: n_cohorts {fu.n_cohorts} vs {py.n_cohorts}")
        rels = {f: rel_diff(getattr(fu, f), getattr(py, f))
                for f in ("avg_response", "p95_response", "avg_backlog", "avg_cost")}
        if sched == "shuffle":
            ok = (np.allclose(fu.backlog, py.backlog, rtol=1e-5, atol=1e-3)
                  and np.allclose(fu.comm_cost, py.comm_cost, rtol=1e-5, atol=1e-3)
                  and rels["avg_response"] <= 1e-3 and rels["p95_response"] <= 1e-3
                  and rels["avg_backlog"] <= 1e-5 and rels["avg_cost"] <= 1e-5)
        else:
            ok = (rels["avg_response"] <= 0.10 and rels["p95_response"] <= 0.25
                  and rels["avg_backlog"] <= 0.10 and rels["avg_cost"] <= 0.02)
        print(f"{label}: cohort-fused vs the event loop rel diff " + ", ".join(
            f"{f} {v:.3e}" for f, v in rels.items()) + f"; n_cohorts {py.n_cohorts}; avg_response "
              f"{py.avg_response!r}/{fu.avg_response!r}; the loop {loop_ms:.3f} ms/slot [{card}]")
        check(ok, f"{label}: beyond the reference's bounds")


class LoopProfile:
    """K3's observer: each timed event-loop run of ``cohort_scale_rows`` in a
    ``torch.profiler`` trace, read as device ms a slot of kernel 2 and 3, of
    the copies of X back (``Memcpy DtoH``) and of the staged queues out
    (``Memcpy HtoD``), the busy share, and the launches."""

    def __init__(self):
        self.rows = {}

    @contextlib.contextmanager
    def __call__(self, I, scheduler, T_py):
        import torch

        torch.cuda.synchronize()
        reset_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_times(prof)

        def ms(key):
            return sum(r[2] for r in rows if key in r[0]) / T_py

        self.rows[(I, scheduler)] = dict(
            T_py=T_py, wall_ms=wall_ms / T_py, busy_ms=sum(r[2] for r in rows) / T_py,
            potus_schedule=ms("potus_schedule_kernel"), potus_price=ms("potus_price_kernel"),
            d2h=ms("Memcpy DtoH"), h2d=ms("Memcpy HtoD"), launches=read_counts(),
            top=rows[:4])


def oracle_scale(card):
    """K3: ``benchmarks/torch_systems.py``'s ``cohort_scale`` on the fleet at
    T=128 (``ORACLE_CELLS``: shuffle and potus at I=1024, potus at 16384):
    the event loop's wall ms a
    slot (on ORACLE_PY_T slots, extrapolated) beside the fused engine's,
    and from the loop's profile the device ms a slot of kernel 2, of the
    copy of X back and the busy share. Returns kernel 2's launches."""
    import benchmarks.torch_systems as ts

    prof = LoopProfile()
    rows = [row for sizes, scheds in ORACLE_CELLS
            for row in ts.cohort_scale_rows("cuda", sizes=sizes, T=FLEET_T, schedulers=scheds,
                                            python_T=lambda I, T: ORACLE_PY_T[I],
                                            observe=prof)]
    for row in rows:
        print(f"  K3 {row.csv()} [{card}]")
    launches = 0
    for (I, sched), r in prof.rows.items():
        check(r["launches"] == oracle_launches(sched, r["T_py"]),
              f"K3 {sched} I={I}: launches {r['launches']}")
        launches += r["launches"]["potus_schedule"]
        xbytes = 4 * I * I
        print(f"K3 cohort {sched} I={I}, {r['T_py']} slot(s) profiled: wall {r['wall_ms']:.3f} "
              f"ms/slot, device busy {r['busy_ms']:.4f} ms/slot (share "
              f"{r['busy_ms'] / r['wall_ms']:.4f}); kernel 2 {r['potus_schedule']:.4f} ms/slot; "
              f"X back (Memcpy DtoH, {xbytes} bytes) {r['d2h']:.4f} ms/slot ("
              f"{xbytes / max(r['d2h'], 1e-9) / 1e6:.1f} GB/s); queues out (Memcpy HtoD) "
              f"{r['h2d']:.4f} ms/slot [{card}]")
        if r["busy_ms"] == 0:
            print("    the profiler saw no device time: device ms not measured")
        for name, count, ms in r["top"]:
            print(f"    {ms:10.3f} ms  x{count:<6d} {name[:90]}")
    return launches


def oracle_gap(pt, card):
    """K4: ``benchmarks/torch_systems.py``'s event-gap rows (Poisson, MMPP,
    Pareto; ``integral=True, jitter=0.5, seed=7``) at T=200 on the card, and
    the same event runs on the CPU: equal bitwise (no kernel: Shuffle)."""
    import benchmarks.torch_systems as ts

    rows = ts.eventgap_rows("cuda", T=ORACLE_GAP_T)
    topo, net, placement = ts.compact_system()
    cfg = pt.SimConfig(window=2, scheduler="shuffle")
    for (kind, params), row in zip(ts.GAP_TRAFFIC, rows):
        arr = np.round(pt.ArrivalSpec(kind=kind, seed=5, rate_per_stream=2.0,
                                      params=params).generate(topo, ORACLE_GAP_T + 3))
        kw = dict(integral=True, jitter=0.5, seed=7)
        card_ev = pt.run_event_sim(topo, net, placement, arr, ORACLE_GAP_T, cfg, device="cuda",
                                   **kw)
        cpu_ev = pt.run_event_sim(topo, net, placement, arr, ORACLE_GAP_T, cfg, device="cpu",
                                  **kw)
        check(same_events(card_ev, cpu_ev), f"K4 {kind}: the card's events differ from the CPU's")
        check(f"events={card_ev.n_events}" in row.derived, f"K4 {kind}: row {row.derived}")
        print(f"K4 {row.csv()} (card = CPU bitwise) [{card}]")


def oracle_path(card, cuda):
    """Phase K, the host-loop oracles on the card: K1 (:func:`oracle_dyadic`),
    K2 (:func:`oracle_paper`), K3 (:func:`oracle_scale`), K4
    (:func:`oracle_gap`). Returns the launches of kernels 2 and 3 on these
    paths, for the kernels line."""
    import repro_torch.core as pt

    t0 = time.perf_counter()
    launches = oracle_dyadic(pt, cuda)
    print(f"  K1 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oracle_paper(pt, card)
    print(f"  K2 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["potus_schedule"] += oracle_scale(card)
    print(f"  K3 {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    oracle_gap(pt, card)
    print(f"  K4 {time.perf_counter() - t0:.1f} s")
    return launches

# ---------------------------------------------------------------------------
# phase L: the mixture-of-experts decoder (granite-moe-1b)
# ---------------------------------------------------------------------------

def moe_layer(cfg, seed, device):
    """One ``MoE`` layer of ``cfg`` drawn on the CPU from
    ``torch.Generator`` seed ``seed`` as ``model_zoo.init`` draws it, and its
    copy on ``device``."""
    import copy

    import torch

    from repro_torch.models import model_zoo as pz
    from repro_torch.models.moe import MoE

    with torch.device("meta"):
        moe = MoE(cfg, dtype=pz.DTYPES[cfg.param_dtype])
    cpu = pz.fill_(moe.to_empty(device="cpu").requires_grad_(False),
                   torch.Generator().manual_seed(seed))
    return cpu, copy.deepcopy(cpu).to(device)


def moe_calls(moe, cfg, xs, router_state):
    """``moe_ffn`` on each of ``xs`` in turn, the router state carried
    (None: no state). Returns [(y, aux)]."""
    from repro_torch.models.moe import moe_ffn

    out, rs = [], router_state
    for x in xs:
        y, aux = moe_ffn(moe, x, cfg, rs)
        rs = aux["router_state"]
        out.append((y, aux))
    return out


def moe_inputs(cfg, n_tokens, n_calls, device):
    """L1's and phase O's tokens in ``cfg``'s type: ``n_calls`` arrays from
    numpy seed N, (4, 1, D) for N=4 (a decode round), else (1, N, D)."""
    import torch

    from repro_torch.models.common import DTYPES

    rng = np.random.default_rng(n_tokens)
    shape = (4, 1) if n_tokens == 4 else (1, n_tokens)
    return [torch.as_tensor(rng.standard_normal(shape + (cfg.d_model,)).astype(np.float32))
            .to(device=device, dtype=DTYPES[cfg.param_dtype]) for _ in range(n_calls)]


MOE_EXACT = ("top_i", "keep", "load", "router_state", "dropped_frac")


def moe_card_vs_cpu(cfg, n_tokens, router, calls, cuda, seed=0):
    """``moe_ffn`` on the card against the port on the CPU from the same
    layer and tokens (numpy seed ``n_tokens``; (4, 1) for N=4, else
    (1, N)): ``calls`` calls, POTUS with its state carried from zeros, top-k
    without a state. The selections, keep masks, loads, router states and
    dropped fractions must be equal, y within 1e-5 of max |y| (f32), and two
    runs on the card bitwise equal. Returns (worst y gap of max |y|, the
    card's layer, its last input, the starting state on the card)."""
    import torch

    from repro_torch.models.moe import init_router_state

    c = cfg.with_(router=router)
    cpu, card_moe = moe_layer(c, seed, cuda)
    xs = moe_inputs(c, n_tokens, calls, "cpu")
    rs = init_router_state(c) if router == "potus" else None
    want = moe_calls(cpu, c, xs, rs)
    xs_card = [x.to(cuda) for x in xs]
    rs_card = None if rs is None else rs.to(cuda)
    got = moe_calls(card_moe, c, xs_card, rs_card)
    again = moe_calls(card_moe, c, xs_card, rs_card)
    torch.cuda.synchronize()
    worst = 0.0
    for step, ((yw, aw), (yg, ag), (ya, aa)) in enumerate(zip(want, got, again)):
        for key in MOE_EXACT:
            if aw[key] is None:
                check(ag[key] is None, f"moe {router} N={n_tokens}: {key} on one side only")
                continue
            same = torch.equal(ag[key].cpu(), aw[key])
            if not same and key == "top_i":
                flips = (ag[key].cpu() != aw[key]).nonzero()[:4].tolist()
                print(f"  moe {router} N={n_tokens} call {step}: selections differ at "
                      f"(token, choice) {flips}")
            check(same, f"moe {router} N={n_tokens} call {step}: card {key} differs from the CPU")
        gap = float((yg.cpu() - yw).abs().max()) / max(float(yw.abs().max()), 1e-30)
        worst = max(worst, gap)
        bitwise = torch.equal(yg, ya) and all(
            aa[key] is None or torch.equal(aa[key], ag[key]) for key in MOE_EXACT)
        check(bitwise, f"moe {router} N={n_tokens} call {step}: two runs on the card differ")
    check(worst <= 1e-5, f"moe {router} N={n_tokens}: y beyond 1e-5 of max |y| ({worst:.3e})")
    return worst, card_moe, xs_card[-1], rs_card


def device_items(fn, n):
    """Device ms per call, device items (kernels, copies, fills) per call and
    the trace's rows ``(name, count, ms)`` of ``n`` calls of ``fn``, from a
    ``torch.profiler`` trace (taken again, up to three times, when it holds
    no device record)."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = device_times(prof)
        if rows:
            return (sum(r[2] for r in rows) / n, sum(r[1] for r in rows) / n, rows)
    check(False, f"device_items: three traces of {n} calls held no device records")


def moe_alone(card, cuda):
    """L1: ``moe_ffn`` at granite-moe-1b widths (D 1024, 32 experts of F 512,
    top-8) in f32, card against CPU, N=4 and N=512, top-k and POTUS; an
    all-zero router (every logit tied) selects experts 0..7 on the card;
    each shape's device ms and device items per call."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_capacity, moe_ffn

    cfg = get_config(MOE_ARCH).with_(param_dtype="float32", compute_dtype="float32")
    for n_tokens in MOE_TOKENS:
        for router, calls in (("topk", 1), ("potus", MOE_CALLS)):
            worst, moe, x, rs = moe_card_vs_cpu(cfg, n_tokens, router, calls, cuda)
            print(f"L1 moe_ffn {router} N={n_tokens} f32 ({calls} call(s), cap "
                  f"{moe_capacity(cfg, n_tokens)}): card = CPU exactly in selections, keep "
                  f"masks, loads, router states, dropped fractions; y max gap {worst:.3e} of "
                  f"max |y| (limit 1e-5); two runs bitwise [{card}]")
        c = cfg.with_(router="potus")
        ms, items, rows = device_items(lambda: moe_ffn(moe, x, c, rs), 20)
        print(f"  device ms per call N={n_tokens}: {ms:.4f}, {items:.1f} device items per call "
              f"[{card}]")
        for name, count, t in rows[:6]:
            print(f"    {t / 20:10.4f} ms per call  x{count / 20:<5.1f} {name[:80]}")
    moe.router.zero_()
    _, aux = moe_ffn(moe, x, cfg)
    tied = bool((aux["top_i"] == torch.arange(cfg.top_k, device=cuda)).all())
    print(f"  all-zero router: every token selects experts 0..{cfg.top_k - 1}: {tied} [{card}]")
    check(tied, "moe: ties on the card do not select the lowest indices")


def moe_block_gaps(cfg, model, tokens, ops_a, ops_b):
    """Each layer's attention and MoE FFN run by two routes from the same
    input (route b's residual stream): the attention's output from ln1(x),
    then the MoE's from ln2 of each route's residual sum, the router state
    threaded as route b's. The attention's rounding flips a few selections
    at near-ties, and a flipped token's output moves by a whole expert's
    share, so the MoE gap is taken over the tokens whose selected and kept
    experts agree, and over all tokens as a record. Returns the worst
    attention gap, the worst MoE gaps (agreeing tokens, all tokens), as
    max |a - b| / max |b|, the token-expert selections that differ, all
    selections and the tokens with a difference."""
    import torch

    from repro_torch.models import model_zoo as pz
    from repro_torch.models.moe import init_router_state, moe_ffn

    x = pz._embed_input(model, cfg, {"tokens": tokens})
    positions = torch.arange(x.shape[1], device=x.device)
    rs = init_router_state(cfg, x.device)
    attn_worst = moe_worst = moe_all = 0.0
    differ = total = tokens_differ = 0
    for block in model.blocks:
        h = block.ln1(x)
        (out_a, _), (out_b, _) = (block.attn(h, positions, o) for o in (ops_a, ops_b))
        attn_worst = max(attn_worst, logit_gap(out_a, out_b)[0])
        (y_a, aux_a), (y_b, aux_b) = (moe_ffn(block.moe, block.ln2(x + o), cfg, rs)
                                      for o in (out_a, out_b))
        moe_all = max(moe_all, logit_gap(y_a, y_b)[0])
        chosen, kept = [], []
        for aux in (aux_a, aux_b):
            top_i, keep = aux["top_i"], aux["keep"].view(aux["top_i"].shape)
            zeros = torch.zeros(top_i.shape[0], cfg.n_experts, device=x.device)
            chosen.append(zeros.scatter(1, top_i, 1.0))
            kept.append(zeros.scatter(1, top_i, keep.float()))
        agree = ((chosen[0] == chosen[1]) & (kept[0] == kept[1])).all(dim=1)
        differ += int((chosen[0] != chosen[1]).sum()) // 2
        total += aux_b["top_i"].numel()
        tokens_differ += int((~agree).sum())
        moe_worst = max(moe_worst, logit_gap(y_a[0, agree], y_b[0, agree])[0])
        x, rs = x + out_b + y_b, aux_b["router_state"]
    return attn_worst, moe_worst, moe_all, differ, total, tokens_differ


def moe_router_balance(cfg, model, cuda, card):
    """L4: one ``forward`` of a skewed batch (1, 512) — its first 256 tokens
    one repeated id, the rest uniform (numpy seed 3) — with top-k and with
    POTUS routing: each MoE layer's expert load max/mean and dropped
    fraction, averaged over the layers, and the final router state."""
    import torch

    from repro_torch.models import model_zoo as pz

    rng = np.random.default_rng(3)
    toks = np.concatenate([np.full(256, int(rng.integers(cfg.vocab_size))),
                           rng.integers(0, cfg.vocab_size, 256)])
    batch = {"tokens": torch.as_tensor(toks, device=cuda)[None]}
    for router in ("topk", "potus"):
        _, aux = pz.forward(model, cfg.with_(router=router), batch)
        layers = aux["moe_layers"]
        loads = torch.stack([a["load"] for a in layers]).cpu().numpy()
        dropped = torch.stack([a["dropped_frac"] for a in layers]).cpu().numpy()
        imb = loads.max(axis=1) / np.maximum(loads.mean(axis=1), 1e-9)
        state = aux["router_state"].cpu().numpy()
        print(f"L4 {router}: expert load max/mean over {len(layers)} layers {imb.mean():.4f} "
              f"(layer min {imb.min():.4f}, max {imb.max():.4f}), dropped "
              f"{dropped.mean():.4f}; final router state max {state.max():.1f}, mean "
              f"{state.mean():.2f}, {int((state > 0).sum())} of {state.size} experts "
              f"backlogged [{card}]")
        check(len(layers) == cfg.n_layers and np.isfinite(imb).all(),
              f"L4 {router}: one load row per layer")


def moe_path(card, cuda):
    """Phase L: the MoE layer alone (L1), granite-moe-1b served at full width
    and depth in bf16 behind the dispatcher (L2), the kernel route against
    the plain route (L3), the POTUS router at full width (L4). Returns the
    served run's launches (kernels 5 and 6 for the kernels line)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import model_zoo as pz
    from repro_torch.serving.engine import ServingEngine

    t_phase = time.perf_counter()
    moe_alone(card, cuda)
    print(f"  L1 {time.perf_counter() - t_phase:.1f} s [{card}]")

    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    model = pz.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase L model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, head_dim {cfg.resolved_head_dim}, {cfg.n_experts} experts of d_ff "
          f"{cfg.d_ff}, top-{cfg.top_k}, capacity factor {cfg.capacity_factor}, vocab "
          f"{cfg.vocab_size}, {cfg.n_layers} layers, {cfg.param_dtype}: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB), drawn in {time.perf_counter() - t0:.2f} s [{card}]")
    # the config's count (configs/base.py) leaves out the final norm
    check(n_params == cfg.param_count() + cfg.d_model,
          "phase L: the model's parameters differ from the config's count")

    # L3's full-depth gap, recorded (also the warm-up)
    t_step = time.perf_counter()
    rel, diff, scale = teacher_forced(cfg, model, cuda)
    print(f"L3 teacher-forced kernel vs plain route, {cfg.n_layers} layers bf16, 4 prompts x 8 "
          f"decode steps: max |dlogit| {diff:.4e} of max |logit| {scale:.4e} = {rel:.4e} "
          f"(recorded, not held; {time.perf_counter() - t_step:.1f} s) [{card}]")

    # L2: the served run at MOE_SERVE_LAYERS layers, counted and timed; a second run,
    # profiled, gives the same tokens
    t_step = time.perf_counter()
    cfg_s = cfg.with_(n_layers=MOE_SERVE_LAYERS)
    served = pz.init(cfg_s, torch.Generator(device=cuda).manual_seed(0), cuda)
    print(f"L2 serves {cfg.name} at {MOE_SERVE_LAYERS} of {cfg.n_layers} layers [{card}]")
    n, reqs, slots, _ = served_run(cfg_s, served, cuda, MOE_REQUESTS, card)
    first = {r.rid: list(r.generated) for r in reqs}
    second = {}
    profile_run(lambda: second.update(run=serve(cfg_s, served, cuda, ServingEngine,
                                                n_requests=MOE_REQUESTS)),
                top=10, suffix=f" [{card}]", also=ATTENTION_KERNELS)
    del served
    reqs2, slots2, _, _ = second["run"]
    same = slots2 == slots and {r.rid: list(r.generated) for r in reqs2} == first
    print(f"  two runs give identical tokens: {same} (the second profiled); L2 "
          f"{time.perf_counter() - t_step:.1f} s [{card}]")
    check(same, "phase L served run: two runs differ")
    t_step = time.perf_counter()

    # L3: each block from the same input, bf16
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, SERVE_PROMPT_LENS[-1]),
                             device=cuda)[None]
    attn_gap, moe_gap, moe_all, differ, total, tokens_differ = moe_block_gaps(
        cfg, model, tokens, kops, kops.plain)
    print(f"L3 each of the {cfg.n_layers} blocks from the same input, bf16, "
          f"{tokens.shape[1]} tokens: attention {attn_gap:.4e}, MoE FFN on the tokens whose "
          f"selections agree {moe_gap:.4e} of max |out| (limit 5e-2); token-expert selections "
          f"that differ {differ} of {total}, over {tokens_differ} token-layers; MoE FFN over "
          f"all tokens {moe_all:.4e} (recorded, not held) [{card}]")
    check(attn_gap <= 5e-2 and moe_gap <= 5e-2,
          "L3: a block's kernel route beyond 5e-2 of the plain route's scale")

    # L4: the POTUS router against top-k on a skewed batch
    moe_router_balance(cfg, model, cuda, card)
    print(f"  L3 blocks and L4 {time.perf_counter() - t_step:.1f} s [{card}]")
    del model
    torch.cuda.empty_cache()

    # L3 at 2 layers in f32: the kernels' own error, without bf16's
    cfg32 = cfg.with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    model32 = pz.init(cfg32, torch.Generator(device=cuda).manual_seed(0), cuda)
    rel, diff, scale = teacher_forced(cfg32, model32, cuda)
    print(f"L3 teacher-forced kernel vs plain route, 2 layers f32: max |dlogit| {diff:.4e} of "
          f"max |logit| {scale:.4e} = {rel:.4e} (limit 1e-4) [{card}]")
    check(rel <= 1e-4, "L3 f32: kernel route vs plain beyond 1e-4 of max |logit|")
    del model32
    torch.cuda.empty_cache()
    print(f"  phase L {time.perf_counter() - t_phase:.1f} s [{card}]")
    return n


# ---------------------------------------------------------------------------
# phase M: training (repro_torch.training, repro_torch.data), kernel 5b
# ---------------------------------------------------------------------------

def bwd_bound(B, Hq, Hkv, S, D, causal, dtype):
    """Bytes (q, dO, dQ of Hq heads and k, v, dK, dV of Hkv heads, each
    once) and operations (five products of the forward's size, 10 B Hq D
    S^2, halved when causal) of one backward call, and its bound."""
    import torch

    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = B * S * D * (3 * Hq + 4 * Hkv) * elem
    flops = 10 * B * Hq * D * S * S // (2 if causal else 1)
    return (nbytes, flops, *attention_bound(nbytes, flops, dtype))


def library_sdpa_backward(q, k, v, dout, causal):
    """One backward of ``F.scaled_dot_product_attention`` (GQA) on the same
    tensors, its graph kept: the yardstick of kernel 5b's ``library_ms``."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = library_sdpa(*leaves, is_causal=causal)
    return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)


def flash_bwd_checks(card, cuda):
    """M1: kernel 5b alone at internvl2-1b's widths (causal, Hq 14 / Hkv 2,
    D 64) and hubert-xlarge's (bidirectional, 16/16, D 80), B=2, S=1024, in
    bf16 (the tensor-core route) and f32 (SIMT): dQ, dK, dV against the
    autograd gradient of the plain version within ``ATT_TOL`` of each
    gradient's scale, the tensor-core route also against its statement in
    plain PyTorch within ``BWD_TC_TOL``, two runs bitwise, launches on the
    route ``bwd_route`` names; in bf16 the device ms per call and per pass
    beside SDPA's backward and the bound, TFLOP/s on the bound's five
    products and on the nine the kernels do (the f32 route is held, not
    timed). Returns the kernels line's row (``BWD_ENTRY``)."""
    import torch

    from repro_torch.kernels import flash_attention as kf

    worst, entry = 0.0, None
    for widths, (B, Hq, Hkv, D, causal) in BWD_DIMS.items():
        for name in ("bfloat16", "float32"):
            dtype, S = getattr(torch, name), TRAIN_S
            route = kf.bwd_route(dtype, D)
            g = torch.Generator(device=cuda).manual_seed(D)
            q, k, v, dout = (torch.randn((B, h, S, D), generator=g, device=cuda).to(dtype)
                             for h in (Hq, Hkv, Hkv, Hq))
            reset_counts()
            got = kf.flash_attention_bwd_call(q, k, v, dout, causal)
            again = kf.flash_attention_bwd_call(q, k, v, dout, causal)
            want = kf.flash_attention_bwd_plain(q, k, v, dout, causal)
            torch.cuda.synchronize()
            routes = kernel_routes()["flash_attention_bwd"]
            check(read_counts() == dict(ZERO_COUNTS, flash_attention_bwd=2)
                  and routes == {r: 2 * (r == route) for r in ("tc", "simt")},
                  f"M1 launches {read_counts()}, routes {routes}, expected 2 on {route}")
            label = f"M1 flash backward {widths} S={S} {name} causal={causal} ({route})"
            gaps = [float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
                    for a, w in zip(got, want)]
            print(f"{label}: dq/dk/dv gap of scale {gaps[0]:.3e}/{gaps[1]:.3e}/{gaps[2]:.3e} "
                  f"(limit {ATT_TOL[name]}) [{card}]")
            check(max(gaps) <= ATT_TOL[name], f"{label}: kernel vs plain beyond {ATT_TOL[name]}")
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{label}: two kernel runs differ")
            if route == "tc":
                stmt = kf.flash_attention_bwd_tc_plain(q, k, v, dout, causal)
                sgaps = [float((a.float() - w.float()).abs().max()) / float(w.float().abs().max())
                         for a, w in zip(got, stmt)]
                print(f"  against its statement (flash_attention_bwd_tc_plain): dq/dk/dv gap of "
                      f"scale {sgaps[0]:.3e}/{sgaps[1]:.3e}/{sgaps[2]:.3e} (limit {BWD_TC_TOL}) "
                      f"[{card}]")
                check(max(sgaps) <= BWD_TC_TOL, f"{label}: kernel vs its statement beyond "
                                                f"{BWD_TC_TOL}")
                del stmt
            err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
            worst = max(worst, err)
            del got, again, want
            if name == "float32":  # the SIMT route is held above, not timed
                del q, k, v, dout
                torch.cuda.empty_cache()
                continue
            n = 10
            kernel = partial(kf.flash_attention_bwd_call, q, k, v, dout, causal)
            sdpa = library_sdpa_backward(q, k, v, dout, causal)
            passes = {f: 1 for f in BWD_PASSES[route]
                      if f != "flash_bwd_tc_reduce_kernel" or Hq > Hkv}
            parts = {}
            ms = device_ms(kernel, n, parts=parts, expect=passes)
            event_ms = time_calls(kernel, n)
            library_ms, library_event_ms = device_ms(sdpa, n), time_calls(sdpa, n)
            plain_ms = time_calls(lambda: kf.flash_attention_bwd_plain(q, k, v, dout, causal), 3)
            nbytes, flops, bound_ms, bound_by = bwd_bound(B, Hq, Hkv, S, D, causal, dtype)
            flops9 = flops // 5 * 9  # S and dP twice, dQ; S^T, dP^T, dV, dK
            print(f"  device ms per call: kernel {ms:.4f} ("
                  + ", ".join(f"{kernel_base(f)} {t:.4f}" for f, t in parts.items())
                  + f"), library (SDPA backward) {library_ms:.4f}; event ms per call: kernel "
                  f"{event_ms:.4f}, SDPA {library_event_ms:.4f}, plain {plain_ms:.4f}; bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {flops} flops); kernel "
                  f"{flops / ms / 1e9:.2f} TFLOP/s on the bound's 5 products, "
                  f"{flops9 / ms / 1e9:.2f} on the 9 it does; SDPA "
                  f"{flops / library_ms / 1e9:.2f} [{card}]")
            if (widths, name) == BWD_ENTRY:
                entry = dict(ms=ms, event_ms=event_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             library_event_ms=library_event_ms, kernel_route=route,
                             passes_ms={kernel_base(f): t for f, t in parts.items()})
            del q, k, v, dout, sdpa
            torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/common.py:230 (no TPU kernel: XLA differentiates the "
                        "plain attention)",
            "launches": None, "max_abs_err": worst, **entry}


def train_batch(cfg, cuda):
    """The repeated batch of M2/M3: ``TokenPipeline(cfg, TRAIN_B, TRAIN_S,
    seed 0)``'s first, on the card (internvl2-1b: 256 patches + 768 tokens;
    hubert-xlarge: 1024 frame embeddings)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.specs import as_tensors

    return as_tensors(TokenPipeline(cfg, batch=TRAIN_B, seq=TRAIN_S, seed=0).next_batch(), cfg,
                      cuda)


def route_gaps(cfg, model, batch, rs, witness=False):
    """Loss and every gradient of one batch by the kernel route and by the
    plain route (``kernels.ops.plain``: attention's gradient by autograd of
    the plain version). Returns (loss gap of |loss|, worst gradient gap of
    its scale, the parameter it is in). With ``witness`` (a bf16 model), the
    plain route also runs in float32 on the same weights and inputs, and a
    fourth item gives, for that parameter, the gap of its plain bf16
    gradient and of its kernel bf16 gradient to the f32 one (each of the f32
    gradient's scale), and the worst plain bf16 gap over all parameters: the
    rounding of bf16 itself, beside which the kernel's gap is read."""
    import copy

    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.training import train_loop as ptl

    names = [n for n, _ in model.named_parameters()]
    out = {}
    for route in (kops, kops.plain):
        loss, _ = ptl.make_loss_fn(cfg, ptl.TrainConfig(), ops=route)(model, batch, rs)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[route is kops] = (float(loss.detach()), grads)
        del loss
    (lk, gk), (lp, gp) = out[True], out[False]

    def gap(a, b):
        return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                1e-30)

    gaps = [gap(a, b) for a, b in zip(gk, gp)]
    i = int(np.argmax(gaps))
    result = (abs(lk - lp) / abs(lp), gaps[i], names[i])
    if not witness:
        return result
    del out
    cfg32 = cfg.with_(param_dtype="float32", compute_dtype="float32")
    model32 = copy.deepcopy(model).float()
    batch32 = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    loss, _ = ptl.make_loss_fn(cfg32, ptl.TrainConfig(), ops=kops.plain)(model32, batch32, rs)
    g32 = torch.autograd.grad(loss, list(model32.parameters()))
    del loss, model32
    plain_bf16 = [gap(a, b) for a, b in zip(gp, g32)]
    j = int(np.argmax(plain_bf16))
    return (*result, dict(plain=plain_bf16[i], kernel=gap(gk[i], g32[i]),
                          worst_plain=plain_bf16[j], worst_plain_at=names[j]))


def train_run(cfg, tcfg, state, batch, n_steps, card, label, routes):
    """``n_steps`` train steps on one repeated batch, each counted and timed
    (synchronised); checks each step's launches (kernels 5 and 5b once per
    layer, each on its route in ``routes``, no other kernel) and finite
    loss and grad norm. Returns (losses, step ms, launches summed)."""
    import torch

    from repro_torch.training import train_loop as ptl

    step = ptl.make_train_step(cfg, tcfg)
    losses, walls, total = [], [], dict(ZERO_COUNTS)
    for i in range(n_steps):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        n = read_counts()
        want = dict(ZERO_COUNTS, flash_attention=cfg.n_layers, flash_attention_bwd=cfg.n_layers)
        check(n == want, f"{label} step {i}: launches {n}, expected {want}")
        for kernel, route in routes.items():
            got = kernel_routes()[kernel]
            check(got == {r: cfg.n_layers * (r == route) for r in ("tc", "simt")},
                  f"{label} step {i}: {kernel} launches off the {route} route: {got}")
        check(np.isfinite(loss) and np.isfinite(gnorm), f"{label} step {i}: not finite")
        print(f"{label} step {i}: loss {loss:.6f}, grad norm {gnorm:.4f}, lr "
              f"{float(met['lr']):.3e}, {walls[-1]:.2f} ms; launches flash_attention="
              f"{n['flash_attention']} flash_attention_bwd={n['flash_attention_bwd']} [{card}]")
        losses.append(loss)
        total = {k: total[k] + n[k] for k in total}
    return losses, walls, total


def train_model(arch, card, cuda, n_steps, hold_witness=False):
    """M2 (internvl2-1b) or M3 (hubert-xlarge) at full width and depth in
    bf16: the model drawn from a seeded ``torch.Generator`` with gradients
    on, ``n_steps`` train steps on one repeated batch (the loss must fall),
    one more step profiled (busy share, top device items), the peak device
    memory; then the full-depth gap between the kernel and the plain route
    (recorded) with its f32 witness (held with ``hold_witness``: on the
    worst leaf, the kernel route's bf16 gap to f32 within
    ``WITNESS_FACTOR`` times the plain route's own) and, at 2 layers in
    f32, the same gap (held within 1e-4).
    Returns (the state after the steps, the config, the train config, the
    batch, the launches of the timed steps)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models import model_zoo as pz
    from repro_torch.training import train_loop as ptl
    from repro_torch.training.optimizer import OptConfig

    cfg = get_config(arch)
    tcfg = ptl.TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=100))
    t0 = time.perf_counter()
    state = ptl.init_train_state(cfg, tcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    batch = train_batch(cfg, cuda)
    routes = {"flash_attention": kf.route(torch.bfloat16, cfg.resolved_head_dim),
              "flash_attention_bwd": kf.bwd_route(torch.bfloat16, cfg.resolved_head_dim)}
    print(f"phase M model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
          f"heads, head_dim {cfg.resolved_head_dim} (flash route {routes['flash_attention']}, "
          f"backward route {routes['flash_attention_bwd']}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.n_layers} layers, {cfg.param_dtype}, "
          f"{'encoder' if cfg.is_encoder else 'causal decoder'}, frontend {cfg.frontend}: "
          f"{n_params} parameters; batch {TRAIN_B} x {TRAIN_S} "
          f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in batch.items())}); drawn in "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    # one forward without grad, timed (kernel 5 alone, once per layer)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = pz.forward(model, cfg, batch)
    finite = bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    check(read_counts() == dict(ZERO_COUNTS, flash_attention=cfg.n_layers) and finite
          and logits.shape == (TRAIN_B, TRAIN_S, cfg.vocab_size),
          f"M {cfg.name}: forward launches {read_counts()} or logits not finite")
    print(f"  forward without grad: {fwd_ms:.2f} ms, logits {tuple(logits.shape)} finite, "
          f"kernel 5 x{cfg.n_layers} [{card}]")
    del logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, walls, total = train_run(cfg, tcfg, state, batch, n_steps, card, f"M {cfg.name}",
                                     routes)
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0], f"M {cfg.name}: the loss did not fall: {losses}")
    print(f"  {n_steps} steps: loss {losses[0]:.6f} -> {losses[-1]:.6f}; step wall ms median "
          f"{np.median(walls):.2f} (first {walls[0]:.2f}, min {min(walls):.2f}); peak device "
          f"memory {peak} bytes ({peak / 2**30:.3f} GiB) [{card}]")
    step = ptl.make_train_step(cfg, tcfg)
    profile_run(lambda: step(state, batch), top=8, suffix=f" [{card}]",
                also=(*BWD_PASSES["tc"], *BWD_PASSES["simt"], "flash_simt", "flash_tc"))
    # the kernel route against the plain route: the full-depth bf16 gap, recorded
    t1 = time.perf_counter()
    loss_gap, grad_gap, where, f32 = route_gaps(cfg, model, batch, state["router_state"],
                                                witness=True)
    print(f"  kernel vs plain route, {cfg.n_layers} layers bf16: loss gap {loss_gap:.3e} of "
          f"|loss|, worst gradient gap {grad_gap:.3e} of its scale ({where}) (recorded, not "
          f"held); against the plain route in f32 on the same weights and inputs, {where}'s "
          f"gap is {f32['plain']:.3e} by the plain route in bf16 and {f32['kernel']:.3e} by the "
          f"kernel route in bf16; the plain route's worst bf16 gap {f32['worst_plain']:.3e} "
          f"({f32['worst_plain_at']}); {time.perf_counter() - t1:.1f} s [{card}]")
    ratio = f32["kernel"] / max(f32["plain"], 1e-30)
    print(f"  witness: the kernel route's bf16 gap to f32 on {where} is {ratio:.3f}x the plain "
          f"route's own (limit {WITNESS_FACTOR}, {'held' if hold_witness else 'recorded'}) "
          f"[{card}]")
    if hold_witness:
        check(ratio <= WITNESS_FACTOR, f"M {cfg.name}: the kernel route's bf16 gap to f32 on "
                                       f"{where} is {ratio:.3f}x the plain route's own")
    torch.cuda.empty_cache()
    return state, cfg, tcfg, batch, total


def two_layer_f32_gap(arch, card, cuda):
    """The kernel route against the plain route at 2 layers in f32 (the
    kernels' own error, without bf16's): loss and every gradient within
    1e-4 of scale."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.training import train_loop as ptl

    cfg = get_config(arch).with_(n_layers=2, param_dtype="float32", compute_dtype="float32")
    state = ptl.init_train_state(cfg, ptl.TrainConfig(),
                                 torch.Generator(device=cuda).manual_seed(0), cuda)
    loss_gap, grad_gap, where = route_gaps(cfg, state["params"], train_batch(cfg, cuda),
                                           state["router_state"])
    print(f"  kernel vs plain route, {cfg.name} 2 layers f32: loss gap {loss_gap:.3e} of |loss|, "
          f"worst gradient gap {grad_gap:.3e} of its scale ({where}) (limit 1e-4) [{card}]")
    check(loss_gap <= 1e-4 and grad_gap <= 1e-4,
          f"M {cfg.name} 2 layers f32: kernel route vs plain beyond 1e-4")
    del state
    torch.cuda.empty_cache()


def checkpoint_state(cfg, tcfg, batch, cuda):
    """M4's model: ``cfg`` at full width cut to ``CKPT_LAYERS`` layers,
    drawn from the seed of M2 and trained ``TRAIN_STEPS`` steps on M2's
    batch. Returns (its config, the train config, the state)."""
    import torch

    from repro_torch.training import train_loop as ptl

    cfg = cfg.with_(n_layers=CKPT_LAYERS)
    state = ptl.init_train_state(cfg, tcfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    step = ptl.make_train_step(cfg, tcfg)
    for _ in range(TRAIN_STEPS):
        state, _ = step(state, batch)
    return cfg, tcfg, state


def checkpoint_resume(cfg, tcfg, state, batch, card, cuda):
    """M4: a trained state (weights, AdamW's moments and step) through an
    ``AsyncCheckpointer`` (the host copy on this thread, the write on its
    own), restored on the card into a fresh state, bitwise; then
    ``CKPT_RESUME_STEPS`` more steps from each, the resumed run against the
    uninterrupted one: bitwise, or the gap recorded."""
    import shutil

    import torch

    from repro_torch.training import checkpoint as ck
    from repro_torch.training import train_loop as ptl

    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        leaves = ck.flatten_state(state)
        nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
        saver = ck.AsyncCheckpointer(ckpt_dir, keep=1)
        t0 = time.perf_counter()
        saver.save(int(state["opt"]["step"]), state, extra=dict(batch_seed=0))
        t_copy = time.perf_counter() - t0
        saver.wait()
        t_save = time.perf_counter() - t0
        step_k = ck.latest_step(ckpt_dir)
        fresh = ptl.init_train_state(cfg, tcfg, torch.Generator(device=cuda).manual_seed(1), cuda)
        t0 = time.perf_counter()
        restored, extra = ck.restore_checkpoint(ckpt_dir, step_k, fresh)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        back = ck.flatten_state(restored)
        same = list(back) == list(leaves) and all(
            torch.equal(back[key].detach(), leaves[key].detach()) for key in leaves)
        print(f"M4 checkpoint of {cfg.name} at step {step_k}: {len(leaves)} leaves, {nbytes} "
              f"bytes; AsyncCheckpointer host copy {t_copy:.2f} s, written in {t_save:.2f} s, "
              f"restored on the card in {t_load:.2f} s; restored bitwise: {same} [{card}]")
        check(same and extra == dict(batch_seed=0), "M4: the restored state differs")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    step = ptl.make_train_step(cfg, tcfg)
    for _ in range(CKPT_RESUME_STEPS):
        state, _ = step(state, batch)
        restored, _ = step(restored, batch)
    torch.cuda.synchronize()
    a, b = ck.flatten_state(state), ck.flatten_state(restored)
    differ = [key for key in a if not torch.equal(a[key].detach(), b[key].detach())]
    gap = max((float((a[k].detach().float() - b[k].detach().float()).abs().max())
               for k in differ), default=0.0)
    print(f"M4 resumed from step {step_k} against the uninterrupted run, {CKPT_RESUME_STEPS} "
          f"steps on: bitwise {not differ} ({len(differ)} of {len(a)} leaves differ, max gap "
          f"{gap:.3e}; first {differ[:3]}) [{card}]")
    return not differ


def training_path(card, cuda):
    """Phase M: kernel 5b alone (M1); internvl2-1b trained at full width and
    depth in bf16 (M2); the checkpoint and resume of its full width at
    ``CKPT_LAYERS`` layers (M4); hubert-xlarge likewise (M3). Returns the kernels line's row of kernel 5b with its
    launches on M2's steps, and kernel 5's launches on M2 and M3."""
    import torch

    t_phase = time.perf_counter()
    row = flash_bwd_checks(card, cuda)
    print(f"  M1 {time.perf_counter() - t_phase:.1f} s [{card}]")

    t0 = time.perf_counter()
    state, cfg, tcfg, batch, m2 = train_model("internvl2_1b", card, cuda, TRAIN_STEPS)
    two_layer_f32_gap("internvl2_1b", card, cuda)
    print(f"  M2 {time.perf_counter() - t0:.1f} s [{card}]")
    t0 = time.perf_counter()
    del state
    torch.cuda.empty_cache()
    resumed = checkpoint_resume(*checkpoint_state(cfg, tcfg, batch, cuda), batch, card, cuda)
    del batch
    torch.cuda.empty_cache()
    print(f"  M4 {time.perf_counter() - t0:.1f} s [{card}]")

    t0 = time.perf_counter()
    state, *_, m3 = train_model("hubert_xlarge", card, cuda, ENCODER_STEPS, hold_witness=True)
    del state
    torch.cuda.empty_cache()
    two_layer_f32_gap("hubert_xlarge", card, cuda)
    print(f"  M3 {time.perf_counter() - t0:.1f} s; phase M {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]")
    row["launches"] = m2["flash_attention_bwd"]
    row["encoder_launches"] = m3["flash_attention_bwd"]
    row["resume_bitwise"] = resumed
    return row, {"train_launches": m2["flash_attention"],
                 "encoder_launches": m3["flash_attention"]}


# ---------------------------------------------------------------------------
# phase N: the instance-sharded engines (core/sharded.py on torch.distributed)
# ---------------------------------------------------------------------------

# N2's world: four gloo ranks sharing the card, with a timeout of its own (a
# hung rank fails the phase); the I=16 dyadic system of tests/test_torch_sharded.py
# (its rolling restart takes down instances of two-instance components, so every
# split stays dyadic), cut from the CPU tests' T=30 to T=16 (a gloo exchange costs
# ~3-7 ms there, ~9 a slot), and the fleet at T=16
SHARD_RANKS, SHARD_TIMEOUT_S = 4, 240
SHARD_T, SHARD_RESTART, SHARD_FLEET_T = 16, (1, 7, 11), 16


def sharded_system(pt):
    """tests/test_sharded_cohort.py's dyadic system (I=16, divisible by 4)
    and its dyadic rolling restart."""
    C = pt.Component
    apps = [[C("src", 0, True, 2, successors=(1,)),
             C("mid", 0, False, 4, 4.0, successors=(2,)),
             C("sink", 0, False, 2, 4.0)],
            [C("src", 1, True, 2, successors=(1, 2), selectivity=(0.5, 0.5)),
             C("a", 1, False, 2, 4.0, successors=(3,)),
             C("b", 1, False, 2, 4.0, successors=(3,)),
             C("sink", 1, False, 2, 8.0)]]
    topo = pt.build_topology(apps, gamma=64.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs("fat-tree", sd)
    placement = pt.t_heron_placement(topo, net, np.ones((topo.n_instances, topo.n_components)),
                                     max_per_container=4)
    rng = np.random.default_rng(11)
    unit = pt.spout_rate_matrix(topo, 1.0)
    arr = (2.0 ** rng.integers(-1, 2, size=(SHARD_T + 1, *unit.shape))).astype(np.float32)
    arr *= rng.random((SHARD_T + 1, *unit.shape)) < 0.8
    trace = pt.rolling_restart(topo, start=8, down_slots=2, instances=list(SHARD_RESTART)
                               ).compile(topo, SHARD_T, placement)
    return topo, net, placement, (arr * (unit > 0)).astype(np.float32), trace


def sharded_cases(pt, device):
    """(name, spec) of N2's dyadic cases, those of the CPU world of
    tests/test_torch_sharded.py: cohort-fused potus, shuffle and jsq with and
    without the restart (metric streams on), chunks 7 and 15, ``use_pallas``,
    ``engine="sharded"`` with and without the restart, and its potus-loop."""
    topo, net, placement, arr, trace = sharded_system(pt)
    base = dict(topo=topo, net=net, placement=placement, arrivals=arr, T=SHARD_T, V=2.0,
                device=device)
    fused = dict(base, warmup=5, age_cap=32, sharded=True)
    cases = [(f"{s} {tag}", pt.EngineSpec(**fused, scheduler=s, events=ev, metrics=True))
             for s in ("potus", "shuffle", "jsq") for tag, ev in (("", None), ("restart", trace))]
    cases += [(f"chunk {c}", pt.EngineSpec(**fused, chunk=c)) for c in (7, 15)]
    cases += [("use_pallas", pt.EngineSpec(**fused, use_pallas=True))]
    cases += [(f"engine sharded {tag}", pt.EngineSpec(**base, engine="sharded", events=ev,
                                                      metrics=True))
              for tag, ev in (("", None), ("restart", trace))]
    cases += [("engine sharded loop", pt.EngineSpec(**base, engine="sharded",
                                                    scheduler="potus-loop"))]
    return cases


def dense_twin(spec):
    """The dense run a sharded case is held to: ``cohort-fused`` without
    ``sharded``, ``engine="jax"`` for ``engine="sharded"``."""
    if spec.engine == "sharded":
        return dataclasses.replace(spec, engine="jax")
    return dataclasses.replace(spec, sharded=False)


def n2_rank(cases, fleet_spec):
    """One rank of N2: every dyadic case, then the fleet run timed, with the
    launches, the sharded routes and the collectives' payload and seconds of
    that run (this rank's counters)."""
    import torch

    import repro_torch.core as pt
    from repro_torch.core import sharded as psh
    from repro_torch.distributed import PAYLOAD

    entered = time.time()
    out = {name: pt.simulate(spec) for name, spec in cases}
    cases_s = time.time() - entered
    reset_counts()
    psh.ROUTES.clear()
    PAYLOAD.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["fleet"] = pt.simulate(fleet_spec)
    torch.cuda.synchronize()
    out["stats"] = dict(wall_s=time.perf_counter() - t0, launches=read_counts(),
                        routes=psh.route_counts(), elements=PAYLOAD.n(),
                        collective_s=PAYLOAD.seconds, calls=PAYLOAD.calls, entered=entered,
                        cases_s=cases_s)
    return out


def sharded_path(card, cuda, fleet=None, also=(), also_timeout_s=None):
    """Phase N, the instance-sharded engines (``core/sharded.py``): N1 one
    NCCL rank in this process, ``sharded=True`` with ``use_pallas`` on the
    I=16384 fleet (T=128): the slot kernel's route, bitwise path 1, kernel 1
    once a slot, wall ms per slot beside path 1's in turns; N2 four gloo
    ranks sharing the card (``spawn_world``): the dyadic cases bitwise the
    dense port on the card, every rank the same, the fleet at T=16 within
    rtol 1e-4 a slot of the dense port, the compact route (kernel 1 launched
    0 times), the counted payload per slot against
    ``cohort_slot_payload_floats``, wall ms per slot and the collectives'
    share. Callable alone after ``card_setup`` and ``build_kernels``
    (kernel 1); builds the fleet itself when not given. ``also``: more
    ``(fn, args, kwargs)`` calls for N2's ranks to run after theirs, in the
    same world (one start-up), within ``also_timeout_s`` more seconds
    (phase O's ``EP_TIMEOUT_S`` unless given).
    Returns ``{"1": N1's kernel 1 launches, "4": N2's}`` and each rank's
    results of ``also``."""
    import torch
    import torch.distributed as dist

    import repro_torch.core as pt
    from repro_torch.core import sharded as psh
    from repro_torch.distributed import call_each, spawn_world

    t_phase = time.perf_counter()
    topo, net, placement, arr = fleet if fleet is not None else fleet_system(pt, FLEET_I,
                                                                            FLEET_T)
    base = dict(topo=topo, net=net, placement=placement, scheduler="potus", V=FLEET_V,
                window=FLEET_W, age_cap=FLEET_AGE_CAP, device="cuda")

    # -- N1: one NCCL rank, in this process -----------------------------------------
    dense_spec = pt.EngineSpec(**base, arrivals=arr, T=FLEET_T)
    shard_spec = dataclasses.replace(dense_spec, sharded=True, use_pallas=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            dense = pt.simulate(dense_spec)
            reset_counts()
            psh.ROUTES.clear()
            shard = pt.simulate(shard_spec)
            torch.cuda.synchronize()
            n1, routes = read_counts(), psh.route_counts()
            walls = {"dense": [], "sharded": []}
            for which in ("dense", "sharded", "sharded", "dense"):
                spec = dense_spec if which == "dense" else shard_spec
                walls[which].append(timed_runs(lambda: pt.simulate(spec), FLEET_T, 1)[0])
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    same = same_result(shard, dense)
    print(f"N1 one {backend} rank: cohort-fused potus sharded=True use_pallas I={FLEET_I} "
          f"T={FLEET_T}: route {routes}, launches " + " ".join(f"{k}={v}" for k, v in n1.items())
          + f"; bitwise path 1's dense run: {same}")
    print(f"  wall ms/slot in turns (dense, sharded, sharded, dense): sharded "
          f"{walls['sharded'][0]:.4f}, {walls['sharded'][1]:.4f}; path 1 "
          f"{walls['dense'][0]:.4f}, {walls['dense'][1]:.4f} [{card}]")
    check(routes == {"kernel": 1} and n1 == dict(ZERO_COUNTS, potus_slot=FLEET_T),
          f"N1: route {routes}, launches {n1}")
    check(same, "N1: the one-rank sharded run differs from path 1's dense run")

    # -- N2: four gloo ranks sharing the card ------------------------------------------
    cases = sharded_cases(pt, "cuda")
    want = {name: pt.simulate(dense_twin(spec)) for name, spec in cases}
    fleet_spec = dataclasses.replace(shard_spec, use_pallas=False, T=SHARD_FLEET_T,
                                     arrivals=arr[:SHARD_FLEET_T + FLEET_W + 1])
    fleet_dense = pt.simulate(dense_twin(fleet_spec))
    torch.cuda.synchronize()
    t0, started = time.perf_counter(), time.time()
    timeout = SHARD_TIMEOUT_S + (0 if not also else EP_TIMEOUT_S if also_timeout_s is None
                                 else also_timeout_s)
    world = spawn_world(call_each, SHARD_RANKS, "gloo", timeout,
                        ([(n2_rank, (cases, fleet_spec), {}), *also],))
    world_s = time.perf_counter() - t0
    outs = [out[0] for out in world]
    for name, _ in cases:
        for r, out in enumerate(outs):
            got, ok = out[name], True
            if hasattr(got, "final_state"):
                ok = all(np.array_equal(getattr(got, f), getattr(want[name], f))
                         for f in ("backlog", "comm_cost", "q_in_total", "q_out_total",
                                   "served_total"))
            else:
                ok = same_result(got, want[name])
            if got.metrics is not None:  # every stream but the payload (0 on one card)
                ok = ok and all(np.array_equal(got.metrics.streams[k], v) or k == "payload"
                                for k, v in want[name].metrics.streams.items())
            check(ok, f"N2 {name}: rank {r} differs from the dense port on the card")
    print(f"N2 {SHARD_RANKS} gloo ranks on the card, the I=16 dyadic system T={SHARD_T}: "
          f"{len(cases)} cases ({', '.join(n for n, _ in cases)}), each rank bitwise the dense "
          f"port on the card: True")
    topo16, net16 = sharded_system(pt)[:2]
    payload = psh.cohort_slot_payload_floats(topo16.n_instances, topo16.n_components,
                                             net16.U.shape[0], 32 + 1, SHARD_RANKS)
    got = {name: float(outs[0][name].metrics.streams["payload"][0, 0])
           for name in ("potus restart", "potus ", "engine sharded ")}
    print(f"  counted payload per slot: potus with the restart {got['potus restart']} (formula "
          f"{payload}), without {got['potus ']} (the formula less the C={topo16.n_components} "
          f"alive counts), engine=sharded {got['engine sharded ']} (2I+5 = "
          f"{2 * topo16.n_instances + 5})")
    check(got == {"potus restart": payload, "potus ": payload - topo16.n_components,
                  "engine sharded ": 2 * topo16.n_instances + 5}, f"N2 payload {got}")

    stats = [out["stats"] for out in outs]
    fl = [out["fleet"] for out in outs]
    check(all(same_result(f, fl[0]) for f in fl[1:]), "N2 fleet: the ranks' results differ")
    r_slot = max(rel_diff(fl[0].backlog, fleet_dense.backlog),
                 rel_diff(fl[0].comm_cost, fleet_dense.comm_cost))
    C, K, atot = topo.n_components, net.U.shape[0], FLEET_AGE_CAP + FLEET_W + 1
    formula = psh.cohort_slot_payload_floats(topo.n_instances, C, K, atot, SHARD_RANKS)
    per_slot = [s["elements"] / SHARD_FLEET_T for s in stats]
    wall_ms = [s["wall_s"] * 1e3 / SHARD_FLEET_T for s in stats]
    share = [s["collective_s"] / s["wall_s"] for s in stats]
    print(f"N2 fleet I={FLEET_I} potus T={SHARD_FLEET_T} on {SHARD_RANKS} gloo ranks: per-slot "
          f"backlog/cost rel diff to the dense port {r_slot:.3e} (limit 1e-4); routes "
          f"{stats[0]['routes']}, launches " + " ".join(
              f"{k}={v}" for k, v in stats[0]["launches"].items())
          + f"; payload per slot {per_slot[0]:.0f} elements (formula {formula}, less C={C}: "
          f"{formula - C}), {stats[0]['calls'] / SHARD_FLEET_T:.0f} collectives a slot")
    print(f"  wall ms/slot per rank: " + ", ".join(f"{w:.3f}" for w in wall_ms)
          + "; share in collectives: " + ", ".join(f"{x:.3f}" for x in share)
          + f"; the world {world_s:.1f} s"
          + (" (with phases O's, P's, Q's, R's, S's and T's calls)" if also else "")
          + ": the ranks up after "
          + ", ".join(f"{s['entered'] - started:.1f}" for s in stats) + " s, the dyadic cases "
          + ", ".join(f"{s['cases_s']:.1f}" for s in stats) + f" s [{card}]")
    check(r_slot <= 1e-4, f"N2 fleet: per-slot rel diff {r_slot} beyond 1e-4")
    check(all(s["routes"] == {"compact": 1} for s in stats)
          and all(s["launches"] == ZERO_COUNTS for s in stats),
          f"N2 fleet: routes/launches {[(s['routes'], s['launches']) for s in stats]}")
    check(all(p == formula - C for p in per_slot), f"N2 fleet: payload per slot {per_slot}")
    print(f"  phase N {time.perf_counter() - t_phase:.1f} s [{card}]")
    return ({"1": n1["potus_slot"], str(SHARD_RANKS): stats[0]["launches"]["potus_slot"]},
            [out[1:] for out in world])


# ---------------------------------------------------------------------------
# phase O: expert-parallel MoE serving across ranks (models/moe_ep.py, launch/mesh.py)
# ---------------------------------------------------------------------------

# O2's four gloo ranks on the card: N=512 tokens, POTUS with its state carried over
# EP_CALLS calls, then EP_TIMED calls timed; O3 serves granite-moe-1b at EP_LAYERS of its 24
# layers to EP_REQUESTS requests of EP_MAX_NEW tokens, prompts of lengths that split over 4
EP_RANKS, EP_TIMEOUT_S, EP_CALLS, EP_TIMED = 4, 300, 2, 4
EP_MESHES = ((4, 1), (2, 2))
EP_CAPACITY = (1.25, 4.0)
EP_LAYERS, EP_REQUESTS, EP_MAX_NEW = 2, 8, 8
EP_PROMPT_LENS = (32, 64, 128)
EP_RATES = (4.0, 2.0, 2.0, 2.0)
# O3's teacher-forced logits: a (4, 16) batch's forward and prefill, then 4 decode steps
EP_TF_SHAPE, EP_TF_STEPS = (4, 16), 4


def ep_examples():
    """``examples/torch_moe_ep.py`` (``serve_rank``, ``model_rank``,
    ``layer_rank``), imported from the checkout."""
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    import torch_moe_ep

    return torch_moe_ep


def ep_one_rank(card, cuda):
    """O1: one NCCL rank in this process, ``moe_ffn_ep`` on a 1x1 mesh
    against ``moe_ffn`` on the card at granite-moe-1b's widths. On one rank
    the send side keeps every entry (its capacity is N*k*cf >= N*k) and the
    receive side takes the entries in token-major order, so the selections,
    the kept entries, load and router state are ``moe_ffn``'s exactly; the
    reference's ``dropped_frac`` counts the send side's drops (0 here), and
    the share of entries the receive side drops is ``moe_ffn``'s
    ``dropped_frac``. y within 1e-6 of max |y| in f32 (2e-2 in bf16)."""
    import copy

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import _mean, init_router_state, moe_ffn
    from repro_torch.models.moe_ep import moe_ffn_ep

    t0 = time.perf_counter()
    base = get_config(MOE_ARCH).with_(param_dtype="float32", compute_dtype="float32")
    layer = moe_layer(base, 0, "cpu")[0]
    print(f"  O1 layer drawn in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        print(f"  O1 process group up in {time.perf_counter() - t0:.1f} s")
        try:
            mesh = make_host_mesh(1, 1)
            backend = dist.get_backend()
            for dtype in ("float32", "bfloat16"):
                # the same draw in either type, as model_zoo.fill_ casts its f32 draws
                moe = copy.deepcopy(layer).to(device=cuda, dtype=getattr(torch, dtype))
                for n_tokens in MOE_TOKENS:
                    for router, calls in (("topk", 1), ("potus", MOE_CALLS)):
                        cfg = base.with_(param_dtype=dtype, compute_dtype=dtype, router=router)
                        xs = moe_inputs(cfg, n_tokens, calls, cuda)
                        rs = rs_ep = init_router_state(cfg, cuda) if router == "potus" else None
                        worst, bitwise, drops = 0.0, True, []
                        for step, x in enumerate(xs):
                            y, a = moe_ffn(moe, x, cfg, rs)
                            y_ep, a_ep = moe_ffn_ep(moe, x, cfg, mesh, rs_ep)
                            nk = a["keep"].numel()
                            recv = a_ep["keep_recv"]
                            same = (torch.equal(a_ep["top_i"], a["top_i"])
                                    and bool(a_ep["keep"].all())
                                    and torch.equal(recv[:nk], a["keep"])
                                    and not bool(recv[nk:].any())
                                    and torch.equal(a_ep["load"], a["load"])
                                    and float(a_ep["dropped_frac"]) == 0.0
                                    and float(1.0 - _mean(recv[:nk].float()))
                                    == float(a["dropped_frac"]))
                            if rs is not None:
                                same = same and torch.equal(a_ep["router_state"],
                                                            a["router_state"])
                                rs, rs_ep = a["router_state"], a_ep["router_state"]
                            check(same, f"O1 {dtype} {router} N={n_tokens} call {step}: "
                                        "selections, keep, load or state differ from moe_ffn")
                            worst = max(worst, logit_gap(y_ep, y)[0])
                            bitwise = bitwise and torch.equal(y_ep, y)
                            drops.append(float(a["dropped_frac"]))
                        limit = 1e-6 if dtype == "float32" else 2e-2
                        print(f"O1 moe_ffn_ep 1x1 mesh ({backend}) {router} N={n_tokens} {dtype} "
                              f"({calls} call(s)): = moe_ffn in selections, kept entries, "
                              f"loads, router states; receive-side drop share = moe_ffn's "
                              f"dropped_frac {drops}, send-side dropped_frac 0; y max gap "
                              f"{worst:.3e} of max |y| (limit {limit:g}), bitwise {bitwise} "
                              f"[{card}]")
                        check(worst <= limit, f"O1 {dtype} {router} N={n_tokens}: y gap {worst}")
                    if dtype == "float32":
                        t0 = time.perf_counter()
                        c = cfg.with_(router="potus")
                        ms, items, _ = device_items(lambda: moe_ffn_ep(moe, x, c, mesh, rs_ep), 20)
                        ms_ffn, items_ffn, _ = device_items(lambda: moe_ffn(moe, x, c, rs), 20)
                        print(f"  device ms per call N={n_tokens} f32: moe_ffn_ep {ms:.4f} "
                              f"({items:.1f} device items), moe_ffn {ms_ffn:.4f} "
                              f"({items_ffn:.1f}); profiled in {time.perf_counter() - t0:.1f} s "
                              f"[{card}]")
        finally:
            dist.destroy_process_group()


def o2_rank(cases, device):
    """One rank of O2: for each (name, cfg, mesh shape) the layer drawn from
    seed 0 on the card (every rank draws the same), ``moe_ffn_ep`` on
    ``EP_CALLS`` inputs with POTUS's state carried, on the card and on this
    rank's CPU, then ``EP_TIMED`` calls on the card timed."""
    import torch

    from repro_torch.models.moe import init_router_state

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model_zoo as pz
    from repro_torch.models.moe import MoE

    ex = ep_examples()
    t0 = time.perf_counter()
    with torch.device("meta"):
        layer = MoE(cases[0][1])
    layer = pz.fill_(layer.to_empty(device=device), torch.Generator(device=device).manual_seed(0))
    state = {k: v.cpu() for k, v in layer.state_dict().items()}
    del layer
    meshes = {shape: make_host_mesh(*shape) for shape in dict.fromkeys(c[2] for c in cases)}
    out = {"setup_s": time.perf_counter() - t0}
    for name, cfg, shape in cases:
        xs = moe_inputs(cfg, 512, EP_CALLS, "cpu")
        rs = init_router_state(cfg)
        card = ex.layer_rank(cfg, meshes[shape], state, xs, rs, device=device)
        threads = torch.get_num_threads()
        torch.set_num_threads(2)  # the four ranks' CPU runs share 8 cores
        try:
            cpu = ex.layer_rank(cfg, meshes[shape], state, xs, rs, device="cpu")
        finally:
            torch.set_num_threads(threads)
        timed = ex.layer_rank(cfg, meshes[shape], state, xs[-1:] * EP_TIMED, rs, device=device)
        out[name] = dict(card=card, cpu=cpu, timed=[(c["wall_s"], c["collective_s"],
                                                     c["elements"]) for c in timed])
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def ep_layer_cases():
    """O2's cases: (name, cfg, mesh shape), granite-moe-1b's MoE layer in f32
    with POTUS, meshes 4x1 and 2x2, capacity factors 1.25 and 4.0."""
    from repro_torch.configs import get_config

    base = get_config(MOE_ARCH).with_(param_dtype="float32", compute_dtype="float32",
                                      router="potus")
    return [(f"{m[0]}x{m[1]} cf {cf}", base.with_(capacity_factor=cf), m)
            for m in EP_MESHES for cf in EP_CAPACITY]


def ep_layers(card, cases, outs):
    """O2's checks on each rank's results (``o2_rank``): ``moe_ffn_ep`` at
    granite-moe-1b's widths, N=512, f32, POTUS with its state carried, on
    four gloo ranks sharing the card. Each rank's card result against its
    own CPU run: loads, drops and router states exactly, y within 1e-5 of
    max |y|; every rank's y the same; the ``"ep"`` payload per call, the
    wall ms per call and its share in collectives."""
    for name, cfg, _ in cases:
        worst = 0.0
        for r, out in enumerate(outs):
            for step, (g, w) in enumerate(zip(out[name]["card"], out[name]["cpu"])):
                exact = all(np.array_equal(g[k].numpy(), w[k].numpy())
                            for k in ("load", "dropped_frac", "router_state"))
                check(exact, f"O2 {name} rank {r} call {step}: load, drop or state differs "
                             "from the CPU")
                worst = max(worst, float((g["y"] - w["y"]).abs().max() / w["y"].abs().max()))
                check(np.array_equal(g["y"].numpy(), outs[0][name]["card"][step]["y"].numpy()),
                      f"O2 {name} rank {r} call {step}: y differs from rank 0's")
        check(worst <= 1e-5, f"O2 {name}: card vs CPU y gap {worst}")
        first = outs[0][name]["card"]
        walls = [np.median([t[0] for t in out[name]["timed"][1:]]) * 1e3 for out in outs]
        shares = [np.median([t[1] / t[0] for t in out[name]["timed"][1:]]) for out in outs]
        elements = outs[0][name]["timed"][0][2]
        print(f"O2 {name} on {EP_RANKS} gloo ranks, N=512 f32 potus ({EP_CALLS} calls): each "
              f"rank's card = its CPU run in loads, dropped_frac ({float(first[0]['dropped_frac']):.6f}, "
              f"{float(first[-1]['dropped_frac']):.6f}) and router states; y max gap {worst:.3e} "
              f"of max |y| (limit 1e-5); every rank's y identical; \"ep\" payload "
              f"{elements} elements per call; wall ms per call per rank "
              + ", ".join(f"{w:.3f}" for w in walls) + "; share in collectives "
              + ", ".join(f"{x:.3f}" for x in shares) + f" [{card}]")


def ep_prompts(cfg):
    """O3's prompts: numpy seed 0, lengths from ``EP_PROMPT_LENS``."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, int(rng.choice(EP_PROMPT_LENS)))
            for _ in range(EP_REQUESTS)]


def ep_teacher_inputs(cfg):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, EP_TF_SHAPE)
    fed = list(rng.integers(0, cfg.vocab_size, (EP_TF_STEPS, EP_TF_SHAPE[0], 1)))
    return toks, fed


def o3_rank(cfgs, mesh_shape, device):
    """One rank of O3: for each (tag, cfg) the served run of ``serve_rank``
    on the card with its launches counted, then the f32 model's
    teacher-forced logits (``model_rank``)."""
    ex = ep_examples()
    t0 = time.perf_counter()
    out = {}
    for tag, cfg in cfgs:
        reset_counts()
        run = ex.serve_rank(cfg, mesh_shape, ep_prompts(cfg), EP_MAX_NEW, rates=EP_RATES,
                            device=device)
        run["launches"] = read_counts()
        out[tag] = run
    cfg = dict(cfgs)["f32"]
    toks, fed = ep_teacher_inputs(cfg)
    out["teacher"] = ex.model_rank(cfg, mesh_shape, None, toks, EP_TF_SHAPE[1] + EP_TF_STEPS + 1,
                                   fed, device=device)
    out["wall_s"] = time.perf_counter() - t0
    return out


def ep_served_cfgs():
    """O3's (tag, cfg): granite-moe-1b at ``EP_LAYERS`` layers with
    ``moe_ep_shardmap``, f32 at capacity factor 4.0 and bf16 as published."""
    from repro_torch.configs import get_config

    base = get_config(MOE_ARCH).with_(n_layers=EP_LAYERS, moe_ep_shardmap=True)
    return [("f32", base.with_(param_dtype="float32", compute_dtype="float32",
                               capacity_factor=4.0)), ("bf16", base)]


def ep_served(card, cuda, cfgs, outs):
    """O3's checks on each rank's results (``o3_rank``): granite-moe-1b at
    full width, ``EP_LAYERS`` of its 24 layers, ``moe_ep_shardmap``, served
    on the 4x1 mesh of four gloo ranks (each holding 8 of the 32 experts):
    in f32 at capacity factor 4.0, where neither stage drops (cap_loc = N,
    cap_send = N_loc*k), the tokens equal a one-rank run without a mesh and
    the teacher-forced logits are within 1e-4 of its; in bf16 at granite's
    1.25 the tokens are recorded. Every rank's tokens identical; kernel 5
    once per prefill and layer, kernel 6 once per decode round and layer,
    kernel 2 once per slot, on every rank. Returns rank 0's launches of the
    bf16 run."""
    ex = ep_examples()
    cfg32 = dict(cfgs)["f32"]
    one = ex.serve_rank(cfg32, None, ep_prompts(cfg32), EP_MAX_NEW, rates=EP_RATES, device=cuda)
    toks, fed = ep_teacher_inputs(cfg32)
    one_tf = ex.model_rank(cfg32, None, None, toks, EP_TF_SHAPE[1] + EP_TF_STEPS + 1, fed,
                           device=cuda)
    for tag, cfg in cfgs:
        runs = [out[tag] for out in outs]
        same = all(r["tokens"] == runs[0]["tokens"] for r in runs[1:])
        check(same, f"O3 {tag}: the ranks' tokens differ")
        for r, run in enumerate(runs):
            want = dict(ZERO_COUNTS, flash_attention=EP_LAYERS * EP_REQUESTS,
                        decode_attention=EP_LAYERS * run["rounds"], potus_schedule=run["slots"])
            check(run["launches"] == want, f"O3 {tag} rank {r}: launches {run['launches']}, "
                                           f"expected {want}")
            check(all(len(t) == EP_MAX_NEW for t in run["tokens"].values()),
                  f"O3 {tag} rank {r}: a request did not get {EP_MAX_NEW} tokens")
        r0 = runs[0]
        line = (f"O3 {cfg.name} {EP_LAYERS} of 24 layers {tag} capacity factor "
                f"{cfg.capacity_factor}, 4x1 mesh of {EP_RANKS} gloo ranks (8 experts each): "
                f"{EP_REQUESTS} requests, {r0['slots']} slots, {r0['rounds']} decode rounds; every "
                f"rank's tokens identical: {same}")
        if tag == "f32":
            equal = r0["tokens"] == one["tokens"]
            line += f"; = the one-rank run without a mesh: {equal}"
            check(equal, "O3 f32: the tokens differ from the one-rank run without a mesh")
        else:
            line += f" (recorded: request 0 {r0['tokens'][0]})"
        print(line + f" [{card}]")
        print(f"  decode round median ms per rank "
              + ", ".join(f"{np.median(r['round_ms']):.3f}" for r in runs)
              + "; wall s " + ", ".join(f"{r['wall_s']:.3f}" for r in runs)
              + "; share in collectives " + ", ".join(f"{r['collective_s'] / r['wall_s']:.3f}"
                                                      for r in runs)
              + f"; \"ep\" payload {r0['elements']} elements; launches "
              + " ".join(f"{k}={v}" for k, v in r0["launches"].items() if v) + f" [{card}]")
    print(f"  one-rank run without a mesh, f32: decode round median "
          f"{np.median(one['round_ms']):.3f} ms, {one['rounds']} rounds [{card}]")
    worst = 0.0
    for r, out in enumerate(outs):
        got = out["teacher"]
        check(got["elements"] > 0, f"O3 rank {r}: the teacher-forced run moved no ep payload")
        for key in ("forward", "prefill", "decode"):
            worst = max(worst, float(np.abs(got[key] - one_tf[key]).max()
                                     / np.abs(one_tf[key]).max()))
    print(f"O3 teacher-forced f32, forward and prefill of {EP_TF_SHAPE} and {EP_TF_STEPS} decode "
          f"steps, 4 ranks vs one rank without a mesh: max |dlogit| {worst:.3e} of max |logit| "
          f"(limit 1e-4) [{card}]")
    check(worst <= 1e-4, f"O3 teacher-forced gap {worst}")
    return outs[0]["bf16"]["launches"]


def ep_world_calls(cuda):
    """O2's and O3's calls for each rank of a world of ``EP_RANKS`` gloo
    ranks sharing the card (``spawn_world(call_each, ...)``)."""
    return [(o2_rank, (ep_layer_cases(), str(cuda)), {}),
            (o3_rank, (ep_served_cfgs(), (EP_RANKS, 1), str(cuda)), {})]


def moe_ep_path(card, cuda, world=None):
    """Phase O, expert-parallel MoE serving (``models/moe_ep.py``): O1 one
    NCCL rank, O2 four gloo ranks on ``moe_ffn_ep`` alone, O3 granite-moe-1b
    served on four gloo ranks. ``world``: each rank's results of
    :func:`ep_world_calls` where another phase's world ran them (phase N's,
    in a whole run), else O2 and O3 start a world of their own. Callable
    alone after ``card_setup`` and ``build_kernels`` (kernels 2, 5 and 6);
    the children re-import ``chip_smoke``. Returns rank 0's launches of
    O3's bf16 served run."""
    from repro_torch.distributed import call_each, spawn_world

    t_phase = time.perf_counter()
    ep_one_rank(card, cuda)
    print(f"  O1 {time.perf_counter() - t_phase:.1f} s [{card}]")
    where = "phase N's world"
    if world is None:
        t0 = time.perf_counter()
        world = spawn_world(call_each, EP_RANKS, "gloo", EP_TIMEOUT_S, (ep_world_calls(cuda),))
        where = f"a world of their own, {time.perf_counter() - t0:.1f} s"
    print(f"  O2 and O3 on {EP_RANKS} gloo ranks in {where}; on rank 0 O2 "
          f"{world[0][0]['wall_s']:.1f} s (the layer drawn and the meshes built in "
          f"{world[0][0]['setup_s']:.1f}), O3 {world[0][1]['wall_s']:.1f} s [{card}]")
    ep_layers(card, ep_layer_cases(), [out[0] for out in world])
    launches = ep_served(card, cuda, ep_served_cfgs(), [out[1] for out in world])
    print(f"  phase O {time.perf_counter() - t_phase:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase P: data-parallel training across ranks (training.make_train_step under a model mesh,
# distributed/sharding.py, the elastic checkpoint, distributed/pipeline.py)
# ---------------------------------------------------------------------------

# internvl2-1b at full width cut to DP_LAYERS of its 24 layers: P1 one NCCL rank in bf16
# (TRAIN_B x TRAIN_S, phase M's batch), DP_STEPS steps; P2 four gloo ranks sharing the card on
# a 4x1 mesh in f32, P2_STEPS steps on a global batch of DP_B x TRAIN_S, ZeRO-1 moments and
# grad_specs (cut from two steps to one to make room for phase Q: a gloo step here is ~7-8 s,
# 96% of it the gradients' reductions through the host); P3 pipeline_apply over the four
# ranks, one full-width block a stage, PIPE_MICRO microbatches of one PIPE_S-token row
DP_ARCH, DP_LAYERS, DP_RANKS, DP_TIMEOUT_S = "internvl2_1b", 2, 4, 300
DP_STEPS, P2_STEPS, DP_B, DP_TURNS = 2, 1, 8, ("meshless", "mesh", "mesh", "meshless")
PIPE_MICRO, PIPE_S = 4, 512


def dp_cfg(dtype):
    from repro_torch.configs import get_config

    return get_config(DP_ARCH).with_(n_layers=DP_LAYERS, param_dtype=dtype, compute_dtype=dtype)


def dp_tcfg():
    """AdamW as phase M's, ZeRO-1 on (``OptConfig``'s default)."""
    from repro_torch.training import train_loop as ptl
    from repro_torch.training.optimizer import OptConfig

    return ptl.TrainConfig(opt=OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=100))


def dp_batch(cfg, B, device, S=None):
    """``TokenPipeline(cfg, B, S (TRAIN_S), seed 0)``'s first batch on ``device``."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.data.specs import as_tensors

    return as_tensors(TokenPipeline(cfg, batch=B, seq=S or TRAIN_S, seed=0).next_batch(), cfg,
                      device)


def dp_stepper(cfg, tcfg, mesh, device):
    """(state, step): the state drawn from seed 0 on ``device`` (every rank
    draws the same), under ``mesh`` (None: none) cut to this rank's ZeRO-1
    blocks (``state_shardings``; an MoE config's experts placed first under
    the expert-parallel route), and ``make_train_step`` with ``grad_specs``
    from the ZeRO rules."""
    import torch

    from repro_torch.distributed import set_mesh
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model_zoo as pz
    from repro_torch.models.moe_ep import place_
    from repro_torch.training import train_loop as ptl

    state = ptl.init_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0),
                                 device)
    specs = None
    if mesh is not None:
        if cfg.moe and cfg.moe_ep_shardmap:
            place_(state["params"], mesh)
        ptl.shard_train_state(state, ptl.state_shardings(cfg, mesh, tcfg))
        specs = shd.specs_for_template(pz.template(cfg), shd.zero_rules(mesh), mesh)
    set_mesh(mesh)
    try:
        return state, ptl.make_train_step(cfg, tcfg, specs)
    finally:
        set_mesh(None)


def timed_step(step, state, batch):
    """One step, synchronised: (state, metrics as floats, wall s, the "dp"
    elements, the elements by tag, collective s and calls, the launches)."""
    import torch

    from repro_torch.distributed import PAYLOAD

    reset_counts()
    PAYLOAD.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, dict(metrics={k: float(v) for k, v in met.items()}, wall_s=wall,
                       elements=PAYLOAD.n("dp"), tags=dict(PAYLOAD.elements),
                       collective_s=PAYLOAD.seconds, tag_seconds=dict(PAYLOAD.tag_seconds),
                       calls=PAYLOAD.calls, launches=read_counts())


def leaf_prints(state, shardings=None):
    """Two exact fingerprints of each leaf's bits (``checkpoint.flatten_state``
    keys), of this rank's block where ``shardings`` cuts it, computed on the
    leaf's device: the wrapping int64 sums of its bit patterns, plain and
    weighted by an odd multiplier per position. Equal leaves give equal
    prints; any one differing element changes the plain sum."""
    import torch

    from repro_torch.training import checkpoint as ck

    sh = {} if shardings is None else ck.flatten_state(shardings)
    bits_of = {4: torch.int32, 2: torch.int16, 1: torch.int8, 8: torch.int64}
    out = {}
    for key, leaf in ck.flatten_state(state).items():
        t = sh[key].local(leaf) if key in sh else leaf
        t = t.detach().contiguous().reshape(-1)
        bits = t.view(bits_of[t.element_size()]).to(torch.int64)
        w = torch.arange(bits.numel(), dtype=torch.int64, device=bits.device) * 2654435761 + 1
        out[key] = (int(bits.sum()), int((bits * w).sum()))
    return out


def dp_one_rank(card, cuda):
    """P1: one NCCL rank in this process, ``DP_ARCH`` at full width and
    ``DP_LAYERS`` layers in bf16 on phase M's batch: ``DP_STEPS`` steps on a
    1x1 mesh with ZeRO-1 moments and ``grad_specs`` against the same steps
    without a mesh (phase M's step): bitwise, kernels 5 and 5b once per
    layer a step; then one step of each timed in turns."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ck

    cfg, tcfg = dp_cfg("bfloat16"), dp_tcfg()
    batch = dp_batch(cfg, TRAIN_B, cuda)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            runs = {}
            for name, mesh in (("meshless", None), ("mesh", make_host_mesh(1, 1))):
                state, step = dp_stepper(cfg, tcfg, mesh, cuda)
                stats = []
                for _ in range(DP_STEPS):
                    state, st = timed_step(step, state, batch)
                    stats.append(st)
                runs[name] = [state, step, stats]
            a, b = (ck.flatten_state(runs[n][0]) for n in ("meshless", "mesh"))
            same = list(a) == list(b) and all(torch.equal(a[k].detach(), b[k].detach())
                                              for k in a)
            same = same and all(x["metrics"] == y["metrics"]
                                for x, y in zip(runs["meshless"][2], runs["mesh"][2]))
            turns = {"meshless": [], "mesh": []}
            for name in DP_TURNS:
                runs[name][0], st = timed_step(runs[name][1], runs[name][0], batch)
                turns[name].append(st)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    want = dict(ZERO_COUNTS, flash_attention=DP_LAYERS, flash_attention_bwd=DP_LAYERS)
    for name, (_, _, stats) in runs.items():
        for i, st in enumerate(stats):
            check(st["launches"] == want, f"P1 {name} step {i}: launches {st['launches']}")
            check(np.isfinite(st["metrics"]["loss"]), f"P1 {name} step {i}: loss not finite")
    print(f"P1 one {backend} rank, {cfg.name} d_model {cfg.d_model}, {DP_LAYERS} of 24 layers, "
          f"bf16, batch {TRAIN_B} x {TRAIN_S}: {DP_STEPS} steps on a 1x1 mesh (ZeRO-1 moments, "
          f"grad_specs) = the steps without a mesh bitwise: {same}; losses "
          + ", ".join(f"{st['metrics']['loss']:.6f}" for st in runs["mesh"][2])
          + f"; launches a step flash_attention={DP_LAYERS} flash_attention_bwd={DP_LAYERS}")
    check(same, "P1: the 1x1-mesh steps differ from the meshless steps")
    for name, sts in turns.items():
        print(f"  P1 {name} step wall ms in turns ({', '.join(DP_TURNS)}): "
              + ", ".join(f"{st['wall_s'] * 1e3:.2f}" for st in sts)
              + f"; share in collectives {sum(s['collective_s'] for s in sts) / sum(s['wall_s'] for s in sts):.4f}"
              + f"; \"dp\" elements a step {sts[0]['elements']} [{card}]")
    del runs
    torch.cuda.empty_cache()


def dp_reference(card, cuda, tmp):
    """P2's reference: the one-rank f32 steps without a mesh on the card from
    the seed and batch P2's ranks use; writes the parameters and the first
    moments after the first step to ``tmp/reference.pt`` for the ranks.
    Returns each step's stats."""
    import torch

    cfg, tcfg = dp_cfg("float32"), dp_tcfg()
    state, step = dp_stepper(cfg, tcfg, None, cuda)
    batch = dp_batch(cfg, DP_B, cuda)
    stats = []
    for i in range(P2_STEPS):
        state, st = timed_step(step, state, batch)
        stats.append(st)
        if i == 0:
            torch.save({"params": {n: p.detach().cpu() for n, p in
                                   state["params"].named_parameters()},
                        "m": {n: t.cpu() for n, t in state["opt"]["m"].items()},
                        "lr": st["metrics"]["lr"]}, Path(tmp) / "reference.pt")
    print(f"P2 reference: one rank, {cfg.name} {DP_LAYERS} layers f32, global batch {DP_B} x "
          f"{TRAIN_S}: step wall ms " + ", ".join(f"{s['wall_s'] * 1e3:.2f}" for s in stats)
          + "; losses " + ", ".join(f"{s['metrics']['loss']:.6f}" for s in stats) + f" [{card}]")
    del state, step, batch
    torch.cuda.empty_cache()
    return stats


def dp_gaps(state, ref_path, shardings, b1, device):
    """P2's gaps after the first step against the one-rank reference: the
    largest excess of a parameter's gap over the ``_param_bound`` rule of
    ``tests/test_torch_training.py`` (the gradient within 1e-4 of its
    leaf's scale; the bound is invariant to the gradient's scale, so the
    reference's first moment stands for it), the largest gap of a
    parameter (block) to the reference's, of the reference parameter's
    scale, and the largest gap of a moment block to the reference's block,
    of the reference moment's scale."""
    import torch

    ref = torch.load(ref_path, mmap=True, weights_only=True)
    lr = ref["lr"]
    excess, m_gap, p_gap = -float("inf"), 0.0, 0.0
    for n, p in state["params"].named_parameters():
        w, m_ref = ref["params"][n].to(device), ref["m"][n].to(device)
        g = m_ref / (1 - b1)
        delta = 1e-4 * g.abs().max()
        bound = lr * torch.clamp(4 * delta / g.abs().clamp_min(1e-30), max=2.0) + 2e-7
        # an expert-parallel rank's experts and a tensor-parallel rank's cut leaves are blocks
        held = shardings["params"][n]
        gap = (p.detach() - held.local(w)).abs()
        excess = max(excess, float((gap - held.local(bound)).max()))
        p_gap = max(p_gap, float(gap.max()) / max(float(w.abs().max()), 1e-30))
        blk = shardings["opt"]["m"][n].local(m_ref)
        m_gap = max(m_gap, float((state["opt"]["m"][n] - blk).abs().max())
                    / max(float(m_ref.abs().max()), 1e-30))
    return dict(param_excess=excess, m_gap=m_gap, param_gap=p_gap)


def p2_rank(tmp, device):
    """One rank of P2: the 4x1 mesh, the state cut to its ZeRO-1 blocks,
    ``P2_STEPS`` steps timed and counted, the gaps after the first against
    the reference, the state saved across the ranks to ``tmp/ckpt`` and the
    fingerprints of this rank's leaves (:func:`leaf_prints`)."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import train_loop as ptl

    t0 = time.perf_counter()
    cfg, tcfg = dp_cfg("float32"), dp_tcfg()
    mesh = make_host_mesh(DP_RANKS, 1)
    shardings = ptl.state_shardings(cfg, mesh, tcfg)
    state, step = dp_stepper(cfg, tcfg, mesh, device)
    batch = dp_batch(cfg, DP_B, device)
    out = dict(setup_s=time.perf_counter() - t0, steps=[])
    for i in range(P2_STEPS):
        state, st = timed_step(step, state, batch)
        out["steps"].append(st)
        if i == 0:
            out["gaps"] = dp_gaps(state, Path(tmp) / "reference.pt", shardings, tcfg.opt.b1,
                                  device)
    t1 = time.perf_counter()
    ck.save_checkpoint(Path(tmp) / "ckpt", P2_STEPS, state, extra=dict(batch_seed=0),
                       shardings=shardings)
    out["save_s"] = time.perf_counter() - t1
    out["prints"] = leaf_prints(state)
    out["wall_s"] = time.perf_counter() - t0
    del state, step
    torch.cuda.empty_cache()
    return out


def pipe_blocks(cfg, device):
    """P3's ``PIPE`` stages: ``DP_RANKS`` blocks of ``cfg`` drawn in turn from
    one generator of seed 0 on ``device``, and their parameters stacked
    (n_stages, ...)."""
    import torch

    from repro_torch.models import model_zoo as pz

    gen = torch.Generator(device=device).manual_seed(0)
    blocks = []
    for _ in range(DP_RANKS):
        with torch.device("meta"):
            b = pz.Block(cfg, dtype=torch.float32)
        blocks.append(pz.fill_(b.to_empty(device=device), gen).requires_grad_(False))
    names = [n for n, _ in blocks[0].named_parameters()]
    return blocks, {n: torch.stack([dict(b.named_parameters())[n] for b in blocks])
                    for n in names}


def pipe_input(cfg, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randn((PIPE_MICRO, 1, PIPE_S, cfg.d_model), generator=gen, device=device)


def pipe_stage(block, p, h):
    """One stage: ``block`` with the parameters ``p`` on ``h`` (1, S, D)."""
    import torch

    positions = torch.arange(h.shape[1], device=h.device)
    return torch.func.functional_call(block, p, (h, positions))[0]


def p3_rank(device):
    """One rank of P3: ``pipeline_apply`` of the four blocks over a "stage"
    axis of the four ranks, timed and counted."""
    import torch

    from repro_torch.distributed import PAYLOAD
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_axis_mesh

    cfg = dp_cfg("float32")
    blocks, params = pipe_blocks(cfg, device)
    x = pipe_input(cfg, device)
    mesh = make_axis_mesh(DP_RANKS, "stage")
    reset_counts()
    PAYLOAD.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = pipeline_apply(partial(pipe_stage, blocks[0]), params, x, mesh, axis="stage")
    torch.cuda.synchronize()
    return dict(out=out.cpu(), wall_s=time.perf_counter() - t0, launches=read_counts(),
                elements=PAYLOAD.n("pp"), collective_s=PAYLOAD.seconds)


def dp_prepare(card, cuda):
    """Phase P's parts in this process before the world of ranks: P1, and
    P2's one-rank reference in a temporary directory. Returns (the
    directory, the reference's stats)."""
    t0 = time.perf_counter()
    dp_one_rank(card, cuda)
    print(f"  P1 {time.perf_counter() - t0:.1f} s [{card}]")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    return tmp, dp_reference(card, cuda, tmp)


def dp_world_calls(cuda, prepared):
    """P2's and P3's calls for each rank of a world of ``DP_RANKS`` gloo
    ranks sharing the card (``spawn_world(call_each, ...)``)."""
    return [(p2_rank, (prepared[0], str(cuda)), {}), (p3_rank, (str(cuda),), {})]


def dp_train_path(card, cuda, prepared=None, world=None):
    """Phase P, data-parallel training (``make_train_step`` under a model
    mesh): P1 (:func:`dp_one_rank`); P2 four gloo ranks sharing the card on
    a 4x1 mesh, f32, ZeRO-1 moments and ``grad_specs``: each step's loss and
    grad norm within rel 1e-5 of the one-rank f32 steps on the card and the
    same on every rank, after the first step the parameters within the
    ``_param_bound`` rule and each rank's moment blocks within 1e-5 of scale
    of the reference's blocks, kernels 5 and 5b once per layer a step on
    every rank, the step walls, their share in collectives and the "dp"
    payload; the state saved across the ranks and restored onto one rank
    here, bitwise every rank's blocks; P3 ``pipeline_apply`` over the four
    ranks, one full-width block a stage (kernel 5 in every stage), against
    the blocks applied in turn on the card within 1e-5 of scale.
    ``prepared``: :func:`dp_prepare`'s result, ``world``: each rank's
    results of :func:`dp_world_calls` where another phase's world ran them
    (phase N's, in a whole run); else they run here. Callable alone after
    ``card_setup`` and ``build_kernels`` (kernels 5 and 5b). Returns rank 0's
    launches of kernels 5 and 5b on P2's steps and kernel 5's in P3."""
    import shutil

    import torch

    from repro_torch.distributed import call_each, spawn_world
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.distributed.context import Axis
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import train_loop as ptl

    t_phase = time.perf_counter()
    if prepared is None:
        prepared = dp_prepare(card, cuda)
    tmp, ref = prepared
    try:
        if world is None:
            t0 = time.perf_counter()
            world = spawn_world(call_each, DP_RANKS, "gloo", DP_TIMEOUT_S,
                                (dp_world_calls(cuda, prepared),))
            print(f"  P2 and P3 in a world of their own, {time.perf_counter() - t0:.1f} s "
                  f"[{card}]")
        p2, p3 = [w[0] for w in world], [w[1] for w in world]
        cfg, tcfg = dp_cfg("float32"), dp_tcfg()
        # -- P2: the steps against the one-rank reference ------------------------------
        want = dict(ZERO_COUNTS, flash_attention=DP_LAYERS, flash_attention_bwd=DP_LAYERS)
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for r, out in enumerate(p2):
            for i, st in enumerate(out["steps"]):
                check(st["launches"] == want, f"P2 rank {r} step {i}: launches {st['launches']}")
                check(st["metrics"] == p2[0]["steps"][i]["metrics"],
                      f"P2 step {i}: rank {r}'s metrics differ from rank 0's")
                for key in worst:
                    worst[key] = max(worst[key], rel_diff(st["metrics"][key],
                                                          ref[i]["metrics"][key]))
        gaps = [out["gaps"] for out in p2]
        excess = max(g["param_excess"] for g in gaps)
        m_gap = max(g["m_gap"] for g in gaps)
        same_params = all(
            all(out["prints"][k] == p2[0]["prints"][k] for k in out["prints"]
                if k.startswith("params/")) for out in p2[1:])
        print(f"P2 {DP_RANKS} gloo ranks on the card, 4x1 mesh, {cfg.name} {DP_LAYERS} of 24 "
              f"layers f32, global batch {DP_B} x {TRAIN_S} ({DP_B // DP_RANKS} rows a rank), "
              f"ZeRO-1 moments, grad_specs, {P2_STEPS} step(s): losses "
              + ", ".join(f"{st['metrics']['loss']:.6f}" for st in p2[0]["steps"])
              + f"; against the one-rank f32 steps: loss rel {worst['loss']:.3e}, grad norm rel "
              f"{worst['grad_norm']:.3e} (limit 1e-5); after step 1 the parameters' largest "
              f"excess over the _param_bound rule {excess:.3e} (held <= 0), the moment blocks "
              f"{m_gap:.3e} of scale (limit 1e-5); every rank's parameters identical: "
              f"{same_params}; launches a step on every rank flash_attention={DP_LAYERS} "
              f"flash_attention_bwd={DP_LAYERS} [{card}]")
        check(max(worst.values()) <= 1e-5, f"P2: loss/grad norm beyond rel 1e-5: {worst}")
        check(excess <= 0.0, f"P2: a parameter beyond the _param_bound rule by {excess}")
        check(m_gap <= 1e-5, f"P2: moment blocks {m_gap} of scale from the reference's")
        check(same_params, "P2: the ranks' parameters differ")
        for i in range(P2_STEPS):
            sts = [out["steps"][i] for out in p2]
            print(f"  P2 step {i} wall ms per rank "
                  + ", ".join(f"{s['wall_s'] * 1e3:.2f}" for s in sts)
                  + "; share in collectives " + ", ".join(f"{s['collective_s'] / s['wall_s']:.3f}"
                                                          for s in sts)
                  + f"; \"dp\" elements {sts[0]['elements']} in {sts[0]['calls']} collectives; "
                  f"one rank without a mesh {ref[i]['wall_s'] * 1e3:.2f} ms [{card}]")
        # -- P2: the 4-rank checkpoint restored onto one rank ---------------------------
        t0 = time.perf_counter()
        fresh = ptl.init_train_state(cfg, tcfg, torch.Generator(device=cuda).manual_seed(1),
                                     cuda)
        restored, extra = ck.restore_checkpoint(Path(tmp) / "ckpt", P2_STEPS, fresh)
        load_s = time.perf_counter() - t0
        bitwise = extra == dict(batch_seed=0)
        for r, out in enumerate(p2):
            mesh = ModelMesh((("data", Axis(None, DP_RANKS, r)), ("model", Axis(None, 1, 0))))
            bitwise = bitwise and leaf_prints(
                restored, ptl.state_shardings(cfg, mesh, tcfg)) == out["prints"]
        print(f"P2 checkpoint saved across the {DP_RANKS} ranks in "
              + ", ".join(f"{out['save_s']:.2f}" for out in p2)
              + f" s, restored onto one rank in {load_s:.2f} s: every rank's blocks bitwise "
              f"(two exact fingerprints of each leaf's bits): {bitwise} [{card}]")
        check(bitwise, "P2: the state restored onto one rank differs from the ranks' blocks")
        del fresh, restored
        torch.cuda.empty_cache()
        # -- P3: the pipeline against the blocks in turn ---------------------------------
        blocks, _ = pipe_blocks(cfg, cuda)
        x = pipe_input(cfg, cuda)
        with torch.no_grad():
            seq = []
            for m in range(PIPE_MICRO):
                h = x[m]
                for b in blocks:
                    h = pipe_stage(b, dict(b.named_parameters()), h)
                seq.append(h)
            seq = torch.stack(seq).cpu()
        gap = max(float((out["out"] - seq).abs().max()) for out in p3) / float(seq.abs().max())
        print(f"P3 pipeline_apply over {DP_RANKS} gloo ranks, one {cfg.name} block (full width, "
              f"f32) a stage, {PIPE_MICRO} microbatches of 1 x {PIPE_S}: max gap to the blocks "
              f"in turn {gap:.3e} of scale (limit 1e-5); kernel 5 launches per rank "
              + ", ".join(str(out["launches"]["flash_attention"]) for out in p3)
              + "; wall ms per rank " + ", ".join(f"{out['wall_s'] * 1e3:.1f}" for out in p3)
              + f", share in its hand-offs {p3[0]['collective_s'] / p3[0]['wall_s']:.3f}, "
              f"\"pp\" elements {p3[0]['elements']} [{card}]")
        check(gap <= 1e-5, f"P3: pipeline vs the blocks in turn {gap}")
        check(all(out["launches"] == dict(ZERO_COUNTS, flash_attention=PIPE_MICRO)
                  for out in p3), f"P3 launches {[out['launches'] for out in p3]}")
        del blocks, x
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase P {time.perf_counter() - t_phase:.1f} s [{card}]")
    steps = p2[0]["steps"]
    return {"flash_attention": sum(s["launches"]["flash_attention"] for s in steps),
            "flash_attention_bwd": sum(s["launches"]["flash_attention_bwd"] for s in steps),
            "pipeline": p3[0]["launches"]["flash_attention"]}


# ---------------------------------------------------------------------------
# phase Q: MoE training across ranks (models/moe.py's global-batch router and
# models/moe_ep.py's expert-parallel route under the data-parallel train step)
# ---------------------------------------------------------------------------

# granite-moe-1b, its published config (32 experts, top-8, capacity factor 1.25): Q1 one NCCL
# rank at full width in bf16 on phase M's batch (TRAIN_B x TRAIN_S), cut to MOE_TRAIN_LAYERS of
# its 24 layers (from all 24 to 8 to make room for phase R, then to 4 for phase S: its checks
# do not depend on the depth),
# MOE_TRAIN_STEPS steps on a 1x1 mesh against no mesh, then one step each in turns; Q2 four gloo
# ranks sharing the card in phase N's world, full width cut to MOE_DP_LAYERS of 24 layers, f32,
# a global batch of MOE_DP_B x MOE_DP_S on a 4x1 mesh, one step by each route against the
# one-rank step on the card: route (a) at the config's capacity factor (drops happen), route
# (b) at 4.0 (cap >= N: nothing drops at either stage)
MOE_TRAIN_ARCH, MOE_TRAIN_STEPS, MOE_TRAIN_LAYERS = "granite_moe_1b", 2, 4
MOE_DP_LAYERS, MOE_DP_B, MOE_DP_S, MOE_DP_TIMEOUT_S = 2, 8, 256, 240
MOE_DP_ROUTES = {"a": (False, None), "b": (True, 4.0)}  # (moe_ep_shardmap, capacity factor)


def moe_train_cfg(dtype, n_layers=None, ep=False, cf=None):
    """``MOE_TRAIN_ARCH`` in ``dtype``, cut to ``n_layers`` (None: all), by
    the expert-parallel route with ``ep``, at capacity factor ``cf`` (None:
    the config's)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_TRAIN_ARCH)
    return cfg.with_(n_layers=n_layers or cfg.n_layers, param_dtype=dtype, compute_dtype=dtype,
                     moe_ep_shardmap=ep, capacity_factor=cf or cfg.capacity_factor)


def moe_layers(cfg, state, batch, axis=None, tp=None):
    """The forward of ``batch`` without grad (this rank's rows of a global
    batch cut over ``axis``, None: the whole batch; the weights cut over the
    model axis ``tp``, None: whole): each MoE layer's load and
    ``dropped_frac`` (global) and this rank's selections, on the CPU."""
    import torch

    from repro_torch.distributed import SOLO
    from repro_torch.models import model_zoo as pz

    with torch.no_grad():
        _, aux = pz.forward(state["params"], cfg, batch, state["router_state"],
                            axis=axis or SOLO, tp=tp or SOLO)
    return [dict(load=a["load"].cpu(), dropped=float(a["dropped_frac"]), top_i=a["top_i"].cpu())
            for a in aux["moe_layers"]]


def moe_one_rank(card, cuda):
    """Q1: one NCCL rank in this process, ``MOE_TRAIN_ARCH`` at full width
    and ``MOE_TRAIN_LAYERS`` layers in bf16 on phase M's batch:
    ``MOE_TRAIN_STEPS`` steps on a 1x1 mesh against the same steps without
    a mesh, bitwise (the global-batch
    router; the expert-parallel route's 1x1 mesh is held on the CPU, in
    ``tests/test_torch_moe_train.py``), kernels 5 and 5b once per layer a
    step; one step of each timed in turns; the peak device memory, each layer's
    ``dropped_frac``, a profiled step's device items; then the kernel route
    against the plain route at 2 layers in f32. Returns the launches of
    kernels 5 and 5b on the meshless steps."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ck

    cfg, tcfg = moe_train_cfg("bfloat16", MOE_TRAIN_LAYERS), dp_tcfg()
    batch = dp_batch(cfg, TRAIN_B, cuda)
    want = dict(ZERO_COUNTS, flash_attention=cfg.n_layers, flash_attention_bwd=cfg.n_layers)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            runs, same, peak = {}, {}, None
            for name, c, mesh in (("meshless", cfg, None), ("mesh", cfg, make_host_mesh(1, 1))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                state, step = dp_stepper(c, tcfg, mesh, cuda)
                stats = []
                for _ in range(MOE_TRAIN_STEPS):
                    state, st = timed_step(step, state, batch)
                    stats.append(st)
                peak = peak or torch.cuda.max_memory_allocated()
                runs[name] = [state, step, stats]
                if name != "meshless":
                    a, b = (ck.flatten_state(runs[n][0]) for n in ("meshless", name))
                    same[name] = (list(a) == list(b)
                                  and all(torch.equal(a[k].detach(), b[k].detach()) for k in a)
                                  and all(x["metrics"] == y["metrics"] for x, y in
                                          zip(runs["meshless"][2], stats)))
            turns = {"meshless": [], "mesh": []}
            for name in DP_TURNS:
                runs[name][0], st = timed_step(runs[name][1], runs[name][0], batch)
                turns[name].append(st)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    state, step, stats = runs.pop("meshless")
    del runs
    torch.cuda.empty_cache()
    for i, st in enumerate(stats):
        check(st["launches"] == want, f"Q1 step {i}: launches {st['launches']}")
        check(np.isfinite(st["metrics"]["loss"]), f"Q1 step {i}: loss not finite")
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"Q1 one {backend} rank, {cfg.name} d_model {cfg.d_model}, {cfg.n_experts} experts of "
          f"d_ff {cfg.d_ff}, top-{cfg.top_k}, capacity factor {cfg.capacity_factor}, "
          f"{cfg.n_layers} of 24 layers, bf16, {n_params} parameters, batch {TRAIN_B} x "
          f"{TRAIN_S}: {MOE_TRAIN_STEPS} steps on a 1x1 mesh = the steps without a mesh bitwise: "
          + ", ".join(f"{k} {v}" for k, v in same.items()) + "; losses "
          + ", ".join(f"{st['metrics']['loss']:.6f}" for st in stats) + "; moe_aux "
          + ", ".join(f"{st['metrics']['moe_aux']:.6f}" for st in stats)
          + f"; launches a step flash_attention={cfg.n_layers} "
          f"flash_attention_bwd={cfg.n_layers}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB) [{card}]")
    check(all(same.values()), f"Q1: the 1x1-mesh steps differ from the meshless steps: {same}")
    for name, sts in turns.items():
        print(f"  Q1 {name} step wall ms in turns ({', '.join(DP_TURNS)}): "
              + ", ".join(f"{st['wall_s'] * 1e3:.2f}" for st in sts) + f" [{card}]")
    layers = moe_layers(cfg, state, batch)
    drops = [layer["dropped"] for layer in layers]
    print(f"  Q1 dropped_frac over the {len(drops)} MoE layers before step "
          f"{MOE_TRAIN_STEPS + 2}: mean {np.mean(drops):.6f}, min {min(drops):.6f}, max "
          f"{max(drops):.6f}; the largest load of a layer over its mean "
          f"{max(float(layer['load'].max() / layer['load'].mean()) for layer in layers):.3f} "
          f"[{card}]")
    profile_run(lambda: step(state, batch), top=10, suffix=f" [{card}]",
                also=(*BWD_PASSES["tc"], "flash_tc"))
    del state, step
    torch.cuda.empty_cache()
    two_layer_f32_gap(MOE_TRAIN_ARCH, card, cuda)
    return {k: sum(st["launches"][k] for st in stats)
            for k in ("flash_attention", "flash_attention_bwd")}


def moe_dp_reference(card, cuda, tmp):
    """Q2's references: for each route's capacity factor, the one-rank f32
    step without a mesh on the card from the seed and the global batch Q2's
    ranks use, and the forward's MoE layers before it; written to
    ``tmp/moe_<route>.pt`` for the ranks. Returns each route's step stats."""
    import torch

    out = {}
    for route, (_, cf) in MOE_DP_ROUTES.items():
        cfg, tcfg = moe_train_cfg("float32", MOE_DP_LAYERS, cf=cf), dp_tcfg()
        state, step = dp_stepper(cfg, tcfg, None, cuda)
        batch = dp_batch(cfg, MOE_DP_B, cuda, MOE_DP_S)
        layers = moe_layers(cfg, state, batch)
        state, st = timed_step(step, state, batch)
        torch.save({"params": {n: p.detach().cpu() for n, p in
                               state["params"].named_parameters()},
                    "m": {n: t.cpu() for n, t in state["opt"]["m"].items()},
                    "lr": st["metrics"]["lr"], "router_state": state["router_state"].cpu(),
                    "layers": layers}, Path(tmp) / f"moe_{route}.pt")
        out[route] = st
        print(f"Q2 reference ({route}): one rank, {cfg.name} {MOE_DP_LAYERS} layers f32, "
              f"capacity factor {cfg.capacity_factor}, global batch {MOE_DP_B} x {MOE_DP_S}: "
              f"step wall {st['wall_s'] * 1e3:.2f} ms, loss {st['metrics']['loss']:.6f}, "
              f"dropped_frac by layer " + ", ".join(f"{x['dropped']:.6f}" for x in layers)
              + f" [{card}]")
        del state, step, batch
        torch.cuda.empty_cache()
    return out


def q2_rank(tmp, device):
    """One rank of Q2: for each route, the 4x1 mesh, the state placed and
    cut (``dp_stepper``), the forward's MoE layers on this rank's rows, one
    step timed and counted, the gaps against the reference (``dp_gaps``),
    the fingerprints of this rank's leaves; the expert-parallel state saved
    across the ranks to ``tmp/moe_ckpt``."""
    import torch

    from repro_torch.distributed import set_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import train_loop as ptl

    out = {}
    for route, (ep, cf) in MOE_DP_ROUTES.items():
        t0 = time.perf_counter()
        cfg, tcfg = moe_train_cfg("float32", MOE_DP_LAYERS, ep=ep, cf=cf), dp_tcfg()
        mesh = make_host_mesh(DP_RANKS, 1)
        held = ptl.state_shardings(cfg, mesh, tcfg)
        state, step = dp_stepper(cfg, tcfg, mesh, device)
        batch = dp_batch(cfg, MOE_DP_B, device, MOE_DP_S)
        data, n = mesh.axis("data"), MOE_DP_B // DP_RANKS
        rows = {k: v[data.index * n:(data.index + 1) * n] for k, v in batch.items()}
        set_mesh(mesh)
        try:
            layers = moe_layers(cfg, state, rows, data)
        finally:
            set_mesh(None)
        r = dict(setup_s=time.perf_counter() - t0, layers=layers)
        state, r["step"] = timed_step(step, state, batch)
        r["gaps"] = dp_gaps(state, Path(tmp) / f"moe_{route}.pt", held, tcfg.opt.b1, device)
        r["router_state"] = state["router_state"].cpu()
        r["prints"] = leaf_prints(state)
        r["owned"] = sorted(f"params/{n}" for n, sh in held["params"].items()
                            if not sh.replicated)
        if ep:
            t1 = time.perf_counter()
            ck.save_checkpoint(Path(tmp) / "moe_ckpt", 1, state, extra=dict(batch_seed=0),
                               shardings=held)
            r["save_s"] = time.perf_counter() - t1
        r["wall_s"] = time.perf_counter() - t0
        out[route] = r
        del state, step
        torch.cuda.empty_cache()
    return out


def moe_prepare(card, cuda):
    """Phase Q's parts in this process before the world of ranks: Q1, and
    Q2's one-rank references in a temporary directory. Returns (the
    directory, the references' stats, Q1's launches)."""
    t0 = time.perf_counter()
    q1 = moe_one_rank(card, cuda)
    print(f"  Q1 {time.perf_counter() - t0:.1f} s [{card}]")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    return tmp, moe_dp_reference(card, cuda, tmp), q1


def moe_world_calls(cuda, prepared):
    """Q2's call for each rank of a world of ``DP_RANKS`` gloo ranks sharing
    the card (``spawn_world(call_each, ...)``)."""
    return [(q2_rank, (prepared[0], str(cuda)), {})]


def moe_train_path(card, cuda, prepared=None, world=None, keep_refs=False):
    """Phase Q, MoE training across ranks: Q1 (:func:`moe_one_rank`); Q2
    four gloo ranks sharing the card on a 4x1 mesh, f32, one step by each
    route against the one-rank f32 step on the card: loss and grad norm
    within rel 1e-5 and the same on every rank, each MoE layer's loads,
    ``dropped_frac`` and the ranks' selections equal to the one-rank
    forward's, the router state equal, the parameters within the
    ``_param_bound`` rule and each rank's moment blocks within 1e-5 of
    scale, every rank's replicated parameters identical, kernels 5 and 5b
    once per layer on every rank, the step walls, their share in
    collectives and the elements by tag; the expert-parallel state saved
    across the ranks and restored onto one rank here, bitwise every rank's
    blocks. ``prepared``: :func:`moe_prepare`'s result, ``world``: each
    rank's results of :func:`moe_world_calls` where another phase's world
    ran them (phase N's, in a whole run); else they run here; ``keep_refs``:
    leave Q2's references in their directory for phase S. Callable alone
    after ``card_setup`` and ``build_kernels`` (kernels 5 and 5b). Returns
    the launches of kernels 5 and 5b on Q1's meshless steps and on rank 0's
    Q2 steps."""
    import shutil

    import torch

    from repro_torch.distributed import call_each, spawn_world
    from repro_torch.distributed.context import Axis
    from repro_torch.launch.mesh import ModelMesh
    from repro_torch.training import checkpoint as ck
    from repro_torch.training import train_loop as ptl

    t_phase = time.perf_counter()
    if prepared is None:
        prepared = moe_prepare(card, cuda)
    tmp, refs, q1 = prepared
    try:
        if world is None:
            t0 = time.perf_counter()
            world = spawn_world(call_each, DP_RANKS, "gloo", MOE_DP_TIMEOUT_S,
                                (moe_world_calls(cuda, prepared),))
            print(f"  Q2 in a world of its own, {time.perf_counter() - t0:.1f} s [{card}]")
        q2 = [w[0] for w in world]
        want = dict(ZERO_COUNTS, flash_attention=MOE_DP_LAYERS, flash_attention_bwd=MOE_DP_LAYERS)
        for route, (ep, cf) in MOE_DP_ROUTES.items():
            cfg, tcfg = moe_train_cfg("float32", MOE_DP_LAYERS, ep=ep, cf=cf), dp_tcfg()
            ref = torch.load(Path(tmp) / f"moe_{route}.pt", weights_only=True)
            outs = [out[route] for out in q2]
            worst = {"loss": 0.0, "grad_norm": 0.0}
            for r, out in enumerate(outs):
                st = out["step"]
                check(st["launches"] == want, f"Q2 ({route}) rank {r}: launches {st['launches']}")
                check(st["metrics"] == outs[0]["step"]["metrics"],
                      f"Q2 ({route}): rank {r}'s metrics differ from rank 0's")
                for key in worst:
                    worst[key] = max(worst[key], rel_diff(st["metrics"][key],
                                                          refs[route]["metrics"][key]))
            same_rs = all(torch.equal(out["router_state"], ref["router_state"]) for out in outs)
            loads = all(torch.equal(out["layers"][i]["load"], layer["load"])
                        and out["layers"][i]["dropped"] == layer["dropped"]
                        for out in outs for i, layer in enumerate(ref["layers"]))
            picks = all(torch.equal(torch.cat([out["layers"][i]["top_i"] for out in outs]),
                                    layer["top_i"]) for i, layer in enumerate(ref["layers"]))
            drops = [layer["dropped"] for layer in ref["layers"]]
            excess = max(out["gaps"]["param_excess"] for out in outs)
            m_gap = max(out["gaps"]["m_gap"] for out in outs)
            same_params = all(out["prints"][k] == outs[0]["prints"][k] for out in outs[1:]
                              for k in out["prints"]
                              if k.startswith("params/") and k not in out["owned"])
            name = "global-batch router" if route == "a" else "expert-parallel route"
            print(f"Q2 ({route}) {DP_RANKS} gloo ranks on the card, 4x1 mesh, the {name}, "
                  f"{cfg.name} {MOE_DP_LAYERS} of 24 layers f32, capacity factor "
                  f"{cfg.capacity_factor}, global batch {MOE_DP_B} x {MOE_DP_S} "
                  f"({MOE_DP_B // DP_RANKS} rows a rank): loss "
                  f"{outs[0]['step']['metrics']['loss']:.6f}, moe_aux "
                  f"{outs[0]['step']['metrics']['moe_aux']:.6f}; against the one-rank f32 step: "
                  f"loss rel {worst['loss']:.3e}, grad norm rel {worst['grad_norm']:.3e} (limit "
                  f"1e-5); each layer's loads and dropped_frac equal: {loads} (dropped_frac "
                  + ", ".join(f"{d:.6f}" for d in drops) + f"); the ranks' selections equal: "
                  f"{picks}; router state equal: {same_rs}; the parameters' largest excess "
                  f"over the _param_bound rule {excess:.3e} (held <= 0), the moment blocks "
                  f"{m_gap:.3e} of scale (limit 1e-5); every rank's replicated parameters "
                  f"identical: {same_params}; launches on every rank flash_attention="
                  f"{MOE_DP_LAYERS} flash_attention_bwd={MOE_DP_LAYERS} [{card}]")
            check(max(worst.values()) <= 1e-5, f"Q2 ({route}): loss/grad norm beyond rel 1e-5: "
                                               f"{worst}")
            check(loads and picks and same_rs, f"Q2 ({route}): loads, dropped_frac, selections "
                                               "or router state differ from the one-rank step")
            check(excess <= 0.0, f"Q2 ({route}): a parameter beyond the _param_bound rule")
            check(m_gap <= 1e-5, f"Q2 ({route}): moment blocks {m_gap} of scale off")
            check(same_params, f"Q2 ({route}): the ranks' replicated parameters differ")
            if route == "b":  # cap >= N: nothing can drop
                check(max(drops) == 0.0, f"Q2 (b): dropped_frac {drops}")
            sts = [out["step"] for out in outs]
            print(f"  Q2 ({route}) step wall ms per rank "
                  + ", ".join(f"{s['wall_s'] * 1e3:.2f}" for s in sts)
                  + "; share in collectives " + ", ".join(f"{s['collective_s'] / s['wall_s']:.3f}"
                                                          for s in sts)
                  + f"; elements by tag {sts[0]['tags']} in {sts[0]['calls']} collectives; "
                  f"one rank without a mesh {refs[route]['wall_s'] * 1e3:.2f} ms; the rank's "
                  f"set-up {outs[0]['setup_s']:.1f} s [{card}]")
        # -- Q2: the expert-parallel checkpoint restored onto one rank ---------------------
        cfg, tcfg = moe_train_cfg("float32", MOE_DP_LAYERS, ep=True, cf=4.0), dp_tcfg()
        t0 = time.perf_counter()
        fresh = ptl.init_train_state(cfg, tcfg, torch.Generator(device=cuda).manual_seed(1),
                                     cuda)
        restored, extra = ck.restore_checkpoint(Path(tmp) / "moe_ckpt", 1, fresh)
        load_s = time.perf_counter() - t0
        bitwise = extra == dict(batch_seed=0)
        for r, out in enumerate(q2):
            mesh = ModelMesh((("data", Axis(None, DP_RANKS, r)), ("model", Axis(None, 1, 0))))
            bitwise = bitwise and leaf_prints(
                restored, ptl.state_shardings(cfg, mesh, tcfg)) == out["b"]["prints"]
        print(f"Q2 expert-parallel checkpoint (each rank's {cfg.n_experts // DP_RANKS} experts "
              f"and their moments) saved across the {DP_RANKS} ranks in "
              + ", ".join(f"{out['b']['save_s']:.2f}" for out in q2)
              + f" s, restored onto one rank in {load_s:.2f} s: every rank's blocks bitwise "
              f"(two exact fingerprints of each leaf's bits): {bitwise} [{card}]")
        check(bitwise, "Q2: the state restored onto one rank differs from the ranks' blocks")
        del fresh, restored
        torch.cuda.empty_cache()
    finally:
        if not keep_refs:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase Q {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: dict(train=q1[k], dp=sum(q2[0][r]["step"]["launches"][k] for r in MOE_DP_ROUTES))
            for k in ("flash_attention", "flash_attention_bwd")}


# ---------------------------------------------------------------------------
# phase R: tensor-parallel training of the dense decoder (make_train_step on a "model"
# axis above 1: models/common.py's Megatron layout, distributed.copy_to/reduce_from, the
# vocabulary-cut loss)
# ---------------------------------------------------------------------------

# stablelm-3b at full width (d_model 2560, 32 heads of 80, d_ff 6912, vocab 50304), cut to
# TP_LAYERS of its 32 layers, f32, one step on a global batch of TP_B x TP_S: R1 one rank
# without a mesh in this process, the reference; R2 four gloo ranks sharing the card on a
# (1, 4) mesh, R3 on a (2, 2) mesh with ZeRO-1 moments over both axes and grad_specs, both in
# phase N's world after Q2
TP_ARCH, TP_LAYERS, TP_B, TP_S, TP_TIMEOUT_S = "stablelm_3b", 2, 4, 512, 300
TP_MESHES = {"R2": (1, 4), "R3": (2, 2)}
# the CPU tests' bounds (tests/test_torch_tp_train.py): loss and grad norm rel 1e-5, each
# moment block within 1e-4 of the reference moment's scale
TP_MOMENT_TOL = 1e-4


def model_cut_keys(held):
    """The flattened keys (``params/<name>``, ``opt/m/<name>``) of the
    leaves that ``held`` (``state_shardings``) cuts over "model"."""
    return sorted(f"{tree}/{n}" for tree, shs in (("params", held["params"]),
                                                  ("opt/m", held["opt"]["m"]))
                  for n, sh in shs.items() if any("model" in a for _, a in sh.cuts()))


def tp_agreement(outs, ref_metrics):
    """What phases R, S and T hold of one tensor-parallel step on the mesh's
    ranks (each rank's ``gaps``, ``prints``, ``model_cut`` and ``coords``):
    the worst rel gaps of loss and grad norm to ``ref_metrics``, the
    parameters' largest gap over scale and excess over the ``_param_bound``
    rule, the moment blocks' largest gap over scale, whether every
    replicated parameter is identical on the ranks and every moment block
    of a leaf that "model" does not cut identical on a data row's model
    ranks, and the text that reports them."""
    a = dict(worst={k: max(rel_diff(o["step"]["metrics"][k], ref_metrics[k]) for o in outs)
                    for k in ("loss", "grad_norm")},
             excess=max(o["gaps"]["param_excess"] for o in outs),
             p_gap=max(o["gaps"]["param_gap"] for o in outs),
             m_gap=max(o["gaps"]["m_gap"] for o in outs))
    cut = set(outs[0]["model_cut"])
    a["same_params"] = all(o["prints"][k] == outs[0]["prints"][k] for o in outs[1:]
                           for k in o["prints"] if k.startswith("params/") and k not in cut)
    a["same_grads"] = all(x["prints"][k] == y["prints"][k] for x in outs for y in outs
                          if x["coords"][0] == y["coords"][0]
                          for k in x["prints"] if k.startswith("opt/m/") and k not in cut)
    a["text"] = (f"loss rel {a['worst']['loss']:.3e}, grad norm rel {a['worst']['grad_norm']:.3e} "
                 f"(limit 1e-5); the parameters' largest gap {a['p_gap']:.3e} of scale, largest "
                 f"excess over the _param_bound rule {a['excess']:.3e} (held <= 0); the moment "
                 f"blocks {a['m_gap']:.3e} of scale (limit {TP_MOMENT_TOL}); every rank's "
                 f"replicated parameters identical: {a['same_params']}; the replicated leaves' "
                 f"gradients (moment blocks) identical on a data row's model ranks: "
                 f"{a['same_grads']}")
    return a


def hold_tp_agreement(label, a):
    """Fail unless :func:`tp_agreement`'s ``a`` is within the CPU tests' bounds."""
    check(max(a["worst"].values()) <= 1e-5,
          f"{label}: loss/grad norm beyond rel 1e-5: {a['worst']}")
    check(a["excess"] <= 0.0, f"{label}: a parameter beyond the _param_bound rule by "
                              f"{a['excess']}")
    check(a["m_gap"] <= TP_MOMENT_TOL, f"{label}: moment blocks {a['m_gap']} of scale off")
    check(a["same_params"] and a["same_grads"],
          f"{label}: replicated parameters or gradients differ across ranks")


def step_walls(sts):
    """Each rank's step wall ms and share in collectives, rank 0's
    collective seconds and elements by tag, from ``timed_step``'s stats."""
    return ("step wall ms per rank " + ", ".join(f"{s['wall_s'] * 1e3:.2f}" for s in sts)
            + "; share in collectives " + ", ".join(f"{s['collective_s'] / s['wall_s']:.3f}"
                                                    for s in sts)
            + "; collective seconds by tag (rank 0) "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(sts[0]["tag_seconds"].items()))
            + f"; elements by tag {sts[0]['tags']} in {sts[0]['calls']} collectives")


def tp_cfg():
    from repro_torch.configs import get_config

    return get_config(TP_ARCH).with_(n_layers=TP_LAYERS, param_dtype="float32",
                                     compute_dtype="float32")


def rank_attention_checks(card, cuda, name, B, Hq, Hkv, D, S, causal):
    """Kernels 5 and 5b alone at one rank's shapes in f32 (the SIMT routes)
    against their plain versions on the card: the output and dQ, dK, dV
    within ``ATT_TOL`` of scale; prints each call's event ms beside the
    plain version's, SDPA's (forward, and backward) and the bound."""
    import torch

    from repro_torch.kernels import flash_attention as kf

    g = torch.Generator(device=cuda).manual_seed(Hq)
    q, k, v, dout = (torch.randn((B, h, S, D), generator=g, device=cuda)
                     for h in (Hq, Hkv, Hkv, Hq))
    fwd_err = attention_close(f"{name}: flash_attention",
                              kf.flash_attention_call(q, k, v, causal),
                              kf.flash_attention_plain(q, k, v, causal), "float32")
    got = kf.flash_attention_bwd_call(q, k, v, dout, causal)
    want = kf.flash_attention_bwd_plain(q, k, v, dout, causal)
    gaps = [float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(got, want)]
    check(max(gaps) <= ATT_TOL["float32"],
          f"{name}: flash_attention_bwd beyond {ATT_TOL['float32']} of scale: {gaps}")
    fwd = {"kernel": partial(kf.flash_attention_call, q, k, v, causal),
           "plain": partial(kf.flash_attention_plain, q, k, v, causal),
           "SDPA": partial(library_sdpa, q, k, v, is_causal=causal)}
    bwd = {"kernel": partial(kf.flash_attention_bwd_call, q, k, v, dout, causal),
           "plain": partial(kf.flash_attention_bwd_plain, q, k, v, dout, causal),
           "SDPA": library_sdpa_backward(q, k, v, dout, causal)}
    fwd_ms = {w: time_calls(fn, 5 if w != "plain" else 2) for w, fn in fwd.items()}
    bwd_ms = {w: time_calls(fn, 5 if w != "plain" else 2) for w, fn in bwd.items()}
    fwd_bound = attention_bound((2 * q.numel() + k.numel() + v.numel()) * 4,
                                4 * B * Hq * D * S * S // (2 if causal else 1), torch.float32)
    *_, bwd_bound_ms, bwd_bound_by = bwd_bound(B, Hq, Hkv, S, D, causal, torch.float32)
    print(f"{name}: flash_attention max_abs_err {fwd_err:.3e} (limit "
          f"{ATT_TOL['float32']}), event ms per call "
          + ", ".join(f"{w} {t:.4f}" for w, t in fwd_ms.items())
          + f", bound {fwd_bound[0]:.4f} ({fwd_bound[1]}); flash_attention_bwd dq/dk/dv gap "
          f"of scale {gaps[0]:.3e}/{gaps[1]:.3e}/{gaps[2]:.3e} (limit "
          f"{ATT_TOL['float32']}), event ms per call "
          + ", ".join(f"{w} {t:.4f}" for w, t in bwd_ms.items())
          + f", bound {bwd_bound_ms:.4f} ({bwd_bound_by}) [{card}]")
    del q, k, v, dout, got, want, fwd, bwd
    torch.cuda.empty_cache()


def tp_kernel_checks(card, cuda):
    """Kernels 5 and 5b alone at each R mesh's per-rank shapes (the rank's
    rows of the global batch, its n_heads/m heads of 80, S = ``TP_S``,
    causal, f32: the SIMT routes) against their plain versions on the card
    (:func:`rank_attention_checks`)."""
    cfg = tp_cfg()
    for label, (n_data, n_model) in TP_MESHES.items():
        B, H, D = TP_B // n_data, cfg.n_heads // n_model, cfg.resolved_head_dim
        rank_attention_checks(card, cuda, f"{label} kernels at a rank's shapes (B {B}, {H} "
                              f"heads of {D}, S {TP_S}, f32)", B, H, H, D, TP_S, True)


def tp_reference(card, cuda, tmp):
    """R1: the one-rank f32 step without a mesh on the card from the seed and
    global batch R2's and R3's ranks use; writes the parameters and the
    first moments after it to ``tmp/tp_reference.pt`` for the ranks.
    Returns its stats."""
    import torch

    cfg, tcfg = tp_cfg(), dp_tcfg()
    state, step = dp_stepper(cfg, tcfg, None, cuda)
    batch = dp_batch(cfg, TP_B, cuda, TP_S)
    state, st = timed_step(step, state, batch)
    torch.save({"params": {n: p.detach().cpu() for n, p in state["params"].named_parameters()},
                "m": {n: t.cpu() for n, t in state["opt"]["m"].items()},
                "lr": st["metrics"]["lr"]}, Path(tmp) / "tp_reference.pt")
    n_params = sum(p.numel() for p in state["params"].parameters())
    want = dict(ZERO_COUNTS, flash_attention=TP_LAYERS, flash_attention_bwd=TP_LAYERS)
    check(st["launches"] == want, f"R1 launches {st['launches']}")
    print(f"R1 one rank, {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {TP_LAYERS} of 32 "
          f"layers f32, {n_params} parameters, global batch {TP_B} x {TP_S}: step wall "
          f"{st['wall_s'] * 1e3:.2f} ms, loss {st['metrics']['loss']:.6f}, grad norm "
          f"{st['metrics']['grad_norm']:.6f}; launches flash_attention={TP_LAYERS} "
          f"flash_attention_bwd={TP_LAYERS} [{card}]")
    del state, step, batch
    torch.cuda.empty_cache()
    return st


def r_rank(tmp, device):
    """One rank of R2 and R3: for each mesh of ``TP_MESHES``, the state cut to
    this rank's blocks (``dp_stepper``: the model-cut parameters and the
    moments), one step timed and counted with its collectives' seconds by
    tag, the gaps against R1 (``dp_gaps``) and the fingerprints of this
    rank's leaves."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import train_loop as ptl

    out = {}
    for label, shape in TP_MESHES.items():
        t0 = time.perf_counter()
        cfg, tcfg = tp_cfg(), dp_tcfg()
        mesh = make_host_mesh(*shape)
        held = ptl.state_shardings(cfg, mesh, tcfg)
        state, step = dp_stepper(cfg, tcfg, mesh, device)
        batch = dp_batch(cfg, TP_B, device, TP_S)
        r = dict(setup_s=time.perf_counter() - t0, coords=(mesh.axis("data").index,
                                                           mesh.axis("model").index))
        state, r["step"] = timed_step(step, state, batch)
        r["gaps"] = dp_gaps(state, Path(tmp) / "tp_reference.pt", held, tcfg.opt.b1, device)
        r["prints"] = leaf_prints(state)
        r["model_cut"] = model_cut_keys(held)
        r["wall_s"] = time.perf_counter() - t0
        out[label] = r
        del state, step
        torch.cuda.empty_cache()
    return out


def tp_prepare(card, cuda):
    """Phase R's parts in this process before the world of ranks: kernels 5
    and 5b at R's per-rank shapes, and R1 in a temporary directory.
    Returns (the directory, R1's stats)."""
    t0 = time.perf_counter()
    tp_kernel_checks(card, cuda)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    ref = tp_reference(card, cuda, tmp)
    print(f"  R's kernel checks and R1 {time.perf_counter() - t0:.1f} s [{card}]")
    return tmp, ref


def tp_world_calls(cuda, prepared):
    """R2's and R3's call for each rank of a world of ``DP_RANKS`` gloo ranks
    sharing the card (``spawn_world(call_each, ...)``)."""
    return [(r_rank, (prepared[0], str(cuda)), {})]


def tp_train_path(card, cuda, prepared=None, world=None):
    """Phase R, tensor-parallel training of the dense decoder
    (``make_train_step`` on a ``"model"`` axis above 1): kernels 5 and 5b at
    the ranks' shapes and R1 (:func:`tp_prepare`); R2 four gloo ranks
    sharing the card on a (1, 4) mesh and R3 on a (2, 2) mesh with ZeRO-1,
    ``TP_ARCH`` at full width, ``TP_LAYERS`` layers, f32, one step each on
    R1's global batch: loss and grad norm within rel 1e-5 of R1 and the same
    on every rank, the parameters (each rank's blocks) within the
    ``_param_bound`` rule and their largest gap over scale, each rank's
    moment blocks within ``TP_MOMENT_TOL`` of scale, every replicated
    parameter the same on every rank and every moment block of a leaf that
    "model" does not cut the same on a data row's model ranks, kernels 5 and
    5b once per layer a step on every rank on the rank's heads, the step
    walls and the collectives' seconds by tag. ``prepared``:
    :func:`tp_prepare`'s result, ``world``: each rank's results of
    :func:`tp_world_calls` where another phase's world ran them (phase N's,
    in a whole run); else they run here. Callable alone after
    ``card_setup`` and ``build_kernels`` (kernels 5 and 5b). Returns rank
    0's launches of kernels 5 and 5b a step, by mesh."""
    import shutil

    from repro_torch.distributed import call_each, spawn_world

    t_phase = time.perf_counter()
    if prepared is None:
        prepared = tp_prepare(card, cuda)
    tmp, ref = prepared
    try:
        if world is None:
            t0 = time.perf_counter()
            world = spawn_world(call_each, DP_RANKS, "gloo", TP_TIMEOUT_S,
                                (tp_world_calls(cuda, prepared),))
            print(f"  R2 and R3 in a world of their own, {time.perf_counter() - t0:.1f} s "
                  f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rr = [w[0] for w in world]
    cfg = tp_cfg()
    want = dict(ZERO_COUNTS, flash_attention=TP_LAYERS, flash_attention_bwd=TP_LAYERS)
    launches = {}
    for label, (n_data, n_model) in TP_MESHES.items():
        outs = [out[label] for out in rr]
        for r, out in enumerate(outs):
            st = out["step"]
            check(st["launches"] == want, f"{label} rank {r}: launches {st['launches']}")
            check(st["metrics"] == outs[0]["step"]["metrics"],
                  f"{label}: rank {r}'s metrics differ from rank 0's")
        agree = tp_agreement(outs, ref["metrics"])
        sts = [out["step"] for out in outs]
        print(f"{label} {DP_RANKS} gloo ranks on the card, ({n_data}, {n_model}) mesh, "
              f"{cfg.name} {TP_LAYERS} of 32 layers f32 (a rank: {cfg.n_heads // n_model} heads, "
              f"d_ff {cfg.d_ff // n_model}, vocab {cfg.vocab_size // n_model}; "
              f"{TP_B // n_data} rows), ZeRO-1 moments, grad_specs: loss "
              f"{sts[0]['metrics']['loss']:.6f}; against R1: {agree['text']}; launches a step on "
              f"every rank flash_attention={TP_LAYERS} flash_attention_bwd={TP_LAYERS} [{card}]")
        hold_tp_agreement(label, agree)
        print(f"  {label} {step_walls(sts)}; R1 {ref['wall_s'] * 1e3:.2f} ms; the rank's set-up "
              f"{outs[0]['setup_s']:.1f} s [{card}]")
        launches[f"{(n_data, n_model)}"] = {k: sts[0]["launches"][k]
                                             for k in ("flash_attention", "flash_attention_bwd")}
    print(f"  phase R {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: {mesh: n[k] for mesh, n in launches.items()}
            for k in ("flash_attention", "flash_attention_bwd")}


# ---------------------------------------------------------------------------
# phase S: tensor-parallel training of the MoE decoder (make_train_step on a "model" axis
# above 1 with an MoE config: models/moe.py's experts cut over "model", models/moe_ep.py's
# F-cut experts under distributed.copy_to/reduce_from)
# ---------------------------------------------------------------------------

# Q2's model and batch (granite-moe-1b at full width, MOE_DP_LAYERS of its 24 layers, f32, a
# global batch of MOE_DP_B x MOE_DP_S), four gloo ranks sharing the card in phase N's world after
# R2 and R3, one step each against Q2's one-rank f32 references (no new reference run): the
# route of MOE_DP_ROUTES (its capacity factor) on a mesh
MOE_TP_STEPS = {"S1": ("a", (1, 4)), "S2": ("a", (2, 2)), "S3": ("b", (2, 2))}
MOE_TP_TIMEOUT_S = 240


def s_rank(tmp, device):
    """One rank of phase S: for each step of ``MOE_TP_STEPS``, the state
    placed and cut to this rank's blocks (``dp_stepper``), the forward's MoE
    layers on this rank's rows and heads, one step timed and counted with
    its collectives' seconds by tag, the gaps against Q2's reference of its
    route (``dp_gaps``) and the fingerprints of this rank's leaves."""
    import torch

    from repro_torch.distributed import set_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import train_loop as ptl

    out = {}
    for label, (route, shape) in MOE_TP_STEPS.items():
        t0 = time.perf_counter()
        ep, cf = MOE_DP_ROUTES[route]
        cfg, tcfg = moe_train_cfg("float32", MOE_DP_LAYERS, ep=ep, cf=cf), dp_tcfg()
        mesh = make_host_mesh(*shape)
        held = ptl.state_shardings(cfg, mesh, tcfg)
        state, step = dp_stepper(cfg, tcfg, mesh, device)
        batch = dp_batch(cfg, MOE_DP_B, device, MOE_DP_S)
        data, model, n = mesh.axis("data"), mesh.axis("model"), MOE_DP_B // shape[0]
        rows = {k: v[data.index * n:(data.index + 1) * n] for k, v in batch.items()}
        set_mesh(mesh)
        try:
            layers = moe_layers(cfg, state, rows, data, model)
        finally:
            set_mesh(None)
        r = dict(setup_s=time.perf_counter() - t0, layers=layers,
                 coords=(data.index, model.index))
        state, r["step"] = timed_step(step, state, batch)
        r["gaps"] = dp_gaps(state, Path(tmp) / f"moe_{route}.pt", held, tcfg.opt.b1, device)
        r["router_state"] = state["router_state"].cpu()
        r["prints"] = leaf_prints(state)
        r["model_cut"] = model_cut_keys(held)
        r["wall_s"] = time.perf_counter() - t0
        out[label] = r
        del state, step
        torch.cuda.empty_cache()
    return out


def moe_tp_world_calls(cuda, prepared):
    """Phase S's call for each rank of a world of ``DP_RANKS`` gloo ranks
    sharing the card (``spawn_world(call_each, ...)``)."""
    return [(s_rank, (prepared[0], str(cuda)), {})]


def moe_tp_train_path(card, cuda, prepared=None, world=None):
    """Phase S, tensor-parallel training of the MoE decoder
    (``make_train_step`` on a ``"model"`` axis above 1): four gloo ranks
    sharing the card, ``MOE_TRAIN_ARCH`` at full width, ``MOE_DP_LAYERS``
    layers, f32, one step each of ``MOE_TP_STEPS`` on Q2's global batch,
    against Q2's one-rank step of its route: loss and grad norm within rel
    1e-5 and the same on every rank, each MoE layer's loads,
    ``dropped_frac`` and the data rows' selections equal to the one-rank
    forward's (the same on a data row's model ranks), the router state
    equal, each rank's parameter blocks within the ``_param_bound`` rule and
    their largest gap over scale, its moment blocks within
    ``TP_MOMENT_TOL`` of scale, every parameter that "model" does not cut
    the same on every rank and its moment block the same on a data row's
    model ranks, kernels 5 and 5b once per layer a step on every rank, the
    step walls and the collectives' seconds and elements by tag.
    ``prepared``: :func:`moe_prepare`'s result (Q2's references, kept by
    ``moe_train_path(..., keep_refs=True)``; this removes them), ``world``:
    each rank's results of :func:`moe_tp_world_calls` where another phase's
    world ran them (phase N's, in a whole run); else the references and the
    world run here. Callable alone after ``card_setup`` and ``build_kernels``
    (kernels 5 and 5b). Returns rank 0's launches of kernels 5 and 5b a
    step, by step."""
    import shutil

    import torch

    from repro_torch.distributed import call_each, spawn_world

    t_phase = time.perf_counter()
    if prepared is None:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_tp_")
        prepared = (tmp, moe_dp_reference(card, cuda, tmp))
    tmp, refs = prepared[:2]
    launches = {}
    try:
        if world is None:
            t0 = time.perf_counter()
            world = spawn_world(call_each, DP_RANKS, "gloo", MOE_TP_TIMEOUT_S,
                                (moe_tp_world_calls(cuda, prepared),))
            print(f"  S in a world of its own, {time.perf_counter() - t0:.1f} s [{card}]")
        ss = [w[0] for w in world]
        want = dict(ZERO_COUNTS, flash_attention=MOE_DP_LAYERS, flash_attention_bwd=MOE_DP_LAYERS)
        for label, (route, (n_data, n_model)) in MOE_TP_STEPS.items():
            ep, cf = MOE_DP_ROUTES[route]
            cfg = moe_train_cfg("float32", MOE_DP_LAYERS, ep=ep, cf=cf)
            ref = torch.load(Path(tmp) / f"moe_{route}.pt", weights_only=True)
            outs = [out[label] for out in ss]
            for r, out in enumerate(outs):
                st = out["step"]
                check(st["launches"] == want, f"{label} rank {r}: launches {st['launches']}")
                check(st["metrics"] == outs[0]["step"]["metrics"],
                      f"{label}: rank {r}'s metrics differ from rank 0's")
            same_rs = all(torch.equal(out["router_state"], ref["router_state"]) for out in outs)
            loads = all(torch.equal(out["layers"][i]["load"], layer["load"])
                        and out["layers"][i]["dropped"] == layer["dropped"]
                        for out in outs for i, layer in enumerate(ref["layers"]))
            picks = all(
                torch.equal(torch.cat([outs[d * n_model]["layers"][i]["top_i"]
                                       for d in range(n_data)]), layer["top_i"])
                and all(torch.equal(out["layers"][i]["top_i"],
                                    outs[out["coords"][0] * n_model]["layers"][i]["top_i"])
                        for out in outs)
                for i, layer in enumerate(ref["layers"]))
            drops = [layer["dropped"] for layer in ref["layers"]]
            agree = tp_agreement(outs, refs[route]["metrics"])
            name = "global-batch router" if route == "a" else "expert-parallel route"
            sts = [out["step"] for out in outs]
            print(f"{label} {DP_RANKS} gloo ranks on the card, ({n_data}, {n_model}) mesh, the "
                  f"{name}, {cfg.name} {MOE_DP_LAYERS} of 24 layers f32 (a rank: "
                  f"{cfg.n_heads // n_model} heads, "
                  + (f"{cfg.n_experts // n_model} of {cfg.n_experts} experts of d_ff {cfg.d_ff}"
                     if route == "a" else f"{cfg.n_experts // n_data} of {cfg.n_experts} experts "
                     f"of d_ff {cfg.d_ff // n_model}")
                  + f", the vocabulary of {cfg.vocab_size} whole; {MOE_DP_B // n_data} rows), "
                  f"capacity factor {cfg.capacity_factor}, ZeRO-1 moments, grad_specs: loss "
                  f"{sts[0]['metrics']['loss']:.6f}, moe_aux {sts[0]['metrics']['moe_aux']:.6f}; "
                  f"against Q2's one-rank step: each layer's loads and dropped_frac equal: "
                  f"{loads} (dropped_frac " + ", ".join(f"{d:.6f}" for d in drops)
                  + f"); the selections equal: {picks}; router state equal: {same_rs}; "
                  f"{agree['text']}; launches a step on every rank flash_attention="
                  f"{MOE_DP_LAYERS} flash_attention_bwd={MOE_DP_LAYERS} [{card}]")
            check(loads and picks and same_rs, f"{label}: loads, dropped_frac, selections or "
                                               "router state differ from the one-rank step")
            hold_tp_agreement(label, agree)
            if route == "b":  # cap >= N: nothing can drop
                check(max(drops) == 0.0, f"{label}: dropped_frac {drops}")
            print(f"  {label} {step_walls(sts)}; Q2's one rank without a mesh "
                  f"{refs[route]['wall_s'] * 1e3:.2f} ms; the rank's set-up "
                  f"{outs[0]['setup_s']:.1f} s [{card}]")
            launches[f"{label} {(n_data, n_model)}"] = {
                k: sts[0]["launches"][k] for k in ("flash_attention", "flash_attention_bwd")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"  phase S {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: {step: n[k] for step, n in launches.items()}
            for k in ("flash_attention", "flash_attention_bwd")}


# ---------------------------------------------------------------------------
# phase T: tensor-parallel training of the vision_stub and encoder configs (make_train_step on
# a "model" axis above 1 for internvl2-1b and hubert-xlarge: the patches and the frame
# embeddings whole on every model rank, the gelu MLP cut, the patch labels masked in the loss)
# ---------------------------------------------------------------------------

# each config at full width cut to FRONTEND_TP_LAYERS layers, f32, one step on a global batch
# of FRONTEND_TP_B x FRONTEND_TP_S (internvl2-1b's first 256 positions patches, their labels
# -1): T1 one rank without a mesh in this process for each config, the reference; four gloo
# ranks sharing the card in phase N's world after phase S: T2 internvl2-1b on (1, 2) (ranks 2
# and 3 off the mesh), T3 hubert-xlarge on (1, 4) and on (2, 2) with ZeRO-1 moments over both
# axes; no (2, 2) mesh for internvl2-1b, whose whole embedding and head (151655 x 896 each: the
# vocabulary is odd) would be summed over "data" through gloo
FRONTEND_TP_LAYERS, FRONTEND_TP_B, FRONTEND_TP_S, FRONTEND_TP_TIMEOUT_S = 2, 4, 512, 240
FRONTEND_TP_STEPS = {"T2": ("internvl2_1b", (1, 2)), "T3 (1, 4)": ("hubert_xlarge", (1, 4)),
                     "T3 (2, 2)": ("hubert_xlarge", (2, 2))}


def frontend_tp_cfg(arch):
    from repro_torch.configs import get_config

    return get_config(arch).with_(n_layers=FRONTEND_TP_LAYERS, param_dtype="float32",
                                  compute_dtype="float32")


def frontend_tp_batch(cfg, device):
    """``dp_batch``'s global batch of ``FRONTEND_TP_B`` x ``FRONTEND_TP_S``,
    a ``vision_stub`` batch's labels at the patch positions -1 (the loss
    masks them)."""
    batch = dp_batch(cfg, FRONTEND_TP_B, device, FRONTEND_TP_S)
    if "patches" in batch:
        batch["labels"][:, :batch["patches"].shape[1]] = -1
    return batch


def frontend_tp_kernel_checks(card, cuda):
    """Kernels 5 and 5b alone at each T mesh's per-rank shapes (the rank's
    rows, its n_heads/m query heads and n_kv_heads/m kv heads, S =
    ``FRONTEND_TP_S``; causal for internvl2-1b, bidirectional for
    hubert-xlarge; f32: the SIMT routes) against their plain versions on
    the card (:func:`rank_attention_checks`)."""
    for label, (arch, (n_data, n_model)) in FRONTEND_TP_STEPS.items():
        cfg = frontend_tp_cfg(arch)
        check(cfg.n_kv_heads % n_model == 0, f"{label}: the kv heads do not divide")
        B, D = FRONTEND_TP_B // n_data, cfg.resolved_head_dim
        Hq, Hkv = cfg.n_heads // n_model, cfg.n_kv_heads // n_model
        rank_attention_checks(card, cuda, f"{label} kernels at a rank's shapes ({cfg.name}: B "
                              f"{B}, {Hq}/{Hkv} heads of {D}, S {FRONTEND_TP_S}, "
                              f"{'causal' if cfg.causal else 'bidirectional'}, f32)",
                              B, Hq, Hkv, D, FRONTEND_TP_S, cfg.causal)


def frontend_tp_reference(card, cuda, tmp):
    """T1: for each config of ``FRONTEND_TP_STEPS``, the one-rank f32 step
    without a mesh on the card from the seed and global batch T2's and T3's
    ranks use; writes the parameters and the first moments after it to
    ``tmp/frontend_<arch>.pt`` for the ranks. Returns its stats by arch."""
    import torch

    out = {}
    for arch in dict.fromkeys(a for a, _ in FRONTEND_TP_STEPS.values()):
        cfg, tcfg = frontend_tp_cfg(arch), dp_tcfg()
        state, step = dp_stepper(cfg, tcfg, None, cuda)
        batch = frontend_tp_batch(cfg, cuda)
        n_tok = int((batch["labels"] >= 0).sum())
        state, st = timed_step(step, state, batch)
        torch.save({"params": {n: p.detach().cpu() for n, p in
                               state["params"].named_parameters()},
                    "m": {n: t.cpu() for n, t in state["opt"]["m"].items()},
                    "lr": st["metrics"]["lr"]}, Path(tmp) / f"frontend_{arch}.pt")
        n_params = sum(p.numel() for p in state["params"].parameters())
        want = dict(ZERO_COUNTS, flash_attention=FRONTEND_TP_LAYERS,
                    flash_attention_bwd=FRONTEND_TP_LAYERS)
        check(st["launches"] == want, f"T1 {cfg.name} launches {st['launches']}")
        check(np.isfinite(st["metrics"]["loss"]) and np.isfinite(st["metrics"]["grad_norm"])
              and st["metrics"]["ntok"] == n_tok, f"T1 {cfg.name}: metrics {st['metrics']}")
        print(f"T1 one rank, {cfg.name} d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
              f"heads of {cfg.resolved_head_dim}, d_ff {cfg.d_ff} ({cfg.mlp_type}), vocab "
              f"{cfg.vocab_size}, {FRONTEND_TP_LAYERS} layers f32 "
              f"({'causal' if cfg.causal else 'bidirectional'}), {n_params} parameters, global "
              f"batch {FRONTEND_TP_B} x {FRONTEND_TP_S}"
              + (f" ({batch['patches'].shape[1]} patch positions, labels -1)"
                 if "patches" in batch else " (frame embeddings)")
              + f": step wall {st['wall_s'] * 1e3:.2f} ms, loss {st['metrics']['loss']:.6f}, "
              f"grad norm {st['metrics']['grad_norm']:.6f}, ntok {n_tok}; launches "
              f"flash_attention={FRONTEND_TP_LAYERS} flash_attention_bwd={FRONTEND_TP_LAYERS} "
              f"[{card}]")
        out[arch] = st
        del state, step, batch
        torch.cuda.empty_cache()
    return out


def t_rank(tmp, device):
    """One rank of T2 and T3: for each step of ``FRONTEND_TP_STEPS``, the
    state cut to this rank's blocks (``dp_stepper``), one step timed and
    counted with its collectives' seconds by tag and, on a member of the
    mesh, the gaps against T1 (``dp_gaps``) and the fingerprints of this
    rank's leaves; and the rank's seconds in phase T."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import train_loop as ptl

    t_all = time.perf_counter()
    out = {}
    for label, (arch, shape) in FRONTEND_TP_STEPS.items():
        t0 = time.perf_counter()
        cfg, tcfg = frontend_tp_cfg(arch), dp_tcfg()
        mesh = make_host_mesh(*shape)
        held = ptl.state_shardings(cfg, mesh, tcfg)
        state, step = dp_stepper(cfg, tcfg, mesh, device)
        batch = frontend_tp_batch(cfg, device)
        r = dict(setup_s=time.perf_counter() - t0, member=mesh.member)
        state, r["step"] = timed_step(step, state, batch)
        if mesh.member:
            r["coords"] = (mesh.axis("data").index, mesh.axis("model").index)
            r["gaps"] = dp_gaps(state, Path(tmp) / f"frontend_{arch}.pt", held, tcfg.opt.b1,
                                device)
            r["prints"] = leaf_prints(state)
            r["model_cut"] = model_cut_keys(held)
        r["wall_s"] = time.perf_counter() - t0
        out[label] = r
        del state, step
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_all
    return out


def frontend_tp_prepare(card, cuda):
    """Phase T's parts in this process before the world of ranks: kernels 5
    and 5b at T's per-rank shapes, and T1 in a temporary directory.
    Returns (the directory, T1's stats by arch)."""
    t0 = time.perf_counter()
    frontend_tp_kernel_checks(card, cuda)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_frontend_tp_")
    ref = frontend_tp_reference(card, cuda, tmp)
    print(f"  T's kernel checks and T1 {time.perf_counter() - t0:.1f} s [{card}]")
    return tmp, ref


def frontend_tp_world_calls(cuda, prepared):
    """T2's and T3's call for each rank of a world of ``DP_RANKS`` gloo ranks
    sharing the card (``spawn_world(call_each, ...)``)."""
    return [(t_rank, (prepared[0], str(cuda)), {})]


def frontend_tp_train_path(card, cuda, prepared=None, world=None):
    """Phase T, tensor-parallel training of the ``vision_stub`` and encoder
    configs (``make_train_step`` on a ``"model"`` axis above 1): kernels 5
    and 5b at the ranks' shapes and T1 (:func:`frontend_tp_prepare`); four
    gloo ranks sharing the card, each config at full width,
    ``FRONTEND_TP_LAYERS`` layers, f32, one step of each of
    ``FRONTEND_TP_STEPS`` on T1's global batch: on every member rank loss
    and grad norm within rel 1e-5 of T1, ``ntok`` T1's (the token labels
    alone), the parameters (the rank's blocks) within the ``_param_bound``
    rule and their largest gap over scale, the moment blocks within
    ``TP_MOMENT_TOL`` of scale, every replicated parameter the same on every
    member and every moment block of a leaf that "model" does not cut the
    same on a data row's model ranks, kernels 5 and 5b once per layer a step
    on the rank's heads; every rank's metrics the same (the ranks off the
    mesh take rank 0's, and launch nothing); the step walls, the
    collectives' seconds and elements by tag and the ranks' seconds in the
    phase. ``prepared``: :func:`frontend_tp_prepare`'s result, ``world``:
    each rank's results of :func:`frontend_tp_world_calls` where another
    phase's world ran them (phase N's, in a whole run); else they run here.
    Callable alone after ``card_setup`` and ``build_kernels`` (kernels 5
    and 5b). Returns rank 0's launches of kernels 5 and 5b a step, by
    step."""
    import shutil

    from repro_torch.distributed import call_each, spawn_world

    t_phase = time.perf_counter()
    if prepared is None:
        prepared = frontend_tp_prepare(card, cuda)
    tmp, refs = prepared
    try:
        if world is None:
            t0 = time.perf_counter()
            world = spawn_world(call_each, DP_RANKS, "gloo", FRONTEND_TP_TIMEOUT_S,
                                (frontend_tp_world_calls(cuda, prepared),))
            print(f"  T2 and T3 in a world of their own, {time.perf_counter() - t0:.1f} s "
                  f"[{card}]")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tt = [w[0] for w in world]
    want = dict(ZERO_COUNTS, flash_attention=FRONTEND_TP_LAYERS,
                flash_attention_bwd=FRONTEND_TP_LAYERS)
    launches = {}
    for label, (arch, (n_data, n_model)) in FRONTEND_TP_STEPS.items():
        cfg, ref = frontend_tp_cfg(arch), refs[arch]
        outs = [out[label] for out in tt]
        members = [out for out in outs if out["member"]]
        check(len(members) == n_data * n_model and all(o["member"] for o in outs[:len(members)]),
              f"{label}: members {[o['member'] for o in outs]}")
        for r, out in enumerate(outs):
            st = out["step"]
            check(st["launches"] == (want if out["member"] else ZERO_COUNTS),
                  f"{label} rank {r}: launches {st['launches']}")
            check(st["metrics"] == outs[0]["step"]["metrics"],
                  f"{label}: rank {r}'s metrics differ from rank 0's")
        ntok = outs[0]["step"]["metrics"]["ntok"]
        agree = tp_agreement(members, ref["metrics"])
        vocab = (f"vocab {cfg.vocab_size // n_model} of {cfg.vocab_size}"
                 if cfg.vocab_size % n_model == 0 else f"the vocabulary of {cfg.vocab_size} whole")
        sts = [out["step"] for out in members]
        print(f"{label} {DP_RANKS} gloo ranks on the card, ({n_data}, {n_model}) mesh"
              + (f" (ranks {len(members)}-{DP_RANKS - 1} off it)" if len(members) < DP_RANKS
                 else "")
              + f", {cfg.name} {FRONTEND_TP_LAYERS} layers f32 (a rank: "
              f"{cfg.n_heads // n_model}/{cfg.n_kv_heads // n_model} heads, d_ff "
              f"{cfg.d_ff // n_model}, {vocab}; {FRONTEND_TP_B // n_data} rows), ZeRO-1 moments, "
              f"grad_specs: loss {sts[0]['metrics']['loss']:.6f}, ntok {ntok:.0f} (T1 "
              f"{ref['metrics']['ntok']:.0f}); against T1: {agree['text']}; launches a step on "
              f"every member flash_attention={FRONTEND_TP_LAYERS} "
              f"flash_attention_bwd={FRONTEND_TP_LAYERS} [{card}]")
        check(ntok == ref["metrics"]["ntok"], f"{label}: ntok {ntok}")
        hold_tp_agreement(label, agree)
        print(f"  {label} {step_walls(sts)} (the members); T1 {ref['wall_s'] * 1e3:.2f} ms; the "
              f"rank's set-up {outs[0]['setup_s']:.1f} s [{card}]")
        launches[f"{label.split()[0]} {cfg.name} {(n_data, n_model)}"] = {
            k: sts[0]["launches"][k] for k in ("flash_attention", "flash_attention_bwd")}
    print(f"  T2 and T3 on the ranks: " + ", ".join(f"{out['phase_s']:.1f}" for out in tt)
          + f" s (the phase's share of the world) [{card}]")
    print(f"  phase T {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {k: {step: n[k] for step, n in launches.items()}
            for k in ("flash_attention", "flash_attention_bwd")}


def slot_kernel(card, cuda):
    """Section 2: the slot kernel against its plain version on the card: the
    dyadic system bitwise (potus, shuffle, jsq; K=1 and 8), the I=16384
    fleet's metrics and two runs, and one call at the main path's shapes,
    held bitwise and timed. Returns the fleet, its constants, streams and
    mid-run state, and the kernel's row of the kernels line (its
    ``launches`` filled in by :func:`main_path`)."""
    import torch

    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf
    from repro_torch.kernels import potus_slot as ps

    T_d, W_d, AC_d = 40, 2, 16
    topo, net, placement, arr = dyadic_system(pt, T_d, W_d)
    for sched in ("potus", "shuffle", "jsq"):
        consts, state, streams = step_inputs(cf, topo, net, placement, arr, T_d, W_d, 2.0, 0.5,
                                             AC_d, cuda)
        sp, mp = run_slots(ps.potus_slot_step_plain, consts, state, streams, 1, sched, AC_d)
        for K in (1, 8):
            sk, mk = run_slots(ps.potus_slot_call, consts, state, streams, K, sched, AC_d)
            torch.cuda.synchronize()
            err = max_abs(sk, mk, sp, mp)
            same = all(torch.equal(x, y) for x, y in zip(sk, sp)) and torch.equal(mk, mp)
            print(f"dyadic {sched} K={K}: kernel vs plain max_abs_err={err} bitwise={same}")
            check(same, f"dyadic {sched} K={K}: kernel differs from the plain version")

    fleet, consts, state0, streams = fleet_inputs(pt, cf, cuda)
    sp, mp = run_slots(ps.potus_slot_step_plain, consts, state0, streams, 1, "potus",
                       FLEET_AGE_CAP)
    mp = mp.cpu().numpy()
    for K in (1, 8):
        sk, mk = run_slots(ps.potus_slot_call, consts, state0, streams, K, "potus",
                           FLEET_AGE_CAP)
        sk2, mk2 = run_slots(ps.potus_slot_call, consts, state0, streams, K, "potus",
                             FLEET_AGE_CAP)
        torch.cuda.synchronize()
        repeat = all(torch.equal(x, y) for x, y in zip(sk, sk2)) and torch.equal(mk, mk2)
        mk = mk.cpu().numpy()
        r16 = max(rel_diff(mk[q, :16], mp[q, :16]) for q in (0, 1))
        means = [rel_diff(mk[q].mean(), mp[q].mean()) for q in (0, 1)]
        print(f"fleet potus K={K} T={FLEET_T}: backlog/cost rel diff first 16 slots {r16:.3e}, "
              f"means {means[0]:.3e}/{means[1]:.3e}, repeat bitwise={repeat}")
        check(r16 <= 1e-4, "fleet: per-slot backlog/cost beyond rtol 1e-4 in the first 16 slots")
        check(max(means) <= 0.02, "fleet: long-run means differ by more than 2%")
        check(repeat, "fleet: two kernel runs differ")

    # one call at the main path's shapes, from a mid-run state
    mid = fleet_mid(ps, consts, state0, streams)
    one = tuple(x[64:65] for x in streams)
    args = (consts, mid, *one, 64)
    kw = dict(scheduler="potus", age_cap=FLEET_AGE_CAP, n_slots=1)
    s_k, m_k = ps.potus_slot_call(*args, **kw)
    s_p, m_p = ps.potus_slot_step_plain(*args, **kw)
    one_err = max_abs(s_k, torch.stack(m_k), s_p, torch.stack(m_p))
    # every output (state and metrics) bitwise, as on every run so far at these shapes
    check(one_err == 0.0, f"one call at I={FLEET_I}: kernel vs plain max_abs_err={one_err}")
    slot_parts = {}
    ms_kernel = device_ms(lambda: ps.potus_slot_call(*args, **kw), 50, parts=slot_parts)
    event_ms = time_calls(lambda: ps.potus_slot_call(*args, **kw), 50)
    ms_plain = time_calls(lambda: ps.potus_slot_step_plain(*args, **kw), 10)
    nbytes, nops = bytes_and_ops(consts, mid, 1)
    bound_ms = max(nbytes / PEAK_BYTES_S, nops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S >= nops / PEAK_F32_S else "operations"
    print(f"one call at I={FLEET_I}: max_abs_err={one_err:.3e} device ms per call: kernel "
          f"{ms_kernel:.4f}; event ms per call: kernel {event_ms:.4f}, plain {ms_plain:.4f}; "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} bytes, {nops} ops) [{card}]")
    for name, ms in sorted(slot_parts.items(), key=lambda r: -r[1]):
        print(f"  part {name[:60]}: {ms:.4f} ms per call")
    row = {"name": "potus_slot", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/potus_slot.cu",
           "replaces": "src/repro/kernels/potus_slot.py:57", "launches": None,
           "max_abs_err": one_err, "ms": ms_kernel, "event_ms": event_ms, "plain_ms": ms_plain,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return SimpleNamespace(fleet=fleet, consts=consts, streams=streams, mid=mid, row=row)


def main_path(fleet, card):
    """Section 3: main path 1, ``simulate`` on the I=16384 fleet through the
    cohort-fused engine's slot kernel: launches counted (one per slot), two
    runs bitwise, the result finite, wall ms/slot over five runs and a
    profiled run's device busy share. Returns the kernel's launches."""
    import torch

    import repro_torch.core as pt

    topo, net, placement, arr = fleet
    spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=FLEET_T,
                         scheduler="potus", V=FLEET_V, window=FLEET_W,
                         age_cap=FLEET_AGE_CAP, device="cuda")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = pt.simulate(spec)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n = read_counts()
    main_launches = n["potus_slot"]
    print(f"main path: potus I={FLEET_I} T={FLEET_T} launches={main_launches} (" + " ".join(
        f"{k}={v}" for k, v in n.items()) + ")")
    check(n == dict(ZERO_COUNTS, potus_slot=FLEET_T), f"main path launches {n}")
    walls = [wall_ms]
    res2 = pt.simulate(spec)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt.simulate(spec)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    same = same_result(res1, res2)
    print(f"  two runs bitwise identical: {same}")
    check(same, "main path: two runs differ")
    check(np.isfinite(res1.backlog).all() and np.isfinite(res1.comm_cost).all()
          and res1.backlog.shape == (FLEET_T,) and np.isfinite(res1.avg_response)
          and res1.completed_mass > 0, "main path: result not finite or of the wrong shape")
    per_slot = np.array(walls) / FLEET_T
    print(f"  wall ms/slot over {len(walls)} runs: median {np.median(per_slot):.4f}, "
          f"min {per_slot.min():.4f}, max {per_slot.max():.4f} [{card}]")
    print(f"  first run {wall_ms / FLEET_T:.4f} ms/slot, avg_backlog={res1.avg_backlog!r} "
          f"avg_cost={res1.avg_cost!r} avg_response={res1.avg_response!r} "
          f"completed_mass={res1.completed_mass!r} saturated_frac={res1.saturated_frac!r} "
          f"[{card}]")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pt.simulate(spec)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    rows = device_times(prof)
    busy_ms = sum(r[2] for r in rows)
    if busy_ms > 0:
        print(f"  device busy {busy_ms:.3f} ms of {prof_ms:.3f} ms wall: "
              f"share {busy_ms / prof_ms:.4f} (profiled run)")
        for name, count, ms in rows[:8]:
            print(f"    {ms:10.3f} ms  x{count:<6d} {name[:90]}")
    else:
        print("  device busy share: not measured (the profiler saw no device time)")
    return main_launches


def card_setup():
    """TF32 off for cuBLAS and cuDNN; prints and returns the card's name and
    power limit (``nvidia-smi``) and the device. A section called alone
    (``slot_kernel``, ``main_path``, ``drain_kernel``, ``ssm_path``,
    ``sweep_path``, ``obs_path``, ``oracle_path``, ``moe_path``,
    ``training_path``, ``sharded_path``, ``moe_ep_path``,
    ``dp_train_path``, ``moe_train_path``, ``tp_train_path``,
    ``moe_tp_train_path``, ``frontend_tp_train_path``) starts with this and
    :func:`build_kernels`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card, torch.device("cuda")


def build_kernels(names=KERNELS):
    """One ``nvcc`` per ``csrc/<kernel>.cu``, all started together."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    print("kernel build: " + ", ".join(f"{k} {_build.BUILD_SECONDS[k]:.2f} s" for k in names)
          + f" (wall {time.perf_counter() - t0:.2f} s, in parallel)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch.core as pt
    from repro_torch.core import cohort_fused as cf

    # -- 1. the card ---------------------------------------------------------
    card, cuda = card_setup()
    build_kernels()
    return run_phases(pt, cf, card, cuda)


def run_phases(pt, cf, card, cuda) -> int:
    """Every phase in order, then the kernels line and the last line."""
    import torch

    # -- 2. kernel against plain version on the card, 3. the main path ----------
    slot = slot_kernel(card, cuda)
    slot.row["launches"] = main_path(slot.fleet, card)

    for sched in ("potus", "shuffle", "jsq"):
        compare_cohort("fleet", cf, pt, slot.fleet, FLEET_T,
                       pt.SimConfig(V=FLEET_V, window=FLEET_W, scheduler=sched), cuda,
                       age_cap=FLEET_AGE_CAP)
    compare_cohort("paper", cf, pt, paper_system(pt, 300), 300,
                   pt.SimConfig(V=2.0, window=2, scheduler="potus"), cuda, age_cap=64)

    # -- 4. the fused cohort engine's dense route and events route: phases A-F ------
    drain_kernel = cohort_dense(pt, card, cuda, slot.fleet, slot.consts, slot.mid, slot.streams)

    # -- 5. the plain scan engine: kernels 2 and 3, main path 2 --------------------
    scan_kernels = scan_engine(pt, card, cuda)

    # -- 6. phase G: the serving path, kernels 5 and 6 ------------------------------
    attention_kernels = serving_path(card, cuda)

    # -- 7. phase H: the SSM and hybrid models, kernel 7 ----------------------------
    ssd_kernel = ssm_path(card, cuda)

    # -- 8. phase I: scenario sweeps, kernel 1 batched over the scenarios --------------
    t_phase = time.perf_counter()
    slot.row["batched"] = sweep_path(card, cuda, slot.fleet)
    print(f"  phase I {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- 9. phase J: observability (kernels 2, 3, 4 with metrics on; J4 ran in phase G) ----
    t_phase = time.perf_counter()
    obs_path(card, cuda, slot.fleet)
    print(f"  phase J {time.perf_counter() - t_phase:.1f} s [{card}]")

    # -- 10. phase K: the host-loop oracles (kernels 2 and 3 once a slot) ---------------
    t_phase = time.perf_counter()
    oracle = oracle_path(card, cuda)
    print(f"  phase K {time.perf_counter() - t_phase:.1f} s [{card}]")
    for row in scan_kernels:
        row["cohort_launches"] = oracle[row["name"]]

    # -- 11. phase L: the MoE decoder (kernels 2, 5 and 6 on its served run) -----------
    moe = moe_path(card, cuda)
    for row in attention_kernels:
        row["moe_launches"] = moe[row["name"]]

    # -- 12. phase M: training (kernels 5 and 5b on every attention layer) ------------
    bwd_kernel, flash_train = training_path(card, cuda)
    attention_kernels[0].update(flash_train)

    # -- 13. phase P's and phase Q's parts in this process: P1 and Q1 (one NCCL rank), P2's
    # and Q2's one-rank references, before the world of ranks ----------------------------
    t_phase = time.perf_counter()
    dp_prepared = dp_prepare(card, cuda)
    print(f"  P1 and P2's reference {time.perf_counter() - t_phase:.1f} s [{card}]")
    t_phase = time.perf_counter()
    moe_prepared = moe_prepare(card, cuda)
    print(f"  Q1 and Q2's references {time.perf_counter() - t_phase:.1f} s [{card}]")
    tp_prepared = tp_prepare(card, cuda)
    frontend_prepared = frontend_tp_prepare(card, cuda)

    # -- 14. phase N: the instance-sharded engines (kernel 1 on one rank); its world of
    # four gloo ranks then runs phase O's O2 and O3, phase P's P2 and P3, phase Q's Q2,
    # phase R's R2 and R3, phase S and phase T's T2 and T3 (one start-up for all) -------------
    slot.row["sharded_launches"], world = sharded_path(
        card, cuda, slot.fleet, also=ep_world_calls(cuda) + dp_world_calls(cuda, dp_prepared)
        + moe_world_calls(cuda, moe_prepared) + tp_world_calls(cuda, tp_prepared)
        + moe_tp_world_calls(cuda, moe_prepared)
        + frontend_tp_world_calls(cuda, frontend_prepared),
        also_timeout_s=EP_TIMEOUT_S + DP_TIMEOUT_S + MOE_DP_TIMEOUT_S + TP_TIMEOUT_S
        + MOE_TP_TIMEOUT_S + FRONTEND_TP_TIMEOUT_S)

    # -- 15. phase O: expert-parallel MoE serving (kernels 2, 5 and 6 on every rank) ----
    ep = moe_ep_path(card, cuda, world=[out[:2] for out in world])
    for row in (*scan_kernels, *attention_kernels):
        if row["name"] in ("potus_schedule", "flash_attention", "decode_attention"):
            row["ep_launches"] = ep[row["name"]]

    # -- 16. phase P: data-parallel training (kernels 5 and 5b on every rank) -----------
    dp = dp_train_path(card, cuda, dp_prepared, world=[out[2:] for out in world])
    attention_kernels[0]["dp_launches"] = dp["flash_attention"]
    attention_kernels[0]["pipeline_launches"] = dp["pipeline"]
    bwd_kernel["dp_launches"] = dp["flash_attention_bwd"]

    # -- 17. phase Q: MoE training across ranks (kernels 5 and 5b on every rank) --------
    moe_train = moe_train_path(card, cuda, moe_prepared, world=[out[4:] for out in world],
                               keep_refs=True)
    for row, name in ((attention_kernels[0], "flash_attention"),
                      (bwd_kernel, "flash_attention_bwd")):
        row["moe_train_launches"] = moe_train[name]["train"]
        row["moe_dp_launches"] = moe_train[name]["dp"]

    # -- 18. phase R: tensor-parallel training (kernels 5 and 5b on every rank's heads) ----
    tp = tp_train_path(card, cuda, tp_prepared, world=[out[5:] for out in world])
    for row, name in ((attention_kernels[0], "flash_attention"),
                      (bwd_kernel, "flash_attention_bwd")):
        row["tp_launches"] = tp[name]

    # -- 19. phase S: tensor-parallel MoE training (kernels 5 and 5b on every rank's heads) --
    moe_tp = moe_tp_train_path(card, cuda, moe_prepared, world=[out[6:] for out in world])
    for row, name in ((attention_kernels[0], "flash_attention"),
                      (bwd_kernel, "flash_attention_bwd")):
        row["moe_tp_launches"] = moe_tp[name]

    # -- 20. phase T: tensor-parallel training of the vision_stub and encoder configs
    # (kernels 5 and 5b on every member rank's heads) ---------------------------------------
    frontend_tp = frontend_tp_train_path(card, cuda, frontend_prepared,
                                         world=[out[7:] for out in world])
    for row, name in ((attention_kernels[0], "flash_attention"),
                      (bwd_kernel, "flash_attention_bwd")):
        row["frontend_tp_launches"] = frontend_tp[name]

    # -- 21. the kernels line, 22. the last line ---------------------------------
    print(json.dumps({"kernels": [slot.row, *scan_kernels, drain_kernel, *attention_kernels,
                                  ssd_kernel, bwd_kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
