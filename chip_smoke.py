#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths on the card at full width:

* the paper's predictor behind ``ForestEngine`` and ``MultiDeviceEngine``:
  512-tree extra-trees forests fitted on the committed 82-kernel x 4-size
  suite dataset (``tests/fixtures/suite_dataset_v1.json``), served at dense
  depth 10;
* the LM framework's zamba2-2.7b (54 Mamba2 layers, d_model 2560, the
  shared attention block every 6 layers; random weights from a seeded
  ``torch.Generator``) serving 4 prompts of 512 tokens and 32 greedy decode
  steps through ``repro_torch.launch.serve.generate``;
* the same model trained through ``repro_torch.launch.train`` with its
  defaults (the reference's: strategy 2d, model axis 1, so a 1 x 1
  ("data", "model") DeviceMesh of one NCCL rank, every parameter a
  DTensor, the kernels on local shards): 4 AdamW steps of 4 x 1024 tokens
  in 2 microbatches, bf16 activations over f32 parameters and moments,
  activation checkpointing as configured;
* smollm-360m, the launchers' default, served (4 x 512 prompts, 32 tokens)
  and trained (4 steps of 8 x 1024 tokens) at full width and depth, and
  the MoE, VLM, xLSTM and enc-dec families at full width with depth cut.

Phases, one JSON line each:

  env          torch / CUDA versions, the card, its power limit
  build        nvcc of ``src/repro_torch/csrc/{forest,ssd,flash_attn}.cu``,
               all started together, their -Xptxas -v lines, and each
               kernel's tensor-core instructions (HMMA / HGMMA in
               ``cuobjdump --dump-sass``); the bf16 kernels must have some
  fit          the forests, fitted on the host
  kernel       the forest kernel against its plain torch version (``ref.py``)
               on the same CUDA tensors, tables packed once per depth:
               depth {2,5,8,10} on the 512-tree forest and {11,12,14} (the
               neighbours of the shared-memory / L2 level split, and the
               reference's deepest) on a 22-tree one, x batch
               {1,7,64,328,4096}, rtol 1e-5 / atol 1e-6, bitwise
               repeatable, a row's bits independent of its batch
  serve        ForestEngine on the card (backend "hopper"): batched predict,
               a burst of async singles, cache hits, a hot-swap, then
               MultiDeviceEngine pricing and scheduling; answers held to the
               plain CPU dense path; launch counter read around the run
  timing       forest kernel (tables packed once), plain-version, backend
               (``engine._predict_fn``: copies, kernel, sync) and engine
               times at B = 64 / 328 / 4096, beside the least time the card
               could take (the bound)
  frontend_*   the pipeline's front end (``repro_torch.workloads.suite``,
               ``repro_torch.core.features``): the suite's 328 workloads run
               once on the card, each held to the same function on host
               copies of its inputs (frontend_run); the features of each,
               exported with inputs on the card and on the host in worker
               processes, equal (frontend_extract); io_bytes and the dense
               kernels' flops held to the fixture, the rank correlation of
               each feature with it (frontend_parity); the port's feature
               rows served through B1 by each device's forest, held to the
               plain CPU dense path, launches counted, the median APE
               against the fixture's targets beside the same forest's on
               the fixture's rows (frontend_serve)
  ground_truth the pipeline's ground truth (``workloads/collect.py``): the
               suite's 246 workloads at sizes s, m and l timed on the card
               (a warm-up call, then the median and CoV of 5 timed calls,
               by CUDA events) beside the simulated TPUs' targets; every
               card time finite and positive, no dynamo compile inside
               the timed calls, the simulated targets replayed bit for bit
               from a fresh rng, the features equal to frontend_extract's
  ground_truth_serve  a 512-tree forest fitted on the log of the card's
               times, served through B1 on the 246 rows, held to the plain
               CPU dense path, launches counted, in-sample median APE
  stream_refresh  the suite at s measured on a collector thread into a
               ``DatasetStore`` while an ``EngineRefresher`` refits a
               32-tree forest and hot-swaps it into a live engine on the
               card, a reader thread predicting all the while: no error,
               at least 2 refreshes, every answered batch one generation's
               whole answer, B1 launches counted, the engine after the
               stream equal to a refit of the last snapshot, the streamed
               features equal to ground_truth's
  sharded      the 512-tree forest behind ``ShardedForestEngine`` on the card
               (the loop placement): 1, 2, 3, 4 and 8 shards at B = 64 / 328
               / 4096, held to the plain CPU dense path, one launch per live
               shard per call; shard 0 and then shard 2 of 3 dropped, held to
               the plain path over the surviving trees with shard_drops /
               trees_lost, a swap restoring all 512; the 22-tree forest in
               22 one-tree shards and in 7; engine ms per shard count at
               B = 4096 beside the unsharded engine's
  cluster      ``python -m repro_torch.cluster --port 0 --trees 64
               --n-features 12`` as a subprocess on the card (startup time,
               no rebuild of the forest library): a v3 and a v2-pinned
               ``RemoteReplica`` held to the in-process twin's plain CPU
               dense path, ``op='metrics'`` and the Prometheus endpoint
               holding the reference's per-layer names; the golden trace
               (``tests/fixtures/trace_golden_v1.jsonl``) replayed in process
               through ``demo_frontend(seed=3, n_features=12)`` on the card
               and on the host, every event's outcome the same and every
               prediction within rtol 1e-5, the host's digest reported
  supervise    ``serve/supervise.py::smoke()`` on the card, then its scenario
               (day-zero transfer tier, measured feedback, graduation) with
               a ``MultiDeviceEngine`` that graduation extends by
               ``add_device``: the graduated engine held to the plain CPU
               dense path of its forest, launches held to engine batches,
               the simulator's MAPE at day zero, plateau and graduation
  ground_truth_cv  nested CV (``core/cv.py``, the reference's fast grid) on
               the card's times and on tpu-v5e's simulated times, in a
               worker process beside the LM phases (reported, not held)
  ssd_kernel   the SSD kernel against its plain version (``ssd_chunked``) on
               the same CUDA tensors at 80 heads of 64, state 64: (Bsz, S) in
               {(1,1), (1,100), (1,500), (4,512), (2,2048)}, f32 and bf16, one
               case with h0, two with B/C strided as the model passes them
               (the serving and the training shape); bitwise repeatable
  lm_serve     zamba2-2.7b: generate() on the card, its SSD launches counted
               (54 per prefill), then every layer's SSD call held in place to
               the plain version in bf16 and in f32 (``kernels.watch``), and
               the whole f32 prefill's logits and caches to the plain chunked
               path (use_pallas=False)
  lm_timing    prefill and decode times of the served model; the SSD kernel
               at the serving shape (its three bf16 passes summed, and each)
               beside its plain version and its bound
  flash_kernel the flash-attention kernel against its plain version
               (``attention_ref``) on the same CUDA tensors: the reference's
               five test shapes and its bf16 case, zamba2's training shape,
               the model's (B, S, H, D) strides, masked keys and rows that
               see none, f32 and bf16; bitwise repeatable; the
               autograd.Function's gradients against the plain version's
  flash_lse    B2's row log-sum-exp (``return_lse``) against its plain
               version's on those shapes and on masked ones (a head dim of
               20, which the 16-byte stores do not take): -inf on exactly
               the rows that see no key, o unchanged by the option
  flash_split  the context-parallel merge (``models/attention.py``'s
               ``merge_partials``): zamba2's and smollm-360m's training
               shapes with the keys cut into 2, 4 and 16 shards, each
               launched with kv_offset = -start and its lse, merged and
               held to B2 over the whole keys, f32 and bf16, with the
               gradients through the merge held to the plain version's;
               the heaviest of smollm's 16 shard launches timed beside the
               whole launch
  lm_train     zamba2-2.7b trained through ``launch.train.main`` on the 1 x 1
               NCCL mesh (the process group NCCL, the mesh (1, 1), every
               parameter a DTensor on the card, asserted): both kernels'
               launches counted against the count the code implies (36
               attention and 324 SSD launches per step), the loss finite
               at every step; one more step on the mesh with every kernel
               call held in place to its plain version
  train_timing step time and tokens/s; one traced step (the card's busy
               share, the largest kernels); the flash kernel at the training
               shape beside its plain version, its bound and SDPA (timed as a
               yardstick only); the SSD kernel at the training shape (one
               microbatch, 2 x 1024) as in lm_timing
  lm_train_f32 one whole f32 step (batch 1 x 512) through the kernels: loss
               and gradient norm beside the plain path, a second correct
               order and two broken kernels (reported; PERF.md says why no
               limit holds them)
  lm_dense_serve  smollm-360m (32 layers, d_model 960, 15 heads over 5 KV
               heads of 64), the launchers' default, at full width: 4
               prompts of 512 tokens and 32 greedy tokens through
               generate(); no kernel launch (its serving attention is plain
               torch, as the reference's is jnp), tokens in range
  lm_dense_timing  its prefill ms (median of 3), decode ms per token and
               tokens/s; one prefill and one decode step traced
  lm_dense_train  smollm-360m trained through ``launch.train.main`` with the
               launcher's defaults (the 1 x 1 NCCL mesh, checked as in
               lm_train; 4 steps of 8 x 1024 tokens, 2 microbatches, groups
               of 8 layers checkpointed in their group's checkpoint): 184
               B2 launches per step asserted (the count
               ``train_launches_per_step`` derives), losses finite;
               one more step with every B2 call held in place; step ms,
               tokens/s, peak GB, a traced step; B2 at (4, 15, 5, 1024,
               1024, 64) beside its plain version, its bound and SDPA
  mesh_parity  the same 4 smollm-360m steps through ``run_training(mesh=None)``
               (plain tensors): losses held to the mesh run's within 2^-7,
               step by step (bitwise reported); step ms, tokens/s and peak GB
               of both paths side by side (DTensor's host cost); one f32 step
               (1 x 1024) on each path, held to DENSE_F32_REL if a
               non-causal fault through the mesh lands 5x above it
  loss_shards  fault F7's loss on the 1 x 1 NCCL mesh: ``cross_entropy_loss``
               on DTensor logits (``cross_entropy_on_shards``) beside the
               plain path on smollm-360m's f32 logits (8, 1024, 49152):
               loss and logits gradient held at rtol 1e-5 (bitwise
               reported); each one's peak allocation over its input and ms
  dp_compressed  ``train.grad.make_dp_grad_fn`` on NCCL at world size 1 over
               smollm-360m's loss (1 x 1024): the int8 + error-feedback
               gradients' relative error against the uncompressed ones
               (reported); the reference's convergence case (150 compressed
               steps, last loss under 1 % of the first), held
  lm_dense_train_f32  one whole f32 step of smollm-360m (1 x 1024) through
               B2 beside the plain path: B2 and its plain version held
               within DENSE_F32_REL on loss and gradient norm, a
               non-causal attention fault landing 5x above it
  lm_families  granite-moe-3b-a800m, qwen2-vl-7b, xlstm-125m and
               whisper-medium at full width with depth cut (2 layers; xlstm
               one group of 4; whisper 2 + 2): one prefill and 8 greedy
               steps through generate(), no kernel launch; one training step
               with B2 launches asserted (none for xlstm) and every B2 call
               held in place; logits and losses finite; xlstm-125m's
               prefill ms and training step s printed beside the parent
               commit's (XLSTM_PARENT: its recurrences stepped in Python
               loops, where they now run as scans)
  lm_families_mesh  the same four trained on the 1 x 1 NCCL mesh:
               whisper-medium and xlstm-125m whole through
               ``launch.train.main``, granite-moe-3b-a800m and qwen2-vl-7b
               at full width with lm_families' depth through
               ``run_training(mesh=make_host_mesh(1))``; NCCL, the mesh
               (1, 1) and DTensor parameters on the card asserted, B2
               launches asserted and every B2 call held in place; then the
               same steps on plain tensors, losses held within 2^-7 at
               every step (bitwise reported), step ms and peak GB of both

  roofline_calibration  (after the build) the cost counter
               (``core/hlo_analysis.py``) and the card's data-sheet
               constants (``launch/roofline.py``) against a bf16 8192^3
               matmul (2 N^3 FLOPs counted exactly) and a 4 GiB bf16 clone
               (twice its bytes counted exactly), each timed by CUDA events:
               bound / measured at most 1.05; ``HBM_PER_CHIP`` equal to the
               card's ``total_memory``
  roofline_step  (inside lm_dense_train) that phase's step counted on its
               real tensors on the 1 x 1 NCCL mesh (B2 counted as its plain
               version's FLOPs): the report's row, useful ratio, counted
               FLOPs beside ``model_flops_for``; the measured step ms (the
               median of steps 2-4) at least the bound; the counted peak
               within a factor 2 of ``max_memory_allocated``
  roofline_autotune  ``launch.train.main --autotune`` (smollm-360m, 2
               steps of 8 x 1024): the pick, trained, losses finite
  roofline_dryrun  ``python -m repro_torch.launch.dryrun`` on smollm-360m's
               ``train_4k`` cell at full width and depth on a fake
               pod16x16 under 2d, in a subprocess off the card started
               first and running beside every phase up to the CV worker's
               (read after lm_families_mesh): status ok, its row and
               seconds; its counted peak a rank under 4 GiB and
               ``fits_hbm`` held (fault F7), temporaries and collective
               bytes by op reported
  mesh_cells_host  fault F6's 28 training cells (``F6_CELLS``: every
               family's ``train_4k`` step at full width, depth cut as
               ``tests/_mesh_cells.py`` cuts it, on meta tensors over a
               fake process group of (2, 2), (2, 16) or (16, 16) ranks)
               run by this host's torch in spawned workers at a lower
               priority, started first and read after lm_families_mesh;
               each cell's status and seconds, the pool's seconds, the
               wait for it, the torch version; every cell must run. In the
               same pool, first, the three ``PEAK_CELLS`` (faults F9-F12):
               each cell's counted peak a rank on a fake (16, 16) mesh
               under 2d, held under its bound; then the six ``CAUSE_CELLS``
               (faults F14-F19): a serving cell of each repaired collective
               cause counted on a fake mesh, its collective bytes a rank
               held under 1.25x the reference's count of the same cell
               (written here: this host has no JAX); and ``POD_CELLS``,
               every family's cut ``train_4k`` step on a fake (2, 2, 2)
               ("pod", "data", "model") mesh under 2d; after the peak
               cells, the ``XLSTM_CELL`` (faults F27, F28): xlstm-125m's ``train_4k``
               step cut to one group of 4 layers on a fake (16, 16) mesh,
               its peak a rank counted and held under 1.15x the
               reference's count of the same cell, and its one-device
               step traced for the 12 features, which must hold ``scan``
               nodes (the recurrences unrolled took hours) and be finite;
               before it the nine ``CUT_CELLS`` (faults F24, F26): a
               ``prefill_32k`` cell of each cause the tally named, cut in
               depth, on fake (16, 16) and (2, 16, 16) meshes, and
               smollm-360m's whole ``train_4k`` on (2, 16, 16), each peak
               a rank held within 1.15x the reference's count of the same
               cell
  context_parallel_host  the context-parallel attention on 4 gloo ranks
               of the host under the host's torch (tests/_gloo.py's
               ``context_parallel`` world: reduced smollm-360m with 3 / 1
               heads, float64, under 2d, tp, zero3 and sp, ``attend_train``
               with its gradients and ``attend_prefill`` with its K/V held
               to one device at rtol 1e-9; the prefill's K keeps its
               sequence shard), in a subprocess at the cells' priority
               started first and read after them
  roofline     the four parts' numbers in one line

then a ``{"kernels": [...]}`` line (the forest kernel's entry counts its
launches on each path: ``launches`` in serve, then ``frontend_launches``,
``ground_truth_launches``, ``stream_launches``, ``sharded_launches``,
``cluster_launches`` and ``supervise_launches``; the flash-attention
entry's ``launches`` are zamba2's training run's, ``smollm_launches``
smollm-360m's, ``families_launches`` the depth-cut families' step's and
``families_mesh_launches`` their mesh runs',
with smollm's shape and times beside zamba2's; ``launch_path`` says that
the training launches come from the mesh path; ``lse_checks`` and
``split_checks`` count flash_lse's and flash_split's checks, with
``split_timing`` and each strategy's ``context_parallel_host`` distance
in units of its tolerance), the card's name and power
limit as nvidia-smi prints them, and ``{"ok": true, "device": {...}}`` last. Any
failed check raises and the script exits non-zero; without a CUDA device it
exits non-zero before printing any result. The kernels build into
``build/kernels/``.
"""
from __future__ import annotations

import contextlib
import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "fixtures" / "suite_dataset_v1.json"

N_TREES = 512            # the reference's paper profile (bench_latency.py)
DEPTH = 10               # EngineConfig.dense_depth
DEPTHS = (2, 5, 8, 10)
# the kernel keeps every level of a depth-11 tree in shared memory and the
# top 11 levels of a deeper one (kernels/forest/kernel.py::split_levels):
# both sides of that split, and the reference's deepest test, on a forest
# small enough for to_dense to stay quick, whose tree count leaves the last
# tree group ragged
DEEP_DEPTHS = (11, 12, 14)
DEEP_TREES = 22
BATCHES = (1, 7, 64, 328, 4096)
TIMED_BATCHES = (64, 328, 4096)
RTOL, ATOL = 1e-5, 1e-6
# NVIDIA's H100 SXM data sheet: the HBM rate, the fp32 rate outside the
# tensor cores (which the forest's compare/index/add work runs at), and the
# dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the LM serving path
LM_ARCH = "zamba2-2.7b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 32
SSD_CASES = ((1, 1), (1, 100), (1, 500), (4, 512), (2, 2048))
SSD_H, SSD_P, SSD_N = 80, 64, 64
SSD_F32_TOL = dict(rtol=2e-4, atol=2e-4)      # the reference's own
# bf16 inputs: both sides compute in f32 from the same bf16 values and round
# y to bf16 once, after sums taken in other orders, so y may differ by one
# bf16 ulp (2^-7 relative at most); h stays f32 and keeps the f32 tolerance
SSD_BF16_Y_TOL = dict(rtol=2 ** -7, atol=1e-3)
# prefill held to the plain chunked path, as shares of the largest value of
# each tensor. (1) In place, at each of the 54 layers: the kernel's y and h
# against the plain version's on the same inputs. The two take the cumsum of
# the log-decay in other orders; over a chunk it reaches a few hundred,
# where a float32 ulp is 1e-5-3e-5, and exp() carries that into y and h, so
# 1e-3; a bf16 y may also round one ulp apart (2^-7 of the largest value).
# (2) The whole f32 prefill over 54 layers: logits and every cache. With
# these random weights a difference grows about 1.6x per group of 6 layers,
# so two correct orders of the same sums end apart; the limit lies between
# that drift and where a broken scan lands, both measured by
# ``python -m repro_torch.launch.scan_drift`` (PERF.md). The whole bf16
# prefill is not held: there two correct orders no longer agree at all.
LM_LAYER_REL = {"bfloat16": (2 ** -7, 1e-3), "float32": (1e-3, 1e-3)}
LM_F32_REL = 0.1

# the flash-attention kernel: the reference's five shapes and its bf16 case
# (tests/test_kernels.py), zamba2's training shape (one microbatch of 2 x
# 1024 tokens, 32 heads of 80), at the reference's tolerances
FLASH_CASES = ((2, 4, 2, 64, 64, 32, True), (1, 2, 2, 33, 33, 16, True),
               (2, 8, 2, 17, 40, 8, False), (1, 4, 1, 128, 128, 64, True),
               (1, 2, 1, 16, 48, 8, True))
FLASH_BF16_CASE = (1, 2, 2, 32, 32, 16, True)
FLASH_TRAIN = (2, 32, 32, 1024, 1024, 80, True)
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
             "bfloat16": dict(rtol=0.08, atol=0.08)}
# B2's row log-sum-exp (``return_lse``) and the context-parallel merge
# (models/attention.py::merge_partials): lse held to the plain version's on
# FLASH_CASES, on rows that see no key (kv_offset < 0) and on a head dim
# the 16-byte stores do not take (D 20); then zamba2's and smollm-360m's
# training shapes with the keys cut into FLASH_SPLITS shards, each launched
# with its kv_offset, merged, and held to B2 over the whole keys, with the
# gradients through the merge held to the plain version's; the events time
# of the heaviest of smollm's 16 shard launches beside the whole launch
FLASH_LSE_MASKED = ((2, 4, 2, 96, 80, 64), (1, 3, 1, 50, 70, 20))
FLASH_SPLITS = (2, 4, 16)
FLASH_SPLIT_SHAPES = {"zamba2-2.7b": FLASH_TRAIN[:6],
                      "smollm-360m": (4, 15, 5, 1024, 1024, 64)}

# the other LM families (models/lm.py, moe.py, xlstm*.py, encdec.py): B2 at
# each family's training shape, one microbatch, causal, (B, Hq, Hkv, Sq,
# Skv, D) in the model's (B, S, H, D) layout
FLASH_MODEL_CASES = {"smollm-360m": (4, 15, 5, 1024, 1024, 64),
                     "granite-moe-3b-a800m": (2, 24, 8, 256, 256, 64),
                     "qwen2-vl-7b": (1, 28, 4, 512, 512, 128),
                     "whisper-medium": (2, 16, 16, 256, 256, 64)}
# smollm-360m, the launchers' default, at full width and depth: serving 4
# prompts of 512 tokens and 32 greedy tokens (plain attention, as the
# reference's jnp; no kernel), training 4 steps of 8 x 1024 tokens in the
# config's 2 microbatches (B2 for every causal attention), and one whole
# f32 step (batch 1 x 1024) beside the plain path
DENSE_ARCH = "smollm-360m"
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 512, 32
DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ, DENSE_TRAIN_STEPS = 8, 1024, 4
DENSE_F32_BATCH, DENSE_F32_SEQ = 1, 1024
# ... held to the plain path on loss and gradient norm, as shares of the
# plain path's: PERF.md's rule (3x the largest correct reading, kept only
# if the broken kernel lands 5x above it). The first run on an H100 (700
# W) read B2 1.73e-7 / 2.32e-5 and B2's plain version 8.7e-8 / 1.32e-5
# apart; the non-causal fault 1.74e-3 / 1.36e-2, 3,300x and 195x above
# these limits
DENSE_F32_REL = {"loss": 5.3e-7, "grad_norm": 7.0e-5}
# the mesh path (a 1 x 1 NCCL mesh, strategy 2d) beside the one-device
# path: the same 4 bf16 steps of smollm-360m, losses held step by step to
# one bf16 ulp (2^-7 relative); on a mesh of one both run the same local
# kernels in the same order, so the bits are expected equal (reported)
MESH_LOSS_REL = 2 ** -7
# where the training launches of B2 and B3 come from (the kernels line)
MESH_PATH = ("launch.train.main's defaults: the mesh path, a 1 x 1 "
             "(data, model) DeviceMesh of one NCCL rank, strategy 2d, "
             "kernels on local shards under local_map")
# the explicit data-parallel gradient (train/grad.py) over smollm-360m's
# loss: one sequence of 1024 tokens
DP_BATCH, DP_SEQ = 1, 1024
# the four other families at full width with depth cut (a check, not a
# cell): 2 layers (xlstm: one group of 4, whisper: 2 encoder + 2 decoder
# layers); one prefill of 2 x 256 tokens and 8 greedy steps through
# generate, then one training step of the config's microbatches, each of
# the per-microbatch batch and length of FLASH_MODEL_CASES (xlstm: 2 x 256)
FAMILY_CUTS = {"granite-moe-3b-a800m": dict(n_layers=2),
               "qwen2-vl-7b": dict(n_layers=2),
               "xlstm-125m": dict(n_layers=4),
               "whisper-medium": dict(n_layers=2, n_enc_layers=2)}
FAMILY_TRAIN = {"granite-moe-3b-a800m": (2, 256), "qwen2-vl-7b": (1, 512),
                "xlstm-125m": (2, 256), "whisper-medium": (2, 256)}
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_GEN = 2, 256, 8
# the same four families trained on the 1 x 1 NCCL mesh (lm_families_mesh):
# whisper-medium and xlstm-125m whole, through launch.train.main;
# granite-moe-3b-a800m and qwen2-vl-7b at full width with FAMILY_CUTS's
# depth, through run_training on make_host_mesh(1) (the launcher has no
# depth flag, and one card cannot hold either whole with f32 AdamW, some
# 16 B a parameter). FAMILY_MESH_STEPS steps of the config's microbatches,
# each FAMILY_TRAIN's; the same steps on plain tensors beside them, losses
# held step by step to MESH_LOSS_REL
FAMILY_MESH_WHOLE = ("whisper-medium", "xlstm-125m")
FAMILY_MESH_CUT = ("granite-moe-3b-a800m", "qwen2-vl-7b")
FAMILY_MESH_STEPS = 2

# the roofline phases (the cost counter, core/hlo_analysis.py, and the
# roofline, launch/roofline.py): a bf16 8192^3 matmul and a 4 GiB bf16
# clone, each counted exactly and timed, its share of the data sheet's
# bound at most ROOFLINE_SHARE_MAX (above it a count or a constant is
# wrong); smollm-360m's counted training step (lm_dense_train's, on the
# 1 x 1 NCCL mesh), its counted live-bytes peak within a factor
# PEAK_FACTOR of torch's reading either way; launch.train.main --autotune
# at AUTOTUNE_* (2 steps); one dry-run cell at full width and depth in a
# subprocess (CPU only, meta tensors on a fake process group of 256)
CALIB_MATMUL_N = 8192
CALIB_CLONE_BYTES = 4 * 2 ** 30
ROOFLINE_SHARE_MAX = 1.05
PEAK_FACTOR = 2.0
AUTOTUNE_ARCH, AUTOTUNE_BATCH, AUTOTUNE_SEQ, AUTOTUNE_STEPS = (
    "smollm-360m", 8, 1024, 2)
DRYRUN_CELL = ("smollm-360m", "train_4k", "pod16x16", "2d")
DRYRUN_TIMEOUT_S = 900
# fault F7: the dry-run cell's counted live-bytes peak a rank must fit under
# DRYRUN_PEAK_MAX (the reference's record: 1.86e9 bytes; the parent port's
# 1.23e11, the whole microbatch's logits gradient on every rank), and its
# fits_hbm must hold
DRYRUN_PEAK_MAX = 4 * 2 ** 30
# the LM loss on the 1 x 1 NCCL mesh (cross_entropy_on_shards) beside the
# plain cross_entropy_loss on the same f32 logits, smollm-360m's
# (8, 1024, vocab 49152): loss and logits gradient held at LOSS_RTOL (plus
# LOSS_RTOL of the gradient's largest magnitude)
LOSS_SHAPE = (8, 1024, 49152)
LOSS_RTOL = 1e-5

# fault F6 (ROADMAP section 3): the training cells that torch 2.11's DTensor
# refused (a sequence-sharded view inside x @ w) while 2.13's ran them,
# each run on a fake process group on the host by this torch, with
# tests/_mesh_cells.py's cuts, in a pool of spawned workers (a fake process
# group is per process), one process a cell, at a lower priority than the
# rest of the run (the dry-run cell beside it sets the run's length); every
# one must run
F6_CELLS = tuple(
    [(a, (2, 2), s) for a in ("smollm-360m", "qwen2.5-14b", "qwen1.5-110b",
                              "whisper-medium", "olmoe-1b-7b", "xlstm-125m")
     for s in ("zero3", "tp", "sp")]
    + [(a, (2, 2), "sp") for a in ("granite-moe-3b-a800m", "qwen2-vl-7b",
                                   "mistral-large-123b", "zamba2-2.7b")]
    + [(a, m, "2d") for a in ("zamba2-2.7b", "xlstm-125m")
       for m in ((2, 2), (2, 16), (16, 16))])
# faults F9-F12 (ROADMAP section 3): tests/test_torch_loss_shards.py's
# PEAK_CELLS, the train_4k cells on a fake (16, 16) mesh under 2d with
# their depth cut, counted in the same pool by this host's torch (the
# card's; the tests run another), each held under its bound in bytes a
# rank (the same bounds as the test's)
PEAK_CELLS = {"smollm-360m": (4, 1.75 * 2 ** 30),
              "qwen2.5-14b": (6, 2.6 * 2 ** 30),
              "zamba2-2.7b": (6, 3.9 * 2 ** 30)}
# faults F14-F19 (ROADMAP section 3): one serving cell of each repaired
# collective cause, as tests/test_torch_dryrun_faults.py counts it, with
# the reference's collective bytes a device of the same cell (lowered and
# compiled by the reference's launch/cells.py on 8 host devices, 512 for
# the last, and counted by its launch/roofline.py::analyze_cell under JAX
# 0.9.0 on a CPU host): (arch, config overrides or None for the full
# width, kind, seq_len, batch, mesh, the reference's bytes)
CAUSE_CELLS = {
    "dense": ("qwen2.5-14b", dict(d_model=256, n_heads=4, n_kv_heads=2,
                                  head_dim=64, d_ff=512, vocab=4096),
              "decode", 64, 8, (2, 2, 2), 2252424.0),
    "cross": ("whisper-medium", {}, "decode", 64, 8, (2, 2, 2), 71056.0),
    "moe": ("olmoe-1b-7b", {}, "decode", 64, 8, (2, 2, 2), 247528.0),
    "moe-slots": ("granite-moe-3b-a800m", dict(n_experts=3), "decode", 64, 8,
                  (2, 2, 2), 221928.0),
    "mixer": ("zamba2-2.7b", {}, "decode", 64, 8, (2, 2, 2), 185256.0),
    "xlstm-pod": ("xlstm-125m", None, "decode", 524288, 1, (2, 16, 16),
                  10106256.75),
}
CAUSE_LIMIT = 1.25
# every family's cut train_4k step on the multi-pod mesh's three axes
POD_CELLS = tuple((a, (2, 2, 2), "2d") for a in (
    "zamba2-2.7b", "mistral-large-123b", "qwen1.5-110b", "smollm-360m",
    "qwen2.5-14b", "whisper-medium", "olmoe-1b-7b", "granite-moe-3b-a800m",
    "qwen2-vl-7b", "xlstm-125m"))
# faults F27 and F28 (ROADMAP section 3): xlstm-125m's train_4k step cut to
# one group of 4 layers, on a fake (16, 16) mesh under 2d, as
# tests/test_torch_dryrun_xlstm.py counts it: (layers, the bound on its peak
# a rank, 1.15x the reference's peak_bytes_tpu of the same cell, lowered
# and compiled by the reference's launch/cells.py on 256 host devices and
# counted by its launch/roofline.py::analyze_cell under JAX 0.9.0 on a CPU
# host: 2,347,162,448 bytes)
XLSTM_CELL = (4, 1.15 * 2347162448)
# faults F24 and F26 (ROADMAP section 3): tests/test_torch_dryrun_prefill.py's
# cells, one of each cause the tally named, cut in depth at full width and
# length, on a fake mesh under 2d: (arch, layers, shape, mesh, the
# reference's peak_bytes_tpu a device of the same cell, lowered and
# compiled by the reference's launch/cells.py on 512 host devices and
# counted by its launch/roofline.py::analyze_cell under JAX 0.9.0 on a CPU
# host); each peak a rank is held within PEAK_LIMIT of it
CUT_CELLS = {
    "caches-16x16": ("qwen1.5-110b", 2, "prefill_32k", (16, 16), 8282343800),
    "caches-2x16x16": ("qwen1.5-110b", 2, "prefill_32k", (2, 16, 16),
                       4489518776),
    "norms-16x16": ("zamba2-2.7b", 6, "prefill_32k", (16, 16), 2438930468),
    "norms-2x16x16": ("zamba2-2.7b", 6, "prefill_32k", (2, 16, 16),
                      1242915428),
    "merge-16x16": ("smollm-360m", 2, "prefill_32k", (16, 16), 798034552),
    "merge-2x16x16": ("smollm-360m", 2, "prefill_32k", (2, 16, 16),
                      425433464),
    "dispatch-16x16": ("olmoe-1b-7b", 1, "prefill_32k", (16, 16),
                       11490282360),
    "dispatch-2x16x16": ("olmoe-1b-7b", 1, "prefill_32k", (2, 16, 16),
                         11200484072),
    "f26-2x16x16": ("smollm-360m", 32, "train_4k", (2, 16, 16), 961120016),
}
PEAK_LIMIT = 1.15
# xlstm-125m in lm_families on the parent commit of the recurrences' scans
# (3afd41c, its loops stepped in Python), measured by ``python3
# tools/mesh_ab.py --root DIR --families`` on an NVIDIA H100 80GB HBM3 at
# 700.00 W (torch 2.11.0+cu128), two runs of the parent beside two of the
# change in one call: the median of its warm prefills of 2 x 256 tokens
# (``xlstm_times``' second to fourth) in ms, and of its lm_families
# training step in seconds
XLSTM_PARENT = {"prefill_ms": 86.32, "train_s": 2.5635}
MESH_CELL_WORKERS = 4
MESH_CELL_NICE = 19          # below the dry-run and the timed phases
MESH_CELLS_TIMEOUT_S = 1000
# context-parallel attention under this host's torch (the card's): the
# comparison of tests/test_torch_context_parallel.py (c) on 4 gloo ranks
# (tests/_gloo.py's ``context_parallel`` world against one device, float64,
# rtol 1e-9; neither imports jax or the reference), in a subprocess at
# MESH_CELL_NICE beside the F6 cells
CP_HOST_TIMEOUT_S = 600

# the LM training path: zamba2-2.7b at full width through launch/train.py,
# global batch 4 x 1024 in the config's 2 microbatches, 1 warm-up step and
# 3 timed steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 4
# in place, every kernel call of one step beside its plain version on the
# same inputs, as shares of the largest value: both compute in f32 from the
# same bf16 values and round the output to bf16 once, so one bf16 ulp
# (2^-7 of the largest value); the SSD state h stays f32 (1e-3, as in
# serving)
TRAIN_CALL_REL = {"flash_attention": (2 ** -7,), "ssd_scan": (2 ** -7, 1e-3)}
# one whole f32 step (batch 1 x 512) through the kernels, beside the plain
# path: loss and gradient norm. Reported, not held to a limit: under
# PERF.md's rule (3x the largest correct reading, kept only if every broken
# kernel lands 5x above it) the attention fault landed 2.2x above on an
# H100, so the whole step cannot tell it from a correct kernel and the
# in-place checks carry correctness
TRAIN_F32_BATCH, TRAIN_F32_SEQ = 1, 512

# the pipeline's front end: the suite's workloads run on the card and held
# to the host (integers exactly, float32 within this share of the host
# output's largest value, TF32 off); their features extracted in worker
# processes; aux.flops held exactly on the dense linear-algebra and
# convolution kernels, as the CPU tests hold it
FRONTEND_F32_REL = 1e-4
FRONTEND_WORKERS = 6
FLOPS_EXACT = {"gemm", "2mm", "3mm", "syrk", "syr2k", "2dconv", "3dconv"}

# the pipeline's ground truth: the suite timed on the card at the
# reference's fast profile (``load_or_collect(fast=True)``: sizes s, m and
# l, 5 repeats; xl waits, where nw alone would take about 90 s), seed 0;
# nested CV on those times with the grid of the reference's fast benchmark
# profile (``benchmarks/common.py::cv_config``), beside the same CV on a
# simulated TPU's times from the same dataset as a yardstick; then the
# stream: the suite at s measured on a collector thread into a store while
# a refresher refits a 32-tree forest and hot-swaps it into a live engine
GT_SIZES = ("s", "m", "l")
GT_REPEATS = 5
CV_GRID = {"criterion": ["mse", "mae"], "max_features": ["max", "log2", "sqrt"],
           "n_estimators": [16, 32]}
CV_CONFIG = dict(outer_folds=3, inner_folds=2, iterations=2, time_split=True,
                 log_target=True)
CV_YARDSTICK = "tpu-v5e"
STREAM_SIZES = ("s",)
STREAM_TREES = 32
STREAM_CHUNK = 8
STREAM_MIN_SAMPLES = 8

# the serving tier: the 512-tree forest partitioned into these shard counts
# (the loop placement: one card), served at TIMED_BATCHES; shards 0 and then
# 2 of a 3-shard engine dropped (shards of 171, 171 and 170 trees); the
# 22-tree forest in one-tree shards and in 7 (shards of 3 and 4 trees, sizes
# the kernel's tree group of 4 does not divide)
SHARD_COUNTS = (1, 2, 3, 4, 8)
SHARD_DROPS = (3, (0, 2))
DEEP_SHARDS = (DEEP_TREES, 7)
ENGINE_CALLS = 5             # engine calls per shard count at B = 4096, whose
                             # median is reported (host clock)
# the wire server: ``python -m repro_torch.cluster --port 0 --trees 64
# --n-features 12`` beside its in-process twin, and the golden trace of
# tests/test_trace.py replayed through the demo frontend the reference's
# golden test builds (seed 3, 12 features)
CLUSTER_TREES, CLUSTER_FEATURES, CLUSTER_ROWS = 64, 12, 64
TRACE_FIXTURE = REPO / "tests" / "fixtures" / "trace_golden_v1.jsonl"

# the CUDA kernels each wrapper call launches, by the name the profiler
# shows: the forest walk and the sum of its groups' partials; the SSD scan's
# bf16 entry runs three passes, its f32 entry one kernel; flash attention
# one kernel per entry
FOREST_KERNELS = ("forest_walk_kernel", "forest_sum_kernel")
SSD_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
               "ssd_chunk_out_kernel", "ssd_chunk_kernel")
FLASH_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, by
    CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(fn, names, iters: int = 50) -> dict:
    """Device ms per launch of each CUDA kernel whose name holds one of
    ``names`` (a name or a tuple of names) while ``fn()`` runs ``iters``
    times, from torch.profiler's CUDA trace: the kernels alone, without the
    host's launch cost. Each kernel's mean over its device events of
    nonzero length (the trace may hold a kernel's launch twice, once with
    no duration). {} when the trace holds no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (names,) if isinstance(names, str) else tuple(names)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    durations = {}
    for e in prof.events():
        us = e.time_range.elapsed_us()
        if (e.device_type == DeviceType.CUDA and us > 0
                and any(n in e.name for n in names)):
            durations.setdefault(e.name, []).append(us)
    return {k: sum(v) / len(v) / 1e3 for k, v in durations.items()}


def kernel_device_ms(fn, names, iters: int = 50) -> float | None:
    """Device time per call of ``fn()`` of the kernels ``names`` picks
    (``kernel_times`` summed: one call launches each once, as the SSD
    scan's three passes). None when the trace holds no such kernel."""
    times = kernel_times(fn, names, iters)
    return sum(times.values()) if times else None


def bound(x, feature, threshold, depth: int) -> tuple[float, str, dict]:
    """Least time for one forest call on these inputs: the larger of (bytes
    this data's walks must read — each distinct node once — plus x and out,
    over the HBM rate) and (compare/index/add operations over the fp32
    rate)."""
    import torch
    B, F = x.shape
    T, N = feature.shape
    trees = torch.arange(T, device=x.device)[None, :]
    cur = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    nodes = 0
    for _ in range(depth):
        nodes += torch.unique(trees * N + cur).numel()
        feat = feature[trees, cur]
        xv = torch.gather(x, 1, feat.clamp_min(0).long())
        left = (feat < 0) | (xv <= threshold[trees, cur])
        cur = torch.where(left, 2 * cur + 1, 2 * cur + 2)
    leaves = torch.unique(trees * N + cur).numel()
    n_bytes = nodes * 8 + leaves * 4 + B * F * 4 + B * 4
    n_ops = B * T * (3 * depth + 1)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": n_bytes, "ops": n_ops}


def plain_cpu(estimator, Z):
    """The plain CPU dense path of ``estimator`` at depth DEPTH on rows
    ``Z``: what the forest engine's answers on the card are held to."""
    import numpy as np

    from repro_torch.core.forest_torch import DenseForestTorch, to_dense
    return DenseForestTorch(to_dense(estimator, DEPTH),
                            device="cpu")(Z).numpy().astype(np.float64)


def profile_breakdown(fn, find: dict | None = None, top: int = 8) -> dict:
    """One synchronised call of ``fn()`` under torch.profiler: host wall
    ms, the sum of the device's kernel times, the device's busy share of
    the wall time, the number of kernels, for each label of ``find`` the
    kernels whose name holds one of its names (their device ms, launches
    and share of the wall time), and the ``top`` kernels by device time.
    Only device events are summed: an aten op's self device time is its
    kernels' time again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(a.key, a.count, a.self_device_time_total / 1e3)
            for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "busy_share": device_ms / wall_ms,
           "kernels": sum(r[1] for r in rows)}
    for label, names in (find or {}).items():
        found = [r for r in rows if any(n in r[0] for n in names)]
        found_ms = sum(r[2] for r in found)
        out[label] = {"ms": found_ms, "count": sum(r[1] for r in found),
                      "share_of_wall": found_ms / wall_ms,
                      "kernels": {r[0][:60]: r[1] for r in found}}
    out["top"] = [{"name": k[:90], "count": c, "ms": m}
                  for k, c, m in rows[:top]]
    return out


def kernel_name(mangled: str) -> str:
    """The kernel's name in a mangled symbol, with its template arguments
    as mangled (``flash_fwd_mma_kernelILi5E``): the first length-prefixed
    name that ends in ``_kernel``."""
    import re
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        j = i + len(m.group())
        name = mangled[j:j + int(m.group())]
        if name.endswith("_kernel"):
            rest = mangled[j + len(name):]
            return name + (rest[:rest.find("E") + 1]
                           if rest.startswith("I") else "")
        i = j + len(name)
    return mangled


def tensor_core_counts(library: Path) -> dict:
    """Tensor-core instructions in each kernel of a built library, from
    ``cuobjdump --dump-sass``: {kernel: {"HMMA": n, "HGMMA": m}}."""
    import re

    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "--dump-sass", str(library)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        counts[kernel_name(part.split("\n", 1)[0].strip())] = {
            op: len(re.findall(rf"\b{op}\b", part))
            for op in ("HMMA", "HGMMA")}
    return counts


def ssd_inputs(dev, B: int, S: int, dtype, seed: int, strided: bool = False):
    """x (B,S,H,P), alog (B,S,H) f32 < 0, B/C (B,S,N) scaled so that C.B
    stays O(1) at N = 64. ``strided``: B and C are the last 2N columns of
    one (B, S, H*P + 2N) tensor, the strides the model passes them with
    (its conv output (x, B, C))."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(B, S, SSD_H, SSD_P).to(dtype)
    alog = -randn(B, S, SSD_H).abs() * 0.3
    if strided:
        di = SSD_H * SSD_P
        xbc = (randn(B, S, di + 2 * SSD_N) * SSD_N ** -0.25).to(dtype)
        return x, alog, xbc[..., di:di + SSD_N], xbc[..., di + SSD_N:]
    Bm = (randn(B, S, SSD_N) * SSD_N ** -0.25).to(dtype)
    Cm = (randn(B, S, SSD_N) * SSD_N ** -0.25).to(dtype)
    return x, alog, Bm, Cm


def ssd_bound(x, alog, B, C, chunk: int) -> tuple[float, str, dict]:
    """Least time for one SSD scan on these inputs: the larger of (x, alog,
    B, C read once, y and h written once, over the HBM rate) and (the
    chunked form's products over the peak rate for the inputs' type: bf16
    tensor cores, or fp32). The products: C.B^T, 2L^2N once per batch and
    chunk (B and C are shared across heads), then 2L^2P + 4LNP per chunk
    and head. Beside it (in the dict), the same bound with the bf16
    kernel's per-chunk state traffic added: the states (f32) written and
    read, h_in (a bf16 hi + lo pair) written and read, 16 bytes per
    element of (Bsz, H, chunks, N, P)."""
    import torch
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    es = x.element_size()
    n_bytes = (2 * x.numel() + B.numel() + C.numel()) * es \
        + alog.numel() * 4 + Bsz * H * N * P * 4
    L = chunk
    nck = -(-S // L)
    n_ops = Bsz * nck * (2 * L * L * N + H * (2 * L * L * P + 4 * L * N * P))
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    state_bytes = 16 * Bsz * H * nck * N * P
    with_states = max((n_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3, t_ops)
    return max(t_bytes, t_ops), by, {"bytes": n_bytes, "ops": n_ops,
                                     "state_bytes": state_bytes,
                                     "bound_with_states_ms": with_states}


def ssd_timing(dev, B: int, S: int) -> dict:
    """The SSD kernel at (B, S), bf16, B/C strided as the model passes
    them: events ms, device ms (its CUDA kernels summed, and each alone),
    the plain version's ms, the bound."""
    import torch
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.kernels.mamba.ref import ssd_chunked
    x, alog, Bm, Cm = ssd_inputs(dev, B, S, torch.bfloat16, seed=7,
                                 strided=True)

    def launch():
        return sops.ssd_scan(x, alog, Bm, Cm)
    k_ms = cuda_ms(launch, iters=50, warmup=5)
    times = kernel_times(launch, SSD_KERNELS, iters=20)
    passes = {n: sum(t for k, t in times.items() if n in k)
              for n in SSD_KERNELS[:3]}
    d_ms = sum(passes.values())
    p_ms = cuda_ms(lambda: ssd_chunked(x, alog, Bm, Cm, chunk=128), iters=10,
                   warmup=2)
    b_ms, b_by, work = ssd_bound(x, alog, Bm, Cm, chunk=128)
    return {"ms": k_ms, "device_ms": d_ms, "passes_device_ms": passes,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, **work,
            "library_ms": None,
            "shape": {"Bsz": B, "S": S, "H": SSD_H, "P": SSD_P, "N": SSD_N,
                      "dtype": "bfloat16", "chunk": 128}}


def ssd_kernel_phase(dev) -> dict:
    """The SSD kernel against its plain version on the same CUDA tensors."""
    import torch
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.kernels.mamba.ref import ssd_chunked
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(B, S, dtype, False, False) for B, S in SSD_CASES]
        cases += [(2, 300, dtype, True, False), (4, 512, dtype, False, True),
                  (2, 1024, dtype, False, True)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    results = []
    for i, (B, S, dtype, with_h0, strided) in enumerate(cases):
        x, alog, Bm, Cm = ssd_inputs(dev, B, S, dtype, seed=i, strided=strided)
        h0 = None
        if with_h0:
            h0 = torch.randn((B, SSD_H, SSD_N, SSD_P), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(99))
        y, h = sops.ssd_scan(x, alog, Bm, Cm, h0=h0)
        y2, h2 = sops.ssd_scan(x, alog, Bm, Cm, h0=h0)
        yp, hp = ssd_chunked(x, alog, Bm, Cm, h0=h0,
                             chunk=min(128, -(-S // 8) * 8))
        torch.cuda.synchronize()
        tol = SSD_F32_TOL if dtype == torch.float32 else SSD_BF16_Y_TOL
        what = f"B={B} S={S} {dtype} h0={with_h0} strided={strided}"
        torch.testing.assert_close(y.float(), yp.float(), **tol, msg=what)
        torch.testing.assert_close(h, hp, **SSD_F32_TOL, msg=what)
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"SSD kernel not repeatable at {what}")
        ey = float((y.float() - yp.float()).abs().max())
        eh = float((h - hp).abs().max())
        worst[dtype] = max(worst[dtype], ey, eh)
        results.append({"B": B, "S": S, "dtype": str(dtype).split(".")[-1],
                        "h0": with_h0, "strided": strided, "y_err": ey,
                        "h_err": eh, "y_max": float(yp.float().abs().max())})
    emit("ssd_kernel", cases=len(results), heads=SSD_H, head_dim=SSD_P,
         state=SSD_N, f32_tol=SSD_F32_TOL, bf16_y_tol=SSD_BF16_Y_TOL,
         max_abs_err=worst[torch.float32],
         max_abs_err_bf16=worst[torch.bfloat16], results=results)
    return {"max_abs_err": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16]}


def flash_inputs(dev, B, Hq, Hkv, Sq, Skv, D, dtype, seed: int,
                 model_layout: bool = False):
    """q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) from a seeded generator.
    ``model_layout``: transposed views of (B, S, H, D) tensors, the strides
    ``attend_train`` passes them with."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(b, h, s, d):
        if model_layout:
            return torch.randn((b, s, h, d), generator=gen, device=dev).to(
                dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    return randn(B, Hq, Sq, D), randn(B, Hkv, Skv, D), randn(B, Hkv, Skv, D)


def flash_bound(q, k, kv_len: int | None = None,
                kv_offset: int | None = None,
                causal: bool = True) -> tuple[float, str, dict]:
    """Least time for one attention call on these inputs: the larger of (q,
    k, v read once, o written once, over the HBM rate) and (the products
    of the (query, key) pairs the masks leave, 4 D operations each, over
    the peak rate for the inputs' type: bf16 tensor cores, or fp32)."""
    import torch
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    kv_len = Skv if kv_len is None else kv_len
    kv_offset = Skv - Sq if kv_offset is None else kv_offset
    rows = torch.arange(Sq)
    seen = (torch.clamp(torch.clamp(rows + kv_offset + 1, max=kv_len), min=0)
            if causal else torch.full((Sq,), kv_len))
    pairs = int(seen.sum())
    n_ops = 4 * B * Hq * pairs * D
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / rate * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": n_bytes, "ops": n_ops}


def flash_kernel_phase(dev) -> dict:
    """The flash-attention kernel against its plain version on the same
    CUDA tensors: the reference's five test shapes and its bf16 case,
    zamba2's training shape, each other family's training shape
    (FLASH_MODEL_CASES: GQA groups of 3 and 7, an odd head count, D 128),
    the model's (B, S, H, D) strides, rows that see no key, keys masked past
    kv_len; bitwise repeatable; the autograd.Function's gradients against
    autograd of the plain version."""
    import torch
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.kernel import flash_attention_kernel
    from repro_torch.kernels.attention.ref import attention_ref
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(*shape, dtype, False) for shape in FLASH_CASES]
        cases += [(*FLASH_TRAIN, dtype, False), (*FLASH_TRAIN, dtype, True)]
        cases += [(*shape, True, dtype, True)
                  for shape in FLASH_MODEL_CASES.values()]
    cases.append((*FLASH_BF16_CASE, torch.bfloat16, False))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    results = []
    for i, (B, Hq, Hkv, Sq, Skv, D, causal, dtype, strided) in enumerate(cases):
        q, k, v = flash_inputs(dev, B, Hq, Hkv, Sq, Skv, D, dtype, seed=i,
                               model_layout=strided)
        o = fops.flash_attention(q, k, v, causal=causal)
        o2 = fops.flash_attention(q, k, v, causal=causal)
        plain = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        what = f"{(B, Hq, Hkv, Sq, Skv, D, causal)} {dtype} strided={strided}"
        if o.stride() != q.stride():
            raise AssertionError(f"output not laid out as q at {what}")
        torch.testing.assert_close(o.float(), plain.float(),
                                   **FLASH_TOL[dtype_name(dtype)], msg=what)
        if not torch.equal(o, o2):
            raise AssertionError(f"flash kernel not repeatable at {what}")
        err = float((o.float() - plain.float()).abs().max())
        worst[dtype] = max(worst[dtype], err)
        results.append({"shape": [B, Hq, Hkv, Sq, Skv, D], "causal": causal,
                        "dtype": dtype_name(dtype),
                        "strided": strided, "max_abs_err": err})
    # keys masked past kv_len, and rows that see no key (kv_offset < 0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_inputs(dev, 2, 4, 2, 96, 80, 64, dtype, seed=50)
        for kv_len, kv_offset in ((53, 27), (80, -40), (0, 0)):
            o = flash_attention_kernel(q, k, v, causal=True, kv_len=kv_len,
                                       kv_offset=kv_offset)
            plain = attention_ref(q, k, v, causal=True, kv_len=kv_len,
                                  kv_offset=kv_offset)
            torch.testing.assert_close(
                o.float(), plain.float(), **FLASH_TOL[dtype_name(dtype)],
                msg=f"kv_len={kv_len} offset={kv_offset} {dtype}")
            if kv_offset < 0 and bool(o[:, :, :-kv_offset].any()):
                raise AssertionError(f"a row that sees no key is not 0 "
                                     f"({dtype})")
    # gradients: the Function's backward (the plain version recomputed)
    # against autograd of the plain version; the same operations on the same
    # inputs, so they should agree to the bit
    grads_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t.detach().requires_grad_() for t in flash_inputs(
            dev, 2, 8, 4, 200, 200, 80, dtype, seed=60, model_layout=True))
        g = torch.randn(q.shape, device=dev).to(dtype)
        got = torch.autograd.grad(fops.flash_attention(q, k, v), (q, k, v), g)
        want = torch.autograd.grad(attention_ref(q, k, v), (q, k, v), g)
        for name, a, b in zip("qkv", got, want):
            torch.testing.assert_close(a, b, **FLASH_TOL[dtype_name(dtype)],
                                       msg=f"d{name} {dtype}")
        grads_err[dtype_name(dtype)] = max(
            float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    emit("flash_kernel", cases=len(results), tol=FLASH_TOL,
         max_abs_err=worst[torch.float32],
         max_abs_err_bf16=worst[torch.bfloat16], grads_max_err=grads_err,
         results=results)
    return {"max_abs_err": worst[torch.float32],
            "max_abs_err_bf16": worst[torch.bfloat16]}


def flash_lse_phase(dev) -> dict:
    """B2's lse output against its plain version's (``attention_ref(...,
    return_lse=True)``) on FLASH_CASES and the masked cases, f32 and bf16:
    -inf exactly on the rows that see no key, o unchanged by the option."""
    import torch
    from repro_torch.kernels.attention.kernel import flash_attention_kernel
    from repro_torch.kernels.attention.ref import attention_ref
    cases = [(*shape, None) for shape in FLASH_CASES]
    cases += [(*shape, True, off) for shape in FLASH_LSE_MASKED
              for off in (None, -40)]
    worst, hidden_rows = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, Hq, Hkv, Sq, Skv, D, causal, off) in enumerate(cases):
            q, k, v = flash_inputs(dev, B, Hq, Hkv, Sq, Skv, D, dtype,
                                   seed=70 + i, model_layout=i % 2 == 1)
            kw = dict(causal=causal, kv_offset=off)
            o, lse = flash_attention_kernel(q, k, v, return_lse=True, **kw)
            o_plain, lse_plain = attention_ref(q, k, v, return_lse=True, **kw)
            o_only = flash_attention_kernel(q, k, v, **kw)
            torch.cuda.synchronize()
            what = f"{(B, Hq, Hkv, Sq, Skv, D, causal, off)} {dtype}"
            if not torch.equal(o, o_only):
                raise AssertionError(f"return_lse changed o at {what}")
            if lse.dtype != torch.float32 or lse.shape != (B, Hq, Sq):
                raise AssertionError(f"lse {lse.dtype} {tuple(lse.shape)} "
                                     f"at {what}")
            empty = torch.isneginf(lse_plain)
            if not torch.equal(torch.isneginf(lse), empty):
                raise AssertionError(f"lse is -inf elsewhere than on the "
                                     f"rows that see no key at {what}")
            hidden_rows += int(empty.sum())
            torch.testing.assert_close(
                lse[~empty], lse_plain[~empty].float(),
                **FLASH_TOL[dtype_name(dtype)], msg=f"lse at {what}")
            torch.testing.assert_close(o.float(), o_plain.float(),
                                       **FLASH_TOL[dtype_name(dtype)],
                                       msg=f"o at {what}")
            err = float((lse[~empty] - lse_plain[~empty]).abs().max())
            worst[dtype_name(dtype)] = max(worst.get(dtype_name(dtype), 0.0),
                                           err)
    if hidden_rows == 0:
        raise AssertionError("no lse case had a row that sees no key")
    out = {"checks": 2 * len(cases), "lse_max_abs_err": worst,
           "hidden_rows": hidden_rows}
    emit("flash_lse", **out, tol=FLASH_TOL)
    return out


def flash_split_phase(dev, smi: str) -> dict:
    """The context-parallel merge on the card: zamba2's and smollm-360m's
    training shapes (FLASH_SPLIT_SHAPES, the model's (B, S, H, D) layout)
    with the keys cut into each of FLASH_SPLITS shards, each shard launched
    through ``flash_attention`` with kv_offset = -start and
    ``return_lse=True``, merged by ``merge_partials`` over the stacked
    shards and held to B2 over the whole keys at FLASH_TOL, f32 and bf16;
    the gradients of q, k and v through the merge (the Function's backward
    on each shard) held to autograd of the plain version over the whole
    keys. Then the events time of the heaviest of smollm's 16 shard
    launches (shard 0: every row sees its keys) beside the whole launch,
    bf16, each beside its bound."""
    import torch
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.models.attention import merge_partials, stacked

    def shards(q, k, v, m):
        n = k.shape[2] // m
        parts = [fops.flash_attention(
            q, k[:, :, r * n:(r + 1) * n], v[:, :, r * n:(r + 1) * n],
            causal=True, kv_offset=-r * n, return_lse=True)
            for r in range(m)]
        return merge_partials(torch.stack([p[0] for p in parts]),
                              torch.stack([p[1] for p in parts]), stacked)
    results, checks = [], 0
    for arch, shape in FLASH_SPLIT_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            tol = FLASH_TOL[dtype_name(dtype)]
            q, k, v = (t.detach().requires_grad_() for t in flash_inputs(
                dev, *shape, dtype, seed=80, model_layout=True))
            g = torch.randn(q.shape, device=dev).to(dtype)
            whole = fops.flash_attention(q, k, v, causal=True)
            want = torch.autograd.grad(attention_ref(q, k, v), (q, k, v), g)
            for m in FLASH_SPLITS:
                merged = shards(q, k, v, m)
                got = torch.autograd.grad(merged, (q, k, v), g)
                torch.cuda.synchronize()
                what = f"{arch} {dtype} over {m} key shards"
                torch.testing.assert_close(merged.float(), whole.float(),
                                           **tol, msg=what)
                for name, a, b in zip("qkv", got, want):
                    torch.testing.assert_close(a, b, **tol,
                                               msg=f"{what} d{name}")
                checks += 1
                results.append({
                    "arch": arch, "dtype": dtype_name(dtype), "shards": m,
                    "max_abs_err": float((merged.float() - whole.float())
                                         .abs().max().detach()),
                    "grads_max_err": max(float((a.float() - b.float())
                                               .abs().max())
                                         for a, b in zip(got, want))})
            del q, k, v, g, whole, want, merged, got
            torch.cuda.empty_cache()
    # one shard launch of smollm's shape beside the whole launch
    shape = FLASH_SPLIT_SHAPES["smollm-360m"]
    q, k, v = flash_inputs(dev, *shape, torch.bfloat16, seed=81,
                           model_layout=True)
    n = shape[4] // FLASH_SPLITS[-1]
    ks, vs = k[:, :, :n], v[:, :, :n]
    def whole():
        return fops.flash_attention(q, k, v, causal=True)

    def shard0():
        return fops.flash_attention(q, ks, vs, causal=True, kv_offset=0,
                                    return_lse=True)
    whole_bound, whole_by, _ = flash_bound(q, k)
    shard_bound, shard_by, _ = flash_bound(q, ks, kv_offset=0)
    # events ms include the host's wrapper whenever it is slower than the
    # kernel; device ms are the kernel's alone (kernel_times)
    timing = {"shape": list(shape), "shards": FLASH_SPLITS[-1],
              "whole_ms": cuda_ms(whole, iters=30, warmup=3),
              "whole_device_ms": kernel_device_ms(whole, FLASH_KERNELS),
              "whole_bound_ms": whole_bound, "whole_bound_by": whole_by,
              "shard0_ms": cuda_ms(shard0, iters=30, warmup=3),
              "shard0_device_ms": kernel_device_ms(shard0, FLASH_KERNELS),
              "shard0_bound_ms": shard_bound, "shard0_bound_by": shard_by}
    emit("flash_split", checks=checks, tol=FLASH_TOL, results=results,
         timing=timing, card=smi)
    return {"checks": checks, "timing": timing,
            "max_abs_err": max(r["max_abs_err"] for r in results)}


def inplace_check(records: dict):
    """A watcher for ``repro_torch.kernels.watch``: each kernel call's
    output beside its plain version's on the same inputs, as shares of
    the largest value, appended to ``records[name]`` (y and h for the SSD
    scan, o for attention). Its plain versions run inside the call, so the
    launch counters do not see them."""
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.mamba.ref import ssd_chunked
    from repro_torch.launch.scan_drift import rel_err

    def check(name, inputs, output):
        i = inputs
        if name == "ssd_scan":
            yp, hp = ssd_chunked(i["x"], i["alog"], i["B"], i["C"],
                                 h0=i["h0"], chunk=i["chunk"])
            records.setdefault(name, []).append(
                (rel_err(output[0], yp), rel_err(output[1], hp)))
        elif name == "flash_attention":
            op = attention_ref(i["q"], i["k"], i["v"], causal=i["causal"],
                               sm_scale=i["sm_scale"],
                               kv_offset=i["kv_offset"])
            got = output[0] if i["return_lse"] else output
            records.setdefault(name, []).append((rel_err(got, op),))
        else:
            raise AssertionError(f"no plain version for {name}")
    return check


def lm_serve_phase(dev) -> dict:
    """zamba2-2.7b at full width on the card: generate() with its SSD
    launches counted, then prefill held to the plain chunked path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.kernels.watch import watching
    from repro_torch.launch.scan_drift import apart
    from repro_torch.launch.serve import generate
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model = build_model(replace(cfg, use_pallas=True))
    params = model.init(seed=0, device=dev)
    batch = model.make_batch(ShapeConfig("serve", LM_PROMPT, LM_BATCH,
                                         "prefill"), seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    sops.launches = fops.launches = 0         # count the main path's launches
    t0 = time.perf_counter()
    tokens, times = generate(model, params, batch, LM_GEN)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = sops.launches
    if launches != cfg.n_layers or fops.launches:
        raise AssertionError(f"{launches} SSD and {fops.launches} attention "
                             f"kernel launches for one prefill of "
                             f"{cfg.n_layers} Mamba layers")
    if (tuple(tokens.shape) != (LM_BATCH, LM_GEN) or len(times) != LM_GEN
            or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab):
        raise AssertionError(f"bad generation: {tuple(tokens.shape)}")

    # prefill through the kernel, every Mamba layer's SSD call held in place
    # to the plain chunked path on the card
    checks, failures = {}, []
    for dtype in ("bfloat16", "float32"):
        c = replace(cfg, dtype=dtype)
        records = {}
        before = sops.launches
        with watching(inplace_check(records)):
            kern = build_model(replace(c, use_pallas=True)).prefill(params,
                                                                    batch)
        torch.cuda.synchronize()
        layers = records.get("ssd_scan", [])
        if sops.launches - before != cfg.n_layers or len(layers) != cfg.n_layers:
            raise AssertionError(f"{sops.launches - before} kernel launches "
                                 f"in the {dtype} prefill")
        if not bool(torch.isfinite(kern[0]).all()):
            raise AssertionError(f"non-finite {dtype} prefill logits")
        y_lim, h_lim = LM_LAYER_REL[dtype]
        worst_y = max(e[0] for e in layers)
        worst_h = max(e[1] for e in layers)
        if not (worst_y <= y_lim and worst_h <= h_lim):
            failures.append(f"{dtype}: a layer's SSD output is {worst_y} "
                            f"(y) / {worst_h} (h) of its largest value off the "
                            f"plain version's, limits {y_lim} / {h_lim}")
        checks[dtype] = {"layers_y": [e[0] for e in layers],
                         "layers_h": [e[1] for e in layers],
                         "worst_layer_y": worst_y, "worst_layer_h": worst_h,
                         "layer_limits": [y_lim, h_lim]}
        if dtype == "float32":
            plain = build_model(replace(c, use_pallas=False)).prefill(params,
                                                                     batch)
            whole = apart(kern, plain)
            bad = {k: v for k, v in whole.items() if not v <= LM_F32_REL}
            if bad:
                failures.append(f"float32 prefill {bad} of the largest value "
                                f"off the plain path's, limit {LM_F32_REL}")
            checks[dtype].update(whole_prefill=whole, whole_limit=LM_F32_REL)
            del plain
        del kern
    emit("lm_serve", arch=LM_ARCH, params=model.n_params(),
         layers=cfg.n_layers, d_model=cfg.d_model, batch=LM_BATCH,
         prompt=LM_PROMPT, generated=LM_GEN, init_s=init_s, serve_s=serve_s,
         ssd_launches=launches, ssd_launches_per_prefill=launches,
         tokens_head=tokens[0, :8].tolist(), vs_plain=checks)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"model": model, "params": params, "batch": batch, "times": times,
            "launches": launches}


def lm_timing_phase(dev, served: dict, smi: str) -> dict:
    """Prefill and decode times of the served model; the SSD kernel at the
    serving shape (bf16 x, B/C strided as the model passes them)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import place_prefill_caches

    model, params, batch = served["model"], served["params"], served["batch"]
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    prefill_ms = float(np.median(pre)) * 1e3
    decode_ms = float(np.median(served["times"])) * 1e3
    # where the time goes: one prefill and one decode step, traced
    prefill_trace = profile_breakdown(lambda: model.prefill(params, batch),
                                      {"ssd": SSD_KERNELS})
    _, caches = model.prefill(params, batch)
    caches = place_prefill_caches(model, caches, LM_PROMPT + 1)
    step = {"tokens": batch["tokens"][:, -1:], "pos": LM_PROMPT}
    decode_trace = profile_breakdown(
        lambda: model.decode(params, step, caches), {"ssd": SSD_KERNELS})
    del caches
    out = ssd_timing(dev, LM_BATCH, LM_PROMPT)
    emit("lm_timing", arch=LM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT,
         prefill_ms=prefill_ms, prefill_runs_ms=[t * 1e3 for t in pre],
         decode_ms_median=decode_ms,
         decode_ms_all=[t * 1e3 for t in served["times"]],
         decode_tokens_per_s=LM_BATCH / decode_ms * 1e3,
         ssd_launches_per_prefill=served["launches"],
         ssd_share_of_prefill=prefill_trace["ssd"]["share_of_wall"],
         ssd=out, prefill_trace=prefill_trace, decode_trace=decode_trace,
         card=smi)
    return out


def train_launches_per_step(cfg) -> dict:
    """Kernel launches of one training step, from the code. Each of the
    config's microbatches runs the model forward once; the backward passes
    recompute the plain versions, launching nothing, but activation
    checkpointing runs forwards again:

    * zamba2 (``models/zamba.py``): each group body runs again in the
      backward pass (its shared-block attention: twice in all; its Mamba
      layers: twice) and each Mamba layer once more inside that (three
      times in all);
    * dense, moe, vlm (``models/lm.py``): each layer's checkpoint runs its
      attention once more; with ``remat_grouped`` (groups of L / G layers
      nested in their group's checkpoint) the group's recomputation runs
      every layer of the group again but its last, because torch's
      non-reentrant checkpoint stops recomputing once it holds every tensor
      the backward needs (the last layer's input): 3 L - G calls;
    * encdec: the decoder's self-attention, once more per layer under remat
      (the encoder and the cross-attention are plain);
    * xlstm: no attention, no kernel."""
    from repro_torch.models.lm import remat_grouped
    fam, L = cfg.family, cfg.n_layers
    attn, ssd = 0, 0
    if fam == "mamba_hybrid":
        groups = L // cfg.shared_attn_every
        attn, ssd = (2 * groups, 3 * L) if cfg.remat else (groups, L)
    elif fam in ("dense", "moe", "vlm"):
        attn = (3 * L - cfg.remat_groups if remat_grouped(cfg)
                else 2 * L if cfg.remat else L)
    elif fam == "encdec":
        attn = 2 * L if cfg.remat else L
    elif fam != "xlstm":
        raise ValueError(f"unknown family {fam!r}")
    return {"flash_attention": attn * cfg.microbatches,
            "ssd_scan": ssd * cfg.microbatches}


def flash_timing(dev, shape) -> dict:
    """The flash-attention kernel at ``shape`` (B, Hq, Hkv, Sq, Skv, D),
    causal, bf16, in the model's (B, S, H, D) layout: events ms, device ms,
    its plain version's ms, the bound, and SDPA's ms (timed as a yardstick
    only, on contiguous copies)."""
    import torch
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.attention.ref import attention_ref
    q, k, v = flash_inputs(dev, *shape, torch.bfloat16, seed=7,
                           model_layout=True)

    def launch():
        return fops.flash_attention(q, k, v, causal=True)
    k_ms = cuda_ms(launch, iters=30, warmup=3)
    d_ms = kernel_device_ms(launch, FLASH_KERNELS, iters=10)
    p_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True), iters=5,
                   warmup=1)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=shape[1] != shape[2]),
        iters=30, warmup=3)
    b_ms, b_by, work = flash_bound(q, k)
    return {"ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, **work, "library_ms": lib_ms,
            "shape": dict(zip(("B", "Hq", "Hkv", "Sq", "Skv", "D"), shape),
                          causal=True, dtype="bfloat16",
                          layout="(B, S, H, D) transposed")}


def mesh_path_check(out: dict, dev) -> dict:
    """That ``launch.train.main`` trained on the mesh path: an NCCL process
    group, the (1, 1) ("data", "model") mesh, every parameter a DTensor on
    the card."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.models.common import leaves

    params = leaves(out["state"]["params"])
    got = {"backend": out["backend"], "mesh": out["mesh"],
           "world": dist.get_world_size(),
           "dtensor_params": sum(isinstance(p, DTensor) for p in params),
           "params_on_card": sum(p.device.type == dev.type for p in params),
           "leaves": len(params)}
    if (got["backend"] != "nccl" or got["mesh"] != (("data", "model"), (1, 1))
            or got["dtensor_params"] != len(params)
            or got["params_on_card"] != len(params)):
        raise AssertionError(f"the launcher did not train on the 1 x 1 NCCL "
                             f"mesh with DTensor parameters on the card: "
                             f"{got}")
    return got


def launcher_training(dev, arch: str, steps: int, batch: int,
                      seq: int) -> dict:
    """``arch`` trained at full width on the card through the launcher's
    entry point (``launch.train.main`` with its defaults: strategy 2d,
    model axis 1, so the mesh path, on the world of one NCCL rank that
    ``main()`` below starts; the config's microbatches): the mesh path checked
    (``mesh_path_check``), kernel launches counted against
    ``train_launches_per_step``, the loss finite at every step; then one
    more step on the same mesh with every kernel call held in place to its
    plain version (TRAIN_CALL_REL). Returns what the phases report and the
    state, step and batch for timing."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.kernels.watch import watching
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.common import leaves
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import distribute, tree_shardings
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = replace(get_config(arch), use_pallas=True)
    per_step = train_launches_per_step(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq-len", str(seq), "--microbatches", str(cfg.microbatches),
            "--seed", "0", "--device", str(dev)]
    sops.launches = fops.launches = 0         # count the main path's launches
    t0 = time.perf_counter()
    out = train_main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {"flash_attention": fops.launches, "ssd_scan": sops.launches}
    on_mesh = mesh_path_check(out, dev)
    want = {k: v * steps for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"{launches} kernel launches in {steps} {arch} "
                             f"training steps, expected {want}")
    losses = out["losses"]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    step_s = [t for _, t in out["monitor"].history]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one more step on the same mesh, every kernel call held in place to
    # its plain version
    state = out["state"]
    del out
    model = build_model(cfg)
    train_step = make_train_step(model, OptConfig(lr=3e-3, total_steps=steps,
                                                  warmup_steps=5),
                                 n_microbatches=cfg.microbatches)
    mesh = leaves(state["params"])[0].device_mesh
    shape = ShapeConfig("check", seq, batch, "train")
    placed = tree_shardings(model.input_axes(shape), mesh, "2d",
                            model.abstract_inputs(shape))
    gen = SyntheticLM(cfg.vocab, seed=0)
    data = {k: distribute(torch.as_tensor(v, device=dev), mesh, placed[k])
            for k, v in gen.batch(steps, batch, seq).items()}

    def step(state, data):
        with activation_sharding(mesh, "2d"):
            return train_step(state, data)
    records = {}
    with watching(inplace_check(records)):
        state, metrics = step(state, data)
    calls = {k: len(v) for k, v in records.items()}
    if calls != {k: v for k, v in per_step.items() if v}:
        raise AssertionError(f"{calls} kernel calls in the checked step, "
                             f"expected {per_step}")
    worst = {k: [max(e[j] for e in v) for j in range(len(v[0]))]
             for k, v in records.items()}
    bad = {k: (w, TRAIN_CALL_REL[k]) for k, w in worst.items()
           if any(a > b for a, b in zip(w, TRAIN_CALL_REL[k]))}
    if bad or not np.isfinite(float(metrics["loss"])):
        raise AssertionError(f"in-place checks off their plain versions "
                             f"(worst, limits): {bad}; loss "
                             f"{float(metrics['loss'])}")
    return {"cfg": cfg, "params": model.n_params(), "run_s": run_s,
            "losses": losses, "step_s": step_s, "peak_memory_gb": peak_gb,
            "launches": launches, "per_step": per_step, "mesh": on_mesh,
            "checked_step_loss": float(metrics["loss"]),
            "checked_calls": calls, "worst_call_rel": worst,
            "state": state, "step": step, "batch": data}


def lm_train_phase(dev) -> dict:
    """zamba2-2.7b trained at full width through ``launch.train.main``
    (``launcher_training``)."""
    run = launcher_training(dev, LM_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    cfg = run["cfg"]
    emit("lm_train", arch=LM_ARCH, params=run["params"],
         layers=cfg.n_layers, global_batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         microbatches=cfg.microbatches, steps=TRAIN_STEPS,
         **{k: run[k] for k in ("run_s", "losses", "step_s",
                                "peak_memory_gb", "launches", "mesh")},
         launches_per_step=run["per_step"],
         **{k: run[k] for k in ("checked_step_loss", "checked_calls",
                                "worst_call_rel")},
         call_limits=TRAIN_CALL_REL)
    return {"state": run["state"], "batch": run["batch"], "step": run["step"],
            "step_s": run["step_s"], "launches": run["launches"],
            "per_step": run["per_step"], "microbatches": cfg.microbatches}


def lm_train_f32_phase(dev) -> dict:
    """One whole f32 step (loss and gradient norm) of the full-width model
    through the kernels, beside the plain path (``use_pallas=False``), a
    second correct order (the SSD kernel's output replaced by its plain
    version in chunks of 64) and two broken kernels (the SSD without its
    carry across chunks, attention without its causal mask), all on the
    same parameters and tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.watch import watching
    from repro_torch.launch.scan_drift import SCANS
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import loss_and_grads

    cfg = replace(get_config(LM_ARCH), dtype="float32")
    params = build_model(cfg).init(0, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg.vocab, seed=0).batch(0, TRAIN_F32_BATCH, TRAIN_F32_SEQ).items()}

    def run(use_pallas: bool, swap=None) -> tuple[float, float]:
        model = build_model(replace(cfg, use_pallas=use_pallas))

        def watcher(name, inputs, output):
            return swap(name, inputs) if swap else None
        with watching(watcher):
            loss, grads = loss_and_grads(model, params, batch)
        return float(loss), float(global_norm(dict(enumerate(grads))))

    def ssd_swap(scan):
        def swap(name, inputs):
            return scan(**inputs) if name == "ssd_scan" else None
        return swap

    def non_causal(name, inputs):
        if name != "flash_attention":
            return None
        return attention_ref(inputs["q"], inputs["k"], inputs["v"],
                             causal=False, sm_scale=inputs["sm_scale"])

    plain = run(False)
    readings = {
        "kernels": run(True),
        "ssd_plain_chunk64": run(True, ssd_swap(SCANS["plain_chunk64"])),
        "fault_ssd_no_carry": run(True, ssd_swap(SCANS["fault_no_carry"])),
        "fault_attention_not_causal": run(True, non_causal),
    }
    apart = {k: {"loss": abs(v[0] - plain[0]) / abs(plain[0]),
                 "grad_norm": abs(v[1] - plain[1]) / abs(plain[1])}
             for k, v in readings.items()}
    emit("lm_train_f32", arch=LM_ARCH, batch=TRAIN_F32_BATCH,
         seq=TRAIN_F32_SEQ, plain={"loss": plain[0], "grad_norm": plain[1]},
         readings={k: {"loss": v[0], "grad_norm": v[1]}
                   for k, v in readings.items()},
         apart_from_plain=apart)
    if not all(np.isfinite(v).all() for v in (plain, *readings.values())):
        raise AssertionError(f"non-finite f32 step: {readings}, plain {plain}")
    return apart


def train_timing_phase(dev, trained: dict, smi: str) -> dict:
    """Step time and tokens/s of the training run; one traced step; the
    flash-attention kernel at the training shape beside its plain version,
    its bound and SDPA (timed as the yardstick only)."""
    import numpy as np
    import torch

    warmup_s, timed = trained["step_s"][0], trained["step_s"][1:]
    trained_microbatches = trained["microbatches"]
    step_ms = float(np.median(timed)) * 1e3
    trace = profile_breakdown(
        lambda: trained["step"](trained["state"], trained["batch"]),
        {"ssd": SSD_KERNELS, "flash": FLASH_KERNELS}, top=12)
    trained.clear()                            # free the training state
    torch.cuda.empty_cache()

    flash = flash_timing(dev, FLASH_TRAIN[:6])
    # the SSD kernel at the training shape: one microbatch of the config's
    # 2, so 2 x 1024 tokens a call
    ssd = ssd_timing(dev, TRAIN_BATCH // trained_microbatches, TRAIN_SEQ)
    emit("train_timing", arch=LM_ARCH, global_batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, step_ms_median=step_ms,
         step_ms_timed=[t * 1e3 for t in timed],
         step_ms_warmup=warmup_s * 1e3,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
         ssd_share_of_step=trace["ssd"]["ms"] / step_ms,
         flash_share_of_step=trace["flash"]["ms"] / step_ms,
         step_trace=trace, flash=flash, ssd=ssd,
         card=smi)
    return {"flash": flash, "ssd": ssd}


def lm_dense_serve_phase(dev) -> dict:
    """smollm-360m at full width and depth on the card: generate() with its
    kernel launches counted (none: its serving attention is plain torch, as
    the reference's is jnp), the tokens in range (generate raises on any
    non-finite logit)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.launch.serve import generate
    from repro_torch.models.registry import build_model

    t0 = time.perf_counter()
    cfg = get_config(DENSE_ARCH)
    model = build_model(replace(cfg, use_pallas=True))
    params = model.init(seed=0, device=dev)
    batch = model.make_batch(ShapeConfig("serve", DENSE_PROMPT, DENSE_BATCH,
                                         "prefill"), seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sops.launches = fops.launches = 0         # count the main path's launches
    t0 = time.perf_counter()
    tokens, times = generate(model, params, batch, DENSE_GEN)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"flash_attention": fops.launches, "ssd_scan": sops.launches}
    if any(launches.values()):
        raise AssertionError(f"{launches} kernel launches serving "
                             f"{DENSE_ARCH}: its serving attention is plain")
    if (tuple(tokens.shape) != (DENSE_BATCH, DENSE_GEN)
            or len(times) != DENSE_GEN or int(tokens.min()) < 0
            or int(tokens.max()) >= cfg.vocab):
        raise AssertionError(f"bad generation: {tuple(tokens.shape)}")
    emit("lm_dense_serve", arch=DENSE_ARCH, params=model.n_params(),
         layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads,
         kv_heads=cfg.n_kv_heads, batch=DENSE_BATCH, prompt=DENSE_PROMPT,
         generated=DENSE_GEN, init_s=init_s, serve_s=serve_s,
         launches=launches, tokens_head=tokens[0, :8].tolist())
    return {"model": model, "params": params, "batch": batch, "times": times,
            "seconds": init_s + serve_s}


def lm_dense_timing_phase(dev, served: dict, smi: str) -> dict:
    """Prefill (median of 3) and decode times of the served smollm-360m;
    one prefill and one decode step traced."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import place_prefill_caches

    t_phase = time.perf_counter()
    model, params, batch = served["model"], served["params"], served["batch"]
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, batch)
        torch.cuda.synchronize()
        pre.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    prefill_ms = float(np.median(pre)) * 1e3
    decode_ms = float(np.median(served["times"])) * 1e3
    prefill_trace = profile_breakdown(lambda: model.prefill(params, batch))
    _, caches = model.prefill(params, batch)
    caches = place_prefill_caches(model, caches, DENSE_PROMPT + 1)
    step = {"tokens": batch["tokens"][:, -1:], "pos": DENSE_PROMPT}
    decode_trace = profile_breakdown(
        lambda: model.decode(params, step, caches))
    del caches
    out = {"prefill_ms": prefill_ms, "decode_ms_median": decode_ms,
           "decode_tokens_per_s": DENSE_BATCH / decode_ms * 1e3,
           "prefill_tokens_per_s": DENSE_BATCH * DENSE_PROMPT / prefill_ms
           * 1e3}
    emit("lm_dense_timing", arch=DENSE_ARCH, batch=DENSE_BATCH,
         prompt=DENSE_PROMPT, **out, prefill_runs_ms=[t * 1e3 for t in pre],
         decode_ms_all=[t * 1e3 for t in served["times"]],
         prefill_trace=prefill_trace, decode_trace=decode_trace,
         seconds=time.perf_counter() - t_phase, card=smi)
    return out


def lm_dense_train_phase(dev, smi: str) -> dict:
    """smollm-360m trained at full width through ``launch.train.main``
    (``launcher_training``: B2 launches counted, every B2 call of one more
    step held in place); step time, tokens/s, peak memory, one traced step;
    B2 at this shape beside its plain version, its bound and SDPA."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    run = launcher_training(dev, DENSE_ARCH, DENSE_TRAIN_STEPS,
                            DENSE_TRAIN_BATCH, DENSE_TRAIN_SEQ)
    cfg = run["cfg"]
    trace = profile_breakdown(lambda: run["step"](run["state"], run["batch"]),
                              {"flash": FLASH_KERNELS}, top=12)
    step_ms = float(np.median(run["step_s"][1:])) * 1e3
    roofline = roofline_step_phase(dev, cfg, run, step_ms, smi)
    for k in ("state", "step", "batch"):
        del run[k]
    torch.cuda.empty_cache()
    flash = flash_timing(dev, FLASH_MODEL_CASES[DENSE_ARCH])
    emit("lm_dense_train", arch=DENSE_ARCH, params=run["params"],
         layers=cfg.n_layers, global_batch=DENSE_TRAIN_BATCH,
         seq=DENSE_TRAIN_SEQ, microbatches=cfg.microbatches,
         remat_groups=cfg.remat_groups, steps=DENSE_TRAIN_STEPS,
         **{k: run[k] for k in ("run_s", "losses", "step_s",
                                "peak_memory_gb", "launches", "mesh")},
         launches_per_step=run["per_step"], step_ms_median=step_ms,
         tokens_per_s=DENSE_TRAIN_BATCH * DENSE_TRAIN_SEQ / step_ms * 1e3,
         **{k: run[k] for k in ("checked_step_loss", "checked_calls",
                                "worst_call_rel")},
         call_limits=TRAIN_CALL_REL,
         flash_share_of_step=trace["flash"]["ms"] / step_ms,
         step_trace=trace, flash=flash,
         seconds=time.perf_counter() - t_phase, card=smi)
    return {"launches": run["launches"], "per_step": run["per_step"],
            "flash": flash, "losses": run["losses"], "step_s": run["step_s"],
            "peak_memory_gb": run["peak_memory_gb"], "run_s": run["run_s"],
            "roofline": roofline}


def mesh_parity_phase(dev, dense: dict, smi: str) -> dict:
    """smollm-360m at full width and depth: the launcher's run on the 1 x 1
    mesh (``lm_dense_train``) beside the same 4 steps through
    ``run_training(mesh=None)`` (plain tensors): losses held step by step
    within MESH_LOSS_REL, step ms, tokens/s and peak GB of both side by
    side (what DTensor's dispatch costs a host-bound step); then one f32
    step (1 x 1024) through B2 on each path, loss and gradient norm held to
    DENSE_F32_REL if a non-causal attention fault through the mesh path
    lands 5x above it (else reported)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.watch import watching
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import leaves
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import (distribute, distribute_tree,
                                            tree_shardings)
    from repro_torch.train.loop import TrainLoopConfig, run_training
    from repro_torch.train.optimizer import OptConfig, global_norm
    from repro_torch.train.step import loss_and_grads

    t_phase = time.perf_counter()
    cfg = replace(get_config(DENSE_ARCH), use_pallas=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the launcher's settings (launch/train.py) with no mesh
    plain = run_training(
        build_model(cfg),
        TrainLoopConfig(steps=DENSE_TRAIN_STEPS, batch=DENSE_TRAIN_BATCH,
                        seq_len=DENSE_TRAIN_SEQ, seed=0,
                        microbatches=cfg.microbatches),
        opt_cfg=OptConfig(lr=3e-3, total_steps=DENSE_TRAIN_STEPS,
                          warmup_steps=max(DENSE_TRAIN_STEPS // 20, 5)),
        device=dev, mesh=None)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    if any(type(p).__name__ == "DTensor"
           for p in leaves(plain["state"]["params"])):
        raise AssertionError("run_training(mesh=None) made DTensors")
    del plain["state"]
    torch.cuda.empty_cache()
    apart = [abs(a - b) / abs(b) for a, b in zip(dense["losses"],
                                                 plain["losses"])]
    if len(apart) != DENSE_TRAIN_STEPS or not max(apart) <= MESH_LOSS_REL:
        raise AssertionError(f"mesh losses {dense['losses']} against the "
                             f"one-device path's {plain['losses']}: {apart} "
                             f"apart, limit {MESH_LOSS_REL}")
    plain_step_s = [t for _, t in plain["monitor"].history]
    tokens = DENSE_TRAIN_BATCH * DENSE_TRAIN_SEQ
    mesh_ms = float(np.median(dense["step_s"][1:])) * 1e3
    plain_ms = float(np.median(plain_step_s[1:])) * 1e3

    # one f32 step on each path, the same parameters and tokens
    cfg32 = replace(cfg, dtype="float32")
    model = build_model(cfg32)
    params = model.init(0, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg.vocab, seed=0).batch(0, DENSE_F32_BATCH, DENSE_F32_SEQ).items()}
    mesh = make_host_mesh(1, dev)
    shape = ShapeConfig("f32", DENSE_F32_SEQ, DENSE_F32_BATCH, "train")
    mparams = distribute_tree(params, mesh, tree_shardings(
        model.param_axes(), mesh, "2d", params))
    placed = tree_shardings(model.input_axes(shape), mesh, "2d",
                            model.abstract_inputs(shape))
    mbatch = {k: distribute(v, mesh, placed[k]) for k, v in batch.items()}

    def step(on_mesh: bool, causal: bool | None = None):
        def swap(name, inputs, output):
            if causal is None or name != "flash_attention":
                return None
            return attention_ref(inputs["q"], inputs["k"], inputs["v"],
                                 causal=causal, sm_scale=inputs["sm_scale"])
        with watching(swap):
            if on_mesh:
                with activation_sharding(mesh, "2d"):
                    loss, grads = loss_and_grads(model, mparams, mbatch)
            else:
                loss, grads = loss_and_grads(model, params, batch)
        return float(loss), float(global_norm(dict(enumerate(grads))))

    one = step(False)
    readings = {"mesh": step(True),
                "fault_mesh_attention_not_causal": step(True, causal=False)}
    f32_apart = {k: {"loss": abs(v[0] - one[0]) / abs(one[0]),
                     "grad_norm": abs(v[1] - one[1]) / abs(one[1])}
                 for k, v in readings.items()}
    fault = f32_apart["fault_mesh_attention_not_causal"]
    held = all(fault[k] > 5 * lim for k, lim in DENSE_F32_REL.items())
    del mparams, params, mbatch, batch
    torch.cuda.empty_cache()
    emit("mesh_parity", arch=DENSE_ARCH, global_batch=DENSE_TRAIN_BATCH,
         seq=DENSE_TRAIN_SEQ, steps=DENSE_TRAIN_STEPS,
         mesh={"shape": (1, 1), "backend": "nccl", "strategy": "2d"},
         losses={"mesh": dense["losses"], "one_device": plain["losses"]},
         losses_apart=apart, losses_bitwise=dense["losses"] == plain[
             "losses"], loss_limit=MESH_LOSS_REL,
         step_ms_median={"mesh": mesh_ms, "one_device": plain_ms},
         step_ms={"mesh": [t * 1e3 for t in dense["step_s"]],
                  "one_device": [t * 1e3 for t in plain_step_s]},
         tokens_per_s={"mesh": tokens / mesh_ms * 1e3,
                       "one_device": tokens / plain_ms * 1e3},
         mesh_step_cost=mesh_ms / plain_ms,
         peak_memory_gb={"mesh": dense["peak_memory_gb"],
                         "one_device": plain_peak},
         run_s={"mesh": dense["run_s"], "one_device": plain_run_s},
         f32={"batch": DENSE_F32_BATCH, "seq": DENSE_F32_SEQ,
              "one_device": {"loss": one[0], "grad_norm": one[1]},
              "readings": {k: {"loss": v[0], "grad_norm": v[1]}
                           for k, v in readings.items()},
              "apart_from_one_device": f32_apart, "limits": DENSE_F32_REL,
              "held": held},
         seconds=time.perf_counter() - t_phase, card=smi)
    if not all(np.isfinite(v).all() for v in (one, *readings.values())):
        raise AssertionError(f"non-finite f32 step: {readings}, one {one}")
    if held and any(f32_apart["mesh"][k] > lim
                    for k, lim in DENSE_F32_REL.items()):
        raise AssertionError(f"f32 step on the mesh {f32_apart['mesh']} off "
                             f"the one-device path's, limits {DENSE_F32_REL}")
    return {"mesh_ms": mesh_ms, "one_device_ms": plain_ms}


def dp_compressed_phase(dev, smi: str) -> dict:
    """``train.grad.make_dp_grad_fn`` on NCCL at world size 1 (a ("data",)
    mesh of one): over smollm-360m's full-width loss at 1 x 1024 through
    B2, the int8 + error-feedback gradients beside the uncompressed ones
    (the relative error, reported); then the reference's convergence case
    (tests/test_distributed.py: a linear regression, 150 compressed steps,
    the last loss under 1 % of the first), held."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.common import leaves
    from repro_torch.models.registry import build_model
    from repro_torch.train.grad import init_error_state, make_dp_grad_fn

    t_phase = time.perf_counter()
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    cfg = replace(get_config(DENSE_ARCH), use_pallas=True)
    model = build_model(cfg)
    params = model.init(0, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg.vocab, seed=0).batch(0, DP_BATCH, DP_SEQ).items()}
    err = init_error_state(params)
    t0 = time.perf_counter()
    loss_u, g_u, _ = make_dp_grad_fn(model.loss, mesh)(params, batch, err)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, g_c, err = make_dp_grad_fn(model.loss, mesh, compress=True)(
        params, batch, err)
    torch.cuda.synchronize()
    compressed_s = time.perf_counter() - t0
    diff = sum(float((a.double() - b.double()).square().sum())
               for a, b in zip(leaves(g_c), leaves(g_u)))
    norm = sum(float(b.double().square().sum()) for b in leaves(g_u))
    worst_leaf = max(float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(leaves(g_c), leaves(g_u)))
    residual = sum(float(e.double().square().sum()) for e in leaves(err))
    del params, g_u, g_c, err, batch
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8, 1)).astype(np.float32)
    xn = rng.normal(size=(64, 8)).astype(np.float32)
    X = torch.tensor(xn, device=dev)
    y = torch.tensor(xn @ w_true, device=dev)
    W = torch.zeros(8, 1, device=dev)

    def reg_loss(p, b):
        return ((b[0] @ p - b[1]) ** 2).mean(), {}

    fn = make_dp_grad_fn(reg_loss, mesh, compress=True, error_feedback=True)
    e = init_error_state(W)
    losses = []
    t0 = time.perf_counter()
    for _ in range(150):
        loss, g, e = fn(W, (X, y), e)
        W = W - 0.1 * g
        losses.append(float(loss))
    conv_s = time.perf_counter() - t0
    out = {"rel_error": (diff / norm) ** 0.5, "worst_leaf_rel": worst_leaf,
           "first": losses[0], "last": losses[-1]}
    emit("dp_compressed", arch=DENSE_ARCH, batch=DP_BATCH, seq=DP_SEQ,
         mesh={"shape": (1,), "names": ("data",), "backend": "nccl"},
         loss={"uncompressed": float(loss_u), "compressed": float(loss_c)},
         compressed_grad_rel_error=out["rel_error"],
         worst_leaf_rel=worst_leaf, residual_norm=residual ** 0.5,
         grad_s={"uncompressed": plain_s, "compressed": compressed_s},
         convergence={"steps": 150, "first": losses[0], "last": losses[-1],
                      "limit": "last < 0.01 x first", "seconds": conv_s},
         seconds=time.perf_counter() - t_phase, card=smi)
    if not np.isfinite(out["rel_error"]) or not losses[-1] < 0.01 * losses[0]:
        raise AssertionError(f"compressed DP: {out}")
    return out


def lm_dense_train_f32_phase(dev) -> dict:
    """One whole f32 step (loss and gradient norm) of smollm-360m at full
    width through B2, beside the plain path (``use_pallas=False``), a
    second correct order (B2's output replaced by its plain version,
    ``attention_ref``) and a broken kernel (attention without its causal
    mask), all on the same parameters and tokens. Both correct readings
    are held to DENSE_F32_REL, and the fault must land 5x above it."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.watch import watching
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import loss_and_grads

    t_phase = time.perf_counter()
    cfg = replace(get_config(DENSE_ARCH), dtype="float32")
    params = build_model(cfg).init(0, dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        cfg.vocab, seed=0).batch(0, DENSE_F32_BATCH, DENSE_F32_SEQ).items()}

    def run(use_pallas: bool, causal: bool | None = None):
        model = build_model(replace(cfg, use_pallas=use_pallas))

        def swap(name, inputs, output):
            if causal is None or name != "flash_attention":
                return None
            return attention_ref(inputs["q"], inputs["k"], inputs["v"],
                                 causal=causal, sm_scale=inputs["sm_scale"])
        with watching(swap):
            loss, grads = loss_and_grads(model, params, batch)
        return float(loss), float(global_norm(dict(enumerate(grads))))

    plain = run(False)
    readings = {"kernels": run(True),
                "attention_plain_version": run(True, causal=True),
                "fault_attention_not_causal": run(True, causal=False)}
    apart = {k: {"loss": abs(v[0] - plain[0]) / abs(plain[0]),
                 "grad_norm": abs(v[1] - plain[1]) / abs(plain[1])}
             for k, v in readings.items()}
    emit("lm_dense_train_f32", arch=DENSE_ARCH, batch=DENSE_F32_BATCH,
         seq=DENSE_F32_SEQ, plain={"loss": plain[0], "grad_norm": plain[1]},
         readings={k: {"loss": v[0], "grad_norm": v[1]}
                   for k, v in readings.items()},
         apart_from_plain=apart, limits=DENSE_F32_REL,
         seconds=time.perf_counter() - t_phase)
    if not all(np.isfinite(v).all() for v in (plain, *readings.values())):
        raise AssertionError(f"non-finite f32 step: {readings}, plain {plain}")
    for name in ("kernels", "attention_plain_version"):
        if any(apart[name][k] > lim for k, lim in DENSE_F32_REL.items()):
            raise AssertionError(f"f32 step through {name}: {apart[name]} "
                                 f"of the plain path's, limits "
                                 f"{DENSE_F32_REL}")
    fault = apart["fault_attention_not_causal"]
    if not all(fault[k] > 5 * lim for k, lim in DENSE_F32_REL.items()):
        raise AssertionError(f"the non-causal fault lands {fault} off the "
                             f"plain path, not 5x above the limits "
                             f"{DENSE_F32_REL}: the limit cannot tell it "
                             f"from a correct kernel")
    return apart


def lm_families_phase(dev, smi: str) -> dict:
    """granite-moe-3b-a800m, qwen2-vl-7b, xlstm-125m and whisper-medium at
    full width with depth cut (FAMILY_CUTS): one prefill and FAMILY_GEN
    greedy steps through generate (no kernel launch: serving attention is
    plain), then one training step of the config's microbatches with
    use_pallas, its B2 launches counted against the count the code implies
    and every B2 call held in place to its plain version; every logit and
    loss finite."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.kernels.watch import watching
    from repro_torch.launch.serve import generate
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    results = {}
    total = {"flash_attention": 0, "ssd_scan": 0}
    limit = TRAIN_CALL_REL["flash_attention"][0]
    for arch, cut in FAMILY_CUTS.items():
        t_arch = time.perf_counter()
        cfg = replace(get_config(arch), use_pallas=True, **cut)
        model = build_model(cfg)
        params = model.init(seed=0, device=dev)
        batch = model.make_batch(ShapeConfig(
            "serve", FAMILY_PROMPT, FAMILY_BATCH, "prefill"), seed=0,
            device=dev)
        sops.launches = fops.launches = 0     # count this path's launches
        tokens, times = generate(model, params, batch, FAMILY_GEN)
        torch.cuda.synchronize()
        served = {"flash_attention": fops.launches, "ssd_scan": sops.launches}
        if (any(served.values())
                or tuple(tokens.shape) != (FAMILY_BATCH, FAMILY_GEN)
                or int(tokens.min()) < 0 or int(tokens.max()) >= cfg.vocab):
            raise AssertionError(f"{arch}: {served} launches serving, tokens "
                                 f"{tuple(tokens.shape)}")
        serve_s = time.perf_counter() - t_arch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3

        per_step = train_launches_per_step(cfg)
        mb_batch, seq = FAMILY_TRAIN[arch]
        train_batch = model.make_batch(ShapeConfig(
            "train", seq, mb_batch * cfg.microbatches, "train"), seed=1,
            device=dev)
        state = {"params": params, "opt": init_opt_state(params)}
        step = make_train_step(model, OptConfig(lr=1e-4, total_steps=10,
                                                warmup_steps=1),
                               n_microbatches=cfg.microbatches)
        records = {}
        torch.cuda.reset_peak_memory_stats()
        sops.launches = fops.launches = 0
        t0 = time.perf_counter()
        with watching(inplace_check(records)):
            state, metrics = step(state, train_batch)
        loss = float(metrics["loss"])
        train_s = time.perf_counter() - t0
        launches = {"flash_attention": fops.launches,
                    "ssd_scan": sops.launches}
        calls = len(records.get("flash_attention", []))
        worst = max((e[0] for e in records.get("flash_attention", [])),
                    default=0.0)
        if launches != per_step or calls != per_step["flash_attention"]:
            raise AssertionError(f"{arch}: {launches} launches and {calls} "
                                 f"checked calls in a step, expected "
                                 f"{per_step}")
        if not worst <= limit or not np.isfinite(loss):
            raise AssertionError(f"{arch}: a B2 call {worst} of its largest "
                                 f"value off its plain version (limit "
                                 f"{limit}); loss {loss}")
        for k in total:
            total[k] += launches[k]
        results[arch] = {
            "cut": cut, "params": model.n_params(), "d_model": cfg.d_model,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "serve_batch": FAMILY_BATCH,
            "prompt": FAMILY_PROMPT, "generated": FAMILY_GEN,
            "tokens_head": tokens[0, :4].tolist(),
            "decode_ms_median": float(np.median(times)) * 1e3,
            "prefill_ms": prefill_ms, "serve_s": serve_s, "train_batch": mb_batch * cfg.microbatches,
            "train_seq": seq, "microbatches": cfg.microbatches,
            "loss": loss, "train_s": train_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": launches, "worst_call_rel": worst,
            "seconds": time.perf_counter() - t_arch}
        del model, params, state, step, train_batch, batch, metrics
        torch.cuda.empty_cache()
    xl = results["xlstm-125m"]
    emit("lm_families", families=results, call_limit=limit,
         seconds=sum(r["seconds"] for r in results.values()),
         xlstm={"prefill_ms": xl["prefill_ms"], "train_s": xl["train_s"],
                "parent": XLSTM_PARENT}, card=smi)
    return {"launches": total, "results": results}


def lm_families_mesh_phase(dev, smi: str) -> dict:
    """granite-moe-3b-a800m, qwen2-vl-7b, xlstm-125m and whisper-medium
    trained on the 1 x 1 NCCL mesh (FAMILY_MESH_WHOLE through
    ``launch.train.main``, FAMILY_MESH_CUT at full width with FAMILY_CUTS's
    depth through ``run_training(mesh=make_host_mesh(1))``): the mesh path
    checked (NCCL, the (1, 1) mesh, every parameter a DTensor on the card),
    B2 launches counted against ``train_launches_per_step``, every B2 call
    held in place to its plain version (TRAIN_CALL_REL), the losses finite;
    then the same steps on plain tensors (``run_training(mesh=None)``),
    the losses held step by step within MESH_LOSS_REL (bitwise equality
    reported), step ms and peak GB of both paths."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import ops as fops
    from repro_torch.kernels.mamba import ops as sops
    from repro_torch.kernels.watch import watching
    from repro_torch.launch.mesh import init_world, make_host_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import TrainLoopConfig, run_training
    from repro_torch.train.optimizer import OptConfig

    t_phase = time.perf_counter()
    # a world of one NCCL rank that outlives the launcher's calls, so that
    # each run's mesh can be checked after it
    if not init_world(dev) or dist.get_backend() != "nccl":
        raise AssertionError("no world of one NCCL rank")
    limit = TRAIN_CALL_REL["flash_attention"][0]
    steps = FAMILY_MESH_STEPS
    results, total = {}, 0
    try:
        for arch in FAMILY_MESH_WHOLE + FAMILY_MESH_CUT:
            t_arch = time.perf_counter()
            cut = {} if arch in FAMILY_MESH_WHOLE else FAMILY_CUTS[arch]
            cfg = replace(get_config(arch), use_pallas=True, **cut)
            mb_batch, seq = FAMILY_TRAIN[arch]
            batch = mb_batch * cfg.microbatches
            per_step = train_launches_per_step(cfg)
            # the launcher's settings (launch/train.py)
            loop = TrainLoopConfig(steps=steps, batch=batch, seq_len=seq,
                                   seed=0, microbatches=cfg.microbatches)
            opt = OptConfig(lr=3e-3, total_steps=steps,
                            warmup_steps=max(steps // 20, 5))
            records = {}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sops.launches = fops.launches = 0   # count this run's launches
            t0 = time.perf_counter()
            with watching(inplace_check(records)):
                if arch in FAMILY_MESH_WHOLE:
                    out = train_main([
                        "--arch", arch, "--steps", str(steps), "--batch",
                        str(batch), "--seq-len", str(seq), "--microbatches",
                        str(cfg.microbatches), "--seed", "0", "--device",
                        str(dev)])
                else:
                    mesh = make_host_mesh(1, dev)
                    out = run_training(build_model(cfg), loop, opt_cfg=opt,
                                       device=dev, mesh=mesh)
                    out["mesh"] = (tuple(mesh.mesh_dim_names),
                                   tuple(mesh.shape))
                    out["backend"] = dist.get_backend()
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
            launches = {"flash_attention": fops.launches,
                        "ssd_scan": sops.launches}
            on_mesh = mesh_path_check(out, dev)
            mesh_peak = torch.cuda.max_memory_allocated() / 1e9
            want = {k: v * steps for k, v in per_step.items()}
            calls = len(records.get("flash_attention", []))
            worst = max((e[0] for e in records.get("flash_attention", [])),
                        default=0.0)
            if launches != want or calls != want["flash_attention"]:
                raise AssertionError(f"{arch}: {launches} launches and "
                                     f"{calls} checked calls in {steps} "
                                     f"steps on the mesh, expected {want}")
            if not worst <= limit:
                raise AssertionError(f"{arch}: a B2 call {worst} of its "
                                     f"largest value off its plain version "
                                     f"(limit {limit})")
            mesh_losses = out["losses"]
            mesh_step_s = [t for _, t in out["monitor"].history]
            del out
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            plain = run_training(build_model(cfg), loop, opt_cfg=opt,
                                 device=dev, mesh=None)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            plain_peak = torch.cuda.max_memory_allocated() / 1e9
            plain_step_s = [t for _, t in plain["monitor"].history]
            plain_losses = plain["losses"]
            del plain
            apart = [abs(a - b) / abs(b)
                     for a, b in zip(mesh_losses, plain_losses)]
            if (len(apart) != steps or not all(np.isfinite(mesh_losses))
                    or not max(apart) <= MESH_LOSS_REL):
                raise AssertionError(f"{arch}: mesh losses {mesh_losses} "
                                     f"against the plain path's "
                                     f"{plain_losses}: {apart} apart, limit "
                                     f"{MESH_LOSS_REL}")
            total += launches["flash_attention"]
            tokens = batch * seq
            results[arch] = {
                "cut": cut, "entry": ("launch.train.main"
                                      if arch in FAMILY_MESH_WHOLE else
                                      "run_training(mesh=make_host_mesh(1))"),
                "params": build_model(cfg).n_params(), "layers": cfg.n_layers,
                "batch": batch, "seq": seq, "microbatches": cfg.microbatches,
                "steps": steps, "mesh": on_mesh,
                "launches": launches, "launches_per_step": per_step,
                "checked_calls": calls, "worst_call_rel": worst,
                "losses": {"mesh": mesh_losses, "plain": plain_losses},
                "losses_apart": apart,
                "losses_bitwise": mesh_losses == plain_losses,
                "step_ms": {"mesh": [t * 1e3 for t in mesh_step_s],
                            "plain": [t * 1e3 for t in plain_step_s]},
                "last_step_ms": {"mesh": mesh_step_s[-1] * 1e3,
                                 "plain": plain_step_s[-1] * 1e3},
                "tokens_per_s": {"mesh": tokens / mesh_step_s[-1],
                                 "plain": tokens / plain_step_s[-1]},
                "peak_memory_gb": {"mesh": mesh_peak, "plain": plain_peak},
                "run_s": {"mesh": mesh_s, "plain": plain_s},
                "seconds": time.perf_counter() - t_arch}
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    emit("lm_families_mesh", families=results, call_limit=limit,
         loss_limit=MESH_LOSS_REL, launches=total,
         seconds=time.perf_counter() - t_phase, card=smi)
    return {"launches": total, "results": results}


def extract_slice(indices: list) -> list:
    """Features of the suite's workloads ``indices``, exported with their
    inputs on the card and again with them on the host; a worker of the
    frontend phase (its own process, so that the exports run side by
    side)."""
    sys.path.insert(0, str(REPO / "src"))
    import warnings

    from repro_torch.core.features import LaunchConfig, extract
    from repro_torch.workloads.suite import suite
    warnings.filterwarnings("ignore", category=FutureWarning)
    ws = suite(device="cpu")
    out = []
    for i in indices:
        w = ws[i]
        launch = LaunchConfig(work_items=w.work_items)
        res = {"index": i}
        for side, args in (("cuda", [a.cuda() for a in w.args]),
                           ("cpu", list(w.args))):
            t0 = time.perf_counter()
            fv = extract(w.fn, *args, launch=launch)
            res[side] = {"values": fv.values.tolist(), "aux": fv.aux,
                         "ms": (time.perf_counter() - t0) * 1e3}
        out.append(res)
    return out


def hold_search_edges(w, got, want) -> str | None:
    """particlefilter's indices, searchsorted of u into the cumsum c of the
    weights: the card sums c in float32, the host accumulates in double, so
    a query near a cell's edge may land in another cell. Each card index
    must be a right answer for some c within the float32 tolerance of the
    host's: c[i - 1] < u + tol and c[i] >= u - tol, tol being
    FRONTEND_F32_REL of c's largest value (None when it holds)."""
    import torch
    x = w.args[0].cpu()
    c = torch.cumsum(x / x.sum(), 0)
    n = c.shape[0]
    u = (torch.arange(n, dtype=torch.int32) + 0.5) / n
    tol = FRONTEND_F32_REL * float(c[-1])
    i = got.cpu().long()
    below = (i == 0) | (c[(i - 1).clamp(min=0)] < u + tol)
    above = (i >= n) | (c[i.clamp(max=n - 1)] >= u - tol)
    bad = int((~(below & above)).sum())
    return f"{bad} indices no cumsum within {tol} gives" if bad else None


# workloads held otherwise than exactly or at the float32 tolerance
FRONTEND_HOLDS = {"particlefilter": hold_search_edges}


def hold_output(got, want) -> str | None:
    """Why a card output is not the host's (None when it is): integers
    exactly, float32 within FRONTEND_F32_REL of the host output's largest
    value."""
    import torch
    got, want = got.cpu(), want.cpu()
    if got.dtype != want.dtype or got.shape != want.shape:
        return f"{got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}"
    if not want.is_floating_point() and not want.is_complex():
        bad = int((got != want).sum())
        return f"{bad} of {want.numel()} integers differ" if bad else None
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    if not bool(torch.isfinite(got).all()) or err > FRONTEND_F32_REL * scale:
        return f"max abs error {err} of largest value {scale}"
    return None


def spearman(a, b) -> float | None:
    """Rank correlation, ties taking their mean rank (None when either side
    is constant)."""
    import numpy as np
    from scipy.stats import rankdata
    ra, rb = rankdata(a), rankdata(b)
    if np.ptp(ra) == 0 or np.ptp(rb) == 0:
        return None
    return float(np.corrcoef(ra, rb)[0, 1])


def frontend_phase(engines: dict, fixture: list, smi: str) -> dict:
    """The pipeline's front end on the card: the port's 328 workloads run
    on the card and held to the host; their features extracted with inputs
    on the card and on the host (equal), held to the fixture (io_bytes on
    all, flops on the dense linear-algebra and convolution kernels); the
    port's feature rows served through B1 for each device's forest."""
    import numpy as np
    import torch

    from repro_torch.core.features import FEATURE_NAMES
    from repro_torch.kernels.forest import ops
    from repro_torch.serve import ForestEngine
    from repro_torch.workloads.suite import suite

    t_phase = time.perf_counter()
    # (b) runs in worker processes beside (a)
    n_work = len(suite(sizes=("s",), device="cpu")) * 4
    chunks = [list(range(i, n_work, FRONTEND_WORKERS))
              for i in range(FRONTEND_WORKERS)]
    with ProcessPoolExecutor(FRONTEND_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")
                             ) as pool:
        futures = [pool.submit(extract_slice, c) for c in chunks]

        # (a) every workload once on the card, held to the host
        t0 = time.perf_counter()
        ws = suite(device="cuda")
        run_ms, unheld, held_otherwise = [], {}, {}
        for w in ws:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = w.fn(*w.args)
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t1) * 1e3)
            host = w.fn(*[a.cpu() for a in w.args])
            outs = out if isinstance(out, tuple) else (out,)
            hosts = host if isinstance(host, tuple) else (host,)
            key = f"{w.kernel}/{w.variant}"
            why = [r for g, h in zip(outs, hosts)
                   if (r := hold_output(g, h))]
            if why and w.kernel in FRONTEND_HOLDS:
                held_otherwise[key] = why
                why = [r for g, h in zip(outs, hosts)
                       if (r := FRONTEND_HOLDS[w.kernel](w, g, h))]
            if len(outs) != len(hosts) or why:
                unheld[key] = why or ["output count"]
        run_s = time.perf_counter() - t0
        slowest = sorted(zip(run_ms, ws), key=lambda p: -p[0])[:5]
        results = sorted((r for f in futures for r in f.result()),
                         key=lambda r: r["index"])
    extract_s = time.perf_counter() - t0
    emit("frontend_run", workloads=len(ws), seconds=run_s,
         slowest=[{"workload": f"{w.kernel}/{w.variant}", "ms": ms}
                  for ms, w in slowest],
         f32_rel_tol=FRONTEND_F32_REL, not_held=unheld,
         held_otherwise={k: {"exact_check": v, "held_by": FRONTEND_HOLDS[
             k.split("/")[0]].__name__} for k, v in held_otherwise.items()})
    failures = []
    if unheld:
        failures.append(f"card outputs off the host's: {unheld}")

    # (b) card-side and host-side features are equal
    differ = [f"{ws[r['index']].kernel}/{ws[r['index']].variant}"
              for r in results if r["cuda"]["values"] != r["cpu"]["values"]
              or r["cuda"]["aux"] != r["cpu"]["aux"]]
    ms = np.array([r[side]["ms"] for r in results for side in ("cuda", "cpu")])
    emit("frontend_extract", workloads=len(results), workers=FRONTEND_WORKERS,
         seconds=extract_s, ms_median=float(np.median(ms)),
         ms_max=float(ms.max()), card_vs_host_differ=differ)
    if len(results) != len(ws) or differ:
        failures.append(f"features differ between card and host: {differ}")

    # (c) the fixture's exact checks on this torch, and rank correlations
    by_key = {(r["app"], r["kernel"], r["variant"]): r for r in fixture}
    refs = [by_key[(w.app, w.kernel, w.variant)] for w in ws]
    io_bad = [f"{w.kernel}/{w.variant}" for w, r, f in zip(ws, results, refs)
              if r["cpu"]["aux"]["io_bytes"] != f["aux"]["io_bytes"]]
    flops_bad = [f"{w.kernel}/{w.variant}"
                 for w, r, f in zip(ws, results, refs)
                 if w.kernel in FLOPS_EXACT
                 and r["cpu"]["aux"]["flops"] != f["aux"]["flops"]]
    X_port = np.array([r["cpu"]["values"] for r in results])
    X_fix = np.array([f["features"] for f in refs])
    rho = {n: spearman(X_port[:, j], X_fix[:, j])
           for j, n in enumerate(FEATURE_NAMES)}
    emit("frontend_parity", io_bytes_exact=len(ws) - len(io_bad),
         io_bytes_off=io_bad, flops_exact_kernels=sorted(FLOPS_EXACT),
         flops_off=flops_bad, spearman=rho)
    if io_bad or flops_bad:
        failures.append(f"io_bytes off {io_bad}, flops off {flops_bad}")

    # (d) the port's rows served through B1, for each device's forest
    rows = X_port.astype(np.float32)
    served, batches = {}, 0
    ops.launches = 0                       # count the main path's launches
    for name, est in engines.items():
        with ForestEngine(est, device="cuda") as eng:
            if eng.backend != "hopper":
                raise AssertionError(f"engine serves on {eng.backend!r}")
            log_t = eng.predict(rows)
            own = eng.predict(X_fix.astype(np.float32))
            batches += eng.stats.batches
        np.testing.assert_allclose(log_t, plain_cpu(est, rows), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} port rows")
        target = np.array([f["targets"][name]["time_us"] for f in refs])
        served[name] = {
            "median_ape_port_rows": float(np.median(
                np.abs(np.exp(log_t) - target) / target)),
            "median_ape_fixture_rows": float(np.median(
                np.abs(np.exp(own) - target) / target))}
    torch.cuda.synchronize()
    launches = ops.launches
    if launches < batches or launches == 0:
        failures.append(f"{launches} forest kernel launches for {batches} "
                        f"engine batches")
    emit("frontend_serve", rows=int(len(rows)), devices=list(engines),
         kernel_launches=launches, engine_batches=batches, served=served,
         rtol=RTOL, atol=ATOL,
         phase_seconds=time.perf_counter() - t_phase, card=smi)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches,
            "features": {(w.app, w.kernel, w.variant): r["cpu"]
                         for w, r in zip(ws, results)}}


def ground_truth_phase(dev, host_features: dict, smi: str) -> dict:
    """The pipeline's ground truth on the card: ``collect`` over the suite
    at GT_SIZES, each workload timed by CUDA events (one warm-up call, then
    GT_REPEATS timed calls) beside the simulated TPUs' targets. Holds every
    card time finite and positive, no dynamo compile inside timed repeats,
    the simulated targets replayed bit for bit from a fresh rng over the
    collected features (the timing leaves the rng alone), and the features
    equal to the front end's host-side exports."""
    import numpy as np

    from repro_torch.core.devices import SIMULATED_DEVICES
    from repro_torch.core.features import FEATURE_NAMES, FeatureVector
    from repro_torch.core.power import simulate_power_mean_w
    from repro_torch.core.simulate import simulate_time_median_us
    from repro_torch.workloads import collect as gt
    from repro_torch.workloads.suite import suite

    card = gt.measured_device(dev)
    gt.stats = gt.CollectStats()             # count this run's work alone
    t0 = time.perf_counter()
    ds = gt.collect(suite(sizes=GT_SIZES, device=dev), repeats=GT_REPEATS,
                    measure_cpu=True, seed=0)
    wall_s = time.perf_counter() - t0
    st = gt.stats
    failures = []

    times = np.array([s.targets.get(card, {}).get("time_us", np.nan)
                      for s in ds.samples])
    covs = np.array([s.targets.get(card, {}).get("time_cov", np.nan)
                     for s in ds.samples])
    bad_times = [f"{s.kernel}/{s.variant}" for s, t in zip(ds.samples, times)
                 if not (np.isfinite(t) and t > 0)]
    if bad_times:
        failures.append(f"card times not finite and positive: {bad_times}")
    if st.timed_compiles:
        failures.append(f"dynamo compiled inside timed repeats: "
                        f"{st.timed_compiles}")

    # the simulated targets, replayed from a fresh rng over the features
    rng = np.random.default_rng(0)
    replay_off = []
    for s in ds.samples:
        spec = gt.spec_from_features(FeatureVector(s.features, s.aux),
                                     s.aux["work_items"])
        for d in SIMULATED_DEVICES:
            t_us, tcov = simulate_time_median_us(spec, d, rng, GT_REPEATS)
            p_w, pcov = simulate_power_mean_w(spec, d, rng, GT_REPEATS)
            if s.targets[d.name] != {"time_us": t_us, "time_cov": tcov,
                                     "power_w": p_w, "power_cov": pcov}:
                replay_off.append(f"{s.kernel}/{s.variant}/{d.name}")
    if replay_off:
        failures.append(f"simulated targets off their replay: {replay_off}")

    features_off = [f"{s.kernel}/{s.variant}" for s in ds.samples
                    if list(s.features) != host_features[
                        (s.app, s.kernel, s.variant)]["values"]
                    or s.aux != host_features[
                        (s.app, s.kernel, s.variant)]["aux"]]
    if features_off:
        failures.append(f"features off the front end's: {features_off}")

    # how the card's times rank against each feature and each simulated
    # device's times
    X = np.array([s.features for s in ds.samples])
    vs_features = {n: spearman(times, X[:, j])
                   for j, n in enumerate(FEATURE_NAMES)}
    vs_simulated = {}
    for d in SIMULATED_DEVICES:
        sim = np.array([s.targets[d.name]["time_us"] for s in ds.samples])
        vs_simulated[d.name] = {"spearman": spearman(times, sim),
                                "median_ratio": float(np.median(times / sim))}
    order = np.argsort(times)
    half = len(order) // 2

    def named(idx, values, key):
        return [{"workload": f"{ds.samples[i].kernel}/{ds.samples[i].variant}",
                 key: float(values[i])} for i in idx]
    emit("ground_truth", workloads=len(ds), sizes=list(GT_SIZES),
         repeats=GT_REPEATS, device=card, seconds=wall_s,
         export_s=st.export_s, timing_s=st.measure_s,
         time_us_min=float(np.nanmin(times)),
         time_us_max=float(np.nanmax(times)),
         orders_of_magnitude=float(np.log10(np.nanmax(times)
                                            / np.nanmin(times))),
         cov_mean_shorter_half=float(np.mean(covs[order[:half]])),
         cov_mean_longer_half=float(np.mean(covs[order[half:]])),
         slowest=named(order[::-1][:5], times, "time_us"),
         highest_cov_longer_half=named(
             order[half:][np.argsort(covs[order[half:]])[::-1][:5]], covs,
             "time_cov"),
         vs_simulated=vs_simulated, spearman_vs_features=vs_features,
         timed_compiles=st.timed_compiles,
         simulated_targets_replayed=len(ds) * len(SIMULATED_DEVICES)
         - len(replay_off),
         features_equal_frontend=len(ds) - len(features_off), card=smi)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"dataset": ds, "device": card}


def cv_worker(samples: list, devices: list) -> dict:
    """Nested CV (``core/cv.py``, CV_GRID and CV_CONFIG) on each device's
    ``time_us`` of the dataset ``samples`` (its samples' JSON), after
    ``reduce_overrepresented()``; a worker of the ground-truth phases (its
    own process, so that it runs beside the LM phases)."""
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.core.cv import CVConfig, nested_cv
    from repro_torch.core.dataset import Dataset, Sample

    ds = Dataset([Sample.from_json(d) for d in samples]).reduce_overrepresented()
    out = {}
    for name in devices:
        X, y, _ = ds.matrix(name, "time_us")
        res = nested_cv(X, y, CVConfig(grid=CV_GRID, **CV_CONFIG))
        out[name] = {"rows": int(len(y)), **res.summary(),
                     "best_params_mode": res.best_params_mode(),
                     "fold_mape": res.scores.tolist()}
    return out


def ground_truth_serve_phase(dev, truth: dict, smi: str) -> dict:
    """The paper-profile forest fitted on the log of the card's times,
    served through B1 on all of the ground truth's rows and held to the
    plain CPU dense path; B1's launches counted."""
    import numpy as np
    import torch

    from repro_torch.core.features import FEATURE_NAMES
    from repro_torch.core.forest import ExtraTreesRegressor
    from repro_torch.kernels.forest import ops
    from repro_torch.serve import ForestEngine

    X, y, _ = truth["dataset"].matrix(truth["device"], "time_us")
    X = X.astype(np.float32)
    t0 = time.perf_counter()
    est = ExtraTreesRegressor(n_estimators=N_TREES, criterion="mse",
                              max_features="max", seed=0).fit(X, np.log(y))
    fit_s = time.perf_counter() - t0
    ops.launches = 0                       # count the main path's launches
    with ForestEngine(est, device=dev) as eng:
        if eng.backend != "hopper":
            raise AssertionError(f"engine serves on {eng.backend!r}")
        log_t = eng.predict(X)
        batches = eng.stats.batches
    torch.cuda.synchronize()
    launches = ops.launches
    np.testing.assert_allclose(log_t, plain_cpu(est, X), rtol=RTOL, atol=ATOL,
                               err_msg="forest on the card's times")
    if launches < batches or launches == 0:
        raise AssertionError(f"{launches} forest kernel launches for "
                             f"{batches} engine batches")
    # the engine serves the trees cut at dense depth DEPTH; beside it, the
    # whole trees' in-sample error (the host's tree walk)
    full = est.predict(X)
    top = np.argsort(est.feature_importances_)[::-1][:5]
    emit("ground_truth_serve", rows=int(len(X)), trees=N_TREES,
         device=truth["device"], fit_s=fit_s, avg_depth=est.avg_depth(),
         kernel_launches=launches, engine_batches=batches, depth=DEPTH,
         median_ape_in_sample=float(np.median(np.abs(np.exp(log_t) - y) / y)),
         median_ape_in_sample_whole_trees=float(
             np.median(np.abs(np.exp(full) - y) / y)),
         top_features={FEATURE_NAMES[j]: float(est.feature_importances_[j])
                       for j in top},
         rtol=RTOL, atol=ATOL, card=smi)
    return {"est": est, "X": X, "launches": launches}


def stream_refresh_phase(dev, truth: dict, served: dict, smi: str) -> dict:
    """The suite at STREAM_SIZES measured on a collector thread into a
    store, while a refresher refits a STREAM_TREES-tree forest on each new
    snapshot and hot-swaps it into a live engine on the card (starting from
    the ground-truth forest), and a reader thread predicts a fixed batch
    all the while. Every answered batch is held to one generation's plain
    CPU dense path; after the stream the engine is held to a deterministic
    refit of the last snapshot."""
    import threading

    import numpy as np
    import torch

    from repro_torch.core.dataset import DatasetStore
    from repro_torch.kernels.forest import ops
    from repro_torch.serve import (EngineRefresher, ForestEngine,
                                   single_device_fit_fn)
    from repro_torch.workloads import collect as gt
    from repro_torch.workloads.stream import StreamingCollector
    from repro_torch.workloads.suite import suite

    card, X = truth["device"], served["X"]
    fit_fn = single_device_fit_fn(card, n_estimators=STREAM_TREES)
    fitted = [served["est"]]                 # generation g serves fitted[g]

    def fit_and_keep(ds):
        est = fit_fn(ds)
        fitted.append(est)
        return est

    workloads = suite(sizes=STREAM_SIZES, device=dev)
    store = DatasetStore(max_per_group=100, seed=0)
    gt.stats = gt.CollectStats()
    ops.launches = 0                       # count the main path's launches
    engine = ForestEngine(served["est"], device=dev)
    answers, reader_errors, reads = {}, [], 0
    stop = threading.Event()

    def reader():
        nonlocal reads
        try:
            while not stop.is_set():
                before = engine.generation
                out = engine.predict(X)
                answers.setdefault((before, engine.generation, out.tobytes()),
                                   out)
                reads += 1
                stop.wait(0.005)
        except Exception as exc:           # surfaced below
            reader_errors.append(exc)

    refresher = EngineRefresher(store, engine, fit_and_keep,
                                min_samples=STREAM_MIN_SAMPLES, poll_s=0.05)
    collector = StreamingCollector(store, workloads, repeats=GT_REPEATS,
                                   measure_cpu=True, chunk_size=STREAM_CHUNK,
                                   seed=0)
    thread = threading.Thread(target=reader, name="stream-reader")
    t0 = time.perf_counter()
    thread.start()
    refresher.start()
    collector.start()
    try:
        finished = collector.wait(timeout=600)
        deadline = time.monotonic() + 120
        while (refresher.stats.last_version < store.version
               and refresher.stats.failed_version != store.version
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        collector.stop()
        refresher.stop()
        stop.set()
        thread.join(timeout=60)
    stream_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = ops.launches
    failures = []
    if thread.is_alive() or reader_errors:
        failures.append(f"reader: alive {thread.is_alive()}, {reader_errors}")
    if (not finished or collector.error is not None
            or collector.collected != len(workloads)):
        failures.append(f"collector: finished {finished}, error "
                        f"{collector.error!r}, {collector.collected} of "
                        f"{len(workloads)} samples")
    st = refresher.stats
    if (st.refreshes < 2 or st.errors or st.last_version != store.version
            or len(fitted) != st.refreshes + 1):
        failures.append(f"refresher: {st}, {len(fitted)} fits")

    # every answered batch is one generation's answer, whole: a generation
    # the batch could have come from (its engine's generation before and
    # after the call, and those between) whose plain path it equals
    plains = {}

    def answer_of(g):
        if g not in plains:
            plains[g] = plain_cpu(fitted[g], X)
        return plains[g]
    mixed, gens_served = [], set()
    for (g0, g1, _), out in answers.items():
        whole = [g for g in range(g0, min(g1, len(fitted) - 1) + 1)
                 if np.allclose(out, answer_of(g), rtol=RTOL, atol=ATOL)]
        if whole:
            gens_served.add(whole[0])
        else:
            mixed.append((g0, g1))
    if mixed:
        failures.append(f"batches matching no single generation: {mixed}")
    if launches < len(gens_served) or launches == 0:
        failures.append(f"{launches} forest kernel launches for "
                        f"{len(gens_served)} generations served")

    # after the stream: the engine serves a deterministic refit of the last
    # snapshot
    snap = store.snapshot()
    final = engine.predict(X)
    engine.close()
    np.testing.assert_allclose(final, plain_cpu(fit_fn(snap.dataset), X),
                               rtol=RTOL, atol=ATOL,
                               err_msg="engine after the stream")

    # the streamed features equal the ground truth's for the same workloads
    truth_by_key = {(s.app, s.kernel, s.variant): s
                    for s in truth["dataset"].samples}
    streamed, _ = store.raw()
    features_off = [s.kernel for s in streamed
                    if list(s.features) != list(truth_by_key[
                        (s.app, s.kernel, s.variant)].features)
                    or s.aux != truth_by_key[(s.app, s.kernel,
                                              s.variant)].aux]
    if features_off:
        failures.append(f"streamed features off the ground truth's: "
                        f"{features_off}")
    ratio = np.array([s.targets[card]["time_us"] / truth_by_key[
        (s.app, s.kernel, s.variant)].targets[card]["time_us"]
        for s in streamed])
    farthest = np.argsort(np.abs(np.log(ratio)))[::-1][:3]
    emit("stream_refresh", workloads=len(workloads), samples=len(streamed),
         store_version=store.version, snapshot_rows=len(snap.dataset),
         seconds=stream_s, export_s=gt.stats.export_s,
         timing_s=gt.stats.measure_s, timed_compiles=gt.stats.timed_compiles,
         refreshes=st.refreshes, refresh_errors=st.errors,
         refresh_skipped=st.skipped, generation=engine.generation,
         reads=reads, distinct_answers=len(answers),
         generations_served=sorted(gens_served), mixed_batches=len(mixed),
         kernel_launches=launches,
         time_vs_ground_truth_median=float(np.median(ratio)),
         time_vs_ground_truth_range=[float(ratio.min()), float(ratio.max())],
         time_vs_ground_truth_farthest=[
             {"workload": streamed[i].kernel, "ratio": float(ratio[i]),
              "ground_truth_us": float(truth_by_key[
                  (streamed[i].app, streamed[i].kernel,
                   streamed[i].variant)].targets[card]["time_us"])}
             for i in farthest],
         trees=STREAM_TREES, chunk=STREAM_CHUNK, card=smi)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


def plain_subset(dense, trees, Z):
    """The plain CPU dense path over the trees ``trees`` of the
    ``DenseForest`` ``dense`` on rows Z: the mean of their leaves, as
    ``DenseForestTorch`` takes it. Over every tree it is ``plain_cpu``; over
    ``live_tree_indices()`` it is what a sharded engine answers after a
    drop."""
    import numpy as np
    import torch

    from repro_torch.core.forest_torch import dense_leaf_sum
    idx = np.asarray(list(trees))
    tables = (torch.as_tensor(a[idx])
              for a in (dense.feature, dense.threshold, dense.value))
    x = torch.as_tensor(np.ascontiguousarray(Z, dtype=np.float32))
    return (dense_leaf_sum(*tables, x, dense.depth) / len(idx)).numpy(
    ).astype(np.float64)


def close_to(got, want, what):
    import numpy as np
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def engine_call(eng, Z) -> tuple:
    """One engine call: its answers, the forest kernel's launches in it and
    its host-clock ms (the answers come back to the host, so the call ends
    after the card's work)."""
    from repro_torch.kernels.forest import ops
    before = ops.launches
    t0 = time.perf_counter()
    out = eng.predict(Z)
    return out, ops.launches - before, (time.perf_counter() - t0) * 1e3


def sharded_phase(dev, est, est_deep, batches: dict, smi: str) -> dict:
    """The 512-tree forest behind ``ShardedForestEngine`` on the card at
    SHARD_COUNTS and the rows ``batches`` holds; the drops of SHARD_DROPS
    and a swap back; the 22-tree forest at DEEP_SHARDS. Every answer is
    held to the plain CPU dense path over the trees it serves, and every
    call launches the forest kernel once per live shard."""
    import numpy as np

    from repro_torch.core.forest_torch import to_dense
    from repro_torch.kernels.forest import ops
    from repro_torch.serve import ForestEngine, ShardedForestEngine

    t_phase = time.perf_counter()
    dense, dense_deep = to_dense(est, DEPTH), to_dense(est_deep, DEPTH)
    n_trees = len(est.trees_)
    want = {B: plain_subset(dense, range(n_trees), Z)
            for B, Z in batches.items()}
    big = max(batches)
    with ForestEngine(est, cache_size=0, device=dev) as eng:
        engine_call(eng, batches[big])
        unsharded_ms = float(np.median([
            engine_call(eng, batches[big])[2] for _ in range(ENGINE_CALLS)]))
    ops.launches = 0                       # count the main path's launches
    cases, engine_ms, failures = [], {}, []

    def check(eng, B, Z, oracle):
        out, launches, ms = engine_call(eng, Z)
        live = len(eng.shard_sizes)
        close_to(out, oracle, f"{eng.backend} at B={B}")
        if launches != live:
            failures.append(f"{eng.backend} at B={B}: {launches} launches "
                            f"for {live} live shards")
        cases.append({"backend": eng.backend, "B": B,
                      "shard_sizes": eng.shard_sizes, "launches": launches,
                      "max_abs_err": float(np.abs(out - oracle).max())})
        return ms

    for n in SHARD_COUNTS:
        with ShardedForestEngine(est, n_shards=n, cache_size=0,
                                 device=dev) as eng:
            if eng.backend != f"sharded-hopper-loopx{n}":
                raise AssertionError(f"{n} shards serve on {eng.backend!r}")
            for B, Z in batches.items():
                check(eng, B, Z, want[B])
            engine_ms[n] = float(np.median([
                check(eng, big, batches[big], want[big])
                for _ in range(ENGINE_CALLS)]))

    # drop shard 0, then shard 2: the mean renormalizes over the survivors
    n, drops = SHARD_DROPS
    mid = sorted(batches)[len(batches) // 2]
    Z = batches[mid]
    dropped = []
    with ShardedForestEngine(est, n_shards=n, cache_size=0,
                             device=dev) as eng:
        for idx in drops:
            lost = eng.drop_shard(idx)
            live = eng.live_tree_indices()
            check(eng, mid, Z, plain_subset(dense, live, Z))
            st = eng.stats_snapshot()
            dropped.append({"shard": idx, "trees_lost": lost,
                            "live_trees": len(live), "stats": {
                                "shard_drops": st.shard_drops,
                                "trees_lost": st.trees_lost}})
            if (st.shard_drops != len(dropped)
                    or st.trees_lost != n_trees - len(live)
                    or eng.live_trees != len(live)):
                failures.append(f"after dropping shard {idx}: {st}, "
                                f"{len(live)} live trees")
        eng.swap_estimator(est)
        check(eng, mid, Z, want[mid])
        st = eng.stats_snapshot()
        if (eng.live_trees != n_trees or st.trees_lost != 0
                or st.shard_drops != len(drops) or eng.dead_shards):
            failures.append(f"the swap did not restore the forest: {st}")

    # the 22-tree forest: one-tree shards, and shards the tree group of
    # the kernel does not divide
    for n in DEEP_SHARDS:
        with ShardedForestEngine(est_deep, n_shards=n, cache_size=0,
                                 device=dev) as eng:
            for B, Z in batches.items():
                check(eng, B, Z, plain_subset(
                    dense_deep, range(len(est_deep.trees_)), Z))
    launches = ops.launches
    emit("sharded", seconds=time.perf_counter() - t_phase, trees=n_trees,
         depth=DEPTH, cases=len(cases),
         max_abs_err=max(c["max_abs_err"] for c in cases),
         engine_ms_at_4096={str(k): v for k, v in engine_ms.items()},
         unsharded_engine_ms_at_4096=unsharded_ms, drops=dropped,
         kernel_launches=launches, results=cases, rtol=RTOL, atol=ATOL,
         card=smi)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


def replay_mismatches(cpu_report, card_report) -> list:
    """Events whose outcome differs between two replays of one trace, or
    whose predictions differ by more than RTOL / ATOL: (index, what)."""
    import numpy as np
    off = []
    card = {o.idx: o for o in card_report.outcomes}
    for a in sorted(cpu_report.outcomes, key=lambda o: o.idx):
        b = card.pop(a.idx, None)
        if b is None:
            off.append((a.idx, "missing on the card"))
        elif (a.tenant, a.kernel, a.outcome) != (b.tenant, b.kernel,
                                                 b.outcome):
            off.append((a.idx, f"{a.outcome} on the host, {b.outcome} on "
                               f"the card"))
        elif (a.prediction is None) != (b.prediction is None) or (
                a.prediction is not None and not np.isclose(
                    b.prediction, a.prediction, rtol=RTOL, atol=ATOL)):
            off.append((a.idx, f"prediction {b.prediction} on the card, "
                               f"{a.prediction} on the host"))
    off += [(i, "only on the card") for i in sorted(card)]
    return off


def cluster_phase(dev, smi: str) -> dict:
    """The port's serving entry point, ``python -m repro_torch.cluster``, as
    a subprocess on the card beside an in-process twin: a v3 and a
    v2-pinned peer held to the twin's plain CPU dense path, both metrics
    surfaces scraped for the reference's per-layer names; the subprocess
    must load the forest library the build phase left, not build it. Then
    the golden trace replayed in process through the demo frontend on the
    card and on the host: every event's outcome the same, every prediction
    within RTOL."""
    import urllib.request

    import numpy as np

    from repro_torch.cluster.remote import (REQUIRED_METRICS, RemoteReplica,
                                            demo_estimator, demo_frontend,
                                            spawn_demo_server)
    from repro_torch.cluster.transport import PROTOCOL_V3, PROTOCOL_VERSION
    from repro_torch.kernels import _build
    from repro_torch.kernels.forest import ops
    from repro_torch.workloads.trace import TraceReplayer, load_trace

    def libraries():
        return {p.name: p.stat().st_mtime_ns
                for p in _build.BUILD_DIR.glob("*.so")}
    t_phase = time.perf_counter()
    built = libraries()
    t0 = time.perf_counter()
    proc, host, port, mhost, mport = spawn_demo_server(
        0, trees=CLUSTER_TREES, n_features=CLUSTER_FEATURES, metrics_port=0,
        device=dev.type)
    startup_s = time.perf_counter() - t0
    failures, peers = [], {}
    try:
        est = demo_estimator(n_features=CLUSTER_FEATURES,
                             n_trees=CLUSTER_TREES)
        Xc = np.random.default_rng(123).lognormal(
            1.0, 1.5, size=(CLUSTER_ROWS, CLUSTER_FEATURES)).astype(
            np.float32)
        want = plain_cpu(est, Xc)
        for name, protocol in (("v3", PROTOCOL_V3), ("v2", PROTOCOL_VERSION)):
            with RemoteReplica(host, port, timeout_s=60.0,
                               protocol=protocol) as peer:
                t0 = time.perf_counter()
                got = peer.predict(Xc, deadline_s=30.0)
                ms = (time.perf_counter() - t0) * 1e3
                negotiated = peer.negotiated_version
            close_to(got, want, f"{name} peer")
            if negotiated != protocol:
                failures.append(f"{name} peer negotiated {negotiated}")
            peers[name] = {"ms": ms, "max_abs_err": float(
                np.abs(got - want).max())}
        with RemoteReplica(host, port, timeout_s=60.0) as peer:
            body = peer.metrics()
        names = {row["name"] for row in body.get("metrics", [])}
        predictions = sum(row["value"] or 0 for row in body["metrics"]
                          if row["name"] == "engine.predictions")
        with urllib.request.urlopen(f"http://{mhost}:{mport}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
        missing = [n for n in REQUIRED_METRICS if n not in names
                   or f"repro_{n.replace('.', '_')}" not in text]
        if not body.get("enabled") or missing:
            failures.append(f"metrics missing {missing}")
        if predictions < 2 * CLUSTER_ROWS:
            failures.append(f"engine.predictions {predictions}")
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    if libraries() != built:
        failures.append(f"the server built the forest library again: "
                        f"{sorted(built)} -> {sorted(libraries())}")

    # the golden trace, in process, on the host and on the card
    trace = load_trace(TRACE_FIXTURE)
    reports, launches, batches = {}, 0, 0
    for side, device in (("host", "cpu"), ("card", dev.type)):
        fe = demo_frontend(seed=3, n_features=CLUSTER_FEATURES,
                           device=device).start()
        engine = fe.pool.replicas["local"].engine
        ops.launches = 0                   # count the main path's launches
        try:
            reports[side] = TraceReplayer(fe, pacing="sequential").replay(
                trace)
        finally:
            fe.close()
        if side == "card":
            # the pool's health probes serve through the same engine: each
            # engine batch, request or probe, is one launch
            launches, batches = ops.launches, engine.stats.batches
    cpu, card = reports["host"], reports["card"]
    off = replay_mismatches(cpu, card)
    if off or cpu.count("served") != len(trace):
        failures.append(f"replay: {cpu.count('served')} of {len(trace)} "
                        f"served on the host, off on the card: {off[:5]}")
    if launches != batches or launches < card.count("served"):
        failures.append(f"{launches} launches for {batches} engine batches, "
                        f"{card.count('served')} events served")
    emit("cluster", seconds=time.perf_counter() - t_phase,
         server_startup_s=startup_s, trees=CLUSTER_TREES,
         features=CLUSTER_FEATURES, rows=CLUSTER_ROWS, peers=peers,
         metrics=len(names), required_metrics=list(REQUIRED_METRICS),
         server_engine_predictions=predictions,
         library_rebuilt=libraries() != built, trace_events=len(trace),
         cpu_digest=cpu.digest(), card_digest=card.digest(),
         outcomes_equal=not off,
         wall_ms_per_request={"cpu": cpu.wall_s / len(trace) * 1e3,
                              "card": card.wall_s / len(trace) * 1e3},
         served_p50_ms={"cpu": cpu.served_wall_ms(50),
                        "card": card.served_wall_ms(50)},
         kernel_launches=launches, engine_batches=batches, card=smi)
    if failures:
        raise AssertionError("; ".join(failures))
    return {"launches": launches}


def supervise_phase(dev, est, dev0: str, smi: str) -> dict:
    """The port's supervisor smoke on the card (``serve/supervise.py``:
    day-zero transfer tier, measured feedback, graduation into a forest
    served by the kernel), then its scenario again with a
    ``MultiDeviceEngine`` that graduation extends by ``add_device``: the
    graduated engine held to the plain CPU dense path of its forest, the
    pricing matrix's new column to it, every launch to an engine batch.
    The targets are simulated (``cliff_rows`` on tpu-v5e's model), so the
    MAPEs are the simulator's."""
    import numpy as np

    from repro_torch.cluster.frontend import ClusterFrontend
    from repro_torch.cluster.replicas import ReplicaPool
    from repro_torch.core.dataset import DatasetStore, Sample
    from repro_torch.core.devices import TPU_V5E
    from repro_torch.core.metrics import mape
    from repro_torch.core.transfer import TransferConfig, select_probes
    from repro_torch.kernels.forest import ops
    from repro_torch.obs.calibration import CalibrationMonitor
    from repro_torch.obs.registry import MetricsRegistry
    from repro_torch.serve import (EngineConfig, ForestEngine,
                                   MultiDeviceEngine, SupervisorConfig,
                                   TransferSupervisor, build_transfer_engine)
    from repro_torch.serve import supervise

    t_phase = time.perf_counter()
    ops.launches = 0                       # count the main path's launches
    if supervise.smoke(device=dev.type) != 0:
        raise AssertionError("the supervisor smoke failed")
    smoke_s, smoke_launches = time.perf_counter() - t_phase, ops.launches
    if smoke_launches == 0:
        raise AssertionError("the supervisor smoke never launched the kernel")

    name = "day-zero-accelerator"
    Xp, yp = supervise.cliff_rows(TPU_V5E, 160, seed=1)       # probe stream
    Xev, yev = supervise.cliff_rows(TPU_V5E, 48, seed=2)      # eval set
    reg = MetricsRegistry()
    mon = CalibrationMonitor(reg, alpha=0.3)
    tp = build_transfer_engine(name, monitor=mon, config=TransferConfig(
        min_samples_leaf=4, shrinkage=32.0))
    store = DatasetStore()
    pool = ReplicaPool({"cold": tp}, check_interval_s=60.0)
    known = ForestEngine(est, cache_size=0, device=dev)
    multi = MultiDeviceEngine({dev0: {MultiDeviceEngine.TIME: known,
                                      MultiDeviceEngine.POWER: None}})
    sup = TransferSupervisor(
        store, mon, pool=pool, multi_engine=multi, registry=reg,
        config=SupervisorConfig(
            min_graduate_samples=96, plateau_window=3,
            engine_config=EngineConfig(cache_size=0, device=dev.type)))
    sup.manage(tp, replica="cold", key=name)
    before = ops.launches
    with ClusterFrontend(pool, max_queue=64) as fe:
        m_day0 = mape(yev, fe.predict(Xev))
        m_plateau = m_day0
        order = select_probes(Xp, len(Xp))
        for start in range(0, len(order), 8):
            if sup.stats_snapshot()["devices"][name]["stage"] == "transfer":
                m_plateau = mape(yev, fe.predict(Xev))
            store.extend([Sample(app="smoke", kernel=f"k{j}", variant="s",
                                 features=Xp[j],
                                 targets={name: {"time_us": float(yp[j])}})
                          for j in order[start:start + 8]])
            sup.supervise_once()
        snap = sup.stats_snapshot()
        m_final = mape(yev, fe.predict(Xev))
        graduated = multi.engines.get(name, {}).get(MultiDeviceEngine.TIME)
        if (snap["devices"][name]["stage"] != "forest" or graduated is None
                or graduated.backend != "hopper"):
            raise AssertionError(f"no graduation onto the card: {snap}, "
                                 f"{multi.device_names}")
        log_t = graduated.predict(Xev)
        close_to(log_t, plain_cpu(graduated.est, Xev), "graduated engine")
        T, _ = multi.price(Xev)
        np.testing.assert_array_equal(T[:, multi.device_names.index(name)],
                                      np.exp(log_t))
    multi.close()
    launches = ops.launches - before
    batches = graduated.stats.batches + known.stats.batches
    emit("supervise", seconds=time.perf_counter() - t_phase,
         smoke_s=smoke_s, smoke_launches=smoke_launches,
         graduated_at_n=snap["devices"][name]["graduated_at_n"],
         slot_generation=snap["devices"][name]["slot_generation"],
         feedback=snap["stats"].feedback, devices=multi.device_names,
         simulated_mape_pct={"day_zero": m_day0, "plateau": m_plateau,
                             "graduated": m_final},
         kernel_launches=launches, engine_batches=batches,
         trees=len(graduated.est.trees_), card=smi)
    if launches != batches or not m_final < m_day0 \
            or m_final > 1.10 * m_plateau:
        raise AssertionError(f"{launches} launches for {batches} engine "
                             f"batches; MAPE {m_day0} -> {m_plateau} -> "
                             f"{m_final}")
    return {"launches": smoke_launches + launches}


def roofline_calibration_phase(dev, smi: str) -> dict:
    """(a) The counter and the card's constants against two programs whose
    bound is known: a bf16 matmul of CALIB_MATMUL_N^3 (counted FLOPs
    exactly 2 N^3) and a clone of CALIB_CLONE_BYTES of bf16 (counted bytes
    exactly twice that: read once, written once), each timed by CUDA
    events; roofline_frac = bound / measured, at most ROOFLINE_SHARE_MAX.
    ``HBM_PER_CHIP`` is held to the card's ``total_memory``."""
    import torch
    from repro_torch.core.hlo_analysis import count_program
    from repro_torch.launch.roofline import (HBM_PER_CHIP, ROOFLINE_HBM_BW,
                                             ROOFLINE_PEAK_FLOPS)

    total = torch.cuda.get_device_properties(0).total_memory
    if total != HBM_PER_CHIP:
        raise AssertionError(f"HBM_PER_CHIP {HBM_PER_CHIP} against the "
                             f"card's total_memory {total}")
    n = CALIB_MATMUL_N
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=g, device=dev, dtype=torch.bfloat16)
    mm = count_program(torch.matmul, a, b).costs
    if mm.flops != 2 * n ** 3:
        raise AssertionError(f"counted {mm.flops} FLOPs for a {n}^3 matmul")
    mm_ms = cuda_ms(lambda: torch.matmul(a, b), iters=20, warmup=5)
    mm_bound = mm.flops / ROOFLINE_PEAK_FLOPS * 1e3
    del a, b
    x = torch.empty(CALIB_CLONE_BYTES // 2, dtype=torch.bfloat16, device=dev)
    x.normal_(generator=g)
    cp = count_program(torch.clone, x).costs
    if cp.hbm_bytes != 2 * CALIB_CLONE_BYTES:
        raise AssertionError(f"counted {cp.hbm_bytes} bytes for a clone of "
                             f"{CALIB_CLONE_BYTES}")
    cp_ms = cuda_ms(lambda: x.clone(), iters=10, warmup=2)
    cp_bound = cp.hbm_bytes / ROOFLINE_HBM_BW * 1e3
    del x
    torch.cuda.empty_cache()
    out = {"matmul": {"n": n, "flops": mm.flops, "ms": mm_ms,
                      "bound_ms": mm_bound, "roofline_frac": mm_bound / mm_ms},
           "clone": {"bytes": cp.hbm_bytes, "ms": cp_ms, "bound_ms": cp_bound,
                     "roofline_frac": cp_bound / cp_ms},
           "total_memory": total}
    emit("roofline_calibration", **out, share_max=ROOFLINE_SHARE_MAX,
         peak_flops=ROOFLINE_PEAK_FLOPS, hbm_bw=ROOFLINE_HBM_BW, card=smi)
    high = {k: v["roofline_frac"] for k, v in out.items()
            if isinstance(v, dict) and v["roofline_frac"] > ROOFLINE_SHARE_MAX}
    if high:
        raise AssertionError(f"roofline shares above {ROOFLINE_SHARE_MAX}: "
                             f"{high}")
    return out


def roofline_step_phase(dev, cfg, run: dict, step_ms: float,
                        smi: str) -> dict:
    """(b) lm_dense_train's step counted on its real tensors (the 1 x 1
    NCCL mesh, B2 counted as its plain version's FLOPs): the report's row,
    useful_ratio, the counted FLOPs against ``model_flops_for``; the step's
    measured ms at least the roofline bound; the counted live-bytes peak
    within PEAK_FACTOR of ``max_memory_allocated`` over the same step."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.hlo_analysis import count_program, xla_cost_analysis
    from repro_torch.launch.roofline import analyze_cell

    shape = ShapeConfig("lm_dense_train", DENSE_TRAIN_SEQ, DENSE_TRAIN_BATCH,
                        "train")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counted = count_program(run["step"], run["state"], run["batch"],
                            n_devices=1)
    torch.cuda.synchronize()
    torch_peak = torch.cuda.max_memory_allocated()
    loss = float(counted.output[1]["loss"])
    del counted.output
    rep = analyze_cell(counted.costs, peak_bytes=counted.peak_bytes,
                       arg_bytes=counted.arg_bytes, out_bytes=counted.out_bytes,
                       xla_flops=xla_cost_analysis(counted)["flops"],
                       arch=DENSE_ARCH, shape=shape, mesh_name="1x1",
                       n_devices=1, strategy="2d", cfg=cfg)
    bound_ms = rep.t_bound * 1e3
    out = {"row": rep.row(), "useful_ratio": rep.useful_ratio,
           "counted_flops": rep.hlo_flops, "model_flops": rep.model_flops,
           "library_flops": rep.xla_flops, "hbm_bytes": rep.hlo_bytes,
           "transcendentals": counted.costs.transcendentals,
           "collective_counts": counted.costs.collective_counts,
           "dominant": rep.dominant, "t_compute_ms": rep.t_compute * 1e3,
           "t_memory_ms": rep.t_memory * 1e3, "bound_ms": bound_ms,
           "step_ms": step_ms, "bound_share": bound_ms / step_ms,
           "counted_peak_bytes": counted.peak_bytes,
           "torch_peak_bytes": torch_peak,
           "peak_ratio": counted.peak_bytes / torch_peak,
           "counting_s": counted.seconds, "loss": loss}
    emit("roofline_step", arch=DENSE_ARCH, global_batch=DENSE_TRAIN_BATCH,
         seq=DENSE_TRAIN_SEQ, mesh="1x1 NCCL", **out,
         peak_factor=PEAK_FACTOR, card=smi)
    if not np.isfinite(loss):
        raise AssertionError(f"the counted step's loss {loss}")
    if step_ms < bound_ms:
        raise AssertionError(f"the step took {step_ms} ms, under its "
                             f"roofline bound {bound_ms} ms")
    if not 1 / PEAK_FACTOR <= out["peak_ratio"] <= PEAK_FACTOR:
        raise AssertionError(f"counted peak {counted.peak_bytes} against "
                             f"torch's {torch_peak}")
    return out


def roofline_autotune_phase(dev, smi: str) -> dict:
    """(c) ``launch.train.main --autotune`` on the card (the world of one
    NCCL rank that main() keeps): the strategies counted on meta
    arguments on the launcher's 1 x 1 mesh and ranked by the card's
    roofline, the pick trained for AUTOTUNE_STEPS steps, every loss
    finite."""
    import numpy as np
    from repro_torch.launch.train import main as train_main

    t0 = time.perf_counter()
    out = train_main(["--arch", AUTOTUNE_ARCH, "--autotune", "--steps",
                      str(AUTOTUNE_STEPS), "--batch", str(AUTOTUNE_BATCH),
                      "--seq-len", str(AUTOTUNE_SEQ), "--seed", "0",
                      "--device", str(dev)])
    seconds = time.perf_counter() - t0
    tuned, losses = out["autotune"], out["losses"]
    got = {"pick": tuned.best, "ranked": tuned.ranked,
           "strategy": out["strategy"], "losses": losses,
           "autotune_s": tuned.lower_seconds + tuned.predict_seconds,
           "seconds": seconds}
    emit("roofline_autotune", arch=AUTOTUNE_ARCH, batch=AUTOTUNE_BATCH,
         seq=AUTOTUNE_SEQ, **got, card=smi)
    if (out["strategy"] != tuned.best or len(losses) != AUTOTUNE_STEPS
            or not all(np.isfinite(losses))):
        raise AssertionError(f"autotune trained {out['strategy']!r} (picked "
                             f"{tuned.best!r}), losses {losses}")
    return got


@contextlib.contextmanager
def dryrun_cell():
    """(d) ``python -m repro_torch.launch.dryrun`` on DRYRUN_CELL in a
    subprocess off the card (meta tensors on a fake process group), for
    the block's length: yields (process, start time); the process is
    killed at the end of the block if it still runs."""
    import os
    arch, shape, _, strategy = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--strategy", strategy], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        yield proc, time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def roofline_dryrun_phase(started: tuple, smi: str) -> dict:
    """(d) The dry-run cell's record: status ok, its report's row and its
    seconds."""
    proc, t0 = started
    log, _ = proc.communicate(timeout=max(
        1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)))
    seconds = time.perf_counter() - t0
    from repro_torch.launch.dryrun import ARTIFACTS
    from repro_torch.launch.roofline import RooflineReport
    path = ARTIFACTS / ("__".join(DRYRUN_CELL) + ".json")
    if proc.returncode != 0 or not path.exists():
        raise AssertionError(f"the dry-run cell exited {proc.returncode}:\n"
                             f"{log[-4000:]}")
    rec = json.loads(path.read_text())
    if rec.get("status") != "ok":
        raise AssertionError(f"the dry-run cell's record: {rec}")
    rep = RooflineReport(**rec["report"])
    out = {"tag": rec["tag"], "status": rec["status"], "row": rep.row(),
           "counting_s": rec["lower_s"], "seconds": seconds,
           "hlo_flops": rep.hlo_flops, "xla_flops": rep.xla_flops,
           "hlo_bytes": rep.hlo_bytes,
           "collective_bytes": rep.collective_bytes,
           "collective_breakdown": rep.collective_breakdown,
           "peak_bytes": rep.peak_bytes, "temp_bytes": rep.temp_bytes,
           "arg_bytes": rep.arg_bytes, "fits_hbm": rep.fits_hbm,
           "peak_max": DRYRUN_PEAK_MAX, "features": rec["features"]}
    emit("roofline_dryrun", **out, card=smi)
    if not (rep.fits_hbm and rep.peak_bytes < DRYRUN_PEAK_MAX):
        raise AssertionError(f"the dry-run cell counts a peak of "
                             f"{rep.peak_bytes} bytes a rank (fits_hbm "
                             f"{rep.fits_hbm}), limit {DRYRUN_PEAK_MAX}")
    return out


def loss_shards_phase(dev, smi: str) -> dict:
    """Fault F7's loss on the 1 x 1 NCCL mesh: ``cross_entropy_loss`` on
    DTensor logits (``sharding.context.cross_entropy_on_shards``, the
    vocabulary "sharded" over the model axis, every collective trivial)
    beside the plain path on the same f32 tensor, loss and logits gradient
    held at LOSS_RTOL; for each, the peak the forward and backward allocate
    over their inputs (``torch.cuda.max_memory_allocated``) and the ms of
    one forward and backward (CUDA events)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.common import cross_entropy_loss

    t_phase = time.perf_counter()
    mesh = make_host_mesh(1, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, V = LOSS_SHAPE
    x = 3.0 * torch.randn(LOSS_SHAPE, device=dev, generator=gen)
    y = torch.randint(0, V, (B, S), device=dev, generator=gen)
    on_mesh = (DTensor.from_local(x, mesh, [Shard(0), Shard(2)],
                                  run_check=False),
               DTensor.from_local(y, mesh, [Shard(0), Replicate()],
                                  run_check=False))

    def run(logits, labels):
        a = logits.detach().requires_grad_()
        loss = cross_entropy_loss(a, labels)
        return loss.detach(), torch.autograd.grad(loss, a)[0]

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t

    got = {}
    for name, args in (("plain", (x, y)), ("shards", on_mesh)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grad = run(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        got[name] = {"loss": local(loss), "grad": local(grad),
                     "peak_bytes": peak,
                     "ms": cuda_ms(lambda args=args: run(*args), 5, 1)}
    plain, shards = got["plain"], got["shards"]
    loss_apart = float(abs(shards["loss"] - plain["loss"])
                       / abs(plain["loss"]))
    grad_err = float((shards["grad"] - plain["grad"]).abs().max())
    grad_max = float(plain["grad"].abs().max())
    out = {"shape": LOSS_SHAPE, "mesh": {"shape": (1, 1), "backend": "nccl"},
           "loss": {k: float(v["loss"]) for k, v in got.items()},
           "loss_apart": loss_apart, "grad_max_abs_err": grad_err,
           "grad_max": grad_max, "rtol": LOSS_RTOL,
           "bitwise": bool(torch.equal(shards["loss"], plain["loss"])
                           and torch.equal(shards["grad"], plain["grad"])),
           "peak_bytes": {k: v["peak_bytes"] for k, v in got.items()},
           "ms": {k: v["ms"] for k, v in got.items()},
           "seconds": time.perf_counter() - t_phase}
    emit("loss_shards", **out, card=smi)
    torch.testing.assert_close(shards["loss"], plain["loss"],
                               rtol=LOSS_RTOL, atol=0)
    torch.testing.assert_close(shards["grad"], plain["grad"],
                               rtol=LOSS_RTOL, atol=LOSS_RTOL * grad_max)
    del got, plain, shards, x, y, on_mesh
    torch.cuda.empty_cache()
    return out


def mesh_cell(cell: tuple) -> dict:
    """One F6 or POD cell (arch, mesh shape, strategy) in this worker
    process, off the card: tests/_mesh_cells.py's ``run_cell`` (the cut
    ``train_4k`` step on meta tensors over a fake process group), with the
    strategy "peak" one of PEAK_CELLS (``peak_cell``), with "cause" one of
    CAUSE_CELLS (its name in place of the arch, ``cause_cell``); its
    status, seconds and, if it raised, the end of its traceback."""
    import os
    import traceback
    os.nice(MESH_CELL_NICE)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path[:0] = [str(REPO / "src"), str(REPO / "tests")]
    import torch
    torch.set_num_threads(1)
    from _mesh_cells import run_cell

    arch, mesh_shape, strategy = cell
    out = {"arch": arch, "mesh": "x".join(map(str, mesh_shape)),
           "strategy": strategy}
    t0 = time.perf_counter()
    try:
        if strategy == "peak":
            out.update(strategy="2d", **peak_cell(arch))
        elif strategy == "xlstm":
            out.update(strategy="2d", **xlstm_cell())
        elif strategy == "cause":
            out.update(strategy="2d", **cause_cell(arch))
        elif strategy == "cut":
            out.update(strategy="2d", **cut_cell(arch))
        else:
            got = run_cell(arch, mesh_shape, strategy)
            out["ok"] = (got["loss_shape"] == () and got["placements"]
                         == got["want"] == got["out_pl"])
            if not out["ok"]:
                out["error"] = "the loss is not a scalar, or the state " \
                               "left its placements"
    except Exception:               # reported; the phase fails on it
        out["ok"] = False
        out["error"] = traceback.format_exc()[-3000:]
    out["seconds"] = time.perf_counter() - t0
    out["done_at"] = time.time()
    return out


def peak_cell(arch: str) -> dict:
    """One of PEAK_CELLS counted in this worker: the cell's ``train_4k``
    step with its depth cut, on meta tensors over a fake (16, 16) process
    group under 2d and torch 2.11's view rule, as
    tests/test_torch_loss_shards.py counts it; its peak a rank, its bound
    and whether it stays under it."""
    from dataclasses import replace

    from _mesh_cells import fake_mesh, view_rule_2_11
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core.autotune import strategy_costs
    from repro_torch.models.registry import build_model

    layers, most = PEAK_CELLS[arch]
    model = build_model(replace(ARCHS[arch], n_layers=layers))
    with fake_mesh((16, 16)) as mesh, view_rule_2_11():
        run = strategy_costs(model, SHAPES["train_4k"], mesh, "2d")
    out = {"layers": layers, "peak_bytes": run.peak_bytes,
           "peak_max": most, "ok": run.peak_bytes < most}
    if not out["ok"]:
        out["error"] = f"counts {run.peak_bytes} bytes a rank, bound {most}"
    return out


def xlstm_cell() -> dict:
    """The XLSTM_CELL counted in this worker, as peak_cell counts its cells:
    its peak a rank beside its bound; then its one-device step traced
    (``core/features.py::trace_graph``) and its 12 features extracted, as
    the dry-run records them; the count of ``scan`` nodes in the trace."""
    from dataclasses import replace

    import numpy as np
    import torch
    from _mesh_cells import fake_mesh, view_rule_2_11
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core.autotune import strategy_costs
    from repro_torch.core.features import (LaunchConfig, extract_from_graph,
                                           trace_graph)
    from repro_torch.launch.cells import cell_fns

    from repro_torch.models.registry import build_model

    layers, most = XLSTM_CELL
    shape = SHAPES["train_4k"]
    model = build_model(replace(ARCHS["xlstm-125m"], n_layers=layers))
    with fake_mesh((16, 16)) as mesh, view_rule_2_11():
        t0 = time.perf_counter()
        run = strategy_costs(model, shape, mesh, "2d")
        t1 = time.perf_counter()
        fn, args, _, _, _ = cell_fns(model, shape, "2d", mesh)
        graph = trace_graph(fn, *args)
        t2 = time.perf_counter()
    fv = extract_from_graph(graph, LaunchConfig(
        work_items=float(shape.tokens), n_shards=256))
    scans = sum(n.target is torch.ops.higher_order.scan
                for n in graph.graph.nodes)
    out = {"layers": layers, "peak_bytes": run.peak_bytes, "peak_max": most,
           "count_s": t1 - t0, "trace_s": t2 - t1, "scans": scans,
           "features": fv.as_dict(),
           "ok": (run.peak_bytes <= most and scans > 0
                  and bool(np.isfinite(fv.values).all()))}
    if not out["ok"]:
        out["error"] = (f"counts {run.peak_bytes} bytes a rank, bound "
                        f"{most}; {scans} scan nodes in the trace; features "
                        f"{fv.as_dict()}")
    return out


def cut_cell(name: str) -> dict:
    """One of CUT_CELLS counted in this worker, as peak_cell counts its
    cells: its peak a rank beside PEAK_LIMIT times the reference's."""
    from dataclasses import replace

    from _mesh_cells import fake_mesh, view_rule_2_11
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core.autotune import strategy_costs
    from repro_torch.models.registry import build_model

    arch, layers, shape, mesh_shape, ref = CUT_CELLS[name]
    model = build_model(replace(ARCHS[arch], n_layers=layers))
    with fake_mesh(mesh_shape) as mesh, view_rule_2_11():
        run = strategy_costs(model, SHAPES[shape], mesh, "2d")
    most = PEAK_LIMIT * ref
    out = {"cell": f"{arch}:{layers} {shape}",
           "mesh": "x".join(map(str, mesh_shape)), "layers": layers,
           "peak_bytes": run.peak_bytes, "peak_max": most,
           "ratio": run.peak_bytes / ref, "ok": 0 < run.peak_bytes <= most}
    if not out["ok"]:
        out["error"] = f"counts {run.peak_bytes} bytes a rank, bound {most}"
    return out


def cause_cell(name: str) -> dict:
    """One of CAUSE_CELLS counted in this worker: the serving cell on meta
    tensors over a fake process group of its mesh under 2d, by
    ``core/autotune.py::strategy_costs``; its collective bytes a rank
    beside the reference's and whether they stay within CAUSE_LIMIT of
    them."""
    from dataclasses import replace

    from _mesh_cells import fake_mesh, view_rule_2_11
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.autotune import strategy_costs
    from repro_torch.models.registry import build_model

    arch, kw, kind, seq, batch, mesh_shape, ref = CAUSE_CELLS[name]
    cfg = ARCHS[arch] if kw is None else replace(reduced(ARCHS[arch]), **kw)
    with fake_mesh(mesh_shape) as mesh, view_rule_2_11():
        run = strategy_costs(build_model(cfg),
                             ShapeConfig("c", seq, batch, kind), mesh, "2d")
    got = run.costs.collective_bytes
    out = {"cell": arch, "mesh": "x".join(map(str, mesh_shape)),
           "collective_bytes": got, "reference_bytes": ref,
           "ratio": got / ref, "ok": 0 < got <= CAUSE_LIMIT * ref}
    if not out["ok"]:
        out["error"] = f"moves {got} collective bytes a rank, the " \
                       f"reference {ref}"
    return out


@contextlib.contextmanager
def mesh_cells_host():
    """The F6 cells on the host in MESH_CELL_WORKERS spawned processes, for
    the block's length: yields (the pool's pending results, start time);
    the pool is terminated at the end of the block."""
    pool = multiprocessing.get_context("spawn").Pool(MESH_CELL_WORKERS,
                                                     maxtasksperchild=1)
    try:
        cells = ([(a, (16, 16), "peak") for a in PEAK_CELLS]
                 + [(c, (), "cut") for c in CUT_CELLS]
                 + [("xlstm-125m", (16, 16), "xlstm")]
                 + [(c, (), "cause") for c in CAUSE_CELLS]
                 + list(POD_CELLS) + list(F6_CELLS))
        yield pool.map_async(mesh_cell, cells, chunksize=1), time.time()
    finally:
        pool.terminate()
        pool.join()


def mesh_cells_host_phase(started: tuple, smi: str) -> dict:
    """Every F6 cell's status and seconds under this torch, and each of
    PEAK_CELLS' peak beside its bound, the seconds from the pool's start
    to its last cell's end, and how long the main process waited for them
    here; fails unless every cell ran and every peak held."""
    import torch
    pending, t0 = started
    t_read = time.time()
    cells = pending.get(timeout=max(1.0, MESH_CELLS_TIMEOUT_S
                                    - (t_read - t0)))
    out = {"torch": torch.__version__, "cells": [
        {k: c[k] for k in ("arch", "cell", "mesh", "strategy", "ok",
                           "seconds", "layers", "peak_bytes", "peak_max",
                           "collective_bytes", "reference_bytes", "ratio",
                           "count_s", "trace_s", "scans", "features")
         if k in c}
        for c in cells], "ok": sum(c["ok"] for c in cells),
        "of": len(cells), "seconds": max(c["done_at"] for c in cells) - t0,
        "waited_s": time.time() - t_read, "workers": MESH_CELL_WORKERS}
    emit("mesh_cells_host", **out, card=smi)
    failed = [c for c in cells if not c["ok"]]
    if failed:
        raise AssertionError("mesh cells failed under torch "
                             f"{torch.__version__}:\n" + "\n".join(
                                 f"{c['arch']} {c['mesh']} {c['strategy']}: "
                                 f"{c['error']}" for c in failed))
    return out


def context_parallel_check() -> dict:
    """Run in the subprocess of ``context_parallel_host``, off the card:
    the context-parallel world on 4 gloo ranks under each of
    ``_gloo.CP_STRATEGIES``, held to one device; per strategy the largest
    distance in units of the tolerance (at most 1 to pass), the prefill
    K's placements, or the traceback."""
    import shutil
    sys.path[:0] = [str(REPO / "src"), str(REPO / "tests")]
    import torch
    torch.set_num_threads(1)
    import _gloo

    work = REPO / "build" / "context_parallel"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    world = _gloo.run_world("context_parallel", 4, work,
                            timeout=CP_HOST_TIMEOUT_S - 60,
                            strategies=_gloo.CP_STRATEGIES)
    want = _gloo.attention_run(None)
    out = {"torch": torch.__version__, "strategies": {}}
    for strategy in _gloo.CP_STRATEGIES:
        got = world[0][strategy]
        if "error" in got:
            out["strategies"][strategy] = {"error": got["error"][-3000:]}
            continue
        apart = _gloo.context_parallel_apart(got, want)
        out["strategies"][strategy] = {
            "worst": max(apart.values()), "at": max(apart, key=apart.get),
            "k_placements": got["prefill_k_placements"]}
    out["seconds"] = time.perf_counter() - t0
    return out


@contextlib.contextmanager
def context_parallel_host():
    """``context_parallel_check`` in a subprocess at MESH_CELL_NICE for
    the block's length: yields (process, start time); the process is
    killed at the end of the block if it still runs."""
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; print(json.dumps("
         "chip_smoke.context_parallel_check()))"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        preexec_fn=lambda: os.nice(MESH_CELL_NICE))
    try:
        yield proc, time.perf_counter()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def context_parallel_host_phase(started: tuple, smi: str) -> dict:
    """The context-parallel check's result under this host's torch; fails
    unless every strategy ran, matched one device and kept K's sequence
    shard."""
    proc, t0 = started
    t_read = time.perf_counter()
    log, err = proc.communicate(timeout=max(
        1.0, CP_HOST_TIMEOUT_S - (t_read - t0)))
    if proc.returncode != 0:
        raise AssertionError(f"the context-parallel check exited "
                             f"{proc.returncode}:\n{err[-4000:]}")
    got = json.loads(log.strip().splitlines()[-1])
    got["waited_s"] = time.perf_counter() - t_read
    worst = {s: r.get("worst") for s, r in got["strategies"].items()}
    got["worst"] = worst
    emit("context_parallel_host", **got, card=smi)
    bad = {s: r for s, r in got["strategies"].items()
           if "error" in r or r["worst"] > 1.0
           or r["k_placements"] != ["S(0)", "S(1)"]}
    if bad:
        raise AssertionError(f"context-parallel attention under torch "
                             f"{got['torch']}: {bad}")
    return got


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this run needs one",
              file=sys.stderr)
        return 2
    # the dry-run cell (roofline (d)) runs on the host from the start, so
    # that it is done before the LM phases are; so do the F6 cells and the
    # context-parallel check, read just before it
    with dryrun_cell() as dry_started, mesh_cells_host() as cells_started, \
            context_parallel_host() as cp_started:
        return run(dry_started, cells_started, cp_started)


def run(dry_started, cells_started, cp_started) -> int:
    """Every phase; ``dry_started`` is the dry-run cell's subprocess,
    ``cells_started`` the F6 cells' pool, ``cp_started`` the
    context-parallel check's subprocess."""
    import torch
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np

    from repro_torch.core.dataset import Dataset
    from repro_torch.core.devices import SIMULATED_DEVICES
    from repro_torch.core.forest import ExtraTreesRegressor
    from repro_torch.core.forest_torch import to_dense
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels.attention import kernel as ak
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.forest import ops
    from repro_torch.kernels.mamba import kernel as sk
    from repro_torch.kernels.forest.ref import (forest_predict_packed_ref,
                                                forest_predict_ref)
    from repro_torch.serve import ForestEngine, MultiDeviceEngine

    dev = torch.device("cuda")
    # float32 products in full float32 on the card (no TF32), for the plain
    # versions the kernels are held to
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:       # one nvcc per source, at once
        infos = list(pool.map(lambda m: m.build(), (fk, sk, ak)))

    def ptxas(info):
        return [ln.strip() for ln in info.log.splitlines()
                if any(k in ln for k in ("registers", "spill", "smem",
                                         "Compiling entry", "bytes stack"))]
    # the bf16 entries' kernels must run their products on the tensor cores
    tc = {i.library.stem: tensor_core_counts(i.library) for i in infos}
    bf16_kernels = ("flash_fwd_mma_kernel", "ssd_chunk_state_kernel",
                    "ssd_chunk_out_kernel")
    found = {n: sum(c["HMMA"] + c["HGMMA"] for lib in tc.values()
                    for k, c in lib.items() if k.startswith(n))
             for n in bf16_kernels}
    emit("build", seconds=time.perf_counter() - t0,
         commands=[" ".join(i.command) for i in infos],
         ptxas={i.library.stem: ptxas(i) for i in infos},
         tensor_core_instructions=tc, tree_group=fk.TREE_GROUP)
    if not all(found.values()):
        raise AssertionError(f"bf16 kernels without tensor-core "
                             f"instructions: {found}")

    # ------------------------------------------------- roofline (a)
    calibration = roofline_calibration_phase(dev, smi)

    # --------------------------------------------------------------- fit
    t0 = time.perf_counter()
    ds = Dataset.load(FIXTURE).reduce_overrepresented()
    dev0, dev1 = SIMULATED_DEVICES[0].name, SIMULATED_DEVICES[1].name
    X, y0, _ = ds.matrix(dev0, "time_us")
    X = X.astype(np.float32)
    _, y1, _ = ds.matrix(dev1, "time_us")

    def fit(y, seed):
        return ExtraTreesRegressor(n_estimators=N_TREES, criterion="mse",
                                   max_features="max",
                                   seed=seed).fit(X, np.log(y))
    est, est_swap, est_dev1 = fit(y0, 0), fit(y0, 1), fit(y1, 0)
    est_deep = ExtraTreesRegressor(n_estimators=DEEP_TREES, criterion="mse",
                                   max_features="max",
                                   seed=2).fit(X, np.log(y0))
    if DEEP_TREES % fk.TREE_GROUP == 0:
        raise AssertionError("tree count must leave the last tree group "
                             "ragged, to exercise the padding path")
    emit("fit", seconds=time.perf_counter() - t0, rows=int(X.shape[0]),
         features=int(X.shape[1]), trees=N_TREES,
         avg_depth=est.avg_depth(), devices=[dev0, dev1])

    # ------------------------------------------------------------ kernel
    rng = np.random.default_rng(0)

    def rows(B):
        """B distinct feature rows: the fixture's kernels, and past its 328
        rows, its kernels again with a 5 % multiplicative jitter (distinct
        rows, so the engine's de-duplication cannot shrink a batch)."""
        if B == len(X):
            return X
        r = X[rng.choice(len(X), B, replace=B > len(X))]
        if B > len(X):
            r = r * rng.lognormal(0.0, 0.05, r.shape).astype(np.float32)
        return np.ascontiguousarray(r, dtype=np.float32)

    def tables(depth, estimator=est):
        d = to_dense(estimator, depth)
        raw = (torch.as_tensor(d.feature, device=dev),
               torch.as_tensor(d.threshold, device=dev),
               torch.as_tensor(d.value, device=dev))
        return raw, ops.pack_tables(*raw, depth=depth,
                                    n_features=d.n_features)

    max_err = 0.0
    results = []
    packed_ref_equal = 0
    for depth, estimator in ([(d, est) for d in DEPTHS]
                             + [(d, est_deep) for d in DEEP_DEPTHS]):
        raw, packed = tables(depth, estimator)
        trees = len(estimator.trees_)
        for B in BATCHES:
            x = torch.as_tensor(rows(B), device=dev)
            out = ops.forest_predict_packed(x, packed)
            again = ops.forest_predict_packed(x, packed)
            plain = forest_predict_ref(x, *raw, depth)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, plain, rtol=RTOL, atol=ATOL)
            if not torch.equal(out, again):
                raise AssertionError(f"kernel not repeatable at depth "
                                     f"{depth}, B={B}")
            if B > 7:
                head = ops.forest_predict_packed(x[:7].contiguous(), packed)
                if not torch.equal(head, out[:7]):
                    raise AssertionError("a row's answer depends on its batch")
            # the plain walk over the packed tables adds in the kernel's
            # order: reported, the tolerance above is the check
            same = torch.equal(out, forest_predict_packed_ref(x, packed))
            packed_ref_equal += same
            err = float((out - plain).abs().max())
            max_err = max(max_err, err)
            results.append({"depth": depth, "trees": trees, "B": B,
                            "split": packed.split, "max_abs_err": err,
                            "packed_ref_bitwise": same,
                            "tile_rows": fk.tile_rows(packed, B)})
        # the dense entry point packs per call and gives the same bits
        if not torch.equal(ops.forest_predict(x, *raw, depth=depth), out):
            raise AssertionError(f"dense and packed calls differ at depth "
                                 f"{depth}")
    # non-finite features follow ref.py: NaN goes right, an inf in another
    # column leaves the walk alone
    raw, packed = tables(DEPTH)
    x = torch.as_tensor(rows(64), device=dev).clone()
    x[0, :] = float("nan")
    x[1, 3] = float("inf")
    x[2, 5] = float("-inf")
    x[3, 0] = float("nan")
    out = ops.forest_predict_packed(x, packed)
    plain = forest_predict_ref(x, *raw, DEPTH)
    torch.testing.assert_close(out, plain, rtol=RTOL, atol=ATOL)
    emit("kernel", cases=len(results), max_abs_err=max_err, rtol=RTOL,
         atol=ATOL, packed_ref_bitwise=packed_ref_equal, results=results,
         nonfinite_rows="ok")

    # ------------------------------------------------------------- serve
    ops.launches = 0                       # count the main path's launches
    t_serve = time.perf_counter()
    engine = ForestEngine(est, device="cuda")
    if engine.backend != "hopper":
        raise AssertionError(f"engine serves on {engine.backend!r}")
    want = plain_cpu(est, X)
    close_to(engine.predict(X), want, "batched predict")
    batches = engine.stats.batches
    close_to(engine.predict(X), want, "repeat predict")
    if engine.stats.batches != batches or engine.stats.cache_hits < len(X):
        raise AssertionError(f"repeat predict missed the cache: "
                             f"{engine.stats}")
    engine.cache_clear()
    futs = [engine.predict_async(X[i]) for i in range(200)]
    singles = np.array([f.result(timeout=60) for f in futs])
    close_to(singles, want[:200], "async singles")
    st = engine.stats_snapshot()
    burst = {"requests": st.requests, "flushes_size": st.flushes_size,
             "flushes_deadline": st.flushes_deadline,
             "batches": st.batches}
    gen = engine.swap_estimator(est_swap)
    if gen != 1 or engine.generation != 1:
        raise AssertionError(f"hot-swap generation {gen}")
    close_to(engine.predict(X), plain_cpu(est_swap, X), "after hot-swap")

    mde = MultiDeviceEngine.from_fits({dev0: (est, None),
                                       dev1: (est_dev1, None)})
    T_mat, P_mat = mde.price(X)
    for j, (name, e) in enumerate(((dev0, est), (dev1, est_dev1))):
        eng = mde.engines[name][MultiDeviceEngine.TIME]
        if eng.backend != "hopper":
            raise AssertionError(f"{name} engine serves on {eng.backend!r}")
        log_t = eng.predict(X)
        close_to(log_t, plain_cpu(e, X), f"{name} pricing")
        np.testing.assert_array_equal(T_mat[:, j], np.exp(log_t))
    sched = schedule(X, mde)
    if (len(sched.assignments) != len(X) or not np.isfinite(sched.makespan_us)
            or sched.makespan_us <= 0):
        raise AssertionError(f"bad schedule: {sched.makespan_us}")
    torch.cuda.synchronize()
    launches = ops.launches
    engine_batches = engine.stats.batches + sum(
        per[MultiDeviceEngine.TIME].stats.batches
        for per in mde.engines.values())
    if launches < engine_batches or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{engine_batches} engine batches")
    emit("serve", seconds=time.perf_counter() - t_serve, backend="hopper",
         rows=int(len(X)), burst=burst, generation=engine.generation,
         price_shape=list(T_mat.shape), finite=bool(np.isfinite(T_mat).all()),
         makespan_us=sched.makespan_us, kernel_launches=launches,
         engine_batches=engine_batches)
    engine.close()
    mde.close()

    # ------------------------------------------------------------ timing
    raw, packed = tables(DEPTH)
    timing = []
    for B in TIMED_BATCHES:
        x = torch.as_tensor(rows(B), device=dev)
        def launch():
            return ops.forest_predict_packed(x, packed)
        k_ms = cuda_ms(launch, iters=200, warmup=20)
        d_ms = kernel_device_ms(launch, FOREST_KERNELS)
        p_ms = cuda_ms(lambda: forest_predict_ref(x, *raw, DEPTH),
                       iters=20, warmup=3)
        b_ms, b_by, work = bound(x, *raw[:2], DEPTH)
        # one engine call on uncached rows: launches and host-clock
        # latency, and the backend call alone (rows to the card, the
        # kernel, answers back): engine_ms - backend_ms is the engine's
        # per-row pass, backend_ms - ms the copies and the sync
        with ForestEngine(est, device="cuda", cache_size=0) as eng:
            xs = rows(B)
            eng.predict(xs)
            before = ops.launches
            eng.predict(xs)
            per_call = ops.launches - before
            n = 20
            t0 = time.perf_counter()
            for _ in range(n):
                eng.predict(xs)
            e_ms = (time.perf_counter() - t0) / n * 1e3
            t0 = time.perf_counter()
            for _ in range(n):
                eng._predict_fn(xs)
            be_ms = (time.perf_counter() - t0) / n * 1e3
        timing.append({"B": B, "ms": k_ms, "device_ms": d_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, **work, "launches_per_call": per_call,
                       "engine_ms": e_ms, "backend_ms": be_ms,
                       "engine_rows_per_s": B / e_ms * 1e3,
                       "library_ms": None, "tile_rows": fk.tile_rows(packed, B),
                       "table_bytes": packed.nbytes})
        emit("timing", **timing[-1], depth=DEPTH, trees=N_TREES, card=smi)

    # ------------------------------------------------------- front end
    front = frontend_phase({dev0: est, dev1: est_dev1},
                           json.loads(FIXTURE.read_text()), smi)

    # ---------------------------------------------------- the ground truth
    truth = ground_truth_phase(dev, front["features"], smi)
    # nested CV on the host, in a worker process beside the phases below
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
            "spawn")) as cv_pool:
        cv_future = cv_pool.submit(
            cv_worker, [s.to_json() for s in truth["dataset"].samples],
            [truth["device"], CV_YARDSTICK])
        gt_served = ground_truth_serve_phase(dev, truth, smi)
        stream = stream_refresh_phase(dev, truth, gt_served, smi)

        # ------------------------------------------- the serving tier
        sharded = sharded_phase(dev, est, est_deep,
                                {B: rows(B) for B in TIMED_BATCHES}, smi)
        cluster = cluster_phase(dev, smi)
        supervised = supervise_phase(dev, est, dev0, smi)

        # ------------------------------------------------ the LM path
        ssd = ssd_kernel_phase(dev)
        served = lm_serve_phase(dev)
        lm = lm_timing_phase(dev, served, smi)
        serve_launches = served["launches"]
        del served                            # free the served model
        torch.cuda.empty_cache()

        # ------------------------------------------- the training path
        # the launcher trains dense and mamba_hybrid on a mesh: a world of
        # one NCCL rank, started here so that it outlives each launcher
        # call and the phases after it can check and reuse it
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_world
        if not init_world(dev) or dist.get_backend() != "nccl":
            raise AssertionError("no world of one NCCL rank")
        flash = flash_kernel_phase(dev)
        flash_lse = flash_lse_phase(dev)
        flash_split = flash_split_phase(dev, smi)
        trained = lm_train_phase(dev)
        train_launches, per_step = trained["launches"], trained["per_step"]
        train_t = train_timing_phase(dev, trained, smi)
        flash_t, ssd_t = train_t["flash"], train_t["ssd"]
        lm_train_f32_phase(dev)

        # ---------------------------------- the other LM families
        torch.cuda.empty_cache()
        dense_served = lm_dense_serve_phase(dev)
        lm_dense_timing_phase(dev, dense_served, smi)
        del dense_served
        torch.cuda.empty_cache()
        dense = lm_dense_train_phase(dev, smi)
        mesh_parity_phase(dev, dense, smi)
        loss_shards_phase(dev, smi)
        dp_compressed_phase(dev, smi)
        autotuned = roofline_autotune_phase(dev, smi)
        dist.destroy_process_group()
        lm_dense_train_f32_phase(dev)
        families = lm_families_phase(dev, smi)
        families_mesh = lm_families_mesh_phase(dev, smi)
        mesh_cells_host_phase(cells_started, smi)
        cp_host = context_parallel_host_phase(cp_started, smi)
        dryrun = roofline_dryrun_phase(dry_started, smi)
        t0 = time.perf_counter()
        cv = cv_future.result()
    emit("roofline", calibration={k: calibration[k]["roofline_frac"]
                                  for k in ("matmul", "clone")},
         step={k: dense["roofline"][k] for k in (
             "row", "useful_ratio", "counted_flops", "model_flops",
             "bound_ms", "step_ms", "counted_peak_bytes",
             "torch_peak_bytes")},
         autotune={k: autotuned[k] for k in ("pick", "ranked")},
         dryrun={k: dryrun[k] for k in ("status", "row", "seconds",
                                        "peak_bytes", "fits_hbm")},
         card=smi)
    emit("ground_truth_cv", rows=cv[truth["device"]]["rows"],
         grid=CV_GRID, config=CV_CONFIG, waited_s=time.perf_counter() - t0,
         results=cv, card=smi)

    main_b = next(t for t in timing if t["B"] == X.shape[0])
    print(json.dumps({"kernels": [{
        "name": "forest_predict_f32", "route": "cuda",
        "source": "src/repro_torch/csrc/forest.cu",
        "replaces": "src/repro/kernels/forest/kernel.py:37",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_b["ms"], "device_ms": main_b["device_ms"],
        "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "library_ms": None, "frontend_launches": front["launches"],
        "ground_truth_launches": gt_served["launches"],
        "stream_launches": stream["launches"],
        "sharded_launches": sharded["launches"],
        "cluster_launches": cluster["launches"],
        "supervise_launches": supervised["launches"],
        "batch": main_b["B"], "depth": DEPTH,
        "trees": N_TREES, "table_bytes": main_b["table_bytes"],
        "cuda_kernels": list(FOREST_KERNELS)}, {
        "name": "ssd_scan_bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd.cu",
        "replaces": "src/repro/kernels/mamba/kernel.py:30",
        "launches": serve_launches, "max_abs_err": ssd["max_abs_err"],
        "max_abs_err_bf16": ssd["max_abs_err_bf16"],
        "ms": lm["ms"], "device_ms": lm["device_ms"],
        "plain_ms": lm["plain_ms"], "bound_ms": lm["bound_ms"],
        "bound_by": lm["bound_by"], "library_ms": None,
        "shape": lm["shape"], "cuda_kernels": list(SSD_KERNELS[:3]),
        "passes_device_ms": lm["passes_device_ms"],
        "bound_with_states_ms": lm["bound_with_states_ms"],
        "train_launches": train_launches["ssd_scan"],
        "train_launch_path": MESH_PATH,
        "train_launches_per_step": per_step["ssd_scan"],
        "train_ms": ssd_t["ms"], "train_device_ms": ssd_t["device_ms"],
        "train_plain_ms": ssd_t["plain_ms"],
        "train_bound_ms": ssd_t["bound_ms"],
        "train_bound_with_states_ms": ssd_t["bound_with_states_ms"],
        "train_shape": ssd_t["shape"]}, {
        "name": "flash_attention_bf16", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/attention/kernel.py:22",
        "launches": train_launches["flash_attention"],
        "launches_per_step": per_step["flash_attention"],
        "launch_path": MESH_PATH,
        "max_abs_err": flash["max_abs_err"],
        "max_abs_err_bf16": flash["max_abs_err_bf16"],
        "ms": flash_t["ms"], "device_ms": flash_t["device_ms"],
        "plain_ms": flash_t["plain_ms"], "bound_ms": flash_t["bound_ms"],
        "bound_by": flash_t["bound_by"],
        "library_ms": flash_t["library_ms"],
        "shape": flash_t["shape"], "cuda_kernels": [FLASH_KERNELS[0]],
        "smollm_launches": dense["launches"]["flash_attention"],
        "smollm_launches_per_step": dense["per_step"]["flash_attention"],
        "smollm_launch_path": MESH_PATH,
        "smollm_shape": dense["flash"]["shape"],
        "smollm_ms": dense["flash"]["ms"],
        "smollm_device_ms": dense["flash"]["device_ms"],
        "smollm_plain_ms": dense["flash"]["plain_ms"],
        "smollm_bound_ms": dense["flash"]["bound_ms"],
        "smollm_bound_by": dense["flash"]["bound_by"],
        "smollm_library_ms": dense["flash"]["library_ms"],
        "families_launches": families["launches"]["flash_attention"],
        "families_mesh_launches": families_mesh["launches"],
        "families_mesh_launch_path": "the 1 x 1 NCCL mesh: whisper-medium "
        "and xlstm-125m through launch.train.main, granite-moe-3b-a800m and "
        "qwen2-vl-7b (2 layers) through run_training(mesh=make_host_mesh(1))",
        "lse_checks": flash_lse["checks"],
        "lse_max_abs_err": flash_lse["lse_max_abs_err"],
        "split_checks": flash_split["checks"],
        "split_max_abs_err": flash_split["max_abs_err"],
        "split_timing": flash_split["timing"],
        "context_parallel_host": cp_host["worst"]
        }]}),
        flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
