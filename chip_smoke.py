#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or of the JAX
package.  Phases, one line each (or one per kernel):

1. build: every ``csrc/*.cu`` compiled by nvcc for sm_90a, in parallel,
   and ptxas's registers and spills of each flash kernel with its dynamic
   shared memory per block;
2. kernels: each hand-written kernel against its plain torch version on
   the card at fixed shapes (time, plain time, bound and, where one
   exists, the nearest single PyTorch call); the BFRT select ("kernel
   bfrt_select[...]") at N = 100,004 and 1,215 with random ratios, with
   every ratio equal and with one outlier crowding bucket 0, each with
   its device ms and launches per call; segment stats at 10M x 4 under
   five sortings (G=100k, 81, 1, every row its own group, 231 with one
   group of 476,724 rows), each also bit-equal to its torch mirror
   ``segment_stats_tiled_plain`` and timed at every candidate tile
   ("segstats tile"); for the DLV scan also its
   long path's counters per case ("... long path": speculative cuts,
   windows verified, repairs, cycles speculating and verifying, the
   longest window), every window of the 10M case checked whole, and each
   case timed at every candidate long-path threshold ("dlv_scan
   threshold");
3. parity: a 200k-row TPC-H table built and solved once on the card and
   once on the CPU -- identical layers and gids, equal objective; then
   solved again on each with the sub-ILP's B&B in waves of 8 ("parity
   W=8": batched LP flights on each engine's device), equal objective,
   every card flight held to the plain version;
4. full: the 10M-row TPC-H table (d_f=100, alpha=100k) partitioned on the
   card and Q2_TPCH solved at hardness 3 and 5 through the device LP, with
   every kernel's launch count read around that run, then a profiled
   second partition and solve (device ops per pivot of the solve), and
   the partition again with every scan segment on the one-thread path
   ("profile partition, one-thread scan only": the build's device time
   without the long path);
4b. analysis: the port's traced contracts on the card
   (``repro_torch.analysis.contracts.run_contracts("card")``) on the
   largest layer LP of one more h=3 solve of phase 4's engine: one host
   read, one pricing launch and one BFRT select call a pivot of the
   device LP, one ``rep.cpu()`` a priced pivot of ``solve_lp_dist`` on a
   world of one rank, the distributed steps' passes and bytes, and the
   trace's cost against untraced solves; fails on any violation;
5. main-path inputs: the main path of phase 4 run once more with a copy of
   the arguments of every kernel call kept, and each kernel held against
   its plain version on exactly those inputs; the times in the ``kernels``
   line are taken at the largest of them; each segment stats call is
   timed with the gather that precedes it in ``dlv_rounds``
   ("main-path segment_stats call i");
5b. lp batch: the batched LP engine (``csrc/lp_batch.cu``, one launch a
   flight: one warp a lane, several lanes a CTA, for m_pad <= 32 and N
   <= WARP_N_MAX; one CTA a lane above).  Its main path: B&B on the
   reference benchmark's instance (``benchmarks/batch_lp.py``, n=150,
   width 0.05) at W=64 on the card, launch counts reset around it,
   against W=1 (the same package and objective) and against W=64 on the
   plain version (the same nodes and LP iterations); dispatches,
   launches, lanes and trips per dispatch, the workspace cache; every
   flight held to the plain version on the card, with the path and the
   lanes a CTA it took; the flights' kernel time (CUDA events, and the
   profiler's device time); one dispatch's host time split into lane
   assembly, ``_validate_warm_batch``, the ``LaneSolver`` call (its
   copies and sync, and the kernel) and unpack ("lp batch bnb dispatch
   split").  Then flights, each against the plain version on the card
   and ``solve_lp_np`` lane by lane and timed (device ms, host wall per
   dispatch, plain ms, bound, path): the Dual Reducer's rung
   flight (n=300, R=12, warm from lp1), "wide" (the same rungs over
   100,000 columns: the CTA path, its global workspace), "tall" (40
   rows, m_pad 64: the CTA path, a lane's rows in the global
   workspace), a shared pivot budget
   that truncates mid-flight (two launches; statuses, iterations and
   notes equal the plain lockstep loop's); the full cell's h=3 and h=5
   solves at W=8 against W=1 (same package and objective, flights held),
   and four rungs of its h=3 Dual Reducer LP (its candidate set, warm
   from its lp1);
5c. kernel split_tree_descent: the descent kernel (``csrc/split_tree.cu``,
   one thread a row over the packed layout of
   ``kernels/split_tree.py::pack_tree``) on the full cell's 10M layer-0
   rows down layer 1's tree (equal to ``part.gid``), on 100,000 rows whose
   values are that tree's bounds (ties), on layer 2's tree over its reps,
   on a KD-tree and a bucketing partition of a 1M-row slice, on the
   bound-less merged single-bucket tree, on a single leaf and on 100,000
   probes outside every box plus NaN rows; each exactly equal to the plain
   version and the packed mirror on the card and the host descent, with
   ms (CUDA events), the kernel's device ms over 21 calls (median, min,
   max), plain ms, bound, the staging the wrapper chose, the host
   descent's seconds, and the same times of the kernel it replaced
   (``csrc/split_tree_bisect.cu``, built and timed in this run on the
   same rows: ``bisection_*``) ("kernel split_tree_descent[...]");
5d. cache: the reference benchmark's flight (``benchmarks/cache_bench.py``)
   on the full cell through the device LP: Q2_TPCH h=2 cold, then
   repeated (a ``cached=package`` hit), tightened to h=3 (``cached=
   contained`` or a gap-rejected fallback), widened to h=1 and Q4_TPCH
   h=2 (misses), and an artifact-only ``QCache(reuse_packages=False)``
   repeat (``cached=exact``); each answer equal to an uncached session's
   with the same seed ("cache <name>" lines: kind, walls, pruned LPs);
   the cache's counters and bytes ("cache stats"); then
   ``Hierarchy.append`` of the h=2 package's first 7 rows and 100,000
   fresh rows (one descent launch, gids equal to the host descent's, the
   removed groups equal to the touched ancestry layer by layer; "cache
   append": the append state's seconds, the append wall, the descent's
   ms beside the replaced kernel's on the same rows, touched, flagged and
   invalidated counts), a stale miss equal to
   the uncached answer and a ``cached=package`` hit again;
5e. heap: ``dlv(X, 100, method="heap")`` (the one-pop-per-iteration build,
   each pop's scan on the card) on the 4 tpch attributes of 1,000,000
   rows (``benchmarks/partitioning.py``'s full profile), launches reset
   just before and read just after: wall, pops, splits, groups, scan
   launches; every scan call held to ``dlv_scan_plain`` (bit-equal; the
   largest also to the row-step scan; "main-path heap dlv_scan" lines);
   the descent on the card equal to gid on 100,000 rows; the build again
   under the profiler (device busy, idle share); ``dlv_rounds`` at the
   same size and seed ("heap rounds": wall, idle share, groups, ratio
   scores) held to the heap build's quality bar (group counts within
   max(10, G/3), each attribute's weighted ratio score within 1.25 x the
   heap build's + 5e-3);
5f. heap seed: the same build with ``scan="seed"`` (the seed's scan:
   the certified design's four kernels a call, prefix sums across the
   card and a one-CTA walk), every seed-scan call held to
   ``dlv_scan_seed_plain`` (bit-equal; the replaced one-thread kernel,
   ``serial=True``, too; the first call's counters to
   ``seed_scan_certified_plain``'s), the build's calls replayed (CUDA
   events; the profiler's summed seed-kernel device ms, profiled again
   while a kernel's record is missing), its wall uncaptured in turns
   with the same build through the replaced kernel (new, serial,
   serial, new), and "kernel dlv_scan_seed[...]" lines for the first
   (largest) span and a fixed 1M-row span: ms (CUDA events), device ms
   (profiler, a call's four kernels summed; profiled again up to three
   times before "not measured"; each kernel's in ``kernel_ms``), plain
   ms, bound, launches, the counters (windows, near-ties, short runs,
   rows stepped serially, tests, cycles) and the replaced kernel's ms
   and device ms;
5g. faults: the 10M-row tpch table written to ``build/streamed`` and
   opened as a ``MemmapRelation`` (the bucketing build within 2.5M
   resident rows), Q2_TPCH h=3 clean and then under each arm of the
   reference's ``test_engine_never_raises_under_faults`` (``CHUNK_READ``
   twice, with the build under the arm too; ``GATHER_READ`` with
   probability 0.3; ``BINV`` three times after one; ``SHARD`` once),
   "faults <site>" lines with the report status, ``fault_retries``, the
   fires per site and the walls: each status defined, a feasible
   package valid, the read faults' packages equal to the clean one,
   ``SHARD`` never fired (only the distributed pivot loop polls it:
   phase 15);

The streamed (out-of-core) path:

6. streamed: a 50M-row TPC-H stand-in (``synth_tables``, chunk by chunk
   from seed 0) written to ``build/streamed/lineitem.npy`` and opened as a
   ``MemmapRelation``; the engine builds it within ``memory_rows`` =
   12.5M through the bucketing backend (each bucket's DLV on the card)
   and solves Q2_TPCH at h=3 and h=5 through the device LP, once, with
   every launch counted and a copy of every kernel call's arguments kept:
   buckets, layers, the build's wall split (stats pass, edge passes,
   spill pass, bucket reads, per-bucket DLV, merge), the peak resident
   rows of the build and of the solves beside ``memory_rows``, and, the
   build having run under the profiler, its device busy time, idle share
   and the bytes and device ms of its copies to the card;
7. streamed main-path inputs: each kernel held against its plain version
   on every call kept in phase 6 (the scan's plain version on host
   copies; the scan calls of the bucket with the largest call also
   against the row-step scan);
8. streamed parity: 2M rows built with ``layer0_backend="bucketing"`` as
   a dict and as a ``MemmapRelation`` on the card, and the memmap on the
   CPU -- identical layers and gids, the same objective;
9. sketchrefine: SketchRefine with ``kdtree`` and with ``dlv`` (the
   partition on the card) and Progressive Shading on a 1M-row table,
   Q2_TPCH at h=3: statuses, objectives, walls, refine steps.

The data and the spill scratch (``build/streamed``, phase 5g's table
too) are removed at the end of phase 8, also when a check fails.

The LM slice (qwen2-1.5b at full width, bf16, random init from a seeded
``torch.Generator``):

10. kernel flash_attention: the flash kernel against its plain version at
   fixed shapes (S=32,768 causal, and with window 4,096, in bf16; S=4,096
   in float32 at head_dim 64), timed against the plain scan and against
   ``scaled_dot_product_attention`` (achieved TFLOP/s and the ratio of the
   kernel's time to that call's);
11. lm prefill: ``Model.prefill_logits`` on 2 prompts of 4,096 tokens with
   every launch count read around it (28 flash launches), then profiled;
12. lm agreement: a float32 copy of the model, prefill logits at S=64
   against 64 ``decode_step``s (2e-3);
13. lm serve: ``ServingEngine.serve`` with the package-query scheduler on
   the card (B&B waves of 8 as batched LP flights), 16 requests, per-tick
   admission and decode numbers, the admissions tick by tick equal to a
   ``device="cpu"`` scheduler's, any flight held to the plain version,
   then the first tick again from the same seed (identical admission and
   tokens), then one short batch profiled;
14. lm main-path inputs: the prefill rerun keeping every flash call's
    arguments, each held against the plain version.

Distributed pricing (``core.distributed`` on an NCCL world of one rank,
a (1, 1) ``DeviceMesh`` named ("data", "model"); no fallback if NCCL
fails to start):

15. dist: the reference's distributed-pricing profile at full size
    (``benchmarks/warm_start.py::_distributed_pricing --full``: a 1M-column
    package LP, m = 12) cold with every kernel count read around it, again
    for its wall and under the profiler (device-to-host reads a pivot),
    warm from the numpy twin's answer, each against ``solve_lp_np``, and
    the single-device ``solve_lp`` beside it ("dist profile"); the full
    cell's 10M rows built by ``PackageQueryEngine(mesh=, chunk_rows=1M)``
    (groups equal to phase 4's build, reps to 1e-8) and Q2_TPCH h=3 with
    every layer LP through ``solve_lp(mesh=)`` against the single-device
    solve ("dist full"); ``SHARD`` armed once ("dist SHARD"); the first
    pivots' pricing and histogram calls and every sharded segment stats
    call held against the plain versions ("main-path dist ...").

The MoE slice (mixtral-8x22b at full width cut to 4 of its 56 layers,
bf16, random init from a seeded ``torch.Generator``; the qwen2 model is
freed before phase 15):

16. moe prefill: ``Model.prefill_logits`` on B = 1 x S = 8,192 tokens
    (the 4,096-token window masks keys) with every launch count read
    around it (4 flash launches): first and warm walls, tokens/s, peak
    memory, then profiled; then one more prefill logging each layer's
    routing (copies per expert, copies dropped, "moe prefill routing
    layer i");
17. moe layer: layer 0's experts on 512 tokens, in float32 ``apply_moe``
    at capacity factor 8.0 against the dense oracle ``ref_moe`` (2e-4 abs
    + 2e-4 rel, the reference's bar), in bf16 at the default capacity
    twice (bit-identical outputs and aux);
18. moe agreement: a float32 copy of the first 2 layers at capacity factor
    8.0 (the reference's test setting: no copy drops), prefill logits at
    S = 64 against 64 ``decode_step``s (2e-3);
19. moe serve: phase 13 on the MoE model (the same 16 requests and budget,
    admissions equal to a CPU scheduler's tick by tick, tick 0 rerun
    identical);
20. moe main-path inputs: phase 14 on phase 16's prefill ("main-path
    flash_attention moe").

The MLA slice (deepseek-v3-671b at full width cut to 5 of its 61 layers:
the 3 leading dense layers and 2 MoE layers of 256 experts, top-8, and a
shared one; the MTP head's parameters; bf16, 27.30e9 parameters, random
init from a seeded ``torch.Generator``; the mixtral model is freed
first):

21. mla prefill: ``Model.prefill_logits`` on B = 1 x S = 8,192 tokens
    with every launch count read around it (5 flash launches, each at
    q/k head_dim 192 and v head_dim 128): first and warm walls,
    tokens/s, peak memory, then profiled (top ops, idle share); each MoE
    layer's routing ("mla prefill routing layer i");
22. mla flash: the prefill's first flash call (the five share one shape)
    held against its plain version (the one-ulp bar), and its ms,
    TFLOP/s, bound and the ``scaled_dot_product_attention`` call's time
    on the same shapes, with the backend that ran it;
23. mla serve: phase 13 on the MLA model (absorbed decode over the
    latent cache; admissions equal to a CPU scheduler's, tick 0 rerun
    identical);
25. mla main-path inputs: phase 14 on phase 21's prefill, every call
    held, the times being phase 22's ("main-path flash_attention mla");
24. mla agreement (last: the bf16 model is freed first): a float32
    deepseek of one dense and one MoE layer at full width (14.63e9
    parameters) drawn from a seeded generator, capacity factor 8.0,
    prefill logits at S = 64 (the float32 flash kernel at (192, 128))
    against 64 absorbed ``decode_step``s (2e-3).

The SSM slice (the deepseek models are freed first):

26. ssm prefill: mamba2-1.3b, uncut (48 layers, bf16, 1.344e9
    parameters, random init from a seeded ``torch.Generator``),
    ``Model.prefill_logits`` on B = 2 x S = 4,096 tokens (16 chunks a
    row) with every launch count read around it (no flash launch: the
    stack has no attention), first and warm walls, tokens/s, peak
    memory, then profiled (top ops, idle share);
27. ssm scan: layer 0 of a float32 copy at full width, ``ssd_forward``
    against the token-by-token ``ssd_reference`` at B = 1, S = 512 (2
    chunks; 2e-3, the reference's bar), then the bf16 layer twice
    (bit-identical);
28. ssm agreement: a float32 copy of the whole model, prefill logits at
    S = 512 against 512 ``decode_step``s (2e-3);
29. ssm serve: phase 13 on mamba2 (``kv_bytes`` is 0, so the admission's
    HBM row binds nothing; admissions equal to a CPU scheduler's, tick 0
    rerun identical);
30. hybrid prefill: jamba-1.5-large-398b at full width with its period
    of 8 sublayers cut to one of 4 (SSM + dense FFN, SSM + MoE,
    attention + dense, SSM + MoE: 22.98e9 parameters, 45.96 GB in bf16;
    a whole period is 90.3 GB), ``Model.prefill_logits`` on B = 1 x
    S = 8,192 tokens with every launch count read around it (exactly 1
    flash launch), walls, tokens/s, peak memory, profiled; each MoE
    sublayer's routing ("hybrid prefill routing sub i");
31. hybrid flash: that flash call held against its plain version (the
    one-ulp bar) and timed beside ``scaled_dot_product_attention``;
32. hybrid serve: phase 13 on the hybrid model;
33. hybrid agreement (last: the bf16 model is freed first): a float32
    jamba of one period of 2 (SSM + dense FFN, attention + MoE; 11.90e9
    parameters) drawn from a seeded generator, capacity factor 8.0,
    prefill logits at S = 512 (the float32 flash kernel at (128, 128))
    against 512 ``decode_step``s (2e-3).

The encoder-decoder and VLM slice (each model uncut, bf16, random init
from a seeded ``torch.Generator``; the stub frontends' frame and patch
embeddings drawn from a seeded generator):

34. encdec prefill: whisper-base (6 encoder and 6 decoder layers, 97.27e6
    parameters), ``Model.prefill_logits`` on B = 16 clips of 1,500 frames
    and 448 text tokens with every launch count read around it (exactly
    18 flash launches: 6 encoder calls, full, 1,500 queries over the
    reference's 2,048 keys, the last 548 its zero padding; 6 causal self
    and 6 cross calls, 448 queries over 448 and over 2,048 keys), first
    and warm walls, tokens/s, peak memory, then profiled;
35. encdec flash: the first encoder, decoder self and cross calls held
    against the plain version (the one-ulp bar) and timed beside
    ``scaled_dot_product_attention`` on the same (padded) K and V, with
    the backend that ran it, and their bounds;
36. encdec agreement: a float32 copy, B = 1, 64 tokens: prefill logits
    against ``prefill_with_cache`` and decode steps within 2e-3 at 1,024
    frames; the same difference at 1,500 frames printed, not checked (the
    reference's parallel path attends its padded keys, its step path
    does not);
37. encdec serve: phase 13 on whisper with 8 requests (the cross cache the
    zeros of ``init_cache``, as in the reference's engine);
38. vlm prefill: paligemma-3b (18 layers, 1.905e9 parameters),
    ``Model.prefill_logits`` on B = 8 x (256 patches + 768 tokens), 18
    flash launches, each prefix-LM at (256, 256); the readings of 34;
39. vlm flash: the first prefix-LM call held to the one-ulp bar and timed
    beside SDPA with the boolean prefix-LM mask and beside causal SDPA
    of the same shape;
40. vlm agreement: a float32 paligemma cut to its first 2 layers, B = 1 x
    (256 + 256): prefill logits through the float32 kernel at (256, 256)
    against the same model with the plain attention on the card (2e-3);
41. vlm serve: phase 13 on paligemma with 8 requests (decode sees no
    prefix, as in the reference).

The training slice (``csrc/flash_attn_bwd.cu`` built beside the others,
its nvcc seconds on the "build" line):

42. flash bwd agreement: for each (q/k, v) head_dim pair, dtype and mask
    of the forward (causal, window, prefix-LM, cross with Sq != Sk) at S
    = 200, and at shapes ragged over the tensor-core kernels' tiles (a
    single query row, S = 129 and 257: one past a multiple of their 64-
    and 128-row tiles): the forward's output bit-identical with and
    without ``lse``, the LSE within 1e-5 of the plain version's, and the
    backward kernels' dQ, dK, dV against ``flash_attention_bwd_plain`` on
    the same O and LSE (relative norm: float32 1e-5, bf16 2^-8, one
    rounding each); a second backward on the same inputs bit-identical;
43. flash bwd time: the backward at the train cell's attention (B = 4,
    S = 4,096, 12/2 heads, (128, 128), bf16, causal) on the tensor cores,
    in turns with the CUDA-core kernels it replaced
    (``flash_attention_bwd_cuda_cores``): ms (CUDA events), each kernel's
    device ms and TFLOP/s, the bound (bytes / 3.35 TB/s against 2 (3 d +
    2 dv) FLOP a kept pair / 989 TFLOP/s), the plain version's ms, and
    SDPA's backward (forward + backward less forward, ``enable_gqa``);
    the profiler shows the tensor-core kernels, not the CUDA-core ones;
    then the CUDA-core kernels timed the same way at the shape of phase
    44's qwen2-1.5b call (float32, B = 2, S = 64, 4/2 heads, 128), and
    bf16 (256, 256), which stays on them, at the VLM cell's attention;
44. train smoke: each arch's smoke config widened to a flash pair in
    float32, one ``make_train_step`` step on the card and one on the CPU
    from the same parameters and batch: metrics 1e-5, moments 1e-4 of each
    leaf's largest (2^-8 where they are bf16), the whole update 1e-3 in
    relative norm, one forward and one backward flash launch for each
    attention call;
45. train: qwen2-1.5b at full width, bf16, ``remat="full"``, AdamW with
    float32 moments (lr 3e-3, no warmup), 8 x 4,096 tokens (cut from
    ``train_4k``'s 256 x 4,096) in 2 microbatches, three steps: step ms,
    tokens/s, 8 N T FLOP a step and its share of 989 TFLOP/s, peak GiB
    beside the state and one microbatch's float32 logits, flash launches a
    step (28 x 2 x 2 forward, 28 x 2 backward), the third step profiled
    (idle share, top device ops), every backward on the tensor cores; the
    first step's ce within 1e-3 of the ce from ``prefill_logits``, every
    parameter changed and finite;
46. train compressed: one more step with int8 gradient compression and
    error feedback (a fresh optimizer state): ms, finite;
47. train launcher: ``python -m repro_torch.launch.train``'s ``main`` at
    smollm-135m, full width (30 layers, d_model 576, 9/3 heads of 64,
    vocab 49,152, bf16, remat "full"), 8 x 2,048 tokens (cut from
    ``train_4k``'s 256 x 4,096), 14 steps with ``--select-data``, three
    runs: (a) uninterrupted, (b) checkpoints every 5 steps and
    ``--fail-at 9`` (exit code 42, held), (c) the same flags, resumed
    from step 10; (b)'s losses bit-equal to (a)'s first ten and (c)'s to
    (a)'s from step 10 on, finite, the last below the first; the
    selection feasible, valid, with the layers and (1e-6) the objective of
    the CPU run in the kernel's order of additions; step ms, tokens/s,
    FLOP share, peak GiB, the selection's wall and package, the
    checkpoint's GB, each save's and the restore's seconds, flash
    launches a step (60 forward, 30 backward, all 30 on the tensor
    cores); then the pipeline's host ms a batch and one more step of
    (a)'s model profiled (device busy, idle share, top device ops);
48. train checkpoint: phase 45's qwen2-1.5b train state (bf16 parameters,
    float32 moments, ~15.4 GB) saved, restored onto the card and every
    leaf held equal: GB, save and restore s and GB/s (the restore reads
    warm files); not run, and said so, with less than twice the state
    free on disk.

Then the seconds of each phase, the card's name and power limit (nvidia-smi), one JSON line listing
every kernel, and a last line ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without CUDA, or without the
package beside the script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float64 and float32
# outside the tensor cores (the LP and partitioning kernels are float64
# vector code), and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12
PEAK_OPS = {"float64": F64_OPS_PER_S, "float32": 67e12, "bfloat16": 989e12}

REL_TOL = 1e-12           # float64 sums vs the plain version, relative
ATTRS = ["price", "quantity", "discount", "tax"]
ILP_KW = dict(max_nodes=200, time_limit_s=600.0)   # B&B capped by nodes

SOURCES = {"pricing": ("src/repro_torch/csrc/pricing.cu",
                       "src/repro/kernels/pricing.py:51"),
           "bfrt_histogram": ("src/repro_torch/csrc/bfrt.cu",
                              "src/repro/kernels/bfrt.py:30"),
           "segment_stats": ("src/repro_torch/csrc/segstats.cu",
                             "src/repro/kernels/segstats.py:25"),
           "dlv_scan": ("src/repro_torch/csrc/dlv_scan.cu",
                        "src/repro/core/dlv.py:46"),
           "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                               "src/repro/kernels/attention.py:32"),
           "lp_batch": ("src/repro_torch/csrc/lp_batch.cu",
                        "src/repro/core/lp_batch.py:121"),
           "split_tree_descent": ("src/repro_torch/csrc/split_tree.cu",
                                  "src/repro/core/partitioner.py:122"),
           "dlv_scan_seed": ("src/repro_torch/csrc/dlv_scan.cu",
                             "src/repro/core/dlv.py:329")}
TOLERANCE = {"pricing": "1e-12 of max(1, |plain|); inf where plain is inf",
             "bfrt_histogram": "select: q, flip mask, has_cross exact vs "
                               "the sequential rule, a second run "
                               "bit-identical; histogram: counts exact, "
                               "sums 1e-12 of max(1, |plain|)",
             "segment_stats": "counts exact; sums 1e-12 of the group's sum "
                              "of |v|; sums of squares 1e-12 relative",
             "dlv_scan": "cuts bit-equal to dlv_scan_plain and to the "
                         "row-step scan",
             "flash_attention": "bfloat16: |kernel - plain| <= 2^-7 |plain| "
                                "+ 1e-3 rms(plain) (one bf16 ulp and a "
                                "floor), ||kernel - plain|| <= 5e-3 "
                                "||plain||; float32: 2e-3 + 2e-3 |plain| "
                                "(the reference's bar), norm 1e-4",
             "lp_batch": "per valid lane: status and iterations exact; "
                         "unless infeasible, sorted basis and bound "
                         "pattern exact, x within 1e-9, objective within "
                         "1e-9 x max(1, |obj|) (the reference's 1e-9; "
                         "relative above 1, where an ulp exceeds it); "
                         "spent pivots exact",
             "split_tree_descent": "leaf ids exact: equal to "
                                   "descend_batch_plain on the card, the "
                                   "host descent and, for member rows, "
                                   "the rows' own group ids",
             "dlv_scan_seed": "cuts bit-equal to dlv_scan_seed_plain on "
                              "every call of the heap-seed build and on "
                              "the fixed span"}
# the flash kernel against its plain version, by dtype: an elementwise
# limit (see flash_agreement) and a bar on the relative norm of the error
FLASH_NORM_TOL = {"bfloat16": 5e-3, "float32": 1e-4}
PLAIN_BLOCK_BYTES = 2 ** 30   # the plain flash scan's score block, at most
# the kernels of the package-query path (phases 4-5); flash_attention is
# the LM slice's (phases 6-10)
PQ_KERNELS = ("pricing", "bfrt_histogram", "segment_stats", "dlv_scan")
ARCH = "qwen2-1.5b"


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One line of results, stamped with the seconds since the start."""
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in kv.items())
          + f" at_s={time.perf_counter() - T0:.1f}", flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(nbytes: float, ops: float, peak: float = F64_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _numbers(shape, nbytes, ops, ms, plain_ms, library_ms=None,
             peak=F64_OPS_PER_S, **extra):
    b, by = bound_ms(nbytes, ops, peak)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "library_ms": library_ms, **extra}


# ---------------------------------------- each kernel against its plain


def pricing_check(args, tol=REL_TOL) -> float:
    """Kernel vs plain pricing on ``args`` (A, rho, d, state, lo, hi, s):
    max abs error of alpha, ratio and cost; fails beyond ``tol`` x max(1,
    |plain|) or on an inf that is not matched.  On the float64 route the
    finite ratios' range must equal the plain one and give the edges of
    ``bucket_edges(ratio)`` bit for bit."""
    import torch
    from repro_torch.kernels.bfrt import bucket_edges, edges_from_range
    from repro_torch.kernels.pricing import pricing, pricing_plain
    got, want = pricing(*args), pricing_plain(*args)
    worst = 0.0
    for g, w in zip(got[:3], want[:3]):
        both_inf = torch.isinf(g) & torch.isinf(w) & (g == w)
        diff = torch.where(both_inf, 0.0, (g - w).abs())
        check(bool(torch.isfinite(diff).all()), "pricing: inf mismatch")
        scale = torch.where(both_inf, 1.0, w.abs().clamp_min(1.0))
        check(bool((diff <= tol * scale).all()),
              f"pricing disagrees with its plain version "
              f"(max abs err {float(diff.max())})")
        worst = max(worst, float(diff.max()))
    if got[0].dtype == torch.float64:
        rng, ratio = got[3], got[1]
        plain = want[3]
        same = torch.equal(rng.isnan(), plain.isnan()) and torch.equal(
            rng.nan_to_num(), plain.nan_to_num())
        check(same, f"pricing: ratio range {rng.tolist()} != plain "
                    f"{plain.tolist()}")
        check(torch.equal(edges_from_range(rng).view(torch.int64),
                          bucket_edges(ratio).view(torch.int64)),
              "pricing: edges from the ratio range differ from "
              "bucket_edges(ratio)")
    return worst


def per_call_device(call, calls: int, module, prefix,
                    counter: str = "launches",
                    kernels_per_call: int = 1) -> dict:
    """``call()`` ``calls`` times under the profiler: the device ms a call
    of this repo's kernels named ``prefix...`` (a string or a tuple of
    them), summed over every kernel the calls started; the launches a call
    (the wrapper's own count ``module.<counter>``, exact; with no
    ``module``, ``kernels_per_call`` a call, which the caller vouches
    for); how many of the started kernels the profiler recorded; and
    ``kernel_ms``, each kernel's mean ms, records and median ms (from each
    record's own duration).  The profiler can lose, or mistime, the first
    device records of a window, more of them the longer the process has
    run (a 10-call window ~800 s into this script once lost all 30): so
    each window opens with a kernel of a torch op, a sync and 0.2 s of
    wait, the median leaves a mistimed record out, and the calls are
    profiled again, up to four times in all, until the profiler has
    recorded every kernel they started.  If it never has, and each call
    started one kernel (the same work every call), the recorded mean is
    the call's time (the estimate these rows have always printed, beside
    "seen of started"); where a call starts several kernels of different
    lengths (the seed scan's call counts once and starts
    ``kernels_per_call`` = 4, the histogram's two; a replay of a build's
    calls), no mean stands for them, and the device ms is None (not
    measured)."""
    import torch
    from torch.autograd import DeviceType
    opener = torch.zeros(1, device="cuda")
    recs = {}

    def window():
        opener.add_(1)              # the window's first device record
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(calls):
            call()

    def keep(prof):
        recs.clear()
        for ev in prof.events():
            name = ev.name.split("(")[0].replace("void ", "")
            if ev.device_type == DeviceType.CUDA and name.startswith(prefix):
                recs.setdefault(name, []).append(
                    ev.time_range.elapsed_us() / 1e3)

    for _ in range(4):
        before = getattr(module, counter) if module is not None else 0
        device_profile(window, on_prof=keep)
        started = (getattr(module, counter) - before) * kernels_per_call \
            if module is not None else calls * kernels_per_call
        seen = sum(len(v) for v in recs.values())
        if seen >= started:
            break
    total = sum(sum(v) for v in recs.values())
    device = total / calls if seen >= started > 0 \
        else total / seen if seen and started == calls else None
    return {"device_ms": device,
            "launches_per_call": started / kernels_per_call / calls,
            "profiled_launches": f"{seen} of {started}",
            "kernel_ms": json.dumps({k: [sum(v) / len(v), len(v),
                                         float(np.median(v))]
                                     for k, v in recs.items()})}


def pricing_times(args) -> dict:
    """The per-pivot call (a ``Pricer`` made once, as the pivot loop does),
    the plain version and ``rho @ A``, back to back."""
    from repro_torch.kernels import pricing
    A, rho, d, state, lo, hi, s = args
    m, N = A.shape
    price = pricing.Pricer(A, lo, hi)
    nbytes = (m * N + m + 1) * 8 + N * (8 + 4 + 8 + 8) + 3 * N * 8 + 16
    return _numbers(f"m={m} N={N} f64", nbytes, 2 * m * N + 4 * N,
                    timed_ms(lambda: price(rho, d, state, s), 200),
                    timed_ms(lambda: pricing.pricing_plain(*args), 50),
                    timed_ms(lambda: rho @ A, 200),
                    **per_call_device(lambda: price(rho, d, state, s), 20,
                                      pricing, "pricing_kernel"))


def bfrt_check(ratio, cost, budget, rng=None) -> float:
    """The select kernel (a ``Selector``'s call, as the pivot loop makes it;
    edges from pricing's ratio range ``rng`` where given, and then
    bit-equal to ``bucket_edges(ratio)``) against the exact sequential rule
    -- q, flip mask and has_cross equal -- and a second call bit-identical;
    ``rng=None`` through ``bfrt_select`` (the kernel finds the range).  The
    histogram kernel against its plain version: counts exact, sums to
    REL_TOL relative, two runs bit-identical.  Returns the sums' max abs
    error."""
    import torch
    from repro_torch.kernels.bfrt import (Selector, bfrt_histogram,
                                          bfrt_histogram_plain, bfrt_select,
                                          bfrt_sequential, bucket_edges,
                                          edges_from_range)
    want = bfrt_sequential(ratio.cpu().numpy(), cost.cpu().numpy(),
                           float(budget))
    if rng is not None:
        check(torch.equal(edges_from_range(rng).view(torch.int64),
                          bucket_edges(ratio).view(torch.int64)),
              "bfrt: edges from pricing's ratio range differ from "
              "bucket_edges(ratio)")
        select = Selector(ratio.shape[0], ratio.device)
        b = torch.as_tensor(budget, dtype=torch.float64,
                            device=ratio.device).reshape(1)
        runs = [tuple(x.clone() for x in select(ratio, cost, b, rng=rng))
                for _ in range(2)]
    else:
        runs = [bfrt_select(ratio, cost, budget) for _ in range(2)]
    q, flips, ok = runs[0]
    check(all(torch.equal(x, y) for x, y in zip(*runs)),
          "bfrt select: two runs differ")
    check(bool(ok) == want[2], "bfrt has_cross differs from the sequential "
                               "rule")
    if want[2]:
        check(int(q) == want[0], f"bfrt q {int(q)} != {want[0]}")
        check(np.array_equal(flips.cpu().numpy(), want[1]),
              "bfrt flip mask differs from the sequential rule")
    edges = bucket_edges(ratio)
    s_k, n_k = bfrt_histogram(ratio, cost, edges)
    s_p, n_p = bfrt_histogram_plain(ratio, cost, edges)
    check(torch.equal(n_k, n_p), "bfrt counts differ")
    err = float((s_k - s_p).abs().max())
    check(bool(((s_k - s_p).abs() <= REL_TOL * s_p.abs().clamp_min(1.0))
               .all()), f"bfrt sums differ (max abs err {err})")
    s2, _ = bfrt_histogram(ratio, cost, edges)
    check(torch.equal(s_k, s2), "bfrt histogram is not deterministic")
    return err


def bfrt_times(ratio, cost, budget, rng=None) -> dict:
    """The per-pivot select as the pivot loop makes it (a ``Selector`` made
    once, the budget a device value, ``rng`` pricing's range: computed
    here when not given): wall ms per call back to back, its kernels'
    device ms and launches per call (profiler), against the plain select;
    the histogram kernel alone beside it."""
    import torch
    from repro_torch.kernels import bfrt
    from repro_torch.kernels.pricing import ratio_range_plain
    edges = bfrt.bucket_edges(ratio)
    N, NB = ratio.shape[0], edges.shape[0]
    if rng is None:
        rng = ratio_range_plain(ratio)
    b = torch.as_tensor(budget, dtype=torch.float64,
                        device=ratio.device).reshape(1)
    select = bfrt.Selector(N, ratio.device)
    # bytes: ratio and cost read, the range and the budget read, q, the
    # flip mask and has_cross written; operations: the bucket search
    return _numbers(
        f"N={N} NB={NB} f64", 16 * N + 24 + 8 + N + 1,
        N * (int(np.log2(NB)) + 2),
        timed_ms(lambda: select(ratio, cost, b, rng=rng), 200),
        timed_ms(lambda: bfrt.bfrt_select_plain(ratio, cost, b, rng=rng),
                 20), None,
        **per_call_device(lambda: select(ratio, cost, b, rng=rng), 20, bfrt,
                          "bfrt_"),
        hist_ms=timed_ms(lambda: bfrt.bfrt_histogram(ratio, cost, edges),
                         200),
        hist_plain_ms=timed_ms(
            lambda: bfrt.bfrt_histogram_plain(ratio, cost, edges), 50))


SEGSTATS_BIG = 476_724    # the longest DLV window of the 10M build


def segstats_case(rng, case: str, n: int, dev, k: int = 4):
    """(vals (n, k), sorted ids, G) on ``dev`` for a named sorting: "G=81"
    or "G=100k" (uniform draws of G ids), "G=1", "G=n" (every row its own
    group), "skewed 231" (231 groups, one of ``SEGSTATS_BIG`` rows, or of
    n/2 if n is smaller), "gaps" (two groups in three empty, and some at
    both ends), "one group 95%", "tile edges" (runs of 1-3 whole tiles:
    every group ends on a tile edge), "n < tile" (37 groups)."""
    import torch
    from repro_torch.kernels.segstats import tile_rows
    if case == "G=1":
        G, ids = 1, np.zeros(n, np.int64)
    elif case == "G=n":
        G, ids = n, np.arange(n)
    elif case == "skewed 231":
        big = min(SEGSTATS_BIG, n // 2)
        sizes = np.full(231, (n - big) // 230)
        sizes[0] += n - big - sizes.sum() + sizes[100]
        sizes[100] = big
        G, ids = 231, np.repeat(np.arange(231), sizes)
    elif case == "gaps":
        G = n // 2
        ids = np.sort(rng.choice(np.arange(7, G - 7, 3), n))
    elif case == "one group 95%":
        G = 20
        ids = np.sort(np.where(rng.random(n) < 0.95, 5,
                               rng.integers(0, G, n)))
    elif case == "tile edges":
        T, m = tile_rows(k), n // tile_rows(k) + 1
        ids = np.repeat(np.arange(m), T * rng.integers(1, 4, m))[:n]
        G = int(ids[-1]) + 1
    elif case == "n < tile":
        G = 37
        ids = np.sort(rng.integers(0, G, n))
    else:
        G = int(case[2:].replace("k", "000"))
        ids = np.sort(rng.integers(0, G, n))
    return (torch.as_tensor(rng.normal(size=(n, k)), dtype=torch.float64,
                            device=dev),
            torch.as_tensor(ids, dtype=torch.int64, device=dev), G)


def segstats_check(vals, ids, G) -> float:
    """Kernel vs plain segment stats: counts exact, sums to REL_TOL of the
    group's sum of |v|, sums of squares to REL_TOL relative; bit-equal to
    ``segment_stats_tiled_plain`` (the kernel's order of additions) and to
    a second run.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.segstats import (segment_stats,
                                              segment_stats_plain,
                                              segment_stats_tiled_plain)
    cnt, sm, sq = segment_stats(vals, ids, G)
    mirror = segment_stats_tiled_plain(vals, ids, G)
    check(all(torch.equal(x, y) for x, y in zip((cnt, sm, sq), mirror)),
          "segment_stats differs from segment_stats_tiled_plain (its order "
          "of additions)")
    del mirror
    cnt_p, sm_p, sq_p = segment_stats_plain(vals, ids, G)
    check(torch.equal(cnt, cnt_p), "segment_stats counts differ")
    mass = torch.zeros((G, vals.shape[1]), dtype=torch.float64,
                       device=vals.device)
    mass.index_add_(0, ids, vals.abs())
    err = 0.0
    for got, want, scale in ((sm, sm_p, mass), (sq, sq_p, sq_p)):
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        check(bool((diff <= REL_TOL * scale.clamp_min(1e-300)).all()),
              f"segment_stats sums differ (max abs err {float(diff.max())})")
    again = segment_stats(vals, ids, G)
    check(all(torch.equal(x, y) for x, y in zip((cnt, sm, sq), again)),
          "segment_stats is not deterministic")
    return err


def segstats_times(vals, ids, G, plain: bool = True) -> dict:
    """The kernel's ms per call back to back, its device ms and launches
    per call (profiler), the longest group, against the plain version and
    ``index_add_`` of the sums alone (skipped without ``plain``)."""
    import torch
    from repro_torch.kernels import segstats
    n, k = vals.shape
    acc = torch.zeros((G, k), dtype=torch.float64, device=vals.device)
    longest = int(torch.unique_consecutive(ids, return_counts=True)[1]
                  .max())
    return _numbers(
        f"n={n} k={k} G={G} f64 sorted ids",
        n * k * 8 + n * 8 + G * (1 + 2 * k) * 8, 3 * n * k + n,
        timed_ms(lambda: segstats.segment_stats(vals, ids, G), 10),
        timed_ms(lambda: segstats.segment_stats_plain(vals, ids, G), 5)
        if plain else None,
        timed_ms(lambda: acc.index_add_(0, ids, vals), 10)
        if plain else None,
        longest_group=longest, tile=segstats.tile_rows(k),
        **per_call_device(lambda: segstats.segment_stats(vals, ids, G), 10,
                          segstats, "segstats_"))


def row_step_check(vals, Ls, beta, cuts, max_rows: int = 2048,
                   max_elems: int = 1 << 24, whole: bool = False) -> int:
    """Hold the scan kernel's ``cuts`` against ``scan_cols_plain``, which
    does the kernel's compensated arithmetic step for step.

    A scan restarted at a cut is in the very state that the running scan
    is in just after that cut.  So every window from a segment start or a
    cut up to the next cut, scanned alone, must cut at its last row and
    nowhere before it; a window that runs to its segment's end must not cut
    at all.  Windows are scanned side by side as columns on ``vals``'s
    device; one longer than ``max_rows`` is checked over its first
    ``max_rows`` rows, or, with ``whole``, over all its rows on the CPU
    (the long path's window ends are what it could get wrong, and the CPU
    takes a step of a few columns faster than the card).  Returns the
    number of windows checked."""
    import torch
    from repro_torch.kernels.dlv_scan import scan_cols_plain
    Ls = np.asarray(Ls, np.int64)
    n = len(vals)
    seg_end = np.cumsum(Ls)
    cut_h = cuts.cpu().numpy()
    starts = np.union1d(seg_end[Ls > 0] - Ls[Ls > 0], np.flatnonzero(cut_h))
    nxt = np.append(starts[1:], n)
    seg = np.searchsorted(seg_end, starts, side="right")
    to_cut = (nxt < n) & cut_h[np.minimum(nxt, n - 1)]
    length = nxt - starts + to_cut
    long = length > max_rows
    if not whole:
        length[long] = max_rows
        to_cut[long] = False
    bar_h = np.asarray(beta, np.float64)[seg]
    host = vals.cpu() if whole and long.any() else None

    def scan(v, idx):
        dev = v.device
        order = idx[np.argsort(length[idx], kind="stable")]
        i = 0
        while i < len(order):
            j = i + 1
            while (j < len(order)
                   and length[order[j]] * (j + 1 - i) <= max_elems):
                j += 1
            sub = order[i:j]
            i = j
            ln = torch.as_tensor(length[sub], dtype=torch.int64, device=dev)
            st = torch.as_tensor(starts[sub], dtype=torch.int64, device=dev)
            ridx = torch.arange(int(length[sub].max()), dtype=torch.int64,
                                device=dev)[:, None]
            V = v[st[None, :] + torch.minimum(ridx, ln[None, :] - 1)]
            bars = torch.as_tensor(bar_h[sub], dtype=torch.float64,
                                   device=dev)
            got = scan_cols_plain(V, bars) & (ridx < ln[None, :])
            want = torch.zeros_like(got)
            cols = torch.arange(len(sub), dtype=torch.int64, device=dev)
            want[ln - 1, cols] = torch.as_tensor(to_cut[sub], device=dev)
            check(torch.equal(got, want),
                  f"dlv_scan cuts differ from the compensated row-step scan "
                  f"(the kernel's own arithmetic) in "
                  f"{int((got != want).any(0).sum())} windows: a kernel "
                  f"fault")

    every = np.arange(len(starts))
    if host is None:
        scan(vals, every)
    else:
        scan(vals, every[~long])
        scan(host, every[long])
    return len(starts)


def dlv_stats(st) -> dict:
    """The long path's counters of one call, with the share of its CTAs'
    cycles spent speculating (the rest verifying and repairing)."""
    from repro_torch.kernels.dlv_scan import STAT_NAMES
    out = dict(zip(STAT_NAMES, (int(x) for x in st.tolist())))
    cyc = out["spec_cycles"] + out["verify_cycles"]
    out["spec_share"] = out["spec_cycles"] / cyc if cyc else None
    return out


def dlv_check(vals, Ls, beta, whole=False, row_step=True,
              plain_host=False, **kw):
    """Scan kernel vs ``dlv_scan_plain`` (bit-equal cuts; with
    ``plain_host`` the plain version runs on a host copy of ``vals``) and,
    with ``row_step``, vs the row-step scan on every window between its
    cuts (``whole``: long windows whole).  Returns (cuts, plain ms,
    windows checked, the long path's counters)."""
    import torch
    from repro_torch.kernels.dlv_scan import dlv_scan, dlv_scan_plain
    got, st = dlv_scan(vals, Ls, beta, stats=True, **kw)
    windows = row_step_check(vals, Ls, beta, got, whole=whole) \
        if row_step else 0
    t0 = time.perf_counter()
    want = dlv_scan_plain(vals.cpu() if plain_host else vals, Ls, beta, **kw)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    cuts = got.to(want.device)
    check(torch.equal(cuts, want),
          f"dlv_scan cuts differ from dlv_scan_plain in "
          f"{int((cuts != want).sum())} rows, though they agree with the "
          f"row-step scan: rounding of the plain version's prefix sums")
    return got, plain, windows, dlv_stats(st)


def dlv_times(vals, Ls, beta, plain_ms, **kw) -> dict:
    from repro_torch.kernels.dlv_scan import LONG_MIN, dlv_scan
    total, nseg = len(vals), len(Ls)
    nlong = int((np.asarray(Ls) >= LONG_MIN).sum())
    return _numbers(f"{nseg} segments ({nlong} long), {total} rows",
                    total * 8 + nseg * 24 + total, 14 * total,
                    timed_ms(lambda: dlv_scan(vals, Ls, beta, **kw), 2),
                    plain_ms)


# --------------------------------------------------------------- phase 2


def bfrt_hist_check(ratio, cost, edges) -> float:
    """The histogram kernel (pass 1 alone, as the distributed pricing step
    calls it) against its plain version: counts exact, sums to REL_TOL
    relative, two runs bit-identical; returns the sums' max abs error."""
    import torch
    from repro_torch.kernels.bfrt import bfrt_histogram, bfrt_histogram_plain
    s_k, n_k = bfrt_histogram(ratio, cost, edges)
    s_p, n_p = bfrt_histogram_plain(ratio, cost, edges)
    check(torch.equal(n_k, n_p), "bfrt histogram: counts differ")
    err = float((s_k - s_p).abs().max())
    check(bool(((s_k - s_p).abs() <= REL_TOL * s_p.abs().clamp_min(1.0))
               .all()), f"bfrt histogram: sums differ (max abs err {err})")
    check(torch.equal(bfrt_histogram(ratio, cost, edges)[0], s_k),
          "bfrt histogram is not deterministic")
    return err


def bfrt_hist_times(ratio, cost, edges) -> dict:
    """The histogram kernel per call, its plain version and the profiler's
    device ms; bytes: ratio and cost read, the edges read, sums and counts
    written; operations: the bucket search."""
    from repro_torch.kernels import bfrt
    N, NB = ratio.shape[0], edges.shape[0]
    return _numbers(
        f"N={N} NB={NB} f64", 16 * N + 8 * NB + 16 * NB,
        N * (int(np.log2(NB)) + 2),
        timed_ms(lambda: bfrt.bfrt_histogram(ratio, cost, edges), 200),
        timed_ms(lambda: bfrt.bfrt_histogram_plain(ratio, cost, edges), 50),
        None, **per_call_device(
            lambda: bfrt.bfrt_histogram(ratio, cost, edges), 20, bfrt,
            ("bfrt_hist_partial", "bfrt_hist_reduce"), kernels_per_call=2))


def host_top(prof, n: int = 8):
    """A profiled run's host ops by their self CPU time: (the total ms,
    the top ``n``).  The profiler's own cost a call weighs on each."""
    from torch.autograd import DeviceType
    rows = sorted(((ev.self_cpu_time_total / 1e3, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU), reverse=True)
    return sum(r[0] for r in rows), [{"op": k[:50], "ms": ms, "calls": c}
                                     for ms, k, c in rows[:n]]


def kernel_pricing(dev, N: int = 100_004):
    import torch
    rng = np.random.default_rng(1)
    m = 4

    def args(dt):
        t = functools.partial(torch.as_tensor, device=dev)
        return (t(rng.normal(size=(m, N)), dtype=dt),
                t(rng.normal(size=m), dtype=dt),
                t(np.abs(rng.normal(size=N)), dtype=dt),
                t(rng.integers(0, 3, N), dtype=torch.int32),
                t(np.zeros(N), dtype=dt), t(rng.uniform(1, 3, N), dtype=dt),
                t(-1.0, dtype=dt))

    err32 = pricing_check(args(torch.float32), 1e-5)
    a = args(torch.float64)
    err = pricing_check(a)
    out = pricing_times(a)
    say("kernel pricing", max_abs_err=err, f32_max_abs_err=err32, **out,
        library="rho@A (alpha only: no eligibility, ratio or cost)")
    return err, out


def kernel_bfrt(dev, N: int = 100_004):
    """Fixed cases: 30% of N eligible at random ratios (the grid path, and
    at the main path's N = 1,215 the one-CTA path), every ratio equal, and
    one outlier that crowds the rest into bucket 0 (both crowded: the
    refinement); each checked at four budgets with the range as pricing
    gives it, and the random case once more without it."""
    import torch
    from repro_torch.kernels.pricing import ratio_range_plain
    rng = np.random.default_rng(2)
    out = {}
    worst = 0.0
    for label, n in (("random", N), ("random", 1215), ("all equal", N),
                     ("crowded bucket 0", N)):
        c = rng.uniform(0.1, 2, n)
        if label == "random":
            r = np.where(rng.random(n) < 0.3, rng.uniform(0, 10, n), np.inf)
            c = np.where(np.isfinite(r), c, 0.0)
        elif label == "all equal":
            r = np.full(n, 2.5)
        else:
            r = rng.uniform(0, 1, n)
            r[n // 2] = 1e6
        ratio = torch.as_tensor(r, dtype=torch.float64, device=dev)
        cost = torch.as_tensor(c, dtype=torch.float64, device=dev)
        rr = ratio_range_plain(ratio)
        tot = c.sum()
        err = max(bfrt_check(ratio, cost, budget, rr)
                  for budget in (0.5, 0.3 * tot + 0.0123, 0.77 * tot + 0.007,
                                 2 * tot))
        if label == "random":
            bfrt_check(ratio, cost, 0.3 * tot + 0.0123)
        worst = max(worst, err)
        key = f"{label} N={n}"
        out[key] = bfrt_times(ratio, cost, 0.3 * tot + 0.0123, rr)
        say(f"kernel bfrt_select[{key}]", max_abs_err=err,
            q_and_flips="exact", **out[key])
    return worst, dict(out[f"random N={N}"],
                       main_path_n=out["random N=1215"],
                       all_equal=out[f"all equal N={N}"],
                       crowded=out[f"crowded bucket 0 N={N}"])


SEGSTATS_TILES = (2048, 4096, 8192, 16_384, 32_768)


def kernel_segstats(dev, n: int = 10_000_000):
    """Sortings of 10M x 4 rows: G=100k groups of ~100 rows; 81 groups of
    ~123k rows (round 1 of the 10M build's shape); one group; every row
    its own group; 231 groups with one of the build's longest window
    (476,724 rows).  Each checked against the plain version and the
    kernel's mirror and timed, then timed at every candidate tile
    ("segstats tile"; bit-equal to the mirror at that tile)."""
    import torch
    from repro_torch.kernels.segstats import (TILE_ROWS,
                                              segment_stats,
                                              segment_stats_tiled_plain)
    rng = np.random.default_rng(3)
    worst, out, tiles = 0.0, {}, {}
    for case in ("G=100k", "G=81", "G=1", "G=n", "skewed 231"):
        vals, ids, G = segstats_case(rng, case, n, dev)
        err = segstats_check(vals, ids, G)
        worst = max(worst, err)
        out[case] = segstats_times(vals, ids, G)
        say(f"kernel segment_stats[{case}]", max_abs_err=err,
            mirror="bit-equal", **out[case],
            library="index_add_ (sums only: no count, sumsq)")
        for T in SEGSTATS_TILES:
            got = segment_stats(vals, ids, G, tile=T)
            check(all(torch.equal(x, y) for x, y in zip(
                got, segment_stats_tiled_plain(vals, ids, G, tile=T))),
                f"segment_stats at tile {T} differs from its mirror")
            tiles.setdefault(T, {})[case] = timed_ms(
                lambda: segment_stats(vals, ids, G, tile=T), 10)
        del vals, ids
    for T, ms in tiles.items():
        say("segstats tile", tile=T, chosen=T == TILE_ROWS,
            **{f"ms_{k.replace(' ', '_')}": v for k, v in ms.items()})
    return worst, dict(out["G=100k"], round1_shape=out["G=81"],
                       one_group=out["G=1"], every_row=out["G=n"],
                       skewed=out["skewed 231"])


def _segments(rng, lens):
    """Sorted, mean-centred segments back to back, and their betas."""
    total = int(lens.sum())
    seg = np.repeat(np.arange(len(lens)), lens)
    v = rng.normal(size=total) * rng.uniform(0.5, 2.0, len(lens))[seg] \
        + rng.uniform(-1e3, 1e3, len(lens))[seg]
    v = v[np.lexsort((v, seg))]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    sums = np.add.reduceat(v, starts)
    v = v - (sums / lens)[seg]
    var = np.add.reduceat(v * v, starts) / lens
    return v, 13.5 * var / 100 ** 2


DLV_THRESHOLDS = (2048, 4096, 8192, 16_384, 32_768, 65_536)


@contextlib.contextmanager
def long_min(rows: int):
    """The scan's long-path threshold set to ``rows`` inside the block."""
    from repro_torch.kernels import dlv_scan
    saved, dlv_scan.LONG_MIN = dlv_scan.LONG_MIN, rows
    try:
        yield
    finally:
        dlv_scan.LONG_MIN = saved


def kernel_dlv_scan(dev, long: int = 10_000_000, nseg: int = 10_000):
    """Fixed cases: round 1 of the 10M build (one 10M-row segment, its
    long windows checked whole), round 2 (231 segments of ~43k rows), 10k
    short segments, and the scale-factor search (4 columns of 10,000
    sorted samples); then every case timed at each long-path threshold."""
    import torch
    from repro_torch.kernels.dlv_scan import LONG_MIN, dlv_scan
    rng = np.random.default_rng(4)
    out, data = {}, {}
    for label, lens in (("1x10M", np.array([long])),
                        ("231x43k", rng.integers(38_000, 48_000, 231)),
                        ("10kx1000", rng.integers(500, 1501, nseg)),
                        ("4x10k", np.full(4, 10_000))):
        v, beta = _segments(rng, lens)
        vals = torch.as_tensor(v, dtype=torch.float64, device=dev)
        got, plain, windows, st = dlv_check(vals, lens, beta, pitch=100,
                                            whole=label == "1x10M")
        out[label] = dlv_times(vals, lens, beta, plain, pitch=100)
        data[label] = (vals, lens, beta, got)
        say(f"kernel dlv_scan[{label}]", cuts=int(got.sum()),
            max_abs_err=0.0, cuts_bit_equal=True,
            row_step_windows=windows,
            long_windows_whole=label == "1x10M", **out[label])
        say(f"kernel dlv_scan[{label}] long path", long_min=LONG_MIN,
            **{k: v for k, v in st.items()})
    for T in DLV_THRESHOLDS:
        ms = {}
        with long_min(T):
            for label, (vals, lens, beta, want) in data.items():
                got = dlv_scan(vals, lens, beta)
                check(torch.equal(got, want), f"dlv_scan at LONG_MIN={T} "
                                              f"differs on {label}")
                ms[label] = timed_ms(lambda: dlv_scan(vals, lens, beta), 3)
        say("dlv_scan threshold", long_min=T, chosen=T == LONG_MIN,
            **{f"ms_{k}": v for k, v in ms.items()})
    del data
    return 0.0, dict(out["1x10M"], round2_shape=out["231x43k"],
                     multi_segment=out["10kx1000"],
                     scale_factor_search=out["4x10k"])


# ------------------------------------------------------------ phases 3, 4


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve(eng, query, budget=None, ilp_kwargs=ILP_KW):
    """``eng.solve`` with the layer LPs on the engine's device (the port's
    ``solve_lp_kernel``); returns (result, seconds)."""
    from repro_torch.core.lp_kernel import solve_lp_kernel
    t0 = time.perf_counter()
    res = eng.solve(query, ilp_kwargs=ilp_kwargs, budget=budget,
                    lp_solver=solve_lp_kernel)
    _sync(eng.device)
    return res, time.perf_counter() - t0


def build_and_solve(table, query, *, d_f, alpha, device):
    from repro_torch.core.engine import PackageQueryEngine
    eng = PackageQueryEngine(table, ATTRS, d_f=d_f, alpha=alpha, seed=0,
                             device=device)
    t0 = time.perf_counter()
    eng.partition()
    _sync(device)
    part_s = time.perf_counter() - t0
    res, solve_s = solve(eng, query)
    return eng, res, part_s, solve_s


def phase_parity(rows: int = 200_000, alpha: int = 2000,
                 devices=("cuda", "cpu")) -> None:
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.data.synth_tables import make_table
    table = make_table("tpch", rows, seed=0)
    q = instantiate(Q2_TPCH, column_stats(table, ATTRS), 3)
    (eg, rg, pg, sg), (ec, rc, pc, sc) = (
        build_and_solve(table, q, d_f=100, alpha=alpha, device=dev)
        for dev in devices)
    sizes = [ly.size for ly in eg.hierarchy.layers]
    check(sizes == [ly.size for ly in ec.hierarchy.layers],
          "parity: layer sizes differ between cuda and cpu")
    for lg, lc in zip(eg.hierarchy.layers[1:], ec.hierarchy.layers[1:]):
        check(np.array_equal(lg.part.gid, lc.part.gid),
              "parity: gids differ between cuda and cpu")
        check(np.array_equal(lg.part.order, lc.part.order),
              "parity: order differs between cuda and cpu")
    check(rg.feasible and rc.feasible, "parity: h=3 solve infeasible")
    check(q.check_package(table, rg.idx, rg.mult),
          "parity: cuda package fails check_package")
    rel = abs(rg.obj - rc.obj) / max(1.0, abs(rc.obj))
    check(rel <= 1e-6, f"parity: objective {rg.obj} vs {rc.obj}")
    say("parity", rows=rows, layers=sizes, gids="identical",
        obj_cuda=rg.obj, obj_cpu=rc.obj, rel_diff=rel,
        partition_s_cuda=pg, partition_s_cpu=pc, solve_s_cuda=sg,
        solve_s_cpu=sc)
    # the same solve with the sub-ILP's B&B in waves of 8 (batched LP
    # flights on each engine's device), every card flight kept
    from repro_torch import kernels
    kernels.reset_launches()
    with capturing_flights() as flights:
        w8 = [wave_solve(e, q, 8) for e in (eg, ec)]
    launched = kernels.launch_counts()["lp_batch"]
    (r8g, s8g), (r8c, s8c) = w8
    check(r8g.feasible and r8c.feasible, "parity: W=8 solve infeasible")
    check(q.check_package(table, r8g.idx, r8g.mult),
          "parity: W=8 cuda package fails check_package")
    rel8 = abs(r8g.obj - r8c.obj) / max(1.0, abs(r8c.obj))
    check(rel8 <= 1e-6, f"parity: W=8 objective {r8g.obj} vs {r8c.obj}")
    say("parity W=8", obj_cuda=r8g.obj, obj_cpu=r8c.obj, rel_diff=rel8,
        same_package=same_package(r8g, r8c), solve_s_cuda=s8g,
        solve_s_cpu=s8c, lp_batch_launches=launched)
    return launched, hold_flights(flights, "parity W=8")


def main_path(table, q3, q5, alpha, device):
    """The main path: partition, then Q2_TPCH at h=3 and h=5 through the
    device LP.  Returns (engine, r3, partition s, h=3 s, r5, h=5 s)."""
    from repro_torch.core import guard
    eng, r3, part_s, s3 = build_and_solve(table, q3, d_f=100, alpha=alpha,
                                          device=device)
    r5, s5 = solve(eng, q5, budget=guard.SolveBudget(deadline_s=300.0))
    return eng, r3, part_s, s3, r5, s5


def phase_full(rows: int = 10_000_000, alpha: int = 100_000,
               device="cuda"):
    from repro_torch import kernels
    from repro_torch.core import guard
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.data.synth_tables import make_table
    t0 = time.perf_counter()
    table = make_table("tpch", rows, seed=0)
    stats = column_stats(table, ATTRS)
    q3, q5 = instantiate(Q2_TPCH, stats, 3), instantiate(Q2_TPCH, stats, 5)
    gen_s = time.perf_counter() - t0
    defined = {guard.OK, guard.DEGRADED, guard.INFEASIBLE,
               guard.BUDGET_EXHAUSTED}

    kernels.reset_launches()
    eng, r3, part_s, s3, r5, s5 = main_path(table, q3, q5, alpha, device)
    counts = kernels.launch_counts()

    sizes = [ly.size for ly in eng.hierarchy.layers]
    ok3 = bool(r3.feasible and q3.check_package(table, r3.idx, r3.mult))
    for h, r, s in ((3, r3, s3), (5, r5, s5)):
        say(f"full h={h}", rows=rows, layers=sizes,
            table_gen_s=gen_s, partition_s=part_s, solve_s=s,
            feasible=r.feasible, obj=r.obj, lp_obj=r.lp_obj,
            package_size=int(r.mult.sum()) if r.feasible else 0,
            check_package=(q3 if h == 3 else q5).check_package(
                table, r.idx, r.mult) if r.feasible else None,
            report_status=r.report.status,
            lp_iters=getattr(r.ps_stats, "lp_iters", None),
            status=json.dumps(r.status))
    say("full launches", **counts)
    check(ok3, "full: h=3 solve is not a feasible, valid package")
    check(r3.report.status in (guard.OK, guard.DEGRADED),
          f"full: h=3 report status {r3.report.status}")
    check(r5.report.status in defined,
          f"full: h=5 report status {r5.report.status}")
    if r5.feasible:
        check(q5.check_package(table, r5.idx, r5.mult),
              "full: h=5 package fails check_package")
    for name in PQ_KERNELS:
        check(counts[name] > 0, f"full: kernel {name} was never launched "
                                "on the main path")

    # where the time goes: device busy time of a second partition and a
    # second h=3 solve under torch.profiler, against the unprofiled walls;
    # the partition also with every scan segment on the one-thread path
    # (the scan before its long path), wall and profile
    from repro_torch.core.engine import PackageQueryEngine

    def partition():
        PackageQueryEngine(table, ATTRS, d_f=100, alpha=alpha, seed=0,
                           device=device).partition()

    def short_only(fn):
        def run():
            with long_min(1 << 62):
                fn()
        return run

    t0 = time.perf_counter()
    short_only(partition)()
    _sync(device)
    before_s = time.perf_counter() - t0
    profiled = []                     # the profiled h=3 solve's result
    for label, wall, fn in (
            ("partition, one-thread scan only", before_s,
             short_only(partition)),
            ("partition", part_s, partition),
            ("solve h=3", s3, lambda: profiled.append(solve(eng, q3)[0]))):
        busy_ms, ops, reads, ours, top = device_profile(fn)
        scan_ms = sum(ms for k, (ms, _) in ours.items()
                      if k.startswith("dlv_scan_"))
        per_pivot = {"pivots": profiled[0].ps_stats.lp_iters,
                     "device_ops_per_pivot":
                         ops / max(profiled[0].ps_stats.lp_iters, 1)} \
            if profiled else {}
        say(f"profile {label}", wall_s=wall, device_busy_s=busy_ms / 1e3,
            idle_share=1.0 - busy_ms / 1e3 / wall, scan_device_ms=scan_ms,
            device_ops=ops, **per_pivot, device_to_host=reads,
            kernels=json.dumps(ours), top=json.dumps(top))
    say("profile pivots", layer_lps=eng.hierarchy.L,
        layer_lp_pivots=r3.ps_stats.lp_iters)
    return counts, (table, q3, q5, alpha, device), eng


def device_profile(fn, on_prof=None):
    """(device busy ms, device ops run, device-to-host copies, device ms
    and calls of this repo's kernels, top device ops) of one call of
    ``fn``, from
    torch.profiler's CUDA activity (kernels, copies and fills).  Only
    device events count: a host op's device time is its kernels' time,
    which their own rows already hold.  ``on_prof`` gets the profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if on_prof is not None:
        on_prof(prof)
    rows, reads, ours = [], 0, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        if ev.key.startswith("Memcpy DtoH"):
            reads += ev.count
        name = ev.key.split("(")[0].replace("void ", "")
        if name.startswith(("pricing_kernel", "bfrt_", "segstats_",
                            "dlv_scan_", "flash_fwd_", "flash_bwd_",
                            "lp_batch_")):
            ms0, n0 = ours.get(name, (0.0, 0))
            ours[name] = (ms0 + getattr(ev, "self_device_time_total",
                                        0.0) / 1e3, n0 + ev.count)
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    top = [{"op": k[:60], "ms": ms, "calls": n} for ms, k, n in rows[:8]]
    return sum(r[0] for r in rows), sum(r[2] for r in rows), reads, ours, \
        top


# ------------------------------------------- the static analysis on the card

ANALYSIS_MAX_ITERS = 5000     # the layer LPs' cap (shading's max_lp_iters)


def phase_analysis(eng, q3):
    """The port's traced contracts on the card
    (``repro_torch.analysis.contracts.run_contracts("card")``) on the
    largest layer LP of one Q2_TPCH h=3 solve of phase "full"'s engine (a
    session: the engine's rng is untouched): the device LP's pivot loop
    (one host read, one pricing launch and one BFRT select call a pivot)
    and ``solve_lp_dist`` on an NCCL world of one rank (one ``rep.cpu()``
    a pivot), the distributed steps, the batched engine, pricing, segment
    stats and the descent.  One line a hot path; fails on any violation
    that the port's baseline does not pin.  Returns the records."""
    from repro_torch.analysis import contracts, report
    from repro_torch.core.lp_kernel import solve_lp_kernel
    lps = []

    def keep(c, A_t, bl, bu, ub, **kw):
        lps.append((c, A_t, bl, bu, ub))
        return solve_lp_kernel(c, A_t, bl, bu, ub, **kw)

    eng.session(0).solve(q3, ilp_kwargs=ILP_KW, lp_solver=keep)
    check(bool(lps), "analysis: the h=3 solve ran no layer LP")
    lp = max(lps, key=lambda a: np.asarray(a[0]).size)
    viol, recs, wall = contracts.run_contracts("card", lp=lp,
                                               max_iters=ANALYSIS_MAX_ITERS)
    pinned = report.load_baseline(str(ROOT / "src" / "repro_torch" /
                                      "analysis" / "baseline.json"))
    new, _, _ = report.compare_baseline(viol, pinned)
    for r in recs:
        keys = ("pivots", "host_reads_per_pivot",
                "pricing_launches_per_pivot", "select_calls_per_pivot",
                "bfrt_launches_per_pivot",
                "dense_passes", "dense_passes_per_pivot", "declared_reads",
                "collective_bytes", "collective_bytes_per_pivot",
                "budget_bytes", "traced_s", "untraced_s",
                "trace_cost_s_per_pivot", "status", "wall_s")
        say(f"analysis {r['hot_path']}", **{
            k: json.dumps(r[k]) if isinstance(r[k], dict) else r[k]
            for k in keys if k in r})
    say("analysis", layer_lps=len(lps), lp_columns=int(np.asarray(
        lp[0]).size), lp_rows=int(np.atleast_2d(lp[1]).shape[0]),
        hot_paths=len(recs), violations=len(viol), new=len(new),
        contracts_s=wall)
    for v in viol:
        print(f"  {v.format()}", flush=True)
    check(not new, f"analysis: {len(new)} contract violations not pinned, "
                   f"first: {new[0].format() if new else ''}")
    twin = next(r for r in recs if r["hot_path"].startswith("lp_kernel."))
    check(twin["pivots"] > 0 and twin["host_reads_per_pivot"] == 1.0
          and twin["pricing_launches_per_pivot"] == 1.0
          and twin["select_calls_per_pivot"] == 1.0,
          f"analysis: the device LP's pivot is not one read, one pricing "
          f"launch and one select call: {twin}")
    dist_rec = next(r for r in recs
                    if r["hot_path"].startswith("distributed.solve_lp_dist"))
    rep_reads = dist_rec["declared_reads"].get("solve_lp_dist:cpu", 0)
    check(dist_rec["pivots"] - 1 <= rep_reads <= dist_rec["pivots"],
          f"analysis: solve_lp_dist read rep {rep_reads} times in "
          f"{dist_rec['pivots']} pivots")
    return recs


# --------------------------------------------------------------- phase 5

# the names by which the main path's modules call each kernel's wrapper
CALL_SITES = {"pricing": ("repro_torch.kernels.pricing", "Pricer.__call__"),
              "bfrt_histogram": ("repro_torch.kernels.bfrt",
                                 "Selector.__call__"),
              "segment_stats": ("repro_torch.core.dlv", "segment_stats"),
              "dlv_scan": ("repro_torch.core.dlv", "dlv_scan"),
              "dlv_scan_seed": ("repro_torch.core.dlv", "dlv_scan_seed"),
              "flash_attention": ("repro_torch.models.attention",
                                  "flash_attention_op"),
              # phase "dist": the histogram as the pricing step calls it,
              # segment stats as the mesh-sharded group stats call it
              "bfrt_histogram dist": ("repro_torch.core.distributed",
                                      "bfrt_histogram"),
              "segment_stats mesh": ("repro_torch.core.partitioner",
                                     "segment_stats")}


def _copy(a):
    import torch
    if isinstance(a, torch.Tensor):
        return a.clone()
    return a.copy() if isinstance(a, np.ndarray) else a


@contextlib.contextmanager
def capturing(names=PQ_KERNELS, limit=None):
    """Keep a copy of the arguments of every call (the first ``limit``
    calls, where given) of the kernels ``names`` made inside the block:
    {kernel name: [(args, kwargs), ...]}.  A call site ``Class.method``
    keeps the instance as the first argument."""
    calls = {name: [] for name in names}
    saved = []
    for name in names:
        modname, attr = CALL_SITES[name]
        owner, _, attr = attr.rpartition(".")
        mod = importlib.import_module(modname)
        if owner:
            mod = getattr(mod, owner)
        fn = getattr(mod, attr)

        def kept(*args, _fn=fn, _log=calls[name], **kw):
            if limit is None or len(_log) < limit:
                _log.append((tuple(_copy(a) for a in args),
                             {k: _copy(v) for k, v in kw.items()}))
            return _fn(*args, **kw)

        saved.append((mod, attr, fn))
        setattr(mod, attr, kept)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def hold_calls(calls, tag: str = "", row_step=None,
               plain_host=False) -> dict:
    """Each kernel against its plain version on every kept call of
    ``calls`` ({kernel: [(args, kwargs), ...]}, from ``capturing``; the
    package-query kernels it holds), lines "main-path {tag}{kernel}";
    returns {kernel: (max abs err, numbers at its largest call)}.
    ``row_step`` (a set of call indices, or None for all) picks the scan
    calls also held to the row-step scan; ``plain_host`` runs the scan's
    plain version on host copies."""
    import torch

    def compare(name, each, size):
        """``each`` on every kept call of ``name``: (results, the largest
        call's args and kwargs, its index)."""
        t0 = time.perf_counter()
        res = [each(i, *a, **kw) for i, (a, kw) in enumerate(calls[name])]
        torch.cuda.synchronize()
        sizes = [size(*a) for a, _ in calls[name]]
        big = int(np.argmax(sizes))
        say(f"main-path {tag}{name}", calls=len(res),
            sizes=f"{min(sizes)}..{max(sizes)} ({len(set(sizes))} "
            f"distinct)", check_s=time.perf_counter() - t0)
        return res, calls[name][big], big

    def price_args(p, rho, d, state, s):
        return p.A, rho, d, state, p.lo, p.hi, s

    out = {}
    if "pricing" in calls:
        res, (a, _), _ = compare(
            "pricing", lambda i, *a: pricing_check(price_args(*a)),
            lambda p, *_: p.A.shape[1])
        out["pricing"] = (max(res), pricing_times(price_args(*a)))
    if "bfrt_histogram" in calls:
        res, (a, kw), _ = compare(
            "bfrt_histogram", lambda i, sel, *a, **kw: bfrt_check(*a, **kw),
            lambda sel, r, *_: r.shape[0])
        out["bfrt_histogram"] = (max(res), bfrt_times(*a[1:], **kw))
    if "bfrt_histogram dist" in calls:
        res, (a, _), _ = compare("bfrt_histogram dist",
                                 lambda i, *a: bfrt_hist_check(*a),
                                 lambda r, *_: r.shape[0])
        out["bfrt_histogram dist"] = (max(res), bfrt_hist_times(*a))
    for name in ("segment_stats", "segment_stats mesh"):
        if name in calls:
            res, (a, _), _ = compare(name, lambda i, *a: segstats_check(*a),
                                     lambda v, *_: v.shape[0])
            out[name] = (max(res), segstats_times(*a))
    if "dlv_scan" in calls:
        res, (a, kw), big = compare(
            "dlv_scan", lambda i, *a, **kw: dlv_check(
                *a, row_step=row_step is None or i in row_step,
                plain_host=plain_host, **kw)[1:],
            lambda v, *_: len(v))
        # the largest call's plain time was taken while checking it
        out["dlv_scan"] = (0.0, dlv_times(*a, res[big][0], **kw))
        windows = sum(r[1] for r in res)
        stats = [r[2] for r in res]
        say(f"main-path {tag}dlv_scan long path",
            calls_with_long_segments=sum(st["segments"] > 0
                                         for st in stats),
            largest_call_long=stats[big]["segments"] > 0,
            largest_call=json.dumps(stats[big]),
            **{f"all_{k}": sum(st[k] for st in stats)
               for k in ("segments", "passes", "spec_cuts", "windows",
                         "repairs")})
    for name, (err, nums) in out.items():
        extra = {"row_step_windows": windows,
                 "row_step_calls": len(calls[name]) if row_step is None
                 else len(row_step)} if name == "dlv_scan" else {}
        say(f"main-path {tag}{name} at its largest call", max_abs_err=err,
            **extra, **nums)
    return out


def phase_main_inputs(counts, table, q3, q5, alpha, device):
    """Each kernel against its plain version on every input that the main
    path gives it; returns {kernel: (max abs err, numbers at its largest
    call)}."""
    from repro_torch import kernels
    from repro_torch.core import dlv
    kernels.reset_launches()
    gathers = []                 # each segment_stats call's gather inputs
    with capturing() as calls:
        kept = dlv.segment_stats

        def with_gather(*a, **kw):
            f = sys._getframe(1).f_locals    # dlv_rounds' frame
            gathers.append((f["Xd"], f["idxs"].clone(), f["gshift_d"]))
            return kept(*a, **kw)

        dlv.segment_stats = with_gather
        try:
            main_path(table, q3, q5, alpha, device)
        finally:
            dlv.segment_stats = kept
    again = kernels.launch_counts()
    say("main-path inputs", calls=json.dumps(
        {k: len(v) for k, v in calls.items()}),
        launches_as_in_phase_4=again == counts)
    for name, got in calls.items():
        check(len(got) > 0, f"main path: no call of {name} was kept")
    out = hold_calls(calls)
    # every segment stats call, with the gather before it in dlv_rounds,
    # (Xd[idxs] - gshift_d).contiguous(), timed on the same inputs
    for c, ((args, _), (Xd, idxs, gs)) in enumerate(
            zip(calls["segment_stats"], gathers)):
        nums = segstats_times(*args, plain=False)
        say(f"main-path segment_stats call {c}", n=args[0].shape[0],
            G=args[2], longest_group=nums["longest_group"], ms=nums["ms"],
            device_ms=nums["device_ms"], bound_ms=nums["bound_ms"],
            launches_per_call=nums["launches_per_call"],
            gather_ms=timed_ms(lambda: (Xd[idxs] - gs).contiguous(), 10))
    return out


# ---------------------------------------------- the batched LP engine

# the reference benchmark's instances (benchmarks/batch_lp.py): the B&B
# tree (``_bnb``, smoke profile) and the Dual Reducer's rung flight
# (``_dr_rungs``); "wide": the same rungs over 100,000 columns, past
# NS_MAX, so every lane keeps its state in the global workspace and its
# select sorts in rounds
LP_BNB = dict(seed=42, n=150, width=0.05, wave_width=64,
              max_nodes=50_000)
LP_RUNGS = dict(n=300, rungs=12, q=25.0)
LP_WIDE = dict(n=100_000, rungs=4, q=25.0)
LP_BUDGET = dict(seed=3, K=8, n=60, m=5)
# more rows than the kernel keeps in shared memory (m_pad 64)
LP_TALL = dict(seed=5, K=4, n=80, m=40)


def random_flight(seed: int, K: int, n: int, m: int):
    """One shared (c, A, bl, bu) around a feasible point and K bound
    variants (``tests/test_lp_batch.py``'s flights)."""
    rng = np.random.default_rng(seed)
    c, A = rng.normal(size=n), rng.normal(size=(m, n))
    ub = rng.integers(1, 4, size=n).astype(float)
    act = A @ (rng.uniform(0, 1, n) * ub)
    wid = np.abs(rng.normal(size=m)) * 2 + 0.5
    return (c, A, act - wid, act + wid,
            [ub * rng.uniform(0.5, 1.0, n) for _ in range(K)])


def lp_instance(seed: int, n: int, width: float):
    """``benchmarks/batch_lp.py::_instance``: count in [15, 45], a value
    sum in 420 +/- width over a synthetic gift-basket table."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(14.0, 1.5, n)
    c = np.abs(rng.normal(1.0, 0.5, n))
    return (c, np.vstack([np.ones(n), vals]),
            np.array([15.0, 420.0 - width]), np.array([45.0, 420.0 + width]))


def rung_flight(c, A, bl, bu, ub, rungs, q, warm=None):
    """The Dual Reducer's rungs ``ub_j = min(ub, E / (q 2^j))`` of one
    (c, A), warm from lp1 (``core/dual_reducer.py``)."""
    from repro_torch.core.lp import OPTIMAL, solve_lp_np
    lp1 = solve_lp_np(c, A, bl, bu, ub, max_iters=20000, warm_start=warm)
    check(lp1.status == OPTIMAL, f"lp batch: lp1 status {lp1.status}")
    E = float(np.sum(lp1.x))
    return [np.minimum(ub, max(E / (max(q, 1) * 2 ** j), 1e-9))
            for j in range(rungs)], lp1


@contextlib.contextmanager
def capturing_flights():
    """Keep every batched LP flight launched inside the block: (the
    ``LaneSolver``, cf, A, the in pack, the out pack it returned)."""
    from repro_torch.kernels import lp_batch
    kept = []
    call = lp_batch.LaneSolver.__call__

    def keep(self, cf, A, in_pack):
        out = call(self, cf, A, in_pack)
        if self.cuda:
            kept.append((self, cf, A, np.array(in_pack), out.copy()))
        return out

    lp_batch.LaneSolver.__call__ = keep
    try:
        yield kept
    finally:
        lp_batch.LaneSolver.__call__ = call


@contextlib.contextmanager
def keeping_dual_reducer():
    """Keep the (query, table, S, warm start) of every Dual Reducer call
    made inside the block (``core/shading.py``'s)."""
    from repro_torch.core import shading
    kept, dual_reducer = [], shading.dual_reducer

    def keep(query, table_, S, **kw):
        kept.append((query, table_, np.array(S), kw.get("warm_start")))
        return dual_reducer(query, table_, S, **kw)

    shading.dual_reducer = keep
    try:
        yield kept
    finally:
        shading.dual_reducer = dual_reducer


def dr_rungs(kept_dr):
    """Four rungs of the first kept Dual Reducer LP: its candidate set,
    warm from its lp1 -- (c, A, bl, bu, ubs, lp1)."""
    query, table_, S, warm = kept_dr[0]
    cd, Ad, bld, bud, ubd = query.matrices(table_, S)
    ubs, lp1 = rung_flight(cd, Ad, bld, bud, ubd, 4, 500, warm)
    return cd, Ad, bld, bud, ubs, lp1


def lp_main_flights(device, full: bool = True) -> dict:
    """The batched LP engine's main-path flights on ``device``, each as
    ``capturing_flights`` keeps it: every flight of B&B at W = 64 on the
    reference benchmark's instance, the Dual Reducer's rung flight (warm
    from lp1), the parity cell's flights (200k rows, h=3, its sub-ILP's
    B&B at W = 8) and, with ``full``, four rungs of the full cell's h=3
    Dual Reducer LP (the 10M-row build, its sub-ILP at W = 8)."""
    from repro_torch.core.ilp import solve_ilp
    from repro_torch.core.lp_batch import solve_lp_batch
    bb = LP_BNB
    c, A, bl, bu = lp_instance(bb["seed"], bb["n"], bb["width"])
    with capturing_flights() as bnb:
        solve_ilp(c, A, bl, bu, np.ones(bb["n"]), wave_width=bb["wave_width"],
                  max_nodes=bb["max_nodes"], time_limit_s=600.0,
                  device=device)
    out = {"bnb": bnb}
    cr, Ar, blr, bur = lp_instance(9, LP_RUNGS["n"], 2.0)
    ubs, lp1 = rung_flight(cr, Ar, blr, bur, np.full(LP_RUNGS["n"], 3.0),
                           LP_RUNGS["rungs"], LP_RUNGS["q"])
    with capturing_flights() as out["rungs"]:
        solve_lp_batch(cr, Ar, blr, bur, ubs, warm_starts=[lp1] * len(ubs),
                       backend="device", device=device)
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.data.synth_tables import make_table
    table = make_table("tpch", 200_000, seed=0)
    q = instantiate(Q2_TPCH, column_stats(table, ATTRS), 3)
    eng = PackageQueryEngine(table, ATTRS, d_f=100, alpha=2000, seed=0,
                             device=device)
    eng.partition()
    with capturing_flights() as out["parity W=8"]:
        wave_solve(eng, q, 8)
    if full:
        table = make_table("tpch", 10_000_000, seed=0)
        q3 = instantiate(Q2_TPCH, column_stats(table, ATTRS), 3)
        eng = PackageQueryEngine(table, ATTRS, d_f=100, alpha=100_000,
                                 seed=0, device=device)
        eng.partition()
        with keeping_dual_reducer() as kept:
            wave_solve(eng, q3, 8)
        cd, Ad, bld, bud, ubs, lp1 = dr_rungs(kept)
        with capturing_flights() as out["full-cell rungs"]:
            solve_lp_batch(cd, Ad, bld, bud, ubs,
                           warm_starts=[lp1] * len(ubs), backend="device",
                           device=device)
    return out


@contextlib.contextmanager
def dispatch_split():
    """Time every batched LP dispatch made inside the block by its parts
    (one thread).  Yields a list, one dict of seconds a dispatch:
    ``dispatch`` all of ``core/lp_batch.py::_dispatch``; ``validate``
    its ``_validate_warm_batch``; ``solver`` the ``LaneSolver`` call
    (pinned copies in and out, the launches, the sync); ``assembly`` the
    dispatch before that call less ``validate``; ``unpack`` after it."""
    from repro_torch.core import lp_batch as core
    from repro_torch.kernels import lp_batch
    rows = []
    disp, val = core._dispatch, core._validate_warm_batch
    call = lp_batch.LaneSolver.__call__

    def timed_dispatch(*a, **kw):
        row = {"validate": 0.0, "start": time.perf_counter()}
        rows.append(row)
        out = disp(*a, **kw)
        row["end"] = time.perf_counter()
        return out

    def timed_validate(*a, **kw):
        t0 = time.perf_counter()
        out = val(*a, **kw)
        rows[-1]["validate"] += time.perf_counter() - t0
        return out

    def timed_call(self, *a, **kw):
        rows[-1]["call0"] = time.perf_counter()
        out = call(self, *a, **kw)
        rows[-1]["call1"] = time.perf_counter()
        return out

    core._dispatch, core._validate_warm_batch = timed_dispatch, timed_validate
    lp_batch.LaneSolver.__call__ = timed_call
    split = []
    try:
        yield split
    finally:
        core._dispatch, core._validate_warm_batch = disp, val
        lp_batch.LaneSolver.__call__ = call
        for r in rows:
            if "call0" in r and "end" in r:
                split.append({
                    "dispatch": r["end"] - r["start"],
                    "validate": r["validate"],
                    "solver": r["call1"] - r["call0"],
                    "assembly": r["call0"] - r["start"] - r["validate"],
                    "unpack": r["end"] - r["call1"]})


def lp_cta_flights(device) -> dict:
    """The CTA path's flights of phase "lp batch", kept as
    ``capturing_flights`` keeps them: "wide" (the rung flight over
    100,000 columns) and "tall" (40 rows)."""
    from repro_torch.core.lp_batch import solve_lp_batch
    cw, Aw, blw, buw = lp_instance(9, LP_WIDE["n"], 2.0)
    ubs, lp1 = rung_flight(cw, Aw, blw, buw, np.full(LP_WIDE["n"], 3.0),
                           LP_WIDE["rungs"], LP_WIDE["q"])
    out = {}
    with capturing_flights() as out["wide"]:
        solve_lp_batch(cw, Aw, blw, buw, ubs, warm_starts=[lp1] * len(ubs),
                       backend="device", device=device)
    with capturing_flights() as out["tall"]:
        solve_lp_batch(*random_flight(**LP_TALL), backend="device",
                       device=device)
    return out


def lp_plain(solver, cf, A, in_pack):
    """The plain version's out pack for one flight, on the card."""
    import torch
    from repro_torch.kernels import lp_batch
    out = lp_batch.lp_batch_plain(
        cf, A, torch.as_tensor(in_pack, device=cf.device),
        max_iters=solver.max_iters, refactor_every=solver.refactor_every)
    return out.cpu().numpy()


def warp_n_max() -> int:
    """The widest flight (N) the batched LP kernel runs one warp a lane."""
    src = (ROOT / SOURCES["lp_batch"][0]).read_text()
    return int(re.search(r"#define WARP_N_MAX (\d+)", src)[1])


def lp_path(solver) -> str:
    """The path a flight must take: "warp" for m_pad <= 32 and N <=
    WARP_N_MAX (the narrow flights), else "cta"."""
    return "warp" if solver.m_pad <= 32 and solver.N <= warp_n_max() \
        else "cta"


def hold_flights(flights, tag: str) -> float:
    """Every kept flight's out pack against the plain version on the card
    (``lane_mismatches`` and the spent pivots), and its path against
    ``lp_path``; returns the largest difference in x or the objective."""
    from repro_torch.kernels import lp_batch
    t0 = time.perf_counter()
    worst, lanes, paths = 0.0, 0, {}
    for i, (solver, cf, A, in_pack, out) in enumerate(flights):
        plan = solver.plan
        check(plan["path"] == lp_path(solver), f"lp batch {tag}: flight {i}"
              f" (m_pad {solver.m_pad}, N {solver.N}) took the "
              f"{plan['path']} path")
        key = f"{plan['path']}, {plan['lanes_per_cta']} lanes a CTA" \
            + (", (cf, A) staged" if plan["staged"] else "")
        paths[key] = paths.get(key, 0) + 1
        want = lp_plain(solver, cf, A, in_pack)
        bad, x_err, obj_err = lp_batch.lane_mismatches(out, want, in_pack,
                                                       solver.m_pad)
        check(not bad, f"lp batch {tag}: flight {i}, lanes {bad} differ "
                       "from the plain version")
        col = 2 * solver.N + 2 * solver.m_pad + 5
        check(out[0, col] == want[0, col], f"lp batch {tag}: flight {i} "
              f"spent {out[0, col]} != plain {want[0, col]}")
        worst = max(worst, x_err, obj_err)
        lanes += int(np.count_nonzero(
            in_pack[:, 3 * solver.N + 1 + solver.m_pad]))
    say(f"main-path {tag} lp_batch", flights=len(flights), lanes=lanes,
        paths=json.dumps(paths), max_abs_err=worst,
        check_s=time.perf_counter() - t0)
    return worst


def lane_bar(got, want, tag: str) -> float:
    """LPResults lane by lane under the lane bar (TOLERANCE["lp_batch"]);
    returns the largest difference in x or the objective."""
    from repro_torch.core.lp import INFEASIBLE
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        check((g.status, g.iters) == (w.status, w.iters),
              f"lp batch {tag}: lane {k} status/iters {g.status}/{g.iters}"
              f" != {w.status}/{w.iters}")
        if w.status == INFEASIBLE:
            continue
        dx = float(np.abs(g.x - w.x).max())
        do = abs(g.obj - w.obj)
        worst = max(worst, dx, do)
        check(np.array_equal(np.sort(g.basis), np.sort(w.basis))
              and np.array_equal(g.at_upper, w.at_upper)
              and dx <= 1e-9 and do <= 1e-9 * max(1.0, abs(w.obj)),
              f"lp batch {tag}: lane {k} differs (x err {dx}, obj err {do}"
              ", or the basis or bound pattern)")
    return worst


def kernel_ms(solver, cf, A, in_pack, reps: int):
    """(CUDA-event ms, launches) of one flight's launches alone, back to
    back: the full launch, and the trip-limited one when the shared cap
    truncates the lockstep loop.  Loads the flight into the solver's
    device buffers first (one call)."""
    from repro_torch.kernels import lp_batch
    N, m = solver.N, solver.m_pad
    valid = in_pack[:, 3 * N + 1 + m] != 0.0
    solver(cf, A, in_pack)
    solver._launch(cf, A, solver.max_iters)
    natural = solver._read()[valid, N + 2 * m + 2].astype(np.int64)
    trips = lp_batch.lockstep_trips(natural, int(in_pack[0, 3 * N + 2 + m]))
    limits = [solver.max_iters] + ([trips] if trips < natural.max() else [])
    return timed_ms(lambda: [solver._launch(cf, A, t) for t in limits],
                    reps), len(limits)


def flight_numbers(solver, cf, A, in_pack, out, dispatch=None,
                   reps: int = 10) -> dict:
    """One flight's times: ``ms`` the kernel's own (CUDA events around its
    launches back to back: the full launch, and the trip-limited one when
    the shared cap truncates), ``device_ms`` the same under the profiler
    (the kernels' device time, without the host's gaps between
    launches), ``wall_ms`` one ``LaneSolver`` call (the
    pinned copies in and out and the host sync included), ``dispatch_ms``
    the whole ``solve_lp_batch`` call when ``dispatch`` is given (lane
    assembly, warm validation and unpack on the host), the plain
    version's wall on the card, and the bound, at the unpadded m rows and
    N = n + m columns: the bytes of A and cf once a flight (the lanes
    share them) and each valid lane's in and out rows, over HBM; pricing's
    2 m N flops for every trip that priced (a lane's trips, less the last
    one of a lane that ended optimal), over float64's peak."""
    import torch
    from repro_torch.core.lp import OPTIMAL
    from repro_torch.kernels import lp_batch
    N, m = solver.N, solver.m_pad
    valid = in_pack[:, 3 * N + 1 + m] != 0.0
    its = out[valid, N + 2 * m + 2]
    priced = its - (out[valid, N + 2 * m + 1] == OPTIMAL)
    lanes = int(valid.sum())
    # the real rows and columns: the padded ones are zero left of the
    # slacks
    nz = A[:, :solver.n_pad].cpu().numpy() != 0.0
    m_real = int(nz.any(1).sum())
    N_real = int(nz.any(0).sum()) + m_real
    nbytes = ((m_real + 1) * N_real
              + lanes * (in_pack.shape[1] + out.shape[1])) * 8
    ops = float(priced.sum()) * 2 * m_real * N_real
    solver(cf, A, in_pack)
    t0 = time.perf_counter()
    for _ in range(reps):
        solver(cf, A, in_pack)
    wall = (time.perf_counter() - t0) / reps * 1e3
    ms, n_launch = kernel_ms(solver, cf, A, in_pack, reps)
    extra = {}
    if dispatch is not None:
        dispatch()
        t0 = time.perf_counter()
        for _ in range(reps):
            dispatch()
        extra["dispatch_ms"] = (time.perf_counter() - t0) / reps * 1e3
    device = per_call_device(lambda: solver(cf, A, in_pack), reps, lp_batch,
                             "lp_batch")["device_ms"]
    lp_plain(solver, cf, A, in_pack)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp_plain(solver, cf, A, in_pack)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    host = extra.get("dispatch_ms", wall)
    return _numbers(f"K={lanes} of {solver.K_pad} N={N} m_pad={m}", nbytes,
                    ops, ms, plain, None, device_ms=device, **solver.plan,
                    wall_ms=wall, **extra,
                    host_share=1.0 - ms / host, launches_per_call=n_launch,
                    lanes=lanes, trips=int(its.max()),
                    priced_trips=int(priced.sum()), rows=m_real, columns=N_real)


def same_package(a, b) -> bool:
    oa, ob = np.argsort(a.idx, kind="stable"), np.argsort(b.idx,
                                                         kind="stable")
    return bool(np.array_equal(np.asarray(a.idx)[oa], np.asarray(b.idx)[ob])
                and np.array_equal(np.asarray(a.mult)[oa],
                                   np.asarray(b.mult)[ob]))


def wave_solve(eng, query, W: int, budget=None):
    """``solve`` from a fresh engine rng, B&B in waves of W."""
    eng.rng = np.random.default_rng(0)
    return solve(eng, query, budget, ilp_kwargs={**ILP_KW, "wave_width": W})


def phase_lp_batch(eng, table, q3, q5, alpha, device):
    """The batched LP engine: its main path (B&B at W = 64 on the
    reference benchmark's instance, against W = 1 and the plain version),
    the rung, full-cell, wide and budget flights against the plain version
    and ``solve_lp_np``, and the full cell's h=3 / h=5 solves at W = 8
    against W = 1.  Returns {"launches", "paths", "err", "main",
    "fixed"}."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import guard
    from repro_torch.core.ilp import solve_ilp
    from repro_torch.core.lp_batch import (batch_cache_stats, batch_stats,
                                           reset_batch_stats, solve_lp_batch)
    from repro_torch.kernels import lp_batch
    errs, paths = [], {}

    # ---- the main path: B&B, W = 64, every wave's flight one launch
    bb = LP_BNB
    c, A, bl, bu = lp_instance(bb["seed"], bb["n"], bb["width"])
    ub = np.ones(bb["n"])
    kw = dict(max_nodes=bb["max_nodes"], time_limit_s=600.0)
    t0 = time.perf_counter()
    r1 = solve_ilp(c, A, bl, bu, ub, wave_width=1, device=device, **kw)
    w1_s = time.perf_counter() - t0
    reset_batch_stats()
    kernels.reset_launches()
    with capturing_flights() as flights:
        t0 = time.perf_counter()
        rw = solve_ilp(c, A, bl, bu, ub, wave_width=bb["wave_width"],
                       device=device, **kw)
        _sync(device)
        ww_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    stats, cache = batch_stats(), batch_cache_stats()
    launched = counts["lp_batch"]
    t0 = time.perf_counter()
    rp = solve_ilp(c, A, bl, bu, ub, wave_width=bb["wave_width"],
                   device="cpu", **kw)
    wp_s = time.perf_counter() - t0
    disp = max(stats["dispatches"], 1)
    valid = [in_pack[:, 3 * sv.N + 1 + sv.m_pad] != 0.0
             for sv, _, _, in_pack, _ in flights]
    trips = [int(f[4][v, f[0].N + 2 * f[0].m_pad + 2].max())
             for f, v in zip(flights, valid)]
    say("lp batch bnb", n=bb["n"], wave_width=bb["wave_width"],
        W1_s=w1_s, W64_s=ww_s, W64_plain_cpu_s=wp_s,
        nodes_W1=r1.nodes, nodes_W64=rw.nodes, nodes_W64_plain=rp.nodes,
        lp_iters_W1=r1.lp_iters, lp_iters_W64=rw.lp_iters,
        obj_W1=r1.obj, obj_W64=rw.obj, dispatches=stats["dispatches"],
        launches=launched, launches_per_dispatch=launched / disp,
        lanes_per_dispatch=float(np.mean([v.sum() for v in valid])),
        flights=len(flights), trips_per_dispatch=float(np.mean(trips)),
        max_trips=max(trips), batch_stats=json.dumps(stats),
        cache=json.dumps(cache), W64_wall_ms_per_dispatch=ww_s / disp * 1e3)
    check(r1.feasible and rw.feasible, "lp batch bnb: infeasible")
    check(np.array_equal(rw.x, r1.x) and rw.obj == r1.obj,
          "lp batch bnb: W=64 package or objective differs from W=1")
    check((rw.nodes, rw.lp_iters) == (rp.nodes, rp.lp_iters),
          f"lp batch bnb: nodes/LP iterations {rw.nodes}/{rw.lp_iters} "
          f"!= the plain version's {rp.nodes}/{rp.lp_iters}")
    check(launched == len(flights) == stats["dispatches"] > 0,
          f"lp batch bnb: {launched} launches for {stats['dispatches']} "
          "dispatches")
    check(all(lp_path(f[0]) == "warp" for f in flights),
          "lp batch bnb: a flight is not narrow (m_pad <= 32, N <= "
          "WARP_N_MAX)")
    paths["bnb W=64"] = launched
    errs.append(hold_flights(flights, "bnb W=64"))
    # the kernel's device time over every wave's flight, against the wall
    dev_ms = [kernel_ms(f[0], f[1], f[2], f[3], 3)[0] for f in flights]
    # and under the profiler: the kernels' own device time, every flight
    # once (its LaneSolver call), without the host's launch gaps
    prof = per_call_device(lambda: [f[0](f[1], f[2], f[3])
                                    for f in flights], 1, lp_batch,
                           "lp_batch")
    say("lp batch bnb device", flights=len(dev_ms),
        device_ms_sum=float(np.sum(dev_ms)),
        device_ms_per_dispatch=float(np.mean(dev_ms)),
        device_ms_max=float(np.max(dev_ms)),
        profiled_ms_sum=prof["device_ms"],
        profiled_launches=prof["profiled_launches"], W64_s=ww_s,
        device_share_of_W64_wall=float(np.sum(dev_ms)) / 1e3 / ww_s)
    # one B&B dispatch's host time, split: the same solve again, timed
    with dispatch_split() as split:
        t0 = time.perf_counter()
        solve_ilp(c, A, bl, bu, ub, wave_width=bb["wave_width"],
                  device=device, **kw)
        _sync(device)
        split_s = time.perf_counter() - t0
    check(len(split) == len(dev_ms), f"lp batch bnb split: {len(split)} "
          f"dispatches timed, {len(dev_ms)} flights")
    part = {k: float(np.mean([r[k] for r in split])) * 1e3
            for k in ("dispatch", "assembly", "validate", "solver", "unpack")}
    kern = float(np.mean(dev_ms))
    say("lp batch bnb dispatch split", dispatches=len(split),
        wall_ms_per_dispatch=split_s / len(split) * 1e3,
        dispatch_ms=part["dispatch"], lane_assembly_ms=part["assembly"],
        validate_warm_batch_ms=part["validate"],
        lane_solver_ms=part["solver"], kernel_ms=kern,
        copies_and_sync_ms=part["solver"] - kern,
        unpack_ms=part["unpack"],
        outside_dispatch_ms=split_s / len(split) * 1e3 - part["dispatch"])
    big = max(flights, key=lambda f: int(np.count_nonzero(
        f[3][:, 3 * f[0].N + 1 + f[0].m_pad])))
    main = flight_numbers(*big)
    say("lp batch bnb largest flight", **main)

    def flight(tag, c, A, bl, bu, ubs, lp1, budget_kw=None, path=None):
        """A flight on the card (one captured launch or two), on ``path``
        where given (always on ``lp_path``'s), against the plain version
        on the card and ``solve_lp_np``; its numbers."""
        kw = dict(warm_starts=None if lp1 is None else [lp1] * len(ubs))
        before = lp_batch.launches
        with capturing_flights() as kept:
            got = solve_lp_batch(c, A, bl, bu, ubs, backend="device",
                                 device=device, **kw, **(budget_kw or {}))
        n_launch = lp_batch.launches - before
        (f,) = kept
        check(path in (None, f[0].plan["path"]), f"lp batch {tag}: the "
              f"{f[0].plan['path']} path, not the {path} path")
        err = hold_flights(kept, tag)
        if budget_kw is None:
            err = max(err, lane_bar(got, solve_lp_batch(
                c, A, bl, bu, ubs, backend="np", **kw), tag))
        nums = flight_numbers(*f, dispatch=lambda: solve_lp_batch(
            c, A, bl, bu, ubs, backend="device", device=device, **kw))
        say(f"lp batch {tag}", launches=n_launch,
            iters=json.dumps([g.iters for g in got]),
            statuses=json.dumps([g.status for g in got]), **nums)
        return got, n_launch, err, nums

    # ---- the Dual Reducer's rung flight, warm from lp1
    cr, Ar, blr, bur = lp_instance(9, LP_RUNGS["n"], 2.0)
    ubs, lp1 = rung_flight(cr, Ar, blr, bur, np.full(LP_RUNGS["n"], 3.0),
                           LP_RUNGS["rungs"], LP_RUNGS["q"])
    _, n1, err, fixed = flight("rungs", cr, Ar, blr, bur, ubs, lp1)
    check(n1 == 1, f"lp batch rungs: {n1} launches")
    errs.append(err)

    # ---- wide: the rungs over 100,000 columns (global workspace)
    cw, Aw, blw, buw = lp_instance(9, LP_WIDE["n"], 2.0)
    ubs, lp1 = rung_flight(cw, Aw, blw, buw, np.full(LP_WIDE["n"], 3.0),
                           LP_WIDE["rungs"], LP_WIDE["q"])
    _, n1, err, _ = flight("wide", cw, Aw, blw, buw, ubs, lp1, path="cta")
    check(n1 == 1, f"lp batch wide: {n1} launches")
    errs.append(err)

    # ---- tall: 40 rows, a lane's rows in the global workspace
    _, n1, err, _ = flight("tall", *random_flight(**LP_TALL), None,
                           path="cta")
    check(n1 == 1, f"lp batch tall: {n1} launches")
    errs.append(err)

    # ---- a shared pivot budget that stops the lockstep loop mid-flight
    cb, Ab, blb, bub, ubs = random_flight(**LP_BUDGET)
    free = solve_lp_batch(cb, Ab, blb, bub, ubs, backend="device",
                          device=device)
    its = [r.iters for r in free]
    cap = int(np.minimum(its, int(np.median(its))).sum())
    got, n2, err, _ = flight("budget", cb, Ab, blb, bub, ubs,
                             None, {"budget": guard.SolveBudget(
                                 max_pivots=cap)})
    want = solve_lp_batch(cb, Ab, blb, bub, ubs,
                          backend="device", device="cpu",
                          budget=guard.SolveBudget(max_pivots=cap))
    check([(g.status, g.iters, g.notes) for g in got]
          == [(w.status, w.iters, w.notes) for w in want],
          "lp batch budget: lanes differ from the plain lockstep loop")
    check(n2 == 2 and len({g.status for g in got}) > 1,
          f"lp batch budget: {n2} launches, statuses "
          f"{[g.status for g in got]} (expected a truncation mid-flight)")
    say("lp batch budget cap", max_pivots=cap, free_iters=json.dumps(its))
    errs.append(err)

    # ---- the full cell at W = 8 against W = 1; its h=3 Dual Reducer LP
    kernels.reset_launches()
    kept_dr = []
    with capturing_flights() as full_flights:
        for h, q in ((3, q3), (5, q5)):
            budget = None if h == 3 else guard.SolveBudget(deadline_s=300.0)
            one, s1 = wave_solve(eng, q, 1, budget)
            budget = None if h == 3 else guard.SolveBudget(deadline_s=300.0)
            with keeping_dual_reducer() as kept:
                eight, s8 = wave_solve(eng, q, 8, budget)
            kept_dr += kept
            same = same_package(one, eight)
            # one package's objective, summed in another order by the
            # wave's vectorized incumbent check (core/ilp.py): 1e-12
            rel = abs(one.obj - eight.obj) / max(1.0, abs(one.obj))
            say(f"lp batch full h={h} W=8", feasible=eight.feasible,
                obj_W1=one.obj, obj_W8=eight.obj, rel_diff=rel,
                same_package=same, solve_s_W1=s1, solve_s_W8=s8,
                report_status=eight.report.status)
            check(one.feasible == eight.feasible and same and rel <= 1e-12,
                  f"lp batch full h={h}: W=8 gives another package or "
                  "objective")
    paths["full W=8"] = kernels.launch_counts()["lp_batch"]
    errs.append(hold_flights(full_flights, "full W=8"))

    # four rungs of the h=3 Dual Reducer LP: its candidate set, warm
    # from its lp1
    cd, Ad, bld, bud, ubs, lp1 = dr_rungs(kept_dr)
    _, n1, err, _ = flight(f"full-cell rungs (n={len(kept_dr[0][2])})", cd,
                           Ad, bld, bud, ubs, lp1)
    errs.append(err)
    torch.cuda.empty_cache()
    return {"launches": launched, "paths": paths, "err": max(errs),
            "main": main, "fixed": fixed}


# --------------------------------- the split-tree descent and the cache

# Q2_TPCH's flight over the full cell (the reference benchmark's,
# benchmarks/cache_bench.py): the cached query and its tightened,
# widened and disjoint variants, by hardness
CACHE_FLIGHT = dict(prime=2.0, tight=3.0, wide=1.0)
APPEND_FRESH = 100_000    # fresh rows appended (make_table seed 2)

DESCENT_CALLS = 21        # calls timed: back to back by events, each by
                          # the profiler (a median and its spread)


def descent_compares(tree, Td) -> int:
    """The float64 comparisons the descent of the rows ``Td`` makes on
    ``tree``: each live bisection step of each level (the plain version's
    loop, counting)."""
    import torch
    attr, off, bounds, children = tree.device_arrays(Td.device)
    cur = torch.full((Td.shape[0],), int(tree.root), dtype=torch.int64,
                     device=Td.device)
    total = 0
    if attr.numel() == 0:
        return 0
    act = torch.nonzero(cur >= 0).flatten()
    while act.numel():
        nodes = cur[act]
        vals = Td[act, attr[nodes].long()]
        lo, hi = off[nodes].clone(), off[nodes + 1].clone()
        live = lo < hi
        while bool(live.any()):
            total += int(live.sum())
            mid = (lo + hi) >> 1
            take = live & (bounds[mid.clamp(max=bounds.numel() - 1)] <= vals)
            lo = torch.where(take, mid + 1, lo)
            hi = torch.where(live & ~take, mid, hi)
            live = lo < hi
        cur[act] = children[nodes + lo]
        act = act[cur[act] >= 0]
    return total


def descent_times(call, kernel: str) -> dict:
    """``call()`` timed: ms per call by CUDA events over DESCENT_CALLS
    back-to-back calls (host launch gaps included), and the device ms per
    call of the kernel named ``kernel`` from the profiler over as many
    calls: median, min and max ("not measured" where the profiler records
    no such kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ms = timed_ms(call, DESCENT_CALLS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DESCENT_CALLS):
            call()
        torch.cuda.synchronize()
    us = []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and \
                ev.name.split("(")[0].split("<")[0].replace(
                    "void ", "") == kernel:
            us.append(getattr(ev, "self_device_time_total", 0.0)
                      or ev.time_range.elapsed_us())
    if not us:
        return {"ms": ms, "device_ms": "not measured"}
    us = np.sort(np.asarray(us, np.float64)) / 1e3
    return {"ms": ms, "device_ms": float(np.median(us)),
            "device_ms_min": float(us[0]), "device_ms_max": float(us[-1]),
            "device_calls": len(us)}


def descent_vs_bisection(Td, packed, want) -> dict:
    """The descent kernel and the kernel it replaced (one thread a row
    bisecting the tree's own arrays, ``descend_batch_bisect``) timed on
    the rows ``Td`` in this run, one after the other; the replaced
    kernel's leaves must equal ``want`` too.  Its numbers carry the prefix
    ``bisection_``."""
    import torch
    from repro_torch.kernels import split_tree
    check(torch.equal(split_tree.descend_batch_bisect(Td, packed), want),
          "split_tree_bisect: the replaced kernel's leaves differ from the "
          "plain version's")
    new = descent_times(lambda: split_tree.descend_batch(Td, packed),
                        "split_tree_descend")
    old = descent_times(lambda: split_tree.descend_batch_bisect(Td, packed),
                        "split_tree_bisect")
    return {**new, **{f"bisection_{k}": v for k, v in old.items()}}


def descent_check(tag: str, tree, T, dev, want=None):
    """The descent kernel on the rows ``T`` (numpy, (m, k)) against its
    plain version and its packed mirror on the card and the host descent,
    and against ``want`` (the rows' own group ids) where given; exact.
    Prints a line "kernel split_tree_descent[tag]" with the staging the
    wrapper chose and the replaced kernel's time; returns (mismatches,
    numbers)."""
    import torch
    from repro_torch.kernels import split_tree
    packed = tree.device_packed(dev)
    Td = torch.as_tensor(np.ascontiguousarray(T, np.float64), device=dev)
    before = split_tree.launches
    got = split_tree.descend_batch(Td, packed)
    torch.cuda.synchronize()
    check(split_tree.launches == before + 1,
          f"split_tree_descent[{tag}]: {split_tree.launches - before} "
          "launches for one call")
    plain = split_tree.descend_batch_plain(Td, *packed.arrays, packed.root)
    mirror = split_tree.descend_batch_packed_plain(Td, packed)
    t0 = time.perf_counter()
    host = tree.descend_batch(T)
    host_s = time.perf_counter() - t0
    got_np = got.cpu().numpy()
    bad = int((got != plain).sum()) + int((got != mirror).sum()) \
        + int((got_np != host).sum())
    if want is not None:
        bad += int((got_np != want).sum())
    check(bad == 0, f"split_tree_descent[{tag}]: {bad} leaves differ from "
          "the plain version, the packed mirror, the host descent or the "
          "rows' own groups")
    times = descent_vs_bisection(Td, packed, plain)
    plain_ms = timed_ms(lambda: split_tree.descend_batch_plain(
        Td, *packed.arrays, packed.root), 1, warm=0)
    m, k = Td.shape
    p = packed.staged
    nums = _numbers(f"{m}x{k}", m * k * 8 + m * 8,
                    descent_compares(tree, Td), times.pop("ms"), plain_ms,
                    **times, staging=p.staging, staged_bytes=p.smem,
                    nodes=tree.num_nodes,
                    bounds=len(tree.bounds), fences=packed.fences.numel(),
                    lines=packed.lines.shape[0], depth=packed.depth,
                    host_descend_s=host_s)
    say(f"kernel split_tree_descent[{tag}]", mismatches=bad,
        vs_gid=want is not None, **nums)
    return bad, nums


def tie_probes(tree, X, n: int, rng):
    """``n`` rows whose value at a node is one of the node's bounds: each
    row picks a bound at random, takes the route to its node (at each
    ancestor the bound below the child it enters: a tie there too, unless
    a deeper node on the route splits the same attribute) and then holds
    that bound in the node's attribute; other attributes from rows of
    ``X``."""
    N = tree.num_nodes
    off = tree.bound_off
    starts = off[:-1] + np.arange(N)                # each node's first child
    at = np.flatnonzero(tree.children >= 0)
    kid = tree.children[at]
    parent = np.full(N, -1)
    pos = np.zeros(N, np.int64)
    parent[kid] = np.searchsorted(starts, at, side="right") - 1
    pos[kid] = at - starts[parent[kid]]
    pick = rng.integers(0, len(tree.bounds), n)
    node = np.searchsorted(off, pick, side="right") - 1
    rows = X[rng.integers(0, len(X), n)].copy()
    route, cur = [], node
    while (parent[cur] >= 0).any():
        up = parent[cur] >= 0
        route.append((np.where(up, parent[cur], 0), pos[cur], up))
        cur = np.where(up, parent[cur], cur)
    for par, p, up in reversed(route):
        has = up & (off[par + 1] > off[par])
        b = tree.bounds[np.where(has, off[par] + np.maximum(p - 1, 0), 0)]
        v = np.where(p > 0, b, b - 1.0)
        rows[np.flatnonzero(has), tree.attr[par][has]] = v[has]
    rows[np.arange(n), tree.attr[node]] = tree.bounds[pick]
    return rows


def kernel_split_tree(eng, dev):
    """The descent kernel at fixed cases: the full cell's 10M layer-0 rows
    down layer 1's tree (equal to ``part.gid``), 100,000 rows whose values
    are the layer-1 tree's bounds (ties), layer 2's tree over its reps, a
    KD-tree and a bucketing partition of a 1M-row slice, the bound-less
    merged single-bucket tree, a single leaf, and 100,000 probes outside
    every box plus NaN rows.  Returns (max mismatches, numbers of the 10M
    case)."""
    from repro_torch.core import partitioner
    hier = eng.hierarchy
    X0 = hier.layers[0].X
    part1 = hier.layers[1].part
    bad, big = descent_check("full layer 1, 10M", part1.tree, X0, dev,
                             want=part1.gid)
    errs = [bad]
    rng = np.random.default_rng(5)
    errs.append(descent_check("ties on layer 1's bounds", part1.tree,
                              tie_probes(part1.tree, X0, 100_000, rng),
                              dev)[0])
    for l in range(2, hier.L + 1):
        part = hier.layers[l].part
        errs.append(descent_check(f"full layer {l}", part.tree,
                                  hier.layers[l - 1].X, dev,
                                  want=part.gid)[0])
    X1 = X0[:1_000_000]
    t0 = time.perf_counter()
    kd = partitioner.fit(X1, backend="kdtree", d_f=100, device=dev)
    kd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bk = partitioner.fit(X1, backend="bucketing", d_f=100,
                         memory_rows=250_000, device=dev)
    bk_s = time.perf_counter() - t0
    say("split_tree_descent 1M fits", kdtree_s=kd_s, kdtree_groups=
        kd.num_groups, bucketing_s=bk_s, bucketing_groups=bk.num_groups)
    errs.append(descent_check("kdtree 1M", kd.tree, X1, dev,
                              want=kd.gid)[0])
    errs.append(descent_check("bucketing 1M", bk.tree, X1, dev,
                              want=bk.gid)[0])
    flat = np.full((3000, 2), 5.0)
    merged = partitioner.fit(flat, backend="bucketing", device=dev)
    check(bool(np.any(np.diff(merged.tree.bound_off) == 0)),
          "split_tree_descent: the merged single-bucket tree has no "
          "bound-less node")
    errs.append(descent_check("merged single bucket", merged.tree, flat,
                              dev, want=merged.gid)[0])
    errs.append(descent_check("single leaf", partitioner.SplitTree
                              .single_leaf(), X1[:100_000], dev,
                              want=np.zeros(100_000, np.int64))[0])
    span = X0.max(0) - X0.min(0) + 1.0
    k = X0.shape[1]
    probes = np.concatenate([
        X0.min(0) - span * rng.uniform(1, 10, (50_000, k)),
        X0.max(0) + span * rng.uniform(1, 10, (50_000, k))])
    nan = X0[rng.choice(len(X0), 10_000)].copy()
    nan[np.arange(10_000), rng.integers(0, k, 10_000)] = np.nan
    nan[:100] = np.nan
    errs.append(descent_check("outside every box + NaN", part1.tree,
                              np.concatenate([probes, nan]), dev)[0])
    return float(max(errs)), big


def phase_cache(eng, table, device):
    """The cross-query cache on the full cell (the reference benchmark's
    flight, benchmarks/cache_bench.py) through the device LP, every answer
    equal to an uncached session's with the same seed (an accepted
    contained prune's to a CPU session's on the same entries); then an
    append of the h=2 package's first 7 rows and 100,000 fresh rows
    through the descent kernel, its ancestry invalidation, the stale miss
    and the re-populated hit.  Returns (launches of the append, mismatches,
    numbers of the append's descent, launches on the flight's solves)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.hardness import (Q2_TPCH, Q4_TPCH, column_stats,
                                           instantiate)
    from repro_torch.core.qcache import QCache
    from repro_torch.data.synth_tables import make_table
    from repro_torch.kernels import split_tree
    stats = column_stats(table, ATTRS)
    q = {name: instantiate(Q2_TPCH, stats, h)
         for name, h in CACHE_FLIGHT.items()}
    q["disjoint"] = instantiate(Q4_TPCH, stats, 2.0)
    check(q["tight"].signature().contained_in(q["prime"].signature())
          and not q["wide"].signature().contained_in(q["prime"].signature()),
          "cache: the flight's signatures do not nest as the reference's")
    hier = eng.hierarchy
    uncached = {}

    def cold(name):
        """An uncached session's answer to ``name`` (seed 0), once."""
        if name not in uncached:
            uncached[name] = solve(eng.session(0), q[name])
        return uncached[name]

    def cached(cache, name, want):
        """A session with ``cache`` (seed 0) solves ``name``: its kind must
        be in ``want`` and its answer the uncached session's.  An accepted
        contained prune may answer otherwise (the cache's contract keeps
        the answer's class, not its package): it must then be a valid
        package within ``gap_accept`` of its own bound, no better a bound
        than the cached query's, and the answer of the same hit served by
        a CPU session from the same entries."""
        s = eng.session(0)
        s.cache = cache
        res, sec = solve(s, q[name])
        ref, ref_s = cold(name)
        kind = res.ps_stats.cache or ("fallback" if "cache_fallback"
                                      in res.report.fallbacks else "miss")
        same = res.feasible == ref.feasible and same_package(res, ref) \
            and res.obj == ref.obj
        extra = {}
        if kind == "contained" and not same:
            twin = QCache(gap_accept=cache.gap_accept)
            twin._entries.update(cache._entries)
            s = eng.session(0)
            s.cache, s.device = twin, torch.device("cpu")
            cpu = solve(s, q[name])[0]
            prime_bound = cold("prime")[0].lp_obj
            extra = dict(cpu_kind=cpu.ps_stats.cache, cpu_obj=cpu.obj,
                         same_as_cpu=same_package(cpu, res),
                         prime_lp_obj=prime_bound, lp_obj=res.lp_obj)
            check(cpu.ps_stats.cache == "contained"
                  and same_package(cpu, res)
                  and abs(cpu.obj - res.obj) <= 1e-12 * max(1.0, abs(
                      res.obj)),
                  f"cache {name}: the contained answer differs from a CPU "
                  "session's on the same entries")
            check(q[name].check_package(table, res.idx, res.mult),
                  f"cache {name}: the contained package fails "
                  "check_package")
            check(res.lp_obj <= prime_bound + 1e-6 * max(1.0, abs(
                prime_bound)), f"cache {name}: the contained bound beats "
                  "the cached query's")
        say(f"cache {name}", kind=kind, wall_s=sec, uncached_s=ref_s,
            feasible=res.feasible, obj=res.obj, uncached_obj=ref.obj,
            same_as_uncached=same, **extra,
            cache_hits=res.report.cache_hits,
            cache_misses=res.report.cache_misses,
            cache_pruned_lps=res.report.cache_pruned_lps,
            fallbacks=json.dumps(res.report.fallbacks),
            status=json.dumps(res.status))
        check(kind in want, f"cache {name}: {kind}, expected one of {want}")
        check(same or kind == "contained", f"cache {name}: the answer "
              "differs from an uncached session's")
        return res, sec

    kernels.reset_launches()
    cache = QCache()
    cached(cache, "prime", ("miss",))
    cached(cache, "prime", ("package",))
    cached(cache, "tight", ("contained", "fallback"))
    cached(cache, "wide", ("miss",))
    cached(cache, "disjoint", ("miss",))
    art = QCache(reuse_packages=False)
    cached(art, "prime", ("miss",))
    cached(art, "prime", ("exact",))
    flight_launches = kernels.launch_counts()["split_tree_descent"]
    say("cache stats", **cache.stats_snapshot().as_dict(),
        hit_rate=cache.stats.hit_rate(), entries=len(cache),
        artifact_only=json.dumps(art.stats_snapshot().as_dict()),
        descent_launches_on_the_flight=flight_launches)

    # ---- the append: the h=2 package's first 7 rows and fresh rows
    prime = cold("prime")[0]
    fresh = make_table("tpch", APPEND_FRESH, seed=2)
    # repro: allow[REPRO005] the cell's table is an in-memory dict: a
    # gather of seven rows and the fresh rows, not a streamed column load
    rows = {a: np.concatenate([np.asarray(table[a][prime.idx[:7]],
                                          np.float64),
                               np.asarray(fresh[a], np.float64)])
            for a in ATTRS}
    R = np.stack([rows[a] for a in ATTRS], axis=1)
    entries = [e for fp, _, e in cache.entries() if fp == hier.fingerprint]
    before = [{l: set(e.group_ids(l)) for l in range(1, hier.L + 1)}
              for e in entries]
    t0 = time.perf_counter()
    if hier._append_state is None:
        hier._append_state = hier._init_append_state()
    init_s = time.perf_counter() - t0
    stats0 = cache.stats_snapshot()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rep = hier.append(rows)
    append_s = time.perf_counter() - t0
    launched = kernels.launch_counts()["split_tree_descent"]
    check(launched == 1, f"cache append: {launched} descent launches")
    host = hier.layers[1].part.tree.descend_batch(R)
    bad = int((rep.gids != host).sum())
    check(bad == 0, f"cache append: {bad} gids differ from the host descent")
    touched = np.unique(rep.gids)
    anc = hier.leaf_ancestors(touched)
    check(np.array_equal(anc[1], touched),
          "cache append: leaf_ancestors(touched)[1] != touched")
    removed_total = 0
    for e, b in zip(entries, before):
        for l in range(1, hier.L + 1):
            removed = b[l] - set(e.group_ids(l))
            check(removed == b[l] & set(int(g) for g in anc[l]),
                  f"cache append: layer {l}: the removed groups are not "
                  "the touched ancestry")
            removed_total += len(removed)
    invalidated = cache.stats.invalidated_groups - stats0.invalidated_groups
    check(invalidated == removed_total > 0,
          f"cache append: {invalidated} groups invalidated, "
          f"{removed_total} removed")
    # the append's descent alone, timed on its rows
    tree = hier.layers[1].part.tree
    packed = tree.device_packed(device)
    Rd = torch.as_tensor(R, device=device)
    times = descent_vs_bisection(Rd, packed, torch.as_tensor(
        rep.gids, device=device))
    plain_ms = timed_ms(lambda: split_tree.descend_batch_plain(
        Rd, *packed.arrays, packed.root), 3)
    m, k = R.shape
    p = packed.staged
    nums = _numbers(f"{m}x{k}", m * k * 8 + m * 8,
                    descent_compares(tree, Rd), times.pop("ms"), plain_ms,
                    **times, staging=p.staging, staged_bytes=p.smem,
                    nodes=tree.num_nodes,
                    bounds=len(tree.bounds))
    say("cache append", rows=m, init_append_state_s=init_s,
        append_s=append_s, descent_launches=launched, touched=len(touched),
        flagged=len(rep.flagged), tv_bar=rep.tv_bar,
        invalidated_groups=invalidated,
        entries_invalidated=sum(not e.complete for e in entries),
        ancestors=json.dumps({l: len(a) for l, a in anc.items()}), **nums)
    stale0 = cache.stats.stale_misses
    cached(cache, "prime", ("miss",))
    check(cache.stats.stale_misses == stale0 + 1,
          "cache after append: the next solve is not a stale miss")
    cached(cache, "prime", ("package",))
    say("cache stats after append", **cache.stats_snapshot().as_dict())
    return launched, bad, nums, flight_launches


# --------------------------------- the heap build and the seed scan

# "heap": benchmarks/partitioning.py's full profile (n = 1,000,000, d_f =
# 100) on the 4 tpch attributes, built by dlv(method="heap") with each
# pop's scan on the card; "heap seed": the same build through the seed's
# scan (dlv_heap(scan="seed")), the benchmark's baseline
HEAP = dict(rows=1_000_000, d_f=100, seed=0)
HEAP_SAMPLE = 100_000        # rows descended on the card against gid
SEED_FIXED_ROWS = 1_000_000  # "kernel dlv_scan_seed": the fixed span


def heap_table(rows: int) -> np.ndarray:
    from repro_torch.data.synth_tables import make_table
    t = make_table("tpch", rows, seed=HEAP["seed"])
    return np.stack([np.asarray(t[a], np.float64) for a in ATTRS], axis=1)


@contextlib.contextmanager
def counting_pops():
    """Count the heap pops of ``dlv_heap`` made inside the block
    ({"pops": n})."""
    import heapq
    from repro_torch.core import dlv
    n = {"pops": 0}

    def heappop(h):
        n["pops"] += 1
        return heapq.heappop(h)

    saved = dlv.heapq
    dlv.heapq = types.SimpleNamespace(heappush=heapq.heappush,
                                      heappop=heappop)
    try:
        yield n
    finally:
        dlv.heapq = saved


def heap_build(X, device, names, **kw):
    """``dlv(X, d_f, method="heap")`` once, its launches counted (reset just
    before, read just after), its pops counted and the arguments of every
    call of the kernels ``names`` kept: (partition, wall s, pops, launch
    counts, kept calls)."""
    from repro_torch import kernels
    from repro_torch.core.dlv import dlv
    kernels.reset_launches()
    with capturing(names) as calls, counting_pops() as pops:
        t0 = time.perf_counter()
        part = dlv(X, HEAP["d_f"], method="heap", device=device, **kw)
        _sync(device)
        wall = time.perf_counter() - t0
    return part, wall, pops["pops"], kernels.launch_counts(), calls


def ratio_scores(X, gid) -> list:
    from repro_torch.core.dlv import ratio_score
    return [ratio_score(X[:, j], gid, weighted=True)
            for j in range(X.shape[1])]


def phase_heap(X, device="cuda"):
    """The heap-built DLV on the card: the build with its launches, pops
    and scan calls; every scan call held to ``dlv_scan_plain`` (bit-equal;
    the largest also to the row-step scan); the descent on the card
    against gid; a second build under the profiler (device busy time,
    idle share); ``dlv_rounds`` at the same size and seed against the
    heap build's quality bar (``tests/test_partitioner.py``'s
    ``test_rounds_match_heap_quality``).  Returns (the scan's launches,
    its numbers at the largest call)."""
    import torch
    from repro_torch.core.dlv import dlv, dlv_rounds
    n, d_f = len(X), HEAP["d_f"]
    part, wall, pops, counts, calls = heap_build(X, device, ("dlv_scan",))
    check(counts["dlv_scan"] > 0, "heap: the DLV scan was never launched")
    G = part.num_groups
    sizes = [len(a[0]) for a, _ in calls["dlv_scan"]]
    big = int(np.argmax(sizes))
    held = hold_calls(calls, "heap ", row_step={big}, plain_host=True)
    sample = np.random.default_rng(0).choice(n, min(HEAP_SAMPLE, n),
                                             replace=False)
    got = part.get_group_batch(X[sample], jit=True, device=device)
    check(np.array_equal(got, part.gid[sample]),
          f"heap: the descent on the card disagrees with gid on "
          f"{int((got != part.gid[sample]).sum())} of {len(sample)} rows")
    busy_ms = device_profile(
        lambda: dlv(X, d_f, method="heap", device=device))[0]
    t0 = time.perf_counter()
    rounds = dlv_rounds(X, d_f, device=device)
    _sync(device)
    rounds_s = time.perf_counter() - t0
    rounds_busy_ms = device_profile(
        lambda: dlv_rounds(X, d_f, device=device))[0]
    z_h, z_r = ratio_scores(X, part.gid), ratio_scores(X, rounds.gid)
    say("heap", rows=n, d_f=d_f, wall_s=wall, pops=pops,
        splits=part.tree.num_nodes, groups=G,
        scan_launches=counts["dlv_scan"],
        descent_rows_checked=len(sample), device_busy_s=busy_ms / 1e3,
        idle_share=1.0 - busy_ms / 1e3 / wall, ratio_scores=json.dumps(z_h))
    say("heap rounds", rows=n, wall_s=rounds_s, groups=rounds.num_groups,
        device_busy_s=rounds_busy_ms / 1e3,
        idle_share=1.0 - rounds_busy_ms / 1e3 / rounds_s,
        ratio_scores=json.dumps(z_r),
        heap_over_rounds_wall=wall / rounds_s)
    check(abs(rounds.num_groups - G) <= max(10, G // 3),
          f"heap: dlv_rounds gives {rounds.num_groups} groups, the heap "
          f"build {G}")
    for j, (zh, zr) in enumerate(zip(z_h, z_r)):
        check(zr <= zh * 1.25 + 5e-3,
              f"heap: dlv_rounds' ratio score {zr} on {ATTRS[j]} above "
              f"1.25 x the heap build's {zh} + 5e-3")
    del calls
    torch.cuda.empty_cache()
    return counts["dlv_scan"], held["dlv_scan"]


def seed_numbers(vals, beta, plain_ms: float) -> dict:
    """The seed scan on one span: CUDA events over 3 calls, the profiler's
    device ms a call (its four kernels summed; ``kernel_ms``: each
    kernel's mean ms, records and median ms), the plain version's ms, the
    bound (8 B read and 1 B written a row, over the card's memory rate),
    the counters of one call, and the replaced kernel (``serial=True``)
    timed the same way right after."""
    from repro_torch.kernels import dlv_scan as kdlv
    n = len(vals)
    _, st = kdlv.dlv_scan_seed(vals, beta, stats=True)
    counters = dict(zip(kdlv.SEED_STAT_NAMES, st.tolist()))
    ms = timed_ms(lambda: kdlv.dlv_scan_seed(vals, beta), 3)
    dev = per_call_device(lambda: kdlv.dlv_scan_seed(vals, beta), 3, kdlv,
                          kdlv.SEED_KERNELS, counter="seed_launches",
                          kernels_per_call=len(kdlv.SEED_KERNELS))
    serial_ms = timed_ms(
        lambda: kdlv.dlv_scan_seed(vals, beta, serial=True), 3)
    sdev = per_call_device(
        lambda: kdlv.dlv_scan_seed(vals, beta, serial=True), 3, kdlv,
        "dlv_scan_seed_serial", counter="seed_serial_launches")
    return _numbers(f"{n} rows", 9 * n, 8 * n, ms, plain_ms, **dev,
                    serial_ms=serial_ms, serial_device_ms=sdev["device_ms"],
                    serial_profiled_launches=sdev["profiled_launches"],
                    serial_over_new=serial_ms / ms,
                    serial_row_share=counters["serial_rows"] / n,
                    **counters)


def seed_hold(vals, beta, mirror: bool = False) -> float:
    """The seed kernel and the replaced serial kernel against
    ``dlv_scan_seed_plain`` (on a host copy) on one span: bit-equal cuts,
    or the run fails; with ``mirror``, the kernel's counters (all but the
    cycles) also equal to ``seed_scan_certified_plain``'s.  Returns the
    plain ms."""
    import torch
    from repro_torch.kernels import dlv_scan as kdlv
    got, st = kdlv.dlv_scan_seed(vals, beta, stats=True)
    got = got.cpu()
    serial = kdlv.dlv_scan_seed(vals, beta, serial=True).cpu()
    t0 = time.perf_counter()
    want = kdlv.dlv_scan_seed_plain(vals.cpu(), beta)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(got, want),
          f"dlv_scan_seed cuts differ from dlv_scan_seed_plain in "
          f"{int((got != want).sum())} of {len(vals)} rows")
    check(torch.equal(serial, want),
          f"dlv_scan_seed_serial cuts differ from dlv_scan_seed_plain in "
          f"{int((serial != want).sum())} of {len(vals)} rows")
    if mirror:
        count = {}
        cuts = kdlv.seed_scan_certified_plain(vals.cpu(), beta, stats=count)
        mine = dict(zip(kdlv.SEED_STAT_NAMES, st.tolist()))
        names = [k for k in kdlv.SEED_STAT_NAMES if not k.endswith("cycles")]
        check(torch.equal(cuts, want) and all(mine[k] == count[k]
                                              for k in names),
              f"dlv_scan_seed counters {mine} differ from "
              f"seed_scan_certified_plain's {count}")
    return plain_ms


def seed_device_ms(calls, serial: bool) -> dict:
    """The kept calls of a build replayed: by CUDA events around the whole
    replay (``replay_ms``: device time and the gaps between launches),
    and the profiler's sum of the seed kernels' device ms over the replay
    (``per_call_device``: None unless it recorded every kernel)."""
    from repro_torch.kernels import dlv_scan as kdlv

    def replay():
        return [kdlv.dlv_scan_seed(*a, serial=serial) for a, _ in calls]

    dev = per_call_device(
        replay, 1, kdlv,
        "dlv_scan_seed_serial" if serial else kdlv.SEED_KERNELS,
        counter="seed_serial_launches" if serial else "seed_launches",
        kernels_per_call=1 if serial else len(kdlv.SEED_KERNELS))
    return {"replay_ms": timed_ms(replay, 1), "device_ms": dev["device_ms"],
            "profiled_kernels": dev["profiled_launches"]}


def phase_heap_seed(X, device="cuda"):
    """The heap build through the seed's scan on the card: every seed-scan
    call held to its plain version (bit-equal, the replaced serial kernel
    too), the build's summed seed-kernel device ms, and its wall (without
    the capture) with the certified kernels and with the replaced one in
    turns (new, serial, serial, new), then both timed on the
    first (largest) span and on a fixed 1M-row span.  Returns (its
    launches, its main-path numbers, its fixed-span numbers)."""
    import functools

    import torch
    from repro_torch.core import dlv as core_dlv
    from repro_torch.core.dlv import dlv
    from repro_torch.kernels import dlv_scan as kdlv
    part, wall, pops, counts, calls = heap_build(
        X, device, ("dlv_scan_seed",), scan="seed")
    kept = calls["dlv_scan_seed"]
    launched = counts["dlv_scan_seed"]
    check(launched > 0 and launched == len(kept),
          f"heap seed: {launched} seed-scan launches for {len(kept)} calls")
    t0 = time.perf_counter()
    plain = [seed_hold(*a, mirror=i == 0) for i, (a, _) in enumerate(kept)]
    rows = sum(len(a[0]) for a, _ in kept)
    check_s = time.perf_counter() - t0
    # the build's wall without the capture: the certified kernels and the
    # replaced one in turns (new, serial, serial, new)
    walls = {False: [], True: []}
    try:
        for serial in (False, True, True, False):
            core_dlv.dlv_scan_seed = functools.partial(kdlv.dlv_scan_seed,
                                                       serial=serial)
            t0 = time.perf_counter()
            again = dlv(X, HEAP["d_f"], method="heap", device=device,
                        scan="seed")
            _sync(device)
            walls[serial].append(time.perf_counter() - t0)
            check(np.array_equal(again.gid, part.gid),
                  f"heap seed: a build (serial={serial}) gives other groups")
    finally:
        core_dlv.dlv_scan_seed = kdlv.dlv_scan_seed
    dev = seed_device_ms(kept, serial=False)
    sdev = seed_device_ms(kept, serial=True)
    say("heap seed", rows=len(X), d_f=HEAP["d_f"], wall_s=wall, pops=pops,
        splits=part.tree.num_nodes, groups=part.num_groups,
        seed_scan_launches=launched, dlv_scan_launches=counts["dlv_scan"],
        held=f"all {len(kept)} calls ({rows} rows), bit-equal, the serial "
             f"kernel too",
        check_s=check_s, seed_replay_ms=dev["replay_ms"],
        seed_device_ms=dev["device_ms"],
        profiled_kernels=dev["profiled_kernels"],
        walls_s=json.dumps(walls[False]),
        serial_walls_s=json.dumps(walls[True]),
        serial_seed_replay_ms=sdev["replay_ms"],
        serial_seed_device_ms=sdev["device_ms"],
        serial_profiled_kernels=sdev["profiled_kernels"],
        ratio_scores=json.dumps(ratio_scores(X, part.gid)))
    (v0, b0), _ = kept[0]
    main = seed_numbers(v0, b0, plain[0])
    rng = np.random.default_rng(5)
    v = np.sort(rng.normal(0.0, 2.0, SEED_FIXED_ROWS))
    v = v - v.mean()
    vals = torch.as_tensor(v, device=device)
    beta = 13.5 * float(v.var()) / HEAP["d_f"] ** 2
    fixed = seed_numbers(vals, beta, seed_hold(vals, beta, mirror=True))
    for tag, nums in (("first span", main), ("1M fixed", fixed)):
        say(f"kernel dlv_scan_seed[{tag}]", max_abs_err=0.0,
            cuts_bit_equal=True, launches=launched, **nums)
    del calls, kept
    torch.cuda.empty_cache()
    return launched, main, fixed


# "faults": the 10M-row tpch table on disk as a MemmapRelation (the
# streamed engine's build, bucketing within memory_rows), Q2_TPCH h=3
# clean and under each arm of tests/test_resilience.py's
# test_engine_never_raises_under_faults (injector seed 3)
FAULTS = dict(rows=10_000_000, memory_rows=2_500_000, chunk_rows=1_048_576,
              d_f=100, alpha=100_000, seed=0)
FAULT_ARMS = (("CHUNK_READ", dict(times=2)),
              ("GATHER_READ", dict(times=None, prob=0.3)),
              ("BINV", dict(times=3, after=1, scale=1e-3)),
              ("SHARD", dict(times=1)))


def phase_faults(device="cuda"):
    """Faults injected into the streamed engine on the card: each arm's
    report status, fault retries, fires per site and walls; the status
    defined, a feasible package valid, the read faults' packages equal to
    the clean solve's (under ``CHUNK_READ`` the build runs under the arm
    too, since the solve reads no chunk), ``SHARD`` never fired (it is
    polled by the distributed pivot loop only: phase "dist")."""
    from repro_torch.core import guard, relation
    from repro_torch.core.relation import MemmapRelation
    from repro_torch.runtime import faults
    cfg = FAULTS
    STREAMED_DIR.mkdir(parents=True, exist_ok=True)
    path = STREAMED_DIR / "faults.npy"
    gen_s = write_streamed(path, cfg["rows"], cfg["chunk_rows"], cfg["seed"])
    rel = MemmapRelation.from_npy(str(path), ATTRS,
                                  chunk_rows=cfg["chunk_rows"])
    q3, _ = streamed_queries(rel, cfg["chunk_rows"])
    sites = {name: getattr(faults, name) for name, _ in FAULT_ARMS}

    def build():
        eng = streamed_engine(rel, device, cfg)
        t0 = time.perf_counter()
        eng.partition()
        _sync(device)
        return eng, time.perf_counter() - t0

    eng, part_s = build()
    clean, clean_s = solve(eng, q3)
    check(bool(clean.feasible and q3.check_package(rel, clean.idx,
                                                   clean.mult)),
          "faults: the clean h=3 solve is not a feasible, valid package")
    say("faults clean", rows=cfg["rows"], table_gen_s=gen_s,
        partition_s=part_s, solve_s=clean_s, status=clean.report.status,
        obj=clean.obj, package_size=int(clean.mult.sum()))
    for name, arm in FAULT_ARMS:
        site = sites[name]
        io0 = relation.io_retry_count()
        with faults.injected(seed=3, arms={site: arm}) as inj:
            e, build_s = build() if site == faults.CHUNK_READ \
                else (eng, None)
            r, s = solve(e, q3)
        fired = {k: inj.fire_count(v) for k, v in sites.items()}
        same = bool(r.feasible == clean.feasible
                    and np.array_equal(r.idx, clean.idx)
                    and np.array_equal(r.mult, clean.mult))
        say(f"faults {name}", arm=json.dumps(arm), status=r.report.status,
            fault_retries=r.report.fault_retries,
            io_retries=relation.io_retry_count() - io0,
            fire_count=json.dumps(fired), partition_s=build_s, solve_s=s,
            feasible=r.feasible, obj=r.obj,
            obj_rel_diff=abs(r.obj - clean.obj) / max(1.0, abs(clean.obj)),
            same_package_as_clean=same)
        check(r.report.status in guard.STATUSES,
              f"faults {name}: status {r.report.status} is not defined")
        if r.feasible:
            check(q3.check_package(rel, r.idx, r.mult),
                  f"faults {name}: the package fails check_package")
        if site in (faults.CHUNK_READ, faults.GATHER_READ):
            check(fired[name] > 0, f"faults {name}: the arm never fired")
            check(same, f"faults {name}: a retried read changed the "
                        "package")
        if site == faults.SHARD:
            check(fired[name] == 0, "faults SHARD fired: these solves run "
                                    "no distributed pivot loop")
    del eng, rel
    path.unlink()


# ------------------------------------------- the streamed (out-of-core) path

# "streamed": a TPC-H stand-in on disk, partitioned through the bucketing
# backend (Appendix D.2) within ``memory_rows`` and solved through the
# device LP; the rows are made chunk by chunk, chunk i from seed SEED + i
STREAMED = dict(rows=50_000_000, memory_rows=12_500_000,
                chunk_rows=4_194_304, d_f=100, alpha=100_000, seed=0)
STREAMED_DIR = ROOT / "build" / "streamed"
# "streamed parity": dict vs memmap vs CPU builds at the same budget
PARITY_STREAMED = dict(rows=2_000_000, memory_rows=500_000,
                       chunk_rows=262_144, d_f=100, alpha=20_000)
SR_ROWS = 1_000_000      # "sketchrefine": each refine step is a host ILP
BUCKET_WALLS = ("stats_s", "edges_s", "spill_s", "bucket_read_s",
                "bucket_dlv_s", "merge_s")


def free_gb(path) -> float:
    return shutil.disk_usage(path).free / 1e9


def write_streamed(path: Path, rows: int, chunk: int, seed: int) -> float:
    """``ATTRS`` as float64 rows, made by ``synth_tables`` chunk by chunk
    (chunk i from ``seed + i``), into the ``.npy`` at ``path``; seconds."""
    from repro_torch.data.synth_tables import make_table
    t0 = time.perf_counter()
    X = np.lib.format.open_memmap(str(path), mode="w+", dtype=np.float64,
                                  shape=(rows, len(ATTRS)))
    for i, a in enumerate(range(0, rows, chunk)):
        b = min(a + chunk, rows)
        t = make_table("tpch", b - a, seed=seed + i)
        X[a:b] = np.stack([t[c] for c in ATTRS], axis=1)
    X.flush()
    del X
    return time.perf_counter() - t0


def streamed_queries(rel, chunk_rows):
    """Q2_TPCH at h=3 and h=5 from one streaming pass's column stats."""
    from repro_torch.core.bucketing import streaming_stats
    from repro_torch.core.hardness import Q2_TPCH, instantiate
    st = streaming_stats(rel.chunk_source(ATTRS), chunk_rows)
    stats = {a: (float(st.mean[j]), float(np.sqrt(st.var[j])))
             for j, a in enumerate(ATTRS)}
    return instantiate(Q2_TPCH, stats, 3), instantiate(Q2_TPCH, stats, 5)


@contextlib.contextmanager
def bucket_walls():
    """Seconds of the bucketed build's parts, summed over the block: the
    stats pass, the edge (counting) passes, the spill pass, the bucket
    reads from the scratch, each bucket's DLV (to the card's last op) and
    the merge; ``buckets`` lists each built bucket's rows."""
    from repro_torch.core import bucketing
    walls = dict.fromkeys(BUCKET_WALLS, 0.0)
    walls["buckets"] = []
    sites = ((bucketing, "streaming_stats", "stats_s"),
             (bucketing, "_bucket_edges", "edges_s"),
             (bucketing, "_spill_pass", "spill_s"),
             (bucketing.BucketSpill, "bucket", "bucket_read_s"),
             (bucketing, "dlv", "bucket_dlv_s"),
             (bucketing, "_merge_buckets", "merge_s"))
    saved = []
    for owner, attr, key in sites:
        fn = getattr(owner, attr)

        def timed(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            if _key == "bucket_dlv_s":
                _sync(kw["device"])
                walls["buckets"].append(len(a[0]))
            walls[_key] += time.perf_counter() - t0
            return out

        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)
    try:
        yield walls
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def streamed_engine(rel, device, cfg=STREAMED):
    from repro_torch.core.engine import PackageQueryEngine
    return PackageQueryEngine(rel, ATTRS, d_f=cfg["d_f"], alpha=cfg["alpha"],
                              seed=0, memory_rows=cfg["memory_rows"],
                              chunk_rows=cfg["chunk_rows"], device=device)


def streamed_path(rel, q3, q5, device, build=None):
    """The streamed main path: partition the memmap (through ``build(fn)``
    where given, e.g. under the profiler), then Q2_TPCH at h=3 and h=5
    through the device LP.  Returns (engine, partition s, the build's
    peak resident rows, r3, h=3 s, r5, h=5 s, the solves' peak)."""
    from repro_torch.core import guard, relation
    eng = streamed_engine(rel, device)
    wall = {}

    def partition():
        t0 = time.perf_counter()
        eng.partition()
        _sync(device)
        wall["s"] = time.perf_counter() - t0

    relation.reset_peak_resident()
    partition() if build is None else build(partition)
    build_peak = relation.peak_resident_rows()
    relation.reset_peak_resident()
    r3, s3 = solve(eng, q3)
    r5, s5 = solve(eng, q5, budget=guard.SolveBudget(deadline_s=300.0))
    return eng, wall["s"], build_peak, r3, s3, r5, s5, \
        relation.peak_resident_rows()


def h2d_copies(prof) -> dict:
    """Host-to-device copies in a profile: bytes (from the trace's memcpy
    events), count and device ms; "not measured" where the trace gives no
    bytes."""
    trace = STREAMED_DIR / "profile_trace.json"
    te = time.perf_counter()
    prof.export_chrome_trace(str(trace))
    try:
        events = json.loads(trace.read_text()).get("traceEvents", [])
    finally:
        trace.unlink(missing_ok=True)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    nbytes = [e.get("args", {}).get("bytes") for e in copies]
    return {"trace_export_s": time.perf_counter() - te,
            "h2d_copies": len(copies),
            "h2d_bytes": sum(nbytes) if copies and None not in nbytes
            else "not measured",
            "h2d_device_ms": sum(e.get("dur", 0.0) for e in copies) / 1e3}


@contextlib.contextmanager
def bucket_boundaries(calls):
    """The index in ``calls["dlv_scan"]`` of each bucket's first scan call
    (a list filled inside the block)."""
    from repro_torch.core import bucketing
    first = []
    kept = bucketing.dlv

    def per_bucket(*a, **kw):
        first.append(len(calls["dlv_scan"]))
        return kept(*a, **kw)

    bucketing.dlv = per_bucket
    try:
        yield first
    finally:
        bucketing.dlv = kept


def phase_streamed(device="cuda"):
    """The streamed cell: write the table, then build and solve it
    out-of-core once, with every launch counted, every kernel call's
    arguments kept (for phase 7), the build's wall split and the build
    under the profiler; check it.  Returns (launch counts, the kept calls,
    each bucket's first scan call)."""
    from repro_torch import kernels
    from repro_torch.core import guard
    from repro_torch.core.relation import MemmapRelation
    cfg = STREAMED
    rows, chunk = cfg["rows"], cfg["chunk_rows"]
    STREAMED_DIR.mkdir(parents=True, exist_ok=True)
    say("streamed disk", free_gb_build=free_gb(STREAMED_DIR),
        data_gb=rows * len(ATTRS) * 8 / 1e9,
        spill_gb=rows * (len(ATTRS) + 1) * 8 / 1e9)
    path = STREAMED_DIR / "lineitem.npy"
    gen_s = write_streamed(path, rows, chunk, cfg["seed"])
    rel = MemmapRelation.from_npy(str(path), ATTRS, chunk_rows=chunk)
    t0 = time.perf_counter()
    q3, q5 = streamed_queries(rel, chunk)
    query_stats_s = time.perf_counter() - t0

    prof = {}                            # the profiled build's numbers

    def profiled(fn):
        prof.update(zip(("busy_ms", "ops", "reads", "ours", "top"),
                        device_profile(fn, on_prof=lambda p: prof.update(
                            h2d_copies(p)))))

    kernels.reset_launches()
    with capturing() as calls, bucket_boundaries(calls) as first, \
            bucket_walls() as walls:
        eng, part_s, build_peak, r3, s3, r5, s5, solve_peak = \
            streamed_path(rel, q3, q5, device, build=profiled)
    counts = kernels.launch_counts()

    h = eng.hierarchy
    sizes = [ly.size for ly in h.layers]
    buckets = walls.pop("buckets")
    root = h.layers[1].part.tree
    say("streamed build", rows=rows, layers=sizes, table_gen_s=gen_s,
        query_stats_s=query_stats_s, partition_s=part_s,
        buckets=int(root.bound_off[1] - root.bound_off[0]) + 1,
        built_buckets=len(buckets), largest_bucket=max(buckets),
        smallest_bucket=min(buckets), memory_rows=cfg["memory_rows"],
        chunk_rows=chunk, peak_resident_rows_build=build_peak,
        peak_resident_rows_solve=solve_peak,
        upper_layers_s=part_s - sum(walls.values()), **walls)
    for hq, r, s, q in ((3, r3, s3, q3), (5, r5, s5, q5)):
        say(f"streamed h={hq}", solve_s=s, feasible=r.feasible, obj=r.obj,
            lp_obj=r.lp_obj, package_size=int(r.mult.sum())
            if r.feasible else 0, check_package=q.check_package(
                rel, r.idx, r.mult) if r.feasible else None,
            report_status=r.report.status,
            lp_iters=getattr(r.ps_stats, "lp_iters", None),
            status=json.dumps(r.status))
    say("streamed launches", **counts)
    # the build's device time and idle share, and its copies to the card
    say("profile streamed partition", wall_s=part_s,
        device_busy_s=prof["busy_ms"] / 1e3,
        idle_share=1.0 - prof["busy_ms"] / 1e3 / part_s,
        bucket_matrix_bytes=sum(buckets) * len(ATTRS) * 8,
        **{k: prof[k] for k in ("h2d_copies", "h2d_bytes", "h2d_device_ms",
                                "trace_export_s")},
        device_ops=prof["ops"], device_to_host=prof["reads"],
        kernels=json.dumps(prof["ours"]), top=json.dumps(prof["top"]))
    defined = {guard.OK, guard.DEGRADED, guard.INFEASIBLE,
               guard.BUDGET_EXHAUSTED}
    check(bool(r3.feasible and q3.check_package(rel, r3.idx, r3.mult)),
          "streamed: h=3 solve is not a feasible, valid package")
    for hq, r in ((3, r3), (5, r5)):
        check(r.report.status in defined,
              f"streamed: h={hq} report status {r.report.status}")
    # the reference's resident bounds: a build holds a chunk or a bucket
    # at a time, a solve O(alpha) rows (tests/test_outofcore.py)
    check(build_peak <= max(cfg["memory_rows"], chunk),
          f"streamed: the build held {build_peak} rows at once")
    check(solve_peak <= 2 * cfg["alpha"] and solve_peak < rows // 2,
          f"streamed: a solve held {solve_peak} rows at once")
    for name in PQ_KERNELS:
        check(counts[name] > 0, f"streamed: kernel {name} was never "
                                "launched on the streamed path")
    return counts, calls, first


def phase_streamed_inputs(calls, first):
    """Each package-query kernel against its plain version on every call
    that phase 6's path made (every bucket's scans and segment stats, the
    solves' pricing and select).  The scan calls are all held to
    ``dlv_scan_plain``, those of the bucket with the largest call also to
    the row-step scan.  Returns {kernel: max abs error}."""
    import torch
    say("main-path streamed inputs", calls=json.dumps(
        {k: len(v) for k, v in calls.items()}), buckets=len(first))
    for name, got in calls.items():
        check(len(got) > 0, f"streamed path: no call of {name} was kept")
    sizes = [len(a[0]) for a, _ in calls["dlv_scan"]]
    big = int(np.argmax(sizes))
    edges = first + [len(sizes)]
    b = max(i for i in range(len(first)) if edges[i] <= big)
    out = hold_calls(calls, "streamed ",
                     row_step=set(range(edges[b], edges[b + 1])),
                     plain_host=True)
    # the plain scan rounds alike on the host and on the card: hold the
    # two against each other on the largest call
    from repro_torch.kernels.dlv_scan import dlv_scan_plain
    a, kw = calls["dlv_scan"][big]
    same = torch.equal(dlv_scan_plain(*a, **kw).cpu(),
                       dlv_scan_plain(a[0].cpu(), *a[1:], **kw))
    check(same, "streamed: dlv_scan_plain differs between the host and "
                "the card on the largest call")
    say("main-path streamed dlv_scan plain", largest_call_rows=sizes[big],
        host_equals_card=same)
    return {name: err for name, (err, _) in out.items()}


def phase_streamed_parity(device="cuda"):
    """2M rows built with ``layer0_backend="bucketing"`` as a dict table and
    as a ``MemmapRelation`` on the card, and the memmap on the CPU, at one
    ``memory_rows`` / ``chunk_rows``: identical layers and gids, the same
    objective (dict and memmap on the card exactly; the CPU within 1e-6,
    as phase "parity")."""
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.core.relation import MemmapRelation
    from repro_torch.data.synth_tables import make_table
    cfg = PARITY_STREAMED
    table = make_table("tpch", cfg["rows"], seed=0)
    path = STREAMED_DIR / "parity.npy"
    STREAMED_DIR.mkdir(parents=True, exist_ok=True)
    # repro: allow[REPRO005] the parity table is made in memory here and
    # written whole to the memmap under test
    np.save(path, np.stack([table[a] for a in ATTRS], axis=1))
    q = instantiate(Q2_TPCH, column_stats(table, ATTRS), 3)
    kw = dict(d_f=cfg["d_f"], alpha=cfg["alpha"], seed=0,
              memory_rows=cfg["memory_rows"], chunk_rows=cfg["chunk_rows"])
    runs = {}
    for label, src, dev, extra in (
            ("dict cuda", table, device, {"layer0_backend": "bucketing"}),
            ("memmap cuda", MemmapRelation.from_npy(str(path), ATTRS), device,
             {}),
            ("memmap cpu", MemmapRelation.from_npy(str(path), ATTRS), "cpu",
             {})):
        eng = PackageQueryEngine(src, ATTRS, device=dev, **extra, **kw)
        t0 = time.perf_counter()
        eng.partition()
        _sync(dev)
        part_s = time.perf_counter() - t0
        res, solve_s = solve(eng, q)
        runs[label] = (eng.hierarchy, res, part_s, solve_s)
    (hd, rd, _, _), (hm, rm, _, _), (hc, rc, _, _) = runs.values()
    sizes = [ly.size for ly in hm.layers]
    for label, other in (("dict", hd), ("cpu", hc)):
        check([ly.size for ly in other.layers] == sizes,
              f"streamed parity: {label} layer sizes differ")
        for lo, lm in zip(other.layers[1:], hm.layers[1:]):
            for f in ("gid", "order", "offsets", "reps"):
                check(np.array_equal(getattr(lo.part, f),
                                     getattr(lm.part, f)),
                      f"streamed parity: {label} {f} differs from the "
                      "memmap build on the card")
    check(rm.feasible and q.check_package(table, rm.idx, rm.mult),
          "streamed parity: h=3 package infeasible or invalid")
    check(rd.obj == rm.obj and np.array_equal(rd.idx, rm.idx),
          f"streamed parity: dict {rd.obj} vs memmap {rm.obj}")
    rel = abs(rc.obj - rm.obj) / max(1.0, abs(rm.obj))
    check(rel <= 1e-6, f"streamed parity: cpu {rc.obj} vs cuda {rm.obj}")
    say("streamed parity", rows=cfg["rows"], layers=sizes,
        memory_rows=cfg["memory_rows"], chunk_rows=cfg["chunk_rows"],
        buckets=int(hm.layers[1].part.tree.bound_off[1]) + 1,
        gids="identical", obj_dict_cuda=rd.obj, obj_memmap_cuda=rm.obj,
        obj_memmap_cpu=rc.obj, rel_diff_cpu=rel,
        **{f"partition_s_{k.replace(' ', '_')}": v[2]
           for k, v in runs.items()},
        **{f"solve_s_{k.replace(' ', '_')}": v[3] for k, v in runs.items()})
    path.unlink()


def phase_sketchrefine(rows: int = SR_ROWS, device="cuda"):
    """SketchRefine (``kdtree``, and ``dlv`` partitioned on the card) and
    Progressive Shading on one table, Q2_TPCH at h=3: defined statuses,
    every feasible package valid; objectives, walls and refine steps."""
    from repro_torch.core import guard
    from repro_torch.core import ilp as ilp_mod
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.hardness import Q2_TPCH, column_stats, instantiate
    from repro_torch.core.sketchrefine import sketch_refine
    from repro_torch.data.synth_tables import make_table
    table = make_table("tpch", rows, seed=0)
    q = instantiate(Q2_TPCH, column_stats(table, ATTRS), 3)
    ilps = [0]
    kept = ilp_mod.solve_ilp

    def counted(*a, **kw):
        ilps[0] += 1
        return kept(*a, **kw)

    out = {}
    ilp_mod.solve_ilp = counted
    try:
        for backend in ("kdtree", "dlv"):
            ilps[0] = 0
            t0 = time.perf_counter()
            r = sketch_refine(q, table, ATTRS, backend=backend,
                              ilp_kwargs=ILP_KW, device=device)
            _sync(device)
            out[f"sr {backend}"] = (r, time.perf_counter() - t0,
                                    max(ilps[0] - 1, 0))
    finally:
        ilp_mod.solve_ilp = kept
    eng = PackageQueryEngine(table, ATTRS, d_f=100, alpha=100_000, seed=0,
                             device=device)
    t0 = time.perf_counter()
    eng.partition()
    _sync(device)
    part_s = time.perf_counter() - t0
    r, s = solve(eng, q)
    out["ps"] = (r, part_s + s, None)
    defined = {"ok", "sketch_infeasible", "refine_infeasible",
               "refine_package_invalid"}
    for label, (r, wall, steps) in out.items():
        status = r.report.status if label == "ps" else r.status
        check(status in (defined if label != "ps" else
                         {guard.OK, guard.DEGRADED, guard.INFEASIBLE,
                          guard.BUDGET_EXHAUSTED}),
              f"sketchrefine: {label} status {status}")
        if r.feasible:
            check(q.check_package(table, r.idx, r.mult),
                  f"sketchrefine: {label} package fails check_package")
        say(f"sketchrefine {label}", rows=rows, status=json.dumps(status),
            feasible=r.feasible, obj=r.obj, lp_obj=r.lp_obj, wall_s=wall,
            refine_steps=steps, package_size=int(r.mult.sum())
            if r.feasible else 0)
    objs = {k: v[0].obj for k, v in out.items() if v[0].feasible}
    say("sketchrefine compared", ps_partition_s=part_s, ps_solve_s=s,
        ps_beats_sr=json.dumps({k: objs["ps"] > v for k, v in objs.items()
                                if k != "ps"}) if "ps" in objs else None)


# ----------------------------------------------- LM slice: flash kernel


def ptxas_entries(log: str) -> list:
    """One dict per kernel entry of an ``nvcc -Xptxas -v`` log: its name
    (``flash_fwd_tc_kernel<192,128,false>``: q/k and v head_dim, whether
    it takes a prefix), registers, stack frame and spill bytes; and the
    log's warnings under ``warning``."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'_Z\d+(\w+?)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?", line)
        if m:
            flag = {"0": ",false", "1": ",true", None: ""}[m[4]]
            cur = {"kernel": f"{m[1]}<{m[2]},{m[3]}{flag}>"}
            out.append(cur)
        elif "Compiling entry function" in line:
            cur = None            # an entry without a head_dim pair
        elif "warning" in line.lower():
            out.append({"warning": line.strip()})
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m[1])
    return out


def ptxas_report(build) -> None:
    """The flash kernels' registers, spills (ptxas) and dynamic shared
    memory per block, one line each; ptxas warnings verbatim."""
    from repro_torch.kernels import attention
    lib = build.load("flash_attn", attention._SIG)
    entries = ptxas_entries(build.build_log("flash_attn"))
    check(any("kernel" in e for e in entries),
          "ptxas: no report of the flash kernels in the build log")
    for e in entries:
        if "warning" in e:
            say("ptxas flash_attn warning", text=json.dumps(e["warning"]))
            continue
        hd, hdv = map(int, e["kernel"].split("<")[1].split(",")[:2])
        bf16 = e["kernel"].startswith("flash_fwd_tc_kernel")
        say("ptxas flash_attn", **e, dtype="bfloat16" if bf16 else "float32",
            dynamic_smem_bytes=lib.flash_attn_smem_bytes(hd, hdv, int(bf16)))


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int,
                prefix: int = 0) -> int:
    """(query, key) pairs the mask keeps, per batch row and head: every
    pair of a full call, else query i's keys below ``prefix`` and its
    causal keys lo..i (lo = i - window + 1 with a window)."""
    if not causal:
        return Sq * Sk
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros_like(i)
    pf = min(max(prefix, 0), Sk)
    return int((pf + np.maximum(0, i + 1 - np.maximum(lo, pf))).sum())


def flash_agreement(got, want) -> tuple:
    """(max abs error, largest error over its elementwise limit, relative
    norm of the error, whether both bars hold) of a flash output ``got``
    against the plain version's ``want``.

    In bfloat16 both outputs are float32 results rounded once, so a sound
    kernel is at most one bf16 ulp (<= 2^-7 |plain|) away, plus a floor of
    1e-3 rms(plain) for elements near zero; a fixed absolute bar would be
    as large as the outputs of rows that attend thousands of keys.  In
    float32 the bar is the reference's, 2e-3 + 2e-3 |plain|."""
    dt = str(want.dtype).split(".")[-1]
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dt == "bfloat16":
        limit = 2.0 ** -7 * want.abs() + 1e-3 * want.square().mean().sqrt()
    else:
        limit = 2e-3 + 2e-3 * want.abs()
    over = float((diff / limit).max())
    rel = float(diff.norm() / want.norm())
    return (float(diff.max()), over, rel,
            over <= 1.0 and rel <= FLASH_NORM_TOL[dt])


def flash_plain(q, k, v, **kw):
    """``flash_attention_plain`` over groups of KV heads (a head's output
    depends on its own q, k and v alone), each group's float32 score
    block (B, S, heads, PLAIN_CHUNK) within ``PLAIN_BLOCK_BYTES``: an MLA
    call's whole block is 4 GiB at S = 8,192 and 128 heads, and the scan
    holds several such temporaries beside a 51 GiB model."""
    import torch
    from repro_torch.kernels.attention import (PLAIN_CHUNK,
                                               flash_attention_plain)
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    g = H // KV
    step = max(1, PLAIN_BLOCK_BYTES
               // (B * Sq * g * min(k.shape[1], PLAIN_CHUNK) * 4))
    if step >= KV:
        return flash_attention_plain(q, k, v, **kw)
    return torch.cat([flash_attention_plain(
        q[:, :, h * g:(h + step) * g], k[:, :, h:h + step],
        v[:, :, h:h + step], **kw) for h in range(0, KV, step)], dim=2)


def flash_check(q, k, v, *, causal=True, window=0, scale=None,
                prefix=0) -> tuple:
    """Kernel vs plain flash attention on (q, k, v): (max abs error, max
    error over its limit, relative norm error); fails beyond the bars of
    ``flash_agreement`` or on a non-finite output."""
    import torch
    from repro_torch.kernels.ops import flash_attention_op
    got = flash_attention_op(q, k, v, causal=causal, window=window,
                             scale=scale, prefix=prefix)
    want = flash_plain(q, k, v, causal=causal, window=window, scale=scale,
                       prefix=prefix)
    check(bool(torch.isfinite(got).all()), "flash_attention: non-finite "
                                           "output")
    err, over, rel, ok = flash_agreement(got, want)
    check(ok, f"flash_attention disagrees with its plain version at "
              f"{tuple(q.shape)} v {tuple(v.shape)} {q.dtype} "
              f"causal={causal} window={window} prefix={prefix} "
              f"(max abs err {err}, {over} of its limit, "
              f"relative norm {rel})")
    return err, over, rel


def sdpa_call(q, k, v, *, causal, window, scale=None, prefix=0):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same inputs (heads-first views), and the name of the backend that
    runs it.  A window or a prefix needs an explicit mask, and with a mask
    the call is pinned to the memory-efficient backend over K/V expanded
    to every head (expanded outside the timed call): the math backend
    would hold (H, S, S) scores.  So would it for v's head_dim other than
    q's (MLA), where the flash backend refuses: that call may take any
    fused backend, never math."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(is_causal=causal, scale=scale)
    backends = None
    if window > 0 or prefix > 0:
        i = torch.arange(q.shape[1], device=q.device)
        allowed = i[:, None] >= i[None, :]
        if window > 0:
            allowed = allowed & (i[:, None] - i[None, :] < window)
        kw = dict(attn_mask=allowed | (i[None, :] < prefix), scale=scale)
        rep = q.shape[2] // k.shape[2]
        kt, vt = (x.repeat_interleave(rep, dim=1) for x in (kt, vt))
        backends = [SDPBackend.EFFICIENT_ATTENTION]
    else:
        if q.shape[2] != k.shape[2]:
            kw["enable_gqa"] = True
        if q.shape[-1] != v.shape[-1]:
            backends = [getattr(SDPBackend, b) for b in
                        ("FLASH_ATTENTION", "CUDNN_ATTENTION",
                         "EFFICIENT_ATTENTION") if hasattr(SDPBackend, b)]
    pinned = (lambda: sdpa_kernel(backends)) if backends \
        else contextlib.nullcontext

    def call():
        with pinned():
            return F.scaled_dot_product_attention(qt, kt, vt, **kw)

    backend = "unknown"
    try:
        with pinned():
            choice = torch._fused_sdp_choice(qt, kt, vt, **kw)
        backend = {int(v): k for k, v in
                   SDPBackend.__members__.items()}.get(int(choice), backend)
    except (AttributeError, RuntimeError, TypeError):
        pass
    return call, backend


def sdpa_ms(q, k, v, reps: int = 3, **kw):
    """(ms, note): the library call's time and its backend, or None and
    why it failed (the yardstick only: noted, not hidden)."""
    try:
        call, backend = sdpa_call(q, k, v, **kw)
        return timed_ms(call, reps), \
            f"scaled_dot_product_attention ({backend})"
    except RuntimeError as exc:
        return None, f"scaled_dot_product_attention failed: {exc}"[:200]


def flash_times(q, k, v, *, causal=True, window=0, scale=None, prefix=0,
                reps=3, keys=None) -> dict:
    """The kernel's, the plain version's and the library's times on these
    inputs, with the bound of the useful work: ``keys`` (default all of
    Sk) are the keys the caller gave, ahead of the reference's zero keys
    that pad a full call; the padded keys are read and attended, but are
    not counted in the bound's bytes or FLOP."""
    from repro_torch.kernels.ops import flash_attention_op
    B, Sq, H, d = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[3]
    given = Sk if keys is None else keys
    dt = str(q.dtype).split(".")[-1]
    nbytes = (B * Sq * H * (d + dv) + B * given * KV * (d + dv)) \
        * q.element_size()
    # the useful FLOP: 2 (d + dv) a (query, key) pair the mask keeps
    ops = 2 * (d + dv) * flash_pairs(Sq, given, causal, window, prefix) \
        * B * H
    lib, lib_note = sdpa_ms(q, k, v, reps, causal=causal, window=window,
                            scale=scale, prefix=prefix)
    ms = timed_ms(lambda: flash_attention_op(q, k, v, causal=causal,
                                             window=window, scale=scale,
                                             prefix=prefix), reps)
    seq = (f"S={Sq}" if Sq == Sk else f"Sq={Sq} Sk={Sk}") \
        + (f" ({given} given)" if given != Sk else "")
    return _numbers(
        f"B={B} {seq} H={H} KV={KV} d={d} dv={dv} {dt} "
        f"{'causal' if causal else 'full'} window={window}"
        + (f" prefix={prefix}" if prefix else ""),
        nbytes, ops, ms,
        timed_ms(lambda: flash_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, prefix=prefix), 1),
        lib, peak=PEAK_OPS[dt], library=lib_note,
        tflops=ops / ms / 1e9,
        vs_library=ms / lib if lib else None)


FLASH_FIXED = (("32k bf16 causal", (1, 12, 2, 32768, 128, "bfloat16", 0)),
               ("32k bf16 window 4096",
                (1, 12, 2, 32768, 128, "bfloat16", 4096)),
               ("4k f32 d64", (2, 9, 3, 4096, 64, "float32", 0)))


def kernel_flash(dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    out, worst = {}, 0.0
    for label, (B, H, KV, S, d, dt, window) in FLASH_FIXED:
        q, k, v = (torch.randn((B, S, h, d), generator=g, device=dev)
                   .to(getattr(torch, dt)) for h in (H, KV, KV))
        err, over, rel = flash_check(q, k, v, window=window)
        worst = max(worst, err)
        out[label] = flash_times(q, k, v, window=window)
        say(f"kernel flash_attention[{label}]", max_abs_err=err,
            err_over_limit=over, rel_norm_err=rel, **out[label])
        del q, k, v
        torch.cuda.empty_cache()
    return worst, out


# --------------------------------------------------- LM slice: the model


def lm_model(dev):
    """qwen2-1.5b at full width, bf16, random init from a seeded
    generator."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(get_config(ARCH), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    say("lm model", arch=ARCH, params=model.param_count(),
        dtype=model.cfg.param_dtype, init_s=time.perf_counter() - t0,
        layers=model.cfg.num_layers, d_model=model.cfg.d_model,
        heads=model.cfg.num_heads, kv_heads=model.cfg.num_kv_heads,
        head_dim=model.cfg.resolved_head_dim,
        vocab=model.cfg.padded_vocab)
    return model


def flash_layers(cfg) -> int:
    """The flash launches of one prefill: one an attention layer, so one a
    hybrid period, none in an SSM stack, and for an encoder-decoder one an
    encoder layer and two a decoder layer (self, cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.is_hybrid:
        return cfg.num_layers // cfg.attn_period
    if cfg.is_encoder_decoder:
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def phase_lm_prefill(model, B: int = 2, S: int = 4096,
                     label: str = "lm prefill"):
    """The prefill path: launch counts reset just before and read just
    after one ``prefill_logits`` (one flash launch an attention layer,
    ``flash_layers``); then a warm run and a profiled run."""
    import torch
    g = torch.Generator(device=model.device).manual_seed(1)
    toks = torch.randint(1, model.cfg.vocab_size, (B, S), generator=g,
                         device=model.device)
    batch = {"tokens": toks}
    return prefill_readings(model, batch, label), batch


def prefill_readings(model, batch, label: str, **extra) -> dict:
    """One ``prefill_logits`` on ``batch`` with the launch counts reset
    just before and read just after (``flash_layers`` flash launches),
    then a warm run and a profiled run; the counts.  S is the positions
    the decoder runs (a VLM's prefix included)."""
    import torch
    from repro_torch import kernels
    cfg = model.cfg
    B = batch["tokens"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits = model.prefill_logits(batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.launch_counts()
    S = batch["tokens"].shape[1] + cfg.num_prefix_tokens
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab)
          and logits.dtype == torch.float32, f"{label}: logits shape")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    check(counts["flash_attention"] == flash_layers(cfg),
          f"{label}: {counts['flash_attention']} flash launches, "
          f"expected {flash_layers(cfg)}")
    peak = torch.cuda.max_memory_allocated()
    del logits
    t0 = time.perf_counter()
    model.prefill_logits(batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    say(label, B=B, S=S, **extra, wall_ms_first=first * 1e3,
        wall_ms=warm * 1e3, tokens_per_s=B * S / warm,
        launches=json.dumps(counts), peak_mem_gib=peak / 2**30)
    busy_ms, ops, reads, ours, top = device_profile(
        lambda: model.prefill_logits(batch))
    say(f"profile {label}", wall_ms=warm * 1e3, device_busy_ms=busy_ms,
        idle_share=1.0 - busy_ms / 1e3 / warm, device_ops=ops,
        device_to_host=reads,
        kernels=json.dumps(ours), top=json.dumps(top))
    return counts


def first_layers(params, n: int):
    """The parameter tree of a model cut to its first ``n`` layers
    (views)."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else v[:n]
                for k, v in tree.items()}
    return {**params, "decoder": {"layers": cut(params["decoder"]["layers"])}}


def phase_lm_agreement(model, S: int = 64, tol: float = 2e-3,
                       label: str = "lm agreement", **changes) -> float:
    """A float32 copy of the model (with ``changes`` to its config; a
    smaller ``num_layers`` keeps the first layers): prefill logits at S
    tokens against S decode steps (the reference's prefill-vs-decode test
    at full width)."""
    import dataclasses
    import torch
    from repro_torch.models import Model
    cfg = dataclasses.replace(model.cfg, param_dtype="float32", **changes)
    params = model.params
    if cfg.num_layers < model.cfg.num_layers:
        params = first_layers(params, cfg.num_layers)
    m32 = Model(cfg, device=model.device).load_params(params)
    del params
    worst = prefill_decode_agreement(m32, S, tol, label)
    del m32
    torch.cuda.empty_cache()
    return worst


def prefill_decode_agreement(m32, S: int, tol: float, label: str) -> float:
    """Prefill logits of ``m32`` at S seeded tokens against S decode steps
    (each within ``tol`` abs + ``tol`` rel)."""
    import torch
    cfg = m32.cfg
    g = torch.Generator(device=m32.device).manual_seed(2)
    toks = torch.randint(1, cfg.vocab_size, (1, S), generator=g,
                         device=m32.device)
    full = m32.prefill_logits({"tokens": toks})
    cache = m32.init_cache(1, S)
    worst, rel = 0.0, 0.0
    for t in range(S):
        logits, cache = m32.decode_step(cache, toks[:, t:t + 1])
        diff = (logits - full[:, t]).abs()
        worst = max(worst, float(diff.max()))
        rel = max(rel, float((diff / (tol + tol * full[:, t].abs())).max()))
    say(label, dtype="float32", S=S, layers=cfg.num_layers,
        capacity_factor=cfg.capacity_factor if cfg.uses_moe else None,
        max_abs_err=worst, max_err_over_bar=rel,
        logits_absmax=float(full.abs().max()))
    check(rel <= 1.0, f"{label}: prefill and decode logits differ by "
                      f"{worst} (bar {tol} abs + {tol} rel)")
    return worst


def serve_once(model, *, seed: int = 0, requests: int = 16, ticks=None,
               prompt=(64, 257), new=(8, 33)):
    """``requests`` requests (prompts of ``prompt`` tokens, 64-256 by
    default, and ``new`` new ones, 8-32; both [lo, hi) ranges; 16
    requests by default, two ticks of a choice among them: 16-64 new
    tokens until the layout phase was added, cut for the run's time),
    max_batch 8, cache_len 1024, an HBM budget of
    0.05 x the card's memory; ``ticks`` admission ticks, by default as
    many as answer every request."""
    import torch
    from repro_torch.serving import PackageScheduler, Request, ServingEngine
    cfg = model.cfg
    memory = torch.cuda.get_device_properties(model.device).total_memory
    sched = PackageScheduler(cfg, hbm_budget_bytes=0.05 * memory,
                             flop_budget=5e13, max_batch=8,
                             device=model.device)
    rng = np.random.default_rng(seed)
    reqs = [Request(rid, int(rng.integers(*prompt)), int(rng.integers(*new)),
                    float(rng.uniform(0.1, 1.0))) for rid in range(requests)]
    for r in reqs:
        sched.submit(r)
    engine = ServingEngine(model, cache_len=1024, seed=seed)
    t0 = time.perf_counter()
    done = engine.serve(sched, ticks=ticks or -(-requests // sched.max_batch))
    return reqs, done, engine, sched, time.perf_counter() - t0


def cpu_admissions(model, reqs, ticks: int) -> list:
    """The admissions, tick by tick, of a scheduler on the CPU (its B&B
    waves on the batched engine's plain version) given serve_once's
    requests."""
    import torch
    from repro_torch.serving import PackageScheduler
    memory = torch.cuda.get_device_properties(model.device).total_memory
    sched = PackageScheduler(model.cfg, hbm_budget_bytes=0.05 * memory,
                             flop_budget=5e13, max_batch=8, device="cpu")
    for r in reqs:
        sched.submit(r)
    return [[r.rid for r in sched.tick()] for _ in range(ticks)]


def phase_lm_serve(model, label: str = "lm serve", requests: int = 16,
                   **lengths):
    """``serve_once`` (``lengths``: its ``prompt`` and ``new`` ranges)
    with its admissions held to a CPU scheduler's, every request answered,
    its first tick rerun identically, then a short profiled batch."""
    from repro_torch import kernels
    from repro_torch.core import guard
    cfg = model.cfg
    kernels.reset_launches()
    with capturing_flights() as flights:
        reqs, done, engine, sched, wall = serve_once(model,
                                                     requests=requests,
                                                     **lengths)
    counts = kernels.launch_counts()
    per_tick, at = [], 0
    for t in engine.tick_log:
        per_tick.append([g.rid for g in done[at:at + t.admitted]])
        at += t.admitted
    want = cpu_admissions(model, reqs, len(engine.tick_log))
    say(f"{label} admissions", card=json.dumps(per_tick),
        cpu=json.dumps(want), lp_batch_launches=counts["lp_batch"])
    check(per_tick == want, f"{label}: the card's admissions differ "
                            "from a CPU scheduler's")
    lp_err = hold_flights(flights, label)
    for i, t in enumerate(engine.tick_log):
        per_tok = t.decode_s / max(t.steps - 1, 1)
        say(f"{label} tick {i}", admitted=t.admitted,
            solve_ms=t.solve_s * 1e3, status=t.status,
            prompt_len=t.prompt_len, steps=t.steps, tokens=t.tokens,
            ttft_ms=t.prefill_s * 1e3, decode_ms_per_token=per_tok * 1e3,
            tokens_per_s=t.tokens / max(t.prefill_s + t.decode_s, 1e-9))
        check(t.status == guard.OK, f"{label}: tick {i} status {t.status}")
    want = {r.rid: r.max_new_tokens for r in reqs}
    got = {g.rid: g.tokens for g in done}
    check(set(got) == set(want) and not sched.queue,
          f"{label}: answered {sorted(got)} of {sorted(want)}")
    for rid, toks in got.items():
        check(len(toks) == want[rid], f"{label}: rid {rid} got "
                                      f"{len(toks)} of {want[rid]} tokens")
        check(all(0 <= x < cfg.vocab_size for x in toks),
              f"{label}: rid {rid} has out-of-vocabulary tokens")
    # determinism: the first tick again from the same seed (its admission
    # and its batch's tokens) proves what a whole second run would, at
    # half its cost
    _, again, _, _, again_s = serve_once(model, requests=requests, ticks=1,
                                         **lengths)
    first = [(g.rid, g.tokens) for g in done[:engine.tick_log[0].admitted]]
    check([(g.rid, g.tokens) for g in again] == first,
          f"{label}: tick 0 rerun with the same seed gave other admissions "
          "or tokens")
    tokens = sum(want.values())
    say(label, requests=len(reqs), answered=len(done), wall_s=wall,
        generated_tokens=tokens, tokens_per_s=tokens / wall,
        tick0_rerun="identical", tick0_rerun_s=again_s,
        launches=json.dumps(counts))
    # a short batch: the profiler's bookkeeping grows with the ~2,400
    # device ops of every decode step
    new = 2
    prompts = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (8, 2)).astype(np.int32)
    t0 = time.perf_counter()
    engine.generate_batch(prompts, new)
    gen_s = time.perf_counter() - t0
    busy_ms, ops, reads, _, top = device_profile(
        lambda: engine.generate_batch(prompts, new))
    steps = prompts.shape[1] + new - 1
    say(f"profile {label} (batch 8, {prompts.shape[1]} prompt + {new} "
        f"new)", wall_s=gen_s,
        device_busy_s=busy_ms / 1e3, idle_share=1.0 - busy_ms / 1e3 / gen_s,
        decode_steps=steps, device_ops_per_step=ops / steps,
        device_to_host=reads, top=json.dumps(top))
    return counts["lp_batch"], lp_err


def phase_lm_main_inputs(model, batch, counts,
                         label: str = "main-path flash_attention",
                         times: bool = True):
    """The prefill rerun keeping every flash call's arguments, each held
    against the plain version; numbers at the largest call (none when not
    ``times``: the caller timed that call)."""
    import torch
    from repro_torch import kernels
    kernels.reset_launches()
    with capturing(("flash_attention",)) as calls:
        model.prefill_logits(batch)
    torch.cuda.synchronize()
    again = kernels.launch_counts()
    kept = calls["flash_attention"]
    check(len(kept) == flash_layers(model.cfg),
          f"{label}: {len(kept)} flash calls kept")
    t0 = time.perf_counter()
    errs, overs, rels = zip(*(flash_check(*a, **kw) for a, kw in kept))
    torch.cuda.synchronize()
    sizes = [a[0].numel() for a, _ in kept]
    (a, kw) = kept[int(np.argmax(sizes))]
    nums = flash_times(*a, **kw) if times else {}
    say(label, calls=len(kept),
        launches_as_in_prefill=again["flash_attention"]
        == counts["flash_attention"], max_abs_err=max(errs),
        err_over_limit=max(overs), rel_norm_err=max(rels),
        check_s=time.perf_counter() - t0, **nums)
    del calls, kept
    torch.cuda.empty_cache()
    return max(errs), nums



# ------------------------------------------- the MoE slice: mixtral-8x22b

MOE_ARCH = "mixtral-8x22b"
# of its 56 layers: one full-width layer holds 2.50e9 parameters (5.0 GB
# in bf16), 4 hold 20.8 GB with the embeddings (8 would hold 40.9); every
# decode step of the capacity dispatch reads every expert's weights.  4,
# not 8: the serve phase's decode is host-bound, ~150 device ops a layer
# and step, and the whole script must stay well inside its time limit
MOE_LAYERS = 4
MOE_PREFILL = dict(B=1, S=8192)   # twice the 4,096-token window
MOE_LAYER_TOKENS = 512            # phase "moe layer"
MOE_TOL = 2e-4                    # the reference's MoE bar, float32
MOE_AGREEMENT = dict(num_layers=2, capacity_factor=8.0)


def moe_model(dev):
    """mixtral-8x22b at full width cut to ``MOE_LAYERS`` layers, bf16,
    random init from a seeded generator."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    say("moe model", arch=MOE_ARCH, params=model.param_count(),
        active_params=cfg.active_param_count(), dtype=cfg.param_dtype,
        init_s=time.perf_counter() - t0, layers=cfg.num_layers,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, experts=cfg.num_experts,
        top_k=cfg.num_experts_per_tok, moe_d_ff=cfg.moe_d_ff,
        window=cfg.sliding_window, vocab=cfg.padded_vocab,
        param_gib=torch.cuda.memory_allocated() / 2**30)
    return model


@contextlib.contextmanager
def routing_log():
    """Every ``moe.apply_moe`` call in the block also logs its routing:
    [(copies per expert, copies dropped per expert, tokens a group,
    slots an expert)], one entry a layer."""
    import torch
    from repro_torch.models import moe
    log, apply = [], moe.apply_moe

    def logged(p, cfg, x, *args, **kw):
        r = moe.route(p, cfg, x, *args, **kw)
        E = cfg.num_experts
        log.append((torch.bincount(r.idx.flatten(), minlength=E),
                    torch.bincount(r.idx[~r.keep], minlength=E), r.g, r.C))
        return apply(p, cfg, x, *args, **kw)

    moe.apply_moe = logged
    try:
        yield log
    finally:
        moe.apply_moe = apply


def phase_moe_prefill(model, label: str = "moe prefill", sizes=MOE_PREFILL):
    """Phase "lm prefill" on a MoE model (mixtral: B = 1, S = 8,192, the
    window masks keys), then one more prefill logging each MoE layer's
    routing (``decoder_layer`` counts the leading dense layers too; a
    hybrid's lines name the MoE sublayer, counted over its periods)."""
    counts, batch = phase_lm_prefill(model, label=label, **sizes)
    with routing_log() as log:
        model.prefill_logits(batch)
    cfg = model.cfg
    if cfg.is_hybrid:
        P, mp = cfg.attn_period, cfg.moe_period
        where = [f"sub {j * P + i}" for j in range(cfg.num_layers // P)
                 for i in range(P) if mp and i % mp == mp - 1]
    else:
        first = cfg.first_k_dense if cfg.uses_moe else 0
        where = [f"layer {i}" for i in range(len(log))]
    check(len(log) == len(where), f"{label}: {len(log)} MoE calls, "
                                  f"expected {len(where)}")
    for i, (copies, dropped, g, C) in enumerate(log):
        say(f"{label} routing {where[i]}",
            **({} if cfg.is_hybrid else {"decoder_layer": first + i}),
            tokens_a_group=g,
            slots_an_expert=C, copies=json.dumps(copies.tolist()),
            dropped=json.dumps(dropped.tolist()),
            dropped_share=float(dropped.sum()) / float(copies.sum()))
    return counts, batch


def phase_moe_layer(model, T: int = MOE_LAYER_TOKENS, tol: float = MOE_TOL):
    """Layer 0's experts on T tokens: in float32 at capacity 8.0 (no copy
    drops) ``apply_moe`` against the dense oracle ``ref_moe`` (2e-4 abs +
    2e-4 rel); in bf16 at the default capacity, twice: bit-identical
    outputs and aux.  Times: the bf16 layer and the float32 pair (CUDA
    events)."""
    import dataclasses
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer
    cfg = model.cfg
    ffn = layer(model.params["decoder"]["layers"], 0)["ffn"]
    g = torch.Generator(device=model.device).manual_seed(3)
    x = torch.randn((1, T, cfg.d_model), generator=g, device=model.device)
    cfg8 = dataclasses.replace(cfg, capacity_factor=8.0)
    p32 = {k: v.float() for k, v in ffn.items()}
    out, _ = moe.apply_moe(p32, cfg8, x)
    want = moe.ref_moe(p32, cfg8, x)
    kept = bool(moe.route(p32, cfg8, x).keep.all())
    ms32 = timed_ms(lambda: moe.apply_moe(p32, cfg8, x), 3)
    plain32 = timed_ms(lambda: moe.ref_moe(p32, cfg8, x), 1)
    diff = (out - want).abs()
    err = float(diff.max())
    over = float((diff / (tol + tol * want.abs())).max())
    check(bool(torch.isfinite(out).all()), "moe layer: non-finite output")
    check(kept, "moe layer: a copy dropped at capacity factor 8.0")
    check(over <= 1.0, f"moe layer: apply_moe and ref_moe differ by {err} "
                       f"(bar {tol} abs + {tol} rel)")
    del p32, out, want, diff
    xb = x.bfloat16()
    a, aux_a = moe.apply_moe(ffn, cfg, xb)
    b, aux_b = moe.apply_moe(ffn, cfg, xb)
    check(torch.equal(a, b) and torch.equal(aux_a, aux_b),
          "moe layer: two bf16 runs differ")
    r = moe.route(ffn, cfg, xb)
    ms16 = timed_ms(lambda: moe.apply_moe(ffn, cfg, xb), 5)
    say("moe layer", tokens=T, float32_max_abs_err=err,
        float32_err_over_bar=over, float32_ms=ms32,
        float32_ref_moe_ms=plain32, bf16_rerun="identical", bf16_ms=ms16,
        bf16_tokens_a_group=r.g, bf16_slots_an_expert=r.C,
        bf16_dropped=int((~r.keep).sum()), aux=float(aux_a))
    torch.cuda.empty_cache()
    return err


def moe_phases(phase, dev):
    """Phases 16-20, each through ``phase(label, fn, *args)``; the model is
    freed at the end.  Returns (the prefill's launch counts, the main-path
    flash hold's (max abs err, numbers), the serve phase's (lp_batch
    launches, max lane error))."""
    import torch
    model = phase("moe model", moe_model, dev)
    counts, batch = phase("moe prefill", phase_moe_prefill, model)
    phase("moe layer", phase_moe_layer, model)
    phase("moe agreement", functools.partial(
        phase_lm_agreement, label="moe agreement", **MOE_AGREEMENT), model)
    serve = phase("moe serve", phase_lm_serve, model, "moe serve")
    held = phase("moe main-path inputs", phase_lm_main_inputs, model, batch,
                 counts, "main-path flash_attention moe")
    del model, batch
    torch.cuda.empty_cache()
    return counts, held, serve


# ------------------------------------------- the MLA slice: deepseek-v3-671b

MLA_ARCH = "deepseek-v3-671b"
# of its 61 layers: the 3 leading dense layers (width 18,432) and 2 MoE
# layers (256 experts of width 2,048, top-8, and a shared one) hold, with
# the embedding and untied head (1.85e9) and the MTP head (0.69e9),
# 27.30e9 parameters, 54.6 GB in bf16; 6 layers would be 77.6 GB.  A MoE
# layer's expert leaf is drawn a layer at a time (a 15 GB float32
# temporary).  Every decode step reads every expert (~45 GB at 2 MoE
# layers)
MLA_LAYERS = 5
MLA_PREFILL = dict(B=1, S=8192)
# phase "mla agreement": a float32 model of one dense and one MoE layer
# (14.63e9 parameters, 58.5 GB: no room beside the bf16 model, so drawn
# anew from a seeded generator once that is freed), capacity 8.0
MLA_AGREEMENT = dict(num_layers=2, first_k_dense=1, capacity_factor=8.0)


def mla_model(dev):
    """deepseek-v3-671b at full width cut to ``MLA_LAYERS`` layers, bf16,
    random init from a seeded generator."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.param import param_count
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_LAYERS)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    say("mla model", arch=MLA_ARCH, params=model.param_count(),
        mtp_params=param_count(model.spec()["mtp"]),
        active_params=cfg.active_param_count(), dtype=cfg.param_dtype,
        init_s=time.perf_counter() - t0, layers=cfg.num_layers,
        dense_layers=cfg.first_k_dense, d_model=cfg.d_model,
        heads=cfg.num_heads, q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank, nope_dim=cfg.qk_nope_head_dim,
        rope_dim=cfg.qk_rope_head_dim, v_head_dim=cfg.v_head_dim,
        d_ff=cfg.d_ff, experts=cfg.num_experts,
        top_k=cfg.num_experts_per_tok, moe_d_ff=cfg.moe_d_ff,
        shared_experts=cfg.num_shared_experts, vocab=cfg.padded_vocab,
        param_gib=torch.cuda.memory_allocated() / 2**30,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return model


def phase_first_flash(model, batch, label: str = "mla flash"):
    """The prefill's first flash call (all of them share its shape, so it
    is the largest) kept and held against the plain version (the one-ulp
    bar), then timed beside the plain scan and the library call on the
    same inputs."""
    import torch
    with capturing(("flash_attention",), limit=1) as calls:
        model.prefill_logits(batch)
    torch.cuda.synchronize()
    (a, kw), = calls["flash_attention"]
    err, over, rel = flash_check(*a, **kw)
    nums = flash_times(*a, **kw)
    say(label, max_abs_err=err, err_over_limit=over,
        rel_norm_err=rel, scale=kw.get("scale"), **nums)
    del calls, a
    torch.cuda.empty_cache()
    return err, nums


def phase_fresh_agreement(dev, arch: str = MLA_ARCH, changes=MLA_AGREEMENT,
                          label: str = "mla agreement", S: int = 64,
                          tol: float = 2e-3) -> float:
    """A float32 ``arch`` with ``changes`` at full width, drawn from a
    seeded generator: prefill logits (the float32 flash kernel: at (192,
    128) for deepseek) against S decode steps (absorbed for MLA), 2e-3."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                              **changes)
    m32 = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(1))
    say(f"{label} model", params=m32.param_count(), layers=cfg.num_layers,
        param_gib=torch.cuda.memory_allocated() / 2**30)
    worst = prefill_decode_agreement(m32, S, tol, label)
    del m32
    torch.cuda.empty_cache()
    return worst


def mla_phases(phase, dev):
    """Phases 21-25, each through ``phase(label, fn, *args)``; "mla
    agreement" (24) runs last, after the bf16 model is freed.  Returns
    (the prefill's launch counts, (max flash error over phases 22 and 25,
    phase 22's numbers), the serve phase's (lp_batch launches, max lane
    error))."""
    import torch
    model = phase("mla model", mla_model, dev)
    counts, batch = phase("mla prefill", phase_moe_prefill, model,
                          "mla prefill", MLA_PREFILL)
    flash_err, nums = phase("mla flash", phase_first_flash, model, batch)
    serve = phase("mla serve", phase_lm_serve, model, "mla serve")
    held_err, _ = phase("mla main-path inputs", phase_lm_main_inputs, model,
                        batch, counts, "main-path flash_attention mla",
                        False)
    del model, batch
    torch.cuda.empty_cache()
    phase("mla agreement", phase_fresh_agreement, dev)
    return counts, (max(flash_err, held_err), nums), serve


# ----------------------------- the SSM slice: mamba2-1.3b and jamba's hybrid

SSM_ARCH = "mamba2-1.3b"          # uncut: 48 layers, 1.344e9 parameters
SSM_PREFILL = dict(B=2, S=4096)   # 16 chunks of 256 a row
SSM_SCAN_S = 512                  # phase "ssm scan": 2 chunks
SSM_AGREEMENT_S = 512             # phases "ssm/hybrid agreement"
SSM_TOL = 2e-3                    # the reference's chunked-vs-sequential bar
HYBRID_ARCH = "jamba-1.5-large-398b"
# one period of 8 sublayers holds 45.14e9 parameters (90.3 GB in bf16),
# more than the card: the period itself is cut to 4 sublayers (SSM +
# dense FFN, SSM + MoE, attention + dense, SSM + MoE): 22.98e9
# parameters, 45.96 GB.  The same three sublayer kinds as Jamba's period;
# attention to SSM 1:3 where Jamba has 1:7
HYBRID_CUT = dict(num_layers=4, attn_period=4)
HYBRID_PREFILL = dict(B=1, S=8192)
# phase "hybrid agreement": a float32 period of 2 (SSM + dense FFN, then
# attention + MoE; 11.90e9 parameters, 47.6 GB), drawn once the bf16
# model is freed, capacity 8.0
HYBRID_AGREEMENT = dict(num_layers=2, attn_period=2, capacity_factor=8.0)


def slice_model(dev, arch: str, label: str, **changes):
    """``arch`` at full width with ``changes`` (a cut), bf16, random init
    from a seeded generator."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch), **changes)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    say(label, arch=arch, params=model.param_count(),
        active_params=cfg.active_param_count(), dtype=cfg.param_dtype,
        init_s=time.perf_counter() - t0, layers=cfg.num_layers,
        attn_period=cfg.attn_period, moe_period=cfg.moe_period,
        d_model=cfg.d_model, d_inner=cfg.d_inner, ssm_heads=cfg.ssm_heads,
        ssm_head_dim=cfg.ssm_head_dim, ssm_state=cfg.ssm_state,
        ssm_chunk=cfg.ssm_chunk, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff, experts=cfg.num_experts,
        top_k=cfg.num_experts_per_tok, vocab=cfg.padded_vocab,
        param_gib=torch.cuda.memory_allocated() / 2**30,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return model


def phase_ssm_scan(model, S: int = SSM_SCAN_S, tol: float = SSM_TOL):
    """Layer 0's SSD at full width: a float32 copy's chunked scan
    ``ssd_forward`` against the token-by-token oracle ``ssd_reference``
    (B = 1, S tokens: 2 chunks; 2e-3 abs + 2e-3 rel, the reference's
    bar); then the bf16 layer twice on the same input, bit-identical.
    Times by CUDA events."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer
    cfg = model.cfg
    p = layer(model.params["decoder"]["layers"], 0)["ssm"]
    p32 = {k: v.float() for k, v in p.items()}
    g = torch.Generator(device=model.device).manual_seed(4)
    x = 0.3 * torch.randn((1, S, cfg.d_model), generator=g,
                          device=model.device)
    par = ssm.ssd_forward(p32, cfg, x)
    seq = ssm.ssd_reference(p32, cfg, x)
    check(bool(torch.isfinite(par).all()), "ssm scan: non-finite output")
    diff = (par - seq).abs()
    err = float(diff.max())
    over = float((diff / (tol + tol * seq.abs())).max())
    check(over <= 1.0, f"ssm scan: chunked and sequential differ by {err} "
                       f"(bar {tol} abs + {tol} rel)")
    ms32 = timed_ms(lambda: ssm.ssd_forward(p32, cfg, x), 3)
    seq_ms = timed_ms(lambda: ssm.ssd_reference(p32, cfg, x), 1, warm=0)
    del p32, par, seq, diff
    xb = x.bfloat16()
    a = ssm.ssd_forward(p, cfg, xb)
    b = ssm.ssd_forward(p, cfg, xb)
    check(torch.equal(a, b), "ssm scan: two bf16 runs differ")
    ms16 = timed_ms(lambda: ssm.ssd_forward(p, cfg, xb), 5)
    say("ssm scan", S=S, chunks=S // min(cfg.ssm_chunk, S),
        float32_max_abs_err=err, float32_err_over_bar=over,
        out_absmax=float(a.float().abs().max()), float32_ms=ms32,
        ssd_reference_ms=seq_ms, bf16_rerun="identical", bf16_ms=ms16)
    torch.cuda.empty_cache()
    return err


def ssm_phases(phase, dev):
    """Phases 26-29 on mamba2-1.3b, uncut: "ssm prefill" (no flash launch:
    the stack has no attention), "ssm scan", "ssm agreement" (a float32
    copy of the whole model), "ssm serve"; the model is freed at the end.
    Returns (the prefill's launch counts, the serve phase's (lp_batch
    launches, max lane error))."""
    import torch
    model = phase("ssm model", slice_model, dev, SSM_ARCH, "ssm model")
    counts, _ = phase("ssm prefill", phase_lm_prefill, model,
                      SSM_PREFILL["B"], SSM_PREFILL["S"], "ssm prefill")
    phase("ssm scan", phase_ssm_scan, model)
    phase("ssm agreement", functools.partial(
        phase_lm_agreement, S=SSM_AGREEMENT_S, label="ssm agreement"),
        model)
    serve = phase("ssm serve", phase_lm_serve, model, "ssm serve")
    del model
    torch.cuda.empty_cache()
    return counts, serve


def hybrid_phases(phase, dev):
    """Phases 30-33 on jamba-1.5-large-398b at full width, one period cut
    to 4 sublayers (``HYBRID_CUT``): "hybrid prefill" (one flash launch,
    the routing of both MoE sublayers), "hybrid flash" (that call held
    and timed), "hybrid serve", then, the bf16 model freed, "hybrid
    agreement".  Returns (the prefill's launch counts, (the flash call's
    max abs error, its numbers), the serve phase's (lp_batch launches,
    max lane error))."""
    import torch
    model = phase("hybrid model", functools.partial(
        slice_model, dev, HYBRID_ARCH, "hybrid model", **HYBRID_CUT))
    counts, batch = phase("hybrid prefill", phase_moe_prefill, model,
                          "hybrid prefill", HYBRID_PREFILL)
    flash = phase("hybrid flash", phase_first_flash, model, batch,
                  "hybrid flash")
    serve = phase("hybrid serve", phase_lm_serve, model, "hybrid serve")
    del model, batch
    torch.cuda.empty_cache()
    phase("hybrid agreement", phase_fresh_agreement, dev, HYBRID_ARCH,
          HYBRID_AGREEMENT, "hybrid agreement", SSM_AGREEMENT_S)
    return counts, flash, serve


# ------------------- the encoder-decoder and VLM slice: whisper, paligemma

ENCDEC_ARCH = "whisper-base"      # uncut: 6 + 6 layers, 97.27e6 parameters
# 16 clips of 30 s (the stub's 1,500 frames each) and 448 text tokens,
# Whisper's text context: the encoder's 6 calls attend 1,500 queries over
# 2,048 keys (the reference's chunk of 1,024, the last padded), the
# decoder's 6 causal self calls 448 over 448 and its 6 cross calls 448
# over 2,048
ENCDEC_PREFILL = dict(B=16, T=448)
ENCDEC_AGREEMENT = dict(T=64, frames=(1024, 1500))
VLM_ARCH = "paligemma-3b"         # uncut: 18 layers, 1.905e9 parameters
VLM_PREFILL = dict(B=8, T=768)    # 256 stub patches + 768 text tokens
# phase "vlm agreement": a float32 paligemma cut to 2 layers, 1 x (256 +
# 256)
VLM_AGREEMENT = dict(num_layers=2, T=256)
# phases "encdec serve" and "vlm serve": 8 requests, prompts of 16-64
# tokens and 8-32 new (a tick decodes as many steps as its longest prompt
# and answer need, under 100 here against 285 at the lm serve's lengths)
SLICE_SERVE = dict(requests=8, prompt=(16, 65), new=(8, 33))
AGREEMENT_TOL = 2e-3              # the reference's prefill-vs-decode bar


def stub_batch(model, B: int, T: int, seed: int = 1, frames=None) -> dict:
    """T seeded tokens a row, and the stub frontend's embeddings drawn from
    the same generator in the model's dtype: ``frames`` (default the
    config's ``encoder_seq_len``) frames for an encoder-decoder,
    ``num_prefix_tokens`` patches for a VLM."""
    import torch
    cfg, dev = model.cfg, model.device
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, T), generator=g,
                                     device=dev)}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = torch.randn(
            (B, frames or cfg.encoder_seq_len, cfg.d_model), generator=g,
            device=dev).to(model.dtype)
    if cfg.num_prefix_tokens:
        batch["prefix"] = torch.randn(
            (B, cfg.num_prefix_tokens, cfg.d_model), generator=g,
            device=dev).to(model.dtype)
    return batch


def encdec_model(dev, arch: str, label: str):
    """``arch`` uncut, bf16, random init from a seeded generator."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    say(label, arch=arch, params=model.param_count(), dtype=cfg.param_dtype,
        init_s=time.perf_counter() - t0, layers=cfg.num_layers,
        encoder_layers=cfg.num_encoder_layers,
        encoder_frames=cfg.encoder_seq_len if cfg.is_encoder_decoder
        else None, prefix_tokens=cfg.num_prefix_tokens,
        d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, norm=cfg.norm,
        act=cfg.act, vocab=cfg.padded_vocab,
        param_gib=torch.cuda.memory_allocated() / 2**30)
    return model


def phase_slice_prefill(model, B: int, T: int, label: str):
    """Phase "lm prefill" on an encoder-decoder or a VLM batch (the stub's
    frames or patches beside T tokens a row): ``flash_layers`` launches."""
    batch = stub_batch(model, B, T)
    extra = {"frames": batch["enc_inputs"].shape[1]} \
        if "enc_inputs" in batch else {"prefix_tokens":
                                       model.cfg.num_prefix_tokens}
    return prefill_readings(model, batch, label, **extra), batch


def phase_picked_flash(model, batch, picks: dict, label: str) -> dict:
    """The prefill's flash calls named in ``picks`` (name: index in launch
    order) kept, each held against the plain version (the one-ulp bar)
    and timed beside the plain scan and the library call on the same
    inputs (a full call's K/V with the reference's padded keys; its bound
    counts the encoder's frames alone).  Returns {name: (max abs error,
    numbers)}."""
    import torch
    with capturing(("flash_attention",),
                   limit=max(picks.values()) + 1) as calls:
        model.prefill_logits(batch)
    torch.cuda.synchronize()
    kept = calls["flash_attention"]
    out = {}
    for name, i in picks.items():
        a, kw = kept[i]
        err, over, rel = flash_check(*a, **kw)
        keys = batch["enc_inputs"].shape[1] \
            if "enc_inputs" in batch and not kw.get("causal", True) else None
        nums = flash_times(*a, **kw, keys=keys)
        if kw.get("prefix"):
            # the same shape causal, without the prefix: the fused
            # backends' case
            nums["causal_library_ms"], nums["causal_library"] = sdpa_ms(
                *a, causal=True, window=0, scale=kw.get("scale"))
        say(f"{label} {name}", call=i, max_abs_err=err, err_over_limit=over,
            rel_norm_err=rel, **nums)
        out[name] = (err, nums)
    del calls, kept
    torch.cuda.empty_cache()
    return out


def logits_gap(full, steps, tol: float) -> tuple:
    """(max abs difference, max difference over ``tol`` abs + ``tol``
    rel) of step logits against the prefill's at the same positions."""
    diff = (steps - full).abs()
    return float(diff.max()), float((diff / (tol + tol * full.abs())).max())


def phase_encdec_agreement(model, T: int = ENCDEC_AGREEMENT["T"],
                           frames=ENCDEC_AGREEMENT["frames"],
                           tol: float = AGREEMENT_TOL) -> float:
    """A float32 copy of the model, B = 1, T tokens: prefill logits against
    ``prefill_with_cache`` of the first token (the encoder's cross K/V in
    the cache) and T - 1 decode steps.  Checked within ``tol`` at the
    first frame count (no padded chunk: the reference's two paths agree);
    at the others only printed: there the reference's parallel path
    attends its padded keys and its step path does not."""
    import dataclasses
    import torch
    from repro_torch.models import Model
    cfg = dataclasses.replace(model.cfg, param_dtype="float32")
    m32 = Model(cfg, device=model.device).load_params(model.params)
    worst = 0.0
    for n in frames:
        batch = stub_batch(m32, 1, T, seed=2, frames=n)
        full = m32.prefill_logits(batch)
        first, cache = m32.prefill_with_cache(
            {**batch, "tokens": batch["tokens"][:, :1]}, T)
        steps = [first]
        for t in range(1, T):
            logits, cache = m32.decode_step(cache,
                                            batch["tokens"][:, t:t + 1])
            steps.append(logits)
        err, over = logits_gap(full[0], torch.stack(steps, 1)[0], tol)
        checked = n == frames[0]
        say("encdec agreement", dtype="float32", frames=n, T=T,
            max_abs_err=err, max_err_over_bar=over,
            logits_absmax=float(full.abs().max()),
            checked=checked, padded_keys=(-n) % 1024 if n > 1024 else 0)
        if checked:
            check(over <= 1.0, f"encdec agreement: prefill and decode "
                               f"differ by {err} at {n} frames (bar {tol} "
                               f"abs + {tol} rel)")
            worst = err
    del m32
    torch.cuda.empty_cache()
    return worst


@contextlib.contextmanager
def plain_attention():
    """The model's flash calls run the kernel's plain version on the card
    (``flash_plain``) inside the block."""
    from repro_torch.models import attention as attn
    saved = attn.flash_attention_op
    attn.flash_attention_op = flash_plain
    try:
        yield
    finally:
        attn.flash_attention_op = saved


def phase_vlm_agreement(model, changes=VLM_AGREEMENT,
                        tol: float = AGREEMENT_TOL) -> float:
    """A float32 copy of the model cut to its first layers, B = 1 x (256
    patches + T tokens): prefill logits through the float32 kernel at
    (256, 256) with the prefix against the same model with the plain
    attention on the card, within ``tol``.  (Prefill against decode does
    not apply: the reference's decode path has no prefix.)"""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.models import Model
    T = changes["T"]
    cfg = dataclasses.replace(model.cfg, param_dtype="float32",
                              num_layers=changes["num_layers"])
    m32 = Model(cfg, device=model.device).load_params(
        first_layers(model.params, cfg.num_layers))
    batch = stub_batch(m32, 1, T, seed=2)
    kernels.reset_launches()
    got = m32.prefill_logits(batch)
    launches = kernels.launch_counts()["flash_attention"]
    with plain_attention():
        want = m32.prefill_logits(batch)
    err, over = logits_gap(want, got, tol)
    say("vlm agreement", dtype="float32", layers=cfg.num_layers,
        S=cfg.num_prefix_tokens + T, flash_launches=launches,
        max_abs_err=err, max_err_over_bar=over,
        logits_absmax=float(want.abs().max()))
    check(launches == cfg.num_layers, f"vlm agreement: {launches} flash "
                                      "launches")
    check(over <= 1.0, f"vlm agreement: the kernel's and the plain "
                       f"version's logits differ by {err} (bar {tol} abs "
                       f"+ {tol} rel)")
    del m32, got, want
    torch.cuda.empty_cache()
    return err


def encdec_phases(phase, dev):
    """Phases 34-37 on whisper-base uncut: "encdec prefill" (18 flash
    launches), "encdec flash" (the first encoder, decoder self and cross
    calls held and timed), "encdec agreement", "encdec serve".  Returns
    (the prefill's launch counts, {call: (max abs error, numbers)}, the
    serve phase's (lp_batch launches, max lane error))."""
    import torch
    model = phase("encdec model", encdec_model, dev, ENCDEC_ARCH,
                  "encdec model")
    counts, batch = phase("encdec prefill", phase_slice_prefill, model,
                          ENCDEC_PREFILL["B"], ENCDEC_PREFILL["T"],
                          "encdec prefill")
    enc = model.cfg.num_encoder_layers
    flash = phase("encdec flash", phase_picked_flash, model, batch,
                  {"encoder": 0, "self": enc, "cross": enc + 1},
                  "encdec flash")
    del batch
    phase("encdec agreement", phase_encdec_agreement, model)
    serve = phase("encdec serve", lambda: phase_lm_serve(
        model, "encdec serve", **SLICE_SERVE))
    del model
    torch.cuda.empty_cache()
    return counts, flash, serve


def vlm_phases(phase, dev):
    """Phases 38-41 on paligemma-3b uncut: "vlm prefill" (18 flash
    launches, prefix-LM at (256, 256)), "vlm flash" (the first call held
    and timed), "vlm agreement", "vlm serve".  Returns as
    ``encdec_phases``."""
    import torch
    model = phase("vlm model", encdec_model, dev, VLM_ARCH, "vlm model")
    counts, batch = phase("vlm prefill", phase_slice_prefill, model,
                          VLM_PREFILL["B"], VLM_PREFILL["T"], "vlm prefill")
    flash = phase("vlm flash", phase_picked_flash, model, batch,
                  {"prefix": 0}, "vlm flash")
    del batch
    torch.cuda.empty_cache()
    phase("vlm agreement", phase_vlm_agreement, model)
    serve = phase("vlm serve", lambda: phase_lm_serve(
        model, "vlm serve", **SLICE_SERVE))
    del model
    torch.cuda.empty_cache()
    return counts, flash, serve


# ------------------------------------------------------------------ main


# ------------------------------------------------ distributed pricing

# "dist": benchmarks/warm_start.py::_distributed_pricing's --full profile
# (``_big_package_lp(1_000_000)``, m = 12, max_iters 20,000) on an NCCL
# world of one rank, then the full cell built and solved through the mesh
DIST_LP = dict(n=1_000_000, m=12, seed=0, max_iters=20_000)
DIST_CHUNK = 1_000_000       # the mesh build's chunk_rows
DIST_HOLD = 3                # pivots whose pricing and histogram are held


def big_package_lp(n: int, m: int = 12, seed: int = 0):
    """``benchmarks/warm_start.py::_big_package_lp``: a paper-style
    package LP (a count row and m - 1 attribute rows around a 30-row
    package)."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=n)
    A = np.stack([np.ones(n)] + [
        rng.normal(rng.uniform(-5, 15), rng.uniform(1, 3), n)
        for _ in range(m - 1)])
    x0 = np.zeros(n)
    x0[rng.choice(n, 30, replace=False)] = 1.0
    act = A @ x0
    w = np.maximum(np.abs(act) * 0.02, 0.5)
    return c, A, act - w, act + w, np.ones(n)


def dist_mesh():
    """An NCCL world of one rank (a ``HashStore``, rank 0) and its (1, 1)
    ``DeviceMesh`` named ("data", "model")."""
    import datetime
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


LAYOUT_TRAIN = dict(arch="smollm-135m", B=8, S=2048)
LAYOUT_DECODE = dict(cache_len=4096, index=100)


def _clone_cache(cache) -> dict:
    return {k: v.clone() if hasattr(v, "clone") else v
            for k, v in cache.items()}


def _local(t):
    """A DTensor's local tensor (the whole tensor on a (1, 1) mesh)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _walls(fn, reps: int = 2) -> list:
    import torch
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def phase_layout(model, batch, dev):
    """The multi-device layout (``repro_torch.distributed``) on an NCCL
    world of one rank and its (1, 1) mesh: qwen2-1.5b's prefill (the
    flash launches counted through ``local_map``) and one decode step
    with its parameters ``shard_params``-ed and the rules active, each
    bit-equal to the rules-free run from the same parameters; then
    smollm-135m's train step (8 x 2,048; its flash backward on the tensor
    cores) bit-equal in loss and updated parameters.  Walls with and
    without rules.  Returns the prefill's launch counts."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.distributed.context import use_rules
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import attention as fa
    from repro_torch.models import Model
    from repro_torch.models.param import leaves
    from repro_torch.training.step import init_train_state, make_train_step
    cfg = model.cfg
    B = batch["tokens"].shape[0]
    g = torch.Generator(device=dev).manual_seed(7)
    cache0 = model.init_cache(B, LAYOUT_DECODE["cache_len"])
    for k in ("k", "v"):
        cache0[k].normal_(generator=g)
    cache0["index"] = LAYOUT_DECODE["index"]
    tok1 = batch["tokens"][:, :1]
    want = model.prefill_logits(batch)
    c_want = _clone_cache(cache0)
    d_want, _ = model.decode_step(c_want, tok1)
    free_prefill = _walls(lambda: model.prefill_logits(batch))
    free_decode = _walls(lambda: model.decode_step(_clone_cache(cache0),
                                                   tok1), 3)
    mesh = dist_mesh()
    try:
        rules = make_rules(mesh)
        rules.shard_params(model)
        with use_rules(rules):
            kernels.reset_launches()
            got = model.prefill_logits(batch)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            check(counts["flash_attention"] == flash_layers(cfg),
                  f"layout prefill: {counts['flash_attention']} flash "
                  f"launches, want {flash_layers(cfg)}")
            check(torch.equal(_local(got), want),
                  "layout prefill: logits under the rules differ from the "
                  "rules-free prefill")
            del got, want
            c_got = _clone_cache(cache0)
            d_got, c_got = model.decode_step(c_got, tok1)
            check(torch.equal(_local(d_got), d_want),
                  "layout decode: logits differ")
            for k in ("k", "v"):
                check(torch.equal(_local(c_got[k]), c_want[k]),
                      f"layout decode: cache {k} differs")
            rules_prefill = _walls(lambda: model.prefill_logits(batch))
            rules_decode = _walls(lambda: model.decode_step(
                _clone_cache(cache0), tok1), 3)
        del c_got, c_want, cache0
        torch.cuda.empty_cache()

        tcfg = get_config(LAYOUT_TRAIN["arch"])
        tb = train_batch(tcfg, dev, LAYOUT_TRAIN["B"], LAYOUT_TRAIN["S"])
        res = {}
        for mode in ("free", "rules"):
            m = Model(tcfg, device=dev).init(
                torch.Generator(device=dev).manual_seed(0))
            if mode == "rules":
                rules.shard_params(m)
            st = init_train_state(m)
            step = make_train_step(m)
            with use_rules(rules if mode == "rules" else None):
                bwd0 = (fa.bwd_launches, fa.bwd_tc_launches)
                t0 = time.perf_counter()
                st, met = step(st, tb)
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                bwd = (fa.bwd_launches - bwd0[0],
                       fa.bwd_tc_launches - bwd0[1])
                t0 = time.perf_counter()
                st2, met2 = step(st, tb)
                torch.cuda.synchronize()
                second = time.perf_counter() - t0
            res[mode] = dict(
                loss=_local(met["loss"]).clone(),
                loss2=_local(met2["loss"]).clone(),
                params={n: _local(p).detach().clone()
                        for n, p in leaves(st2["params"])},
                walls=[first, second], bwd=bwd)
            del m, st, st2, step
            torch.cuda.empty_cache()
        a, b = res["free"], res["rules"]
        check(b["bwd"][0] == tcfg.num_layers and b["bwd"][1] == b["bwd"][0],
              f"layout train: flash backward launches {b['bwd']}, want "
              f"{tcfg.num_layers} on the tensor cores")
        check(torch.equal(a["loss"], b["loss"]) and
              torch.equal(a["loss2"], b["loss2"]),
              f"layout train: loss {float(b['loss'])} under the rules vs "
              f"{float(a['loss'])}")
        diff = [n for n in a["params"]
                if not torch.equal(a["params"][n], b["params"][n])]
        check(not diff, f"layout train: parameters differ after two steps: "
                        f"{diff[:5]}")
    finally:
        dist.destroy_process_group()
    say("layout", card=json.dumps(smi()), mesh="(1, 1) nccl",
        arch=ARCH, prefill=f"{B}x{batch['tokens'].shape[1]}",
        flash_launches=counts["flash_attention"],
        prefill_free_s=free_prefill, prefill_rules_s=rules_prefill,
        decode_free_s=free_decode, decode_rules_s=rules_decode,
        train_arch=LAYOUT_TRAIN["arch"],
        train=f"{LAYOUT_TRAIN['B']}x{LAYOUT_TRAIN['S']}",
        train_free_s=a["walls"], train_rules_s=b["walls"],
        train_loss=float(a["loss"]), bwd_launches=b["bwd"][0],
        bit_equal=True)
    return counts


def dist_profile(mesh, device):
    """The reference's distributed-pricing profile on the card: cold (the
    kernel counts read around it, the first pivots' calls kept) and warm
    from the numpy twin's answer, each against ``solve_lp_np``; the cold
    solve again for its wall and under the profiler (device to host reads
    a pivot), and the single-device ``solve_lp`` on the same LP."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.distributed import solve_lp_dist
    from repro_torch.core.lp import OPTIMAL, solve_lp, solve_lp_np
    cfg = DIST_LP
    lp = big_package_lp(cfg["n"], cfg["m"], cfg["seed"])
    it = cfg["max_iters"]
    t0 = time.perf_counter()
    ref = solve_lp_np(*lp, max_iters=it)
    np_s = time.perf_counter() - t0

    def dist_solve(**kw):
        t0 = time.perf_counter()
        res = solve_lp_dist(*lp, mesh=mesh, device=device,
                            **{"max_iters": it, **kw})
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    kernels.reset_launches()
    with capturing(("pricing", "bfrt_histogram dist"), limit=DIST_HOLD) \
            as calls:
        cold, first_s = dist_solve()
    launched = kernels.launch_counts()
    cold2, cold_s = dist_solve()
    # the solve's fixed part alone: standard form, the shards' copies to
    # the card, the final factorization and state gather (no pivot)
    fixed_s = min(dist_solve(max_iters=0)[1] for _ in range(2))
    warm, warm_s = dist_solve(warm_start=ref)
    host = []
    busy_ms, ops, reads, ours, top = device_profile(
        dist_solve, on_prof=lambda p: host.append(host_top(p)))
    t0 = time.perf_counter()
    single = solve_lp(*lp, max_iters=it, device=device)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    tol = 1e-6 * (1 + abs(ref.obj))
    for tag, r in (("cold", cold), ("cold again", cold2), ("warm", warm),
                   ("single-device solve_lp", single)):
        check(r.status == ref.status == OPTIMAL,
              f"dist profile {tag}: status {r.status}, numpy {ref.status}")
        check(abs(r.obj - ref.obj) <= tol,
              f"dist profile {tag}: objective {r.obj} vs {ref.obj}")
    check(cold2.iters == cold.iters and np.array_equal(cold2.x, cold.x),
          "dist profile: a second cold solve differs")
    pivots = max(cold.iters, 1)
    for name in ("pricing", "bfrt_histogram"):
        check(launched[name] > 0, f"dist profile: {name} never launched")
    say("dist profile", n=cfg["n"], m=cfg["m"], status=cold.status,
        obj=cold.obj, numpy_obj=ref.obj,
        obj_rel_diff=abs(cold.obj - ref.obj) / max(1.0, abs(ref.obj)),
        pivots=cold.iters, numpy_pivots=ref.iters, warm_pivots=warm.iters,
        single_pivots=single.iters, exact=cold.pivot_stats["exact"],
        conservative=cold.pivot_stats["conservative"],
        us_per_pivot=cold_s / pivots * 1e6, fixed_s=fixed_s,
        loop_us_per_pivot=(cold_s - fixed_s) / pivots * 1e6,
        first_solve_us_per_pivot=first_s / pivots * 1e6,
        warm_s=warm_s, single_us_per_pivot=single_s
        / max(single.iters, 1) * 1e6,
        numpy_us_per_pivot=np_s / max(ref.iters, 1) * 1e6,
        device_busy_s=busy_ms / 1e3, device_ops_per_pivot=ops / pivots,
        host_self_ms_profiled=host[0][0],
        device_to_host=reads, device_to_host_per_pivot=reads / pivots,
        pricing_per_pivot=launched["pricing"] / pivots,
        histogram_per_pivot=launched["bfrt_histogram"] / pivots,
        launches=json.dumps(launched), kernels=json.dumps(ours),
        top=json.dumps(top), host_top=json.dumps(host[0][1]))
    return launched, calls, lp, ref


def dist_full(mesh, table, q3, alpha, layers, device):
    """The full cell through the mesh: ``PackageQueryEngine(mesh=,
    chunk_rows=)`` (kernel counts read around the build and the solve,
    every mesh-sharded segment stats call kept), its layers held to the
    full phase's ``mesh=None`` build, and Q2_TPCH h=3 with every layer LP
    through ``solve_lp(mesh=)`` against the single-device solve."""
    from repro_torch import kernels
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.lp import solve_lp
    kernels.reset_launches()
    with capturing(("segment_stats mesh",)) as calls:
        t0 = time.perf_counter()
        eng = PackageQueryEngine(table, ATTRS, d_f=100, alpha=alpha,
                                 seed=0, mesh=mesh, chunk_rows=DIST_CHUNK,
                                 device=device).partition()
        _sync(device)
        part_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = eng.session(0).solve(q3, ilp_kwargs=ILP_KW,
                                 lp_solver=functools.partial(
                                     solve_lp, mesh=mesh, device=device))
        _sync(device)
        dist_s = time.perf_counter() - t0
    launched = kernels.launch_counts()
    got = [(ly.part.gid, ly.part.reps) for ly in eng.hierarchy.layers[1:]]
    check(len(got) == len(layers), "dist full: layer count differs")
    rel = 0.0
    for (g, reps), (g0, reps0) in zip(got, layers):
        check(np.array_equal(g, g0), "dist full: groups differ from the "
                                     "mesh=None build")
        rel = max(rel, float(np.max(np.abs(reps - reps0)
                                    / np.maximum(np.abs(reps0), 1.0))))
    check(rel <= 1e-8, f"dist full: reps differ by {rel} (relative)")
    single, single_s = solve(eng.session(0), q3)
    check(bool(r.feasible and q3.check_package(table, r.idx, r.mult)),
          "dist full: the h=3 solve through the mesh is not a feasible, "
          "valid package")
    obj_rel = abs(r.obj - single.obj) / max(1.0, abs(single.obj))
    check(obj_rel <= 1e-6, f"dist full: objective {r.obj} vs the "
                           f"single-device {single.obj}")
    check(launched["segment_stats"] > 0 and launched["pricing"] > 0,
          "dist full: segment stats or pricing never launched")
    say("dist full", rows=len(table[ATTRS[0]]), chunk_rows=DIST_CHUNK,
        layers=[len(layers[0][0])] + [len(x[1]) for x in layers],
        groups="identical", reps_max_rel_diff=rel, partition_s=part_s,
        solve_s=dist_s, single_device_solve_s=single_s, obj=r.obj,
        single_device_obj=single.obj, obj_rel_diff=obj_rel,
        same_package=same_package(r, single), report=r.report.status,
        lp_iters=getattr(r.ps_stats, "lp_iters", None),
        sharded_stats_calls=len(calls["segment_stats mesh"]),
        launches=json.dumps(launched))
    return launched, calls


def dist_shard(mesh, lp, ref, device):
    """``SHARD`` armed once (seed 0): the first pivot raises, the solve
    falls back to the host twin and reaches its optimum."""
    from repro_torch.core.distributed import solve_lp_dist
    from repro_torch.runtime import faults
    t0 = time.perf_counter()
    with faults.injected(seed=0, arms={faults.SHARD: dict(times=1)}) as inj:
        r = solve_lp_dist(*lp, mesh=mesh, max_iters=DIST_LP["max_iters"],
                          device=device)
    fires = inj.fire_count(faults.SHARD)
    check(fires == 1, f"dist SHARD: {fires} fires")
    check(r.pivot_stats.get("fallback") == 1 and any(
        "single_host_fallback" in nt for nt in r.notes),
        "dist SHARD: no single-host fallback")
    check(r.status == ref.status and abs(r.obj - ref.obj)
          <= 1e-6 * (1 + abs(ref.obj)), "dist SHARD: another optimum")
    say("dist SHARD", fires=fires, status=r.status, obj=r.obj,
        numpy_obj=ref.obj, pivot_stats=json.dumps(r.pivot_stats),
        seconds=time.perf_counter() - t0)


def phase_dist(table, q3, alpha, layers, device="cuda"):
    """Distributed pricing (``core.distributed``) on an NCCL world of one
    rank: the profile, the full cell through the mesh, ``SHARD``, and each
    kernel the phase launched held against its plain version on its real
    inputs.  Returns ({path: launch counts}, {kernel: (max abs err,
    numbers at its largest call)})."""
    import torch.distributed as dist
    mesh = dist_mesh()
    try:
        prof_n, calls, lp, ref = dist_profile(mesh, device)
        full_n, seg = dist_full(mesh, table, q3, alpha, layers, device)
        dist_shard(mesh, lp, ref, device)
    finally:
        dist.destroy_process_group()
    held = hold_calls({**calls, **seg}, tag="dist ")
    return {"dist profile": prof_n, "dist full": full_n}, {
        "pricing": held["pricing"],
        "bfrt_histogram": held["bfrt_histogram dist"],
        "segment_stats": held["segment_stats mesh"]}


# ------------------------------------------ the training slice: qwen2-1.5b

BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
LSE_TOL = 1e-5            # |lse - plain| / max(1, |plain|)
# (d, dv, H, KV): the forward's pairs, each at its card test's heads
BWD_PAIRS = ((64, 64, 6, 2), (120, 120, 6, 2), (128, 128, 6, 2),
             (192, 128, 4, 4), (256, 256, 8, 1))
# (mask, Sq, Sk, kwargs): S ragged over the 64-row and 64-key tiles
BWD_MASKS = (("causal", 200, 200, dict(causal=True)),
             ("window", 200, 200, dict(causal=True, window=70)),
             ("prefix", 200, 200, dict(causal=True, prefix=37)),
             ("cross", 150, 333, dict(causal=False)))
# ragged over the tensor-core kernels' tiles (dK/dV: 64 or 128 keys a
# block, 64 or 32 query rows a stage; dQ: 128 or 64 query rows a block, 64
# keys a stage): one query row over 129 keys, and S one past a multiple of
# 64 and 128.  (One causal row over its one key has dQ = dK = 0 exactly,
# dP = D, so a relative norm there compares rounding noise.)
BWD_RAGGED = (("one row", 1, 129, dict(causal=False)),
              ("S=129", 129, 129, dict(causal=True)),
              ("S=129 prefix", 129, 129, dict(causal=True, prefix=37)),
              ("S=257 window", 257, 257, dict(causal=True, window=70)))
# the kernels of a backward call: D, then dK/dV and dQ on the tensor cores
# (bf16 at (64, 64), (120, 120), (128, 128), (192, 128)) or on the CUDA
# cores (float32, bf16 (256, 256), and the baseline timed in phase 43)
BWD_KERNELS = ("flash_bwd_dot", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc",
               "flash_bwd_dkdv", "flash_bwd_dq")
BWD_TC = ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc")
BWD_CUDA_CORES = ("flash_bwd_dkdv", "flash_bwd_dq")
BWD_REPLACES = ("none: no TPU kernel; the reference differentiates its jnp "
                "scan, src/repro/models/attention.py:61")
TRAIN_ATTN = dict(B=4, S=4096, H=12, KV=2, d=128, dv=128)  # one microbatch
TRAIN_ARCH = "qwen2-1.5b"
# cut from SHAPES["train_4k"] (256 x 4,096) to 8 x 4,096 in 2 microbatches
TRAIN = dict(B=8, S=4096, microbatches=2, steps=3)
# no warmup, and a rate at which one step moves a bf16 1.0 (an RMSNorm
# scale: half its ulp below 1 is 2^-9), so every parameter changes
TRAIN_HYPER = dict(lr=3e-3, warmup_steps=0)
TRAIN_CE_TOL = 1e-3       # phase 45's first ce against prefill's, relative
# each arch's smoke config widened to a flash pair (as the card tests
# widen them); danube's window cut to 48 so that S = 64 crosses it; the
# MoE archs at capacity 8.0, so that neither device drops a copy
TRAIN_SMOKE = {
    "qwen2-1.5b": dict(head_dim=128),
    "h2o-danube-3-4b": dict(head_dim=120, sliding_window=48),
    "smollm-135m": dict(head_dim=64),
    "glm4-9b": dict(head_dim=128),
    "mixtral-8x22b": dict(head_dim=128, capacity_factor=8.0),
    "deepseek-v3-671b": dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                             v_head_dim=128, capacity_factor=8.0),
    "mamba2-1.3b": dict(),
    "jamba-1.5-large-398b": dict(head_dim=128, capacity_factor=8.0),
    "whisper-base": dict(head_dim=64),
    "paligemma-3b": dict(head_dim=256)}
# metrics, of max(1, |cpu|); moments, of each leaf's largest magnitude
# (mu = 0.1 g and nu = 0.05 g^2 after one step: they hold the gradients),
# float32 1e-4 (mamba2's SSD, whose exponentials of cumulative sums carry
# rounding furthest, differs by 1.8e-5 on the H100) and bf16 2^-8 (the
# moments of the MoE archs, one rounding to bf16); the update (the new
# parameters less the old) over all leaves, in relative norm: Adam's first
# step divides a gradient by its own magnitude, so an element whose
# gradient is as small as the two devices' rounding may move either way,
# which one leaf of a few elements cannot absorb but the whole update can
TRAIN_SMOKE_TOL = dict(metrics=1e-5, moments={"float32": 1e-4,
                                              "bfloat16": 2.0 ** -8},
                       update=1e-3)


def bwd_inputs(case, mask, dtype: str, dev, B: int = 2):
    """q, k, v and the output gradient dO of a backward case, drawn from
    a numpy seed of its shape."""
    import torch
    d, dv, H, KV = case
    _, Sq, Sk, _ = mask
    rng = np.random.default_rng(Sq * 1000 + Sk + d + dv + H)
    return tuple(torch.as_tensor(rng.normal(size=(B, S, h, w)),
                                 dtype=torch.float32, device=dev)
                 .to(getattr(torch, dtype))
                 for S, h, w in ((Sq, H, d), (Sk, KV, d), (Sk, KV, dv),
                                 (Sq, H, dv)))


def bwd_hold(q, k, v, do, **kw) -> dict:
    """The forward with ``lse`` and the backward kernels on (q, k, v, dO)
    held to their plain versions: the forward's output bit-identical with
    and without ``lse``; the LSE within ``LSE_TOL``; dQ, dK and dV within
    ``BWD_TOL`` in relative norm of the plain backward's on the same
    inputs (the kernel's O and LSE); fails otherwise.  The largest
    relative errors and absolute error."""
    import torch
    from repro_torch.kernels import attention as A
    dt = str(q.dtype).split(".")[-1]
    with torch.no_grad():
        o0 = A.flash_attention(q, k, v, **kw)
        o, lse = A.flash_attention_fwd(q, k, v, want_lse=True, **kw)
        _, lse_p = A.flash_attention_fwd_lse_plain(q, k, v, **kw)
        got = A.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = A.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    what = f"{tuple(q.shape)} v {tuple(v.shape)} {dt} {kw}"
    check(torch.equal(o, o0), f"flash forward: the output with lse differs "
                              f"from the output without, {what}")
    lse_err = float(((lse - lse_p).abs() / lse_p.abs().clamp_min(1.0))
                    .max())
    check(lse_err <= LSE_TOL, f"flash forward lse off by {lse_err}, {what}")
    rels, abs_err = [], 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype
              and bool(torch.isfinite(g).all()),
              f"flash backward {name}: shape, dtype or non-finite, {what}")
        diff = (g.float() - w.float())
        rels.append(float(diff.norm() / w.float().norm().clamp_min(1e-30)))
        abs_err = max(abs_err, float(diff.abs().max()))
        check(rels[-1] <= BWD_TOL[dt],
              f"flash backward {name} relative norm error {rels[-1]} over "
              f"{BWD_TOL[dt]}, {what}")
    return {"rel": rels, "max_abs_err": abs_err, "lse_err": lse_err}


def bwd_rerun(q, k, v, do, **kw) -> None:
    """The backward twice on the same inputs (the forward's O and LSE):
    dQ, dK and dV bit-identical (no atomics: every sum in one fixed
    order); fails otherwise."""
    import torch
    from repro_torch.kernels import attention as A
    with torch.no_grad():
        o, lse = A.flash_attention_fwd(q, k, v, want_lse=True, **kw)
        first = A.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        again = A.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"flash backward: a rerun gave other bits, {tuple(q.shape)} "
          f"{q.dtype} {kw}")


def phase_flash_bwd_agreement(dev):
    """Phase 42: every pair, dtype and mask of the forward's card tests,
    at S = 200 (150 queries over 333 keys for cross), and the ragged
    shapes of ``BWD_RAGGED``; each bf16 case rerun bit-identical."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    err = 0.0
    masks = BWD_MASKS + BWD_RAGGED
    for case in BWD_PAIRS:
        for mask in masks:
            for dt in ("float32", "bfloat16"):
                *qkv, do = bwd_inputs(case, mask, dt, dev)
                r = bwd_hold(*qkv, do, **mask[3])
                if dt == "bfloat16":
                    bwd_rerun(*qkv, do, **mask[3])
                worst[dt] = max(worst[dt], max(r["rel"]))
                err = max(err, r["max_abs_err"])
                say(f"flash bwd {case[0]}x{case[1]} {mask[0]} {dt}",
                    rel_norm_dq_dk_dv=json.dumps(r["rel"]),
                    max_abs_err=r["max_abs_err"], lse_err=r["lse_err"])
    say("flash bwd agreement", cases=len(BWD_PAIRS) * len(masks) * 2,
        worst_rel_f32=worst["float32"], worst_rel_bf16=worst["bfloat16"],
        bar=json.dumps(BWD_TOL), lse_bar=LSE_TOL, bf16_reruns_same_bits=True)
    return err


def sdpa_bwd_ms(q, k, v, do, reps: int = 3):
    """(ms, note): ``scaled_dot_product_attention``'s backward alone on the
    same inputs (causal, ``enable_gqa``): forward + backward less the
    forward, each recorded with grad on, and the backend that ran it."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    kw = dict(is_causal=True, enable_gqa=True)
    fwd = lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)
    both = lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    backend = "unknown"
    try:
        from torch.nn.attention import SDPBackend
        choice = torch._fused_sdp_choice(qt, kt, vt, **kw)
        backend = {int(b): n for n, b in SDPBackend.__members__.items()}\
            .get(int(choice), backend)
    except (AttributeError, RuntimeError, TypeError, ImportError):
        pass
    try:
        return timed_ms(both, reps) - timed_ms(fwd, reps), \
            f"scaled_dot_product_attention backward ({backend})"
    except RuntimeError as exc:
        return None, f"scaled_dot_product_attention failed: {exc}"[:200]


def bwd_kernel_numbers(B, Sq, Sk, H, KV, d, dv, pairs, esize):
    """(bytes, FLOP) of each backward kernel's useful work: D reads O and
    dO and writes D; dK/dV reads q, k, v, dO, LSE and D and writes dK, dV,
    2 (2 d + 2 dv) FLOP a kept pair (S, dP, dV, dK); dQ reads the same and
    writes dQ, 2 d a pair (its recompute of S and dP is not counted).
    The same for a route's two kernels on the tensor cores and on the
    CUDA cores."""
    qb, kb = B * Sq * H * d * esize, B * Sk * KV * d * esize
    vb, ob = B * Sk * KV * dv * esize, B * Sq * H * dv * esize
    rows = B * H * Sq * 4
    dkdv = (qb + kb + vb + ob + 2 * rows + kb + vb,
            2 * (2 * d + 2 * dv) * pairs)
    dq = (qb + kb + vb + ob + 2 * rows + qb, 2 * d * pairs)
    return {"flash_bwd_dot": (2 * ob + rows, 2 * dv * B * Sq * H),
            "flash_bwd_dkdv_tc": dkdv, "flash_bwd_dq_tc": dq,
            "flash_bwd_dkdv": dkdv, "flash_bwd_dq": dq}


def bwd_device(call, calls: int, cuda_cores: bool = False):
    """``per_call_device`` of ``calls`` backward calls (three kernels each:
    counted by ``bwd_launches``, or, on the uncounted CUDA-core baseline,
    three a call) and each kernel's median device ms by its name before
    "<"."""
    from repro_torch.kernels import attention as A
    dev = per_call_device(call, calls, None if cuda_cores else A,
                          "flash_bwd_", counter="bwd_launches",
                          kernels_per_call=3)
    return dev, {k.split("<")[0]: v[2]
                 for k, v in json.loads(dev["kernel_ms"]).items()}


def bwd_case_numbers(q, k, v, do, kw, reps: int, ms=None, plain_ms=None,
                     plain: bool = True) -> dict:
    """One backward case (``flash_attention_bwd``, on whichever route its
    pair and dtype take) timed on the card: the call's ms (CUDA events
    over ``reps`` calls, unless ``ms`` is given), each kernel's device ms
    (``bwd_device``), its bytes, useful FLOP (``bwd_kernel_numbers``) and
    bound, the plain version's ms (unless given, or ``plain`` is false)
    and SDPA's backward (causal calls)."""
    from repro_torch.kernels import attention as A
    B, S, H, d = q.shape
    KV, dv = k.shape[2], v.shape[3]
    o, lse = A.flash_attention_fwd(q, k, v, want_lse=True, **kw)
    run = lambda: A.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    tc0 = A.bwd_tc_launches
    run()
    route = BWD_TC if A.bwd_tc_launches > tc0 else BWD_CUDA_CORES
    ms = timed_ms(run, reps) if ms is None else ms
    dev, med = bwd_device(run, reps)
    if plain_ms is None and plain:
        plain_ms = timed_ms(lambda: A.flash_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), 1, warm=0)
    lib, note = sdpa_bwd_ms(q, k, v, do) if kw.get("causal") \
        and not kw.get("window") and not kw.get("prefix") else (None, None)
    pairs = flash_pairs(S, S, kw.get("causal", False), kw.get("window", 0),
                        kw.get("prefix", 0)) * B * H
    peak = PEAK_OPS[str(q.dtype).split(".")[-1]]
    shape = f"B={B} S={S} H={H} KV={KV} d={d} dv={dv} " \
            f"{str(q.dtype).split('.')[-1]} {kw}"
    per = {}
    for name, (nb, fl) in bwd_kernel_numbers(B, S, S, H, KV, d, dv, pairs,
                                             q.element_size()).items():
        if name not in ("flash_bwd_dot",) + route:
            continue
        kms = med.get(name)           # None where the profiler lost it
        per[name] = _numbers(shape, nb, fl, kms, plain_ms, lib, peak=peak,
                             library=note,
                             plain="flash_attention_bwd_plain (the three "
                                   "kernels' work together)",
                             tflops=fl / kms / 1e9 if kms else None,
                             vs_library=kms / lib if kms and lib else None,
                             backward_ms=ms,
                             runs_on="tensor cores" if name in BWD_TC
                             else "cuda cores",
                             **({"recompute_flop": 2 * (d + dv) * pairs}
                                if name in ("flash_bwd_dq_tc", "flash_bwd_dq")
                                else {}))
    del o, lse
    return {"ms": ms, "device_ms": dev["device_ms"], "pairs": pairs,
            "profiled_launches": dev["profiled_launches"], "kernels": per,
            "medians": med, "plain_ms": plain_ms, "library_ms": lib,
            "library": note}


def bwd_smoke_call(dev, arch: str = TRAIN_ARCH):
    """q, k, v, dO and the mask of ``arch``'s attention call in phase 44:
    its widened smoke config, float32, ``smoke_batch``'s B and S, causal;
    the call whose CUDA-core kernels phase 44 launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              **TRAIN_SMOKE[arch])
    B, S = smoke_batch(cfg)["tokens"].shape
    d = cfg.resolved_head_dim
    g = torch.Generator(device=dev).manual_seed(44)
    q, k, v, do = (torch.randn((B, S, h, d), generator=g, device=dev)
                   for h in (cfg.num_heads, cfg.num_kv_heads,
                             cfg.num_kv_heads, cfg.num_heads))
    return q, k, v, do, dict(causal=True, window=cfg.sliding_window or 0)


def phase_flash_bwd_time(dev, cell=TRAIN_ATTN):
    """Phase 43: the backward at the train cell's attention (one layer of
    one microbatch of phase 45), on the tensor cores and, in turns (new,
    old, old, new), on the CUDA-core kernels it replaced: each route's ms
    (CUDA events) and each kernel's device ms and TFLOP/s (the profiler,
    which must show the tensor-core kernels and not the CUDA-core ones on
    the model's call: ``per_call_device``'s medians over 10 and 3 calls),
    the bound (bytes / 3.35 TB/s against 2 (3 d + 2 dv) FLOP a kept pair /
    989 TFLOP/s), the plain version's ms and SDPA's backward.  Then the
    CUDA-core kernels at the shape of phase 44's qwen2-1.5b call (the
    kernels line's numbers for them), and bf16 (256, 256) at the VLM
    cell's attention, which stays on them."""
    import torch
    from repro_torch.kernels import attention as A
    B, S, H, KV, d, dv = (cell[k] for k in ("B", "S", "H", "KV", "d", "dv"))
    g = torch.Generator(device=dev).manual_seed(43)
    q, k, v, do = (torch.randn((B, S, h, w), generator=g, device=dev)
                   .to(torch.bfloat16)
                   for h, w in ((H, d), (KV, d), (KV, dv), (H, dv)))
    o, lse = A.flash_attention_fwd(q, k, v, causal=True, want_lse=True)
    run = lambda: A.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    old = lambda: A.flash_attention_bwd_cuda_cores(q, k, v, o, lse, do,
                                                   causal=True)
    got = run()
    torch.cuda.synchronize()
    want = A.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    plain_ms = timed_ms(lambda: A.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=True), 1, warm=0)
    rels = [float((a.float() - b.float()).norm() / b.float().norm())
            for a, b in zip(got, want)]
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    check(max(rels) <= BWD_TOL["bfloat16"],
          f"flash backward at the train cell: relative norm errors {rels}")
    del got, want
    torch.cuda.empty_cache()
    turns = [timed_ms(run, 10), timed_ms(old, 2), timed_ms(old, 2),
             timed_ms(run, 10)]
    ms, old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    new = bwd_case_numbers(q, k, v, do, dict(causal=True), 10, ms=ms,
                           plain_ms=plain_ms)
    new_k = new["medians"]
    old_dev, old_k = bwd_device(old, 3, cuda_cores=True)
    check(all(n in new_k for n in BWD_TC)
          and not any(n in new_k for n in BWD_CUDA_CORES),
          f"flash backward at the train cell: the profiler shows "
          f"{sorted(new_k)}, not the tensor-core kernels alone")
    # inputs q, k, v, O, dO (bf16) and LSE (f32) once; dQ, dK, dV once
    nbytes = (B * S * H * d + B * S * KV * (d + dv) + 2 * B * S * H * dv
              + B * S * H * d + B * S * KV * (d + dv)) * q.element_size() \
        + B * H * S * 4
    ops = 2 * (3 * d + 2 * dv) * new["pairs"]
    lib = new["library_ms"]
    whole = _numbers(f"B={B} S={S} H={H} KV={KV} d={d} dv={dv} bfloat16 "
                     "causal", nbytes, ops, ms, plain_ms, lib,
                     peak=PEAK_OPS["bfloat16"], library=new["library"],
                     device_ms=sum(new_k.values()),
                     tflops=ops / ms / 1e9,
                     vs_library=ms / lib if lib else None,
                     turns_ms=json.dumps(turns),
                     profiled_launches=new["profiled_launches"],
                     cuda_cores_ms=old_ms,
                     cuda_cores_device_ms=sum(old_k.values()),
                     cuda_cores_kernel_ms=old_dev["kernel_ms"],
                     cuda_cores_profiled_launches=old_dev[
                         "profiled_launches"],
                     rel_norm_dq_dk_dv=json.dumps(rels))
    say("flash bwd time", **whole, kernel_device_ms=json.dumps(new_k))
    per = new["kernels"]
    for name, nums in per.items():
        say(f"kernel {name}[train cell]", **nums)
    del q, k, v, do, o, lse, new
    torch.cuda.empty_cache()
    # the CUDA-core kernels as phase 44's float32 steps launch them
    *qkvd, kw = bwd_smoke_call(dev)
    smoke = bwd_case_numbers(*qkvd, kw, 10)
    check(all(n in smoke["medians"] for n in BWD_CUDA_CORES),
          f"flash backward at phase 44's call: the profiler shows "
          f"{sorted(smoke['medians'])}, not the CUDA-core kernels")
    for name in BWD_CUDA_CORES:
        per[name] = {**smoke["kernels"][name], "call_of": f"phase 44's "
                     f"{TRAIN_ARCH} step (its widened smoke config)"}
        say(f"kernel {name}[phase 44 call]", **per[name])
    del qkvd
    # bf16 (256, 256) at the VLM cell's attention (paligemma: B = 8, 256
    # patches + 768 tokens, 8 query heads on 1 KV head, a 256-key prefix)
    g = torch.Generator(device=dev).manual_seed(44)
    q, k, v, do = (torch.randn((8, 1024, h, 256), generator=g, device=dev)
                   .to(torch.bfloat16) for h in (8, 1, 1, 8))
    vlm = bwd_case_numbers(q, k, v, do, dict(causal=True, prefix=256), 3,
                           plain=False)
    vops = 2 * (3 * 256 + 2 * 256) * vlm["pairs"]
    vbytes = (4 * 8 * 1024 * 8 * 256 + 4 * 8 * 1024 * 256) * 2 \
        + 8 * 8 * 1024 * 4
    vb, vby = bound_ms(vbytes, vops, PEAK_OPS["bfloat16"])
    say("flash bwd 256x256[vlm cell]", ms=vlm["ms"],
        device_ms=vlm["device_ms"], tflops=vops / vlm["ms"] / 1e9,
        bound_ms=vb, bound_by=vby, over_bound=vlm["ms"] / vb,
        profiled_launches=vlm["profiled_launches"],
        kernel_device_ms=json.dumps(vlm["medians"]))
    del q, k, v, do
    torch.cuda.empty_cache()
    return err, whole, per


def smoke_batch(cfg, B: int = 2, S: int = 64, seed: int = 44):
    """A numpy-seeded batch (labels = tokens) with the stub frames or
    patches the family takes."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (B, S))
    batch = {"tokens": tok, "labels": tok}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = rng.normal(
            size=(B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    if cfg.num_prefix_tokens:
        batch["prefix"] = rng.normal(
            size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def train_smoke_step(arch: str, dev) -> dict:
    """One train step of ``arch``'s smoke config widened by
    ``TRAIN_SMOKE`` in float32 on the card and on the CPU from the same
    parameters and batch (lr 1e-3): loss and every metric within 1e-5 of
    max(1, |cpu|); the moments (mu = 0.1 g, nu = 0.05 g^2) within 1e-5 of
    each leaf's largest magnitude in float32 (2^-8 in bf16), which holds
    the gradients; the whole update within 1e-3 in relative norm
    (``TRAIN_SMOKE_TOL``); the card's flash launches: one forward and one
    backward for each attention call of the forward.  Fails
    otherwise."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.param import leaves
    from repro_torch.training.optimizer import OptHyper, tree_map
    from repro_torch.training.step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config(arch).smoke(), param_dtype="float32",
                              **TRAIN_SMOKE[arch])
    cpu = Model(cfg, device="cpu").init(seed=0)
    p0 = {n: p.detach().clone() for n, p in leaves(cpu.params)}
    card = Model(cfg, device=dev).load_params(
        tree_map(lambda t: t.detach().clone(), cpu.params))
    batch = smoke_batch(cfg)
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        state = init_train_state(model)
        step = make_train_step(model, OptHyper(lr=1e-3))
        kernels.reset_launches()
        state, metrics = step(state, batch)
        if name == "card":
            torch.cuda.synchronize()
        out[name] = (state, metrics, kernels.launch_counts())
    (s_c, m_c, _), (s_g, m_g, counts) = out["cpu"], out["card"]
    tol = TRAIN_SMOKE_TOL
    met = max(abs(float(m_g[k]) - float(m_c[k])) / max(1.0, abs(float(
        m_c[k]))) for k in m_c)
    mom = 0.0
    for key in ("mu", "nu"):
        ref = dict(leaves(s_c["opt"][key]))
        for n, t in leaves(s_g["opt"][key]):
            w = ref[n].float()
            mom = max(mom, float((t.cpu().float() - w).abs().max())
                      / max(float(w.abs().max()), 1e-30))
    ref = dict(leaves(s_c["params"]))
    diff = want = 0.0
    for n, t in leaves(s_g["params"]):
        d_cpu = ref[n].detach() - p0[n]
        diff += float((t.detach().cpu() - p0[n] - d_cpu).square().sum())
        want += float(d_cpu.square().sum())
    upd = (diff / max(want, 1e-60)) ** 0.5
    calls = flash_layers(cfg) + (1 if cfg.mtp_depth else 0)
    say(f"train smoke {arch}", widened=json.dumps(TRAIN_SMOKE[arch]),
        loss=float(m_g["loss"]), metric_err=met, moment_err=mom,
        update_rel_err=upd, flash_fwd=counts["flash_attention"],
        flash_bwd=counts["flash_attention_bwd"], expected=calls)
    check(set(m_g) == set(m_c) and met <= tol["metrics"],
          f"train smoke {arch}: metrics differ ({met})")
    check(mom <= tol["moments"][cfg.opt_dtype],
          f"train smoke {arch}: moments differ ({mom})")
    check(upd <= tol["update"], f"train smoke {arch}: updates differ ({upd})")
    check(counts["flash_attention"] == calls
          and counts["flash_attention_bwd"] == calls,
          f"train smoke {arch}: {counts['flash_attention']} forward and "
          f"{counts['flash_attention_bwd']} backward flash launches, "
          f"expected {calls} each")
    return {"metric_err": met, "moment_err": mom, "update_rel_err": upd,
            "cuda_cores_bwd": counts["flash_attention_bwd"]
            - counts["flash_attention_bwd_tc"]}


def phase_train_smoke(dev):
    """Phase 44: every arch's widened smoke step, card against CPU; the
    float32 backward calls, all on the CUDA-core kernels."""
    from repro_torch.configs import ARCH_IDS
    return {arch: train_smoke_step(arch, dev) for arch in ARCH_IDS}


def train_model(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(get_config(TRAIN_ARCH), device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    cfg = model.cfg
    say("train model", arch=TRAIN_ARCH, params=model.param_count(),
        dtype=cfg.param_dtype, opt_dtype=cfg.opt_dtype, remat=cfg.remat,
        init_s=time.perf_counter() - t0, layers=cfg.num_layers)
    return model


def train_batch(cfg, dev, B: int, S: int, seed: int = 45):
    """B rows of S + 1 tokens from a seeded generator on the card: tokens
    the first S, labels the next-token shift."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(1, cfg.vocab_size, (B, S + 1), generator=g,
                      device=dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def prefill_ce(model, batch) -> float:
    """The mean next-token cross-entropy of ``batch`` from
    ``prefill_logits`` (no grad): the training loss's ce by another
    route."""
    import torch
    logits = model.prefill_logits(batch)
    lab = model._tokens(batch["labels"])
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lab[..., None])[..., 0]
    ce = float((logz - tgt).mean())
    del logits, logz, tgt
    torch.cuda.empty_cache()
    return ce


def phase_train(model, dev, sizes=TRAIN):
    """Phase 45: ``TRAIN["steps"]`` AdamW steps of the full-width model on
    B x S tokens in microbatches, through ``make_train_step``.  The first
    holds the set-up; its ce is held against ``prefill_ce`` of the last
    microbatch (the metric is the last microbatch's) at ``TRAIN_CE_TOL``.
    Step 2 is timed with the launch counts reset around it; step 3 runs
    under the profiler (its device busy time against step 2's wall gives
    the idle share: the profiler itself slows the host ~4x).  Checks: finite loss and grad norm, every
    parameter changed and finite."""
    import torch
    from repro_torch import kernels
    from repro_torch.models.param import leaves
    from repro_torch.training.optimizer import OptHyper
    from repro_torch.training.step import init_train_state, make_train_step
    cfg = model.cfg
    B, S, mb = sizes["B"], sizes["S"], sizes["microbatches"]
    batch = train_batch(cfg, dev, B, S)
    last = {k: v[B - B // mb:] for k, v in batch.items()}
    ce_prefill = prefill_ce(model, last)
    state = init_train_state(model)
    p0 = {n: p.detach().clone() for n, p in leaves(state["params"])}
    step = make_train_step(model, OptHyper(**TRAIN_HYPER), microbatches=mb)
    n_params = sum(p.numel() for p in p0.values())
    state_bytes = n_params * (2 + 4) + sum(
        t.numel() * t.element_size() for key in ("mu", "nu")
        for _, t in leaves(state["opt"][key]))
    logits_bytes = B // mb * S * cfg.padded_vocab * 4
    flop = 8 * n_params * B * S
    torch.cuda.reset_peak_memory_stats()
    walls, metrics, counts = [], [], None
    for i in range(sizes["steps"]):
        if i == 1:
            kernels.reset_launches()
        t0 = time.perf_counter()
        if i == 2:
            busy, ops, _, ours, top = device_profile(
                lambda: metrics.append(step(state, batch)[1]))
        else:
            state, m = step(state, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 1:
            counts = kernels.launch_counts()
        m = metrics[-1]
        check(bool(torch.isfinite(m["loss"])) and bool(
            torch.isfinite(m["grad_norm"])),
            f"train step {i + 1}: loss {float(m['loss'])} grad norm "
            f"{float(m['grad_norm'])}")
        say(f"train step {i + 1}", wall_ms=walls[-1] * 1e3,
            **{k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    ce0 = float(metrics[0]["ce"])
    ce_err = abs(ce0 - ce_prefill) / abs(ce_prefill)
    check(ce_err <= TRAIN_CE_TOL, f"train: the first step's ce {ce0} is "
                                  f"{ce_err} from prefill's {ce_prefill}")
    unchanged = [n for n, p in leaves(state["params"])
                 if torch.equal(p.detach(), p0[n])]
    finite = all(bool(torch.isfinite(p.detach().float()).all())
                 for _, p in leaves(state["params"]))
    check(not unchanged, f"train: parameters unchanged after "
                         f"{sizes['steps']} steps: {unchanged}")
    check(finite, "train: non-finite parameters")
    # a forward launch each layer and microbatch, again in the backward's
    # recompute under remat; a backward launch each
    layers = cfg.num_layers
    want = {"flash_attention": layers * mb * (1 if cfg.remat == "none"
                                              else 2),
            "flash_attention_bwd": layers * mb,
            "flash_attention_bwd_tc": layers * mb}
    check(all(counts[k] == n for k, n in want.items()),
          f"train: flash launches a step {counts}, expected {want}")
    step_s = walls[1]
    nums = dict(B=B, S=S, microbatches=mb, hyper=json.dumps(TRAIN_HYPER),
                step_ms=step_s * 1e3, step_ms_profiled=walls[2] * 1e3,
                first_step_ms=walls[0] * 1e3,
                tokens_per_s=B * S / step_s, params=n_params,
                flop_per_step=flop, flop_share=flop / step_s / 989e12,
                peak_gib=peak / 2**30, state_gib=state_bytes / 2**30,
                microbatch_logits_gib=logits_bytes / 2**30,
                ce_first=ce0, ce_prefill=ce_prefill, ce_rel_err=ce_err,
                flash_fwd_launches=counts["flash_attention"],
                flash_bwd_launches=counts["flash_attention_bwd"],
                flash_bwd_tc_launches=counts["flash_attention_bwd_tc"],
                device_busy_ms=busy, idle_share=1.0 - busy / 1e3 / step_s,
                device_ops=ops, kernels=json.dumps(ours),
                top=json.dumps(top))
    say("train", **nums)
    opt = state["opt"]
    del p0, state, step
    torch.cuda.empty_cache()
    return counts, nums, opt


def phase_train_compressed(model, dev, sizes=TRAIN):
    """Phase 46: one more step of phase 45's model with int8 gradient
    compression and error feedback (a fresh optimizer state)."""
    import torch
    from repro_torch.models.param import leaves
    from repro_torch.training.optimizer import OptHyper
    from repro_torch.training.step import init_train_state, make_train_step
    B, S, mb = sizes["B"], sizes["S"], sizes["microbatches"]
    batch = train_batch(model.cfg, dev, B, S, seed=46)
    state = init_train_state(model, compress=True)
    step = make_train_step(model, OptHyper(**TRAIN_HYPER), microbatches=mb,
                           compress=True)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = bool(torch.isfinite(m["loss"])) and all(
        bool(torch.isfinite(p.detach().float()).all())
        for _, p in leaves(state["params"]))
    ef = sum(float(t.abs().sum()) for _, t in leaves(state["opt"]["ef"]))
    say("train compressed", step_ms=wall * 1e3, ef_abs_sum=ef,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        **{k: float(v) for k, v in m.items()})
    check(finite and ef > 0, "train compressed: non-finite loss or "
                             "parameters, or no residual kept")
    del state, step
    torch.cuda.empty_cache()
    return wall * 1e3


LAUNCHER_ARCH = "smollm-135m"     # 30 layers, d_model 576, 9/3 heads of 64
# cut from SHAPES["train_4k"] (256 x 4,096) to 8 x 2,048 (SmolLM's context)
LAUNCHER = dict(batch=8, seq=2048, steps=14, ckpt_every=5, fail_at=9)
LAUNCHER_TIMED = slice(2, 14)     # (a)'s steps whose median is the step ms
SELECTION_TOL = 1e-6              # objective, relative: phase "parity"'s bar
# the kernels of phase 47's path: the train step's flash pair and the
# package query of --select-data
LAUNCHER_KERNELS = ("flash_attention", "pricing", "bfrt_histogram",
                    "segment_stats", "dlv_scan", "lp_batch")


def launcher_args(dev, ckpt_dir=None, fail_at=None) -> list:
    c = LAUNCHER
    args = ["--arch", LAUNCHER_ARCH, "--steps", str(c["steps"]),
            "--batch", str(c["batch"]), "--seq", str(c["seq"]),
            "--select-data", "--log-every", "5", "--device", str(dev)]
    if ckpt_dir is not None:
        args += ["--ckpt-dir", str(ckpt_dir), "--ckpt-every",
                 str(c["ckpt_every"])]
    if fail_at is not None:
        args += ["--fail-at", str(fail_at)]
    return args


@contextlib.contextmanager
def kernel_order_stats():
    """The DLV build's segment stats in the card kernel's order of
    additions (``segment_stats_tiled_plain``, its output bit for bit) in
    place of the plain version's ``index_add_`` while the block runs."""
    from repro_torch.core import dlv
    from repro_torch.kernels import segstats
    saved = dlv.segment_stats
    dlv.segment_stats = segstats.segment_stats_tiled_plain
    try:
        yield
    finally:
        dlv.segment_stats = saved


def selection_hold(sel) -> dict:
    """Phase 47's selection (run on the card by the launcher) against the
    port's own ``select_training_docs(device="cpu")`` on the same corpus.

    The DLV build picks each partition's split attribute by the largest
    variance; on an all-web partition ``tokens`` and ``tok_web`` hold the
    same values, so their variances tie exactly and the order of the
    sums breaks the tie.  The card's segment stats add in another order
    than the CPU's ``index_add_``, so the two builds may differ there.
    The card is held to the CPU run with the kernel's order
    (``kernel_order_stats``): the same layer sizes and the objective
    within ``SELECTION_TOL``; the plain CPU run's objective is printed
    beside it."""
    from repro_torch.data.selection import select_training_docs
    from repro_torch.launch.train import SELECT_KW, selection_problem
    corpus, q = selection_problem()
    check(sel.feasible and q.check_package(corpus, sel.idx, sel.mult),
          "train launcher: the selection is not a feasible, valid package")
    kw = dict(device="cpu", **SELECT_KW)
    t0 = time.perf_counter()
    with kernel_order_stats():
        mirror = select_training_docs(corpus, q, **kw)
    mirror_s = time.perf_counter() - t0
    plain = select_training_docs(corpus, q, **kw)
    rel = abs(sel.obj - mirror.obj) / max(1.0, abs(mirror.obj))
    check(sel.ps_stats.layer_sizes == mirror.ps_stats.layer_sizes,
          f"train launcher: the card's layers {sel.ps_stats.layer_sizes} "
          f"vs the CPU's in the kernel's order "
          f"{mirror.ps_stats.layer_sizes}")
    check(rel <= SELECTION_TOL, f"train launcher: the selection's objective "
                                f"{sel.obj} vs the CPU's {mirror.obj}")
    return dict(selection_obj=sel.obj, selection_docs=len(sel.idx),
                selection_package_size=int(sel.mult.sum()),
                selection_layers=json.dumps(sel.ps_stats.layer_sizes),
                selection_lp_iters=sel.ps_stats.lp_iters,
                selection_cpu_kernel_order_obj=mirror.obj,
                selection_rel_diff=rel, selection_cpu_s=mirror_s,
                selection_cpu_plain_obj=plain.obj,
                selection_cpu_plain_layers=json.dumps(
                    plain.ps_stats.layer_sizes),
                selection_cpu_plain_rel_diff=abs(sel.obj - plain.obj)
                / max(1.0, abs(plain.obj)))


def first_difference(got, want) -> tuple:
    """(largest |difference|, first index that differs or None)."""
    diff = [abs(a - b) for a, b in zip(got, want)]
    first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
    return (max(diff) if diff else 0.0), first


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def launcher_profile(model, dev) -> dict:
    """Where a launcher step's time goes, on (a)'s trained model: the
    host seconds of one ``global_batch`` (the pipeline's per-token loop,
    inside the launcher's step time), then one more step of
    ``make_train_step`` (the launcher's schedule, fresh moments) on that
    batch under the profiler: device busy ms, ops and top device ops."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.training.optimizer import OptHyper
    from repro_torch.training.step import init_train_state, make_train_step
    c = LAUNCHER
    data = SyntheticTokens(DataConfig(model.cfg.vocab_size, c["seq"],
                                      c["batch"]))
    t0 = time.perf_counter()
    host = data.global_batch(c["steps"])
    pipeline_s = time.perf_counter() - t0
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    state = init_train_state(model)
    step = make_train_step(model, OptHyper(
        lr=3e-3, warmup_steps=max(c["steps"] // 10, 5),
        total_steps=c["steps"]))
    busy, ops, reads, ours, top = device_profile(lambda: step(state, batch))
    del state, step
    return dict(pipeline_ms=pipeline_s * 1e3, device_busy_ms=busy,
                device_ops=ops, device_to_host=reads,
                kernels=json.dumps(ours), top=json.dumps(top))


def phase_train_launcher(dev):
    """Phase 47: ``repro_torch.launch.train.main`` on the card at
    smollm-135m, full width, bf16, remat "full", ``LAUNCHER`` (8 x 2,048
    tokens, 14 steps, --select-data), three runs in one process: (a)
    without a checkpoint, launch counts reset around it; (b) with
    ``--ckpt-dir`` every 5 steps and ``--fail-at 9``, whose exit code must
    be 42; (c) the same flags without ``--fail-at``, which resumes from
    step 10.  (b)'s losses equal (a)'s first ten bit for bit (two
    uninterrupted runs), (c)'s equal (a)'s from step 10 on; every loss is
    finite and the last below the first; the selection is held by
    ``selection_hold``; ``launcher_profile`` profiles one more step.
    Returns (a)'s launch counts."""
    import torch
    from repro_torch import kernels
    from repro_torch.launch import train
    c = LAUNCHER
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="launcher_ckpt_",
                                 dir=ROOT / "build"))
    try:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        sa = {}
        a = train.main(launcher_args(dev), stats=sa)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_params = sa["model"].param_count()
        layers = sa["model"].cfg.num_layers
        prof = launcher_profile(sa.pop("model"), dev)
        sb = {}
        try:
            train.main(launcher_args(dev, root, c["fail_at"]), stats=sb)
            code = 0
        except SystemExit as e:
            code = e.code
        check(code == 42, f"train launcher: run (b) exited {code}, not 42 "
                          f"after --fail-at {c['fail_at']}")
        ckpt_bytes = dir_bytes(sb["saves"][-1][2])
        del sb["model"]
        sc = {}
        resumed = train.main(launcher_args(dev, root), stats=sc)
        del sc["model"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    b = [l for _, l, _ in sb["steps"]]
    split = c["fail_at"] + 1
    two_err, two_first = first_difference(b, a[:split])
    check(len(b) == split and two_first is None,
          f"train launcher: two uninterrupted runs differ from step "
          f"{two_first} (largest {two_err}): an op of the train path is not "
          f"deterministic")
    check(sc["start"] == split, f"train launcher: resumed at "
                                f"{sc['start']}, not {split}")
    res_err, res_first = first_difference(resumed, a[split:])
    check(len(resumed) == c["steps"] - split and res_first is None,
          f"train launcher: resumed losses differ from step "
          f"{res_first} (largest {res_err})")
    check(all(np.isfinite(a + b + resumed)) and a[-1] < a[0],
          f"train launcher: losses {a}")
    per = {k: counts[k] / c["steps"] for k in (
        "flash_attention", "flash_attention_bwd", "flash_attention_bwd_tc")}
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "flash_attention_bwd_tc": layers}
    check(per == want, f"train launcher: flash launches a step {per}, "
                       f"expected {want}")
    for name in ("pricing", "bfrt_histogram", "segment_stats", "dlv_scan"):
        check(counts[name] > 0, f"train launcher: the selection never "
                                f"launched {name}")
    step_s = float(np.median([t for _, _, t in sa["steps"][LAUNCHER_TIMED]]))
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / 1e3 / step_s
    tokens = c["batch"] * c["seq"]
    flop = 8 * n_params * tokens
    saves = sb["saves"] + sc["saves"]
    nums = dict(arch=LAUNCHER_ARCH, params=n_params, batch=c["batch"],
                seq=c["seq"], steps=c["steps"], step_ms=step_s * 1e3,
                step_ms_all=json.dumps([t * 1e3 for _, _, t in sa["steps"]]),
                tokens_per_s=tokens / step_s, flop_per_step=flop,
                flop_share=flop / step_s / 989e12,
                peak_gib=(peak - base) / 2**30,
                resident_before_gib=base / 2**30,
                loss_first=a[0], loss_last=a[-1],
                two_runs_max_diff=two_err, resumed_max_diff=res_err,
                resumed_from=sc["start"], exit_b=code,
                selection_s=sa["selection_s"],
                checkpoint_gb=ckpt_bytes / 1e9,
                save_s=json.dumps([[st, t] for st, t, _ in saves]),
                restore_s=sc["restore_s"],
                flash_fwd_launches_per_step=per["flash_attention"],
                flash_bwd_launches_per_step=per["flash_attention_bwd"],
                flash_bwd_tc_launches_per_step=per[
                    "flash_attention_bwd_tc"],
                launches=json.dumps({k: counts[k]
                                     for k in LAUNCHER_KERNELS}),
                **selection_hold(sa["selection"]))
    say("train launcher", **nums)
    say("profile train launcher step", **prof)
    return counts


def phase_train_checkpoint(model, opt):
    """Phase 48: phase 45's qwen2-1.5b train state (the model's bf16
    parameters, after phase 46's step, and phase 45's float32 moments and
    step) saved by ``CheckpointManager(keep_last_k=1)`` under a temp dir
    in ``build/``, restored onto the card, and every leaf held equal
    (``torch.equal``, dtype and device).  Not run, and said so, where the
    disk holds less than twice the state."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.param import leaves
    state = {"params": model.params, "opt": opt}
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves(state))
    (ROOT / "build").mkdir(exist_ok=True)
    free = free_gb(ROOT / "build")
    if free * 1e9 < 2 * nbytes:
        say("train checkpoint", state_gb=nbytes / 1e9,
            result=f"not run: {free} GB free")
        return
    root = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    try:
        mgr = CheckpointManager(root, keep_last_k=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(int(opt["step"]), state)
        save_s = time.perf_counter() - t0
        on_disk = dir_bytes(path)
        t0 = time.perf_counter()
        out = mgr.restore(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = dict(leaves(out))
        bad = [n for n, t in leaves(state)
               if got[n].dtype != t.dtype or got[n].device != t.device
               or not torch.equal(got[n], t.detach())]
        check(not bad, f"train checkpoint: leaves differ after the round "
                       f"trip: {bad[:5]}")
        say("train checkpoint", arch=model.cfg.name, free_gb=free,
            state_gb=nbytes / 1e9, on_disk_gb=on_disk / 1e9,
            leaves=len(got), save_s=save_s, restore_s=restore_s,
            save_gb_per_s=nbytes / 1e9 / save_s,
            restore_gb_per_s=nbytes / 1e9 / restore_s, equal=True)
        del out, got
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def train_phases(phase, dev):
    """Phases 42-48; the kernels line's five backward entries: D and the
    tensor-core kernels launched by phase 45's steps (timed at the train
    cell in phase 43), the CUDA-core ones by phase 44's float32 steps
    (timed in phase 43 at the shape of phase 44's qwen2-1.5b call).
    Returns (those entries, phase 47's launch counts)."""
    import torch
    err42 = phase("flash bwd agreement", phase_flash_bwd_agreement, dev)
    err43, whole, per = phase("flash bwd time", phase_flash_bwd_time, dev)
    smoke = phase("train smoke", phase_train_smoke, dev)
    model = phase("train model", train_model, dev)
    counts, nums, opt = phase("train", phase_train, model, dev)
    phase("train compressed", phase_train_compressed, model, dev)
    launcher = phase("train launcher", phase_train_launcher, dev)
    phase("train checkpoint", phase_train_checkpoint, model, opt)
    del model, opt
    torch.cuda.empty_cache()
    smoke_cc = sum(r["cuda_cores_bwd"] for r in smoke.values())
    check(smoke_cc > 0, "train smoke: no backward on the CUDA-core kernels")
    entries = []
    for name in BWD_KERNELS:
        step = counts["flash_attention_bwd_tc"] if name in BWD_TC \
            else 0 if name in BWD_CUDA_CORES \
            else counts["flash_attention_bwd"]
        paths = {"train step": step}
        if name in BWD_CUDA_CORES:
            paths["train smoke"] = smoke_cc
        else:
            paths["train launcher"] = launcher[
                "flash_attention_bwd_tc" if name in BWD_TC
                else "flash_attention_bwd"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
            "replaces": BWD_REPLACES,
            "launches": smoke_cc if name in BWD_CUDA_CORES else step,
            "launches_by_path": paths,
            "max_abs_err": max(err42, err43),
            "tolerance": "relative norm of dQ, dK, dV against "
                         "flash_attention_bwd_plain: float32 1e-5, bf16 "
                         "2^-8 (one rounding to bf16 each); the forward's "
                         "LSE 1e-5 of max(1, |plain|); bf16 reruns "
                         "bit-identical",
            **per[name],
            **({} if name in BWD_CUDA_CORES else {"whole_backward": whole}),
            "train_step": {k: nums[k] for k in (
                "step_ms", "tokens_per_s", "flop_share", "peak_gib")}})
    return entries, launcher


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    # float32 products in full float32 (the agreement bar assumes it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    build_s = _build.build_all()
    card = smi()
    say("build", seconds=build_s, sources=len(_build.SOURCES),
        card=json.dumps(card),
        nvcc_s=json.dumps(dict(sorted(_build.BUILD_SECONDS.items()))))
    print(card, flush=True)
    ptxas_report(_build)
    for name in ("dlv_scan", "bfrt", "segstats", "split_tree",
                 "flash_attn_bwd"):
        say(f"ptxas {name}", report=json.dumps(
            [ln.strip() for ln in _build.build_log(name).splitlines()
             if re.search(r"entry function|registers|spill", ln)]))

    phase_s = {"build": build_s}

    def phase(label, fn, *args):
        """``fn(*args)``, its seconds (to the card's last op) kept under
        ``label``."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_s[label] = time.perf_counter() - t0
        return out

    fixed = {}
    for name, fn in (("pricing", kernel_pricing),
                     ("bfrt_histogram", kernel_bfrt),
                     ("segment_stats", kernel_segstats),
                     ("dlv_scan", kernel_dlv_scan),
                     ("flash_attention", kernel_flash)):
        fixed[name] = phase(f"kernel {name}", fn, dev)

    parity_lp = phase("parity", phase_parity)
    counts, inputs, eng = phase("full", phase_full)
    phase("analysis", phase_analysis, eng, inputs[1])
    main_nums = phase("main-path inputs", phase_main_inputs, counts,
                      *inputs)
    lp = phase("lp batch", phase_lp_batch, eng, *inputs)
    fixed["split_tree_descent"] = phase("kernel split_tree_descent",
                                        kernel_split_tree, eng, dev)
    # phase "dist" builds the full cell again through the mesh: its
    # table, query and the layers of this build (before the append)
    full_layers = [(ly.part.gid.copy(), ly.part.reps.copy())
                   for ly in eng.hierarchy.layers[1:]]
    full_cell = (inputs[0], inputs[1], inputs[3], full_layers)
    append_n, append_err, append_nums, flight_n = phase(
        "cache", phase_cache, eng, inputs[0], dev)
    del inputs, eng
    torch.cuda.empty_cache()
    X_heap = heap_table(HEAP["rows"])
    heap_n, (heap_err, heap_nums) = phase("heap", phase_heap, X_heap, dev)
    seed_n, seed_main, seed_fixed = phase("heap seed", phase_heap_seed,
                                          X_heap, dev)
    del X_heap
    # the streamed phases' data and spill scratch live in STREAMED_DIR
    STREAMED_DIR.mkdir(parents=True, exist_ok=True)
    saved_tmp, tempfile.tempdir = tempfile.tempdir, str(STREAMED_DIR)
    try:
        phase("faults", phase_faults)
        streamed_counts, calls, first = phase("streamed", phase_streamed)
        streamed_errs = phase("streamed main-path inputs",
                              phase_streamed_inputs, calls, first)
        del calls
        torch.cuda.empty_cache()
        phase("streamed parity", phase_streamed_parity)
    finally:
        tempfile.tempdir = saved_tmp
        shutil.rmtree(STREAMED_DIR, ignore_errors=True)
    phase("sketchrefine", phase_sketchrefine)

    model = phase("lm model", lm_model, dev)
    lm_counts, batch = phase("lm prefill", phase_lm_prefill, model)
    phase("lm agreement", phase_lm_agreement, model)
    serve_lp = phase("lm serve", phase_lm_serve, model)
    lm_main = phase("lm main-path inputs", phase_lm_main_inputs, model,
                    batch, lm_counts)
    layout_counts = phase("layout", phase_layout, model, batch, dev)
    del model, batch
    torch.cuda.empty_cache()
    dist_counts, dist_nums = phase("dist", phase_dist, *full_cell)
    del full_cell

    moe_counts, moe_main, moe_serve_lp = moe_phases(phase, dev)
    mla_counts, mla_main, mla_serve_lp = mla_phases(phase, dev)
    ssm_counts, ssm_serve_lp = ssm_phases(phase, dev)
    hybrid_counts, hybrid_flash, hybrid_serve_lp = hybrid_phases(phase, dev)
    encdec_counts, encdec_flash, encdec_serve_lp = encdec_phases(phase, dev)
    vlm_counts, vlm_flash, vlm_serve_lp = vlm_phases(phase, dev)
    bwd_entries, launcher_counts = train_phases(phase, dev)
    say("phase seconds", **{k.replace(" ", "_"): v
                            for k, v in phase_s.items()})

    # flash's main paths: the seven prefills (mamba2's launches none),
    # numbers at the largest call (MLA's, at (192, 128))
    prefills = {"lm prefill": lm_counts, "layout prefill": layout_counts,
                "moe prefill": moe_counts,
                "mla prefill": mla_counts, "ssm prefill": ssm_counts,
                "hybrid prefill": hybrid_counts,
                "encdec prefill": encdec_counts, "vlm prefill": vlm_counts}
    counts["flash_attention"] = sum(c["flash_attention"]
                                    for c in prefills.values())
    slice_flash = {**{f"encdec_{k}_call": v for k, v in
                      encdec_flash.items()},
                   **{f"vlm_{k}_call": v for k, v in vlm_flash.items()}}
    main_nums["flash_attention"] = (
        max([lm_main[0], moe_main[0], mla_main[0], hybrid_flash[0]]
            + [v[0] for v in slice_flash.values()]), mla_main[1])

    # the batched LP engine: its main path is phase "lp batch"'s B&B;
    # its launches on every other path that batches LP flights
    fixed["lp_batch"] = (lp["err"], lp["fixed"])
    serves = {"lm serve": serve_lp, "moe serve": moe_serve_lp,
              "mla serve": mla_serve_lp, "ssm serve": ssm_serve_lp,
              "hybrid serve": hybrid_serve_lp,
              "encdec serve": encdec_serve_lp, "vlm serve": vlm_serve_lp}
    main_nums["lp_batch"] = (max([lp["err"], parity_lp[1]]
                                 + [v[1] for v in serves.values()]),
                             lp["main"])
    counts["lp_batch"] = lp["launches"]
    lp_paths = {**lp["paths"], "parity W=8": parity_lp[0],
                **{k: v[0] for k, v in serves.items()}}
    # the descent's main path is the append; the build and the solves
    # (phase "full", the cache flight) never descend
    main_nums["split_tree_descent"] = (float(append_err), append_nums)
    descent_paths = {"append": append_n,
                     "full": counts["split_tree_descent"],
                     "cache flight": flight_n,
                     "streamed": streamed_counts["split_tree_descent"]}
    counts["split_tree_descent"] = append_n
    # the seed scan's main path is phase "heap seed"'s build, the only one
    # that scans through it
    fixed["dlv_scan_seed"] = (0.0, seed_fixed)
    main_nums["dlv_scan_seed"] = (0.0, seed_main)
    seed_paths = {"heap seed": seed_n, "full": counts["dlv_scan_seed"],
                  "streamed": streamed_counts["dlv_scan_seed"]}
    counts["dlv_scan_seed"] = seed_n

    entries = []
    for name, (source, replaces) in SOURCES.items():
        err_f, nums_f = fixed[name]
        err_m, nums_m = main_nums[name]
        paths = {"full": counts[name], "streamed": streamed_counts[name]} \
            if name in PQ_KERNELS else lp_paths if name == "lp_batch" \
            else descent_paths if name == "split_tree_descent" \
            else seed_paths if name == "dlv_scan_seed" \
            else {p: c[name] for p, c in prefills.items()}
        extra = {}
        if name == "dlv_scan":
            paths["heap"] = heap_n
            err_m = max(err_m, heap_err)
            extra["heap_largest_call"] = heap_nums
        if name == "flash_attention":
            from repro_torch.kernels.attention import HEAD_DIM_PAIRS
            extra.update(head_dim_pairs=[list(p) for p in HEAD_DIM_PAIRS],
                         modes=["causal", "window", "full", "cross",
                                "prefix"],
                         lm_prefill_largest_call=lm_main[1],
                         moe_prefill_largest_call=moe_main[1],
                         hybrid_prefill_call=hybrid_flash[1],
                         **{k: v[1] for k, v in slice_flash.items()})
        if name in LAUNCHER_KERNELS:
            paths["train launcher"] = launcher_counts[name]
        if name in dist_nums:
            paths.update({p: n[name] for p, n in dist_counts.items()})
            err_m = max(err_m, dist_nums[name][0])
            extra["dist_largest_call"] = dist_nums[name][1]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "launches_by_path": paths,
                        "max_abs_err": max(err_f, err_m,
                                           streamed_errs.get(name, 0.0)),
                        "tolerance": TOLERANCE[name], **nums_m,
                        "fixed_shape": nums_f, **extra})
    entries += bwd_entries
    say("done", seconds=time.perf_counter() - t_all)
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
