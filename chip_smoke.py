#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--profile]

Needs one CUDA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; exits non-zero, printing no result, without them or
outside a checkout of the repository. Phases, each printed as a JSON line
(with ``at_s``, the script's seconds when the phase ended):

1. ``env``     — torch and CUDA versions, the card.
2. ``build``   — nvcc builds every kernel source of the port (seconds, and
   ptxas' register/shared-memory report).
3. ``kernels`` — every kernel against its plain PyTorch version on the card,
   at the main path's shapes (eval S=4,400 and train S=600 seeds over
   N=9,000 nodes, K=10, H=2, D=50, d_time=100, d_edge=172, E=157,474) and
   on degenerate inputs (negative seeds, empty and all-masked rows,
   repeated ids, K = 1 and 20, S = 131, each bias group alone and none,
   slot times ~2.59e6 s before the seed's), with times (CUDA events, median
   of repeats; device µs per call and per launch of each of the kernels'
   launches by ``torch.profiler``) and the workspace a call allocates (the
   allocator's count against ``kernel.workspace_bytes``): K1 and K1w
   forward; K2, the backward, gradient by gradient, and a second K2 run
   bit-equal to the first in every gradient but the two tables (which add
   with float atomics).
4. ``slice``   — inference: ``tg.Experiment`` on full-scale synthetic
   ``wikipedia`` with 1-layer TGAT over the device recency sampler,
   ``compile(device="cuda").evaluate("val")`` through the kernel (launch
   count = val batches), then the same pipeline with ``fused="ref"``: MRR
   within 1e-4 and a bit-equal sampler state.
5. ``train``   — training: the first train steps from the same parameters,
   kernels against the plain version (the loss, and K1 and K2 on each
   step's own layer inputs and cotangent; whole-model gradients reported);
   then
   ``train_epoch()`` through K1 and K2 (each launched once per train batch,
   552 at full scale) and val MRR after it; a checkpoint save and restore
   on the card (bit-equal parameters, optimizer and sampler state); the same
   epoch with ``fused="ref"`` from the same initial state (mean loss and val
   MRR within the stated tolerances, bit-equal sampler state). Epoch
   seconds and ms per step of each. Last, the
   ported ``PrefetchLoader`` (off the main path) against the calling
   thread's batches, bit for bit, with a train step on each batch.
6. ``dtdg_kernels`` — K4 (the segment sum) against its plain version on the
   card at the DTDG path's shapes (the largest hourly snapshot, E = 256
   ids, and the largest daily one, E = 2,048, over G = 9,000 nodes at
   widths D = 1 and 64) and on degenerate inputs (every id equal, every id
   dropped, ids out of range, E = 1 and 0, D = 33, five segments, 5,000
   ids, sorted ids, a 2,000-edge padding run, one segment), every case's
   sums bit-equal to an edge-order float32 loop on the host, with times of
   the kernel, its plain version and ``index_add_``, and the bound.
7. ``dtdg``    — the snapshot slice: ``tg.Experiment`` with
   ``DataSpec("wikipedia", discretization="h")`` and GCLSTM (``d_embed``
   64): the ``SnapshotTensor`` built on the card, bit-equal to the CPU's;
   ``evaluate("val")`` through K4 (16 launches per snapshot, warm steps
   included) and with ``mode="ref"``; the first train steps held step by
   step (loss, every gradient, the carried state); ``train_epoch()``
   through K4 and val MRR after it; a mid-epoch checkpoint with
   ``chunk_size``, resumed to the uninterrupted epoch's bits; the plain
   epoch; GCN and T-GCN ``evaluate("val")`` against their plain versions.

8. ``classic_kernels`` — K3 (masked seed -> K-neighbor attention over
   pre-gathered keys and values, the classic path's core) and K3b (its
   gradient, one launch: dq, dk, dv) against their plain versions at the
   classic path's shapes (train S = 600 and eval S = 4,400, K = 10, H = 2,
   D = 50): K3 against ``temporal_attention_ref``, K3b gradient by gradient
   against plain autograd and ``temporal_attention_bwd_ref``, exact zeros
   on masked slots and empty rows, a second launch of each bitwise, each
   call's launch plan equal to the CUDA source's; times of both, their
   plain versions and ``scaled_dot_product_attention`` (forward, and
   forward + backward for K3b) over the rows with a valid slot, device µs,
   the bounds and shares; the gradient through ``_TemporalAttentionFn``
   (K3b launched) against plain autograd; degenerate inputs through both
   (every slot masked, rows without a valid slot, one valid slot, K = 1,
   17 and 300 with rows whose first chunk is all masked, S = 1 and 0, D =
   33 and 128, an offset view on the scalar path, bfloat16 at D = 50 and 64).
9. ``host``    — ``examples/quickstart.py``'s experiment as written (the host
   ``RecencySampler``, the classic path) at full scale:
   ``evaluate("val")`` through K3 (one launch per val batch, no K3b) and
   with the plain version; the first train steps held step by step (K3 and
   K3b on each step's own inputs); one ``train_epoch()`` through K3 and K3b
   (one launch each per train batch) and the plain epoch from the same
   start (the sampler's state after both bit-equal); the host and device
   samplers' neighborhoods bit-equal batch by batch.
10. ``tgn``    — TGN at full width (``d_model``, ``d_memory``, ``d_time`` 100,
   2 heads, k = 10) on the device sampler (K1, K2) and on the host sampler
   (K3, K3b): ``evaluate("val")`` against the plain version (MRR, memory and
   ``last_update``), step parity with exactly-zero GRU gradients, one
   ``train_epoch()`` with its launch counts, a checkpoint round trip with
   the model state.
11. ``tgat2``  — 2-layer TGAT, the reference's default TGAT (``ModelSpec
   ("tgat")`` with no kwargs: two layers, two hops, k = 20): first its
   kernel calls at its shapes against their plain versions (K1 in the seed
   form at S = 600 and 4,400, the hop-2 form over the frontier's 12,000 and
   88,000 queries with padded slots, empty rows and negative time deltas,
   and the per-seed form over 12,000- and 88,000-row tables; K2 at the
   train shapes with a second run bitwise; K3 at (600, 20), (12,000, 20),
   (4,400, 20) and (88,000, 20) over two 16-slot chunks, K3b at the train
   shapes; times, device µs from one profiler window, bounds, SDPA for K3
   and K3b); then on full-scale ``wikipedia``, on the device sampler (K1,
   K2) and on the host sampler (K3, K3b): ``evaluate("val")`` through the
   kernels (three launches a scored batch) and with the plain version (MRR
   within 1e-4; on the device sampler a second pass, the sampler state
   bit-equal; on the host sampler, whose hooks ``fused`` does not reach,
   the plain version scoring every batch of the kernel pass:
   ``paired_eval``), the first train steps held
   step by step (each of a step's three attention calls), one
   ``train_epoch()`` (three forward and three backward launches a batch)
   and a checkpoint round trip; the two samplers' hop-1 and hop-2
   neighborhoods bit-equal batch by batch; last ``python -m
   repro_torch.launch.train`` on the card, killed and resumed: ``tg``
   (2-layer TGAT, wikipedia at data scale 0.1) and ``dtdg`` (GCLSTM, full
   scale, killed mid-epoch), the resumed ``dtdg`` run's test MRR equal to
   the uninterrupted run's to the bit.
12. ``zoo``    — the rest of the CTDG zoo and the uniform samplers, through
   the user's entry point on full-scale ``wikipedia``, each model at its
   reference config's defaults: GraphMixer (device recency sampler, k =
   20), DyGFormer (device recency, k = 32) and TPNet (no neighbors; its
   recipe samples k = 1), each with ``evaluate("val")`` (seconds, MRR, no
   kernel of the port launched; DyGFormer's peak device memory), the first
   3 train steps on the card against the same steps on the CPU (loss
   within 1e-5 relative, every gradient within 1e-4 of its leaf's largest
   entry + 1e-7, TPNet's new state), one ``train_epoch()`` and val MRR
   after it (GraphMixer and TPNet; DyGFormer's epoch is cut for the time
   limit, ``ZOO_NO_EPOCH``) and a checkpoint round trip (TPNet's
   ``{"R", "last"}`` too); then 2-layer TGAT over
   ``SamplerSpec(kind="uniform")`` on the host and with ``device=True``:
   ``evaluate("val")`` through K3 (three launches a scored batch) and with
   the plain version (MRR within 1e-4; on the device sampler a second pass,
   the sampler's state and counter equal; on the host sampler
   ``paired_eval``), 3 train steps held step by step (K3 and K3b on each call's own
   inputs), one ``train_epoch()`` (three K3 and three K3b a batch), the
   busy share; and the two samplers against each other: the CSR bit-equal,
   over a whole val pass the hop-1 masks and every valid-prefix
   start and length (hop 1 and hop 2) bit-equal, every valid slot an event
   of its seed strictly before its query time, the prefix search's time
   over a scored batch's 88,000 hop-2 queries on each, a device epoch
   replayed after ``reset_state`` bit for bit, and a host <-> device
   ``state_dict`` interchange.

13. ``node``   — the node tasks (Table 4's configuration,
   ``benchmarks/table4_nodeprop.py``: synthetic ``genre`` at full scale,
   1,505 nodes and 1,785,839 events over 30 days, daily label windows,
   ``val_ratio`` 0, ``test_ratio`` 0.3, 16 categories, ``d_embed`` 32) and
   the device discretization (Table 5): first K4 at genre's daily capacity
   (G = 1,505, D = 1 and 32) bit-equal to the edge-order loop, and K3 and
   K3b at (2,048, 4, 2, 16) with the node-0 padding rows empty, against
   their plain versions, with times, device µs, bounds and the library
   calls; then GCN, GCLSTM and T-GCN through ``DTDGNodePipeline``: the
   labels of every pair built on the card bit-equal to the CPU's, test
   NDCG@10 through K4 and with ``mode="ref"`` (within 1e-4, or every
   swapped row a named near-tie), 3 train steps held step by step (loss,
   every gradient, the carried state), one ``train_epoch()`` with its K4
   launch count and test NDCG after it, a bit-identical checkpoint round
   trip; ``tgn`` through
   ``EventNodePipeline``: test NDCG through K3 and plain, 3 windows held
   step by step (K3 and K3b on each window's own inputs and cotangent), one
   epoch with its K3 and K3b counts, a checkpoint round trip, the node-0
   padding rows' share of the active rows; ``pf`` bit-equal to the CPU;
   last Table 5: ``discretize_device`` against ``discretize`` and
   ``discretize_naive`` at ``reduce="count"``, hourly, on full-scale
   ``wikipedia``, ``reddit`` and ``lastfm`` (integer columns and the exact
   reductions bit for bit, sums within 1e-5 relative; the int32 guard
   passing), their times and speedups, every reduction on ``wikipedia``
   and genre's daily axis.
14. ``storage`` — out-of-core storage on full-scale ``wikipedia``: the
   store written by ``MmapStore.from_data`` to a temporary directory
   (seconds, bytes on disk, ``is_intact``); the quickstart off the
   in-memory stream and off ``compile(MmapStore(path))``:
   ``evaluate("val")`` through K1 (119 launches), MRR and the sampler
   state after it bit-equal; one ``train_epoch()`` each through K1 and K2
   (552 launches each) and val MRR after it, bit-equal to the in-memory
   epoch where two in-memory epochs (this one and the train phase's) are
   bit-equal, else within EPOCH_LOSS_TOL / TRAIN_MRR_TOL (which held is
   printed), and every one of its 552 train batches bit-equal, key by
   key, to the in-memory pipeline's; the pages released once per batch
   (``storage/windows_released``), the process's RSS; ``streaming_csr``
   against the in-RAM build of both uniform samplers (bit-equal, or the
   same multiset per node where events share a ``(node, time)``); 2-layer
   TGAT over the store-built device uniform sampler: ``evaluate("val")``
   through K3 (357 launches) with the MRR of the in-memory pipeline given
   the same CSR, 3 train steps on the card held against the CPU (K3 and
   K3b counted); the store-built host uniform sampler's first 10 batches
   bit-equal to the in-memory one's; ``trace_capture`` around 5
   store-backed train steps (the trace names K1's and K2's kernels) and
   ``device_memory_gauges`` (the five gauges, ``bytes_in_use`` equal to
   ``torch.cuda.memory_allocated()``).
15. ``serve``  — the online graph service at the reference's widths (k 8,
   ``d_model`` 32, ``time_dim`` 8, ``max_batch`` 32) over wikipedia's
   9,000 nodes: 12,000 events ingested one by one (events/s) with a
   snapshot at 11,000; 2,000 link and 256 embed requests under
   ``torch.profiler`` (idle share, device ms per flush, latency p50 / p99
   per tier); the same events and requests through the service on the CPU
   in a process of its own (``serve_cpu``): sampler and EdgeBank state
   bit-equal, scores within SERVE_TOL, embeddings within SERVE_TOL of
   their largest entry, every answer from the model tier with no model
   error; 224 link requests again in flushes of 1, 7 and 32, and a fresh
   service restored from the snapshot replaying the rest with 5
   duplicates: bit-identical answers; the chaos run of
   ``tests/test_serving.py`` on the card.
16. ``lm_kernels`` — the LM serving slice's kernels against their plain
   versions on the card at its shapes (B = 4, S = 4,096, bfloat16): K5
   (flash attention) for hymba-1.5b (25 query over 5 kv heads, D = 64,
   window 1024) and qwen3-0.6b (16 over 8, D = 128, causal), K6 (the SSD
   chunk scan with groups and the final state) for hymba (H = 50, P = 64,
   N = 16), mamba2-780m (H = 48, N = 128) and hymba's 32k prefill (B = 1,
   S = 32,768); a second launch bitwise; times of each kernel, its plain
   version and, for K5, SDPA, by CUDA events and by ``torch.profiler``,
   each beside its bound (K6 also its share of the bound, each of its
   three passes' device time and the bytes of its chunk-state scratch); K5b
   (the attention gradient, LM training's) at the same two shapes: K5's
   log-sum-exp against the plain one, dq, dk and dv against the plain
   backward and against autograd of the plain forward (BF16_TOL of each
   gradient's largest entry), a second launch bitwise, its bf16 launch plan
   (TMA maps, grids, shared memory) equal to the Python mirror's, times of
   K5b, the plain backward, SDPA forward + backward and SDPA's backward
   alone (one saved forward) beside its bound, and ptxas' registers and
   spills of its bf16 kernels (none may spill); K6b (the SSD scan's
   gradient, LM training's) at hymba's and mamba2's shapes, as a train
   step calls it (on the chunk states K6 kept, which are held against
   ``ssd_chunk_states_ref``): dx, ddt, da, dB and dC against
   ``ssd_chunk_bwd_ref`` and against autograd of the float32 plain forward
   (BF16_TOL of each gradient's largest entry), a second launch bitwise,
   its time, its device time, achieved TFLOP/s and GB/s per pass (in K6's
   profiler window at the shape) and the plain backward's beside its
   bound, its scratch bytes against ``bwd_plan``'s, ptxas' registers,
   spills and ``wgmma`` serialization of its chunk-pass instances, reverse
   pass and float32 kernel (none may spill or serialize), and cases
   (``K6B_CASES``: S = 1 and 300, two groups, P 48 / N 24 and P 40 / N 20,
   steep decay, zero-dt rows, a final-state cotangent, float32 within
   ATOL), each (bf16: on K6's kept states) also bitwise on contiguous
   copies of the views;
   degenerate inputs (Sq != Skv, S = 1, S not a
   multiple of the tile or chunk, window >= S, non-causal, float32 on K5's
   and K6's CUDA-core kernels, bfloat16 on K5's tensor-core kernel at D =
   8, 48, 96 and 120, offsets and windows that are not multiples of a
   tile, one query over 4,096 keys; K6 at S = 129 and 4,095, with zero-dt
   rows, steep decay in both types, groups incl. two at N = 128, P and N
   not multiples of 16; K5b likewise (``K5B_CASES``): Sq != Skv, one
   query over 4,096 keys, S = 1,000, a window >= S, non-causal, D 96, 128
   and padded 120, float32 on its CUDA-core kernels, and at its bf16
   blocks' edges: Skv = 200 with G 5 and a window, key blocks no row sees,
   Sq = 200 at D 128; keys no row sees get exactly zero dk and dv, and
   the bhsd layout's call the same bits);
   ``profiler_clock`` before the phase.
17. ``lm``     — first the decode attentions' products (``layers.
   _attend_cache``, bf16 GEMMs with float32 output over views of the
   cache) against the float32-copy form at hymba's and qwen3's decode
   shapes, within DECODE_TOL, with the memory a call allocates held below
   one float32 copy of a cache; then hymba-1.5b at full width and depth
   (bf16, random weights from a seeded generator on the card): the prefill
   of 4 x 4,096 tokens
   through K5 and K6 (32 launches each, every call held against the plain
   version on its own inputs), the same prefill with ``mode="ref"`` (last
   logits and every cache leaf compared), 32 teacher-forced decode steps
   from both caches (logits compared; greedy tokens equal wherever the top-2
   margin exceeds twice the difference), prefill tokens/s and decode ms per
   step; the float32 variant at 4 layers (logits within LM_F32_TOL);
   ``launch.serve.main`` at ``--batch 4 --prompt-len 4096 --new-tokens 32
   --temperature 0``; one kernel-path prefill at B = 1, S = 32,768; then
   qwen3-0.6b (K5, 28 launches) and mamba2-780m (K6, 48 launches) through
   the same prefill and decode comparisons.
18. ``lm_train`` — LM training (ROADMAP A6) at full width: qwen3-0.6b,
   28 layers, bf16 parameters, float32 AdamW moments, remat, B = 4 x S =
   4,096 synthetic tokens: one ``train.lm_train.make_train_step`` step
   through K5 and K5b (56 K5 launches, 28 K5b, no K6), each attention call
   held on its own inputs against the plain version (forward and
   gradient), the same step again from the same state to the same bits,
   and with ``mode="ref"`` (loss within BF16_TOL; whole-model gradients
   reported: chaotic in depth); five timed steps (losses, ms a step,
   tokens/s, peak memory, ``mfu``) and the card's busy share over one
   more, with K5b's device ms a step by kernel (row statistics, dq pass,
   dk/dv pass); the float32 variant at 4 layers held whole against the plain
   step (loss, every gradient, grad_norm, the updated parameters); then
   mamba2-780m (48 layers: 96 K6 launches, 48 K6b) and hymba-1.5b (32:
   64 K5, 32 K5b, 64 K6, 32 K6b) the same way, every K6 and K6b call held
   on its own inputs, five timed steps and one profiled, with K6b's device
   ms a step by pass (and its own passes' sum, TFLOP/s and GB/s per call),
   and hymba's float32 variant at 2 layers held whole
   (its gradients within SSM_F32_GRAD_RTOL); last
   ``python -m repro_torch.launch.train --workload lm`` on the card: the
   reduced qwen3 with the reference test's flags killed at step 7 and
   resumed to the uninterrupted run's ``done`` line, and one full-width
   run (B 4 x S 4,096, 3 steps).
19. ``multi`` — the mesh paths (ROADMAP A5), ranks spawned on the one card:
   ``init_distributed("gloo", device="cuda:0")`` for 2 and 4 ranks (NCCL
   refuses two ranks on one device) and a one-rank NCCL group for the
   1 x 1 mesh, each rank printing its backend, world size and device.
   2 ranks: ``fused_temporal_layer_sharded`` at the main path's shapes (S =
   4,400 and 600, N = 9,000, K = 10, H = 2, D = 50, every bias group) on
   each rank's node block, the output bit-equal to the one-device K1 call
   (and the plain sharded version to the one-device plain version), the
   gradients against the one-device K2 within the K2 tolerances, K1 and K2
   counted per rank; then on the 1 x 2 mesh over full-scale ``wikipedia``:
   the quickstart and 2-layer TGAT with the sharded buffer exposed
   (``evaluate("val")`` through the shard-aware K1, hop-2 too) and 2-layer
   TGAT over the node-sharded device uniform sampler under both partitions
   (K3), each with val MRR and the canonical sampler state bit-equal to the
   one-device run of the ``slice``, ``tgat2`` and ``zoo`` phases. 4 ranks,
   the 2 x 2 mesh: 1-layer TGAT's first 20 steps held against the
   one-device K1/K2 step from the same parameters (loss; whole-model
   gradients reported), ``train_epoch()`` (552 batches, K1 and K2 once a
   batch on every rank) and val MRR after it within the ``train`` phase's
   free-running tolerances of its one-device epoch, epoch seconds, ms a
   step and the host seconds inside ``all_reduce``; a checkpoint; TGN's 3
   steps through K1/K2 against ``fused="ref"`` (loss, synced memory, GRU
   gradients zero). 1 rank over NCCL: the 2 x 2 checkpoint restored on the
   1 x 1 mesh, parameters and canonical sampler state bit-equal, and val
   MRR through K1. The two 1 x 2 worlds (recency, then the sharded K1/K2;
   uniform) start once the 2 x 2 epoch is timed, the 1 x 1 restore once
   the 2 x 2 world has ended.

``--profile`` adds ``profile`` (host-clock time per batch of the warm pass,
and per scored val batch of the hooks, the model step and the metric, each
closed by a device synchronise), ``trace`` (``torch.profiler`` over scored
val batches: device busy time, idle share, device time by kernel name,
K1's, K2's, K3's and K3b's device ms and share of the busy time, as in
every train window),
``loader`` (ms per batch with the hooks in the calling thread and in
``PrefetchLoader``'s thread), ``spread`` (loss and val MRR of several
free-running kernel and perturbed plain epochs), ``train_profile`` (per
train step: the next batch, forward, backward with K2, AdamW, each closed
by a synchronise), ``train_trace`` (the profiler over train steps as
``train_epoch`` runs them), ``dtdg_profile`` (a GCLSTM train step split
into forward, backward and AdamW; the profiler over train steps and scored
val pairs), ``dtdg_spread`` (loss and val MRR of free-running K4 and plain
epochs), ``dtdg_parity`` (the step parity over more steps), and for the
classic path ``host_profile`` (the per-batch split of the host-sampler
quickstart), ``host_trace`` and ``host_train_trace`` (its profiler windows)
``tgn_device_train_trace`` / ``tgn_host_train_trace`` (TGN's train
steps under the profiler on each sampler), ``tgat2_{device,host}_trace``
and ``tgat2_{device,host}_train_trace`` (2-layer TGAT's scored val batches
and train steps under the profiler on each sampler), and in ``lm`` a profiler window
over hymba's decode steps (``decode_trace``, with the device ms per step of
copy kernels and the largest copies by shape). ``build`` and
``lm_kernels`` report ``profiler_clock`` (what the profiler keeps of two
known launches, early and late in the process). Then the
script's total seconds (``total``), the ``{"kernels": [...]}`` summary (K1,
K2, K3, K3b, K4, K5, K5b, K6 and K6b with their launches on the main paths, the
uniform samplers', the node tasks', the storage paths' and the mesh paths' runs
(summed over ranks) among them; K1w, off
the path, beside them), the card's name and power limit as nvidia-smi reports them,
and the last line ``{"ok": true, "device": {"platform": "gpu",
...}}``. Any failed check exits non-zero before the last line.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel vs plain version on the card: float32, summation order differs
# (per-thread FMA chains vs cuBLAS/ATen reductions), |err| <= ATOL + RTOL|ref|.
ATOL = RTOL = 1e-4
# K2's time_w gradient against the plain backward: max |err| / max |ref|
# (its entries sum dtheta * dt with dt up to ~2.6e6 s over every slot).
TIME_W_RTOL = 1e-4
MRR_TOL = 1e-4
# K3 in bfloat16 against its plain version: the reference's harness
# tolerance for bfloat16 (tests/kernels/harness.py).
BF16_TOL = 2e-2
# Train phase. A step from the same parameters, kernels against the plain
# version: loss within STEP_LOSS_TOL, the layer's K1 and K2 on that step's
# inputs within the kernel tolerances above (``step_parity``); whole-model
# gradients are reported against GRAD_RTOL of each leaf's largest entry plus
# GRAD_FLOOR (float32 noise of the gradients that are zero in exact
# arithmetic, such as the key bias). A whole epoch runs freely and training
# here is chaotic (theta = dt * w + b with dt up to ~2.6e6 s turns an ulp of
# w into ~0.1 rad; AdamW turns a gradient entry near zero into a full step
# of either sign), so the kernel and plain epochs are held to the spread
# that free-running epochs show on the card: EPOCH_LOSS_TOL in the mean
# loss, TRAIN_MRR_TOL in val MRR after the epoch. Measured on an H100 over
# kernel epochs (the table gradients' float atomics make each a separate
# trajectory) and plain epochs from parameters scaled by 1 + c * 1e-7
# (``--profile``'s ``spread`` phase, and the train phase of earlier runs),
# the largest distance from the plain epoch was 1.12e-3 in loss and 2.03e-3
# in MRR (NVIDIA H100 80GB HBM3, 700 W); the limits are ~2.5x that. The
# control run that re-measured one such distance every run (a plain epoch
# from parameters scaled by 1 + 1e-7) was cut in PR 24 to keep the script
# in its time limit; ``--profile``'s ``spread`` measures the spread.
STEP_LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-7
PARITY_STEPS = 20
EPOCH_LOSS_TOL = 3e-3
TRAIN_MRR_TOL = 5e-3
# DTDG phase (GCLSTM, hourly snapshots). A step from the same parameters,
# K4 against the plain version: loss within DTDG_STEP_LOSS_TOL, every
# whole-model gradient within GRAD_RTOL of its leaf's largest entry (+
# GRAD_FLOOR); over 200 steps on an H100 the largest error was 0.13 of that.
# A free-running epoch through K4 against the plain epoch from the same
# start: DTDG_EPOCH_LOSS_TOL in the mean loss and DTDG_MRR_TOL in val MRR
# after it. K4 epochs are bit-reproducible; the plain version's index_add_
# adds with float atomics, so each plain epoch is its own trajectory. Over
# 40 plain epochs on an H100 (from the same start, or from parameters scaled
# by 1 + c * 1e-7; ``--profile``'s ``dtdg_spread`` and the control runs
# this phase made before PR 24, NVIDIA H100 80GB HBM3, 700 W) the largest
# distance from the K4 epoch was 8.86e-6 in loss and 1.71e-3 in MRR; the
# limits are ~3x that.
DTDG_STEP_LOSS_TOL = 1e-5
DTDG_PROFILE_PARITY_STEPS = 200
DTDG_EPOCH_LOSS_TOL = 2.5e-5
DTDG_MRR_TOL = 5e-3

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 on the CUDA
# cores and HBM3 bandwidth; they assume the 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# ... and dense bfloat16 on the tensor cores (the LM kernels' input type).
PEAK_BF16_FLOPS = 989e12

# LM serving slice (K5, K6): the prefill batch and length of the main path,
# the decode steps after it. K6's final state (float32, chunked sums of
# thousands of steps) is held by its largest error over its largest entry,
# SSD_TOL: the reference's bound for a chunked scan against the recurrence
# (tests/kernels/families.py::_SSD_TOL). The random-init models are chaotic
# in depth: a 1e-7 change of hymba's parameters moves its float32 logits by
# O(1) within 16 layers (CPU, full width), so a bfloat16 model, kernel path
# against plain path, is held layer by layer on the same input: the layer's
# output and every cache leaf to LM_LAYER_TOL of its largest entry (the
# plain path runs the reference's bfloat16 einsums and K6 float32
# arithmetic, so each layer parts by bfloat16 rounding: up to 1.1e-2
# measured on the CPU with the plain versions standing in for the kernels,
# full width, six layers; 1.28e-2 on an H100, NVIDIA H100 80GB HBM3, 700 W).
# The float32 variant, four layers deep, is held whole: its last logits to
# LM_F32_TOL (2.8e-4 measured on the H100), every cache leaf to
# LM_F32_CACHE_TOL (9.2e-4 measured there: the k/v of layers 2-4 carry the
# parting of the layers below).
LM_B, LM_S, LM_DECODE_STEPS = 4, 4096, 32
# Warm timed prefills per path and model, after one cold run each: one
# host-clock reading of mamba2's kernel-path prefill, the first after
# emptying the allocator's cache, read 0.559 s where the other runs read
# 0.215-0.224 s (the plain path 0.407-0.428 s; NVIDIA H100 80GB HBM3, 700 W).
PREFILL_RUNS = 2
SSD_TOL = 1e-3
LM_LAYER_TOL = 3e-2
LM_F32_TOL = 1e-3
LM_F32_CACHE_TOL = 3e-3

N_NODES, K, H, D = 9000, 10, 2, 50
D_TIME, D_EDGE, N_EDGES = 100, 172, 157_474
EVAL_S, TRAIN_S = 200 * (2 + 20), 200 * (2 + 1)

KERNEL_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/fused_temporal_layer.cu"
BWD_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/fused_temporal_layer_bwd.cu"
TPU_K1 = "src/repro/kernels/temporal_attention/kernel.py:383"
TPU_K1W = "src/repro/kernels/temporal_attention/kernel.py:746"
TPU_K2 = "src/repro/kernels/temporal_attention/kernel.py:626"
SEG_SOURCE = "src/repro_torch/kernels/segment_reduce/csrc/segment_sum.cu"
TPU_K4 = "src/repro/kernels/segment_reduce/kernel.py:47"
TA_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/temporal_attention.cu"
TPU_K3 = "src/repro/kernels/temporal_attention/kernel.py:100"
TA_BWD_SOURCE = "src/repro_torch/kernels/temporal_attention/csrc/temporal_attention_bwd.cu"
# K3b has no TPU kernel: the JAX package takes XLA's gradient of K3's oracle.
TPU_K3B = ("src/repro/kernels/temporal_attention/ref.py:10 (no TPU kernel: "
           "XLA's gradient of temporal_attention_ref)")
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
TPU_K5 = "src/repro/kernels/flash_attention/kernel.py:77"
FA_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu"
# K5b's bf16 kernels by name (the profiler's and ptxas'): the row statistics,
# the dq pass and the dk/dv pass.
K5B_KERNELS = ("fa_bwd_stats_kernel", "fa_bwd_dq_wg_kernel", "fa_bwd_dkdv_wg_kernel")
BUILD_LOGS: dict = {}  # nvcc's output per library, from main's build
# K5b has no TPU kernel: the JAX package's LM takes autodiff of its jnp
# blocked attention.
TPU_K5B = ("src/repro/models/lm/layers.py:95 (no TPU kernel: autodiff of the "
           "jnp flash_attention)")
SSD_SOURCE = "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu"
TPU_K6 = "src/repro/kernels/ssd_chunk/kernel.py:70"
SSD_BWD_SOURCE = "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk_bwd.cu"
# K6b has no TPU kernel: the JAX package's LM takes autodiff of its plain
# chunked scan.
TPU_K6B = ("src/repro/models/lm/layers.py:580 (no TPU kernel: autodiff of the "
           "jnp ssd_mix)")
# K6b's launches by kernel name (the profiler's and ptxas'), in order,
# after K6's passes 1 (``ssd_chunk_state_kernel<NB, false>``) and 2, which
# the forward launches and a train step's profile books beside K6b's: pass
# 1 with dy and C (``<NB, true>``), the reverse state pass, the chunk pass
# (``ssd_bwd_chunk_kernel<16, true, true>``, or its dx and dB / dC kernels
# ``<128, true, false>`` and ``<128, false, true>``), the fixed-order sums;
# the float32 kernel.
K6B_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_state_rpass_kernel",
               "ssd_bwd_chunk_kernel", "ssd_bwd_sum_kernel", "ssd_bwd_f32_kernel")
# The chunk pass's instances by their template arguments, and their pass names.
K6B_CHUNK = {"true, true": "chunk", "true, false": "chunk_dx", "false, true": "chunk_dbc"}
# The passes K6b itself launches (bfloat16, on K6's kept states).
K6B_OWN = ("cotan", "ssd_state_rpass_kernel", "chunk", "chunk_dx", "chunk_dbc",
           "ssd_bwd_sum_kernel")
DEVICE = "cuda"
T_START = time.perf_counter()


class SmokeError(RuntimeError):
    pass


def emit(obj) -> None:
    """Print ``obj`` as one JSON line; a phase's line gains ``at_s``, the
    script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel inputs
# ---------------------------------------------------------------------------
# Degenerate inputs for both kernels: (case, S, layer_inputs options).
DEGENERATE = (
    ("neg_seeds", 77, dict(neg_seeds=20)),
    ("empty_rows", 64, dict(empty_rows=10)),
    ("all_masked", 33, dict(all_masked=True)),
    ("dup_ids", 50, dict(dup_row=True)),
    ("k1", 129, dict(k=1)),
    ("s_not_128", 131, {}),
    ("time_only", 64, dict(d_edge=0)),
    ("edge_only", 64, dict(d_time=0)),
    ("no_groups", 64, dict(d_time=0, d_edge=0)),
    ("k20", 64, dict(k=20)),
    ("far_times", 64, dict(far_times=True)),
)


def layer_inputs(torch, gen, S, *, n=N_NODES, k=K, h=H, d=D, d_time=D_TIME,
                 d_edge=D_EDGE, e=N_EDGES, neg_seeds=0, empty_rows=0,
                 dup_row=False, all_masked=False, far_times=False):
    """Random fused-layer operands on the card, shaped like the main path:
    buffer rows hold past neighbors (times before the seed's), some slots
    empty (-1) or featureless (eid -1), times on the wikipedia scale.
    ``far_times``: every slot ~2.58e6-2.59e6 s before its seed (the
    largest dt of the month-long stream, where dtheta * dt stresses the
    time_w gradient)."""
    dev = DEVICE

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    w = math.sqrt(2.0 / (d_time + d_edge + 2 * h * d))
    seeds = torch.randint(0, n, (S,), generator=gen, dtype=torch.int32)
    if neg_seeds:
        seeds[torch.randperm(S, generator=gen)[:neg_seeds]] = -1
    seed_t = torch.randint(2_590_000 if far_times else 2_000_000, 2_592_000,
                           (S,), generator=gen, dtype=torch.int32)
    ids = torch.randint(0, n, (n + 1, k), generator=gen, dtype=torch.int32)
    # Most rows full after the warm pass, the rest partly filled.
    cnt = torch.where(torch.rand((n + 1, 1), generator=gen) < 0.8, k,
                      torch.randint(0, k + 1, (n + 1, 1), generator=gen))
    ids = torch.where(torch.arange(k)[None] < cnt, ids, -1)
    times = torch.randint(0, 10_000 if far_times else 2_000_000, (n + 1, k),
                          generator=gen, dtype=torch.int32)
    eids = torch.randint(-1, e, (n + 1, k), generator=gen, dtype=torch.int32)
    buf = torch.stack([ids, torch.where(ids >= 0, times, 0),
                       torch.where(ids >= 0, eids, -1)], dim=-1)
    buf[n] = torch.tensor([-1, 0, -1], dtype=torch.int32)  # sink row
    if empty_rows:
        buf[seeds[:empty_rows].clamp(min=0).long()] = torch.tensor(
            [-1, 0, -1], dtype=torch.int32)
    if dup_row:
        r = int(seeds[0].clamp(min=0))
        buf[r, :, 0] = int(ids[r, 0].clamp(min=0))
    if all_masked:
        buf[..., 0] = -1
    ops = dict(
        q=randn(S, h, d, scale=0.25), k_table=randn(n, h, d, scale=0.25),
        v_table=randn(n, h, d, scale=0.25), seeds=seeds.to(dev),
        seed_times=seed_t.to(dev), buf=buf.to(dev))
    kw = {}
    if d_time:
        kw.update(time_w=randn(d_time, scale=0.1),
                  time_b=randn(d_time, scale=0.1),
                  wt_k=randn(d_time, h * d, scale=w),
                  wt_v=randn(d_time, h * d, scale=w))
    if d_edge:
        kw.update(edge_feats=randn(e, d_edge), we_k=randn(d_edge, h * d, scale=w),
                  we_v=randn(d_edge, h * d, scale=w))
    return ops, kw


def _reach(torch, ops, kw):
    """What one fused-layer call on these inputs reaches: the seeds with a
    valid slot (and with a featured one), the valid and featured slots, and
    the distinct buffer, table and edge rows."""
    q, seeds, buf = ops["q"], ops["seeds"], ops["buf"]
    S, h, d = q.shape
    live = seeds >= 0
    rows = buf[seeds[live].long()]                       # (S', K, 3)
    valid = rows[..., 0] >= 0
    d_time = kw["wt_k"].shape[0] if "wt_k" in kw else 0
    d_edge = kw["we_k"].shape[0] if "we_k" in kw else 0
    edge = valid & (rows[..., 2] >= 0) if d_edge else torch.zeros_like(valid)
    return dict(
        S=S, h=h, d=d, hd=h * d, d_time=d_time, d_edge=d_edge,
        k=buf.shape[1], n=ops["k_table"].shape[0],
        seeds_valid=int(valid.any(-1).sum()), seeds_edge=int(edge.any(-1).sum()),
        slots=int(valid.sum()), edge_slots=int(edge.sum()),
        rows=int(torch.unique(seeds[live]).numel()),
        ids=int(torch.unique(rows[..., 0][valid]).numel()),
        eids=int(torch.unique(rows[..., 2][edge]).numel()))


def _bound(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def layer_bound(torch, ops, kw):
    """Least time (ms) for one fused-layer call on these inputs: each input
    byte this run needs read once (only the buffer rows, table rows and edge
    rows its seeds reach), the output written once; the operations the
    function needs in its cheapest exact form. The bias groups factor per
    seed: q's score against phi @ wt_k is (wt_k q) . phi, and the output's
    sum_j p_j phi_j @ wt_v is wt_v^T (sum_j p_j phi_j), so each weight
    matrix is crossed once per seed (4 (d_time + d_edge) HD) and a slot
    costs O(H (D + d_time + d_edge)): its table-row score and weighted sum
    (4 HD), its phi (3 d_time) and phi's score and weighted sum (4 H
    d_time), a featured slot's edge row likewise (4 H d_edge), the softmax
    (5 H). Returns (bound_ms, bound_by, bytes, flops)."""
    r = _reach(torch, ops, kw)
    hd, h, dt, de = r["hd"], r["h"], r["d_time"], r["d_edge"]
    flops = (4 * hd * (r["seeds_valid"] * dt + r["seeds_edge"] * de)
             + r["slots"] * (4 * hd + 4 * h * dt + 3 * dt + 5 * h)
             + r["edge_slots"] * 4 * h * de)
    nbytes = (4 * r["S"] * hd * 2                # q in, out
              + 4 * r["S"] * (2 if dt else 1)    # seeds, seed times
              + 4 * r["rows"] * r["k"] * 3       # buffer rows
              + 4 * r["ids"] * hd * 2            # k/v table rows
              + 4 * r["eids"] * de               # edge-feature rows
              + 4 * (2 * dt + 2 * (dt + de) * hd))  # weights
    return _bound(nbytes, flops)


def layer_bwd_bound(torch, ops, kw):
    """Least time (ms) for one backward call on these inputs, by the rule of
    ``layer_bound``: the cotangent g, q, the buffer, table and edge rows its
    seeds reach and the weights read once; dq, both whole table gradients
    and the weight gradients written once. Operations in the factored form:
    per seed, q and g each projected through the k and v weights, dq's bias
    part projected back, and the four weight gradients as rank-1 updates
    (sum_j ds_j phi_j) x q and (sum_j p_j phi_j) x g, with their edge
    counterparts: 10 (d_time + d_edge) HD. Per slot: scores, dp, dq's and
    the two weighted sums, the dk/dv rows into the tables (10 HD); phi,
    dtheta and the time-weight sums (8 d_time); phi's dot products, weighted
    sums and dphi (12 H d_time); a featured slot's edge row (8 H d_edge);
    softmax and ds (10 H). Returns (bound_ms, bound_by, bytes, flops)."""
    r = _reach(torch, ops, kw)
    hd, h, dt, de = r["hd"], r["h"], r["d_time"], r["d_edge"]
    flops = (10 * hd * (r["seeds_valid"] * dt + r["seeds_edge"] * de)
             + r["slots"] * (10 * hd + 12 * h * dt + 8 * dt + 10 * h)
             + r["edge_slots"] * 8 * h * de)
    weights = 4 * (2 * dt + 2 * (dt + de) * hd)
    nbytes = (4 * r["S"] * hd * 3                # g, q in; dq out
              + 4 * r["S"] * (2 if dt else 1)    # seeds, seed times
              + 4 * r["rows"] * r["k"] * 3       # buffer rows
              + 4 * r["ids"] * hd * 2            # k/v table rows
              + 4 * r["eids"] * de               # edge-feature rows
              + 4 * r["n"] * hd * 2              # dk/dv tables out
              + 2 * weights)                     # weights in, their gradients out
    return _bound(nbytes, flops)


def time_ms(torch, fn, reps: int, trials: int = 5) -> float:
    """Median over ``trials`` of the mean time of ``reps`` calls, from CUDA
    events (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    return statistics.median(out)


def compare(torch, got, want, what: str, tol: float = ATOL) -> float:
    """Hold a kernel's output elementwise to |err| <= tol + tol |ref| (in
    float32, whatever the storage type); returns the largest error."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all())
    check(ok, f"{what}: kernel disagrees with the plain version "
              f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def compare_grads(torch, got, want, what: str):
    """Hold every gradient of K2 against the plain backward. ``time_w`` sums
    dtheta * dt over every slot with dt up to ~2.6e6 s, so its absolute
    error scales with its largest entry: it is held to TIME_W_RTOL of that
    (max |err| / max |ref|); the others elementwise to ATOL + RTOL |ref|.
    Returns {name: [max abs err, max abs err / max |ref|]}."""
    torch.cuda.synchronize()
    check(sorted(got) == sorted(want), f"{what}: gradient names {sorted(got)} "
                                       f"!= {sorted(want)}")
    out = {}
    for name in want:
        a, b = got[name], want[name]
        check(tuple(a.shape) == tuple(b.shape),
              f"{what}: {name} shape {tuple(a.shape)} != {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {name}")
        err = (a - b).abs()
        emax, ref_max = float(err.max()), float(b.abs().max())
        rel = emax / ref_max if ref_max > 0 else emax
        if name == "time_w":
            ok = rel <= TIME_W_RTOL
        else:
            ok = bool((err <= ATOL + RTOL * b.abs()).all())
        check(ok, f"{what}: gradient {name} disagrees with the plain version "
                  f"(max abs err {emax:.3e}, relative {rel:.3e})")
        out[name] = [emax, rel]
    return out


# The device launches of one K1 and one K2 call, by kernel name (K1w runs
# K1's slot kernel alone).
K1_LAUNCHES = ("ftl_fwd_project_kernel", "ftl_fwd_slot_kernel",
               "ftl_fwd_back_project_kernel")
K2_LAUNCHES = ("ftl_bwd_project_kernel", "ftl_bwd_slot_kernel",
               "ftl_bwd_back_project_kernel", "ftl_bwd_wgrad_kernel", "ftl_bwd_wsum_kernel")


def launch_us(by_name: dict, launches, label: str, strict: bool = True) -> dict:
    """Device µs per call of each launch of a kernel's call, keyed by kernel
    name, from ``device_us_per_call(by_kernel=True)``'s profiler names.
    Fails on two kernels under one name, and with ``strict`` on a device
    kernel that is none of ``launches`` (else it is kept under its own
    name: K1w's wrapper packs its buffer with PyTorch ops); empty when the
    profiler recorded nothing (not measured)."""
    out = {}
    for name, us in by_name.items():
        hit = [k for k in launches if k in name]
        check(len(hit) == 1 or not strict,
              f"{label}: device kernel {name!r} is no launch of it")
        key = hit[0] if hit else name
        check(key not in out, f"{label}: two device kernels named {key}")
        out[key] = us
    return out


def workspace_measured(torch, fn, outputs_bytes: int) -> int:
    """Bytes a call allocates beyond its outputs: the rise of the
    allocator's peak over one call, less ``outputs_bytes``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    used = torch.cuda.max_memory_allocated() - m0 - outputs_bytes
    del out
    return used


def layer_timing(torch, kern, plain, launches, label, reps=20, strict=True):
    """CUDA-event ms of the kernel and its plain version, and the kernel's
    device µs per call and per launch from the profiler."""
    by_launch = launch_us(device_us_per_call(torch, kern, reps, by_kernel=True),
                          launches, label, strict)
    return dict(ms=time_ms(torch, kern, reps), plain_ms=time_ms(torch, plain, 5),
                device_us=sum(by_launch.values()) if by_launch else None,
                device_us_by_launch=by_launch)


def k2_phase(torch, gen):
    """Hold K2 against the plain backward at the train and eval shapes and
    on degenerate inputs, hold a second run bit-equal to the first in every
    gradient but the tables, and time it beside the plain backward (CUDA
    events; device µs per call and per launch by the profiler), with the
    workspace a call allocates. Returns (results, cases)."""
    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_bwd_kernel,
        fused_temporal_layer_bwd_ref,
    )
    from repro_torch.kernels.temporal_attention.kernel import workspace_bytes

    def cotangent(S):
        return torch.randn((S, H, D), generator=gen).to(DEVICE)

    results, cases = {}, []
    for name, S in (("train", TRAIN_S), ("eval", EVAL_S)):
        ops, kw = layer_inputs(torch, gen, S)
        g = cotangent(S)
        got = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        want = fused_temporal_layer_bwd_ref(g, **ops, **kw)
        errs = compare_grads(torch, got, want, f"K2 {name} S={S}")
        again = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        rerun = compare_grads(torch, again, got, f"K2 {name} S={S} rerun")
        bitwise = {k: bool(torch.equal(again[k], got[k])) for k in got}
        for k_, same in bitwise.items():
            check(same or k_ in ("k_table", "v_table"),
                  f"K2 {name} S={S}: a second run gave other bits in {k_}")
        bound, by, nbytes, flops = layer_bwd_bound(torch, ops, kw)
        kern = lambda: fused_temporal_layer_bwd_kernel(g, **ops, **kw)  # noqa: E731
        plain = lambda: fused_temporal_layer_bwd_ref(g, **ops, **kw)  # noqa: E731
        r = results[f"K2_{name}"] = dict(
            S=S, max_abs_err=max(e[0] for e in errs.values()), errors=errs,
            rerun_max_abs_diff={k: v[0] for k, v in rerun.items()},
            rerun_bitwise_equal=bitwise,
            **layer_timing(torch, kern, plain, K2_LAUNCHES, f"K2 {name}"),
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        r["bound_share"] = bound / r["ms"]
        d_time, d_edge = kw["wt_k"].shape[0], kw["we_k"].shape[0]
        r["workspace_bytes_planned"] = workspace_bytes(S, H, D, d_time, d_edge,
                                                       backward=True)
        r["workspace_bytes"] = workspace_measured(
            torch, kern, sum(v.numel() * v.element_size() for v in got.values()))
        check(r["workspace_bytes"] >= r["workspace_bytes_planned"],
              f"K2 {name}: a call allocated {r['workspace_bytes']} bytes beyond its "
              f"outputs, less than the planned {r['workspace_bytes_planned']}")
        del got, again, want
    small = dict(n=300, e=500)
    for case, S, extra in DEGENERATE:
        ops, kw = layer_inputs(torch, gen, S, **small, **extra)
        g = cotangent(S)
        got = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        errs = compare_grads(torch, got, fused_temporal_layer_bwd_ref(g, **ops, **kw),
                             f"K2 {case}")
        again = fused_temporal_layer_bwd_kernel(g, **ops, **kw)
        for k_ in got:
            check(k_ in ("k_table", "v_table") or bool(torch.equal(again[k_], got[k_])),
                  f"K2 {case}: a second run gave other bits in {k_}")
        if case == "neg_seeds":
            check(bool((got["q"][ops["seeds"] < 0] == 0).all()),
                  "K2 neg_seeds: dq rows of seeds < 0 not exactly zero")
        if case == "all_masked":
            check(all(bool((v == 0).all()) for v in got.values()),
                  "K2 all_masked: gradients not exactly zero")
        cases.append({"case": case, "S": S,
                      "max_abs_err": max(e[0] for e in errs.values())})
    return results, cases


def kernels_phase(torch):
    """Hold K1 and K1w against their plain versions; time them (CUDA
    events; device µs per call and per launch by the profiler) and measure
    K1's workspace."""
    from repro_torch.kernels.temporal_attention import (
        fused_recency_attention_kernel,
        fused_recency_attention_ref,
        fused_temporal_layer_kernel,
        fused_temporal_layer_ref,
    )
    from repro_torch.kernels.temporal_attention.kernel import workspace_bytes

    gen = torch.Generator().manual_seed(0)
    results, cases = {}, []
    with torch.no_grad():
        for name, S in (("eval", EVAL_S), ("train", TRAIN_S)):
            ops, kw = layer_inputs(torch, gen, S)
            got = fused_temporal_layer_kernel(**ops, **kw)
            err = compare(torch, got, fused_temporal_layer_ref(**ops, **kw),
                          f"K1 {name} S={S}")
            bound, by, nbytes, flops = layer_bound(torch, ops, kw)
            kern = lambda: fused_temporal_layer_kernel(**ops, **kw)  # noqa: E731
            plain = lambda: fused_temporal_layer_ref(**ops, **kw)  # noqa: E731
            r = results[f"K1_{name}"] = dict(
                S=S, max_abs_err=err,
                **layer_timing(torch, kern, plain, K1_LAUNCHES, f"K1 {name}"),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            r["bound_share"] = bound / r["ms"]
            r["workspace_bytes_planned"] = workspace_bytes(S, H, D, D_TIME, D_EDGE,
                                                           backward=False)
            r["workspace_bytes"] = workspace_measured(torch, kern, got.numel() * 4)
            check(r["workspace_bytes"] >= r["workspace_bytes_planned"],
                  f"K1 {name}: a call allocated {r['workspace_bytes']} bytes beyond "
                  f"its output, less than the planned {r['workspace_bytes_planned']}")
            ids = ops["buf"][..., 0].contiguous()
            kops = {k: ops[k] for k in ("q", "k_table", "v_table", "seeds")}
            got = fused_recency_attention_kernel(**kops, buf_ids=ids)
            err = compare(torch, got,
                          fused_recency_attention_ref(**kops, buf_ids=ids),
                          f"K1w {name} S={S}")
            bound, by, nbytes, flops = layer_bound(
                torch, dict(ops, buf=torch.stack(
                    [ids, torch.zeros_like(ids), torch.full_like(ids, -1)], -1)), {})
            kern = lambda: fused_recency_attention_kernel(**kops, buf_ids=ids)  # noqa: E731
            plain = lambda: fused_recency_attention_ref(**kops, buf_ids=ids)  # noqa: E731
            r = results[f"K1w_{name}"] = dict(
                S=S, max_abs_err=err,
                **layer_timing(torch, kern, plain, K1_LAUNCHES, f"K1w {name}",
                               strict=False),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            r["bound_share"] = bound / r["ms"]

        # Degenerate inputs at the real widths (small N and E keep it quick).
        small = dict(n=300, e=500)
        for case, S, extra in DEGENERATE:
            ops, kw = layer_inputs(torch, gen, S, **small, **extra)
            got = fused_temporal_layer_kernel(**ops, **kw)
            err = compare(torch, got, fused_temporal_layer_ref(**ops, **kw),
                          f"K1 {case}")
            if case in ("neg_seeds", "all_masked"):
                zero = ops["seeds"] < 0 if case == "neg_seeds" else slice(None)
                check(bool((got[zero] == 0).all()), f"K1 {case}: rows not exactly zero")
            cases.append({"case": case, "S": S, "max_abs_err": err})
    return results, cases


def slice_phase(torch):
    """The main path through the user's entry point, then its plain twin."""
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    pipe = quickstart().compile(device=DEVICE)
    setup_s = time.perf_counter() - t0
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)

    reset_launches()
    t0 = time.perf_counter()
    mrr, eval_s = pipe.evaluate("val")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check(math.isfinite(mrr) and 0.0 < mrr <= 1.0, f"val MRR {mrr} out of range")
    check(launches["fused_temporal_layer"] == n_val,
          f"kernel launched {launches['fused_temporal_layer']} times for "
          f"{n_val} val batches")
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    state = hook.state_dict()

    pipe.fused = "ref"
    reset_launches()
    mrr_ref, eval_ref_s = pipe.evaluate("val")
    check(LAUNCHES["fused_temporal_layer"] == 0, "fused='ref' launched the kernel")
    state_ref = hook.state_dict()
    check(abs(mrr - mrr_ref) <= MRR_TOL,
          f"val MRR {mrr} (kernel) vs {mrr_ref} (plain) differ by more than {MRR_TOL}")
    for k_ in state:
        check(bool((state[k_] == state_ref[k_]).all()),
              f"sampler state {k_!r} differs between the two runs")
    return dict(mrr=mrr, mrr_ref=mrr_ref, eval_seconds=eval_s,
                state_sha256=state_digest(state),
                eval_ref_seconds=eval_ref_s, evaluate_total_seconds=total_s,
                setup_seconds=setup_s, val_batches=n_val,
                val_events=pipe.val_data.num_edge_events,
                train_events=pipe.train_data.num_edge_events,
                launches=launches)


def quickstart(train_spec_kw=None):
    """The quickstart experiment at full scale: 1-layer TGAT over the device
    recency sampler (k=10) on synthetic ``wikipedia``, batch 200."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    return Experiment(
        data=DataSpec("wikipedia", scale=1.0),
        model=ModelSpec("tgat", {"num_layers": 1}),
        sampler=SamplerSpec(kind="recency", k=10, device=True),
        train=TrainSpec(batch_size=200, eval_negatives=20,
                        **(train_spec_kw or {})),
    )


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def step_parity(torch, pipe, n_steps: int):
    """The first ``n_steps`` train steps through the kernels, each from the
    same parameters (and model state) as a plain-version step. Held: the
    loss, and every attention call of the step as the model makes it (one
    a step with 1-layer TGAT or TGN, three with 2-layer TGAT): on the fused
    path K1 against the plain forward on the step's own inputs and K2
    against the plain backward on the step's own cotangent (taken from the
    autograd graph); on the classic path K3 against its plain version on the
    step's own inputs and K3b on the step's own cotangent against plain
    autograd. A stateful model's GRU gradients
    are held to exact zeros on both runs (no gradient reaches the memory
    update). The whole-model gradients are compared too, but only reported:
    the merge and decoder MLPs' ReLUs and the cancelling time_w sum turn a
    rounding-level change of the layer's output into a whole unit's gradient
    in a few percent of steps (on the CPU, scaling the layer's output by
    1 + 1e-6 noise moved 4 of 150 steps beyond 1e-4), so no tolerance holds
    them every step. The kernels' update (and state) moves the run on.
    Returns the worst errors seen."""
    import repro_torch.kernels.temporal_attention as ta
    from repro_torch.core import TRAIN_KEY

    layer, attention, seen = ta.fused_temporal_layer, ta.temporal_attention, {}

    def watch(name, out, args):
        rec = {"args": args}
        seen.setdefault(name, []).append(rec)
        out.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous()))

    def layer_spy(q, k_table, v_table, seeds, seed_times, buf, *, mode, **kw):
        out = layer(q, k_table, v_table, seeds, seed_times, buf, mode=mode, **kw)
        if mode == "auto":
            watch("layer", out, dict(
                q=q.detach().contiguous(), k_table=k_table.detach().contiguous(),
                v_table=v_table.detach().contiguous(),
                seeds=seeds.to(torch.int32).contiguous(),
                seed_times=seed_times.to(torch.int32).contiguous(),
                buf=buf.to(torch.int32).contiguous(),
                **{k: None if v is None else v.detach().contiguous()
                   for k, v in kw.items()}))
        return out

    def attention_spy(q, k, v, mask, *, mode="auto"):
        out = attention(q, k, v, mask, mode=mode)
        if mode == "auto":
            watch("attention", out, [t.detach().contiguous() for t in (q, k, v)]
                  + [mask.contiguous()])
        return out

    worst = {"loss": 0.0, "k1_max_abs_err": 0.0, "k2_max_rel_err": 0.0,
             "k3_max_abs_err": 0.0, "k3_grad_max_abs_err": 0.0,
             "model_grad_rel": 0.0, "model_grad_name": None,
             "steps_with_model_grads_beyond_1e-4": 0,
             "gru_grads_exactly_zero": pipe.stateful or None}
    t0 = time.perf_counter()
    # The per-seed form reaches the layer through ``ops``' own name.
    ta.fused_temporal_layer, ta.temporal_attention = layer_spy, attention_spy
    ta.ops.fused_temporal_layer = layer_spy
    try:
        pipe.reset_epoch_state()
        with pipe.manager.activate(TRAIN_KEY):
            for i, batch in zip(range(n_steps), pipe._loader(pipe.train_data)):
                pipe.fused = "ref"
                loss_ref, _ = pipe._loss_and_state(batch)
                grads_ref = _flat(pipe._grads(loss_ref))
                pipe.fused = None
                loss, new_state = pipe._loss_and_state(batch)
                grads = pipe._grads(loss)
                dl = abs(loss.item() - loss_ref.item())
                check(dl <= STEP_LOSS_TOL, f"train step {i}: loss {loss.item()} "
                                           f"(kernels) vs {loss_ref.item()} (plain)")
                worst["loss"] = max(worst["loss"], dl)
                check(bool(seen), f"train step {i}: the kernel path ran no kernel")
                worst["calls_per_step"] = {k: len(v) for k, v in seen.items()}
                for c, rec in enumerate(seen.pop("layer", [])):
                    a, g = rec["args"], rec["g"]
                    err = compare(torch, ta.fused_temporal_layer_kernel(**a),
                                  ta.fused_temporal_layer_ref(**a),
                                  f"K1 train step {i} call {c}")
                    errs = compare_grads(torch, ta.fused_temporal_layer_bwd_kernel(g, **a),
                                         ta.fused_temporal_layer_bwd_ref(g, **a),
                                         f"K2 train step {i} call {c}")
                    worst["k1_max_abs_err"] = max(worst["k1_max_abs_err"], err)
                    worst["k2_max_rel_err"] = max(worst["k2_max_rel_err"],
                                                  *(e[1] for e in errs.values()))
                for c, rec in enumerate(seen.pop("attention", [])):
                    a, g = rec["args"], rec["g"]
                    err = compare(torch, ta.temporal_attention_kernel(*a),
                                  ta.temporal_attention_ref(*a),
                                  f"K3 train step {i} call {c}")
                    got = ta.temporal_attention_bwd_kernel(g, *a)
                    want = plain_attention_grads(torch, g, *a)
                    gerr = max(compare(torch, x, y, f"K3b d{n} train step {i} call {c}")
                               for n, x, y in zip("qkv", got, want))
                    worst["k3_max_abs_err"] = max(worst["k3_max_abs_err"], err)
                    worst["k3_grad_max_abs_err"] = max(worst["k3_grad_max_abs_err"], gerr)
                beyond = False
                for name, gr in _flat(grads).items():
                    want = grads_ref[name]
                    if pipe.stateful and name.startswith("gru/"):
                        check(not bool(gr.any()) and not bool(want.any()),
                              f"train step {i}: GRU gradient {name} is not zero")
                    e = float((gr - want).abs().max())
                    scale = float(want.abs().max())
                    beyond |= e > GRAD_RTOL * scale + GRAD_FLOOR
                    rel = e / scale if scale else 0.0
                    if rel > worst["model_grad_rel"] and e > GRAD_FLOOR:
                        worst.update(model_grad_rel=rel, model_grad_name=name)
                worst["steps_with_model_grads_beyond_1e-4"] += int(beyond)
                pipe._update(grads)
                if pipe.stateful:
                    pipe.model_state = new_state
    finally:
        ta.fused_temporal_layer, ta.temporal_attention = layer, attention
        ta.ops.fused_temporal_layer = layer
    torch.cuda.synchronize()
    worst["seconds"] = time.perf_counter() - t0
    return worst


def run_epoch(torch, pipe, fused, val_mrr=True):
    """One ``train_epoch()`` with ``pipe.fused = fused``, launch counts zeroed
    just before it and read just after, then (with ``val_mrr``) val MRR."""
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    pipe.fused = fused
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    loss, secs = pipe.train_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(LAUNCHES)
    mrr = pipe.evaluate("val")[0] if val_mrr else None
    return dict(loss=loss, epoch_seconds=wall, train_epoch_seconds=secs,
                ms_per_step=1e3 * wall / n_train, val_mrr=mrr,
                launches=launches)


def train_phase(torch):
    """Training through the user's entry point: ``compile`` then one
    ``train_epoch`` on full-scale wikipedia through the kernels (K1 and K2
    launched once per train batch), val MRR after it, a checkpoint round
    trip; then the same epoch from the same initial state with
    ``fused="ref"``. Before the epochs, the first train steps are held step
    by step (``step_parity``)."""
    import shutil

    from repro_torch.tree import tree_leaves, tree_map

    def snapshot(tree):
        return tree_map(lambda t: t.detach().clone(), tree)

    def equal(a, b):
        return _flat(a).keys() == _flat(b).keys() and all(
            torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    t0 = time.perf_counter()
    pipe = quickstart({"epochs": 1}).compile(device=DEVICE)
    setup_s = time.perf_counter() - t0
    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    init = snapshot(pipe.params), snapshot(pipe.opt_state)

    parity = step_parity(torch, pipe, PARITY_STEPS)
    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])

    def epoch(fused):
        return run_epoch(torch, pipe, fused)

    run = epoch(None)
    launches = run["launches"]
    check(launches["fused_temporal_layer"] == n_train
          and launches["fused_temporal_layer_bwd"] == n_train,
          f"train epoch launched K1 {launches['fused_temporal_layer']} and K2 "
          f"{launches['fused_temporal_layer_bwd']} times for {n_train} batches")
    check(math.isfinite(run["loss"]) and 0.0 < run["val_mrr"] <= 1.0,
          f"train epoch: loss {run['loss']}, val MRR {run['val_mrr']}")
    state = hook.state_dict()

    # Checkpoint round trip on the card: bit-equal state back.
    ck_dir = ROOT / "checkpoints" / "chip_smoke"
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        saved = snapshot(pipe.params), snapshot(pipe.opt_state)
        pipe.save_checkpoint(str(ck_dir), 1)
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])
        check(pipe.restore_checkpoint(str(ck_dir)) == 1, "checkpoint step")
        check(equal(pipe.params, saved[0]) and equal(pipe.opt_state, saved[1]),
              "checkpoint round trip changed the parameters or optimizer state")
        check(pipe.params["nodes"]["emb"].device == pipe.device,
              "restored parameters are not on the pipeline's device")
        restored = hook.state_dict()
        check(all((restored[k] == state[k]).all() for k in state),
              "checkpoint round trip changed the sampler state")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    plain = epoch("ref")
    check(plain["launches"]["fused_temporal_layer"] == 0
          and plain["launches"]["fused_temporal_layer_bwd"] == 0,
          "fused='ref' launched a kernel")
    state_ref = hook.state_dict()
    for k_ in state:
        check(bool((state[k_] == state_ref[k_]).all()),
              f"sampler state {k_!r} differs between the two train epochs")
    prefetch = prefetch_check(torch, pipe)
    dl, dm = abs(run["loss"] - plain["loss"]), abs(run["val_mrr"] - plain["val_mrr"])
    check(dl <= EPOCH_LOSS_TOL, f"epoch loss {run['loss']} (kernels) vs "
                                f"{plain['loss']} (plain): beyond {EPOCH_LOSS_TOL}")
    check(dm <= TRAIN_MRR_TOL, f"val MRR after the epoch {run['val_mrr']} "
                               f"(kernels) vs {plain['val_mrr']} (plain): "
                               f"beyond {TRAIN_MRR_TOL}")
    return dict(train_batches=n_train,
                train_events=pipe.train_data.num_edge_events,
                setup_seconds=setup_s, step_parity=dict(steps=PARITY_STEPS, **parity),
                kernels=run, plain=plain, prefetch_loader=prefetch,
                loss_diff=dl, mrr_diff=dm)


def prefetch_loader(pipe, data):
    """The ported ``PrefetchLoader`` over ``data`` with the pipeline's hooks
    (producer thread, side stream, pinned slots), as the reference's
    pipeline builds it; the port's pipeline itself runs the hooks in the
    calling thread (``pipe._loader``)."""
    from repro_torch.core import DGDataLoader, DGraph, PrefetchLoader

    return PrefetchLoader(
        DGDataLoader(DGraph(data), pipe.manager, batch_size=pipe.batch_size),
        device=pipe.device, prefetch=pipe.sampler_spec.prefetch)


def prefetch_check(torch, pipe, n_steps: int = 60):
    """``PrefetchLoader`` on the card, off the main path: with a train step
    on each batch while the producer samples and stages the next ones on
    its side stream, its first ``n_steps`` batches are bit-equal to the
    calling thread's (each copied after its step ran, so a buffer reused
    or rewritten too early would show). Changes the parameters."""
    import numpy as np

    from repro_torch.core import TRAIN_KEY

    def batches(loader):
        pipe.reset_epoch_state()
        out = []
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(loader(pipe.train_data))
            try:
                for _, b in zip(range(n_steps), it):
                    pipe._train_step(b)
                    out.append({k: b[k].clone() if isinstance(b[k], torch.Tensor)
                                else np.array(b[k], copy=True) for k in b.keys()})
            finally:
                it.close()
        torch.cuda.synchronize()
        return out

    pipe.fused = None
    inline = batches(pipe._loader)
    staged = batches(lambda data: prefetch_loader(pipe, data))
    check(len(staged) == len(inline) == n_steps, "prefetch check: batch count")
    sink_diffs = 0
    for i, (a, b) in enumerate(zip(staged, inline)):
        check(a.keys() == b.keys(), f"prefetch batch {i}: keys differ")
        for k in a:
            x, y = a[k], b[k]
            if k == "nbr_buf":
                # The sampler's sink row (last) takes the padding's duplicate
                # scatter writes, which CUDA lands in any order; nothing
                # reads it (the sampler's state_dict drops it too).
                sink_diffs += int((x[-1] != y[-1]).sum())
                x, y = x[:-1], y[:-1]
            if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
                same = x.device == y.device and torch.equal(x, y)
            else:
                same = type(x) is type(y) and np.array_equal(x, y)
            check(same, f"prefetch batch {i}: {k!r} differs from the "
                        f"calling thread's")
    return {"steps": n_steps, "bit_equal": True,
            "sink_row_entries_differing": sink_diffs}


# ---------------------------------------------------------------------------
# DTDG slice: K4 (segment sum) and the snapshot link pipeline
# ---------------------------------------------------------------------------
def dtdg_experiment(model: str = "gclstm"):
    """Table 3's DTDG configuration at full data scale: hourly snapshots of
    synthetic ``wikipedia`` (9,000 nodes, 720 snapshots of capacity 256),
    ``model`` with ``d_embed`` 64 (``d_node`` 256), AdamW lr 1e-3, one
    train and 20 eval negatives per edge."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, TrainSpec

    return Experiment(data=DataSpec("wikipedia", scale=1.0, discretization="h"),
                      model=ModelSpec(model, {"d_embed": 64}),
                      train=TrainSpec(eval_negatives=20))


# Idle seconds before and after the calls inside every profiled window.
# Late in a full run the profiler loses device kernels (cause not found):
# at ~160 s into the run it kept neither a known matmul nor an elementwise
# launch with no margin (nor with 0.25 s), both with 2 s in one run and
# neither in another (``profiler_clock``), while a young process keeps
# them with none; with 2 s every K5/K6 reading of a full run came through
# (PERF.md). K5/K6 also report their CUDA-event time, which needs no
# profiler. With 1 s margins a full run lost every reading of the grouped
# windows of ``dtdg_kernels``, ``classic_kernels`` and ``tgat2`` (NVIDIA
# H100 80GB HBM3, 700.00 W), so the leading margin stays 2 s; the kernel
# phases measure a shape's calls in one grouped window instead of one
# window a call (``grouped_device_us``). A 0.25 s margin after the calls
# (2 s before) lost every such reading too, so both stay 2 s.
PROFILE_MARGIN_S = 2.0


def device_us_per_call(torch, fn, n: int = 50, by_kernel: bool = False):
    """Device time (µs) per call of ``fn`` from ``torch.profiler``: the sum
    of the device kernels ``n`` calls launch, over ``n`` (after a warm-up
    call), the calls between idle margins of PROFILE_MARGIN_S; None when
    the profiler recorded no device kernel (not measured). ``by_kernel``:
    a dict of µs per call by kernel name instead (empty when none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if by_kernel:
        out = {}
        for name, us in spans:
            out[name] = out.get(name, 0.0) + us / n
        return out
    return sum(us for _, us in spans) / n if spans else None


def profiler_clock(torch, margin_s: float = 0.0):
    """What the profiler records of two known launches, a cuBLAS matmul and
    an ATen elementwise kernel, with host and device activities: the device
    kernels it kept and each one's start minus the host start of its launch
    call. Run early in the process and again before ``lm_kernels``, there
    with no margin and with ``margin_s`` idle seconds before and after the
    launches: the evidence for PROFILE_MARGIN_S."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2048, 2048, device=DEVICE)
    work = (lambda: torch.mm(x, x), lambda: x.add(1.0))
    for fn in work:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for fn in work:
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    ev = prof.profiler.kineto_results.events()
    launch = {e.correlation_id(): e.start_ns() for e in ev
              if e.device_type().name == "CPU" and "aunch" in e.name()}
    kern = [e for e in ev if e.device_type().name == "CUDA"]
    return {"device_kernels": [e.name()[:60] for e in kern],
            "launch_to_kernel_us": [
                (e.start_ns() - launch[c]) / 1e3 for e in kern
                for c in (e.correlation_id(), e.linked_correlation_id())
                if c in launch],
            "margin_s": margin_s, "process_seconds": time.perf_counter() - T_START}


def edge_order_sum(x, ids, G):
    """The segment sum as a plain loop on the host: each row added to its
    segment's float32 sum in edge order from +0.0, ids outside [0, G)
    dropped; the bits K4 must give."""
    import numpy as np

    x, ids = x.cpu().numpy(), ids.cpu().numpy()
    out = np.zeros((G, x.shape[1]), np.float32)
    for e in np.flatnonzero((ids >= 0) & (ids < G)):
        out[ids[e]] += x[e]
    return out


def segment_bound(n_kept, E, D, G):
    """Least time (ms) for one segment sum: ids and edge rows read once, the
    (G, D) output written once; one add per element of a kept edge row.
    Returns (bound_ms, bound_by, bytes, flops)."""
    return _bound(4 * (E * D + E + G * D), n_kept * D)


def dtdg_kernels_phase(torch, data):
    """K4 against its plain version on the card at the main path's shapes
    (the largest hourly snapshot, E = 256 ids, and the largest daily one,
    E = 2,048, over G = 9,000 nodes, at the layer's widths D = 1 and 64;
    padding edges carry id 0 and zero rows, as the GCN layer gives them)
    and on degenerate inputs. Times by CUDA events for the kernel, its plain
    version and ``index_add_`` into zeros (the one PyTorch call computing
    the same function here): per call over back-to-back calls, which at
    these sizes measures the host's launch rate as much as the device; and
    the device time per call from ``torch.profiler`` (``*_device_us``, the
    sum of the device kernels one call launches). Also: a second launch
    bit-equal to the first, and every case's sums bit-equal to the
    edge-order float32 loop on the host (``edge_order_sum``; the CPU's
    ``index_add_`` reported beside it)."""
    from repro_torch.core import snapshot_tensor
    from repro_torch.kernels.segment_reduce import segment_sum_kernel, segment_sum_ref

    gen = torch.Generator().manual_seed(4)
    G = data.num_nodes
    results, cases = {}, []
    for unit in ("h", "d"):
        st = snapshot_tensor(data, unit, device=DEVICE)
        r = int(torch.argmax(st.counts))
        ids, mask = st.src[r].contiguous(), st.mask[r]
        E, kept = ids.shape[0], int(st.counts[r])
        for D in (1, 64):
            x = (torch.randn((E, D), generator=gen).to(DEVICE)
                 * mask[:, None]).contiguous()
            got = segment_sum_kernel(x, ids, G)
            err = compare(torch, got, segment_sum_ref(x, ids, G),
                          f"K4 {unit} E={E} D={D}")
            again = segment_sum_kernel(x, ids, G)
            cpu = segment_sum_ref(x.cpu(), ids.cpu(), G)
            loop = edge_order_sum(x, ids, G)
            check(bool((got.cpu().numpy().view("u4") == loop.view("u4")).all()),
                  f"K4 {unit} E={E} D={D}: not the edge-order sum's bits")
            bound, by, nbytes, flops = segment_bound(E, E, D, G)
            kern = lambda: segment_sum_kernel(x, ids, G)  # noqa: E731
            plain = lambda: segment_sum_ref(x, ids, G)  # noqa: E731
            lib = lambda: torch.zeros((G, D), device=DEVICE).index_add_(0, ids, x)  # noqa: E731
            us = grouped_device_us(torch, {"kern": kern, "plain": plain, "lib": lib},
                                   n=20)
            results[f"{unit}_d{D}"] = dict(
                E=E, valid_edges=kept, D=D, G=G, max_abs_err=err,
                rerun_bitwise_equal=bool(torch.equal(again, got)),
                bitwise_equal_to_edge_order_loop=True,
                bitwise_equal_to_cpu_index_add=bool(torch.equal(got.cpu(), cpu)),
                ms=time_ms(torch, kern, 200), plain_ms=time_ms(torch, plain, 200),
                library_ms=time_ms(torch, lib, 200),
                device_us=us["kern"], plain_device_us=us["plain"],
                library_device_us=us["lib"],
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            check(results[f"{unit}_d{D}"]["rerun_bitwise_equal"],
                  f"K4 {unit} D={D}: a second launch gave other bits")

    def case(name, E, D, ids, g=G):
        x = torch.randn((E, D), generator=gen).to(DEVICE)
        ids = ids.to(torch.int32).to(DEVICE)
        got = segment_sum_kernel(x, ids, g)
        err = compare(torch, got, segment_sum_ref(x, ids, g), f"K4 {name}")
        hit = torch.zeros(g, dtype=torch.bool, device=DEVICE)
        kept = ids[(ids >= 0) & (ids < g)].long()
        hit[kept] = True
        check(bool((got[~hit] == 0).all()), f"K4 {name}: empty segments not zero")
        check(bool((got.cpu().numpy().view("u4")
                    == edge_order_sum(x, ids, g).view("u4")).all()),
              f"K4 {name}: not the edge-order sum's bits")
        cases.append({"case": name, "E": E, "D": D, "G": g, "max_abs_err": err,
                      "bitwise_equal_to_edge_order_loop": True})

    def ids(lo, hi, E):
        return torch.randint(lo, hi, (E,), generator=gen)

    case("all_equal", 256, 64, torch.full((256,), 17))
    case("all_dropped", 256, 64, torch.full((256,), -1))
    case("out_of_range", 256, 64, ids(-1, G + 50, 256))
    case("e1", 1, 64, ids(0, G, 1))
    case("e0", 0, 64, ids(0, G, 0))
    case("d33", 256, 33, ids(0, G, 256))
    case("d3_g5_dups", 300, 3, ids(0, 5, 300), g=5)
    case("e5000_chunks", 5000, 64, ids(-1, G, 5000))
    case("sorted", 2048, 64, torch.sort(ids(-1, G, 2048)).values)
    case("padding_run_5000", 5000, 64,  # > 2,048 ids, > 128 listed in a tile
         torch.cat([ids(0, G, 3000), torch.zeros(2000, dtype=torch.long)]))
    case("d1_all_equal", 3000, 1, torch.full((3000,), G - 1))
    case("g1", 300, 64, ids(-1, 2, 300), g=1)
    return results, cases


def _tree_clone(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _trees_equal(torch, a, b):
    return _flat(a).keys() == _flat(b).keys() and all(
        torch.equal(x, y) for x, y in zip(_flat(a).values(), _flat(b).values()))


def dtdg_eval(torch, pipe, mode):
    """``evaluate("val")`` with ``pipe.mode = mode``, the launch count
    zeroed just before it and read just after."""
    from repro_torch.kernels.segment_reduce import LAUNCHES, reset_launches

    pipe.mode = mode
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    mrr, _ = pipe.evaluate("val")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(math.isfinite(mrr) and 0.0 < mrr <= 1.0, f"DTDG val MRR {mrr}")
    return dict(mrr=mrr, seconds=wall, launches=LAUNCHES["segment_sum"])


def dtdg_epoch(torch, pipe, mode):
    """One ``train_epoch()`` with ``pipe.mode = mode`` (launch count zeroed
    just before it and read just after), then val MRR."""
    from repro_torch.kernels.segment_reduce import LAUNCHES, reset_launches

    lo, hi = pipe._split_pairs("train")
    pipe.mode = mode
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    loss, _ = pipe.train_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = LAUNCHES["segment_sum"]
    out = dict(loss=loss, epoch_seconds=wall,
               ms_per_pair=1e3 * wall / max(hi - lo, 1), launches=launches)
    out["val_mrr"] = dtdg_eval(torch, pipe, mode)["mrr"]
    check(math.isfinite(loss), f"DTDG epoch loss {loss}")
    return out


def dtdg_step_parity(torch, pipe, n_steps):
    """The first ``n_steps`` train steps of the DTDG link pipeline, held by
    ``snapshot_step_parity``."""
    from repro_torch.models.tg.common import bce_link_loss

    def loss_and_state(x):
        pos, neg, st = pipe._scores(pipe.params, x, pipe.model_state)
        return bce_link_loss(pos, neg, x["nmask"]), st

    lo, _ = pipe._split_pairs("train")
    xs = pipe._pair_xs(lo, lo + n_steps, pipe.num_negatives)
    return snapshot_step_parity(
        torch, pipe, [{k: v[i] for k, v in xs.items()} for i in range(n_steps)],
        loss_and_state, "DTDG")


def snapshot_step_parity(torch, pipe, xs, loss_and_state, label):
    """A snapshot pipeline's train steps on the pair inputs ``xs``, each from
    the same parameters and carried state through K4 and through the plain
    version (``loss_and_state(x) -> (loss, new state)`` under ``pipe.mode``):
    the loss within DTDG_STEP_LOSS_TOL, every whole-model gradient within
    GRAD_RTOL of its leaf's largest entry (+ GRAD_FLOOR), the new state
    within the kernel tolerances; ``grad_tolerance_share`` is the largest
    error over its tolerance. The kernels' update moves the run on."""
    def tensors(state):
        return state if isinstance(state, tuple) else (state,)

    t0 = time.perf_counter()
    pipe.reset_epoch_state()
    worst = {"loss": 0.0, "model_grad_rel": 0.0, "model_grad_name": None,
             "grad_tolerance_share": 0.0, "state_max_abs_err": 0.0}
    for i, x in enumerate(xs):
        out = {}
        for mode in ("ref", "auto"):
            pipe.mode = mode
            loss, st = loss_and_state(x)
            out[mode] = (loss.detach(), pipe._grads(loss), st)
        (loss, grads, st), (loss_ref, grads_ref, st_ref) = out["auto"], out["ref"]
        dl = abs(loss.item() - loss_ref.item())
        check(dl <= DTDG_STEP_LOSS_TOL,
              f"{label} train step {i}: loss {loss.item()} (K4) vs "
              f"{loss_ref.item()} (plain)")
        worst["loss"] = max(worst["loss"], dl)
        flat_ref = _flat(grads_ref)
        for name, g in _flat(grads).items():
            want = flat_ref[name]
            e, scale = float((g - want).abs().max()), float(want.abs().max())
            tol = GRAD_RTOL * scale + GRAD_FLOOR
            check(e <= tol, f"{label} train step {i}: gradient {name} off by "
                            f"{e:.3e} (largest entry {scale:.3e})")
            worst["grad_tolerance_share"] = max(worst["grad_tolerance_share"],
                                                e / tol)
            if scale and e / scale > worst["model_grad_rel"]:
                worst.update(model_grad_rel=e / scale, model_grad_name=name)
        for a_, b_ in zip(tensors(st), tensors(st_ref)):
            worst["state_max_abs_err"] = max(
                worst["state_max_abs_err"],
                compare(torch, a_.detach(), b_.detach(), f"{label} step {i} state"))
        pipe._update(grads)
        pipe.model_state = (tuple(t.detach() for t in st) if isinstance(st, tuple)
                            else st.detach())
    pipe.mode = "auto"
    torch.cuda.synchronize()
    worst["seconds"] = time.perf_counter() - t0
    return worst


def dtdg_phase(torch, data):
    """The DTDG slice through the user's entry point on full-scale
    wikipedia, hourly snapshots: the ``SnapshotTensor`` built on the card
    (bit-equal to the CPU build, build seconds); GCLSTM ``evaluate("val")``
    through K4 (16 launches per snapshot: the advance-only warm steps and
    the scored pairs) and with ``mode="ref"`` from the same parameters; the
    first train steps held step by step; one ``train_epoch()`` through K4
    (16 launches per pair; the backward is a gather) and val MRR after it;
    a mid-epoch checkpoint round trip with ``chunk_size`` resumed to the
    same bits as the uninterrupted epoch; the plain epoch from the same
    start, held to DTDG_EPOCH_LOSS_TOL and DTDG_MRR_TOL; last, GCN and T-GCN
    ``evaluate("val")`` through K4 against the plain version."""
    import shutil

    from repro_torch.core import snapshot_tensor

    t = time.perf_counter()
    st_cpu = snapshot_tensor(data, "h", device="cpu")
    cpu_s = time.perf_counter() - t
    build_s = []
    for _ in range(2):  # the first build includes the card's warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        st = snapshot_tensor(data, "h", device=DEVICE)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t)
    for name in ("src", "dst", "mask", "counts"):
        a, b = getattr(st, name), getattr(st_cpu, name)
        check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
              f"SnapshotTensor {name}: the card's build differs from the CPU's")
    check((st.t0, st.ticks, st.capacity) == (st_cpu.t0, st_cpu.ticks,
                                            st_cpu.capacity), "SnapshotTensor meta")
    snap = dict(num_snapshots=st.num_snapshots, capacity=st.capacity,
                classes=int(st.counts.sum()), largest=int(st.counts.max()),
                cpu_build_seconds=cpu_s, card_build_seconds=build_s,
                bit_equal_to_cpu=True)

    t = time.perf_counter()
    pipe = dtdg_experiment().compile(data=data, device=DEVICE)
    setup_s = time.perf_counter() - t
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)
    train, val = pipe._split_pairs("train"), pipe._split_pairs("val")
    n_train, n_val = train[1] - train[0], val[1] - val[0]

    ev = dtdg_eval(torch, pipe, "auto")
    expected = 16 * val[1]  # warm steps over pairs [0, val lo), then scored
    check(ev["launches"] == expected,
          f"GCLSTM eval launched K4 {ev['launches']} times, expected {expected}")
    ev_ref = dtdg_eval(torch, pipe, "ref")
    check(ev_ref["launches"] == 0, "mode='ref' launched K4")
    check(abs(ev["mrr"] - ev_ref["mrr"]) <= MRR_TOL,
          f"GCLSTM val MRR {ev['mrr']} (K4) vs {ev_ref['mrr']} (plain)")

    parity = dtdg_step_parity(torch, pipe, PARITY_STEPS)

    def restart():
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])

    restart()
    run = dtdg_epoch(torch, pipe, "auto")
    check(run["launches"] == 16 * n_train,
          f"GCLSTM epoch launched K4 {run['launches']} times for {n_train} pairs")
    final = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

    # Mid-epoch checkpoint round trip: two chunks, save, clobber, restore,
    # finish the epoch; K4 and the rest of the step are deterministic, so
    # the result is the uninterrupted epoch's to the bit.
    ck_dir = ROOT / "checkpoints" / "chip_smoke_dtdg"
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        restart()
        pipe.chunk_size = 100
        first = pipe.train_chunk() + pipe.train_chunk()
        saved = (_tree_clone(pipe.params), _tree_clone(pipe.opt_state),
                 tuple(t.clone() for t in pipe.model_state), pipe.snapshot_cursor)
        pipe.save_checkpoint(str(ck_dir), 3)
        restart()
        pipe.reset_epoch_state()
        pipe._cursor = 0
        check(pipe.restore_checkpoint(str(ck_dir)) == 3, "DTDG checkpoint step")
        check(_trees_equal(torch, pipe.params, saved[0])
              and _trees_equal(torch, pipe.opt_state, saved[1])
              and all(torch.equal(a, b) for a, b in zip(pipe.model_state, saved[2]))
              and pipe.snapshot_cursor == saved[3] == 200,
              "DTDG checkpoint round trip changed the state")
        check(pipe.params["emb"].device == pipe.device, "restored off the card")
        rest_loss, _ = pipe.train_epoch()
        check(_trees_equal(torch, pipe.params, final[0])
              and _trees_equal(torch, pipe.opt_state, final[1]),
              "the resumed epoch's parameters differ from the uninterrupted one's")
        combined = (sum(first) + rest_loss * (n_train - 200)) / n_train
        check(abs(combined - run["loss"]) <= 1e-6 * abs(run["loss"]),
              f"resumed epoch loss {combined} vs {run['loss']}")
    finally:
        pipe.chunk_size = None
        shutil.rmtree(ck_dir, ignore_errors=True)

    restart()
    plain = dtdg_epoch(torch, pipe, "ref")
    check(plain["launches"] == 0, "mode='ref' launched K4 in training")
    dl, dm = abs(run["loss"] - plain["loss"]), abs(run["val_mrr"] - plain["val_mrr"])
    check(dl <= DTDG_EPOCH_LOSS_TOL,
          f"GCLSTM epoch loss {run['loss']} (K4) vs {plain['loss']} (plain)")
    check(dm <= DTDG_MRR_TOL,
          f"GCLSTM val MRR after the epoch {run['val_mrr']} (K4) vs "
          f"{plain['val_mrr']} (plain)")

    others = {}
    for name, per in (("gcn", 8), ("tgcn", 12)):
        p = dtdg_experiment(name).compile(data=data, device=DEVICE)
        a, b = dtdg_eval(torch, p, "auto"), dtdg_eval(torch, p, "ref")
        lo, hi = p._split_pairs("val")
        want = per * ((hi - lo) if name == "gcn" else hi)
        check(a["launches"] == want and b["launches"] == 0,
              f"{name} eval launched K4 {a['launches']} times, expected {want}")
        check(abs(a["mrr"] - b["mrr"]) <= MRR_TOL,
              f"{name} val MRR {a['mrr']} (K4) vs {b['mrr']} (plain)")
        others[name] = dict(kernel=a, plain=b)
        del p

    return dict(snapshots=snap, setup_seconds=setup_s, train_pairs=n_train,
                val_pairs=n_val, val_lo=val[0], eval=ev, eval_ref=ev_ref,
                step_parity=dict(steps=PARITY_STEPS, **parity), kernels=run,
                plain=plain, loss_diff=dl, mrr_diff=dm,
                checkpoint_resume_bit_equal=True, other_models=others)


# ---------------------------------------------------------------------------
# The classic path: K3, the host recency sampler, and TGN on both samplers
# ---------------------------------------------------------------------------
def attention_inputs(torch, gen, S, *, k=K, h=H, d=D, dtype=None, mask="path"):
    """Random K3 operands on the card: q, k, v ~ N(0, 1) (the scale of the
    projected rows) in ``dtype`` (float32 by default) and an (S, k) mask:
    "path" shaped like the host sampler's after its warm pass (80% of the
    seeds with all k slots, the rest with 0..k), "none" (every slot masked)
    or "one" (one valid slot per seed)."""
    q = torch.randn((S, h, d), generator=gen)
    kk = torch.randn((S, k, h, d), generator=gen)
    v = torch.randn((S, k, h, d), generator=gen)
    if mask == "path":
        cnt = torch.where(torch.rand((S, 1), generator=gen) < 0.8, k,
                          torch.randint(0, k + 1, (S, 1), generator=gen))
        m = torch.arange(k)[None] < cnt
    else:
        m = torch.zeros((S, k), dtype=torch.bool)
        if mask == "one":
            m[torch.arange(S), torch.randint(0, k, (S,), generator=gen)] = True
    dtype = dtype or torch.float32
    return [x.to(DEVICE, dtype) for x in (q, kk, v)] + [m.to(DEVICE)]


def attention_bound(q, k, v, mask):
    """Least time (ms) for one K3 call on these inputs: q and the mask read
    once, each valid slot's key and value rows read once, the output written
    once; per valid slot and head its score (2 D), the softmax (5) and its
    share of the weighted sum (2 D). Returns (bound_ms, bound_by, bytes,
    flops)."""
    S, h, d = q.shape
    b, slots = q.element_size(), int(mask.sum())
    nbytes = 2 * b * S * h * d + mask.numel() + 2 * b * slots * h * d
    return _bound(nbytes, slots * h * (4 * d + 5))


def bwd_attention_bound(q, k, v, mask):
    """Least time (ms) for one K3b call on these inputs: g, q and the mask
    read once, each valid slot's key and value rows read once, dq and the
    whole dk and dv (masked slots' zeros included) written once; per valid
    slot and head its score and dp (4 D), the softmax and ds (10), its
    share of dq (2 D), its dk and dv rows (2 D). Returns (bound_ms,
    bound_by, bytes, flops)."""
    S, h, d = q.shape
    K = k.shape[1]
    b, slots = q.element_size(), int(mask.sum())
    nbytes = (3 * b * S * h * d + mask.numel() + 2 * b * slots * h * d
              + 2 * b * S * K * h * d)
    return _bound(nbytes, slots * h * (8 * d + 10))


def plain_attention_grads(torch, g, q, k, v, m):
    """K3's gradient by plain autograd through ``temporal_attention_ref``
    (what the reference's XLA gradient is to its oracle)."""
    from repro_torch.kernels.temporal_attention import temporal_attention_ref

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = temporal_attention_ref(*leaves, m)
        return torch.autograd.grad(out, leaves, g)


def ta_plan_checked(torch, q, k, backward=False, aligned_with=()):
    """``kernel.ta_plan`` for K3's (or K3b's) operands, held equal to the
    plan the CUDA source computes (``temporal_attention_plan``)."""
    import ctypes

    from repro_torch.kernels.temporal_attention import kernel as tk

    S, H, D = q.shape
    K = k.shape[1]
    aligned = tk._aligned(q, k, *aligned_with)
    plan = tk.ta_plan(S, K, H, D, q.dtype, aligned, backward=backward)
    out = (ctypes.c_longlong * 5)()
    tk._ta_library().temporal_attention_plan(
        K, H, D, tk._TA_DTYPES[q.dtype], int(plan["vector_bytes"] == 16),
        int(backward), out)
    want = [plan[n] for n in ("warps", "chunk", "vector_bytes", "warp_bytes", "block_bytes")]
    check(list(out) == want, f"ta_plan {want} != the CUDA source's plan {list(out)} "
                             f"(S={S} K={K} H={H} D={D} {q.dtype} backward={backward})")
    check(tk._ta_vec(H, D, q, k, *aligned_with) == int(plan["vector_bytes"] == 16),
          f"the wrapper's path differs from ta_plan's (S={S} K={K} H={H} D={D})")
    return plan


def k3_phase(torch):
    """K3 (masked seed -> K-neighbor attention over pre-gathered k/v) and
    K3b (its gradient) against their plain versions on the card at the
    classic path's shapes (train S = 600 and eval S = 4,400 seeds, K = 10,
    H = 2, D = 50, float32), each with a second launch held bitwise to the
    first: K3 against ``temporal_attention_ref``, K3b's dq, dk and dv
    against plain autograd through it and against
    ``temporal_attention_bwd_ref``, with exact zeros on masked slots and
    rows without a valid slot; times (CUDA events over back-to-back calls,
    and the device time per call by ``torch.profiler``) of each kernel, its
    plain version and ``scaled_dot_product_attention`` (K3b: its forward and
    backward) on (S', H, 1, D) x (S', H, K, D) with the boolean mask over the
    S' rows that have a valid slot (SDPA gives no zeros for a row without
    one, so those rows are left out of its call), beside the bounds
    (``attention_bound``, ``bwd_attention_bound``). Then the gradient
    through ``_TemporalAttentionFn`` against plain autograd, and the
    degenerate inputs, each through both kernels: every slot masked (exact
    zeros), rows without a valid slot, one valid slot, K = 1, K = 17 (two
    chunks, with rows whose first chunk is all masked), K = 300, S = 1, S =
    0 (no launch), D = 33 and 128, an offset view (the scalar path),
    bfloat16 at both path shapes (tolerance BF16_TOL; the scalar path at D
    = 50) and at D = 64 (the 16-byte path). Every call's launch plan is
    held equal to the CUDA source's."""
    import torch.nn.functional as F

    from repro_torch.kernels.temporal_attention import (
        LAUNCHES,
        temporal_attention,
        temporal_attention_bwd_kernel,
        temporal_attention_bwd_ref,
        temporal_attention_kernel,
        temporal_attention_ref,
    )

    def both(label, q, k, v, m, g, tol=ATOL):
        """Both kernels on one input: errors, exact zeros, bitwise reruns."""
        empty = ~m.any(-1)
        plan = ta_plan_checked(torch, q, k, aligned_with=(v,))
        ta_plan_checked(torch, q, k, backward=True, aligned_with=(v, g))
        got = temporal_attention_kernel(q, k, v, m)
        err = compare(torch, got, temporal_attention_ref(q, k, v, m), f"K3 {label}", tol)
        check(bool((got[empty] == 0).all()), f"K3 {label}: empty rows not exactly zero")
        check(bool(torch.equal(temporal_attention_kernel(q, k, v, m), got)),
              f"K3 {label}: a second launch gave other bits")
        grads = temporal_attention_bwd_kernel(g, q, k, v, m)
        plain = plain_attention_grads(torch, g, q, k, v, m)
        formulas = temporal_attention_bwd_ref(g, q, k, v, m)
        gerr = {}
        for name, a, b, c in zip(("dq", "dk", "dv"), grads, plain, formulas):
            check(a.dtype == q.dtype and a.shape == b.shape, f"K3b {label}: {name} "
                                                             f"{a.dtype} {tuple(a.shape)}")
            gerr[name] = compare(torch, a, b, f"K3b {label} {name} (plain autograd)", tol)
            compare(torch, a, c, f"K3b {label} {name} (temporal_attention_bwd_ref)", tol)
        dq, dk, dv = grads
        check(bool((dq[empty] == 0).all()) and bool((dk[~m] == 0).all())
              and bool((dv[~m] == 0).all()),
              f"K3b {label}: masked slots or empty rows not exactly zero")
        again = temporal_attention_bwd_kernel(g, q, k, v, m)
        check(all(bool(torch.equal(a, b)) for a, b in zip(again, grads)),
              f"K3b {label}: a second launch gave other bits")
        return dict(S=q.shape[0], K=k.shape[1], D=q.shape[2], dtype=str(q.dtype),
                    empty_rows=int(empty.sum()), chunk=plan["chunk"],
                    vector_bytes=plan["vector_bytes"], max_abs_err=err,
                    grad_max_abs_err=gerr, rerun_bitwise_equal=True)

    gen = torch.Generator().manual_seed(3)
    results, cases = {}, []
    with torch.no_grad():
        for name, S in (("train", TRAIN_S), ("eval", EVAL_S)):
            q, k, v, m = attention_inputs(torch, gen, S)
            g = torch.randn((S, H, D), generator=gen).to(DEVICE)
            r = both(f"{name} S={S}", q, k, v, m, g)
            live = m.any(-1)
            sq = q[live].unsqueeze(2).contiguous()                # (S', H, 1, D)
            sk = k[live].permute(0, 2, 1, 3).contiguous()         # (S', H, K, D)
            sv = v[live].permute(0, 2, 1, 3).contiguous()
            sm = m[live][:, None, None, :].contiguous()          # (S', 1, 1, K)
            sg = g[live].unsqueeze(2).contiguous()
            leaves = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]

            def sdpa():
                return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)

            def sdpa_fwd_bwd():
                with torch.enable_grad():
                    out = F.scaled_dot_product_attention(*leaves, attn_mask=sm)
                    return torch.autograd.grad(out, leaves, sg)

            got = temporal_attention_kernel(q, k, v, m)
            lib_diff = float((sdpa()[:, :, 0, :] - got[live]).abs().max())
            bound, by, nbytes, flops = attention_bound(q, k, v, m)
            kern = lambda: temporal_attention_kernel(q, k, v, m)  # noqa: E731
            plain = lambda: temporal_attention_ref(q, k, v, m)  # noqa: E731
            us = grouped_device_us(torch, {"kern": kern, "plain": plain, "sdpa": sdpa},
                                   n=10)
            r.update(valid_slots=int(m.sum()), rows_without_valid_slot=int((~live).sum()),
                     ms=time_ms(torch, kern, 20), plain_ms=time_ms(torch, plain, 5),
                     library_ms=time_ms(torch, sdpa, 20), library_rows=int(live.sum()),
                     device_us=us["kern"], plain_device_us=us["plain"],
                     library_device_us=us["sdpa"],
                     library_max_abs_diff=lib_diff, bound_ms=bound, bound_by=by,
                     bytes=nbytes, flops=flops,
                     bound_ms_every_slot=attention_bound(q, k, v, torch.ones_like(m))[0])
            r["bound_share"] = bound / r["ms"]
            r["bound_share_device"] = (1e3 * bound / r["device_us"]
                                       if r["device_us"] else None)
            results[f"K3_{name}"] = r
            bound, by, nbytes, flops = bwd_attention_bound(q, k, v, m)
            kern = lambda: temporal_attention_bwd_kernel(g, q, k, v, m)  # noqa: E731
            plain = lambda: temporal_attention_bwd_ref(g, q, k, v, m)  # noqa: E731
            autograd = lambda: plain_attention_grads(torch, g, q, k, v, m)  # noqa: E731
            us = grouped_device_us(torch, {"kern": kern, "plain": plain,
                                           "autograd": autograd,
                                           "sdpa": sdpa_fwd_bwd}, n=10)
            rb = dict(S=S, max_abs_err=max(r["grad_max_abs_err"].values()),
                      errors=r["grad_max_abs_err"], rerun_bitwise_equal=True,
                      ms=time_ms(torch, kern, 20), plain_ms=time_ms(torch, plain, 5),
                      plain_autograd_ms=time_ms(torch, autograd, 5),
                      library_ms=time_ms(torch, sdpa_fwd_bwd, 20),
                      device_us=us["kern"], plain_device_us=us["plain"],
                      plain_autograd_device_us=us["autograd"],
                      library_device_us=us["sdpa"],
                      bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            rb["bound_share"] = bound / rb["ms"]
            rb["bound_share_device"] = (1e3 * bound / rb["device_us"]
                                        if rb["device_us"] else None)
            results[f"K3b_{name}"] = rb

        def case(label, S, tol=ATOL, offset=False, **kw):
            q, k, v, m = attention_inputs(torch, gen, S, **kw)
            if label == "empty_rows":
                m[::5] = False
            if label.startswith("k17") or label == "k300":  # rows that start late
                m[::2, :16] = False
                m[::7] = False
            g = torch.randn(q.shape, generator=gen).to(DEVICE, q.dtype)
            if offset:  # contiguous views 4 bytes past an aligned start
                q, k, v, g = (torch.empty(x.numel() + 1, dtype=x.dtype, device=DEVICE)[1:]
                              .view(x.shape).copy_(x) for x in (q, k, v, g))
            cases.append({"case": label, **both(label, q, k, v, m, g, tol)})
            return cases[-1]

        zero = case("all_masked", 64, mask="none")
        check(zero["empty_rows"] == 64, "K3 all_masked: expected every row empty")
        case("empty_rows", TRAIN_S)
        case("one_valid_slot", TRAIN_S, mask="one")
        case("k1", TRAIN_S, k=1)
        c = case("k17", TRAIN_S, k=17)
        check(c["chunk"] == 16, f"K3 k17: chunk {c['chunk']}, expected a split at 16")
        case("k300", 64, k=300)
        case("s1", 1)
        c = case("d33", TRAIN_S, d=33)
        check(c["vector_bytes"] == 4, "K3 d33: expected the scalar path")
        case("d128", TRAIN_S, d=128)
        c = case("offset_view", TRAIN_S, offset=True)
        check(c["vector_bytes"] == 4, "K3 offset_view: expected the scalar path")
        case("bf16_train", TRAIN_S, tol=BF16_TOL, dtype=torch.bfloat16)
        case("bf16_eval", EVAL_S, tol=BF16_TOL, dtype=torch.bfloat16)
        c = case("bf16_d64", TRAIN_S, tol=BF16_TOL, dtype=torch.bfloat16, d=64)
        check(c["vector_bytes"] == 16, "K3 bf16_d64: expected the 16-byte path")
        q, k, v, m = attention_inputs(torch, gen, 0)
        before = dict(LAUNCHES)
        out = temporal_attention_kernel(q, k, v, m)
        grads = temporal_attention_bwd_kernel(out, q, k, v, m)
        check(tuple(out.shape) == (0, H, D) and LAUNCHES == before
              and [tuple(x.shape) for x in grads] == [(0, H, D), (0, K, H, D), (0, K, H, D)],
              "K3/K3b S=0: wrong shape or a launch")
        cases.append({"case": "s0", "S": 0, "launched": False})

    # The gradient through the Function: K3 forward, K3b backward.
    q, k, v, m = attention_inputs(torch, gen, TRAIN_S)
    m[::7] = False
    g = torch.randn((TRAIN_S, H, D), generator=gen).to(DEVICE)
    before = LAUNCHES["temporal_attention_bwd"]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    temporal_attention(*leaves, m, mode="kernel").backward(g)
    check(LAUNCHES["temporal_attention_bwd"] == before + 1,
          "K3 gradient: the Function's backward did not launch K3b")
    gerr = {}
    dq, dk, dv = (t.grad for t in leaves)
    for name, a, b in zip("qkv", (dq, dk, dv), plain_attention_grads(torch, g, q, k, v, m)):
        gerr[f"d{name}"] = compare(torch, a, b, f"K3 gradient d{name}")
    check(bool((dq[~m.any(-1)] == 0).all()) and bool((dk[~m] == 0).all())
          and bool((dv[~m] == 0).all()),
          "K3 gradient: masked slots or empty rows not exactly zero")
    results["K3_grad"] = dict(S=TRAIN_S, max_abs_err=gerr, launched_k3b=True,
                              masked_exact_zero=True)
    return results, cases


def quickstart_host():
    """``examples/quickstart.py``'s experiment as written (the host recency
    sampler, ``SamplerSpec(kind="recency", k=10)``: the classic path), at
    full data scale."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    return Experiment(
        data=DataSpec("wikipedia", scale=1.0),
        model=ModelSpec("tgat", {"num_layers": 1}),
        sampler=SamplerSpec(kind="recency", k=10),
        train=TrainSpec(epochs=2, batch_size=200, eval_negatives=20),
        task="link",
    )


def eval_run(torch, pipe, fused):
    """``evaluate("val")`` with ``pipe.fused = fused``, launch counts zeroed
    just before it and read just after; the sampler's and the model's state
    after it."""
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    pipe.fused = fused
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    mrr, scored_s = pipe.evaluate("val")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    state = None if not pipe.stateful else _tree_clone(pipe.model_state)
    check(math.isfinite(mrr) and 0.0 < mrr <= 1.0, f"val MRR {mrr} out of range")
    sampler_state = hook.state_dict()
    return dict(mrr=mrr, scored_seconds=scored_s, evaluate_seconds=wall,
                launches=dict(LAUNCHES),
                state_sha256=state_digest(sampler_state)), sampler_state, state


def paired_eval(torch, pipe):
    """``evaluate("val")`` through the kernels (``eval_run(pipe, None)``:
    its MRR, launches and states) with every scored batch scored again by
    the plain version (``fused="ref"``) on the same hooks' outputs; returns
    ``eval_run``'s three and the plain scores' numbers (MRR over the same
    batches, their launch count). For the host samplers: their hooks, which
    ``fused`` does not reach, set the time of an evaluation, so the plain
    version is held batch by batch in one pass instead of a second whole
    one. Stateless models only (the plain step would move a model's state
    a second time)."""
    from repro_torch.kernels.temporal_attention import LAUNCHES
    from repro_torch.train.metrics import mrr as mrr_of

    check(not pipe.stateful, "paired_eval takes stateless models only")
    kernel_step = pipe._eval_step
    rrs, weights, plain_launches = [], [], [0]

    def both(batch):
        out = kernel_step(batch)
        before = sum(LAUNCHES.values())
        pipe.fused = "ref"
        try:
            pos, neg = kernel_step(batch)
        finally:
            pipe.fused = None
        plain_launches[0] += sum(LAUNCHES.values()) - before
        w = float(batch["batch_mask"].sum())
        rrs.append(mrr_of(pos, neg, batch["batch_mask"]) * w)
        weights.append(w)
        return out

    pipe._eval_step = both
    try:
        ev, state, model_state = eval_run(torch, pipe, None)
    finally:
        del pipe._eval_step  # back to the class's method
    plain = dict(mrr=float(sum(rrs) / max(sum(weights), 1.0)), batches=len(rrs),
                 launches=plain_launches[0], same_batches_as_the_kernel_pass=True)
    return ev, state, model_state, plain


def state_digest(state) -> str:
    """SHA-256 of a canonical sampler state (every key's int64 bytes, in
    key order): bit-equal states, equal digests, across processes."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        h.update(np.ascontiguousarray(np.asarray(state[key], np.int64)).tobytes())
    return h.hexdigest()


def _states_equal(a, b):
    return all(bool((a[k] == b[k]).all()) for k in a)


def host_phase(torch):
    """The quickstart as written, on the card: ``compile(device="cuda")``
    builds the host ``RecencySampler`` and the classic path (no packed
    buffer on the batch). ``evaluate("val")`` through K3 (one launch per val
    batch, no other kernel) and with the plain version (MRR within MRR_TOL,
    the sampler's state bit-equal); the first train steps held step by step;
    one ``train_epoch()`` through K3 and K3b (one launch each per train
    batch, no other kernel) and the same epoch with the plain
    version from the same start (the sampler's state after them bit-equal;
    loss and val MRR reported); last, the host-sampled and device-sampled
    pipelines' neighborhoods, batch by batch, bit-equal over the warm pass
    and the val batches."""
    from repro_torch.core.tg_hooks import RecencyNeighborHook

    t0 = time.perf_counter()
    pipe = quickstart_host().compile(device=DEVICE)
    setup_s = time.perf_counter() - t0
    check(any(isinstance(h, RecencyNeighborHook) for h in pipe.manager.hooks()),
          "the quickstart spec did not build the host sampler")
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

    ev, state, _ = eval_run(torch, pipe, None)
    launched = {k: v for k, v in ev["launches"].items() if v}
    check(launched == {"temporal_attention": n_val},
          f"host eval launched {launched} for {n_val} val batches")
    ev_ref, state_ref, _ = eval_run(torch, pipe, "ref")
    check(sum(ev_ref["launches"].values()) == 0, "fused='ref' launched a kernel")
    check(abs(ev["mrr"] - ev_ref["mrr"]) <= MRR_TOL,
          f"host val MRR {ev['mrr']} (K3) vs {ev_ref['mrr']} (plain)")
    check(_states_equal(state, state_ref), "host sampler state differs between "
                                           "the kernel and plain eval")

    parity = step_parity(torch, pipe, PARITY_STEPS)

    def restart():
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])

    restart()
    run = run_epoch(torch, pipe, None)
    state = pipe.manager.state_dict()
    launched = {k: v for k, v in run["launches"].items() if v}
    check(launched == {"temporal_attention": n_train, "temporal_attention_bwd": n_train},
          f"host train epoch launched {launched} for {n_train} batches")
    restart()
    plain = run_epoch(torch, pipe, "ref")
    check(sum(plain["launches"].values()) == 0, "fused='ref' launched a kernel")
    state_ref = pipe.manager.state_dict()
    for group in state:
        check(_states_equal(state[group], state_ref[group]),
              f"host sampler state {group!r} differs after the two epochs")
    return dict(setup_seconds=setup_s, val_batches=n_val, train_batches=n_train,
                eval=ev, eval_ref=ev_ref, step_parity=dict(steps=PARITY_STEPS, **parity),
                kernels=run, plain=plain, sampler_state_bit_equal=True,
                loss_diff=abs(run["loss"] - plain["loss"]),
                mrr_diff=abs(run["val_mrr"] - plain["val_mrr"]),
                neighborhoods=neighborhoods_check(torch, pipe))


def neighborhoods_check(torch, host_pipe, dev=None):
    """The host-sampled pipeline's neighborhoods against the device
    sampler's (``nbr_ids/times/eids/mask``, and the hop-2 ``nbr2_*`` when
    the hooks sample two hops), batch by batch, over the warm pass through
    train and the val batches: bit-equal, as the reference promises of its
    two samplers. ``dev`` is the device-sampled pipeline (the quickstart's
    by default). Also the median time of each loader's batch (its hooks and
    the staging on the card, closed by a synchronise): train batches (S =
    600) and scored val batches (S = 4,400)."""
    from repro_torch.core import EVAL_KEY, TRAIN_KEY

    def timed(loader, into):
        it = iter(loader)
        while True:
            torch.cuda.synchronize()
            t = time.perf_counter()
            batch = next(it, None)
            torch.cuda.synchronize()
            if batch is None:
                return
            into.append(1e3 * (time.perf_counter() - t))
            yield batch

    if dev is None:
        dev = quickstart().compile(device=DEVICE)
    names = ("nbr_ids", "nbr_times", "nbr_eids", "nbr_mask")
    counts, ms, hop2 = {}, {}, ()
    for p in (host_pipe, dev):
        p.reset_epoch_state()
    for key, data in ((TRAIN_KEY, "train_data"), (EVAL_KEY, "val_data")):
        n, th, td = 0, [], []
        with host_pipe.manager.activate(key), dev.manager.activate(key):
            for a, b in zip(timed(host_pipe._loader(getattr(host_pipe, data)), th),
                            timed(dev._loader(getattr(dev, data)), td)):
                hop2 = tuple(k.replace("nbr_", "nbr2_") for k in names) if "nbr2_ids" in a else ()
                check(("nbr2_ids" in a) == ("nbr2_ids" in b), f"{data} batch {n}: "
                      f"one sampler gave a hop-2 neighborhood, the other none")
                for name in names + hop2:
                    check(a[name].device == b[name].device and torch.equal(a[name], b[name]),
                          f"{data} batch {n}: {name} differs between the host "
                          f"and device samplers")
                n += 1
        counts[data] = n
        ms[data] = {"host_sampler_ms_per_batch": statistics.median(th),
                    "device_sampler_ms_per_batch": statistics.median(td)}
    check(counts["val_data"] == math.ceil(dev.val_data.num_edge_events / dev.batch_size),
          "neighborhood check: val batch count")
    return {"batches": counts, "bit_equal": True, "hops": 2 if hop2 else 1,
            "loader": ms}


def tgn_experiment(device_sampler: bool):
    """TGN at full width on full-scale synthetic ``wikipedia``: ``d_model``,
    ``d_memory`` and ``d_time`` 100, 2 heads, the recency sampler with k = 10
    on the host or the device, batch 200, 20 eval negatives."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    return Experiment(
        data=DataSpec("wikipedia", scale=1.0),
        model=ModelSpec("tgn", {"d_model": 100, "d_memory": 100, "d_time": 100,
                                "num_heads": 2}),
        sampler=SamplerSpec(kind="recency", k=10, device=device_sampler),
        train=TrainSpec(batch_size=200, eval_negatives=20))


def memory_update_ms(torch, pipe):
    """Time (ms, CUDA events, median of repeats) of one TGN memory update on
    a full train batch: the message build, the last-event scatter and the
    GRU over every node."""
    from repro_torch.core import TRAIN_KEY

    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        batch = next(iter(pipe._loader(pipe.train_data)))
    state = pipe.model_state
    with torch.no_grad():
        return time_ms(torch, lambda: pipe._model.update_memory(
            pipe.params, pipe.cfg, state, batch), 20)


def tgn_phase(torch, data):
    """TGN on both samplers through the user's entry point. For each:
    ``evaluate("val")`` through the kernels (device sampler: K1 once per val
    batch; host sampler: K3 once per val batch; the warm pass only advances
    the memory) and with the plain version (MRR within MRR_TOL, the sampler
    state and ``last_update`` bit-equal, the memory within ATOL/RTOL); the
    first train steps held step by step (GRU gradients exactly zero); one
    ``train_epoch()`` through the kernels (device: K1 and K2 once per train
    batch; host: K3 and K3b once per batch) with val MRR after it; a checkpoint save
    and restore on the card, bit-equal in parameters, optimizer, model state
    and sampler state."""
    out = {}
    for label, on_device in (("device", True), ("host", False)):
        t0 = time.perf_counter()
        pipe = tgn_experiment(on_device).compile(data=data, device=DEVICE)
        setup_s = time.perf_counter() - t0
        n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
        n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
        fwd = "fused_temporal_layer" if on_device else "temporal_attention"
        init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

        ev, state, mstate = eval_run(torch, pipe, None)
        launched = {k: v for k, v in ev["launches"].items() if v}
        check(launched == {fwd: n_val},
              f"TGN {label} eval launched {launched} for {n_val} val batches")
        ev_ref, state_ref, mstate_ref = eval_run(torch, pipe, "ref")
        check(sum(ev_ref["launches"].values()) == 0, "fused='ref' launched a kernel")
        check(abs(ev["mrr"] - ev_ref["mrr"]) <= MRR_TOL,
              f"TGN {label} val MRR {ev['mrr']} (kernels) vs {ev_ref['mrr']} (plain)")
        check(_states_equal(state, state_ref), f"TGN {label}: sampler state differs")
        check(torch.equal(mstate["last_update"], mstate_ref["last_update"]),
              f"TGN {label}: last_update differs between the kernel and plain eval")
        mem_err = compare(torch, mstate["memory"], mstate_ref["memory"],
                          f"TGN {label} memory after evaluate")

        parity = step_parity(torch, pipe, PARITY_STEPS)
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])
        run = run_epoch(torch, pipe, None)
        launched = {k: v for k, v in run["launches"].items() if v}
        want = ({"fused_temporal_layer": n_train, "fused_temporal_layer_bwd": n_train}
                if on_device else {"temporal_attention": n_train,
                                   "temporal_attention_bwd": n_train})
        check(launched == want,
              f"TGN {label} train epoch launched {launched} for {n_train} batches")
        check(math.isfinite(run["loss"]), f"TGN {label} epoch loss {run['loss']}")

        checkpoint_round_trip(torch, pipe, f"tgn_{label}", init)
        update_ms = memory_update_ms(torch, pipe)
        out[label] = dict(setup_seconds=setup_s, val_batches=n_val,
                          train_batches=n_train, eval=ev, eval_ref=ev_ref,
                          memory_max_abs_err=mem_err,
                          step_parity=dict(steps=PARITY_STEPS, **parity),
                          kernels=run, memory_update_ms=update_ms,
                          checkpoint_bit_equal=True)
        del pipe
    return out


# ---------------------------------------------------------------------------
# 2-layer TGAT: the reference's default TGAT (two layers, two hops, k = 20)
# ---------------------------------------------------------------------------
K20 = 20
# Train steps of 2-layer TGAT held step by step (three attention calls each:
# the seeds, the hop-1 frontier and the final hop).
TGAT2_PARITY_STEPS = 3
# Hop-2 kernel inputs: the share of padded frontier slots, and about the
# share of nodes whose buffer row is empty.
HOP2_PAD, HOP2_EMPTY = 0.2, 0.1
# The CLI on the card: the tg workload on wikipedia at this data scale (900
# nodes, 15,747 events; the full scale takes minutes an epoch on the host
# sampler's hooks), the dtdg workload at full scale, one epoch in chunks of
# 64 snapshot pairs (8 chunks), killed after 3.
CLI_TG_SCALE, CLI_DTDG_SCALE = "0.1", "1.0"
CLI_DTDG_CHUNK, CLI_DTDG_KILL = "64", "3"
CLI_TIMEOUT_S = 300


def grouped_device_us(torch, fns: dict, n: int = 5, by_kernel: bool = False) -> dict:
    """Device µs per call of each callable of ``fns`` (label -> fn), all from
    one ``torch.profiler`` window between idle margins of PROFILE_MARGIN_S:
    groups of ``n`` calls separated by ``torch.cuda._sleep`` launches (device
    kernel ``spin_kernel``); a group's time is the sum of the device kernels
    between its separators, over ``n`` (``by_kernel``: a dict of µs per call
    by kernel name instead, empty when not measured). Every label None (not
    measured) when the profiler kept other than one separator more than
    there are groups."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        torch.cuda._sleep(1000)
        for fn in fns.values():
            for _ in range(n):
                fn()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    cuts = [i for i, (_, _, name) in enumerate(spans) if "spin_kernel" in name]
    if len(cuts) != len(fns) + 1:
        return {label: {} if by_kernel else None for label in fns}
    if by_kernel:
        out = {}
        for label, lo, hi in zip(fns, cuts, cuts[1:]):
            by = out[label] = {}
            for a, b, name in spans[lo + 1:hi]:
                by[name] = by.get(name, 0.0) + (b - a) / n
        return out
    return {label: sum(b - a for a, b, _ in spans[lo + 1:hi]) / n
            for label, lo, hi in zip(fns, cuts, cuts[1:])}


def _groups_like_layer_inputs(torch, gen):
    """The time and edge groups as ``layer_inputs`` draws them."""
    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(DEVICE)

    w = math.sqrt(2.0 / (D_TIME + D_EDGE + 2 * H * D))
    return dict(time_w=randn(D_TIME, scale=0.1), time_b=randn(D_TIME, scale=0.1),
                wt_k=randn(D_TIME, H * D, scale=w), wt_v=randn(D_TIME, H * D, scale=w),
                edge_feats=randn(N_EDGES, D_EDGE), we_k=randn(D_EDGE, H * D, scale=w),
                we_v=randn(D_EDGE, H * D, scale=w))


def hop2_inputs(torch, gen, S):
    """The hop-2 call's operands for S seeds: an (S, 20) frontier over the
    buffer, tables and groups of ``layer_inputs`` at K = 20 (N = 9,000,
    E = 157,474): q (S * 20, H, D); a HOP2_PAD share of the frontier padded
    (-1) and about a HOP2_EMPTY share of the nodes with an empty buffer
    row; frontier times
    uniform over the month, so about a third of the valid slots lie after
    their frontier node's time (negative deltas, as hop-2 slots taken from
    the batch's buffer can). Returns (wrapper operands, flat operands of
    ``fused_temporal_layer``, groups)."""
    n_f = S * K20
    ops, kw = layer_inputs(torch, gen, n_f, k=K20,
                           empty_rows=int(N_NODES * HOP2_EMPTY))
    pad = (torch.rand(n_f, generator=gen) < HOP2_PAD).to(DEVICE)
    seeds = torch.where(pad, -1, ops["seeds"])
    f_t = torch.randint(0, 2_592_000, (n_f,), generator=gen, dtype=torch.int32).to(DEVICE)
    flat = dict(ops, seeds=seeds, seed_times=f_t)
    wrap = dict(q=ops["q"], k_table=ops["k_table"], v_table=ops["v_table"],
                frontier=seeds.reshape(S, K20), frontier_times=f_t.reshape(S, K20),
                buf=ops["buf"])
    return wrap, flat, kw


def per_seed_inputs(torch, gen, S):
    """The final hop's operands for S seeds: q (S, H, D) and per-seed k/v
    rows (S * 20, H, D); 80% of the seeds with all 20 slots valid, the rest
    0..20, every 16th none; slot times before the seed's but a tenth after
    it (negative deltas); edge ids with featureless -1s; the groups of
    ``layer_inputs``. Returns (wrapper operands, flat operands of
    ``fused_temporal_layer`` over the synthetic buffer, groups)."""
    from repro_torch.kernels.temporal_attention.ops import per_seed_buffer

    def randn(*shape):
        return (torch.randn(shape, generator=gen) * 0.25).to(DEVICE)

    cnt = torch.where(torch.rand((S, 1), generator=gen) < 0.8, K20,
                      torch.randint(0, K20 + 1, (S, 1), generator=gen))
    mask = torch.arange(K20)[None] < cnt
    mask[::16] = False
    seed_t = torch.randint(2_000_000, 2_592_000, (S,), generator=gen, dtype=torch.int32)
    back = torch.randint(0, 2_000_000, (S, K20), generator=gen, dtype=torch.int32)
    late = torch.rand((S, K20), generator=gen) < 0.1
    nbr_t = torch.where(late, seed_t[:, None] + 1000, seed_t[:, None] - back)
    eids = torch.randint(-1, N_EDGES, (S, K20), generator=gen, dtype=torch.int32)
    wrap = dict(q=randn(S, H, D), k_rows=randn(S * K20, H, D),
                v_rows=randn(S * K20, H, D), seed_times=seed_t.to(DEVICE),
                nbr_times=nbr_t.to(DEVICE), nbr_mask=mask.to(DEVICE),
                nbr_eids=eids.to(DEVICE))
    seeds, buf = per_seed_buffer(wrap["nbr_times"], wrap["nbr_mask"], wrap["nbr_eids"])
    flat = dict(q=wrap["q"], k_table=wrap["k_rows"], v_table=wrap["v_rows"],
                seeds=seeds, seed_times=wrap["seed_times"], buf=buf)
    return wrap, flat, _groups_like_layer_inputs(torch, gen)


def _live_rows(torch, flat):
    """Rows of a fused-layer call with a valid slot (the others are exact
    zeros in the output and in dq)."""
    rows = flat["buf"][flat["seeds"].clamp(min=0).long()]
    return (rows[..., 0] >= 0).any(-1) & (flat["seeds"] >= 0)


def _negative_delta_share(torch, flat):
    rows = flat["buf"][flat["seeds"].clamp(min=0).long()]
    valid = (rows[..., 0] >= 0) & (flat["seeds"] >= 0)[:, None]
    neg = (flat["seed_times"][:, None] - rows[..., 1]) < 0
    return float((neg & valid).sum()) / max(int(valid.sum()), 1)


def sdpa_calls(torch, q, k, v, m, g):
    """SDPA forward, and forward + backward, over the rows of K3's operands
    with a valid slot (SDPA gives no zeros for a row without one): the
    callables and the row count."""
    import torch.nn.functional as F

    live = m.any(-1)
    sq = q[live].unsqueeze(2).contiguous()                # (S', H, 1, D)
    sk = k[live].permute(0, 2, 1, 3).contiguous()         # (S', H, K, D)
    sv = v[live].permute(0, 2, 1, 3).contiguous()
    sm = m[live][:, None, None, :].contiguous()
    sg = g[live].unsqueeze(2).contiguous()
    leaves = [t.clone().requires_grad_(True) for t in (sq, sk, sv)]

    def fwd():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm)

    def fwd_bwd():
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=sm)
            return torch.autograd.grad(out, leaves, sg)

    return fwd, fwd_bwd, int(live.sum())


def tgat2_kernels(torch):
    """The 2-layer path's calls of K1, K2, K3 and K3b at its shapes (k =
    20), each against its plain version on the card: K1 in the seed form
    (S = 600 and 4,400 over the buffer), the hop-2 form (the frontier, S *
    20 = 12,000 and 88,000 queries, padded, with empty rows and negative
    deltas) and the per-seed form (S = 600 and 4,400 over 12,000- and
    88,000-row tables, negative deltas, seeds with no valid slot), through
    the wrappers the model calls; K2 at the train shapes, every gradient,
    a second run bitwise (the per-seed form's table gradients included:
    every table row is read by one seed); K3 at (600, 20), (12,000, 20),
    (4,400, 20) and (88,000, 20) with rows whose first 16-slot chunk is all
    masked and rows with no valid slot, and K3b at the train shapes (two
    chunks: the restaging pass), each rerun bitwise and its plan held to
    the CUDA source's. K1's and K2's workspace (the allocator's count)
    against ``kernel.workspace_bytes``. Times (CUDA events; device µs per call from one
    profiler window, ``grouped_device_us``), plain times, bounds and shares;
    SDPA forward (and forward + backward) over the rows with a valid slot
    for K3 (K3b)."""
    from functools import partial

    from repro_torch.kernels.temporal_attention import (
        fused_temporal_layer_bwd_kernel,
        fused_temporal_layer_bwd_ref,
        fused_temporal_layer_hop2,
        fused_temporal_layer_kernel,
        fused_temporal_layer_per_seed,
        fused_temporal_layer_ref,
        temporal_attention_bwd_kernel,
        temporal_attention_bwd_ref,
        temporal_attention_kernel,
        temporal_attention_ref,
    )
    from repro_torch.kernels.temporal_attention.kernel import workspace_bytes

    gen = torch.Generator().manual_seed(20)
    dgen = torch.Generator(device=DEVICE).manual_seed(20)
    res, timed = {}, {}

    def workspace(r, what, fn, outputs_bytes, S, backward):
        """The workspace a call allocates (the allocator's count) against
        ``kernel.workspace_bytes``."""
        r["workspace_bytes_planned"] = workspace_bytes(S, H, D, D_TIME, D_EDGE,
                                                       backward=backward)
        r["workspace_bytes"] = workspace_measured(torch, fn, outputs_bytes)
        check(r["workspace_bytes"] >= r["workspace_bytes_planned"],
              f"{what}: a call allocated {r['workspace_bytes']} bytes beyond its "
              f"outputs, less than the planned {r['workspace_bytes_planned']}")

    def record(key, kern, plain, bound, plain_reps=1, **extra):
        r = res[key] = dict(extra, ms=time_ms(torch, kern, 5, 3),
                            plain_ms=time_ms(torch, plain, plain_reps, 3),
                            bound_ms=bound[0], bound_by=bound[1], bytes=bound[2],
                            flops=bound[3])
        r["bound_share"] = bound[0] / r["ms"]
        timed[key] = kern
        return r

    with torch.no_grad():
        forms = (("seed", EVAL_S, False), ("seed", TRAIN_S, True),
                 ("hop2", EVAL_S, False), ("hop2", TRAIN_S, True),
                 ("per_seed", EVAL_S, False), ("per_seed", TRAIN_S, True))
        for form, S, train in forms:
            if form == "seed":
                flat, kw = layer_inputs(torch, gen, S, k=K20)
                kern = partial(fused_temporal_layer_kernel, **flat, **kw)
            elif form == "hop2":
                wrap, flat, kw = hop2_inputs(torch, gen, S)
                kern = partial(fused_temporal_layer_hop2, **wrap, **kw, mode="kernel")
            else:
                wrap, flat, kw = per_seed_inputs(torch, gen, S)
                kern = partial(fused_temporal_layer_per_seed, **wrap, **kw, mode="kernel")
            n = int(flat["seeds"].shape[0])
            label = f"{form} S={n}"
            plain = partial(fused_temporal_layer_ref, **flat, **kw)
            got = kern()
            err = compare(torch, got, plain(), f"K1 {label}")
            live = _live_rows(torch, flat)
            check(bool((got[~live] == 0).all()),
                  f"K1 {label}: rows without a valid slot not exactly zero")
            r = record(f"K1_{form}_{'train' if train else 'eval'}", kern, plain,
                       layer_bound(torch, flat, kw), S=n, K=K20,
                       table_rows=int(flat["k_table"].shape[0]), max_abs_err=err,
                       rows_without_valid_slot=int((~live).sum()),
                       negative_delta_share=_negative_delta_share(torch, flat))
            workspace(r, "K1 " + label, kern, got.numel() * 4, n, backward=False)
            if not train:
                continue
            g = torch.randn((n, H, D), generator=gen).to(DEVICE)
            bwd = partial(fused_temporal_layer_bwd_kernel, g, **flat, **kw)
            got = bwd()
            errs = compare_grads(torch, got, fused_temporal_layer_bwd_ref(g, **flat, **kw),
                                 f"K2 {label}")
            check(bool((got["q"][~live] == 0).all()),
                  f"K2 {label}: dq rows without a valid slot not exactly zero")
            again = bwd()
            bitwise = {k: bool(torch.equal(again[k], got[k])) for k in got}
            for k_, same in bitwise.items():
                check(same or k_ in ("k_table", "v_table"),
                      f"K2 {label}: a second run gave other bits in {k_}")
            r = record(f"K2_{form}_train", bwd,
                       partial(fused_temporal_layer_bwd_ref, g, **flat, **kw),
                       layer_bwd_bound(torch, flat, kw), S=n, K=K20,
                       table_rows=int(flat["k_table"].shape[0]),
                       max_abs_err=max(e[0] for e in errs.values()), errors=errs,
                       rerun_bitwise_equal=bitwise)
            workspace(r, "K2 " + label, bwd,
                      sum(v.numel() * v.element_size() for v in got.values()), n,
                      backward=True)
            del got, again

        for name, S, train in (("seeds_train", TRAIN_S, True),
                               ("frontier_train", TRAIN_S * K20, True),
                               ("seeds_eval", EVAL_S, False),
                               ("frontier_eval", EVAL_S * K20, False)):
            q = torch.randn((S, H, D), generator=dgen, device=DEVICE)
            k = torch.randn((S, K20, H, D), generator=dgen, device=DEVICE)
            v = torch.randn((S, K20, H, D), generator=dgen, device=DEVICE)
            g = torch.randn((S, H, D), generator=dgen, device=DEVICE)
            cnt = torch.where(torch.rand((S, 1), generator=dgen, device=DEVICE) < 0.8, K20,
                              torch.randint(0, K20 + 1, (S, 1), generator=dgen,
                                            device=DEVICE))
            m = torch.arange(K20, device=DEVICE)[None] < cnt
            m[::7, :16] = False   # the first chunk all masked
            m[::11] = False       # no valid slot (padded frontier slots)
            empty = ~m.any(-1)
            label = f"{name} S={S} K={K20}"
            plan = ta_plan_checked(torch, q, k, aligned_with=(v,))
            check(plan["chunks"] == 2, f"K3 {label}: {plan['chunks']} chunks, not 2")
            kern = partial(temporal_attention_kernel, q, k, v, m)
            plain = partial(temporal_attention_ref, q, k, v, m)
            got = kern()
            err = compare(torch, got, plain(), f"K3 {label}")
            check(bool((got[empty] == 0).all()), f"K3 {label}: empty rows not exactly zero")
            check(bool(torch.equal(kern(), got)), f"K3 {label}: a second launch gave other bits")
            sdpa, sdpa_fwd_bwd, rows = sdpa_calls(torch, q, k, v, m, g)
            r = record(f"K3_{name}", kern, plain, attention_bound(q, k, v, m),
                       plain_reps=2, S=S, K=K20, chunks=plan["chunks"], max_abs_err=err,
                       rows_without_valid_slot=int(empty.sum()), valid_slots=int(m.sum()),
                       library_rows=rows)
            r["library_ms"] = time_ms(torch, sdpa, 5, 3)
            timed[f"K3_{name}_library"] = sdpa
            del got
            if not train:
                continue
            ta_plan_checked(torch, q, k, backward=True, aligned_with=(v, g))
            bwd = partial(temporal_attention_bwd_kernel, g, q, k, v, m)
            grads = bwd()
            want = plain_attention_grads(torch, g, q, k, v, m)
            gerr = {n: compare(torch, a, b, f"K3b {label} d{n}")
                    for n, a, b in zip("qkv", grads, want)}
            dq, dk, dv = grads
            check(bool((dq[empty] == 0).all()) and bool((dk[~m] == 0).all())
                  and bool((dv[~m] == 0).all()),
                  f"K3b {label}: masked slots or empty rows not exactly zero")
            check(all(bool(torch.equal(a, b)) for a, b in zip(bwd(), grads)),
                  f"K3b {label}: a second launch gave other bits")
            r = record(f"K3b_{name}", bwd, partial(temporal_attention_bwd_ref, g, q, k, v, m),
                       bwd_attention_bound(q, k, v, m), plain_reps=2, S=S, K=K20,
                       max_abs_err=max(gerr.values()), errors=gerr,
                       rerun_bitwise_equal=True)
            r["library_ms"] = time_ms(torch, sdpa_fwd_bwd, 5, 3)
            timed[f"K3b_{name}_library"] = sdpa_fwd_bwd
            del grads, want, dq, dk, dv

        # Device time of every call above, from one profiler window.
        us = grouped_device_us(torch, timed)
    for key, r in res.items():
        r["device_us"] = us[key]
        r["bound_share_device"] = 1e3 * r["bound_ms"] / us[key] if us[key] else None
        if f"{key}_library" in us:
            r["library_device_us"] = us[f"{key}_library"]
    return res


def tgat2_experiment(device_sampler: bool):
    """``ModelSpec("tgat")`` with no kwargs (the reference's default: two
    layers, two hops) and k = 20 on full-scale synthetic ``wikipedia``,
    batch 200, 20 eval negatives; the device sampler (the fused path: K1
    and K2) or the host sampler (the CLI's default; the classic path: K3
    and K3b)."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    return Experiment(data=DataSpec("wikipedia", scale=1.0), model=ModelSpec("tgat"),
                      sampler=SamplerSpec(k=K20, device=device_sampler),
                      train=TrainSpec(batch_size=200, eval_negatives=20))


def checkpoint_round_trip(torch, pipe, label: str, init) -> bool:
    """Save ``pipe`` under ``checkpoints/chip_smoke_<label>`` (removed
    after), load ``init`` (params, optimizer state), reset, restore: the
    parameters, the optimizer state, a stateful model's state and the
    sampler state must come back bit-equal, on the pipeline's device (the
    model state in its own dtypes: TGN's int32 ``last_update``, TPNet's
    int32 ``last``)."""
    import shutil

    ck_dir = ROOT / "checkpoints" / f"chip_smoke_{label}"
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        saved = (_tree_clone(pipe.params), _tree_clone(pipe.opt_state),
                 _tree_clone(pipe.model_state) if pipe.stateful else None,
                 pipe.manager.state_dict())
        pipe.save_checkpoint(str(ck_dir), 1)
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])
        pipe.reset_epoch_state()
        check(pipe.restore_checkpoint(str(ck_dir)) == 1, f"{label}: checkpoint step")
        check(_trees_equal(torch, pipe.params, saved[0])
              and _trees_equal(torch, pipe.opt_state, saved[1])
              and all(t.device == pipe.device for t in _flat(pipe.params).values()),
              f"{label}: checkpoint round trip changed the parameters or optimizer")
        if pipe.stateful:
            got, want = _flat(pipe.model_state), _flat(saved[2])
            check(_trees_equal(torch, pipe.model_state, saved[2])
                  and all(got[k].dtype == want[k].dtype and got[k].device == pipe.device
                          for k in want),
                  f"{label}: checkpoint round trip changed the model state")
        restored = pipe.manager.state_dict()
        for group in saved[3]:
            check(_states_equal(restored[group], saved[3][group]),
                  f"{label}: checkpoint round trip changed the sampler state")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    return True


def _kernel_and_plain_eval(torch, pipe, device_sampler, what, with_state=False):
    """The kernel and the plain ``evaluate("val")`` of a 2-layer path, val
    MRR within MRR_TOL: on the device sampler two whole passes (``fused``
    reaches its hooks' buffers, so the sampler state after each must be
    bit-equal); on the host sampler one pass, every scored batch scored by
    both (``paired_eval``: its hooks, untouched by ``fused``, run once).
    Returns the kernel pass's numbers, the plain ones' (and the sampler
    state)."""
    if device_sampler:
        ev, state, _ = eval_run(torch, pipe, None)
        ev_ref, state_ref, _ = eval_run(torch, pipe, "ref")
        check(_states_equal(state, state_ref),
              f"{what}: sampler state differs between the kernel and plain eval")
    else:
        ev, state, _, ev_ref = paired_eval(torch, pipe)
    plain_launched = ev_ref["launches"]
    if isinstance(plain_launched, dict):
        plain_launched = sum(plain_launched.values())
    check(plain_launched == 0, f"{what}: fused='ref' launched a kernel")
    check(abs(ev["mrr"] - ev_ref["mrr"]) <= MRR_TOL,
          f"{what} val MRR {ev['mrr']} (kernels) vs {ev_ref['mrr']} (plain)")
    return (ev, ev_ref, state) if with_state else (ev, ev_ref)


def tgat2_run(torch, data, device_sampler: bool):
    """2-layer TGAT through the user's entry point on one sampler:
    ``evaluate("val")`` through the kernels (three forward launches a
    scored batch, none in the warm pass) and with the plain version (MRR
    within MRR_TOL, the sampler state bit-equal); the first train steps held
    step by step (each step's three attention calls); one ``train_epoch()``
    (three forward and three backward launches a batch); a checkpoint round
    trip. Returns its numbers and the pipeline."""
    label = "device" if device_sampler else "host"
    t0 = time.perf_counter()
    pipe = tgat2_experiment(device_sampler).compile(data=data, device=DEVICE)
    setup_s = time.perf_counter() - t0
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    check(pipe.cfg.num_layers == 2 and hook.num_hops == 2 and hook.k == K20,
          f"tgat2 {label}: built {pipe.cfg.num_layers} layers, {hook.num_hops} "
          f"hops of {hook.k}")
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    fwd, bwd = (("fused_temporal_layer", "fused_temporal_layer_bwd") if device_sampler
                else ("temporal_attention", "temporal_attention_bwd"))
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

    ev, ev_ref = _kernel_and_plain_eval(torch, pipe, device_sampler, f"tgat2 {label}")
    launched = {k: v for k, v in ev["launches"].items() if v}
    check(launched == {fwd: 3 * n_val},
          f"tgat2 {label} eval launched {launched} for {n_val} val batches")

    parity = step_parity(torch, pipe, TGAT2_PARITY_STEPS)
    check(parity["calls_per_step"] == {"layer" if device_sampler else "attention": 3},
          f"tgat2 {label}: attention calls a step {parity['calls_per_step']}")
    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    run = run_epoch(torch, pipe, None, val_mrr=False)
    launched = {k: v for k, v in run["launches"].items() if v}
    check(launched == {fwd: 3 * n_train, bwd: 3 * n_train},
          f"tgat2 {label} train epoch launched {launched} for {n_train} batches")
    check(math.isfinite(run["loss"]), f"tgat2 {label} epoch loss {run['loss']}")
    out = dict(setup_seconds=setup_s, val_batches=n_val, train_batches=n_train,
               eval=ev, eval_ref=ev_ref, mrr_diff=abs(ev["mrr"] - ev_ref["mrr"]),
               step_parity=dict(steps=TGAT2_PARITY_STEPS, **parity), kernels=run,
               checkpoint_bit_equal=checkpoint_round_trip(torch, pipe, f"tgat2_{label}", init))
    return out, pipe


def _cli(args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device", "cuda"] + args


def _cli_start(runs: dict, procs: list):
    """Start one ``_cli`` process per ``{name: args}`` at once, each kept in
    ``procs`` for the caller to end; returns what ``_cli_wait`` takes."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    started = {}
    for name, args in runs.items():
        p = subprocess.Popen(_cli(args), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env=env, cwd=str(ROOT))
        procs.append(p)
        started[name] = p
    return started, t


def _cli_wait(started):
    """Wait for ``_cli_start``'s processes; returns ``({name: (exit code,
    stdout, stderr)}, seconds since they started)``."""
    started, t = started
    out = {}
    for name, p in started.items():
        so, se = p.communicate(timeout=CLI_TIMEOUT_S)
        out[name] = (p.returncode, so, se)
    return out, time.perf_counter() - t


def _cli_round(runs: dict, procs: list):
    """``_cli_start`` then ``_cli_wait``: one round of parallel runs."""
    return _cli_wait(_cli_start(runs, procs))


def cli_phase(torch):
    """``python -m repro_torch.launch.train`` on the card, killed and resumed
    as the reference's ``tests/test_fault_tolerance.py`` drives its own: the
    ``tg`` workload (its defaults: 2-layer TGAT, k = 20, the host sampler)
    on wikipedia at CLI_TG_SCALE for 2 epochs, killed after epoch 0 (exit 42)
    and resumed; the ``dtdg`` workload (GCLSTM, hourly snapshots, full
    scale, one epoch in chunks of CLI_DTDG_CHUNK pairs) uninterrupted, and
    killed after CLI_DTDG_KILL chunks (mid-epoch) then resumed: its final
    test MRR equal to the uninterrupted run's to the bit. The runs of each
    round go in parallel; every process is ended before returning."""
    import shutil

    ck = {n: ROOT / "checkpoints" / f"chip_smoke_cli_{n}"
          for n in ("tg", "dtdg_clean", "dtdg_crash")}
    tg = ["--workload", "tg", "--dataset", "wikipedia", "--data-scale", CLI_TG_SCALE,
          "--epochs", "2", "--ckpt-dir", str(ck["tg"])]
    dtdg = ["--workload", "dtdg", "--model", "gclstm", "--dataset", "wikipedia",
            "--data-scale", CLI_DTDG_SCALE, "--epochs", "1", "--chunk-size", CLI_DTDG_CHUNK,
            "--discretization", "h"]
    procs = []

    def round_(runs):
        return _cli_round(runs, procs)

    def final(so):
        return [ln for ln in so.splitlines() if ln.startswith("final test MRR")][-1]

    for d in ck.values():
        shutil.rmtree(d, ignore_errors=True)
    try:
        first, s1 = round_({
            "tg_killed": tg + ["--simulate-failure", "0"],
            "dtdg_clean": dtdg + ["--ckpt-dir", str(ck["dtdg_clean"])],
            "dtdg_killed": dtdg + ["--ckpt-dir", str(ck["dtdg_crash"]),
                                   "--simulate-failure", CLI_DTDG_KILL]})
        for name, want in (("tg_killed", 42), ("dtdg_clean", 0), ("dtdg_killed", 42)):
            rc, so, se = first[name]
            check(rc == want, f"CLI {name}: exit {rc}, expected {want}: {se[-1500:]}")
        second, s2 = round_({"tg_resumed": tg + ["--resume"],
                             "dtdg_resumed": dtdg + ["--ckpt-dir", str(ck["dtdg_crash"]),
                                                     "--resume"]})
        for name in second:
            rc, so, se = second[name]
            check(rc == 0 and "[resume]" in so, f"CLI {name}: exit {rc}: {se[-1500:]}")
        check("[resume] restored epoch 0" in second["tg_resumed"][1],
              "CLI tg: the resumed run did not start after epoch 0")
        clean, resumed = final(first["dtdg_clean"][1]), final(second["dtdg_resumed"][1])
        check(clean == resumed, f"CLI dtdg: resumed {resumed!r} vs uninterrupted {clean!r}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for d in ck.values():
            shutil.rmtree(d, ignore_errors=True)
    return dict(
        tg=dict(args=tg, data_scale=float(CLI_TG_SCALE), final=final(second["tg_resumed"][1]),
                stdout_killed=first["tg_killed"][1].splitlines(),
                stdout_resumed=second["tg_resumed"][1].splitlines()),
        dtdg=dict(args=dtdg, final_uninterrupted=clean, final_resumed=resumed,
                  bit_identical=True,
                  resume_line=[ln for ln in second["dtdg_resumed"][1].splitlines()
                               if ln.startswith("[resume]")]),
        round_seconds=[s1, s2])


def tgat2_phase(torch, data):
    """2-layer TGAT (the reference's default TGAT) on the card: its kernel
    calls (``tgat2_kernels``), the device-sampler and host-sampler runs
    (``tgat2_run``), their hop-2 neighborhoods bit-equal batch by batch
    (``neighborhoods_check``), and the training CLI killed and resumed
    (``cli_phase``)."""
    t0 = time.perf_counter()
    out = {"kernels": tgat2_kernels(torch)}
    out["device"], dev = tgat2_run(torch, data, True)
    out["host"], host = tgat2_run(torch, data, False)
    out["neighborhoods"] = neighborhoods_check(torch, host, dev)
    del dev, host
    torch.cuda.empty_cache()
    out["cli"] = cli_phase(torch)
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The rest of the CTDG zoo (GraphMixer, DyGFormer, TPNet) and 2-layer TGAT
# over the uniform samplers
# ---------------------------------------------------------------------------
ZOO_PARITY_STEPS = 3
ZOO_LOSS_RTOL = 1e-5
# Train steps before, and in, each loop's profiler window (its busy share).
BUSY_SKIP, BUSY_STEPS = 3, 15
# Each zoo model at its reference config's defaults (full width) and its
# sampler: k (TPNet samples no neighbors: its recipe runs at k = 1 over the
# default host recency spec) and whether it is the device recency sampler.
ZOO = (("graphmixer", 20, True), ("dygformer", 32, True), ("tpnet", 20, False))
# Models whose whole train epoch is not run, for the script's time limit:
# DyGFormer's took 25.1 s (1,419 device kernels a step, host-bound; NVIDIA
# H100 80GB HBM3, 700.00 W). Its train path stays driven and held by the
# ZOO_PARITY_STEPS steps against the CPU.
ZOO_NO_EPOCH = ("dygformer",)
# The zoo models run no kernel of the port: their train busy shares were
# measured in PRs 21-24 (PERF.md) and are not read again, for the time
# limit (a profiler window costs its 2 s margins on each side).


def zoo_experiment(name, sampler):
    """``ModelSpec(name)`` with no kwargs (the reference config's defaults)
    on full-scale synthetic ``wikipedia``, batch 200, 20 eval negatives."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, TrainSpec

    return Experiment(data=DataSpec("wikipedia", scale=1.0), model=ModelSpec(name),
                      sampler=sampler, train=TrainSpec(batch_size=200, eval_negatives=20))


def _launched():
    """The port's kernel launch counts that are not zero."""
    from repro_torch.kernels.segment_reduce import LAUNCHES as SEG
    from repro_torch.kernels.temporal_attention import LAUNCHES as TA

    return {k: v for k, v in {**TA, **SEG}.items() if v}


def card_vs_cpu_steps(torch, pipe, n_steps: int):
    """The first ``n_steps`` train steps on the card against the same steps
    on the CPU: each batch's loss and every gradient computed again by the
    model's ``link_scores`` on CPU copies of the parameters, the batch and
    the model state. Held: the loss within ZOO_LOSS_RTOL relative, every
    gradient within GRAD_RTOL of its leaf's largest entry + GRAD_FLOOR, and
    a stateful model's new state (float leaves within ATOL/RTOL, integer
    leaves bit-equal). The card's update moves the run on. Returns the
    worst errors."""
    from repro_torch.core import TRAIN_KEY
    from repro_torch.models.tg.common import bce_link_loss
    from repro_torch.tree import tree_map

    worst = {"loss_rel": 0.0, "grad_rel": 0.0, "grad_name": None, "state_abs": 0.0}
    name = pipe.model_name
    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        for i, batch in zip(range(n_steps), pipe._loader(pipe.train_data)):
            loss, new_state = pipe._loss_and_state(batch)
            gtree = pipe._grads(loss)
            params = tree_map(lambda t: t.detach().cpu().requires_grad_(True), pipe.params)
            host = {k: batch[k].cpu() if isinstance(batch[k], torch.Tensor) else batch[k]
                    for k in batch.keys()}
            if pipe.stateful:
                (pos, neg), want_state = pipe._model.link_scores(
                    params, pipe.cfg, tree_map(lambda t: t.cpu(), pipe.model_state),
                    host, pipe.batch_size)
            else:
                pos, neg = pipe._model.link_scores(params, pipe.cfg, host, pipe.batch_size)
            want = bce_link_loss(pos, neg, host["batch_mask"])
            rel = abs(loss.item() - want.item()) / max(abs(want.item()), 1e-30)
            check(rel <= ZOO_LOSS_RTOL,
                  f"{name} step {i}: loss {loss.item()} (card) vs {want.item()} (CPU)")
            worst["loss_rel"] = max(worst["loss_rel"], rel)
            leaves = _flat(params)
            cpu = dict(zip(leaves, torch.autograd.grad(want, list(leaves.values()),
                                                       allow_unused=True)))
            for leaf, g in _flat(gtree).items():
                g = g.cpu()
                w = torch.zeros_like(g) if cpu[leaf] is None else cpu[leaf]
                scale = float(w.abs().max())
                err = float((g - w).abs().max())
                check(torch.allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale + GRAD_FLOOR),
                      f"{name} step {i}: gradient {leaf} card vs CPU differs by {err} "
                      f"(leaf max {scale})")
                rel = err / (scale + GRAD_FLOOR / GRAD_RTOL)
                if rel > worst["grad_rel"]:
                    worst.update(grad_rel=rel, grad_name=leaf)
            if pipe.stateful:
                want_flat = _flat(want_state)
                for leaf, t in _flat(new_state).items():
                    if t.dtype.is_floating_point:
                        worst["state_abs"] = max(worst["state_abs"], compare(
                            torch, t, want_flat[leaf].to(t.device),
                            f"{name} step {i} state {leaf}"))
                    else:
                        check(torch.equal(t.cpu(), want_flat[leaf]),
                              f"{name} step {i}: state {leaf} card vs CPU differs")
            pipe._update(gtree)
            if pipe.stateful:
                pipe.model_state = new_state
    torch.cuda.synchronize()
    return worst


def train_busy(torch, pipe):
    """The card's busy share in a loop's train steps: ``torch.profiler``
    over BUSY_STEPS steps (after BUSY_SKIP) as ``train_epoch`` runs them,
    between idle margins of PROFILE_MARGIN_S that lie outside the timed
    window. ``device_window``'s numbers; ``None`` entries where the
    profiler kept no device event (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import TRAIN_KEY

    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        it = iter(pipe._loader(pipe.train_data))
        try:
            for _, batch in zip(range(BUSY_SKIP), it):
                pipe._train_step(batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_MARGIN_S)
                t0 = time.perf_counter()
                for _, batch in zip(range(BUSY_STEPS), it):
                    pipe._train_step(batch)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
                time.sleep(PROFILE_MARGIN_S)
        finally:
            it.close()
    out = device_window(prof, wall_us)
    out["device_busy_share"] = (None if out["device_idle_share"] is None
                                else 1.0 - out["device_idle_share"])
    out["steps"] = BUSY_STEPS
    return out


def zoo_run(torch, data, name: str, k: int, device_sampler: bool):
    """One zoo model through the user's entry point: ``evaluate("val")``
    (seconds, MRR, no kernel launched; the peak device memory it allocates
    above what was held before), the first ZOO_PARITY_STEPS train steps on
    the card against the CPU (``card_vs_cpu_steps``), one ``train_epoch()``
    (seconds, ms per step, no kernel launched; not for ZOO_NO_EPOCH) and
    val MRR after it, and a
    checkpoint round trip (TPNet's ``{"R", "last"}`` included)."""
    from repro_torch.tg import SamplerSpec

    t0 = time.perf_counter()
    pipe = zoo_experiment(name, SamplerSpec(k=k, device=device_sampler)).compile(
        data=data, device=DEVICE)
    setup_s = time.perf_counter() - t0
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    check(hook.k == (1 if name == "tpnet" else k) and "nbr_buf" not in hook.produces,
          f"{name}: hook samples {hook.k} and produces {sorted(hook.produces)}")
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches_all()
    ev, _, _ = eval_run(torch, pipe, None)
    peak = torch.cuda.max_memory_allocated() - held
    check(not _launched(), f"{name} eval launched {_launched()}")
    steps = card_vs_cpu_steps(torch, pipe, ZOO_PARITY_STEPS)
    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    if name in ZOO_NO_EPOCH:
        run = {"not_run": "ZOO_NO_EPOCH: the held steps train it"}
    else:
        _reset_launches_all()
        run = run_epoch(torch, pipe, None)
        check(not _launched() and math.isfinite(run["loss"]),
              f"{name} train epoch: loss {run['loss']}, launched {_launched()}")
    out = dict(setup_seconds=setup_s, val_batches=n_val, train_batches=n_train,
               config={k_: v for k_, v in vars(pipe.cfg).items()},
               sampler=dict(kind="recency", device=device_sampler, k=hook.k),
               eval=ev, eval_peak_bytes_above_held=peak,
               card_vs_cpu=dict(steps=ZOO_PARITY_STEPS, **steps), epoch=run,
               checkpoint_bit_equal=checkpoint_round_trip(torch, pipe, f"zoo_{name}", init))
    del pipe
    torch.cuda.empty_cache()
    return out


def _reset_launches_all():
    from repro_torch.kernels import segment_reduce, temporal_attention

    segment_reduce.reset_launches()
    temporal_attention.reset_launches()


def uniform_experiment(device_sampler: bool):
    """``ModelSpec("tgat")`` with no kwargs (2 layers, 2 hops) over
    ``SamplerSpec(kind="uniform", k=20)``, on the host or with
    ``device=True``, full-scale synthetic ``wikipedia``, batch 200, 20 eval
    negatives: the classic path (K3, and K3b in the backward)."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, SamplerSpec, TrainSpec

    return Experiment(data=DataSpec("wikipedia", scale=1.0), model=ModelSpec("tgat"),
                      sampler=SamplerSpec(kind="uniform", k=K20, device=device_sampler),
                      train=TrainSpec(batch_size=200, eval_negatives=20))


def uniform_run(torch, data, device_sampler: bool):
    """2-layer TGAT over one uniform sampler: ``evaluate("val")`` through K3
    (three launches a scored batch, nothing else) and with the plain
    version (MRR within MRR_TOL, the sampler's state, counter included,
    equal); the first train steps held step by step (``step_parity``: K3
    and K3b on each of a step's three attention calls); one
    ``train_epoch()`` with three K3 and three K3b launches a batch; the
    busy share of its train steps. Returns its numbers and the pipeline."""
    from repro_torch.core.tg_hooks import DeviceUniformNeighborHook, UniformNeighborHook

    label = "device" if device_sampler else "host"
    t0 = time.perf_counter()
    pipe = uniform_experiment(device_sampler).compile(data=data, device=DEVICE)
    setup_s = time.perf_counter() - t0
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    want_cls = DeviceUniformNeighborHook if device_sampler else UniformNeighborHook
    check(type(hook) is want_cls and pipe.cfg.num_layers == 2 and hook.num_hops == 2
          and hook.k == K20, f"uniform {label}: built {type(hook).__name__}, "
          f"{pipe.cfg.num_layers} layers, {hook.num_hops} hops of {hook.k}")
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
    n_train = math.ceil(pipe.train_data.num_edge_events / pipe.batch_size)
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

    ev, ev_ref, state = _kernel_and_plain_eval(torch, pipe, device_sampler,
                                               f"uniform {label}", with_state=True)
    check(int(state["counter"]) > 0, f"uniform {label}: the sampler drew nothing")
    launched = {k: v for k, v in ev["launches"].items() if v}
    check(launched == {"temporal_attention": 3 * n_val},
          f"uniform {label} eval launched {launched} for {n_val} val batches")

    parity = step_parity(torch, pipe, TGAT2_PARITY_STEPS)
    check(parity["calls_per_step"] == {"attention": 3},
          f"uniform {label}: attention calls a step {parity['calls_per_step']}")
    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    run = run_epoch(torch, pipe, None, val_mrr=False)
    launched = {k: v for k, v in run["launches"].items() if v}
    check(launched == {"temporal_attention": 3 * n_train,
                       "temporal_attention_bwd": 3 * n_train},
          f"uniform {label} train epoch launched {launched} for {n_train} batches")
    check(math.isfinite(run["loss"]), f"uniform {label} epoch loss {run['loss']}")
    out = dict(setup_seconds=setup_s, val_batches=n_val, train_batches=n_train,
               eval=ev, eval_ref=ev_ref, mrr_diff=abs(ev["mrr"] - ev_ref["mrr"]),
               counter_after_eval=int(state["counter"]),
               step_parity=dict(steps=TGAT2_PARITY_STEPS, **parity), kernels=run,
               train_busy=train_busy(torch, pipe))
    return out, pipe


def _slot_checks(torch, ev, seeds, query_t, ids, times, eids, mask, what):
    """Every valid slot is an event of its seed (either endpoint, the other
    one the slot's neighbor, at the slot's time) strictly before its query
    time: so inside the seed's strict-past prefix."""
    s, q = seeds.long()[:, None].expand(mask.shape)[mask], query_t.long()[:, None].expand(mask.shape)[mask]
    e, n, t = eids.long()[mask], ids.long()[mask], times.long()[mask]
    src, dst, et = ev
    ok = (((src[e] == s) & (dst[e] == n)) | ((dst[e] == s) & (src[e] == n))) & (et[e] == t) & (t < q)
    check(bool(ok.all()), f"{what}: a drawn slot is not a strict-past event of its seed")


def uniform_checks(torch, host, dev):
    """The two uniform samplers against each other: the CSR bit-equal; over
    the warm pass and a whole val pass, batch by batch, the seeds and hop-1
    masks bit-equal, each seed's valid-prefix start and length bit-equal
    between the samplers (hop 1, and hop 2 on both frontiers), each hop-2
    mask equal to the prefix test on its own frontier (padded slots
    masked), and every valid slot of both an event of its seed strictly
    before its query time. The time of each sampler's prefix search over a
    scored batch's hop-2 frontier (88,000 queries; the host's with its
    ``np.unique`` dedup, the device's over every query; CUDA events for the
    device). A device epoch (the train split's batches) replayed after
    ``reset_state``, bit-equal; last, a host <-> device ``state_dict``
    interchange: the host sampler loads the device's state (CSR, counter),
    and a fresh device sampler loading the host's state draws what the
    device sampler draws."""
    import numpy as np

    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.core.device_uniform import DeviceUniformSampler

    hh = next(h for h in host.manager.hooks() if hasattr(h, "sampler"))
    dh = next(h for h in dev.manager.hooks() if hasattr(h, "sampler"))
    hs, ds = hh.sampler, dh.sampler
    csr = ("adj_nbr", "adj_t", "adj_e", "indptr")
    a, b = hh.state_dict(), dh.state_dict()
    for key in csr:
        check(np.array_equal(a[key], b[key]), f"uniform CSR {key} differs host vs device")
    data = dev.data
    ev = tuple(torch.as_tensor(np.asarray(x, np.int64), device=DEVICE)
               for x in (data.src, data.dst, data.edge_t))
    host_ms, dev_ms = [], []

    def prefixes(seeds, q, what):
        hst, hn = hs.prefix(seeds.cpu().numpy(), q.cpu().numpy())
        dst_, dn = ds.prefix(seeds, q)
        check(np.array_equal(hst, dst_.cpu().numpy()) and np.array_equal(hn, dn.cpu().numpy()),
              f"{what}: valid prefixes differ between the host and device samplers")
        return dn

    for p in (host, dev):
        p.reset_epoch_state()
    n = 0
    with host.manager.activate(EVAL_KEY), dev.manager.activate(EVAL_KEY):
        for x, y in zip(host._loader(host.val_data), dev._loader(dev.val_data)):
            what = f"val batch {n}"
            for name in ("seed_nodes", "seed_times", "nbr_mask"):
                check(torch.equal(x[name], y[name]), f"{what}: {name} differs")
            seeds, st = y["seed_nodes"], y["seed_times"]
            nv = prefixes(seeds, st, what + " hop 1")
            check(torch.equal(y["nbr_mask"], (nv > 0)[:, None].expand_as(y["nbr_mask"])),
                  f"{what}: hop-1 mask is not the prefix test")
            for z, label in ((x, "host"), (y, "device")):
                _slot_checks(torch, ev, seeds, st, z["nbr_ids"], z["nbr_times"],
                             z["nbr_eids"], z["nbr_mask"], f"{what} {label} hop 1")
                f_ids, f_t = z["nbr_ids"].reshape(-1), z["nbr_times"].reshape(-1)
                pad = f_ids < 0
                safe, qt = torch.where(pad, 0, f_ids), torch.where(pad, 0, f_t)
                if label == "device":
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    hs.prefix(safe.cpu().numpy(), qt.cpu().numpy())
                    host_ms.append(1e3 * (time.perf_counter() - t))
                    dev_ms.append(time_ms(torch, lambda: ds.prefix(safe, qt), 5, trials=1))
                nv2 = prefixes(safe, qt, f"{what} {label} hop 2")
                want = ((nv2 > 0) & ~pad)[:, None].expand_as(z["nbr2_mask"])
                check(torch.equal(z["nbr2_mask"], want),
                      f"{what} {label}: hop-2 mask is not the prefix test")
                _slot_checks(torch, ev, safe, qt, z["nbr2_ids"], z["nbr2_times"],
                             z["nbr2_eids"], z["nbr2_mask"], f"{what} {label} hop 2")
            n += 1
    check(n == math.ceil(dev.val_data.num_edge_events / dev.batch_size),
          "uniform check: val batch count")

    def epoch_draws():
        out = []
        dev.reset_epoch_state()
        with dev.manager.activate(TRAIN_KEY):
            for z in dev._loader(dev.train_data):
                out.append(torch.cat([torch.stack([z[f"{p}_ids"], z[f"{p}_times"],
                                                   z[f"{p}_eids"]]).reshape(3, -1)
                                      for p in ("nbr", "nbr2")], 1))
        return out

    first = epoch_draws()
    again = epoch_draws()
    check(len(first) == len(again) and all(torch.equal(u, v) for u, v in zip(first, again)),
          "the device sampler's epoch differs after reset_state")
    counter = int(dh.state_dict()["counter"])
    del first, again

    state = dh.state_dict()
    hh.load_state_dict(state)
    back = hh.state_dict()
    check(all(np.array_equal(back[k], state[k]) for k in csr)
          and int(back["counter"]) == counter, "host sampler did not load the device's state")
    twin = DeviceUniformSampler(ds.num_nodes, ds.k, seed=ds._seed, device=DEVICE)
    twin.load_state_dict(back)
    seeds = torch.as_tensor(data.dst[:4400].astype(np.int64), device=DEVICE)
    qt = torch.as_tensor(data.edge_t[-4400:].astype(np.int64), device=DEVICE)
    u, v = ds.sample(seeds, qt), twin.sample(seeds, qt)
    check(all(torch.equal(getattr(u, f), getattr(v, f))
              for f in ("nbr_ids", "nbr_times", "nbr_eids", "mask")),
          "a device sampler loaded from the host's state draws differently")
    return dict(csr_entries=int(len(a["adj_nbr"])), csr_bit_equal=True, val_batches=n,
                masks_and_prefixes_bit_equal=True, draws_strict_past=True,
                hop2_prefix_ms_per_scored_batch={
                    "host_np_unique_dedup": statistics.median(host_ms),
                    "device_every_query": statistics.median(dev_ms),
                    "queries": int(y["nbr_ids"].numel())},
                epoch_replay_bit_equal=True, epoch_sample_calls=counter,
                state_interchange=True)


def zoo_phase(torch, data):
    """The rest of the CTDG zoo and the uniform samplers on the card:
    GraphMixer (device recency, k 20), DyGFormer (device recency, k 32) and
    TPNet (``zoo_run`` each), then 2-layer TGAT over the host and the
    device uniform sampler (``uniform_run`` each) and the two samplers
    against each other (``uniform_checks``)."""
    t0 = time.perf_counter()
    out = {}
    for name, k, on_device in ZOO:
        out[name] = zoo_run(torch, data, name, k, on_device)
    out["uniform"] = {}
    out["uniform"]["host"], host = uniform_run(torch, data, False)
    out["uniform"]["device"], dev = uniform_run(torch, data, True)
    out["uniform"]["samplers"] = uniform_checks(torch, host, dev)
    del host, dev
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# The node tasks (Table 4) and the device discretization (Table 5)
# ---------------------------------------------------------------------------
NODE_NUM_CATS = 16
# Snapshot models and their K4 launches per apply of the model (GCN: two
# layers of four segment sums; GCLSTM: four gate convolutions; T-GCN: three).
NODE_SNAPSHOT_MODELS = (("gcn", 8), ("gclstm", 16), ("tgcn", 12))
NODE_PARITY_STEPS = 3
NDCG_TOL = 1e-4
# A near-tie: two categories whose probabilities differ by less than this
# may swap between the kernel and the plain path (float32 rounding).
NEAR_TIE = 1e-5
# TGN's attention on the node path: the seed users' power-of-two bucket (a
# genre day has up to 1,320 users), k = 4 neighbors, 2 heads of d_model / 2.
NODE_S, NODE_K, NODE_H, NODE_D = 2048, 4, 2, 16
# Table 5: sum and mean features within this relative tolerance (index_add_
# adds in arrival order on the card); the rest bit for bit.
DISC_SUM_RTOL = 1e-5
DISC_REDUCTIONS = ("first", "last", "sum", "mean", "max", "count")


def node_experiment(model: str):
    """Table 4's configuration (``benchmarks/table4_nodeprop.py``): synthetic
    ``genre`` at full scale (1,505 nodes, 1,785,839 events, 30 days), daily
    label windows, ``val_ratio`` 0, ``test_ratio`` 0.3, ``num_cats`` 16,
    each model's reference defaults (``d_embed`` 32; TGN ``d_time`` 16,
    k = 4), one epoch."""
    from repro_torch.tg import DataSpec, Experiment, ModelSpec, TrainSpec

    return Experiment(task="node",
                      data=DataSpec("genre", scale=1.0, discretization="d",
                                    val_ratio=0.0, test_ratio=0.3),
                      model=ModelSpec(model, {"num_cats": NODE_NUM_CATS}),
                      train=TrainSpec(epochs=1))


def node_kernels(torch, data):
    """K4, K3 and K3b at the node path's shapes against their plain versions:
    K4 at genre's busiest daily snapshot (E = the daily capacity, G = 1,505)
    at D = 1 (degrees) and 32 (``d_embed``), bit-equal to the edge-order
    float32 loop, a second launch bitwise, and at D = 32 again with the
    padding edges' ids dropped (-1 in place of 0: the same sums); K3 and K3b at (2,048, 4, 2, 16),
    the rows past the busiest day's users without a valid slot (the node-0
    padding), exact zeros there, a second launch bitwise, the launch plans
    held to the CUDA source's. Times by CUDA events of each kernel, its
    plain version and the library call (``index_add_``; SDPA forward, and
    forward + backward, over the rows with a valid slot), device µs per call
    from one profiler window, bounds and shares."""
    from functools import partial

    import numpy as np

    from repro_torch.core import DGDataLoader, DGraph, snapshot_tensor
    from repro_torch.kernels.segment_reduce import segment_sum_kernel, segment_sum_ref
    from repro_torch.kernels.temporal_attention import (
        temporal_attention_bwd_kernel,
        temporal_attention_bwd_ref,
        temporal_attention_kernel,
        temporal_attention_ref,
    )

    gen = torch.Generator().manual_seed(22)
    res, timed = {}, {}

    def record(key, kern, plain, bound, lib, **extra):
        r = res[key] = dict(extra, ms=time_ms(torch, kern, 20),
                            plain_ms=time_ms(torch, plain, 5),
                            library_ms=time_ms(torch, lib, 20),
                            bound_ms=bound[0], bound_by=bound[1], bytes=bound[2],
                            flops=bound[3])
        r["bound_share"] = bound[0] / r["ms"]
        timed[key], timed[f"{key}_library"] = kern, lib
        return r

    with torch.no_grad():
        st = snapshot_tensor(data, "d", device=DEVICE)
        row = int(torch.argmax(st.counts))
        ids, mask = st.src[row].contiguous(), st.mask[row]
        E, G = ids.shape[0], data.num_nodes
        for D in (1, 32):
            x = (torch.randn((E, D), generator=gen).to(DEVICE) * mask[:, None]).contiguous()
            kern = partial(segment_sum_kernel, x, ids, G)
            got = kern()
            err = compare(torch, got, segment_sum_ref(x, ids, G), f"K4 node E={E} D={D}")
            check(bool((got.cpu().numpy().view("u4")
                        == edge_order_sum(x, ids, G).view("u4")).all()),
                  f"K4 node E={E} D={D}: not the edge-order sum's bits")
            check(bool(torch.equal(kern(), got)), f"K4 node D={D}: a second launch "
                                                  f"gave other bits")
            lib = partial(lambda x_: torch.zeros((G, x_.shape[1]), device=DEVICE)
                          .index_add_(0, ids, x_), x)
            record(f"K4_d{D}", kern, partial(segment_sum_ref, x, ids, G),
                   segment_bound(E, E, D, G), lib, E=E, valid_edges=int(st.counts[row]),
                   D=D, G=G, max_abs_err=err, bitwise_equal_to_edge_order_loop=True,
                   rerun_bitwise_equal=True)
        # The same call with the padding edges' ids dropped (-1) instead of
        # 0: what the run of ~3,800 padding ids in segment 0 costs.
        dropped = torch.where(mask, ids, -1).contiguous()
        kern = partial(segment_sum_kernel, x, dropped, G)
        check(bool(torch.equal(kern(), got)), "K4 node D=32: dropping the padding "
                                              "ids changed the sums")
        lib = partial(lambda x_: torch.zeros((G, x_.shape[1]), device=DEVICE)
                      .index_add_(0, dropped.clamp(min=0), x_), x)
        record("K4_d32_padding_dropped", kern, partial(segment_sum_ref, x, dropped, G),
               segment_bound(int(mask.sum()), E, 32, G), lib, E=E,
               padding_ids=int((~mask).sum()), D=32, G=G)

        users = max(len(np.unique(b["src"])) for b in DGDataLoader(
            DGraph(data), None, batch_size=None, batch_unit="d"))
        q, k, v, m = attention_inputs(torch, gen, NODE_S, k=NODE_K, h=NODE_H, d=NODE_D)
        m[users:] = False  # the padding rows: node 0 with no neighbor
        g = torch.randn((NODE_S, NODE_H, NODE_D), generator=gen).to(DEVICE)
        label = f"node S={NODE_S} K={NODE_K} H={NODE_H} D={NODE_D}"
        empty = ~m.any(-1)
        plan = ta_plan_checked(torch, q, k, aligned_with=(v,))
        ta_plan_checked(torch, q, k, backward=True, aligned_with=(v, g))
        kern = partial(temporal_attention_kernel, q, k, v, m)
        got = kern()
        err = compare(torch, got, temporal_attention_ref(q, k, v, m), f"K3 {label}")
        check(bool((got[empty] == 0).all()), f"K3 {label}: empty rows not exactly zero")
        check(bool(torch.equal(kern(), got)), f"K3 {label}: a second launch gave other bits")
        sdpa, sdpa_fwd_bwd, rows = sdpa_calls(torch, q, k, v, m, g)
        common = dict(S=NODE_S, K=NODE_K, H=NODE_H, D=NODE_D, users=users,
                      rows_without_valid_slot=int(empty.sum()), valid_slots=int(m.sum()),
                      library_rows=rows, vector_bytes=plan["vector_bytes"])
        record("K3", kern, partial(temporal_attention_ref, q, k, v, m),
               attention_bound(q, k, v, m), sdpa, max_abs_err=err,
               rerun_bitwise_equal=True, **common)
        bwd = partial(temporal_attention_bwd_kernel, g, q, k, v, m)
        grads = bwd()
        want = plain_attention_grads(torch, g, q, k, v, m)
        gerr = {n: compare(torch, a, b, f"K3b {label} d{n}")
                for n, a, b in zip("qkv", grads, want)}
        dq, dk, dv = grads
        check(bool((dq[empty] == 0).all()) and bool((dk[~m] == 0).all())
              and bool((dv[~m] == 0).all()),
              f"K3b {label}: masked slots or empty rows not exactly zero")
        check(all(bool(torch.equal(a, b)) for a, b in zip(bwd(), grads)),
              f"K3b {label}: a second launch gave other bits")
        record("K3b", bwd, partial(temporal_attention_bwd_ref, g, q, k, v, m),
               bwd_attention_bound(q, k, v, m), sdpa_fwd_bwd,
               max_abs_err=max(gerr.values()), errors=gerr, rerun_bitwise_equal=True,
               **common)
        us = grouped_device_us(torch, timed)
    for key, r in res.items():
        r["device_us"] = us[key]
        r["library_device_us"] = us[f"{key}_library"]
        r["bound_share_device"] = 1e3 * r["bound_ms"] / us[key] if us[key] else None
    return res


def ndcg_rows_of(torch, pipe, mode):
    """``evaluate("test")`` of a node pipeline with ``pipe.mode = mode``,
    every launch count zeroed just before it and read just after: the NDCG,
    the seconds, the launches and the (probabilities, labels) rows it
    scored."""
    import repro_torch.train.nodeprop as nodeprop
    from repro_torch.kernels import segment_reduce, temporal_attention

    rows, score = [], nodeprop._ndcg_rows

    def keep(r, k_eval):
        r = list(r)
        rows.extend(r)
        return score(r, k_eval)

    pipe.mode = mode
    nodeprop._ndcg_rows = keep
    try:
        torch.cuda.synchronize()
        _reset_launches_all()
        t = time.perf_counter()
        ndcg, _ = pipe.evaluate("test")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        nodeprop._ndcg_rows = score
        pipe.mode = "auto"
    check(math.isfinite(ndcg) and 0.0 < ndcg <= 1.0, f"node test NDCG {ndcg}")
    launches = {**temporal_attention.LAUNCHES, **segment_reduce.LAUNCHES}
    return dict(ndcg=ndcg, seconds=wall, launches=dict(launches)), rows


def near_ties(rows, rows_ref, k: int = 10):
    """Rows of active users whose top-``k`` categories are ordered
    differently on the two paths: (window, row, the first two categories
    that swap, their probability gap on the kernel path)."""
    import numpy as np

    out = []
    for w, ((pr, lab), (pr_ref, _)) in enumerate(zip(rows, rows_ref)):
        active = lab.sum(-1) > 0
        top = np.argsort(-pr[active], axis=1)[:, :k]
        top_ref = np.argsort(-pr_ref[active], axis=1)[:, :k]
        for r in np.flatnonzero((top != top_ref).any(1)):
            j = int(np.flatnonzero(top[r] != top_ref[r])[0])
            a, b = int(top[r, j]), int(top_ref[r, j])
            gap = float(abs(pr[active][r, a] - pr[active][r, b]))
            out.append({"window": w, "row": int(np.flatnonzero(active)[r]),
                        "categories": [a, b], "gap": gap})
    return out


def node_agreement(torch, pipe, label):
    """Test NDCG through the kernels and with the plain versions from the
    same parameters: within NDCG_TOL, or else every differing row a near-tie
    (named, with its gap). Returns (kernel eval, plain eval, near-ties)."""
    ev, rows = ndcg_rows_of(torch, pipe, "auto")
    ev_ref, rows_ref = ndcg_rows_of(torch, pipe, "ref")
    check(not any(ev_ref["launches"].values()), f"{label}: mode='ref' launched a kernel")
    ties = near_ties(rows, rows_ref)
    diff = abs(ev["ndcg"] - ev_ref["ndcg"])
    check(diff <= NDCG_TOL or all(t["gap"] < NEAR_TIE for t in ties),
          f"{label} test NDCG {ev['ndcg']} (kernels) vs {ev_ref['ndcg']} (plain); "
          f"swapped top-10 rows: {ties[:5]}")
    return ev, ev_ref, ties


def node_epoch(torch, pipe):
    """One ``train_epoch()`` through the kernels, every launch count zeroed
    just before it and read just after, then test NDCG."""
    from repro_torch.kernels import segment_reduce, temporal_attention

    torch.cuda.synchronize()
    _reset_launches_all()
    t = time.perf_counter()
    loss, _ = pipe.train_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    check(math.isfinite(loss), f"node epoch loss {loss}")
    launches = dict({**temporal_attention.LAUNCHES, **segment_reduce.LAUNCHES})
    ndcg, _ = pipe.evaluate("test")
    return dict(loss=loss, epoch_seconds=wall, launches=launches, test_ndcg=ndcg)


def node_snapshot_run(torch, data, name: str, per: int, cpu):
    """One snapshot model through ``DTDGNodePipeline`` on the card: the labels
    of every pair bit-equal to the CPU pipeline's (``cpu``); test NDCG
    through K4 (``per`` launches an apply: the warm steps and the scored
    pairs, GCN only the scored) and with ``mode="ref"``; the first train
    steps held step by step; one ``train_epoch()`` through K4 (``per`` a
    pair; the backward is a gather) and test NDCG after it; a checkpoint
    round trip (bit-equal parameters, optimizer and recurrent state)."""
    import shutil

    t = time.perf_counter()
    pipe = node_experiment(name).compile(data=data, device=DEVICE)
    setup_s = time.perf_counter() - t
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)
    (lo, hi), (tlo, thi) = pipe._split_pairs("train"), pipe._split_pairs("test")
    T = pipe.snapshots.num_snapshots
    for p in range(T - 1):
        check(torch.equal(pipe.labels_of(pipe._pair_x(p)).cpu(),
                          cpu.labels_of(cpu._pair_x(p))),
              f"node {name}: pair {p}'s labels on the card differ from the CPU's")

    ev, ev_ref, ties = node_agreement(torch, pipe, f"node {name}")
    want = per * ((thi - tlo) if name == "gcn" else thi)
    check(ev["launches"]["segment_sum"] == want,
          f"node {name} eval launched K4 {ev['launches']['segment_sum']} times, "
          f"expected {want}")

    xs = list(pipe._pairs(lo, lo + NODE_PARITY_STEPS))
    parity = snapshot_step_parity(
        torch, pipe, xs,
        lambda x: pipe._loss_and_state(pipe.params, pipe.model_state, x),
        f"node {name}")

    def restart():
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])

    restart()
    run = node_epoch(torch, pipe)
    check(run["launches"]["segment_sum"] == per * (hi - lo),
          f"node {name} epoch launched K4 {run['launches']['segment_sum']} times "
          f"for {hi - lo} pairs")
    final = (_tree_clone(pipe.params), _tree_clone(pipe.opt_state),
             [t_.clone() for t_ in _leaves_of(pipe.model_state)])

    ck_dir = ROOT / "checkpoints" / f"chip_smoke_node_{name}"
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        pipe.save_checkpoint(str(ck_dir), 1)
        restart()
        pipe.reset_epoch_state()
        check(pipe.restore_checkpoint(str(ck_dir)) == 1, f"node {name}: checkpoint step")
        check(_trees_equal(torch, pipe.params, final[0])
              and _trees_equal(torch, pipe.opt_state, final[1])
              and all(torch.equal(a, b) for a, b in zip(_leaves_of(pipe.model_state),
                                                        final[2]))
              and pipe.params["head"].device == pipe.device,
              f"node {name}: checkpoint round trip changed the state")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    return dict(setup_seconds=setup_s, snapshots=T, capacity=pipe.capacity,
                train_pairs=hi - lo, test_pairs=thi - tlo,
                labels_bit_equal_to_cpu=True, eval=ev, eval_ref=ev_ref,
                ndcg_diff=abs(ev["ndcg"] - ev_ref["ndcg"]), near_ties=ties,
                step_parity=dict(steps=NODE_PARITY_STEPS, **parity), kernels=run,
                checkpoint_bit_equal=True)


def _leaves_of(state):
    """A recurrent state's tensors (``()``, one tensor, or a tuple)."""
    return list(state) if isinstance(state, tuple) else [state]


def tgn_node_step_parity(torch, pipe, n_steps: int):
    """The first ``n_steps`` train windows of the node TGN, each from the same
    parameters and memory through K3 (K3b in the backward) and through the
    plain version: the loss within STEP_LOSS_TOL; K3 against its plain
    version on the step's own inputs and K3b on the step's own cotangent
    against plain autograd. The whole-model gradients are reported (the
    merge MLP's ReLUs, as on the link path). The kernels' update moves the
    run on."""
    import repro_torch.kernels.temporal_attention as ta
    from repro_torch.models.tg import tgn
    from repro_torch.train.nodeprop import _soft_cross_entropy

    attention, seen = ta.temporal_attention, []

    def spy(q, k, v, mask, *, mode="auto"):
        out = attention(q, k, v, mask, mode=mode)
        if mode == "auto":
            rec = {"args": [t.detach().contiguous() for t in (q, k, v)]
                   + [mask.contiguous()]}
            seen.append(rec)
            out.register_hook(lambda g: rec.__setitem__("g", g.detach().contiguous()))
        return out

    worst = {"loss": 0.0, "k3_max_abs_err": 0.0, "k3_grad_max_abs_err": 0.0,
             "model_grad_rel": 0.0, "model_grad_name": None,
             "steps_with_model_grads_beyond_1e-4": 0, "steps": 0}
    windows = pipe.windows()
    pipe.reset_epoch_state()
    state = tgn.init_state(pipe.cfg, pipe.device)
    ta.temporal_attention = spy
    try:
        for i in range(len(windows) - 1):
            if worst["steps"] == n_steps:
                break
            if windows[i][0].num_events == 0:
                continue
            batch, seed_user = pipe._tgn_batch(windows[i][0])
            labels = pipe._put(pipe._next_labels(i, seed_user))
            out = {}
            for mode in ("ref", "auto"):
                pipe.mode = mode
                loss = _soft_cross_entropy(pipe._embed(state, batch)
                                           @ pipe.params["head"], labels)
                out[mode] = (loss.detach(), pipe._grads(loss))
            (loss, grads), (loss_ref, grads_ref) = out["auto"], out["ref"]
            dl = abs(loss.item() - loss_ref.item())
            check(dl <= STEP_LOSS_TOL, f"node TGN window {i}: loss {loss.item()} "
                                       f"(K3) vs {loss_ref.item()} (plain)")
            worst["loss"] = max(worst["loss"], dl)
            check(len(seen) == 1 and "g" in seen[0],
                  f"node TGN window {i}: {len(seen)} K3 calls recorded")
            rec = seen.pop()
            a, g = rec["args"], rec["g"]
            err = compare(torch, ta.temporal_attention_kernel(*a),
                          ta.temporal_attention_ref(*a), f"K3 node TGN window {i}")
            gerr = max(compare(torch, x, y, f"K3b d{n} node TGN window {i}")
                       for n, x, y in zip("qkv", ta.temporal_attention_bwd_kernel(g, *a),
                                          plain_attention_grads(torch, g, *a)))
            worst["k3_max_abs_err"] = max(worst["k3_max_abs_err"], err)
            worst["k3_grad_max_abs_err"] = max(worst["k3_grad_max_abs_err"], gerr)
            flat_ref, beyond = _flat(grads_ref), False
            for name, gr in _flat(grads).items():
                want = flat_ref[name]
                e, scale = float((gr - want).abs().max()), float(want.abs().max())
                beyond |= e > GRAD_RTOL * scale + GRAD_FLOOR
                if scale and e / scale > worst["model_grad_rel"] and e > GRAD_FLOOR:
                    worst.update(model_grad_rel=e / scale, model_grad_name=name)
            worst["steps_with_model_grads_beyond_1e-4"] += int(beyond)
            new_state = pipe._advance(state, batch)
            pipe._update(grads)
            state = new_state
            worst["steps"] += 1
    finally:
        ta.temporal_attention = attention
        pipe.mode = "auto"
    torch.cuda.synchronize()
    return worst


def node_tgn_run(torch, data):
    """``tgn`` through ``EventNodePipeline`` on the card: test NDCG through K3
    (one launch per scored window; the warm windows only advance the
    memory) and with the plain version; the first train windows held step
    by step; one ``train_epoch()`` through K3 and K3b (one launch each per
    train window with events) and test NDCG after it; a checkpoint round
    trip; the node-0 padding rows' share of the active rows on the first
    window where node 0 is active next (ROADMAP C)."""
    import shutil

    import numpy as np

    t = time.perf_counter()
    pipe = node_experiment("tgn").compile(data=data, device=DEVICE)
    setup_s = time.perf_counter() - t
    t = time.perf_counter()
    windows = pipe.windows()
    windows_s = time.perf_counter() - t
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)
    n_val, n_test = pipe._bounds()
    busy = [i for i in range(len(windows) - 1) if windows[i][0].num_events]
    n_train = sum(1 for i in busy if i < min(n_val, len(windows)) - 1)
    n_scored = sum(1 for i in busy if n_test <= i + 1)

    ev, ev_ref, ties = node_agreement(torch, pipe, "node TGN")
    launched = {k: v for k, v in ev["launches"].items() if v}
    check(launched == {"temporal_attention": n_scored},
          f"node TGN eval launched {launched} for {n_scored} scored windows")
    parity = tgn_node_step_parity(torch, pipe, NODE_PARITY_STEPS)

    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    run = node_epoch(torch, pipe)
    launched = {k: v for k, v in run["launches"].items() if v}
    check(launched == {"temporal_attention": n_train, "temporal_attention_bwd": n_train},
          f"node TGN epoch launched {launched} for {n_train} train windows")
    run["ms_per_window"] = 1e3 * run["epoch_seconds"] / n_train

    ck_dir = ROOT / "checkpoints" / "chip_smoke_node_tgn"
    shutil.rmtree(ck_dir, ignore_errors=True)
    try:
        saved = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)
        pipe.save_checkpoint(str(ck_dir), 1)
        pipe.load_params(init[0])
        pipe.load_opt_state(init[1])
        check(pipe.restore_checkpoint(str(ck_dir)) == 1, "node TGN: checkpoint step")
        check(_trees_equal(torch, pipe.params, saved[0])
              and _trees_equal(torch, pipe.opt_state, saved[1])
              and pipe.params["head"].device == pipe.device,
              "node TGN: checkpoint round trip changed the state")
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)

    pipe.reset_epoch_state()
    i = next(i for i in busy if windows[i + 1][1][0].sum() > 0)
    users = len(np.unique(windows[i][0]["src"]))
    _, seed_user = pipe._tgn_batch(windows[i][0])
    active = pipe._next_labels(i, seed_user).sum(-1) > 0
    pad = np.arange(len(seed_user)) >= users
    padding = dict(window=i, users=users, bucket=len(seed_user),
                   padding_rows=int(pad.sum()), active_rows=int(active.sum()),
                   active_padding_rows=int(active[pad].sum()),
                   padding_share_of_active=float(active[pad].sum() / active.sum()))
    return dict(setup_seconds=setup_s, windows_seconds=windows_s, windows=len(windows),
                train_windows=n_train, scored_windows=n_scored, eval=ev, eval_ref=ev_ref,
                ndcg_diff=abs(ev["ndcg"] - ev_ref["ndcg"]), near_ties=ties,
                step_parity=parity, kernels=run, checkpoint_bit_equal=True,
                node0_padding=padding)


def node_pf_run(data):
    """``pf`` through ``EventNodePipeline``: test NDCG on a pipeline made for
    the card and on one made for the CPU (host numpy in both), bit-equal."""
    t = time.perf_counter()
    ndcg = node_experiment("pf").compile(data=data, device=DEVICE).evaluate("test")[0]
    seconds = time.perf_counter() - t
    cpu = node_experiment("pf").compile(data=data, device="cpu").evaluate("test")[0]
    check(ndcg == cpu and 0.0 < ndcg <= 1.0, f"pf test NDCG {ndcg} vs {cpu} on the CPU")
    return dict(ndcg=ndcg, seconds=seconds, bit_equal_to_cpu=True)


def disc_hold(want, got, reduce: str, what: str) -> float:
    """Integer columns bit for bit; the features of ``first``, ``last`` and
    ``max``, and ``count``'s count column, bit for bit; sums (``sum``,
    ``mean``, ``count``'s summed features) within DISC_SUM_RTOL of the
    largest entry. Returns the largest relative difference of a sum."""
    import numpy as np

    for name in ("src", "dst", "edge_t", "node_ids", "node_t"):
        a, b = getattr(want, name), getattr(got, name)
        check((a is None) == (b is None) and (a is None or np.array_equal(a, b)),
              f"{what}: {name} differs")
    a, b = want.edge_feats, got.edge_feats
    check((a is None) == (b is None), f"{what}: edge features present in one only")
    if a is None:
        return 0.0
    check(a.shape == b.shape, f"{what}: features {a.shape} vs {b.shape}")
    exact = {"first": a.shape[1], "last": a.shape[1], "max": a.shape[1],
             "count": 1}.get(reduce, 0)
    if exact:
        check(np.array_equal(a[:, -exact:], b[:, -exact:]),
              f"{what}: {reduce} features not bit-equal")
    a, b = a[:, :a.shape[1] - exact], b[:, :b.shape[1] - exact]
    if not a.size:
        return 0.0
    rel = float(np.abs(a - b).max() / max(float(np.abs(a).max()), 1e-30))
    check(rel <= DISC_SUM_RTOL, f"{what}: summed features off by {rel:.3e} relative")
    return rel


# Timed runs of Table 5's host paths (their median); numpy's run takes
# seconds on reddit.
TABLE5_NUMPY_RUNS, TABLE5_DEVICE_RUNS = 1, 3


def table5(torch, graphs):
    """Table 5 (``benchmarks/table5_discretize.py``) on the card:
    ``discretize_device`` against ``discretize`` (numpy) and
    ``discretize_naive`` at ``reduce="count"``, hourly, on full-scale
    ``wikipedia``, ``reddit`` and ``lastfm`` (``disc_hold``), the int32 guard
    passing on each (the device path ran); times: ``discretize`` and
    ``discretize_device`` (host arrays in, ``DGData`` out: the transfers,
    the core, the count's read and the slices) by host clock, median of
    runs, the core alone on staged tensors by CUDA events (what the
    reference's benchmark times), ``discretize_naive`` once; the speedups
    as Table 5 gives them. Then every reduction once on ``wikipedia``, and
    the daily axis of ``genre``, against the numpy path."""
    from repro_torch.core import TimeDelta, discretize, discretize_device, discretize_naive
    from repro_torch.core.discretize import (
        _host_ticks,
        device_discretize_supported,
        discretize_edges_padded,
    )

    def host_s(fn, runs):
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
        return statistics.median(out)

    def core_ms(data, unit, reduce):
        k = unit.ticks_per(data.granularity)
        t_staged, k_dev = _host_ticks(data.edge_t, k)
        put = lambda a: torch.as_tensor(a).to(DEVICE)  # noqa: E731
        feats = (torch.zeros((data.num_edge_events, 0), device=DEVICE)
                 if data.edge_feats is None else put(data.edge_feats))
        args = (put(data.src), put(data.dst), put(t_staged), feats)
        return time_ms(torch, lambda: discretize_edges_padded(
            *args, k=k_dev, reduce=reduce, capacity=data.num_edge_events,
            feat_dim=data.edge_feat_dim), 5, 3)

    out, unit = {}, TimeDelta("h")
    for name in ("wikipedia", "reddit", "lastfm"):
        data = graphs[name]
        check(device_discretize_supported(data, unit.ticks_per(data.granularity)),
              f"Table 5 {name}: the int32 guard refused the graph")
        fast = discretize(data, unit, "count")
        dev = discretize_device(data, unit, "count")
        rel = disc_hold(fast, dev, "count", f"Table 5 {name} device vs numpy")
        t = time.perf_counter()
        naive = discretize_naive(data, unit, "count")
        naive_s = time.perf_counter() - t
        disc_hold(naive, dev, "count", f"Table 5 {name} device vs naive")
        r = out[name] = dict(
            events=data.num_edge_events, classes=dev.num_edge_events,
            edge_feat_dim=data.edge_feat_dim, guard_passed=True, sum_max_rel_diff=rel,
            naive_s=naive_s,
            numpy_s=host_s(lambda: discretize(data, unit, "count"), TABLE5_NUMPY_RUNS),
            device_s=host_s(lambda: discretize_device(data, unit, "count"), TABLE5_DEVICE_RUNS),
            device_core_ms=core_ms(data, unit, "count"))
        r.update(speedup_numpy_vs_naive=naive_s / r["numpy_s"],
                 speedup_device_vs_naive=naive_s / r["device_s"],
                 speedup_device_core_vs_naive=1e3 * naive_s / r["device_core_ms"],
                 device_vs_numpy=r["numpy_s"] / r["device_s"])
        del fast, dev, naive

    wiki = graphs["wikipedia"]
    out["wikipedia_reductions"] = {
        reduce: disc_hold(discretize(wiki, unit, reduce), discretize_device(wiki, unit, reduce),
                          reduce, f"wikipedia {reduce}")
        for reduce in DISC_REDUCTIONS}
    genre, day = graphs["genre"], TimeDelta("d")
    check(device_discretize_supported(genre, day.ticks_per(genre.granularity)),
          "genre daily: the int32 guard refused the graph")
    rel = disc_hold(discretize(genre, day, "count"), discretize_device(genre, day, "count"),
                    "count", "genre daily")
    out["genre_daily"] = dict(
        events=genre.num_edge_events, sum_max_rel_diff=rel, guard_passed=True,
        numpy_s=host_s(lambda: discretize(genre, day, "count"), TABLE5_NUMPY_RUNS),
        device_s=host_s(lambda: discretize_device(genre, day, "count"), TABLE5_DEVICE_RUNS),
        device_core_ms=core_ms(genre, day, "count"))
    return out


def node_phase(torch, wiki):
    """The node tasks (Table 4) and the device discretization (Table 5):
    ``node_kernels``; GCN, GCLSTM and T-GCN (``node_snapshot_run``), ``tgn``
    (``node_tgn_run``) and ``pf`` (``node_pf_run``) at Table 4's
    configuration; ``table5``. Seconds of each part."""
    from repro_torch.data import generate

    t0 = time.perf_counter()
    genre = generate("genre", scale=1.0)
    out = {"genre": dict(nodes=genre.num_nodes, events=genre.num_edge_events,
                         generate_seconds=time.perf_counter() - t0)}
    t = time.perf_counter()
    out["kernels"] = node_kernels(torch, genre)
    out["kernels_seconds"] = time.perf_counter() - t
    cpu = node_experiment("gcn").compile(data=genre, device="cpu")
    for name, per in NODE_SNAPSHOT_MODELS:
        t = time.perf_counter()
        out[name] = node_snapshot_run(torch, genre, name, per, cpu)
        out[name]["seconds"] = time.perf_counter() - t
    del cpu
    t = time.perf_counter()
    out["tgn"] = node_tgn_run(torch, genre)
    out["tgn"]["seconds"] = time.perf_counter() - t
    out["pf"] = node_pf_run(genre)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    graphs = {"wikipedia": wiki, "genre": genre,
              "reddit": generate("reddit", scale=1.0),
              "lastfm": generate("lastfm", scale=1.0)}
    out["table5"] = table5(torch, graphs)
    out["table5_seconds"] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Out-of-core storage, the online graph service and the profiler hooks
# ---------------------------------------------------------------------------
# 2-layer TGAT over the store-built device uniform sampler: train steps held
# card against CPU; batches of the store-built host uniform sampler held
# against the in-memory one; store-backed train steps inside trace_capture.
STORE_STEPS = 3
STORE_HOST_BATCHES = 10
TRACE_STEPS = 5
GAUGES = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit", "num_allocs",
          "bytes_reserved")


def _rss_bytes():
    """(current, peak) resident set of this process: ``VmRSS`` from
    ``/proc/self/status`` and ``ru_maxrss`` (KiB on Linux)."""
    import resource

    cur = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                cur = int(line.split()[1]) * 1024
    return cur, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _shared_node_time(data):
    """Whether two distinct events share a ``(node, timestamp)`` pair: the
    condition under which the streaming CSR may order a node's run
    differently from the in-RAM lexsort (``repro_torch/storage/csr.py``)."""
    import numpy as np

    e = np.arange(data.num_edge_events, dtype=np.int64)
    nodes = np.concatenate([data.src, data.dst]).astype(np.int64)
    times = np.concatenate([data.edge_t, data.edge_t]).astype(np.int64)
    eids = np.concatenate([e, e])
    order = np.lexsort((eids, times, nodes))
    n, t, ev = nodes[order], times[order], eids[order]
    same = (n[1:] == n[:-1]) & (t[1:] == t[:-1])
    return bool((same & (ev[1:] != ev[:-1])).any())


def _csr_runs_equal(a, b):
    """Each node's run of ``a`` and ``b`` is the same multiset of (time,
    neighbor, event) entries, and ``a``'s times ascend within each run."""
    import numpy as np

    if not np.array_equal(a["indptr"], b["indptr"]):
        return False
    node = np.repeat(np.arange(len(a["indptr"]) - 1), np.diff(a["indptr"]))

    def canon(c):
        o = np.lexsort((c["adj_e"], c["adj_nbr"], c["adj_t"], node))
        return [np.asarray(c[k])[o] for k in ("adj_t", "adj_nbr", "adj_e")]

    ascending = bool(np.all((np.diff(a["adj_t"]) >= 0) | (np.diff(node) != 0)))
    return ascending and all(np.array_equal(x, y) for x, y in zip(canon(a), canon(b)))


def _train_batches_equal(torch, mem, store):
    """Every train batch of an epoch off the store bit-equal, key by key, to
    the in-memory pipeline's, as each pipeline stages it for its step. The
    batches do not depend on the parameters, so the store's data path (its
    columns, feature rows and negatives, pages released after each batch)
    is held exactly, where the epochs' losses are not (K2's float atomics).
    The sampler's sink row of ``nbr_buf`` is left out, as in
    ``prefetch_check``. Returns the number of batches."""
    import numpy as np

    from repro_torch.core import TRAIN_KEY

    n = 0
    for p in (mem, store):
        p.reset_epoch_state()
    with mem.manager.activate(TRAIN_KEY), store.manager.activate(TRAIN_KEY):
        for x, y in itertools.zip_longest(mem._loader(mem.train_data),
                                          store._loader(store.train_data)):
            check(x is not None and y is not None,
                  f"the store's epoch has another number of train batches ({n} equal)")
            check(x.keys() == y.keys(), f"train batch {n}: keys differ off the store")
            for k in x:
                a, b = x[k], y[k]
                if k == "nbr_buf":
                    a, b = a[:-1], b[:-1]
                if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
                    same = a.device == b.device and torch.equal(a, b)
                else:
                    same = type(a) is type(b) and np.array_equal(a, b)
                check(same, f"train batch {n}: {k!r} off the store differs")
            n += 1
    return n


def _store_epochs(torch, mem, store, tel, earlier):
    """One ``train_epoch()`` (and val MRR after it) off the in-memory stream
    and off the store from the same initial state. ``earlier`` is the train
    phase's epoch through the kernels, an in-memory epoch from that same
    state too: where the two in-memory epochs agree to the bit, the store
    epoch must as well; where they differ (float atomics in K2's table
    gradients), it is held to the train phase's tolerances. Either way,
    every train batch of the epoch is held bit-equal first
    (``_train_batches_equal``). Returns the numbers and which rule held."""
    check(_trees_equal(torch, mem.params, store.params),
          "the store-backed pipeline's initial parameters differ")
    rel0 = tel.counter_value("storage/windows_released")
    a = run_epoch(torch, mem, None)
    rss = _rss_bytes()
    s = run_epoch(torch, store, None)
    rss_after = _rss_bytes()
    released = tel.counter_value("storage/windows_released") - rel0
    n_train = math.ceil(store.train_data.num_edge_events / store.batch_size)
    n_val = math.ceil(store.val_data.num_edge_events / store.batch_size)
    for run, label in ((a, "in-memory"), (s, "store")):
        launched = {k: v for k, v in run["launches"].items() if v}
        check(launched == {"fused_temporal_layer": n_train,
                           "fused_temporal_layer_bwd": n_train},
              f"{label} epoch launched {launched} for {n_train} batches")
    # the epoch's batches, then the val MRR's warm-up (train) and val pass
    check(released == 2 * n_train + n_val,
          f"storage/windows_released {released} for {2 * n_train + n_val} batches")
    out = dict(in_memory=a, store=s, windows_released=released,
               train_batches_bit_equal=_train_batches_equal(torch, mem, store),
               rss_bytes_before_store_epoch=rss[0], rss_bytes_after_store_epoch=rss_after[0],
               peak_rss_bytes=rss_after[1])
    b = (earlier["loss"], earlier["val_mrr"])
    if (a["loss"], a["val_mrr"]) == b:
        check((s["loss"], s["val_mrr"]) == b,
              f"two in-memory epochs agree to the bit but the store epoch differs: "
              f"loss {s['loss']} vs {a['loss']}, val MRR {s['val_mrr']} vs {a['val_mrr']}")
        out["held"] = "bit-equal, as two in-memory epochs are"
        return out
    dl, dm = abs(s["loss"] - a["loss"]), abs(s["val_mrr"] - a["val_mrr"])
    check(dl <= EPOCH_LOSS_TOL and dm <= TRAIN_MRR_TOL,
          f"store epoch loss {s['loss']} / val MRR {s['val_mrr']} vs in-memory "
          f"{a['loss']} / {a['val_mrr']}: beyond {EPOCH_LOSS_TOL} / {TRAIN_MRR_TOL}")
    out.update(held="within EPOCH_LOSS_TOL and TRAIN_MRR_TOL (in-memory epochs "
                    "differ run to run)", loss_diff=dl, mrr_diff=dm,
               in_memory_spread=dict(loss=abs(a["loss"] - b[0]),
                                     val_mrr=abs(a["val_mrr"] - b[1])))
    return out


def _store_csr(torch, wiki, store, tel):
    """``streaming_csr`` over the store against the in-RAM ``build`` of both
    uniform samplers: bit-equal when no two distinct events share a
    ``(node, time)`` pair, else the same multiset per node with ascending
    times. Seconds of each build."""
    import numpy as np

    from repro_torch.core.device_uniform import DeviceUniformSampler
    from repro_torch.core.sampler import UniformSampler
    from repro_torch.storage import streaming_csr

    t = time.perf_counter()
    csr = streaming_csr(store, telemetry=tel)
    stream_s = time.perf_counter() - t
    host = UniformSampler(wiki.num_nodes, K20)
    t = time.perf_counter()
    host.build(wiki.src, wiki.dst, wiki.edge_t)
    host_s = time.perf_counter() - t
    dev = DeviceUniformSampler(wiki.num_nodes, K20, device=DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    dev.build(wiki.src, wiki.dst, wiki.edge_t)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t
    keys = ("adj_nbr", "adj_t", "adj_e", "indptr")
    got = {k: np.asarray(csr[k]) for k in keys}
    shared = _shared_node_time(wiki)
    out = dict(entries=int(len(got["adj_nbr"])), shared_node_time_pairs=shared,
               streaming_seconds=stream_s, host_build_seconds=host_s,
               device_build_seconds=dev_s,
               csr_windows=tel.counter_value("storage/csr_windows"))
    for label, want in (("host", host.state_dict()), ("device", dev.state_dict())):
        equal = all(np.array_equal(got[k], want[k]) for k in keys)
        if shared:
            check(equal or _csr_runs_equal(got, want),
                  f"streaming CSR vs the {label} build: a node's run differs")
            out[label] = "bit-equal" if equal else "same multiset per node, ascending"
        else:
            check(equal, f"streaming CSR is not bit-equal to the {label} build")
            out[label] = "bit-equal"
    return out


def _store_tgat2(torch, wiki, path):
    """2-layer TGAT over the store-built uniform samplers. Device sampler:
    ``evaluate("val")`` through K3 (three launches a scored batch) off the
    store and off the in-memory stream given the store's CSR, the MRRs
    equal; STORE_STEPS train steps on the card held against the CPU
    (``card_vs_cpu_steps``), K3 and K3b counted. Host sampler: the CSR equal
    to the in-RAM build's (given the same CSR where pairs collide) and the
    first STORE_HOST_BATCHES train batches' ``nbr_*`` / ``nbr2_*`` bit-equal
    to the in-memory pipeline's."""
    from repro_torch.core import TRAIN_KEY
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches
    from repro_torch.storage import MmapStore

    out = {}
    t = time.perf_counter()
    st = uniform_experiment(True).compile(data=MmapStore(path), device=DEVICE)
    out["setup_seconds"] = time.perf_counter() - t
    mem = uniform_experiment(True).compile(data=wiki, device=DEVICE)
    sh = next(h for h in st.manager.hooks() if hasattr(h, "sampler"))
    mh = next(h for h in mem.manager.hooks() if hasattr(h, "sampler"))
    mh.load_state_dict(sh.state_dict())  # the same CSR
    n_val = math.ceil(st.val_data.num_edge_events / st.batch_size)
    ev, _, _ = eval_run(torch, st, None)
    ev_mem, _, _ = eval_run(torch, mem, None)
    for r, label in ((ev, "store"), (ev_mem, "in-memory")):
        launched = {k: v for k, v in r["launches"].items() if v}
        check(launched == {"temporal_attention": 3 * n_val},
              f"2-layer TGAT ({label}) eval launched {launched} for {n_val} batches")
    check(ev["mrr"] == ev_mem["mrr"],
          f"2-layer TGAT val MRR off the store {ev['mrr']} vs in-memory {ev_mem['mrr']}")
    del mem
    reset_launches()
    steps = card_vs_cpu_steps(torch, st, STORE_STEPS)
    launches = dict(LAUNCHES)
    launched = {k: v for k, v in launches.items() if v}
    check(launched == {"temporal_attention": 3 * STORE_STEPS,
                       "temporal_attention_bwd": 3 * STORE_STEPS},
          f"2-layer TGAT store steps launched {launched}")
    out.update(eval=ev, eval_in_memory_mrr=ev_mem["mrr"],
               steps=dict(steps=STORE_STEPS, launches=launches, **steps))
    del st
    torch.cuda.empty_cache()

    host = uniform_experiment(False).compile(data=MmapStore(path), device=DEVICE)
    host_mem = uniform_experiment(False).compile(data=wiki, device=DEVICE)
    a = next(h for h in host.manager.hooks() if hasattr(h, "sampler"))
    b = next(h for h in host_mem.manager.hooks() if hasattr(h, "sampler"))
    b.load_state_dict(a.state_dict())
    n = 0
    for p in (host, host_mem):
        p.reset_epoch_state()
    with host.manager.activate(TRAIN_KEY), host_mem.manager.activate(TRAIN_KEY):
        for x, y in zip(host._loader(host.train_data), host_mem._loader(host_mem.train_data)):
            for f in ("ids", "times", "eids", "mask"):
                for hop in ("nbr", "nbr2"):
                    check(torch.equal(x[f"{hop}_{f}"], y[f"{hop}_{f}"]),
                          f"host uniform batch {n}: {hop}_{f} off the store differs")
            n += 1
            if n == STORE_HOST_BATCHES:
                break
    out["host_uniform_batches_bit_equal"] = n
    return out


def _trace_store_steps(torch, pipe, logdir):
    """``trace_capture`` around TRACE_STEPS store-backed train steps (idle
    margins inside it, so the profiler keeps the device records): the trace
    file exists and names K1's and K2's device kernels. Then
    ``device_memory_gauges``: the five gauges of each card, ``bytes_in_use``
    equal to ``torch.cuda.memory_allocated()``."""
    import os

    from repro_torch.core import TRAIN_KEY
    from repro_torch.obs import MemorySink, Telemetry, device_memory_gauges, trace_capture

    sink = MemorySink()
    tel = Telemetry(sink)
    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        it = iter(pipe._loader(pipe.train_data))
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with trace_capture(logdir, telemetry=tel):
                time.sleep(PROFILE_MARGIN_S)
                for _, batch in zip(range(TRACE_STEPS), it):
                    pipe._train_step(batch)
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
            seconds = time.perf_counter() - t
        finally:
            it.close()
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    check(len(files) == 1, f"trace_capture wrote {len(files)} files")
    with open(files[0]) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    k1 = sorted(n for n in names if any(k in n for k in K1_LAUNCHES))
    k2 = sorted(n for n in names if any(k in n for k in K2_LAUNCHES))
    check(bool(k1) and bool(k2), f"the trace names no K1 ({k1}) or K2 ({k2}) kernel")
    spans = [r for r in sink.records if r["kind"] == "span"]
    check([r["name"] for r in spans] == ["profiler/trace"]
          and spans[0]["attrs"]["logdir"] == logdir, "trace_capture's span")
    gauges = device_memory_gauges(tel)
    allocated = torch.cuda.memory_allocated(0)
    check(sorted(gauges) == sorted(f"device{i}/{g}" for i in range(torch.cuda.device_count())
                                   for g in GAUGES), f"device_memory_gauges gave {sorted(gauges)}")
    check(gauges["device0/bytes_in_use"] == allocated,
          f"bytes_in_use {gauges['device0/bytes_in_use']} vs memory_allocated {allocated}")
    return dict(trace_bytes=os.path.getsize(files[0]), seconds_with_margins=seconds,
                k1_kernels=k1, k2_kernels=k2, gauges=gauges)


def storage_phase(torch, wiki, train_run):
    """Out-of-core storage on the card (``repro_torch.storage``): the store
    written from full-scale ``wikipedia`` by ``MmapStore.from_data``
    (timed; bytes on disk; ``is_intact``); the quickstart off the in-memory
    stream and off ``compile(MmapStore(path))``: ``evaluate("val")`` through
    K1 (119 launches), MRR and the sampler state after it bit-equal; one
    ``train_epoch()`` each through K1 and K2 (552 launches each) and val MRR
    after it (``_store_epochs``, with ``train_run``, the train phase's
    kernel epoch), the pages released once per batch, the process's RSS; ``streaming_csr`` against the in-RAM builds
    (``_store_csr``); 2-layer TGAT over the store-built uniform samplers
    (``_store_tgat2``); the profiler hooks around store-backed train steps
    (``_trace_store_steps``). The store lives in a temporary directory,
    removed after."""
    import os
    import shutil
    import tempfile

    from repro_torch.obs import MemorySink, Telemetry
    from repro_torch.storage import MmapStore

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        path = os.path.join(tmp, "wikipedia")
        t = time.perf_counter()
        MmapStore.from_data(path, wiki)
        write_s = time.perf_counter() - t
        check(MmapStore.is_intact(path), "the written store is not intact")
        disk = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        out = dict(store=dict(write_seconds=write_s, bytes_on_disk=disk,
                              events=wiki.num_edge_events, nodes=wiki.num_nodes,
                              edge_feat_dim=wiki.edge_feat_dim, intact=True))

        tel = Telemetry(MemorySink())
        mem = quickstart({"epochs": 1}).compile(data=wiki, device=DEVICE)
        t = time.perf_counter()
        store = quickstart({"epochs": 1}).compile(data=MmapStore(path), device=DEVICE,
                                                  telemetry=tel)
        out["store"]["compile_seconds"] = time.perf_counter() - t
        n_val = math.ceil(store.val_data.num_edge_events / store.batch_size)
        ev_mem, state_mem, _ = eval_run(torch, mem, None)
        ev, state, _ = eval_run(torch, store, None)
        launched = {k: v for k, v in ev["launches"].items() if v}
        check(launched == {"fused_temporal_layer": n_val},
              f"store eval launched {launched} for {n_val} val batches")
        check(ev["mrr"] == ev_mem["mrr"],
              f"val MRR off the store {ev['mrr']} vs in-memory {ev_mem['mrr']}")
        check(_states_equal(state, state_mem), "sampler state after eval differs")
        out["eval"] = dict(ev, in_memory_mrr=ev_mem["mrr"], sampler_state_bit_equal=True)
        out["epoch"] = _store_epochs(torch, mem, store, tel, train_run)
        del mem
        out["csr"] = _store_csr(torch, wiki, MmapStore(path), tel)
        out["tgat2"] = _store_tgat2(torch, wiki, path)
        out["profiler"] = _trace_store_steps(torch, store, os.path.join(tmp, "trace"))
        del store
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


# Events ingested one by one: 20,000 before PR 25, cut to 12,000 for the
# script's time limit (the ingest is host-bound: 58 s of 20,000 on the
# slower card machines; NVIDIA H100 80GB HBM3, 700.00 W).
SERVE_EVENTS = 12_000
SERVE_POSITIVES = 1_000     # each with one negative: 2,000 link requests
SERVE_EMBEDS = 256
SERVE_SNAPSHOT_AT = 11_000
SERVE_DUPLICATES = 5
SERVE_COMPOSITION = 224     # link requests answered again in flushes of 1, 7, 32
SERVE_TOL = 2e-5
SERVE_TIMEOUT_S = 120
SERVE_CPU_TIMEOUT_S = 600


def serve_requests(wiki, seed: int = 0):
    """The request mix: the SERVE_POSITIVES events after the ingested ones
    as link requests, each followed by one with a negative destination from
    a seeded numpy draw, then SERVE_EMBEDS embed requests (the positives'
    sources at their times)."""
    import numpy as np

    lo, hi = SERVE_EVENTS, SERVE_EVENTS + SERVE_POSITIVES
    neg = np.random.default_rng(seed).integers(0, wiki.num_nodes, SERVE_POSITIVES)
    links = []
    for s, d, t, n in zip(wiki.src[lo:hi], wiki.dst[lo:hi], wiki.edge_t[lo:hi], neg):
        links += [(int(s), int(d), int(t)), (int(s), int(n), int(t))]
    embeds = [(int(s), int(t)) for s, t in zip(wiki.src[lo:lo + SERVE_EMBEDS],
                                               wiki.edge_t[lo:lo + SERVE_EMBEDS])]
    return links, embeds


def serve_cpu(path: str) -> None:
    """The serve phase's service on the CPU, run in a process of its own
    beside the card's ingest: the events and requests of ``path`` (an
    ``.npz`` of ``events`` (E, 4), ``links`` (L, 3), ``embeds`` (M, 2),
    ``num_nodes``) through ``OnlineGraphService(device="cpu")``; writes
    ``path + ".out.npz"``: the scores, the embeddings, the sampler's and
    EdgeBank's state, its ingest events/s and the request seconds."""
    import numpy as np
    import torch

    from repro_torch.serve import OnlineGraphService

    torch.set_num_threads(1)  # the card's ingest runs beside it on the host
    inp = np.load(path)
    events, links, embeds = (inp[k].tolist() for k in ("events", "links", "embeds"))
    with OnlineGraphService(int(inp["num_nodes"]), k=8, device="cpu") as cpu:
        rate = _ingest(torch, cpu, events)
        t = time.perf_counter()
        res = _answers(cpu, links, embeds)
        requests_s = time.perf_counter() - t
        _model_only(cpu, res)
        state, bank = cpu.sampler.state_dict(), cpu.edgebank.state_dict()
    np.savez(path + ".out.npz", ingest_events_per_s=rate, requests_seconds=requests_s,
             scores=np.array([r.score for r in res[:len(links)]]),
             embeddings=np.stack([r.embedding for r in res[len(links):]]),
             **{f"sampler_{k}": v for k, v in state.items()},
             **{f"edgebank_{k}": v for k, v in bank.items()})


def _answers(svc, links, embeds):
    """Submit every request at once; the responses in request order."""
    pend = [svc.submit_link(*q) for q in links] + [svc.submit_embed(*q) for q in embeds]
    return [p.result(timeout=SERVE_TIMEOUT_S) for p in pend]


def _ingest(torch, svc, events):
    """Ingest ``events`` and drain; events per second."""
    t = time.perf_counter()
    svc.ingest_many(events)
    svc.drain()
    if svc.device.type == "cuda":
        torch.cuda.synchronize()
    return len(events) / (time.perf_counter() - t)


def _model_only(svc, res):
    """No request of the non-chaos part was answered by anything but the
    learned tier, and no model call failed (a CUDA fault must not pass as
    EdgeBank's DEGRADED)."""
    from repro_torch.serve import Status

    tiers = {(r.status, r.tier) for r in res}
    check(tiers == {(Status.OK, "model")} and svc.stats["model_errors"] == 0,
          f"service answers {tiers}, model errors {svc.stats['model_errors']}")


def _same_bits(a, b, what):
    import numpy as np

    for x, y in zip(a, b):
        same = (x.score == y.score if x.embedding is None
                else np.array_equal(x.embedding, y.embedding))
        check(same, f"{what}: an answer differs")


def serve_phase(torch, wiki):
    """The online graph service (``repro_torch.serve``) on the card at the
    reference's widths (``d_model`` 32, ``time_dim`` 8, ``max_batch`` 32),
    k = 8 over wikipedia's 9,000 nodes: SERVE_EVENTS events ingested one by
    one (events/s), then 2,000 link and 256 embed requests under
    ``torch.profiler`` (the card's idle share over the request window, its
    busy time per flush); the same on the CPU (``serve_cpu``, in a process
    of its own on one thread that runs beside the card's ingest, so the
    card's events/s are read with it running): sampler and EdgeBank
    state bit-equal, scores within SERVE_TOL, embeddings within SERVE_TOL
    of their largest entry; every answer from the model tier, no model error;
    SERVE_COMPOSITION of the link requests answered again in flushes of 1,
    7 and 32, bit-identical; the card's service snapshotted mid-stream, at
    SERVE_SNAPSHOT_AT events, restored into a fresh service (which never saw
    the first one) that replays the rest with SERVE_DUPLICATES duplicates:
    the same state and the same bits as the uninterrupted service, and both
    stopped with nothing left in flight; last the chaos run of ``tests/test_serving.py``, every request
    resolved with an explicit status and the tallies equal to the
    telemetry counters. Per-tier latency p50 / p99 from the service's
    ``serve/latency/*`` histograms (and exact, from the responses)."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.obs import MemorySink, Telemetry

    t0 = time.perf_counter()
    n = SERVE_EVENTS
    events = [(int(s), int(d), int(t), i) for i, (s, d, t) in
              enumerate(zip(wiki.src[:n], wiki.dst[:n], wiki.edge_t[:n]))]
    links, embeds = serve_requests(wiki)

    tel = Telemetry(MemorySink())
    out, parts = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        path = os.path.join(tmp, "cpu.npz")
        np.savez(path, events=np.array(events), links=np.array(links),
                 embeds=np.array(embeds), num_nodes=wiki.num_nodes)
        with open(path + ".log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-c",
                 f"import sys; sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
                 f"import chip_smoke; chip_smoke.serve_cpu({path!r})"],
                stdout=log, stderr=subprocess.STDOUT)
        try:
            res, state, bank = _serve_card(torch, wiki, events, links, embeds,
                                           os.path.join(tmp, "snapshot"), tel, out, parts)
            t = time.perf_counter()
            rc = proc.wait(timeout=SERVE_CPU_TIMEOUT_S)
            parts["cpu_wait"] = time.perf_counter() - t
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(path + ".log") as log:
            check(rc == 0, f"the CPU service failed: {log.read()[-2000:]}")
        cpu, nl = np.load(path + ".out.npz"), len(links)
        check(all(np.array_equal(state[k], cpu[f"sampler_{k}"]) for k in state),
              "sampler state card vs CPU")
        check(all(np.array_equal(bank[k], cpu[f"edgebank_{k}"]) for k in bank),
              "EdgeBank state card vs CPU")
        score_err = float(np.abs(np.array([r.score for r in res[:nl]]) - cpu["scores"]).max())
        emb_rel = max(float(np.abs(r.embedding - e).max() / np.abs(e).max())
                      for r, e in zip(res[nl:], cpu["embeddings"]))
        check(score_err <= SERVE_TOL, f"scores card vs CPU differ by {score_err}")
        check(emb_rel <= SERVE_TOL, f"embeddings card vs CPU differ by {emb_rel} of the largest")
        out["cpu_ingest_events_per_s"] = float(cpu["ingest_events_per_s"])
        parts["cpu_requests"] = float(cpu["requests_seconds"])
        out["card_vs_cpu"] = dict(score_max_abs_err=score_err,
                                  embedding_max_err_of_largest=emb_rel,
                                  sampler_state_bit_equal=True, edgebank_bit_equal=True)
    t = time.perf_counter()
    out["chaos"] = serve_chaos(torch)
    parts["chaos"] = time.perf_counter() - t
    out["part_seconds"] = parts
    out["seconds"] = time.perf_counter() - t0
    return out


def _serve_card(torch, wiki, events, links, embeds, snap_dir, tel, out, parts):
    """``serve_phase``'s part on the card (the CPU service runs meanwhile in
    its own process): ingest with a snapshot into ``snap_dir`` mid-stream,
    the request window under the profiler, flush compositions, the restored
    service. Returns the card's answers, its sampler's and its EdgeBank's
    state, for the comparison with the CPU."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import OnlineGraphService

    def service(**kw):
        return OnlineGraphService(wiki.num_nodes, k=8, device=DEVICE, **kw)

    n = len(events)
    with service(telemetry=tel) as card:
        t = time.perf_counter()
        rate = _ingest(torch, card, events[:SERVE_SNAPSHOT_AT])
        parts["snapshot"] = -time.perf_counter()
        card.snapshot(snap_dir, step=SERVE_SNAPSHOT_AT)
        parts["snapshot"] += time.perf_counter()
        rate2 = _ingest(torch, card, events[SERVE_SNAPSHOT_AT:])
        parts["card_ingest"] = time.perf_counter() - t - parts["snapshot"]
        out["ingest_events_per_s"] = n / parts["card_ingest"]
        out["ingest_events_per_s_by_part"] = [rate, rate2]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            t = time.perf_counter()
            res = _answers(card, links, embeds)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t)
            time.sleep(PROFILE_MARGIN_S)
        _model_only(card, res)
        flushes = tel.counter_value("serve/flushes")
        t = time.perf_counter()
        window = device_window(prof, wall_us)
        parts["profiler_read"] = time.perf_counter() - t
        out["requests"] = dict(
            links=len(links), embeds=len(embeds), flushes=flushes, **window,
            device_ms_per_flush=(window["device_busy_ms"] / flushes
                                 if window["device_events"] else None),
            latency_hist_s={tier: {"p50": h.quantile(0.5), "p99": h.quantile(0.99),
                                   "count": h.count}
                            for tier in ("model", "edgebank", "model_call")
                            for h in [tel.histogram(f"serve/latency/{tier}")] if h},
            latency_exact_s={"p50": float(np.percentile([r.latency_s for r in res], 50)),
                             "p99": float(np.percentile([r.latency_s for r in res], 99))})

        state, bank = card.sampler.state_dict(), card.edgebank.state_dict()

        sizes = {}
        t = time.perf_counter()
        for size in (1, 7, 32):
            f0 = tel.counter_value("serve/flushes")
            got = []
            for lo in range(0, SERVE_COMPOSITION, size):
                got += _answers(card, links[lo:min(lo + size, SERVE_COMPOSITION)], [])
            _same_bits(got, res[:SERVE_COMPOSITION], f"flushes of {size}")
            sizes[size] = tel.counter_value("serve/flushes") - f0
        parts["flush_composition"] = time.perf_counter() - t
        out["flush_composition"] = dict(requests=SERVE_COMPOSITION, flushes=sizes,
                                        bit_identical=True)
        _model_only(card, res)

        t = time.perf_counter()
        with service() as revived:
            check(revived.restore(snap_dir) == SERVE_SNAPSHOT_AT, "restored step")
            _ingest(torch, revived, events[SERVE_SNAPSHOT_AT - SERVE_DUPLICATES:])
            check(revived.stats["events_deduped"] == SERVE_DUPLICATES,
                  f"replay deduped {revived.stats['events_deduped']} events")
            a, b = revived.sampler.state_dict(), card.sampler.state_dict()
            check(all(np.array_equal(a[k], b[k]) for k in a), "restored sampler state")
            a, b = revived.edgebank.state_dict(), card.edgebank.state_dict()
            check(all(np.array_equal(a[k], b[k]) for k in a), "restored EdgeBank state")
            again = _answers(revived, links, embeds)
            _model_only(revived, again)
            _same_bits(again, res, "restored service")
        parts["restore_replay_answer"] = time.perf_counter() - t
        out["snapshot_restore"] = dict(at=SERVE_SNAPSHOT_AT, duplicates=SERVE_DUPLICATES,
                                       bit_identical=True)
    return res, state, bank


def serve_chaos(torch):
    """``tests/test_serving.py``'s chaos run on the card: slow and failing
    model steps, a dropped / duplicated / reordered stream; every request
    resolved with an explicit status, over-deadline requests shed, EdgeBank
    answering while the model tier is down, and the tallies equal to the
    telemetry counters."""
    import numpy as np

    from repro_torch.obs import MemorySink, Telemetry, validate
    from repro_torch.serve import FaultInjector, OnlineGraphService, Status

    inj = FaultInjector(seed=0, drop_p=0.05, dup_p=0.05, reorder_p=0.15,
                        reorder_span=3, slow_p=0.5, slow_s=0.02, fail_p=0.6)
    sink = MemorySink()
    tel = Telemetry(sink)
    rng = np.random.default_rng(1)
    stream = [(int(rng.integers(60)), int(rng.integers(60)), 100 + i, i) for i in range(150)]
    with OnlineGraphService(60, k=4, flush_interval=0.002, fault_injector=inj,
                            fail_threshold=2, probe_every=3, latency_budget=0.05,
                            telemetry=tel, device=DEVICE) as svc:
        svc.ingest_many(inj.perturb_events(stream))
        svc.drain()
        pend = [svc.submit_link(i % 60, (i * 7 + 1) % 60, 1000, timeout=5.0)
                for i in range(30)]
        pend += [svc.submit_link(1, 2, 1000, timeout=0.0) for _ in range(3)]
        results = [p.result(timeout=30) for p in pend]
        statuses = {r.status for r in results}
        check(Status.REJECTED in statuses and Status.DEGRADED in statuses
              and inj.stats["model_faults"] > 0, f"chaos statuses {statuses}")
        tallies = {s: svc.stats[s] for s in ("ok", "degraded", "rejected", "failed")}
        check(sum(tallies.values()) == len(results), f"chaos tallies {tallies}")
        counters = {s: tel.counter_value(f"serve/requests_{s}") for s in tallies}
        check(counters == tallies, f"chaos counters {counters} vs tallies {tallies}")
        check(tel.counter_value("serve/model_errors") == svc.stats["model_errors"]
              and tel.counter_value("serve/events_deduped") == svc.stats["events_deduped"],
              "chaos: telemetry counters differ from the service's stats")
    tel.flush()
    for rec in sink.records:
        validate(rec)
    return dict(tallies=tallies, injected=dict(inj.stats), counters_equal=True)


def dtdg_profile_phase(torch, data, n_steps: int = 100, n_window: int = 30):
    """``--profile``: where a GCLSTM train step's time goes, by host clock
    with a synchronise closing each part (forward and loss, backward, AdamW;
    steady steps after the first 10), then ``torch.profiler`` over
    ``n_window`` train steps and over ``n_window`` scored val pairs as the
    pipeline runs them (no synchronise inside): device busy time, idle
    share, device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.tg.common import bce_link_loss

    pipe = dtdg_experiment().compile(data=data, device=DEVICE)
    sync = torch.cuda.synchronize
    lo, _ = pipe._split_pairs("train")
    xs = pipe._pair_xs(lo, lo + n_steps + n_window, pipe.num_negatives)
    pipe.reset_epoch_state()
    parts = {"forward": [], "backward": [], "optimizer": []}
    for i in range(n_steps):
        x = {k: v[i] for k, v in xs.items()}
        sync()
        t0 = time.perf_counter()
        pos, neg, st = pipe._scores(pipe.params, x, pipe.model_state)
        loss = bce_link_loss(pos, neg, x["nmask"])
        sync()
        t1 = time.perf_counter()
        grads = pipe._grads(loss)
        sync()
        t2 = time.perf_counter()
        pipe._update(grads)
        pipe.model_state = tuple(t.detach() for t in st)
        sync()
        t3 = time.perf_counter()
        for k, a, b in (("forward", t0, t1), ("backward", t1, t2),
                        ("optimizer", t2, t3)):
            parts[k].append(1e3 * (b - a))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps, n_steps + n_window):
            pipe._train_step({k: v[i] for k, v in xs.items()})
        sync()
        train_us = 1e6 * (time.perf_counter() - t0)
    train_window = device_window(prof, train_us)
    vlo, _ = pipe._split_pairs("val")
    vxs = pipe._pair_xs(vlo, vlo + n_window, pipe.eval_negatives)
    state = pipe._init_state()
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_window):
            state, _, _ = pipe._eval_step(state, {k: v[i] for k, v in vxs.items()})
        sync()
        eval_us = 1e6 * (time.perf_counter() - t0)
    return {"train_step_ms": {k: statistics.median(v[10:]) for k, v in parts.items()},
            "steps": n_steps, "train_trace": {"steps": n_window, **train_window},
            "eval_trace": {"pairs": n_window, **device_window(prof, eval_us)}}


def dtdg_spread_phase(torch, data, rounds: int = 6):
    """``--profile``: the spread of free-running GCLSTM epochs on the card,
    from which DTDG_EPOCH_LOSS_TOL and DTDG_MRR_TOL are set: two K4 epochs
    from the same start (K4 is deterministic, so they should agree to the
    bit), ``rounds`` plain epochs from the same start (``index_add_``'s
    float atomics make each its own trajectory) and ``rounds`` plain epochs
    from parameters scaled by 1 + c * 1e-7, each against the first K4
    epoch; and the largest distance between two plain epochs."""
    from repro_torch.tree import tree_map

    pipe = dtdg_experiment().compile(data=data, device=DEVICE)
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)

    def epoch(mode, scale=1.0):
        pipe.load_params(tree_map(lambda t: t * scale, init[0]))
        pipe.load_opt_state(init[1])
        r = dtdg_epoch(torch, pipe, mode)
        return r["loss"], r["val_mrr"]

    base = epoch("auto")
    runs = [("kernel", epoch("auto"))]
    runs += [("plain", epoch("ref")) for _ in range(rounds)]
    runs += [(f"plain x(1{c:+d}e-7)", epoch("ref", 1 + c * 1e-7))
             for c in (1, -1, 2, -2, 3, -3)[:rounds]]
    plains = [r for name, r in runs if name.startswith("plain")]
    return {"kernel": {"loss": base[0], "val_mrr": base[1]},
            "runs": [{"run": name, "loss": l, "val_mrr": m,
                      "loss_diff": abs(l - base[0]), "mrr_diff": abs(m - base[1])}
                     for name, (l, m) in runs],
            "max_loss_diff": max(abs(l - base[0]) for _, (l, _) in runs),
            "max_mrr_diff": max(abs(m - base[1]) for _, (_, m) in runs),
            "max_plain_pair_loss_diff": max(abs(a[0] - b[0]) for a in plains for b in plains),
            "max_plain_pair_mrr_diff": max(abs(a[1] - b[1]) for a in plains for b in plains)}


def spread_phase(torch, rounds: int = 3):
    """``--profile``: the spread of free-running train epochs on the card,
    from which EPOCH_LOSS_TOL and TRAIN_MRR_TOL are set: ``rounds`` kernel
    epochs from the same initial state (the table gradients' float atomics
    make each its own trajectory) and ``rounds`` plain epochs from the
    initial parameters scaled by 1 + c * 1e-7, each against the plain epoch
    from the initial state."""
    from repro_torch.tree import tree_map

    pipe = quickstart({"epochs": 1}).compile(device=DEVICE)
    init = (tree_map(lambda t: t.detach().clone(), pipe.params),
            tree_map(lambda t: t.detach().clone(), pipe.opt_state))

    def epoch(fused, scale=1.0):
        pipe.load_params(tree_map(lambda t: t * scale, init[0]))
        pipe.load_opt_state(init[1])
        r = run_epoch(torch, pipe, fused)
        return r["loss"], r["val_mrr"]

    base = epoch("ref")
    runs = [("kernels", epoch(None)) for _ in range(rounds)]
    runs += [(f"plain x(1{c:+d}e-7)", epoch("ref", 1 + c * 1e-7))
             for c in (1, -1, 2, -2, 3)[:rounds]]
    return {"plain": {"loss": base[0], "val_mrr": base[1]},
            "runs": [{"run": name, "loss": l, "val_mrr": m,
                      "loss_diff": abs(l - base[0]), "mrr_diff": abs(m - base[1])}
                     for name, (l, m) in runs],
            "max_loss_diff": max(abs(l - base[0]) for _, (l, _) in runs),
            "max_mrr_diff": max(abs(m - base[1]) for _, (_, m) in runs)}


def profile_phase(torch, exp=None):
    """``--profile``: where a path's time goes (``exp``, the device-sampler
    quickstart by default), by host clock with a device synchronise after
    each part (so each part's device work is inside its own interval): the
    warm pass per batch, and per scored val batch the hooks (sampling,
    negatives, staging), the model step and the metric."""
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe = (exp or quickstart()).compile(device=DEVICE)
    sync = torch.cuda.synchronize
    pipe.reset_epoch_state()
    sync()
    t0 = time.perf_counter()
    n_warm = 0
    with pipe.manager.activate(TRAIN_KEY):
        for batch in pipe._loader(pipe.train_data):
            pipe._advance(batch)
            n_warm += 1
    sync()
    warm_s = time.perf_counter() - t0
    parts = {"hooks": [], "model": [], "metric": []}
    with pipe.manager.activate(EVAL_KEY):
        it = iter(pipe._loader(pipe.val_data))
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            sync()
            t1 = time.perf_counter()
            if batch is None:
                break
            pos, neg = pipe._eval_step(batch)
            sync()
            t2 = time.perf_counter()
            mrr(pos, neg, batch["batch_mask"])
            t3 = time.perf_counter()
            parts["hooks"].append(t1 - t0)
            parts["model"].append(t2 - t1)
            parts["metric"].append(t3 - t2)
    n = len(parts["model"])
    return pipe, {"warm_batches": n_warm, "warm_seconds": warm_s,
                  "warm_ms_per_batch": 1e3 * warm_s / max(n_warm, 1),
                  "scored_batches": n,
                  "scored_ms_per_batch": {k: 1e3 * sum(v) / max(n, 1)
                                          for k, v in parts.items()},
                  "scored_ms_per_batch_median": {
                      k: 1e3 * statistics.median(v) for k, v in parts.items()}}


def loader_phase(torch, rounds: int = 2, train_steps: int = 200):
    """``--profile``: what the prefetch thread would cost. The scored val
    pass (after an untimed warm pass) and the first ``train_steps`` train
    steps, run as ``evaluate`` / ``train_epoch`` run them (no synchronise
    inside, one at the end), with the batches from (a) the pipeline's loader
    (hooks in the calling thread), (b) ``PrefetchLoader`` (hooks in its
    producer thread). Host clock, ms per batch, the two in turns for
    ``rounds`` rounds."""
    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe = quickstart().compile(device=DEVICE)
    sync = torch.cuda.synchronize

    def scored(loader):
        pipe.reset_epoch_state()
        with pipe.manager.activate(TRAIN_KEY):
            for _ in loader(pipe.train_data):
                pass
        sync()
        n, t0 = 0, time.perf_counter()
        with pipe.manager.activate(EVAL_KEY):
            for b in loader(pipe.val_data):
                pos, neg = pipe._eval_step(b)
                mrr(pos, neg, b["batch_mask"])
                n += 1
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    def train(loader):
        pipe.reset_epoch_state()
        sync()
        n, t0 = 0, time.perf_counter()
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(loader(pipe.train_data))
            for _, b in zip(range(train_steps), it):
                pipe._train_step(b)
                n += 1
            it.close()
        sync()
        return 1e3 * (time.perf_counter() - t0) / n

    out = {"eval_scored_ms_per_batch": {}, "train_ms_per_step": {}}
    for _ in range(rounds):
        for key, fn in (("eval_scored_ms_per_batch", scored),
                        ("train_ms_per_step", train)):
            for name, loader in (
                    ("inline", pipe._loader),
                    ("prefetch", lambda data: prefetch_loader(pipe, data))):
                out[key].setdefault(name, []).append(fn(loader))
    return out


def train_profile_phase(torch, n_steps: int = 150):
    """``--profile``: where a train step's time goes, by host clock with a
    device synchronise after each part: the next batch from the loader
    (hooks and staging, in the calling thread), the forward (K1 inside),
    the backward (K2 inside) and the AdamW update."""
    from repro_torch.core import TRAIN_KEY

    pipe = quickstart().compile(device=DEVICE)
    sync = torch.cuda.synchronize
    parts = {"hooks": [], "forward": [], "backward": [], "optimizer": []}
    pipe.reset_epoch_state()
    sync()
    with pipe.manager.activate(TRAIN_KEY):
        it = iter(pipe._loader(pipe.train_data))
        try:
            for _ in range(n_steps):
                t0 = time.perf_counter()
                batch = next(it, None)
                sync()
                t1 = time.perf_counter()
                if batch is None:
                    break
                loss = pipe._loss(batch)
                sync()
                t2 = time.perf_counter()
                grads = pipe._grads(loss)
                sync()
                t3 = time.perf_counter()
                pipe._update(grads)
                sync()
                t4 = time.perf_counter()
                for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                    parts[name].append(dt)
        finally:
            it.close()
    n = len(parts["forward"])
    # The first steps see an empty sampler and warm caches: skip 10.
    steady = {k: v[10:] for k, v in parts.items()}
    return pipe, {"steps": n, "steady_steps": max(n - 10, 0),
                  "ms_per_step_mean": {k: 1e3 * sum(v) / max(len(v), 1)
                                       for k, v in steady.items()},
                  "ms_per_step_median": {k: 1e3 * statistics.median(v)
                                         for k, v in steady.items() if v}}


def trace_phase(torch, pipe, n_batches: int = 30, train: bool = False):
    """``--profile``: ``torch.profiler`` over the first ``n_batches`` scored
    val batches (after a fresh warm pass), run as ``evaluate`` runs them, or
    with ``train`` over train steps 50 onwards as ``train_epoch`` runs them;
    no synchronise inside the window. Device busy time is the union of the
    device events' intervals; the idle share is one minus busy over the
    window's host-clock time (closed by a synchronise). Also the device time
    by kernel name, largest first."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EVAL_KEY, TRAIN_KEY
    from repro_torch.train.metrics import mrr

    pipe.reset_epoch_state()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    if train:
        with pipe.manager.activate(TRAIN_KEY):
            it = iter(pipe._loader(pipe.train_data))
            try:
                for _, batch in zip(range(50), it):
                    pipe._train_step(batch)
                torch.cuda.synchronize()
                with profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    for _, batch in zip(range(n_batches), it):
                        pipe._train_step(batch)
                    torch.cuda.synchronize()
                    wall_us = 1e6 * (time.perf_counter() - t0)
            finally:
                it.close()
    else:
        with pipe.manager.activate(TRAIN_KEY):
            for _ in pipe._loader(pipe.train_data):
                pass
        torch.cuda.synchronize()
        with profile(activities=acts) as prof, pipe.manager.activate(EVAL_KEY):
            t0 = time.perf_counter()
            for _, batch in zip(range(n_batches), pipe._loader(pipe.val_data)):
                pos, neg = pipe._eval_step(batch)
                mrr(pos, neg, batch["batch_mask"])
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    return {"batches": n_batches, **device_window(prof, wall_us)}


def device_window(prof, wall_us, sum_of=()):
    """Device busy time (the union of the device events' intervals), idle
    share (one minus busy over the window's host-clock time ``wall_us``) and
    device time by kernel name, largest first, of a ``torch.profiler`` run
    (busy time and idle share ``None`` where it kept no device event: not
    measured); with ``sum_of``, also ``ms_of``: the device ms of the
    kernels whose names hold each of those fragments.
    Read from the profiler's raw kineto events (device records, in ns):
    building ``prof.events()`` over a window of thousands of launches takes
    tens of seconds."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type().name == "CUDA")
    busy, end, by_name = 0, -math.inf, {}
    for a, b, name in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
        by_name[name] = by_name.get(name, 0) + b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    layer = {label: sum(v for k, v in by_name.items()
                        if any(n in k for n in launches))
             for label, launches in (("K1", K1_LAUNCHES), ("K2", K2_LAUNCHES),
                                     ("K3", ("ta_fwd_kernel",)),
                                     ("K3b", ("ta_bwd_kernel",)))}
    return {"device_events": len(spans),
            "ms_of": {f: sum(v for k, v in by_name.items() if f in k) / 1e6 for f in sum_of},
            "window_ms": wall_us / 1e3, "device_busy_ms": busy / 1e6 if spans else None,
            "device_idle_share": 1.0 - busy / 1e3 / wall_us if spans else None,
            "device_ms_by_name": {k: v / 1e6 for k, v in top},
            "kernel_device_ms": {k: v / 1e6 for k, v in layer.items()},
            "kernel_busy_share": {k: v / busy if busy else None
                                  for k, v in layer.items()}}


# ---------------------------------------------------------------------------
# The LM serving slice: K5 (flash attention) and K6 (the SSD chunk scan)
# ---------------------------------------------------------------------------
def flash_visible_pairs(Sq, Skv, causal, window):
    """Visible (query, key) pairs of one (batch, head) under K5's mask."""
    off = Skv - Sq
    total = 0
    for i in range(Sq):
        pos = i + off
        hi = min(Skv - 1, pos) if causal else Skv - 1
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound(B, H, Hk, Sq, Skv, D, causal, window, dtype_bytes):
    """Least time (ms) for one K5 call: q, k, v read once and o written once;
    4 D operations per visible (query, key) pair and head (the score and its
    share of the weighted sum), over the peak of the inputs' type (bf16 on
    the tensor cores, float32 on the CUDA cores). Returns (bound_ms,
    bound_by, bytes, flops)."""
    nbytes = dtype_bytes * D * (2 * B * H * Sq + 2 * B * Hk * Skv)
    flops = 4 * D * B * H * flash_visible_pairs(Sq, Skv, causal, window)
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    return _bound(nbytes, flops, peak)


def flash_bwd_bound(B, H, Hk, Sq, Skv, D, causal, window, dtype_bytes):
    """Least time (ms) for one K5b call: q, k, v, o, dO and the float32
    log-sum-exp read once, dq, dk and dv written once; the five products
    (S, dP, dV, dQ, dK) of 2 D operations per visible (query, key) pair and
    head, over the peak of the inputs' type. Returns (bound_ms, bound_by,
    bytes, flops)."""
    nbytes = dtype_bytes * D * (4 * B * H * Sq + 4 * B * Hk * Skv) + 4 * B * H * Sq
    flops = 10 * D * B * H * flash_visible_pairs(Sq, Skv, causal, window)
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    return _bound(nbytes, flops, peak)


def ssd_bound(B, S, H, G, P, N, dtype_bytes):
    """Least time (ms) for one K6 call: x, B, C, dt and a read once, y and
    the final state written once; the recurrence's 4 P N operations per
    step and head (the state update and the output), over the peak of the
    inputs' type. Returns (bound_ms, bound_by, bytes, flops)."""
    nbytes = (dtype_bytes * (2 * B * S * H * P + 2 * B * S * G * N)
              + 4 * (B * S * H + H + B * H * P * N))
    flops = 4 * B * S * H * P * N
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    return _bound(nbytes, flops, peak)


def ssd_bwd_bound(B, S, H, G, P, N, dtype_bytes):
    """Least time (ms) for one K6b call in training (no final-state
    cotangent): x, dy, B, C, dt and a read once, dx, dB, dC, ddt and da
    written once; the recurrence's backward, 8 P N operations per step and
    head (two outer products and two state-vector products), over the peak
    of the inputs' type. Returns (bound_ms, bound_by, bytes, flops)."""
    nbytes = (dtype_bytes * (3 * B * S * H * P + 4 * B * S * G * N)
              + 4 * (2 * B * S * H + 2 * H))
    flops = 8 * B * S * H * P * N
    peak = PEAK_BF16_FLOPS if dtype_bytes == 2 else PEAK_F32_FLOPS
    return _bound(nbytes, flops, peak)


def _sdpa(torch, q, k, v, causal, window):
    """``scaled_dot_product_attention`` on (B, H, S, D) views: ``is_causal``
    without a window, an explicit boolean mask with one; GQA by
    ``enable_gqa`` where the installed torch has it, else repeated kv."""
    import torch.nn.functional as F

    G = q.shape[1] // k.shape[1]
    kw = {}
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        kw["enable_gqa"] = True
    elif G > 1:
        k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    if not window:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, **kw)
    Sq, Skv = q.shape[2], k.shape[2]
    i = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    t = torch.arange(Skv, device=q.device)[None, :]
    mask = (t > i - window) & ((t <= i) if causal else True)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **kw)


def flash_inputs(torch, gen, B, H, Hk, Sq, Skv, D, dtype):
    """q (B, Sq, H, D), k and v (B, Skv, Hk, D) ~ N(0, 1) on the card: the
    model's layout (the projected rows after RoPE are of that scale)."""
    return [torch.randn(s, generator=gen).to(DEVICE, dtype)
            for s in ((B, Sq, H, D), (B, Skv, Hk, D), (B, Skv, Hk, D))]


def ssd_inputs(torch, gen, B, S, H, G, P, N, dtype, dt_scale=1.0):
    """x, Bm, Cm as views of one (B, S, H P + 2 G N) tensor, as the model
    splits its conv output; dt = dt_scale softplus(N(0, 1)) and a =
    -exp(N(1, 0.3)) (the model's a_log starts at 1) in float32."""
    import torch.nn.functional as F

    xbc = (torch.randn((B, S, H * P + 2 * G * N), generator=gen) * 0.5).to(DEVICE, dtype)
    x, bm, cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    dt = (dt_scale * F.softplus(torch.randn((B, S, H), generator=gen))).to(DEVICE)
    a = -torch.exp(1.0 + 0.3 * torch.randn((H,), generator=gen)).to(DEVICE)
    return (x.reshape(B, S, H, P), dt, a, bm.reshape(B, S, G, N),
            cm.reshape(B, S, G, N))


def _flash_plain(q, k, v, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention_ref

    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window).transpose(1, 2)


def compare_rel(torch, got, want, what: str, tol: float):
    """Hold ``got`` to ``want`` by the largest error over the largest
    reference entry (float32); returns (max abs err, relative)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(tuple(got.shape) == tuple(want.shape),
          f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    rel = err / scale if scale > 0 else err
    check(rel <= tol, f"{what}: max abs err {err:.3e} is {rel:.3e} of the "
                      f"largest entry (limit {tol})")
    return err, rel


# K5 / K6 main shapes of the slice: (label, B, S, H, Hk, D, causal, window)
# and (label, B, S, H, G, P, N), bfloat16; K6 also at the 32k prefill's.
K5_SHAPES = (("hymba", LM_B, LM_S, 25, 5, 64, True, 1024),
             ("qwen3", LM_B, LM_S, 16, 8, 128, True, 0))
# K6b is held and timed at the first two, the training shapes.
K6B_LABELS = ("hymba", "mamba2")
K6_SHAPES = (("hymba", LM_B, LM_S, 50, 1, 64, 16),
             ("mamba2", LM_B, LM_S, 48, 1, 64, 128),
             ("hymba_32k", 1, 32_768, 50, 1, 64, 16))


# K5b's degenerate cases (name, B, H, Hk, Sq, Skv, D, causal, window, dtype):
# Sq != Skv (one query over 4,096 keys too), S not a multiple of a tile, a
# window >= S, non-causal, float32 on the CUDA cores, D 64, 96, 128 and
# zero-padded 120 and 8 (float32); then the bf16 passes' 128-row blocks and
# 64-row tiles: Skv not a multiple of 128 with G 5 and a window, key blocks
# no row sees (Sq < Skv behind a window), Sq not a multiple of 128 at D 128.
K5B_CASES = (("sq100_skv4096_window", 2, 25, 5, 100, 4096, 64, True, 1024, "bfloat16"),
             ("s1000_unaligned", 2, 25, 5, 1000, 1000, 64, True, 1024, "bfloat16"),
             ("window_ge_s", 2, 25, 5, 1000, 1000, 64, True, 2048, "bfloat16"),
             ("bidirectional", 2, 4, 2, 200, 263, 32, False, 0, "bfloat16"),
             ("window_no_causal", 1, 4, 2, 300, 300, 64, False, 64, "bfloat16"),
             ("bf16_d96", 1, 32, 32, 300, 300, 96, True, 0, "bfloat16"),
             ("bf16_d128_s1000", 1, 16, 8, 1000, 1000, 128, True, 0, "bfloat16"),
             ("bf16_d120", 1, 6, 2, 130, 130, 120, True, 40, "bfloat16"),
             ("bf16_sq1_skv4096", 4, 16, 8, 1, 4096, 128, True, 0, "bfloat16"),
             ("f32_hymba", 1, 25, 5, 1000, 1000, 64, True, 1024, "float32"),
             ("f32_qwen3", 1, 16, 8, 1000, 1000, 128, True, 0, "float32"),
             ("f32_d8_offset", 1, 4, 4, 130, 197, 8, True, 0, "float32"),
             ("bf16_skv200_g5_window", 1, 10, 2, 200, 200, 64, True, 70, "bfloat16"),
             ("bf16_unseen_key_blocks", 2, 4, 2, 20, 300, 64, True, 8, "bfloat16"),
             ("bf16_sq200_d128", 2, 16, 8, 200, 200, 128, True, 0, "bfloat16"))


def ptxas_report(logs: dict, fragments, library: str):
    """Registers, spill bytes and ``wgmma`` serialisation warnings of each
    kernel whose mangled name holds one of ``fragments``, from the ``nvcc
    -Xptxas -v`` output of the library whose name starts with ``library``
    (``_build.build_all``'s logs), each kernel read from its "Compiling
    entry function" line to the next. ``None`` when that library was not
    built in this run (its log is empty); the check fails when a kernel's
    report lacks a number."""
    log = next((t for n, t in logs.items() if n.startswith(library + "-")), "")
    if not log:
        return None
    lines = log.splitlines()
    starts = [i for i, ln in enumerate(lines) if "Compiling entry function" in ln]
    out = {}
    for i, j in zip(starts, starts[1:] + [len(lines)]):
        frag = next((f for f in fragments if f in lines[i]), None)
        if frag is None:
            continue
        name = lines[i].split("'")[1]
        block = "\n".join(lines[i + 1:j])

        def num(pat):
            m = re.search(pat, block)
            check(m is not None, f"ptxas report of {name}: no match for {pat!r}")
            return int(m.group(1))

        targs = re.match(r"I((?:L[ib]\d+E)+)E", name[name.index(frag) + len(frag):])
        label = frag + ("<" + ", ".join(
            v if k == "i" else ("true" if v == "1" else "false")
            for k, v in re.findall(r"L([ib])(\d+)E", targs.group(1))) + ">" if targs else "")
        out[label] = dict(registers=num(r"Used (\d+) registers"),
                          spill_stores=num(r"(\d+) bytes spill stores"),
                          spill_loads=num(r"(\d+) bytes spill loads"),
                          wgmma_serialized=any("C7512" in x and name in x for x in lines))
    return out


def k5b_check(torch, gen, q, k, v, causal, window, label):
    """K5b at one of the slice's shapes: K5's log-sum-exp (and its output
    with it bit-equal to the call without) against the plain log-sum-exp;
    dq, dk and dv against the plain backward on the same (q, k, v, o, lse,
    dO) and against autograd of the plain forward in float32, each to
    BF16_TOL of the gradient's largest entry; a second launch bitwise.
    Returns its numbers and the three callables to time (K5b, the plain
    backward, SDPA forward + backward)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_bwd_ref, flash_attention_kernel,
        flash_attention_lse_ref)

    T = lambda x: x.transpose(1, 2)  # noqa: E731
    kw = dict(causal=causal, window=window)
    do = torch.randn(q.shape, generator=gen).to(DEVICE, q.dtype)
    o, lse = flash_attention_kernel(q, k, v, **kw, layout="bshd", return_lse=True)
    check(bool(torch.equal(o, flash_attention_kernel(q, k, v, **kw, layout="bshd"))),
          f"K5 {label}: the output with the log-sum-exp differs from the one without")
    lse_err = compare(torch, lse, flash_attention_lse_ref(T(q), T(k), T(v), **kw)[1],
                      f"K5 {label} lse", ATOL)
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw, layout="bshd")
    again = flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw, layout="bshd")
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"K5b {label}: a second launch gave other bits")
    del again
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw, layout="bshd")
    errs = {f"d{n}": compare_rel(torch, a, b, f"K5b {label} d{n}", BF16_TOL)
            for n, a, b in zip("qkv", got, want)}
    del want
    with torch.enable_grad():  # the phase runs under no_grad
        xs = [x.float().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(_flash_plain(*xs, causal, window), xs, do.float())
    errs_auto = {f"d{n}": compare_rel(torch, a, b, f"K5b {label} d{n} (autograd)", BF16_TOL)
                 for n, a, b in zip("qkv", got, auto)}
    del xs, auto, got
    torch.cuda.empty_cache()
    qs, ks, vs = (T(x).detach().requires_grad_() for x in (q, k, v))
    sdpa = _sdpa(torch, qs, ks, vs, causal, window)

    def sdpa_fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(sdpa(), (qs, ks, vs), T(do))

    with torch.enable_grad():  # one saved forward: SDPA's backward alone
        saved = sdpa()

    def sdpa_bwd():
        return torch.autograd.grad(saved, (qs, ks, vs), T(do), retain_graph=True)

    fns = {"bwd": lambda: flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw, layout="bshd"),
           "bwd_plain": lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw,
                                                        layout="bshd"),
           "bwd_sdpa": sdpa_fwd_bwd, "bwd_sdpa_only": sdpa_bwd}
    out = dict(max_abs_err=max(e[0] for e in errs.values()),
               rel_err={n: e[1] for n, e in errs.items()},
               rel_err_vs_autograd={n: e[1] for n, e in errs_auto.items()},
               lse_max_abs_err=lse_err, rerun_bitwise_equal=True)
    return out, fns


def k5b_case(torch, gen, cases, name, B, H, Hk, Sq, Skv, D, causal, window, dtype):
    """K5b on one degenerate input against the plain backward (BF16_TOL of
    each gradient's largest entry, ATOL in float32), a second launch and the ``bhsd``
    layout's call (on transposed copies) bitwise; appended to ``cases``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_bwd_ref, flash_attention_kernel)

    q, k, v = flash_inputs(torch, gen, B, H, Hk, Sq, Skv, D, dtype)
    do = torch.randn(q.shape, generator=gen).to(DEVICE, dtype)
    kw = dict(causal=causal, window=window, layout="bshd")
    o, lse = flash_attention_kernel(q, k, v, **kw, return_lse=True)
    got = flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd_kernel(q, k, v, o, lse, do, **kw)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"K5b {name}: a second launch gave other bits")
    T = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    bhsd = flash_attention_bwd_kernel(*map(T, (q, k, v, o)), lse, T(do), causal=causal,
                                      window=window, layout="bhsd")
    check(all(bool(torch.equal(a.transpose(1, 2), b)) for a, b in zip(bhsd, got)),
          f"K5b {name}: the two layouts gave other bits")
    del again, bhsd
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else ATOL
    errs = [compare_rel(torch, a, b, f"K5b {name} d{n}", tol)
            for n, a, b in zip("qkv", got, want)]
    i = torch.arange(Sq, device=DEVICE)[:, None] + (Skv - Sq)
    t = torch.arange(Skv, device=DEVICE)[None, :]
    seen = ((t <= i) if causal else torch.ones_like(t > i)) & ((t > i - window) if window else True)
    unseen = ~seen.any(0)
    check(not bool(got[1][:, unseen].any()) and not bool(got[2][:, unseen].any()),
          f"K5b {name}: keys no row sees got nonzero dk or dv")
    cases.append({"kernel": "K5b", "case": name, "Sq": Sq, "Skv": Skv, "H": H, "Hk": Hk,
                  "D": D, "causal": causal, "window": window, "dtype": str(dtype),
                  "max_abs_err": max(e[0] for e in errs),
                  "max_rel_err": max(e[1] for e in errs), "keys_unseen": int(unseen.sum())})


def lm_kernels_phase(torch):
    """K5 and K6 against their plain versions on the card at the slice's
    shapes (B = 4, S = 4,096, bfloat16: K5 for hymba, 25 over 5 heads, D 64,
    window 1024, and qwen3, 16 over 8, D 128, causal; K6 for hymba, H 50, P
    64, N 16, and mamba2, H 48, N 128, one group), a second launch held
    bitwise to the first, times by CUDA events (kernel, plain version, and
    SDPA for K5) and device time per call by ``torch.profiler``, each beside
    its bound (K5: its share of the bound and TFLOP/s); then degenerate
    inputs: Sq != Skv, S = 1, S not a multiple of the tile or the chunk, a
    window >= S, non-causal, float32 (the CUDA-core kernel), bfloat16 (the
    tensor-core kernel) at D = 8, 48, 96 and 120, offsets and windows that
    are not multiples of a tile, one query over 4,096 keys; K6's shapes and
    cases, and K6b's at the training shapes, in ``k6_kernels``."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel

    gen = torch.Generator().manual_seed(15)
    results, cases = {}, []
    with torch.no_grad():
        for label, B, S, H, Hk, D, causal, window in K5_SHAPES:
            q, k, v = flash_inputs(torch, gen, B, H, Hk, S, S, D, torch.bfloat16)
            got = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                         layout="bshd")
            want = _flash_plain(q, k, v, causal, window)
            err = compare(torch, got, want, f"K5 {label}", BF16_TOL)
            again = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                           layout="bshd")
            check(bool(torch.equal(again, got)), f"K5 {label}: a second launch "
                                                 f"gave other bits")
            del want, again
            sdpa = _sdpa(torch, q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal, window)
            lib_diff = float((sdpa().transpose(1, 2).float() - got.float()).abs().max())
            bound, by, nbytes, flops = flash_bound(B, H, Hk, S, S, D, causal, window, 2)
            kern = lambda: flash_attention_kernel(q, k, v, causal=causal,  # noqa: E731
                                                  window=window, layout="bshd")
            plain = lambda: _flash_plain(q, k, v, causal, window)  # noqa: E731
            rb, bwd = k5b_check(torch, gen, q, k, v, causal, window, label)
            us = grouped_device_us(torch, {"kern": kern, "plain": plain, "sdpa": sdpa,
                                           **bwd}, n=2)
            b_bound, b_by, b_bytes, b_flops = flash_bwd_bound(B, H, Hk, S, S, D, causal,
                                                              window, 2)
            rb = results[f"K5b_{label}"] = dict(
                B=B, S=S, H=H, Hk=Hk, D=D, causal=causal, window=window,
                dtype="bfloat16", **rb, ms=time_ms(torch, bwd["bwd"], 5, 3),
                plain_ms=time_ms(torch, bwd["bwd_plain"], 1, 3),
                library_ms=time_ms(torch, bwd["bwd_sdpa"], 5, 3),
                library="SDPA forward + backward", device_us=us["bwd"],
                plain_device_us=us["bwd_plain"], library_device_us=us["bwd_sdpa"],
                library_bwd_only_ms=time_ms(torch, bwd["bwd_sdpa_only"], 5, 3),
                library_bwd_only_device_us=us["bwd_sdpa_only"],
                bound_ms=b_bound, bound_by=b_by, bytes=b_bytes, flops=b_flops)
            rb["bound_share"] = b_bound / rb["ms"]
            rb["tflops"] = b_flops / rb["ms"] / 1e9
            rb["device_us_cuda_events_idle_stream"] = 1e3 * rb["ms"]
            del bwd
            r = results[f"K5_{label}"] = dict(
                B=B, S=S, H=H, Hk=Hk, D=D, causal=causal, window=window,
                dtype="bfloat16", max_abs_err=err, rerun_bitwise_equal=True,
                ms=time_ms(torch, kern, 10, 3), plain_ms=time_ms(torch, plain, 1, 3),
                library_ms=time_ms(torch, sdpa, 10, 3),
                device_us=us["kern"], plain_device_us=us["plain"],
                library_device_us=us["sdpa"],
                library_max_abs_diff=lib_diff, bound_ms=bound, bound_by=by,
                bytes=nbytes, flops=flops)
            r["bound_share"] = bound / r["ms"]
            r["tflops"] = flops / r["ms"] / 1e9
            # The CUDA-event time of back-to-back calls on the otherwise
            # idle stream, beside the profiler's reading, under its own name.
            r["device_us_cuda_events_idle_stream"] = 1e3 * r["ms"]
            del q, k, v, got
            torch.cuda.empty_cache()

        def k5_case(name, B, H, Hk, Sq, Skv, D, causal, window, dtype, tol):
            q, k, v = flash_inputs(torch, gen, B, H, Hk, Sq, Skv, D, dtype)
            got = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                         layout="bshd")
            err = compare(torch, got, _flash_plain(q, k, v, causal, window),
                          f"K5 {name}", tol)
            bhsd = flash_attention_kernel(q.transpose(1, 2).contiguous(),
                                          k.transpose(1, 2).contiguous(),
                                          v.transpose(1, 2).contiguous(),
                                          causal=causal, window=window)
            check(bool(torch.equal(bhsd.transpose(1, 2), got)),
                  f"K5 {name}: the two layouts gave other bits")
            cases.append({"kernel": "K5", "case": name, "Sq": Sq, "Skv": Skv,
                          "D": D, "causal": causal, "window": window,
                          "dtype": str(dtype), "max_abs_err": err})

        bf, f32 = torch.bfloat16, torch.float32
        k5_case("chunked_decode", 1, 2, 1, 32, 96, 32, True, 0, f32, ATOL)
        k5_case("sq100_skv4096_window", 2, 25, 5, 100, 4096, 64, True, 1024, bf, BF16_TOL)
        k5_case("s1", 2, 16, 8, 1, 1, 128, True, 0, bf, BF16_TOL)
        k5_case("s1000_unaligned", 2, 25, 5, 1000, 1000, 64, True, 1024, bf, BF16_TOL)
        k5_case("window_ge_s", 2, 25, 5, 1000, 1000, 64, True, 2048, bf, BF16_TOL)
        k5_case("window_no_causal", 1, 4, 2, 300, 300, 64, False, 64, bf, BF16_TOL)
        k5_case("bidirectional", 2, 4, 2, 200, 200, 32, False, 0, f32, ATOL)
        k5_case("f32_hymba", 1, 25, 5, 2048, 2048, 64, True, 1024, f32, ATOL)
        k5_case("f32_qwen3", 1, 16, 8, 1024, 1024, 128, True, 0, f32, ATOL)
        k5_case("d8", 1, 4, 4, 130, 130, 8, True, 0, f32, ATOL)
        k5_case("d120", 1, 6, 2, 130, 130, 120, True, 40, f32, ATOL)
        # bfloat16 on the tensor cores: D not 64 or 128 (96 natively, phi3's;
        # 48 natively in the D <= 64 instance; 8 and 120 zero-padded to 16
        # and 128), offsets and windows that are not multiples of a tile,
        # one row, one query over a long cache, non-causal.
        k5_case("bf16_d96", 1, 32, 32, 300, 300, 96, True, 0, bf, BF16_TOL)
        k5_case("bf16_d48", 2, 4, 2, 200, 200, 48, True, 0, bf, BF16_TOL)
        k5_case("bf16_d8", 1, 4, 4, 130, 130, 8, True, 0, bf, BF16_TOL)
        k5_case("bf16_d120", 1, 6, 2, 130, 130, 120, True, 40, bf, BF16_TOL)
        k5_case("bf16_offset37", 2, 8, 2, 300, 337, 64, True, 0, bf, BF16_TOL)
        k5_case("bf16_window77", 2, 25, 5, 700, 700, 64, True, 77, bf, BF16_TOL)
        k5_case("bf16_s1_window", 2, 25, 5, 1, 1, 64, True, 1024, bf, BF16_TOL)
        k5_case("bf16_sq1_skv4096", 4, 16, 8, 1, 4096, 128, True, 0, bf, BF16_TOL)
        k5_case("bf16_s1000_d128", 1, 16, 8, 1000, 1000, 128, True, 0, bf, BF16_TOL)
        k5_case("bf16_bidirectional", 2, 4, 2, 200, 263, 32, False, 0, bf, BF16_TOL)
        for case in K5B_CASES:
            k5b_case(torch, gen, cases, *case[:-1], getattr(torch, case[-1]))

    k6, k6_cases = k6_kernels(torch, gen)
    results.update(k6)
    cases += k6_cases
    # K5b's bf16 kernels as ptxas built them in this run: every instance
    # reported, none spilling or serializing its wgmma (null when the
    # library was built before this run)
    rep = results["ptxas_k5b"] = ptxas_report(BUILD_LOGS, K5B_KERNELS, "flash_attention_bwd")
    if rep is not None:
        want = {"fa_bwd_stats_kernel"} | {f"{k}<{d}>" for k in K5B_KERNELS[1:]
                                          for d in (64, 128)}
        check(set(rep) == want, f"K5b ptxas report: kernels {sorted(rep)}, want {sorted(want)}")
        for name, r in rep.items():
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0
                  and not r["wgmma_serialized"], f"K5b {name}: ptxas spills or serializes ({r})")
    # K6b's chunk-pass instances, its reverse pass and its float32 kernel
    # likewise (no spill, no serialized wgmma, none missing)
    rep = results["ptxas_k6b"] = ptxas_report(
        BUILD_LOGS, ("ssd_bwd_chunk_kernel", "ssd_bwd_f32_kernel", "ssd_state_rpass_kernel"),
        "ssd_chunk_bwd")
    if rep is not None:
        want = {"ssd_bwd_chunk_kernel<16, true, true>", "ssd_bwd_chunk_kernel<128, true, false>",
                "ssd_bwd_chunk_kernel<128, false, true>", "ssd_bwd_f32_kernel",
                "ssd_state_rpass_kernel"}
        check(set(rep) == want, f"K6b ptxas report: kernels {sorted(rep)}, want {sorted(want)}")
        for name, r in rep.items():
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0
                  and not r["wgmma_serialized"], f"K6b {name}: ptxas spills or serializes ({r})")
    return results, cases


K6_PASSES = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_chunk_out_kernel")


def k6_pass_us(by_name: dict, label: str) -> dict:
    """Device µs per call of K6's three passes, keyed by kernel name, from
    ``device_us_per_call(by_kernel=True)``'s profiler names (demangled,
    with template and argument lists). Fails on a device kernel that is no
    pass of K6, or on two kernels under one pass; empty when the profiler
    recorded nothing (not measured)."""
    out, seen = {}, {}
    for name, us in by_name.items():
        hit = [k for k in K6_PASSES if k in name]
        check(len(hit) == 1, f"K6 {label}: device kernel {name!r} is no pass of K6")
        check(hit[0] not in seen, f"K6 {label}: {name!r} and {seen.get(hit[0])!r} "
              f"are both {hit[0]}")
        seen[hit[0]] = name
        out[hit[0]] = us
    return out


def k6_kernels(torch, gen):
    """K6 against its plain version (``ssd_chunk_ref``) on the card: at the
    main shapes (hymba, H 50, P 64, N 16, and mamba2, H 48, N 128, one
    group, B = 4 x S = 4,096; hymba's 32k prefill, B = 1) y to BF16_TOL and
    the final state to SSD_TOL of its largest entry, a second launch
    bitwise, times by CUDA events and the profiler (also per pass) beside
    the bound and its share, the scratch's bytes (measured and planned),
    at mamba2's shape y and the state also against the recurrence
    (``ssd_ref``); then cases: S = 1, 33, 129 and 4,095 (chunks of 128 cut
    short), zero-dt rows at the end, steep decay (dt x
    10: the inclusive sum of dt a passes -88 within a chunk) in bfloat16
    and float32, groups (two at N 128 in bfloat16), P and N not multiples
    of 16 (element loads), float32 on the CUDA-core kernel. At the two
    training shapes (K6B_LABELS) also K6b (``k6b_check``), its device time
    read in the same profiler window as K6's; then K6b's cases
    (``k6b_case``)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_kernel, ssd_chunk_ref, ssd_ref
    from repro_torch.kernels.ssd_chunk.kernel import CHUNK, chunk_plan

    results, cases = {}, []
    with torch.no_grad():
        for label, B, S, H, G, P, N in K6_SHAPES:
            x, dt, a, bm, cm = ssd_inputs(torch, gen, B, S, H, G, P, N, torch.bfloat16)
            y, st = ssd_chunk_kernel(x, dt, a, bm, cm)
            wy, wst = ssd_chunk_ref(x, dt, a, bm, cm)
            err = compare(torch, y, wy, f"K6 {label} y", BF16_TOL)
            serr = compare_rel(torch, st, wst, f"K6 {label} state", SSD_TOL)
            y2, st2 = ssd_chunk_kernel(x, dt, a, bm, cm)
            check(bool(torch.equal(y2, y)) and bool(torch.equal(st2, st)),
                  f"K6 {label}: a second launch gave other bits")
            bound, by, nbytes, flops = ssd_bound(B, S, H, G, P, N, 2)
            kern = lambda: ssd_chunk_kernel(x, dt, a, bm, cm)  # noqa: E731
            plain = lambda: ssd_chunk_ref(x, dt, a, bm, cm)  # noqa: E731
            fns = {"kern": kern, "plain": plain}
            if label in K6B_LABELS:  # K6b at this training shape, one window
                rb, bfns = k6b_check(torch, gen, label, B, S, H, G, P, N)
                fns.update(bfns)
            us = grouped_device_us(torch, fns, n=3, by_kernel=True)
            by_pass = k6_pass_us(us["kern"], label)
            plain_us = sum(us["plain"].values()) if us["plain"] else None
            if label in K6B_LABELS:
                bpass = k6b_pass_us(us["bwd"], label)
                work = k6b_pass_work(B, S, H, G, P, N)
                rb.update(device_us=sum(bpass.values()) if bpass else None,
                          device_us_by_pass=bpass,
                          rates_by_pass=k6b_rates(bpass, work),
                          work_by_pass={k: dict(operations=v[0], bytes=v[1])
                                        for k, v in work.items()},
                          plain_device_us=sum(us["bwd_plain"].values()) if us["bwd_plain"]
                          else None)
                if bpass:
                    check(set(bpass) <= set(K6B_OWN), f"K6b {label}: a call ran "
                          f"{sorted(bpass)}, not only K6b's own passes")
                results[f"K6b_{label}"] = rb
            del fns, us
            r = results[f"K6_{label}"] = dict(
                B=B, S=S, H=H, G=G, P=P, N=N, dtype="bfloat16", max_abs_err=err,
                state_max_abs_err=serr[0], state_rel_err=serr[1],
                rerun_bitwise_equal=True,
                ms=time_ms(torch, kern, 5, 3), plain_ms=time_ms(torch, plain, 1, 3),
                library_ms=None,
                device_us=sum(by_pass.values()) if by_pass else None,
                plain_device_us=plain_us,
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
            r["device_us_cuda_events_idle_stream"] = 1e3 * r["ms"]
            r["bound_share"] = bound / r["ms"]
            r["device_us_by_pass"] = by_pass
            # The float32 chunk states and decays: written by the first
            # pass, read and overwritten by the second, read by the third.
            # Measured: the rise of the allocator's peak over one call, less
            # the outputs; planned: ``chunk_plan``'s shapes.
            plan = chunk_plan(B, S, H, G, P, N)
            r["scratch_bytes_planned"] = 4 * (math.prod(plan["scratch"])
                                              + math.prod(plan["decay"]))
            del y2, st2
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            y2, st2 = kern()
            torch.cuda.synchronize()
            r["scratch_bytes"] = (torch.cuda.max_memory_allocated() - m0
                                  - y2.numel() * y2.element_size()
                                  - st2.numel() * st2.element_size())
            check(r["scratch_bytes"] >= r["scratch_bytes_planned"],
                  f"K6 {label}: a call allocated {r['scratch_bytes']} bytes of "
                  f"scratch, less than its plan's {r['scratch_bytes_planned']}")
            r["scratch_traffic_ms"] = 4 * r["scratch_bytes_planned"] / PEAK_BYTES * 1e3
            if label == "mamba2":  # the kernel against the recurrence
                ry, rst = [], []
                for b in range(B):
                    heads = lambda t: t[b].expand(S, H, N)  # noqa: E731
                    wyb, wsb = ssd_ref(x[b], dt[b], a, heads(bm), heads(cm))
                    ry.append(wyb)
                    rst.append(wsb)
                r["recurrence_max_abs_err"] = compare(
                    torch, y, torch.stack(ry), f"K6 {label} y vs the recurrence", BF16_TOL)
                r["recurrence_state_rel_err"] = compare_rel(
                    torch, st, torch.stack(rst), f"K6 {label} state vs the recurrence",
                    SSD_TOL)[1]
                del ry, rst
            del x, dt, a, bm, cm, y, st, wy, wst, y2, st2
            torch.cuda.empty_cache()

        def k6_case(name, B, S, H, G, P, N, dtype, tol, zero_tail=0, dt_scale=1.0):
            x, dt, a, bm, cm = ssd_inputs(torch, gen, B, S, H, G, P, N, dtype,
                                          dt_scale=dt_scale)
            if zero_tail:
                dt[:, S - zero_tail:] = 0.0
            y, st = ssd_chunk_kernel(x, dt, a, bm, cm)
            wy, wst = ssd_chunk_ref(x, dt, a, bm, cm)
            err = compare(torch, y, wy, f"K6 {name} y", tol)
            serr = compare_rel(torch, st, wst, f"K6 {name} state", SSD_TOL)
            if zero_tail:  # the state after step S - 1 - zero_tail
                _, st_cut = ssd_chunk_kernel(*(t[:, :S - zero_tail]
                                               for t in (x, dt)), a,
                                             bm[:, :S - zero_tail], cm[:, :S - zero_tail])
                compare_rel(torch, st, st_cut, f"K6 {name} zero-dt tail", SSD_TOL)
            # the lowest inclusive sum of dt a within a chunk
            cum = torch.cumsum((dt * a)[:, :min(S, CHUNK)], dim=1)
            cases.append({"kernel": "K6", "case": name, "S": S, "H": H, "G": G,
                          "P": P, "N": N, "dtype": str(dtype), "max_abs_err": err,
                          "state_rel_err": serr[1], "min_cum": float(cum.min())})
            return cum

        bf, f32 = torch.bfloat16, torch.float32
        k6_case("s1", 2, 1, 50, 1, 64, 16, bf, BF16_TOL)
        k6_case("s33_unaligned", 2, 33, 48, 1, 64, 128, bf, BF16_TOL)
        k6_case("zero_dt_tail", 2, 200, 50, 1, 64, 16, bf, BF16_TOL, zero_tail=37)
        k6_case("f32_hymba", 2, 1000, 50, 1, 64, 16, f32, ATOL)
        k6_case("f32_mamba2", 1, 1000, 48, 1, 64, 128, f32, ATOL)
        k6_case("two_groups", 2, 300, 8, 2, 32, 64, f32, ATOL)
        k6_case("p16_n32", 1, 77, 3, 3, 16, 32, f32, ATOL)
        k6_case("s129", 2, 129, 50, 1, 64, 16, bf, BF16_TOL)
        k6_case("s4095_mamba2", 1, 4095, 48, 1, 64, 128, bf, BF16_TOL)
        for name, dtype, tol in (("steep_decay", bf, BF16_TOL),
                                 ("f32_steep_decay", f32, ATOL)):
            cum = k6_case(name, 2, 300, 50, 1, 64, 16, dtype, tol, dt_scale=10.0)
            check(float(cum.min()) < -88.0, f"K6 {name}: the decay is not steep")
        k6_case("steep_decay_n128", 1, 300, 48, 1, 64, 128, bf, BF16_TOL, dt_scale=10.0)
        k6_case("two_groups_n128", 2, 500, 48, 2, 64, 128, bf, BF16_TOL)
        k6_case("bf16_two_groups_n64", 2, 300, 8, 2, 32, 64, bf, BF16_TOL)
        k6_case("bf16_p36_n20", 1, 200, 6, 3, 36, 20, bf, BF16_TOL)
        k6_case("bf16_g3_zero_tail", 1, 260, 6, 3, 16, 32, bf, BF16_TOL, zero_tail=5)
        for case in K6B_CASES:
            k6b_case(torch, gen, cases, *case)
    return results, cases


def k6b_pass(name: str):
    """K6b's pass of a device kernel by its profiler name: ``states`` and
    ``cotan`` (pass 1 with x and B, and with dy and C), the chunk pass's
    instances by K6B_CHUNK, else the kernel's entry of K6B_KERNELS; None for
    a kernel of no pass."""
    if K6B_KERNELS[0] in name:
        return "cotan" if "true" in name else "states"
    if "ssd_bwd_chunk_kernel" in name:
        hit = [v for k, v in K6B_CHUNK.items() if f"{k}>" in name]
        return hit[0] if len(hit) == 1 else None
    hit = [k for k in K6B_KERNELS[1:] if k in name]
    return hit[0] if len(hit) == 1 else None


def k6b_pass_work(B, S, H, G, P, N) -> dict:
    """{pass: (operations, bytes)} of one bfloat16 K6b call at these sizes,
    the rates' numerators: the useful operations of each pass's products
    (at the state's width N16, not the 64 columns the chunk pass's wgmma
    issues where N16 < 64; pass 1's product once, not its two bf16 terms;
    dy x^T in each kernel that forms it), and the bytes of each tensor a
    pass reads or writes, once."""
    from repro_torch.kernels.ssd_chunk.kernel import bwd_plan

    nc, Q, P16, N16 = -(-S // 128), 128, -(-P // 16) * 16, -(-N // 16) * 16
    PN, heads, rows = P16 * N16, B * nc * H, B * S
    blk = 2 * 64 * 64  # one 64 x 64 block, one column of K
    state = 4 * heads * PN
    per_head_in = 2 * rows * H * P
    bc = 2 * 2 * rows * G * N
    table = 4 * heads * (2 * Q + 32)
    images = 2 * 2 * heads * PN
    parts = 2 * 4 * bwd_plan(B, S, H, G, P, N)["head_tiles"] * rows * G * N
    pass1 = 2 * Q * P16 * N16 * heads
    # per head: V2, C B^T, dy x^T, W^T dy and C s_in^T (dx); dy x^T, R^T C,
    # (e dt x) g, R B and (exp(cum) dy) s_in (dB / dC)
    dx_ops = heads * (2 * blk * N16 + 3 * blk * N16 + 3 * blk * 64 + 3 * blk * 64
                      + 2 * blk * N16)
    dbc_ops = heads * (3 * blk * 64 + 3 * blk * N16 + 2 * blk * N16 + 3 * blk * N16
                       + 2 * blk * N16)
    dx_bytes = 2 * per_head_in + bc + images + table + per_head_in + 4 * rows * H + 4 * heads
    dbc_bytes = 2 * per_head_in + bc + images + table + parts
    out = {"cotan": (pass1, per_head_in + bc // 2 + 4 * rows * H + state + table),
           "ssd_state_rpass_kernel": (2 * heads * PN, 2 * state + 4 * heads + images),
           "ssd_bwd_sum_kernel": (0, parts + bc + 4 * heads + 4 * H)}
    if N16 <= 16:
        out["chunk"] = (dx_ops + dbc_ops - heads * 3 * blk * 64, dx_bytes + parts)
    else:
        out["chunk_dx"], out["chunk_dbc"] = (dx_ops, dx_bytes), (dbc_ops, dbc_bytes)
    return out


def k6b_rates(us_by_pass: dict, work: dict) -> dict:
    """{pass: {"tflops": achieved operations / device time, "gbps": bytes /
    device time}} of the passes with a device time."""
    return {k: {"tflops": work[k][0] / us / 1e6, "gbps": work[k][1] / us / 1e3}
            for k, us in us_by_pass.items() if us and k in work}


def k6b_pass_us(by_name: dict, label: str) -> dict:
    """Device µs per call of K6b's launches by pass (``k6b_pass``), from a
    by-kernel profiler reading of K6b's calls. Fails on a kernel of no pass
    or on two kernels under one pass; empty when the profiler recorded
    nothing."""
    out = {}
    for name, us in by_name.items():
        key = k6b_pass(name)
        check(key is not None, f"K6b {label}: device kernel {name!r} is no pass of K6b")
        check(key not in out, f"K6b {label}: two device kernels under {key}")
        out[key] = us
    return out


def _k6b_inputs(torch, gen, B, S, H, G, P, N, dtype, dt_scale=1.0, zero_tail=0,
                with_state=False):
    """K6's inputs (``ssd_inputs``: views of one tensor, as the model's), dy
    ~ N(0, 1) in their dtype and, ``with_state``, a float32 N(0, 1)
    cotangent of the final state."""
    x, dt, a, bm, cm = ssd_inputs(torch, gen, B, S, H, G, P, N, dtype, dt_scale=dt_scale)
    if zero_tail:
        dt[:, S - zero_tail:] = 0.0
    dy = torch.randn((B, S, H, P), generator=gen).to(DEVICE, dtype)
    ds = torch.randn((B, H, P, N), generator=gen).to(DEVICE) if with_state else None
    return (x, dt, a, bm, cm), dy, ds


def k6b_check(torch, gen, label, B, S, H, G, P, N):
    """K6b at a training shape (B = 4, S = 4,096, bfloat16), as a train step
    calls it: on K6's kept chunk states (``ssd_chunk_kernel(...,
    keep=True)``; their hi + lo terms against ``ssd_chunk_states_ref`` to
    SSD_TOL of the largest entry); dx, ddt, da, dB and dC against
    ``ssd_chunk_bwd_ref``
    on the same inputs and against autograd of the float32 plain forward
    (``ssd_chunk_ref``), each within BF16_TOL of the gradient's largest
    entry; a second launch bitwise; times by CUDA events, the plain
    backward's (autograd of the plain forward, its backward alone),
    the bound and its share, the scratch's bytes (the allocator's rise over
    a call less the outputs, and ``bwd_plan``'s). Returns its numbers and
    the callables (``bwd``, ``bwd_plain``) whose device µs the caller reads in K6's profiler window
    (``k6b_pass_us`` by pass)."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_kernel, ssd_chunk_bwd_ref,
                                               ssd_chunk_kernel, ssd_chunk_ref,
                                               ssd_chunk_states_ref)
    from repro_torch.kernels.ssd_chunk.kernel import bwd_plan

    args, dy, _ = _k6b_inputs(torch, gen, B, S, H, G, P, N, torch.bfloat16)
    names = ("dx", "ddt", "da", "dB", "dC")
    _, _, kept = ssd_chunk_kernel(*args, keep=True)
    # the [8 x hi | 8 x lo] groups of K6's split states, as hi + lo
    split = kept[0].view(*kept[0].shape[:-1], -1, 8).view(torch.bfloat16).float()
    s_in = (split[..., :8] + split[..., 8:]).reshape(kept[0].shape)[..., :P, :N]
    ws, wd = ssd_chunk_states_ref(*args)
    kept_err = compare_rel(torch, s_in, ws, f"K6 {label} kept states", SSD_TOL)[1]
    compare(torch, kept[1], wd, f"K6 {label} kept decays", ATOL)  # elementwise: many are ~0
    del split, s_in, ws, wd
    got = ssd_chunk_bwd_kernel(*args, dy, kept=kept)
    again = ssd_chunk_bwd_kernel(*args, dy, kept=kept)
    check(all(bool(torch.equal(p, q)) for p, q in zip(got, again)),
          f"K6b {label}: a second launch gave other bits")
    del again
    want = ssd_chunk_bwd_ref(*args, dy)
    errs = {n: compare_rel(torch, g, w, f"K6b {label} {n}", BF16_TOL)
            for n, g, w in zip(names, got, want)}
    del want
    with torch.enable_grad():  # the phase runs under no_grad
        leaves = [t.float().requires_grad_() for t in args]
        y, _ = ssd_chunk_ref(*leaves)
        auto = torch.autograd.grad(y, leaves, dy.float())
    errs_auto = {n: compare_rel(torch, g, w, f"K6b {label} {n} (autograd)", BF16_TOL)
                 for n, g, w in zip(names, got, auto)}
    del auto, y, leaves
    torch.cuda.empty_cache()
    with torch.enable_grad():  # one saved plain forward: its backward alone
        leaves = [t.detach().requires_grad_() for t in args]
        saved, _ = ssd_chunk_ref(*leaves)

    def plain():
        return torch.autograd.grad(saved, leaves, dy, retain_graph=True)

    kern = lambda: ssd_chunk_bwd_kernel(*args, dy, kept=kept)  # noqa: E731
    bound, by, nbytes, flops = ssd_bwd_bound(B, S, H, G, P, N, 2)
    r = dict(B=B, S=S, H=H, G=G, P=P, N=N, dtype="bfloat16",
             max_abs_err=max(e[0] for e in errs.values()),
             rel_err={n: e[1] for n, e in errs.items()},
             rel_err_vs_autograd={n: e[1] for n, e in errs_auto.items()},
             kept_states_rel_err=kept_err,
             rerun_bitwise_equal=True, ms=time_ms(torch, kern, 5, 3),
             plain_ms=time_ms(torch, plain, 1, 3), library_ms=None,
             bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
             launches_per_call=len(bwd_plan(B, S, H, G, P, N)["grids"]))
    r["bound_share"] = bound / r["ms"]
    r["device_us_cuda_events_idle_stream"] = 1e3 * r["ms"]
    r["scratch_bytes_planned"] = bwd_plan(B, S, H, G, P, N)["scratch_bytes"]
    outs = sum(t.numel() * t.element_size() for t in got)
    del got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    got = kern()
    torch.cuda.synchronize()
    r["scratch_bytes"] = torch.cuda.max_memory_allocated() - m0 - outs
    check(r["scratch_bytes"] >= r["scratch_bytes_planned"],
          f"K6b {label}: a call allocated {r['scratch_bytes']} bytes of scratch, less "
          f"than its plan's {r['scratch_bytes_planned']}")
    del got
    return r, {"bwd": kern, "bwd_plain": plain}


# K6b's degenerate cases (name, B, S, H, G, P, N, dtype, dt_scale, zero_tail,
# final-state cotangent): one step, S not a multiple of the chunk, two
# groups, P 48 and N 24, P 40 and N 20 (element loads), steep decay (dt x 10:
# the inclusive sum of dt a passes -88 within a chunk), zero-dt rows, a
# final-state cotangent, and float32 (the CUDA-core kernel, chunks of 32).
K6B_CASES = (("s1", 2, 1, 48, 1, 64, 128, "bfloat16", 1.0, 0, False),
             ("s300_g2_p48_n24_state", 2, 300, 8, 2, 48, 24, "bfloat16", 1.0, 0, True),
             ("p40_n20_element_loads", 1, 200, 6, 3, 40, 20, "bfloat16", 1.0, 0, False),
             ("steep_decay", 2, 300, 50, 1, 64, 16, "bfloat16", 10.0, 0, False),
             ("steep_decay_n128", 1, 300, 48, 1, 64, 128, "bfloat16", 10.0, 0, True),
             ("zero_dt_tail_state", 2, 300, 50, 1, 64, 16, "bfloat16", 1.0, 37, True),
             ("g2_n128_s500_state", 1, 500, 48, 2, 64, 128, "bfloat16", 1.0, 0, True),
             ("f32_g2_state", 2, 300, 8, 2, 64, 16, "float32", 1.0, 5, True),
             ("f32_n128", 1, 200, 6, 1, 64, 128, "float32", 1.0, 0, False),
             ("f32_steep_p48_n24", 1, 300, 8, 1, 48, 24, "float32", 10.0, 0, False))


def k6b_case(torch, gen, cases, name, B, S, H, G, P, N, dtype, dt_scale, zero_tail,
             with_state):
    """K6b on one degenerate input against ``ssd_chunk_bwd_ref`` (BF16_TOL of
    each gradient's largest entry, ATOL in float32), in bfloat16 on the
    chunk states K6 kept (``ssd_chunk_kernel(..., keep=True)``, as a train
    step calls it); a second launch and the call on contiguous copies of
    the views (and K6's states of those) bitwise; steep cases must reach a
    chunk sum below -88; appended to ``cases``."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_kernel, ssd_chunk_bwd_ref,
                                               ssd_chunk_kernel)
    from repro_torch.kernels.ssd_chunk.kernel import CHUNK, CHUNK_F32

    dtype = getattr(torch, dtype)
    args, dy, ds = _k6b_inputs(torch, gen, B, S, H, G, P, N, dtype, dt_scale, zero_tail,
                               with_state)
    kept = ssd_chunk_kernel(*args, keep=True)[2]
    check((kept is None) == (dtype != torch.bfloat16), f"K6b {name}: K6 kept {kept is None}")
    got = ssd_chunk_bwd_kernel(*args, dy, ds, kept=kept)
    again = ssd_chunk_bwd_kernel(*args, dy, ds, kept=kept)
    flat = [t.contiguous() for t in args]
    copies = ssd_chunk_bwd_kernel(*flat, dy, ds,
                                  kept=ssd_chunk_kernel(*flat, keep=True)[2])
    check(all(bool(torch.equal(p, q)) for p, q in zip(got, again)),
          f"K6b {name}: a second launch gave other bits")
    check(all(bool(torch.equal(p, q)) for p, q in zip(got, copies)),
          f"K6b {name}: contiguous copies of the views gave other bits")
    chunk = CHUNK if dtype == torch.bfloat16 else CHUNK_F32
    want = ssd_chunk_bwd_ref(*args, dy, ds, chunk=chunk)
    tol = BF16_TOL if dtype == torch.bfloat16 else ATOL
    errs = [compare_rel(torch, g, w, f"K6b {name} {n}", tol)
            for n, g, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want)]
    x, dt, a = args[:3]
    cum = torch.cumsum((dt * a)[:, :min(S, chunk)], dim=1)
    if dt_scale > 1:
        check(float(cum.min()) < -88.0, f"K6b {name}: the decay is not steep")
    cases.append({"kernel": "K6b", "case": name, "B": B, "S": S, "H": H, "G": G, "P": P,
                  "N": N, "dtype": str(dtype), "final_state_cotangent": with_state,
                  "zero_dt_tail": zero_tail, "max_abs_err": max(e[0] for e in errs),
                  "max_rel_err": max(e[1] for e in errs), "min_cum": float(cum.min())})


def _capture(torch, store):
    """Wrap the model's K5 and K6 entry points (``fa_ops.flash_attention``,
    ``ssd_ops.ssd_chunk_scan``) so that every call keeps its inputs and
    output in ``store``; returns the undo function. The wrappers call the
    kernels as before (the launch counts are the kernels' own)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops

    fa, ssd = fa_ops.flash_attention, ssd_ops.ssd_chunk_scan

    def fa_tap(q, k, v, **kw):
        out = fa(q, k, v, **kw)
        store.append(("K5", (q, k, v), kw, out))
        return out

    def ssd_tap(*args, **kw):
        out = ssd(*args, **kw)
        store.append(("K6", args, kw, out))
        return out

    fa_ops.flash_attention, ssd_ops.ssd_chunk_scan = fa_tap, ssd_tap

    def undo():
        fa_ops.flash_attention, ssd_ops.ssd_chunk_scan = fa, ssd
    return undo


def _lm_launches():
    from repro_torch.kernels.flash_attention import LAUNCHES as FA
    from repro_torch.kernels.ssd_chunk import LAUNCHES as SSD

    return {"flash_attention": FA["flash_attention"],
            "flash_attention_bwd": FA["flash_attention_bwd"], "ssd_chunk": SSD["ssd_chunk"],
            "ssd_chunk_bwd": SSD["ssd_chunk_bwd"]}


def _lm_reset():
    from repro_torch.kernels.flash_attention import reset_launches as fa_reset
    from repro_torch.kernels.ssd_chunk import reset_launches as ssd_reset

    fa_reset()
    ssd_reset()


def _layer_checks(torch, store, f32=False):
    """Each captured K5 / K6 call's output against the plain version on the
    same inputs (BF16_TOL, or ATOL for float32; K6's state to SSD_TOL of its
    largest entry); returns the largest errors."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_ref

    out = {"K5": [], "K6": []}
    tol = ATOL if f32 else BF16_TOL
    for layer, (kind, args, kw, got) in enumerate(store):
        if kind == "K5":
            want = _flash_plain(*args, kw["causal"], kw["window"])
            out["K5"].append(compare(torch, got, want, f"K5 call {layer}", tol))
        else:
            wy, wst = ssd_chunk_ref(*args)
            out["K6"].append(compare_rel(torch, got[0], wy, f"K6 call {layer} y",
                                         tol)[0] if f32 else
                             compare(torch, got[0], wy, f"K6 call {layer} y", tol))
            compare_rel(torch, got[1], wst, f"K6 call {layer} state", SSD_TOL)
    return {k: max(v) if v else None for k, v in out.items()}


def _cache_diff(torch, a, b, prefix=""):
    """[largest |a - b|, that over the largest |b|] per cache leaf of the
    kernel path's cache ``a`` against the plain path's ``b``; the integer
    leaves (``idx``, ``slot_pos``) must be equal."""
    out = {}
    for k in a:
        if isinstance(a[k], dict):
            out.update(_cache_diff(torch, a[k], b[k], f"{prefix}/{k}"))
        elif a[k].dtype in (torch.int32, torch.int64):
            check(bool(torch.equal(a[k], b[k])), f"cache {prefix}/{k}: int leaves differ")
            out[f"{prefix}/{k}"] = [0.0, 0.0]
        else:
            err = float((a[k].float() - b[k].float()).abs().max())
            scale = float(b[k].float().abs().max())
            out[f"{prefix}/{k}"] = [err, err / scale if scale > 0 else err]
    return out


def layer_parity(torch, M, params, cfg, prompt, max_len, tol):
    """Each decoder layer, kernel path (``mode="auto"``) against plain path
    (``mode="ref"``) on the same input, the kernel path's own residual
    stream: the layer's output and every cache leaf it fills, each held by
    its largest error over its largest entry to ``tol``. Returns the
    largest relative error of the outputs and of the cache leaves."""
    tokens = prompt["tokens"]
    B, S = tokens.shape
    x = M._embed_tokens(params, cfg, tokens)
    pos = torch.arange(S, device=tokens.device)
    ck, cr = M.init_cache(cfg, B, max_len, DEVICE), M.init_cache(cfg, B, max_len, DEVICE)
    worst_x, worst_c = 0.0, 0.0
    for i in range(cfg.num_layers):
        lp = M._layer(params["blocks"], i)
        xk = M.prefill_layer(lp, cfg, x, M._layer(ck, i), pos, mode="auto")
        xr = M.prefill_layer(lp, cfg, x, M._layer(cr, i), pos, mode="ref")
        worst_x = max(worst_x, compare_rel(torch, xk, xr, f"{cfg.name} layer {i}", tol)[1])
        for name, (err, rel) in _cache_diff(torch, M._layer(ck, i), M._layer(cr, i)).items():
            check(rel <= tol, f"{cfg.name} layer {i} cache {name}: error {err:.3e}, "
                              f"{rel:.3e} of the largest entry (limit {tol})")
            worst_c = max(worst_c, rel)
        x = xk
    return worst_x, worst_c


def lm_model_run(torch, arch, *, tokens, new_tokens, tol, f32_layers=0,
                 profile=False):
    """One config on the card. The kernel-path prefill (the main path: K5
    and K6 counted, each call captured and held against the plain version
    on its own inputs), then the same prefill timed without capture, and
    the plain one: each once cold (the first run after emptying the
    allocator's cache), then PREFILL_RUNS warm runs each in turns
    (medians), each run with its cudaMalloc calls, allocator retries,
    garbage collections and CPU seconds. The
    random-init models are chaotic in depth (a 1e-7 change of the
    parameters moves hymba's logits by O(1) within 16 layers), so the
    prefill is held layer by layer (``layer_parity``, ``tol``) and the
    whole-depth plain prefill (``mode="ref"``) is compared and reported;
    ``f32_layers`` > 0 (the float32 variant at that depth, too shallow to
    part) holds the whole prefill's logits to ``tol`` and its caches to
    LM_F32_CACHE_TOL. Then
    ``new_tokens`` teacher-forced decode steps from both caches (the same
    plain code on both; their logits part as the caches do, amplified by
    the depth): logits compared and reported, greedy tokens equal wherever
    the plain path's top-2 margin exceeds twice that step's largest
    difference."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as M

    cfg = get_arch(arch)
    if f32_layers:
        cfg = dataclasses.replace(cfg, num_layers=f32_layers,
                                  param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S = tokens.shape[0], tokens.shape[1] - new_tokens
    prompt = {"tokens": tokens[:, :S]}
    max_len = S + new_tokens + 1
    res = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.compute_dtype,
           "B": B, "S": S, "params": sum(t.numel() for t in _flat(params).values()),
           "init_seconds": init_s}

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        store = []
        undo = _capture(torch, store)
        try:
            torch.cuda.synchronize()
            _lm_reset()
            lk, ck = M.prefill(params, cfg, prompt, max_len=max_len, mode="auto")
            torch.cuda.synchronize()
            res["launches"] = _lm_launches()
        finally:
            undo()
        res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        res["call_max_abs_err"] = _layer_checks(torch, store, f32=bool(f32_layers))
        del store
        torch.cuda.empty_cache()
        want = {"hybrid": (cfg.num_layers, cfg.num_layers), "dense": (cfg.num_layers, 0),
                "ssm": (0, cfg.num_layers)}[cfg.family]
        check((res["launches"]["flash_attention"], res["launches"]["ssd_chunk"]) == want
              and res["launches"]["flash_attention_bwd"] == 0
              and res["launches"]["ssd_chunk_bwd"] == 0,
              f"{cfg.name} prefill: launches {res['launches']}, expected K5/K6 {want}")
        check(bool(torch.isfinite(lk.float()).all()), f"{cfg.name}: non-finite logits")

        def timed(mode):
            """One prefill on the host's clock, with what may stall it: the
            allocator's cudaMalloc calls and retries (a retry frees the
            cache and synchronizes), Python's garbage collections and the
            process's CPU seconds."""
            torch.cuda.synchronize()
            m0, gc0 = torch.cuda.memory_stats(), sum(g["collections"] for g in gc.get_stats())
            cpu, t = time.process_time(), time.perf_counter()
            out = M.prefill(params, cfg, prompt, max_len=max_len, mode=mode)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            m1 = torch.cuda.memory_stats()
            return out, {"seconds": sec, "cpu_seconds": time.process_time() - cpu,
                         "cuda_mallocs": (m1.get("segment.all.allocated", 0)
                                          - m0.get("segment.all.allocated", 0)),
                         "alloc_retries": (m1.get("num_alloc_retries", 0)
                                           - m0.get("num_alloc_retries", 0)),
                         "gc_collections": sum(g["collections"] for g in gc.get_stats()) - gc0}

        # Each path once cold (its first run after emptying the allocator's
        # cache, reported apart), then PREFILL_RUNS warm runs per path in
        # turns; the warm medians and every run are reported.
        for mode, key in (("auto", "prefill_cold"), ("ref", "plain_prefill_cold")):
            torch.cuda.empty_cache()
            out, res[key] = timed(mode)
            del out
        runs = {"auto": [], "ref": []}
        for i in range(PREFILL_RUNS):
            for mode in (("auto", "ref") if i % 2 == 0 else ("ref", "auto")):
                out, info = timed(mode)
                runs[mode].append(info)
                if mode == "ref":
                    lr, cr = out
                del out
        res["prefill_warm_runs"] = runs["auto"]
        res["plain_prefill_warm_runs"] = runs["ref"]
        res["prefill_seconds"] = statistics.median(r["seconds"] for r in runs["auto"])
        res["plain_prefill_seconds"] = statistics.median(r["seconds"] for r in runs["ref"])
        res["prefill_tokens_per_s"] = B * S / res["prefill_seconds"]
        if not f32_layers:
            res["layer_rel_err"], res["layer_cache_rel_err"] = layer_parity(
                torch, M, params, cfg, prompt, max_len, tol)
        err = float((lk.float() - lr.float()).abs().max())
        res["prefill_logits_max_abs_err"] = err
        res["logits_scale"] = float(lr.float().abs().max())
        res["prefill_logits_rel_err"] = err / res["logits_scale"]
        res["cache_err"] = diffs = _cache_diff(torch, ck, cr)
        if f32_layers:
            compare_rel(torch, lk, lr, f"{cfg.name} prefill logits", tol)
            worst = max(diffs, key=lambda n: diffs[n][1])
            check(diffs[worst][1] <= LM_F32_CACHE_TOL,
                  f"{cfg.name} prefill cache {worst}: error {diffs[worst]} "
                  f"(limit {LM_F32_CACHE_TOL})")

        step_err, held, equal, step_ms = [], 0, 0, []
        for i in range(new_tokens):
            tok = tokens[:, S + i]
            torch.cuda.synchronize()
            t = time.perf_counter()
            lk, ck = M.decode_step(params, cfg, ck, tok)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t))
            lr, cr = M.decode_step(params, cfg, cr, tok)
            check(bool(torch.isfinite(lk.float()).all()),
                  f"{cfg.name} decode step {i}: non-finite logits")
            diff = (lk.float() - lr.float()).abs().amax(-1)
            step_err.append(float(diff.max()))
            top2 = torch.topk(lr.float(), 2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > 2 * diff
            same = torch.argmax(lk, -1) == torch.argmax(lr, -1)
            check(bool(same[sure].all()), f"{cfg.name} decode step {i}: greedy "
                                          f"tokens differ beyond the margin")
            held += int(sure.sum())
            equal += int(same.sum())
        res.update(decode_steps=new_tokens, decode_logits_max_abs_err=max(step_err),
                   greedy_rows_beyond_margin=held, greedy_rows_equal=equal,
                   greedy_rows=B * new_tokens,
                   decode_ms_per_step=statistics.median(step_ms),
                   decode_tokens_per_s=B * 1e3 / statistics.median(step_ms))
        res["decode_cache_err"] = _cache_diff(torch, ck, cr)
        if profile:
            res["decode_trace"] = decode_trace(torch, M, params, cfg, ck, tokens[:, S])
    del params
    torch.cuda.empty_cache()
    return res


def chaos_control(torch, arch, B: int = 1, S: int = 1024):
    """How far the random-init model's logits part under a tiny change, in
    float32 at full depth: kernel path against plain path, and plain path
    against the plain path from parameters scaled by 1 + 1e-7 (reported,
    not held)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as M
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch(arch), param_dtype="float32",
                              compute_dtype="float32")
    with torch.no_grad():
        params = M.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        tokens = torch.as_tensor(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (B, S)), dtype=torch.int32, device=DEVICE)
        lk, _ = M.prefill(params, cfg, {"tokens": tokens}, mode="auto")
        lr, _ = M.prefill(params, cfg, {"tokens": tokens}, mode="ref")
        params = tree_map(lambda t: t * (1 + 1e-7), params)
        lp, _ = M.prefill(params, cfg, {"tokens": tokens}, mode="ref")
        out = {"arch": cfg.name, "layers": cfg.num_layers, "B": B, "S": S,
               "kernel_vs_plain": float((lk - lr).abs().max()),
               "perturbed_vs_plain": float((lp - lr).abs().max()),
               "logits_scale": float(lr.abs().max())}
    del params
    torch.cuda.empty_cache()
    return out


def decode_trace(torch, M, params, cfg, cache, tok, n: int = 10):
    """``--profile``: ``torch.profiler`` over ``n`` decode steps (after two
    untimed ones): device idle share, device time by kernel name, the
    device ms per step of copy kernels (``direct_copy_kernel``: dtype
    casts and layout copies; the float32 copies of the KV cache were the
    largest of them) and the largest ``aten::copy_`` calls by the shapes
    they copy (device ms per step), which tells the cache's copies from
    the others'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        M.decode_step(params, cfg, cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(n):
            M.decode_step(params, cfg, cache, tok)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(PROFILE_MARGIN_S)
    copy_us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "direct_copy_kernel" in e.name)
    copies = sorted(((str(a.input_shapes), a.device_time_total, a.count)
                     for a in prof.key_averages(group_by_input_shape=True)
                     if a.key == "aten::copy_"), key=lambda c: -c[1])[:6]
    return {"steps": n, **device_window(prof, wall_us),
            "copy_kernels_ms_per_step": copy_us / 1e3 / n,
            "copy_calls_by_shape": [{"shapes": sh, "ms_per_step": us / 1e3 / n,
                                     "calls_per_step": cnt / n}
                                    for sh, us, cnt in copies]}


# Decode attention over a bfloat16 cache at B = 4: hymba's windowed layers
# (a ring of 1,024 slots, all filled; 25 over 5 heads, D 64) and qwen3's
# (the 4,129-slot cache of a 4,096-token prefill and 32 steps, 4,113
# filled; 16 over 8, D 128): (label, H, Hk, D, slots, filled).
DECODE_SHAPES = (("hymba", 25, 5, 64, 1024, 1024),
                 ("qwen3", 16, 8, 128, LM_S + LM_DECODE_STEPS + 1, LM_S + 17))
# The reference's decode tolerance (tests/test_lm_models.py), the CPU
# tests' bound for the decode attentions against JAX.
DECODE_TOL = 3e-4


def decode_attention_check(torch):
    """On the card, ``layers._attend_cache`` (the products of both decode
    attentions: bfloat16 GEMMs with float32 output over views of the cache)
    against the float32-copy form it replaced (the same arithmetic on
    float32 copies of the cache) within DECODE_TOL, elementwise; the memory
    a call allocates beyond its inputs, held below one float32 copy of one
    cache (no such copy is made); times of both."""
    from repro_torch.models.lm import layers as L

    gen = torch.Generator().manual_seed(16)
    out = {}
    with torch.no_grad():
        for label, H, Hk, D, T, filled in DECODE_SHAPES:
            B, G = LM_B, H // Hk
            qg = (torch.randn((B, Hk, G, D), generator=gen) / math.sqrt(D)).to(
                DEVICE, torch.bfloat16)
            kc, vc = (torch.randn((B, T, Hk, D), generator=gen).to(DEVICE, torch.bfloat16)
                      for _ in range(2))
            allow = torch.arange(T, device=DEVICE) < filled

            def helper():
                return L._attend_cache(qg, kc, vc, allow)

            def copy_form():
                s = torch.einsum("bhgd,bthd->bhgt", qg.float(), kc.float())
                p = torch.softmax(torch.where(allow, s, L.NEG_INF), dim=-1)
                return torch.einsum("bhgt,bthd->bhgd", p.to(vc.dtype).float(),
                                    vc.float())

            helper()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = helper()
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            err = compare(torch, got, copy_form(), f"decode attention {label}", DECODE_TOL)
            f32_cache = 4 * kc.numel()
            check(extra < f32_cache, f"decode attention {label}: a call allocated "
                                     f"{extra} bytes; a float32 copy of a cache is {f32_cache}")
            out[label] = dict(B=B, H=H, Hk=Hk, D=D, slots=T, filled=filled,
                              max_abs_err=err, peak_extra_bytes=extra,
                              f32_cache_copy_bytes=f32_cache,
                              ms=time_ms(torch, helper, 20),
                              copy_form_ms=time_ms(torch, copy_form, 20))
            del qg, kc, vc, got
    torch.cuda.empty_cache()
    return out


def lm_phase(torch, profile=False):
    """The LM serving slice at full width and depth on the card: hymba-1.5b
    (bf16, B = 4 x S = 4,096, 32 teacher-forced decode steps; K5 and K6 32
    times each per prefill), its float32 variant at 4 layers (logits within
    LM_F32_TOL), ``launch.serve.main`` (4 x 4,096, 32 new tokens, greedy),
    one kernel-path prefill at B = 1, S = 32,768, then qwen3-0.6b (K5 only)
    and mamba2-780m (K6 only) through the same comparisons."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.configs import get_arch

    out = {"decode_attention": decode_attention_check(torch)}
    for arch in ("hymba-1.5b", "qwen3-0.6b", "mamba2-780m"):
        V = get_arch(arch).vocab_size
        tokens = torch.as_tensor(np.random.default_rng(5).integers(
            0, V, (LM_B, LM_S + LM_DECODE_STEPS)), dtype=torch.int32, device=DEVICE)
        out[arch] = lm_model_run(torch, arch, tokens=tokens,
                                 new_tokens=LM_DECODE_STEPS, tol=LM_LAYER_TOL,
                                 profile=profile and arch == "hymba-1.5b")
        if arch != "hymba-1.5b":
            continue
        out["hymba_f32_4_layers"] = lm_model_run(
            torch, arch, tokens=tokens[:, :LM_S + 4], new_tokens=4,
            tol=LM_F32_TOL, f32_layers=4)

        from repro_torch.launch.serve import main as serve_main

        buf = io.StringIO()
        torch.cuda.synchronize()
        _lm_reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_main(["--arch", arch, "--batch", str(LM_B), "--prompt-len",
                             str(LM_S), "--new-tokens", str(LM_DECODE_STEPS),
                             "--temperature", "0"])
        torch.cuda.synchronize()
        out["serve_main"] = {"rc": rc, "seconds": time.perf_counter() - t0,
                             "launches": _lm_launches(),
                             "stdout": buf.getvalue().splitlines()}
        check(rc == 0 and out["serve_main"]["stdout"][0].startswith(
            f"{arch}: ({LM_B}, {LM_DECODE_STEPS}) tokens"), "launch.serve.main failed")
        check(out["serve_main"]["launches"] == {"flash_attention": 32, "flash_attention_bwd": 0,
                                                "ssd_chunk": 32, "ssd_chunk_bwd": 0},
              f"launch.serve.main: launches {out['serve_main']['launches']}")
        torch.cuda.empty_cache()
        out["hymba_prefill_32k"] = long_prefill(torch, arch)
        out["hymba_f32_chaos_control"] = chaos_control(torch, arch)
    return out


def long_prefill(torch, arch, S: int = 32_768):
    """One kernel-path prefill at B = 1 and the repo's prefill_32k length."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import model as M

    cfg = get_arch(arch)
    with torch.no_grad():
        params = M.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        tokens = torch.as_tensor(np.random.default_rng(6).integers(
            0, cfg.vocab_size, (1, S)), dtype=torch.int32, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _lm_reset()
        t0 = time.perf_counter()
        logits, _ = M.prefill(params, cfg, {"tokens": tokens}, mode="auto")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = _lm_launches()
        check(bool(torch.isfinite(logits.float()).all()), "32k prefill: non-finite logits")
        check(launches == {"flash_attention": 32, "flash_attention_bwd": 0, "ssd_chunk": 32,
                           "ssd_chunk_bwd": 0}, f"32k prefill: launches {launches}")
        peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    return {"B": 1, "S": S, "seconds": sec, "tokens_per_s": S / sec,
            "launches": launches, "peak_memory_gb": peak}


# ----------------------------------------------------------------------
# lm_train: LM training at full width through K5 and K5b
# ----------------------------------------------------------------------
# qwen3-0.6b at full width and depth (bf16 parameters, float32 AdamW
# moments, remat), B = LM_B x S = LM_S synthetic tokens (data/tokens.py),
# AdamW lr 3e-4 and clip 1.0 (the CLI's). LM_TRAIN_STEPS free-running steps
# are timed, then LM_TRAIN_BUSY_STEPS more under the profiler. The model-FLOP
# share of peak (``mfu``) counts 6 x parameters x tokens and, for attention,
# 12 D operations per visible pair, head and layer (the forward's two
# products, the backward's four; the remat recompute not counted), over
# PEAK_BF16_FLOPS. The CLI's ``--reduced`` kill-and-resume uses the
# reference test's flags (tests/test_fault_tolerance.py).
LM_TRAIN_STEPS = 5
LM_TRAIN_BUSY_STEPS = 1
# mamba2-780m and hymba-1.5b at full width and depth, the same way; hymba's
# float32 variant at 2 layers is held whole as qwen3's at 4.
LM_TRAIN_SSM_ARCHS = ("mamba2-780m", "hymba-1.5b")
# The float32 step with an SSD scan (hymba's): its gradients against the
# plain step's within SSM_F32_GRAD_RTOL of each leaf's largest entry. At
# 2 layers, B = 4 x S = 4,096, the plain and the kernel float32 steps part
# from a float64 plain step by up to 3.1e-3 and 3.3e-3 of a leaf's largest
# entry, and from each other by up to 8.1e-4 (scripts/lm_f32_grad_noise.py,
# NVIDIA H100 80GB HBM3,
# 700.00 W): GRAD_RTOL, qwen3's 1e-4, lies below the plain step's own
# float32 noise there.
SSM_F32_GRAD_RTOL = 2e-3
LM_TRAIN_LR = 3e-4
ADAMW_EPS = 1e-8  # AdamWConfig's default, the train steps'
LM_CLI_REDUCED = ["--workload", "lm", "--arch", "qwen3-0.6b", "--reduced", "--steps", "12",
                  "--batch-size", "2", "--seq-len", "16", "--ckpt-every", "4",
                  "--log-every", "4"]
LM_CLI_FULL = ["--workload", "lm", "--arch", "qwen3-0.6b", "--batch-size", str(LM_B),
               "--seq-len", str(LM_S), "--steps", "3", "--ckpt-every", "0", "--log-every", "1"]


def _train_taps(torch, errs):
    """Wrap the kernel path's launches (``fa_ops._FWD``, ``fa_ops._BWD``,
    ``ssd_ops._FWD``, ``ssd_ops._BWD``) so that every attention and SSD call
    of a train step is held on its own inputs against the plain version:
    K5's output (BF16_TOL elementwise, ATOL in float32) and log-sum-exp
    (ATOL), K5b's dq, dk and dv (BF16_TOL of each gradient's largest entry,
    ATOL in float32); K6's output (as K5's) and final state (SSD_TOL of its
    largest entry), K6b's dx, ddt, da, dB and dC (as K5b's; the plain
    versions at the kernels' chunks, 128 in bfloat16 and 32 in float32);
    the largest errors go to ``errs``. The plain versions launch no kernel
    of the port, so the counts stay the kernels'. Returns the undo
    function."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_ref, flash_attention_lse_ref)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_ref, ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.kernel import CHUNK, CHUNK_F32

    fwd, bwd = fa_ops._FWD, fa_ops._BWD
    sfwd, sbwd = ssd_ops._FWD, ssd_ops._BWD

    def chunk_tol(x):
        return (CHUNK, BF16_TOL) if x.dtype == torch.bfloat16 else (CHUNK_F32, ATOL)

    def sfwd_tap(x, dt, a, Bm, Cm, keep=False):
        out = sfwd(x, dt, a, Bm, Cm, keep=keep)
        y, st = out[:2]
        chunk, tol = chunk_tol(x)
        with torch.no_grad():
            wy, wst = ssd_chunk_ref(x, dt, a, Bm, Cm, chunk=chunk)
            errs["K6"].append(compare(torch, y, wy, "train K6 call", tol))
            errs["K6_state"].append(compare_rel(torch, st, wst, "train K6 state", SSD_TOL)[1])
        return out

    def sbwd_tap(x, dt, a, Bm, Cm, dy, dstate, kept=None):
        got = sbwd(x, dt, a, Bm, Cm, dy, dstate, kept=kept)
        chunk, tol = chunk_tol(x)
        with torch.no_grad():
            want = ssd_chunk_bwd_ref(x, dt, a, Bm, Cm, dy, dstate, chunk=chunk)
            errs["K6b"].append(max(
                compare_rel(torch, g, w, f"train K6b call {n}", tol)[1]
                for n, g, w in zip(("dx", "ddt", "da", "dB", "dC"), got, want)))
        return got

    def fwd_tap(q, k, v, **kw):
        out = fwd(q, k, v, **kw)
        if kw.get("return_lse"):
            tol = ATOL if q.dtype == torch.float32 else BF16_TOL
            T = (lambda x: x.transpose(1, 2)) if kw["layout"] == "bshd" else (lambda x: x)
            with torch.no_grad():
                wo, wl = flash_attention_lse_ref(T(q), T(k), T(v), causal=kw["causal"],
                                                 window=kw["window"])
                errs["K5"].append(compare(torch, out[0], T(wo), "train K5 call", tol))
                errs["K5_lse"].append(compare(torch, out[1], wl, "train K5 lse", ATOL))
        return out

    def bwd_tap(q, k, v, o, lse, do, **kw):
        got = bwd(q, k, v, o, lse, do, **kw)
        tol = ATOL if q.dtype == torch.float32 else BF16_TOL
        with torch.no_grad():
            want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            errs["K5b"].append(max(
                compare_rel(torch, a, b, f"train K5b call d{n}", tol)[1]
                for n, a, b in zip("qkv", got, want)))
        return got

    fa_ops._FWD, fa_ops._BWD = fwd_tap, bwd_tap
    ssd_ops._FWD, ssd_ops._BWD = sfwd_tap, sbwd_tap

    def undo():
        fa_ops._FWD, fa_ops._BWD = fwd, bwd
        ssd_ops._FWD, ssd_ops._BWD = sfwd, sbwd
    return undo


def train_launches(cfg) -> dict:
    """The kernel launches one train step of ``cfg`` makes on the kernel
    path: per layer its family's forward kernels (K5 for attention, K6 for
    the SSD scan; twice under remat, whose backward runs the layer's
    forward again) and their backward kernels once (K5b, K6b)."""
    n, fw = cfg.num_layers, 2 if cfg.remat else 1
    attn, ssm = cfg.family in ("dense", "hybrid"), cfg.family in ("ssm", "hybrid")
    return {"flash_attention": fw * n if attn else 0, "flash_attention_bwd": n if attn else 0,
            "ssd_chunk": fw * n if ssm else 0, "ssd_chunk_bwd": n if ssm else 0}


def k6b_step_ms(prof, steps: int) -> dict:
    """K6b's device ms a train step by pass (``k6b_pass_us``'s names) from a
    profiler window over ``steps`` steps. ``states`` and
    ``ssd_state_pass_kernel`` are K6's passes 1 and 2, which only its
    forward launches (twice a layer under remat)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        key = k6b_pass(e.name()) if e.device_type().name == "CUDA" else None
        if key is not None:
            out[key] = out.get(key, 0.0) + e.duration_ns() / 1e6 / steps
    return out


def k6b_step_report(cfg, by_pass: dict) -> dict:
    """K6b's device ms a train step by pass (``k6b_step_ms``), the sum of
    the passes K6b itself launches (K6B_OWN: with K6's states kept, passes
    1-2 are K6's forward's alone), and each own pass's achieved TFLOP/s and
    GB/s per call (``k6b_pass_work`` at the step's SSD shape, over the
    step's K6b calls); empty for a config without K6b or a run without
    device records."""
    calls = train_launches(cfg)["ssd_chunk_bwd"]
    if not calls or not by_pass:
        return {"k6b_device_ms_per_step": by_pass}
    own = {k: v for k, v in by_pass.items() if k in K6B_OWN}
    work = k6b_pass_work(LM_B, LM_S, cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_head_dim,
                         cfg.ssm_state)
    return {"k6b_device_ms_per_step": by_pass,
            "k6b_own_device_ms_per_step": sum(own.values()),
            "k6b_rates_by_pass": k6b_rates({k: 1e3 * v / calls for k, v in own.items()},
                                           work)}


def _leaf_rel(torch, got, want):
    """{leaf index: largest |got - want| over the largest |want|}."""
    return {i: float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-30)
            for i, (g, w) in enumerate(zip(got, want))}


def lm_train_run(torch, cfg, f32: bool, before_timed_steps=None):
    """One config's train steps on the card from seeded random parameters:
    the first step through its family's kernels (K5 and K5b, K6 and K6b, or
    both) with every attention and SSD call held on its own inputs
    (``_train_taps``) and the launches counted (``train_launches``: the
    forward kernels twice a layer under remat, the backward kernels once);
    the same step again from the same state, the same bits (loss,
    grad_norm, every parameter and moment); the
    same step with ``mode="ref"``. ``f32`` (the float32 variant, shallow
    enough not to part): that step held whole, loss within STEP_LOSS_TOL,
    grad_norm and every gradient (read from the first moment, mu = 0.1 g of
    the clipped gradient) within GRAD_RTOL (SSM_F32_GRAD_RTOL with an SSD
    scan) of the largest entry + GRAD_FLOOR,
    and every updated parameter outside the gradient's tolerance band around
    0 (where AdamW's first step may go either way) within 1e-6 of the
    leaf's largest entry (with an SSD scan, beyond what the gradient's
    tolerance moves it through AdamW's eps: the SSD's float32 sums leave
    gradient entries near the band differing by up to 10%, and a leaf that
    starts at zero, hymba's conv_b, is ~lr after the step); else (bf16,
    chaotic in depth) the loss within
    BF16_TOL and the whole-model gradients reported. Then (bf16)
    LM_TRAIN_STEPS timed steps on the stream's next batches and
    LM_TRAIN_BUSY_STEPS under the profiler, after ``before_timed_steps()``
    (where given) has returned."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import synthetic_token_batches
    from repro_torch.models.lm import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.lm_train import init_opt_state, make_train_step
    from repro_torch.tree import tree_leaves

    t_run = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
    opt = init_opt_state(params)
    n_steps = 1 if f32 else 1 + LM_TRAIN_STEPS + LM_TRAIN_BUSY_STEPS
    stream = synthetic_token_batches(cfg.vocab_size, LM_B, LM_S, n_steps, seed=0)
    batches = [{"tokens": torch.as_tensor(t, device=DEVICE),
                "labels": torch.as_tensor(l, device=DEVICE)} for t, l in stream]
    opt_cfg = AdamWConfig(lr=LM_TRAIN_LR)
    step = make_train_step(cfg, opt_cfg, kv_block=1024)
    live = tree_leaves(params) + tree_leaves(opt)
    init = [x.clone() for x in live]

    def restore():
        with torch.no_grad():
            for x, y in zip(live, init):
                x.copy_(y)

    n_layers = cfg.num_layers
    res = {"arch": cfg.name, "layers": n_layers, "dtype": cfg.compute_dtype,
           "remat": cfg.remat, "B": LM_B, "S": LM_S,
           "params": sum(x.numel() for x in tree_leaves(params))}
    errs = {"K5": [], "K5_lse": [], "K5b": [], "K6": [], "K6_state": [], "K6b": []}
    undo = _train_taps(torch, errs)
    try:
        torch.cuda.synchronize()
        _lm_reset()
        _, _, m = step(params, opt, batches[0])
        torch.cuda.synchronize()
        res["launches"] = _lm_launches()
    finally:
        undo()
    want = train_launches(cfg)
    check(res["launches"] == want,
          f"{cfg.name} train step: launches {res['launches']}, expected {want}")
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gnorm),
          f"{cfg.name} train step: loss {loss}, grad_norm {gnorm}")
    check(len(errs["K5b"]) == want["flash_attention_bwd"]
          and len(errs["K6b"]) == want["ssd_chunk_bwd"]
          and len(errs["K6"]) == want["ssd_chunk"],
          f"{cfg.name} train step: calls held {({k: len(v) for k, v in errs.items()})}")
    res.update(loss=loss, grad_norm=gnorm,
               call_errors={k: max(v) for k, v in errs.items() if v},
               calls_held={k: len(v) for k, v in errs.items()})
    first = [x.clone() for x in live]

    restore()
    _, _, m2 = step(params, opt, batches[0])
    torch.cuda.synchronize()
    check(float(m2["loss"]) == loss and float(m2["grad_norm"]) == gnorm
          and all(bool(torch.equal(a, b)) for a, b in zip(live, first)),
          f"{cfg.name} train step: a second run from the same state gave other bits")
    res["repeat_bitwise_equal"] = True

    restore()
    _, _, mr = make_train_step(cfg, opt_cfg, kv_block=1024, mode="ref")(
        params, opt, batches[0])
    torch.cuda.synchronize()
    n_p = len(tree_leaves(params))
    mu = slice(n_p, 2 * n_p)  # the first moments, in the live list's order
    ref = [x.clone() for x in live]
    loss_ref, gnorm_ref = float(mr["loss"]), float(mr["grad_norm"])
    res.update(plain_loss=loss_ref, plain_grad_norm=gnorm_ref,
               loss_rel_err=abs(loss - loss_ref) / abs(loss_ref),
               grad_norm_rel_err=abs(gnorm - gnorm_ref) / gnorm_ref,
               grad_rel_err=max(_leaf_rel(torch, first[mu], ref[mu]).values()),
               param_rel_err=max(_leaf_rel(torch, first[:n_p], ref[:n_p]).values()))
    if f32:
        # with an SSD scan, its float32 noise sets the gradients' tolerance
        ssm = cfg.family in ("ssm", "hybrid")
        grad_rtol = SSM_F32_GRAD_RTOL if ssm else GRAD_RTOL
        res["grad_rtol"] = grad_rtol
        check(res["loss_rel_err"] <= STEP_LOSS_TOL,
              f"{cfg.name}: loss {loss} vs plain {loss_ref}")
        check(res["grad_norm_rel_err"] <= grad_rtol,
              f"{cfg.name}: grad_norm {gnorm} vs plain {gnorm_ref}")
        for i, (g, w) in enumerate(zip(first[mu], ref[mu])):
            err = float((g - w).abs().max())
            tol = grad_rtol * float(w.abs().max()) + 0.1 * GRAD_FLOOR
            check(err <= tol, f"{cfg.name}: gradient leaf {i}: {err:.3e} > {tol:.3e}")
        worst = 0.0
        for g, w, band_of in zip(first[:n_p], ref[:n_p], ref[mu]):
            check(float((g - w).abs().max()) <= 2.01 * LM_TRAIN_LR,
                  f"{cfg.name}: a parameter moved past two steps of the plain one")
            mu_tol = grad_rtol * float(band_of.abs().max()) + 0.1 * GRAD_FLOOR
            band = band_of.abs() <= mu_tol
            dev = (g - w).abs()
            if ssm:
                # what the gradient tolerance, held above, moves a parameter
                # by through AdamW's first step, lr g / (|g| + eps): lr eps
                # tol / ((|g| - tol + eps)(|g| + eps)), g = 10 mu, tol its
                # tolerance; taken off before the parameter is held
                tol_g, g_ref = 10 * mu_tol, 10 * band_of.abs()
                prop = (1.01 * LM_TRAIN_LR * ADAMW_EPS * tol_g
                        / ((g_ref - tol_g).clamp_min(0) + ADAMW_EPS) / (g_ref + ADAMW_EPS))
                dev = (dev - prop).clamp_min(0)
            err = float(torch.where(band, 0.0, dev).max())
            worst = max(worst, err / float(w.abs().max()))
        check(worst <= 1e-6, f"{cfg.name}: updated parameters {worst:.3e} of the "
                             f"largest entry from the plain step's")
        res["param_rel_err_outside_band"] = worst
    else:
        check(res["loss_rel_err"] <= BF16_TOL,
              f"{cfg.name}: loss {loss} vs plain {loss_ref} (limit {BF16_TOL} relative)")
    del first, ref
    restore()
    torch.cuda.empty_cache()

    if not f32:
        if before_timed_steps is not None:
            before_timed_steps()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for batch in batches[1:1 + LM_TRAIN_STEPS]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, _, mt = step(params, opt, batch)
            losses.append(float(mt["loss"]))  # reads back: the step has ended
            step_s.append(time.perf_counter() - t)
        check(all(math.isfinite(x) for x in losses), f"{cfg.name}: losses {losses}")
        warm = statistics.median(step_s[1:])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            t0 = time.perf_counter()
            for batch in batches[1 + LM_TRAIN_STEPS:]:
                step(params, opt, batch)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
            time.sleep(PROFILE_MARGIN_S)
        busy = device_window(prof, wall_us, sum_of=K5B_KERNELS)
        tokens = LM_B * LM_S
        attn = 12 * cfg.resolved_head_dim * LM_B * cfg.num_heads * n_layers * \
            flash_visible_pairs(LM_S, LM_S, True, cfg.sliding_window)
        res.update(steps=LM_TRAIN_STEPS, losses=losses, step_seconds=step_s,
                   warm_ms_per_step=1e3 * warm, tokens_per_s=tokens / warm,
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   model_flops_per_step=6 * res["params"] * tokens + attn,
                   attention_flops_per_step=attn,
                   mfu=(6 * res["params"] * tokens + attn) / warm / PEAK_BF16_FLOPS,
                   busy=dict(steps=LM_TRAIN_BUSY_STEPS,
                             device_busy_share=(None if busy["device_idle_share"] is None
                                                else 1.0 - busy["device_idle_share"]),
                             **{k: busy[k] for k in ("device_busy_ms", "window_ms",
                                                     "device_ms_by_name")}),
                   k5b_device_ms_per_step={k: v / LM_TRAIN_BUSY_STEPS
                                           for k, v in busy["ms_of"].items()},
                   **k6b_step_report(cfg, k6b_step_ms(prof, LM_TRAIN_BUSY_STEPS)))
    del params, opt, live, init, batches
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_run
    return res


def lm_train_phase(torch):
    """LM training on the card (ROADMAP A6): qwen3-0.6b at full width and
    depth (``lm_train_run``: the held step, its bitwise repeat, the plain
    step, five timed steps and the busy share), its float32 variant at 4
    layers held whole against the plain step; mamba2-780m and hymba-1.5b
    the same way through K6 and K6b (hymba also K5 and K5b), five timed
    steps each, and hymba's float32 variant at 2 layers held whole; and
    ``python -m
    repro_torch.launch.train --workload lm`` on the card: the reduced qwen3
    with the reference test's flags (LM_CLI_REDUCED) run whole and killed at
    step 7 (exit 42), both started with the phase and waited for before the
    timed steps, then resumed: its ``done`` line equal to the uninterrupted
    run's; beside the resumed run one uninterrupted full-width run
    (LM_CLI_FULL: B = 4 x S = 4,096, 3 steps, no checkpoint). Every process
    is ended before returning."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()
    ck = {n: ROOT / "checkpoints" / f"chip_smoke_lm_{n}" for n in ("clean", "crash", "full")}
    for d in ck.values():
        shutil.rmtree(d, ignore_errors=True)

    def done(so):
        return [ln for ln in so.splitlines() if ln.startswith("done")][-1]

    procs, first = [], {}
    try:
        started = _cli_start({
            "clean": LM_CLI_REDUCED + ["--ckpt-dir", str(ck["clean"])],
            "killed": LM_CLI_REDUCED + ["--ckpt-dir", str(ck["crash"]),
                                        "--simulate-failure", "7"]}, procs)

        def wait_first():
            first["runs"], first["seconds"] = _cli_wait(started)

        cfg = get_arch("qwen3-0.6b")
        out = {"qwen3": lm_train_run(torch, cfg, f32=False, before_timed_steps=wait_first),
               "qwen3_f32_4_layers": lm_train_run(torch, dataclasses.replace(
                   cfg, num_layers=4, param_dtype="float32", compute_dtype="float32"),
                   f32=True)}
        for arch in LM_TRAIN_SSM_ARCHS:
            torch.cuda.empty_cache()
            out[arch] = lm_train_run(torch, get_arch(arch), f32=False)
        out["hymba_f32_2_layers"] = lm_train_run(torch, dataclasses.replace(
            get_arch("hymba-1.5b"), num_layers=2, param_dtype="float32",
            compute_dtype="float32"), f32=True)
        runs = first["runs"]
        for name, want in (("clean", 0), ("killed", 42)):
            rc, so, se = runs[name]
            check(rc == want, f"lm CLI {name}: exit {rc}, expected {want}: {se[-1500:]}")
        second, s2 = _cli_round({
            "resumed": LM_CLI_REDUCED + ["--ckpt-dir", str(ck["crash"]), "--resume"],
            "full": LM_CLI_FULL + ["--ckpt-dir", str(ck["full"])]}, procs)
        for name in second:
            rc, so, se = second[name]
            check(rc == 0, f"lm CLI {name}: exit {rc}: {se[-1500:]}")
        resumed_out = second["resumed"][1]
        check("[resume] restored step 4" in resumed_out,
              f"lm CLI resumed: {resumed_out[-1500:]}")
        clean, resumed = done(runs["clean"][1]), done(resumed_out)
        check(clean == resumed, f"lm CLI: resumed {resumed!r} vs uninterrupted {clean!r}")
        full = second["full"][1].splitlines()
        check(len([ln for ln in full if ln.startswith("step ")]) == 3
              and "nan" not in done(second["full"][1]), f"lm CLI full width: {full}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for d in ck.values():
            shutil.rmtree(d, ignore_errors=True)
    out["cli"] = dict(reduced=dict(args=LM_CLI_REDUCED, done_uninterrupted=clean,
                                   done_resumed=resumed, bit_identical=True,
                                   stdout_killed=runs["killed"][1].splitlines()),
                      full_width=dict(args=LM_CLI_FULL, stdout=full),
                      round_seconds=[first["seconds"], s2])
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------------
# multi: the mesh paths, several ranks sharing the one card
# ----------------------------------------------------------------------
# Ranks of one world share cuda:0 over gloo (NCCL refuses two ranks on one
# device); the 1 x 1 mesh runs on a one-rank NCCL group. Parity steps and
# TGN steps of the 2 x 2 mesh. Its epoch is the whole one (552 batches):
# the first 200 alone, tried for the phase's budget, parted from a
# one-device run of the same 200 by up to 1.0e-2 in val MRR, and two
# one-device 200-batch runs by 7.2e-3 (mid-training runs spread wider than
# the train phase's whole-epoch tolerances hold; NVIDIA H100 80GB HBM3,
# 700.00 W).
MULTI_PARITY_STEPS = 20
MULTI_TGN_STEPS = 3


def _multi_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _multi_entry(rank, world, port, backend, task, payload, out):
    """One rank: its process group on the card (``init_distributed`` with
    ``backend`` and ``payload["device"]``), a line naming it, then the task;
    its JSON result goes to ``out``."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = init_distributed(backend, device=payload["device"])
    print(json.dumps({"multi_rank": rank, "backend": dist.get_backend(),
                      "world_size": dist.get_world_size(), "device": str(dev),
                      "task": task}), flush=True)
    try:
        res = MULTI_TASKS[task](torch, dev, payload)
        with open(Path(out) / f"rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _start_world(world: int, backend: str, task: str, payload: dict) -> dict:
    """Spawn ``world`` ranks running ``task`` without waiting for them."""
    import tempfile

    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    ctx = mp.start_processes(_multi_entry, args=(world, _multi_port(), backend,
                                                 task, payload, out),
                             nprocs=world, join=False, start_method="spawn")
    return {"ctx": ctx, "out": out, "world": world, "t0": time.perf_counter(),
            "seconds": None}


def _wait(handles, until=None) -> None:
    """Wait until every world of ``handles`` has ended (or ``until()`` is
    true); a failed rank raises here."""
    while any(h["seconds"] is None for h in handles):
        if until is not None and until():
            return
        for h in handles:
            if h["seconds"] is None and h["ctx"].join(timeout=0.05):
                h["seconds"] = time.perf_counter() - h["t0"]


def _results(h) -> list:
    """An ended world's results by rank, each with the world's seconds."""
    res = []
    for r in range(h["world"]):
        with open(Path(h["out"]) / f"rank{r}.json") as f:
            res.append(dict(json.load(f), world_seconds=h["seconds"]))
    return res


def _sharded(exp, shards=None, data_shards=1, **sampler_kw):
    """``exp`` with its sampler node-sharded (``shards``, the buffer exposed
    to the shard-aware layer) and its train step over ``data_shards``."""
    import dataclasses

    sampler = dataclasses.replace(exp.sampler, shards=shards, **sampler_kw)
    train = dataclasses.replace(exp.train, data_shards=data_shards)
    return dataclasses.replace(exp, sampler=sampler, train=train)


def _block_of(torch, buf, lo, per):
    """This rank's ``(per + 1, K, 3)`` block of a one-device ``(N + 1, K,
    3)`` buffer: its rows, padding rows and its sink empty."""
    n = buf.shape[0] - 1
    block = torch.zeros((per + 1,) + tuple(buf.shape[1:]), dtype=buf.dtype,
                        device=buf.device)
    block[..., 0] = -1
    block[..., 2] = -1
    m = max(min(lo + per, n) - lo, 0)
    block[:m] = buf[lo:lo + m]
    return block


def multi_kernels_task(torch, dev, p):
    """K1 and K2 through ``fused_temporal_layer_sharded`` at the main path's
    shapes (eval S = 4,400 and train S = 600, N = 9,000, K = 10, H = 2, D =
    50), every bias group, on this rank's node block: the output bit-equal
    to the one-device K1 call on the whole buffer and the plain sharded
    version bit-equal to the one-device plain version (each sums one owner
    with exact zeros), kernel against plain within ATOL; the gradients
    against the one-device K2 within the kernels phase's K2 tolerances; the
    sharded call's K1 and K2 launches on this rank, and its ms (the
    all-reduce included) beside the one-device K1's."""
    import repro_torch.kernels.temporal_attention as ta
    from repro_torch.distributed.sharding import (
        axis_group,
        axis_index,
        make_node_mesh,
        node_rows_per_shard,
    )

    mesh = make_node_mesh(p["world"], "nodes")
    group = axis_group(mesh, "nodes")
    per = node_rows_per_shard(N_NODES, p["world"])
    lo = axis_index(mesh, "nodes") * per
    groups = {"time_edge": (D_TIME, D_EDGE), "time": (D_TIME, 0),
              "edge": (0, D_EDGE), "none": (0, 0)}
    out = {}
    for label, S in (("eval", EVAL_S), ("train", TRAIN_S)):
        for gname, (d_time, d_edge) in groups.items():
            gen = torch.Generator().manual_seed(31)
            ops, kw = layer_inputs(torch, gen, S, d_time=d_time, d_edge=d_edge)
            block = _block_of(torch, ops["buf"], lo, per)
            names = ("q", "k_table", "v_table") + tuple(
                k for k in kw if k != "edge_feats")
            leaves = {k: (ops[k] if k in ops else kw[k]).detach().clone()
                      .requires_grad_(True) for k in names}
            args = {**ops, **kw, **leaves}

            def sharded(mode):
                a = dict(args)
                a["buf"] = block
                return ta.fused_temporal_layer_sharded(
                    group=group, rows_per_shard=per, mode=mode, **a)

            ta.reset_launches()
            got = sharded("kernel")
            g = torch.randn(got.shape, generator=gen).to(got.device)
            grads = dict(zip(names, torch.autograd.grad(got, list(leaves.values()), g)))
            torch.cuda.synchronize()
            launched = dict(ta.LAUNCHES)
            check(launched["fused_temporal_layer"] == 1
                  and launched["fused_temporal_layer_bwd"] == 1,
                  f"sharded {label} {gname}: launches {launched}")
            one = ta.fused_temporal_layer_kernel(**ops, **kw)
            check(torch.equal(got, one), f"sharded K1 {label} {gname} is not "
                                         f"bit-equal to the one-device K1")
            plain = sharded("ref").detach()
            one_plain = ta.fused_temporal_layer_ref(**ops, **kw)
            check(torch.equal(plain, one_plain), f"sharded plain {label} {gname} "
                                                 f"is not bit-equal to one device")
            got = got.detach()
            err = compare(torch, got, plain, f"sharded K1 {label} {gname}")
            want = ta.fused_temporal_layer_bwd_kernel(g, **ops, **kw)
            errs = compare_grads(torch, {k: grads[k].reshape(want[k].shape)
                                         for k in want}, want,
                                 f"sharded K2 {label} {gname}")
            rec = {"S": S, "max_abs_err": err, "grad_errors": errs,
                   "launches": launched}
            if gname == "time_edge":
                rec["ms"] = time_ms(torch, lambda: sharded("kernel"), 10, 3)
                rec["one_device_ms"] = time_ms(
                    torch, lambda: ta.fused_temporal_layer_kernel(**ops, **kw), 10, 3)
            out[f"{label}_{gname}"] = rec
    return out


def _eval_sharded(torch, pipe, want_mrr, want_digest, label, kernel, per_batch):
    """``evaluate("val")`` on a sharded pipeline, launch counts zeroed just
    before it and read just after: val MRR and the canonical sampler state
    bit-equal to the one-device run's, ``kernel`` launched ``per_batch``
    times a val batch."""
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    mrr, scored_s = pipe.evaluate("val")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k: v for k, v in LAUNCHES.items() if v}
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    digest = state_digest(hook.state_dict())
    check(launches == {kernel: per_batch * n_val},
          f"{label}: launched {launches} for {n_val} val batches")
    check(mrr == want_mrr, f"{label}: val MRR {mrr!r} vs {want_mrr!r} on one device")
    check(digest == want_digest, f"{label}: the sampler state differs from "
                                 f"the one-device run's")
    return dict(mrr=mrr, scored_seconds=scored_s, evaluate_seconds=wall,
                launches=launches, state_sha256=digest)


def multi_eval_task(torch, dev, p):
    """On the 1 x 2 mesh: the quickstart (1-layer TGAT) and 2-layer TGAT
    over the node-sharded device recency sampler with the buffer exposed
    (K1 shard-aware, hop-2 too), each ``evaluate("val")`` bit-equal to its
    one-device run; then the sharded K1/K2 alone (``multi_kernels_task``)."""
    from repro_torch.data import generate

    data = generate("wikipedia", scale=1.0)
    w = p["world"]
    out = {}
    pipe = _sharded(quickstart(), shards=w, expose_buffer=True).compile(
        data=data, device=dev)
    check(pipe._use_2d and pipe._buf_rows == -(-pipe.cfg.num_nodes // w),
          "quickstart 1x2 mesh")
    out["quickstart_1x2"] = _eval_sharded(torch, pipe, p["quickstart_mrr"],
                                          p["quickstart_state"], "quickstart 1x2",
                                          "fused_temporal_layer", 1)
    del pipe
    pipe = _sharded(tgat2_experiment(True), shards=w, expose_buffer=True).compile(
        data=data, device=dev)
    out["tgat2_1x2"] = _eval_sharded(torch, pipe, p["tgat2_mrr"], p["tgat2_state"],
                                     "tgat2 1x2", "fused_temporal_layer", 3)
    del pipe
    torch.cuda.empty_cache()
    out["kernels"] = multi_kernels_task(torch, dev, p)
    return out


def multi_uniform_task(torch, dev, p):
    """On the 1 x 2 mesh: 2-layer TGAT over the node-sharded device uniform
    sampler under both partitions (K3, the model replicated), each
    ``evaluate("val")`` bit-equal to the one-device run."""
    from repro_torch.data import generate

    data = generate("wikipedia", scale=1.0)
    out = {}
    for partition in ("rows", "degree"):
        pipe = _sharded(uniform_experiment(True), shards=p["world"],
                        partition=partition).compile(data=data, device=dev)
        hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
        check(hook.sampler._mesh is not None and not pipe._use_2d,
              f"uniform {partition}: not node-sharded")
        out[f"uniform_{partition}_1x2"] = _eval_sharded(
            torch, pipe, p["uniform_mrr"], p["uniform_state"],
            f"uniform {partition} 1x2", "temporal_attention", 3)
        out[f"uniform_{partition}_1x2"]["edges_on_rank"] = int(hook.sampler._adj["L"])
        del pipe
    return out


def _full_buffer(torch, pipe, block):
    """The one-device ``(N + 1, K, 3)`` buffer from the node group's blocks
    (one owner per row; the sink row empty)."""
    import torch.distributed as dist

    n, per = pipe.cfg.num_nodes, pipe._buf_rows
    lo = per * dist.get_rank(group=pipe._node_group)
    full = torch.zeros((n + 1,) + tuple(block.shape[1:]), dtype=torch.int32,
                       device=block.device)
    m = max(min(lo + per, n) - lo, 0)
    full[lo:lo + m] = block[:m]
    dist.all_reduce(full, group=pipe._node_group)
    full[n] = torch.tensor([-1, 0, -1], dtype=torch.int32, device=block.device)
    return full


def _grad_report(torch, got, want, worst, stateful):
    """Whole-model gradients against another path's: the worst relative
    error, and whether any leaf is beyond GRAD_RTOL of its largest entry +
    GRAD_FLOOR (reported, as ``step_parity`` reports them); a stateful
    model's GRU gradients held to exact zeros."""
    beyond = False
    for name, gr in _flat(got).items():
        w = want[name]
        if stateful and name.startswith("gru/"):
            check(not bool(gr.any()) and not bool(w.any()),
                  f"GRU gradient {name} is not zero")
        e, scale = float((gr - w).abs().max()), float(w.abs().max())
        beyond |= e > GRAD_RTOL * scale + GRAD_FLOOR
        rel = e / scale if scale else 0.0
        if rel > worst["model_grad_rel"] and e > GRAD_FLOOR:
            worst.update(model_grad_rel=rel, model_grad_name=name)
    worst["steps_with_model_grads_beyond_1e-4"] += int(beyond)


def multi_train_task(torch, dev, p):
    """The 2 x 2 mesh (data 2 x nodes 2): 1-layer TGAT from the train
    phase's initial parameters, the first MULTI_PARITY_STEPS steps held
    against the one-device K1/K2 step on the whole batch (over the
    reassembled buffer) from the same parameters (loss within
    STEP_LOSS_TOL; whole-model gradients reported), then ``train_epoch()``
    from the start (K1 and K2 once a batch on every rank) and val MRR after
    it, within the train phase's free-running tolerances of its one-device
    epoch, with epoch seconds, ms a step and the host time inside
    ``all_reduce``; a checkpoint written for the 1 x 1 restore; then TGN on
    the same mesh, MULTI_TGN_STEPS steps through K1/K2 against
    ``fused="ref"`` from the same parameters and memory."""
    import torch.distributed as dist

    from repro_torch.core import TRAIN_KEY
    from repro_torch.data import generate
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches
    from repro_torch.models.tg.common import bce_link_loss

    data = generate("wikipedia", scale=1.0)
    pipe = _sharded(quickstart({"epochs": 1}), shards=2, data_shards=2,
                    expose_buffer=True).compile(data=data, device=dev)
    check(pipe._use_2d and tuple(pipe._mesh.mesh.shape) == (2, 2), "2x2 mesh")
    init = _tree_clone(pipe.params), _tree_clone(pipe.opt_state)
    B = pipe.batch_size
    worst = {"loss": 0.0, "model_grad_rel": 0.0, "model_grad_name": None,
             "steps_with_model_grads_beyond_1e-4": 0}
    t0 = time.perf_counter()
    pipe.reset_epoch_state()
    with pipe.manager.activate(TRAIN_KEY):
        for i, batch in zip(range(MULTI_PARITY_STEPS), pipe._loader(pipe.train_data)):
            loss, grads, _ = pipe._step_2d(batch)
            whole = {k: batch[k] for k in batch.keys()}
            whole["nbr_buf"] = _full_buffer(torch, pipe, batch["nbr_buf"])
            pos, neg = pipe._model.link_scores(pipe.params, pipe.cfg, whole, B)
            loss_one = bce_link_loss(pos, neg, whole["batch_mask"])
            grads_one = _flat(pipe._grads(loss_one))
            dl = abs(float(loss) - float(loss_one.detach()))
            check(dl <= STEP_LOSS_TOL, f"2x2 step {i}: loss {float(loss)} vs "
                                       f"{float(loss_one.detach())} on one device")
            worst["loss"] = max(worst["loss"], dl)
            _grad_report(torch, grads, grads_one, worst, False)
            pipe._update(grads)
    torch.cuda.synchronize()
    parity = dict(steps=MULTI_PARITY_STEPS, seconds=time.perf_counter() - t0, **worst)

    pipe.load_params(init[0])
    pipe.load_opt_state(init[1])
    n_train = math.ceil(pipe.train_data.num_edge_events / B)
    reduce_s, calls = [0.0], [0]
    all_reduce = dist.all_reduce

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return all_reduce(*a, **kw)
        finally:
            reduce_s[0] += time.perf_counter() - t
            calls[0] += 1

    torch.cuda.synchronize()
    reset_launches()
    dist.all_reduce = timed
    try:
        t = time.perf_counter()
        loss, _ = pipe.train_epoch()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t
    finally:
        dist.all_reduce = all_reduce
    launches = {k: v for k, v in LAUNCHES.items() if v}
    check(launches == {"fused_temporal_layer": n_train,
                       "fused_temporal_layer_bwd": n_train},
          f"2x2 epoch launched {launches} for {n_train} batches")
    if dist.get_rank() == 0:  # the phase starts its 1 x 2 worlds now
        Path(p["epoch_done"]).touch()
    mrr = pipe.evaluate("val")[0]
    check(abs(loss - p["train_loss"]) <= EPOCH_LOSS_TOL,
          f"2x2 epoch loss {loss} vs {p['train_loss']} on one device")
    check(abs(mrr - p["train_mrr"]) <= TRAIN_MRR_TOL,
          f"2x2 val MRR {mrr} vs {p['train_mrr']} on one device")
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    state = state_digest(hook.state_dict())
    pipe.save_checkpoint(p["ckpt"], 1)
    params = _params_digest(pipe.params)
    epoch = dict(loss=loss, val_mrr=mrr, batches=n_train,
                 one_device_loss=p["train_loss"], one_device_val_mrr=p["train_mrr"],
                 loss_diff=abs(loss - p["train_loss"]),
                 mrr_diff=abs(mrr - p["train_mrr"]),
                 epoch_seconds=epoch_s, ms_per_step=1e3 * epoch_s / n_train,
                 all_reduce_seconds=reduce_s[0], all_reduce_calls=calls[0],
                 all_reduce_share=reduce_s[0] / epoch_s, launches=launches,
                 state_sha256=state, params_sha256=params)
    del pipe
    return dict(step_parity=parity, epoch=epoch, tgn=_multi_tgn(torch, dev, data))


def _params_digest(params) -> str:
    """SHA-256 of a parameter tree's float32 bytes, leaf by leaf in key
    order."""
    import hashlib

    h = hashlib.sha256()
    for key, leaf in sorted(_flat(params).items()):
        h.update(key.encode())
        h.update(leaf.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _multi_tgn(torch, dev, data):
    """TGN on the 2 x 2 mesh: MULTI_TGN_STEPS steps, each through K1/K2 and
    with ``fused="ref"`` from the same parameters and memory: loss within
    STEP_LOSS_TOL, the masked-synced memory within ATOL, GRU gradients
    exactly zero, whole-model gradients reported; the kernel step's update
    moves the run on."""
    from repro_torch.core import TRAIN_KEY
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    pipe = _sharded(tgn_experiment(True), shards=2, data_shards=2,
                    expose_buffer=True).compile(data=data, device=dev)
    worst = {"loss": 0.0, "memory": 0.0, "model_grad_rel": 0.0,
             "model_grad_name": None, "steps_with_model_grads_beyond_1e-4": 0}
    pipe.reset_epoch_state()
    reset_launches()
    with pipe.manager.activate(TRAIN_KEY):
        for i, batch in zip(range(MULTI_TGN_STEPS), pipe._loader(pipe.train_data)):
            pipe.fused = None
            loss, grads, state = pipe._step_2d(batch)
            pipe.fused = "ref"
            loss_ref, grads_ref, state_ref = pipe._step_2d(batch)
            pipe.fused = None
            dl = abs(float(loss) - float(loss_ref))
            check(dl <= STEP_LOSS_TOL, f"TGN 2x2 step {i}: loss {float(loss)} vs "
                                       f"{float(loss_ref)} plain")
            dm = float((state["memory"] - state_ref["memory"]).abs().max())
            check(dm <= ATOL, f"TGN 2x2 step {i}: synced memory differs by {dm}")
            check(torch.equal(state["last_update"], state_ref["last_update"]),
                  f"TGN 2x2 step {i}: last_update differs")
            worst["loss"], worst["memory"] = max(worst["loss"], dl), max(worst["memory"], dm)
            _grad_report(torch, grads, _flat(grads_ref), worst, True)
            pipe._update(grads)
            pipe.model_state = state
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    check(launches == {"fused_temporal_layer": MULTI_TGN_STEPS,
                       "fused_temporal_layer_bwd": MULTI_TGN_STEPS},
          f"TGN 2x2 steps launched {launches}")
    return dict(steps=MULTI_TGN_STEPS, launches=launches, **worst)


def multi_restore_task(torch, dev, p):
    """The 1 x 1 mesh on a one-rank NCCL group: the 2 x 2 checkpoint
    restored, its parameters and canonical sampler state bit-equal to what
    the 2 x 2 ranks held, then ``evaluate("val")`` through the shard-aware
    K1 over the 1-rank node group."""
    from repro_torch.data import generate
    from repro_torch.kernels.temporal_attention import LAUNCHES, reset_launches

    data = generate("wikipedia", scale=1.0)
    pipe = _sharded(quickstart({"epochs": 1}), shards=1,
                    expose_buffer=True).compile(data=data, device=dev)
    check(pipe._use_2d and tuple(pipe._mesh.mesh.shape) == (1, 1), "1x1 mesh")
    check(pipe.restore_checkpoint(p["ckpt"]) == 1, "1x1 restore step")
    hook = next(h for h in pipe.manager.hooks() if hasattr(h, "sampler"))
    params, state = _params_digest(pipe.params), state_digest(hook.state_dict())
    check(params == p["params_sha256"], "1x1 restore: parameters differ from 2x2's")
    check(state == p["state_sha256"], "1x1 restore: sampler state differs from 2x2's")
    reset_launches()
    mrr = pipe.evaluate("val")[0]
    n_val = math.ceil(pipe.val_data.num_edge_events / pipe.batch_size)
    check(LAUNCHES["fused_temporal_layer"] == n_val, "1x1 eval launches")
    check(abs(mrr - p["mrr"]) <= MRR_TOL, f"1x1 val MRR {mrr} vs 2x2 {p['mrr']}")
    return dict(params_bit_equal=True, state_bit_equal=True, mrr=mrr,
                mrr_2x2=p["mrr"], launches=dict(LAUNCHES))


MULTI_TASKS = {"eval": multi_eval_task, "uniform": multi_uniform_task,
               "train": multi_train_task, "restore": multi_restore_task}


def multi_phase(torch, sl, tr, t2, zo):
    """The multi-rank paths on the one card (module docstring, item 18):
    4 ranks over gloo (the 2 x 2 steps, epoch, TGN and checkpoint); once
    its epoch is timed, two worlds of 2 ranks over gloo (the 1 x 2 evals
    over the recency sampler, then the sharded K1/K2 alone; over the
    uniform sampler); once it has ended, one NCCL rank (the 1 x 1
    restore). The payloads carry the one-device numbers of the earlier
    phases."""
    import shutil
    import tempfile

    ck_dir = ROOT / "checkpoints" / "chip_smoke_multi"
    shutil.rmtree(ck_dir, ignore_errors=True)
    marks = Path(tempfile.mkdtemp(prefix="chip_smoke_marks_"))
    base = {"device": "cuda:0"}
    out, handles = {}, []
    t0 = time.perf_counter()
    try:
        train = _start_world(4, "gloo", "train", dict(
            base, ckpt=str(ck_dir), train_loss=tr["kernels"]["loss"],
            train_mrr=tr["kernels"]["val_mrr"], epoch_done=str(marks / "epoch")))
        handles.append(train)
        # The 1 x 2 worlds start once the 2 x 2 epoch is timed, beside the
        # rest of that world (its val MRR, checkpoint and TGN steps).
        _wait([train], until=(marks / "epoch").exists)
        handles += [_start_world(2, "gloo", "eval", dict(
            base, world=2, quickstart_mrr=sl["mrr"],
            quickstart_state=sl["state_sha256"],
            tgat2_mrr=t2["device"]["eval"]["mrr"],
            tgat2_state=t2["device"]["eval"]["state_sha256"])),
            _start_world(2, "gloo", "uniform", dict(
                base, world=2, uniform_mrr=zo["uniform"]["device"]["eval"]["mrr"],
                uniform_state=zo["uniform"]["device"]["eval"]["state_sha256"]))]
        _wait([train])
        out["train"] = _results(train)
        ep = out["train"][0]["epoch"]
        check(all(r["epoch"]["params_sha256"] == ep["params_sha256"]
                  and r["epoch"]["state_sha256"] == ep["state_sha256"]
                  for r in out["train"]), "2x2 ranks hold different parameters")
        handles.append(_start_world(1, "nccl", "restore", dict(
            base, ckpt=str(ck_dir), params_sha256=ep["params_sha256"],
            state_sha256=ep["state_sha256"], mrr=ep["val_mrr"])))
        _wait(handles)
        out["eval"], out["uniform"], out["restore"] = map(_results, handles[1:])
        out["kernels"] = [r.pop("kernels") for r in out["eval"]]
    finally:
        for h in handles:
            for proc in h["ctx"].processes:
                if proc.is_alive():
                    proc.terminate()
            shutil.rmtree(h["out"], ignore_errors=True)
        shutil.rmtree(ck_dir, ignore_errors=True)
        shutil.rmtree(marks, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def multi_launches(mu) -> dict:
    """The multi phase's main-path launches by path, summed over ranks."""
    def total(runs, key, name):
        return sum(r[key]["launches"].get(name, 0) for r in runs)

    ev, un, tr, rs = mu["eval"], mu["uniform"], mu["train"], mu["restore"]
    paths = {"fused_temporal_layer": {}, "fused_temporal_layer_bwd": {},
             "temporal_attention": {}, "temporal_attention_bwd": {}}
    for name in paths:
        found = {
            "multi_quickstart_1x2_eval": total(ev, "quickstart_1x2", name),
            "multi_tgat2_1x2_eval": total(ev, "tgat2_1x2", name),
            "multi_uniform_rows_1x2_eval": total(un, "uniform_rows_1x2", name),
            "multi_uniform_degree_1x2_eval": total(un, "uniform_degree_1x2", name),
            "multi_2x2_train": sum(r["epoch"]["launches"].get(name, 0) for r in tr),
            "multi_tgn_2x2_steps": sum(r["tgn"]["launches"].get(name, 0) for r in tr),
            "multi_1x1_eval": sum(r["launches"].get(name, 0) for r in rs),
        }
        paths[name] = {k: v for k, v in found.items() if v}
    return paths


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        smi = nvidia_smi_line()
        emit({"phase": "env", "python": sys.version.split()[0],
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "device_count": torch.cuda.device_count(), "nvidia_smi": smi})

        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        logs = _build.build_all()
        BUILD_LOGS.update(logs)
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": {name: [ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln]
                        for name, log in logs.items()},
              "profiler_clock": profiler_clock(torch)})

        results, cases = kernels_phase(torch)
        k2, k2_cases = k2_phase(torch, torch.Generator().manual_seed(1))
        results.update(k2)
        emit({"phase": "kernels", "tolerance": {"atol": ATOL, "rtol": RTOL,
                                                "time_w_rtol": TIME_W_RTOL},
              "peaks": {"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES},
              "shapes": results, "degenerate": cases,
              "degenerate_bwd": k2_cases})

        sl = slice_phase(torch)
        emit({"phase": "slice", **sl})

        tr = train_phase(torch)
        emit({"phase": "train", "tolerance": {
            "step_loss": STEP_LOSS_TOL, "model_grad_rtol": GRAD_RTOL,
            "model_grad_floor": GRAD_FLOOR, "epoch_loss": EPOCH_LOSS_TOL,
            "val_mrr": TRAIN_MRR_TOL}, **tr})

        from repro_torch.data import generate

        wiki = generate("wikipedia", scale=1.0)
        seg, seg_cases = dtdg_kernels_phase(torch, wiki)
        emit({"phase": "dtdg_kernels", "tolerance": {"atol": ATOL, "rtol": RTOL},
              "peaks": {"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES},
              "shapes": seg, "degenerate": seg_cases})

        dt = dtdg_phase(torch, wiki)
        emit({"phase": "dtdg", "tolerance": {
            "val_mrr": MRR_TOL, "step_loss": DTDG_STEP_LOSS_TOL,
            "model_grad_rtol": GRAD_RTOL, "model_grad_floor": GRAD_FLOOR,
            "epoch_loss": DTDG_EPOCH_LOSS_TOL, "epoch_val_mrr": DTDG_MRR_TOL},
            **dt})

        k3, k3_cases = k3_phase(torch)
        emit({"phase": "classic_kernels", "tolerance": {"atol": ATOL, "rtol": RTOL,
                                                        "bf16": BF16_TOL},
              "peaks": {"f32_flops": PEAK_F32_FLOPS, "bytes_per_s": PEAK_BYTES},
              "shapes": k3, "degenerate": k3_cases})
        ho = host_phase(torch)
        emit({"phase": "host", "tolerance": {"val_mrr": MRR_TOL,
                                             "step_loss": STEP_LOSS_TOL}, **ho})
        tg = tgn_phase(torch, wiki)
        emit({"phase": "tgn", "tolerance": {"val_mrr": MRR_TOL, "memory": ATOL,
                                            "step_loss": STEP_LOSS_TOL}, **tg})
        t2 = tgat2_phase(torch, wiki)
        emit({"phase": "tgat2", "tolerance": {"atol": ATOL, "rtol": RTOL,
                                              "time_w_rtol": TIME_W_RTOL,
                                              "val_mrr": MRR_TOL,
                                              "step_loss": STEP_LOSS_TOL}, **t2})
        torch.cuda.empty_cache()
        zo = zoo_phase(torch, wiki)
        emit({"phase": "zoo", "tolerance": {"val_mrr": MRR_TOL, "step_loss": STEP_LOSS_TOL,
                                            "card_vs_cpu_loss_rel": ZOO_LOSS_RTOL,
                                            "grad_rtol": GRAD_RTOL, "grad_floor": GRAD_FLOOR,
                                            "state": ATOL},
              "nvidia_smi": nvidia_smi_line(), **zo})
        torch.cuda.empty_cache()
        nd = node_phase(torch, wiki)
        emit({"phase": "node", "tolerance": {
            "atol": ATOL, "rtol": RTOL, "ndcg": NDCG_TOL, "near_tie": NEAR_TIE,
            "step_loss": DTDG_STEP_LOSS_TOL, "model_grad_rtol": GRAD_RTOL,
            "model_grad_floor": GRAD_FLOOR, "discretize_sum_rtol": DISC_SUM_RTOL},
            "nvidia_smi": nvidia_smi_line(), **nd})
        torch.cuda.empty_cache()
        so = storage_phase(torch, wiki, tr["kernels"])
        emit({"phase": "storage", "tolerance": {
            "eval_mrr": "bit-equal", "epoch_loss": EPOCH_LOSS_TOL, "epoch_val_mrr": TRAIN_MRR_TOL,
            "card_vs_cpu_loss_rel": ZOO_LOSS_RTOL, "grad_rtol": GRAD_RTOL,
            "grad_floor": GRAD_FLOOR}, "nvidia_smi": nvidia_smi_line(), **so})
        sv = serve_phase(torch, wiki)
        emit({"phase": "serve", "tolerance": {"score_abs": SERVE_TOL,
                                              "embedding_of_largest": SERVE_TOL},
              "nvidia_smi": nvidia_smi_line(), **sv})
        torch.cuda.empty_cache()

        clock = [profiler_clock(torch), profiler_clock(torch, PROFILE_MARGIN_S)]
        lmk, lmk_cases = lm_kernels_phase(torch)
        emit({"phase": "lm_kernels", "tolerance": {"atol": ATOL, "rtol": RTOL,
                                                   "bf16": BF16_TOL, "ssd_state": SSD_TOL},
              "peaks": {"f32_flops": PEAK_F32_FLOPS, "bf16_flops": PEAK_BF16_FLOPS,
                        "bytes_per_s": PEAK_BYTES},
              "profiler_clock": clock, "shapes": lmk, "degenerate": lmk_cases})
        lm = lm_phase(torch, profile="--profile" in sys.argv[1:])
        emit({"phase": "lm", "tolerance": {"bf16_layer": LM_LAYER_TOL,
                                           "f32_model": LM_F32_TOL,
                                           "f32_cache": LM_F32_CACHE_TOL,
                                           "kernel_bf16": BF16_TOL,
                                           "decode_attention": DECODE_TOL}, **lm})
        torch.cuda.empty_cache()
        lt = lm_train_phase(torch)
        emit({"phase": "lm_train", "tolerance": {
            "kernel_bf16": BF16_TOL, "kernel_f32": ATOL, "bf16_step_loss_rel": BF16_TOL,
            "f32_step_loss_rel": STEP_LOSS_TOL, "f32_grad_rtol": GRAD_RTOL,
            "f32_grad_floor": 0.1 * GRAD_FLOOR, "f32_param_rel_outside_band": 1e-6},
            "peaks": {"bf16_flops": PEAK_BF16_FLOPS}, "nvidia_smi": nvidia_smi_line(), **lt})

        torch.cuda.empty_cache()
        mu = multi_phase(torch, sl, tr, t2, zo)
        emit({"phase": "multi", "tolerance": {
            "atol": ATOL, "rtol": RTOL, "time_w_rtol": TIME_W_RTOL,
            "eval_mrr": "bit-equal", "eval_state": "bit-equal",
            "step_loss": STEP_LOSS_TOL, "epoch_loss": EPOCH_LOSS_TOL,
            "epoch_val_mrr": TRAIN_MRR_TOL, "restore": "bit-equal",
            "restore_mrr": MRR_TOL},
            "note": "ranks share one card over gloo: correctness and host "
                    "staging, not multi-GPU scaling",
            "nvidia_smi": nvidia_smi_line(), **mu})

        if "--profile" in sys.argv[1:]:
            pipe, prof = profile_phase(torch)
            emit({"phase": "profile", **prof})
            emit({"phase": "trace", **trace_phase(torch, pipe)})
            emit({"phase": "loader", **loader_phase(torch)})
            emit({"phase": "spread", **spread_phase(torch)})
            pipe, prof = train_profile_phase(torch)
            emit({"phase": "train_profile", **prof})
            emit({"phase": "train_trace", **trace_phase(torch, pipe, train=True)})
            emit({"phase": "dtdg_profile", **dtdg_profile_phase(torch, wiki)})
            emit({"phase": "dtdg_spread", **dtdg_spread_phase(torch, wiki)})
            pipe = dtdg_experiment().compile(data=wiki, device=DEVICE)
            emit({"phase": "dtdg_parity",
                  **dtdg_step_parity(torch, pipe, DTDG_PROFILE_PARITY_STEPS)})
            pipe, prof = profile_phase(torch, quickstart_host())
            emit({"phase": "host_profile", **prof})
            emit({"phase": "host_trace", **trace_phase(torch, pipe)})
            emit({"phase": "host_train_trace", **trace_phase(torch, pipe, train=True)})
            for label, on_device in (("device", True), ("host", False)):
                pipe = tgn_experiment(on_device).compile(data=wiki, device=DEVICE)
                emit({"phase": f"tgn_{label}_train_trace",
                      **trace_phase(torch, pipe, train=True)})
                pipe = tgat2_experiment(on_device).compile(data=wiki, device=DEVICE)
                emit({"phase": f"tgat2_{label}_trace", **trace_phase(torch, pipe)})
                emit({"phase": f"tgat2_{label}_train_trace",
                      **trace_phase(torch, pipe, train=True)})
    except Exception as exc:  # any failed phase: no result line
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1

    k1, k1w, k2 = results["K1_eval"], results["K1w_eval"], results["K2_train"]
    k1t, k1wt, k2e = results["K1_train"], results["K1w_train"], results["K2_eval"]
    k3e, k3t, k3b, k3be = k3["K3_eval"], k3["K3_train"], k3["K3b_train"], k3["K3b_eval"]
    k4 = seg["h_d64"]
    paths = {"eval": sl, "train": tr["kernels"], "host_eval": ho["eval"],
             "host_train": ho["kernels"], "tgn_device_eval": tg["device"]["eval"],
             "tgn_device_train": tg["device"]["kernels"],
             "tgn_host_eval": tg["host"]["eval"], "tgn_host_train": tg["host"]["kernels"],
             "tgat2_device_eval": t2["device"]["eval"],
             "tgat2_device_train": t2["device"]["kernels"],
             "tgat2_host_eval": t2["host"]["eval"], "tgat2_host_train": t2["host"]["kernels"],
             **{f"uniform_{label}_{part}": zo["uniform"][label][key]
                for label in ("host", "device")
                for part, key in (("eval", "eval"), ("train", "kernels"))},
             "node_tgn_eval": nd["tgn"]["eval"], "node_tgn_train": nd["tgn"]["kernels"],
             "storage_eval": so["eval"], "storage_train": so["epoch"]["store"],
             "storage_tgat2_eval": so["tgat2"]["eval"],
             "storage_tgat2_steps": so["tgat2"]["steps"]}
    node_k = nd["kernels"]
    node_seg = {f"node_{name}_{part}": nd[name][key]["launches"]["segment_sum"]
                for name, _ in NODE_SNAPSHOT_MODELS
                for part, key in (("eval", "eval"), ("train", "kernels"))}

    def node_shape(key):
        """The node path's numbers of one kernel at its shape."""
        return {f: node_k[key][f] for f in (
            "S", "K", "H", "D", "E", "G", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "bound_share", "device_us", "library_device_us",
            "bound_share_device") if f in node_k[key]}
    t2k = t2["kernels"]

    def tgat2_shapes(prefix):
        """The 2-layer path's numbers of one kernel, by call form and shape."""
        keys = ("S", "K", "table_rows", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "bound_share", "device_us", "bound_share_device",
                "library_ms", "library_device_us")
        return {k[len(prefix):]: {f: r[f] for f in keys if f in r}
                for k, r in t2k.items() if k.startswith(prefix)}

    by_path = {name: {p: r["launches"][name] for p, r in paths.items()
                      if r["launches"][name]}
               for name in ("fused_temporal_layer", "fused_temporal_layer_bwd",
                            "temporal_attention", "temporal_attention_bwd")}
    for name, extra in multi_launches(mu).items():
        by_path[name].update(extra)
    mk = mu["kernels"][0]
    k5, k6, k5b = lmk["K5_hymba"], lmk["K6_hymba"], lmk["K5b_qwen3"]
    k6b = lmk["K6b_mamba2"]
    lm_runs = {"qwen3_train_step": lt["qwen3"]["launches"],
               "qwen3_f32_4_layers_train_step": lt["qwen3_f32_4_layers"]["launches"],
               "mamba2_train_step": lt["mamba2-780m"]["launches"],
               "hymba_train_step": lt["hymba-1.5b"]["launches"],
               "hymba_f32_2_layers_train_step": lt["hymba_f32_2_layers"]["launches"],
               "hymba_prefill": lm["hymba-1.5b"]["launches"],
               "qwen3_prefill": lm["qwen3-0.6b"]["launches"],
               "mamba2_prefill": lm["mamba2-780m"]["launches"],
               "hymba_f32_prefill": lm["hymba_f32_4_layers"]["launches"],
               "hymba_serve_main": lm["serve_main"]["launches"],
               "hymba_prefill_32k": lm["hymba_prefill_32k"]["launches"]}
    lm_paths = {name: {p: r[name] for p, r in lm_runs.items() if r[name]}
                for name in ("flash_attention", "flash_attention_bwd", "ssd_chunk",
                             "ssd_chunk_bwd")}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "fused_temporal_layer", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K1,
        "launches": sum(by_path["fused_temporal_layer"].values()),
        "launches_by_path": by_path["fused_temporal_layer"],
        "max_abs_err": max(k1["max_abs_err"], k1t["max_abs_err"]), "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None, "shape": "S=4400",
        "device_us": k1["device_us"], "device_us_by_launch": k1["device_us_by_launch"],
        "bound_share": k1["bound_share"], "workspace_bytes": k1["workspace_bytes"],
        "train": {k: k1t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "device_us", "device_us_by_launch",
                                       "bound_share", "workspace_bytes")},
        "tgat2": tgat2_shapes("K1_"),
        "sharded_2_ranks": {label: {k: mk[label][k] for k in (
            "S", "max_abs_err", "ms", "one_device_ms")}
            for label in ("eval_time_edge", "train_time_edge")},
    }, {
        "name": "fused_temporal_layer_bwd", "route": "cuda",
        "source": BWD_SOURCE, "replaces": TPU_K2,
        "launches": sum(by_path["fused_temporal_layer_bwd"].values()),
        "launches_by_path": by_path["fused_temporal_layer_bwd"],
        "max_abs_err": k2["max_abs_err"],
        "max_rel_err": max(e[1] for e in k2["errors"].values()),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None, "shape": "S=600",
        "device_us": k2["device_us"], "device_us_by_launch": k2["device_us_by_launch"],
        "bound_share": k2["bound_share"], "workspace_bytes": k2["workspace_bytes"],
        "eval": {k: k2e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "device_us", "device_us_by_launch",
                                      "bound_share", "workspace_bytes")},
        "tgat2": tgat2_shapes("K2_"),
    }, {
        "name": "temporal_attention", "route": "cuda",
        "source": TA_SOURCE, "replaces": TPU_K3,
        "launches": sum(by_path["temporal_attention"].values()),
        "launches_by_path": by_path["temporal_attention"],
        "max_abs_err": max(k3t["max_abs_err"], k3e["max_abs_err"]),
        "ms": k3e["ms"], "plain_ms": k3e["plain_ms"],
        "bound_ms": k3e["bound_ms"], "bound_by": k3e["bound_by"],
        "library_ms": k3e["library_ms"], "shape": "S=4400 K=10 H=2 D=50",
        "device_us": k3e["device_us"], "library_device_us": k3e["library_device_us"],
        "bound_share": k3e["bound_share"], "bound_share_device": k3e["bound_share_device"],
        "train": {k: k3t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "device_us", "library_device_us",
                                       "bound_share", "bound_share_device")},
        "tgat2": tgat2_shapes("K3_"),
        "node": node_shape("K3"),
    }, {
        "name": "temporal_attention_bwd", "route": "cuda",
        "source": TA_BWD_SOURCE, "replaces": TPU_K3B,
        "launches": sum(by_path["temporal_attention_bwd"].values()),
        "launches_by_path": by_path["temporal_attention_bwd"],
        "max_abs_err": max(k3b["max_abs_err"], k3be["max_abs_err"]),
        "errors": {"train": k3b["errors"], "eval": k3be["errors"]},
        "ms": k3b["ms"], "plain_ms": k3b["plain_ms"],
        "plain_autograd_ms": k3b["plain_autograd_ms"],
        "bound_ms": k3b["bound_ms"], "bound_by": k3b["bound_by"],
        "library_ms": k3b["library_ms"], "library": "SDPA forward + backward",
        "shape": "S=600 K=10 H=2 D=50",
        "device_us": k3b["device_us"], "library_device_us": k3b["library_device_us"],
        "plain_autograd_device_us": k3b["plain_autograd_device_us"],
        "bound_share": k3b["bound_share"], "bound_share_device": k3b["bound_share_device"],
        "eval": {k: k3be[k] for k in ("ms", "plain_ms", "plain_autograd_ms", "bound_ms",
                                       "bound_by", "library_ms", "device_us",
                                       "library_device_us", "bound_share",
                                       "bound_share_device")},
        "tgat2": tgat2_shapes("K3b_"),
        "node": node_shape("K3b"),
    }, {
        "name": "segment_sum", "route": "cuda",
        "source": SEG_SOURCE, "replaces": TPU_K4,
        "launches": (dt["eval"]["launches"] + dt["kernels"]["launches"]
                     + sum(node_seg.values())),
        "launches_by_path": {"dtdg_eval": dt["eval"]["launches"],
                             "dtdg_train": dt["kernels"]["launches"], **node_seg},
        "max_abs_err": max([r["max_abs_err"] for r in seg.values()]
                           + [node_k[k]["max_abs_err"] for k in ("K4_d1", "K4_d32")]),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"], "shape": "E=256 D=64 G=9000",
        "device_us": k4["device_us"], "library_device_us": k4["library_device_us"],
        "daily": {k: seg["d_d64"][k] for k in ("E", "ms", "device_us", "library_ms",
                                               "library_device_us", "bound_ms")},
        "node": {"d1": node_shape("K4_d1"), "d32": node_shape("K4_d32")},
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": FA_SOURCE, "replaces": TPU_K5,
        "launches": lm["hymba-1.5b"]["launches"]["flash_attention"],
        "launches_by_path": lm_paths["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for k, r in lmk.items() if k.startswith("K5")),
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"], "shape": "hymba B=4 S=4096 H=25/5 D=64 window=1024 bf16",
        "device_us": k5["device_us"], "library_device_us": k5["library_device_us"],
        "device_us_cuda_events_idle_stream": k5["device_us_cuda_events_idle_stream"],
        "bound_share": k5["bound_share"],
        "qwen3": {k: lmk["K5_qwen3"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_us",
            "library_device_us", "device_us_cuda_events_idle_stream", "bound_share")},
        "lse_max_abs_err": max(lmk[f"K5b_{a}"]["lse_max_abs_err"] for a in ("hymba", "qwen3")),
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": FA_BWD_SOURCE, "replaces": TPU_K5B,
        "launches": lt["qwen3"]["launches"]["flash_attention_bwd"],
        "launches_by_path": lm_paths["flash_attention_bwd"],
        "max_abs_err": max([r["max_abs_err"] for k, r in lmk.items() if k.startswith("K5b")]
                           + [c["max_abs_err"] for c in lmk_cases if c["kernel"] == "K5b"]),
        "max_rel_err": max(max(r["rel_err"].values()) for k, r in lmk.items()
                           if k.startswith("K5b")),
        "ms": k5b["ms"], "plain_ms": k5b["plain_ms"],
        "bound_ms": k5b["bound_ms"], "bound_by": k5b["bound_by"],
        "library_ms": k5b["library_ms"], "library": "SDPA forward + backward",
        "library_bwd_only_ms": k5b["library_bwd_only_ms"],
        "library_bwd_only_device_us": k5b["library_bwd_only_device_us"],
        "device_ms_per_train_step": lt["qwen3"]["k5b_device_ms_per_step"],
        "ptxas": lmk["ptxas_k5b"],
        "shape": "qwen3 B=4 S=4096 H=16/8 D=128 causal bf16",
        "device_us": k5b["device_us"], "library_device_us": k5b["library_device_us"],
        "plain_device_us": k5b["plain_device_us"],
        "device_us_cuda_events_idle_stream": k5b["device_us_cuda_events_idle_stream"],
        "bound_share": k5b["bound_share"],
        "hymba": {k: lmk["K5b_hymba"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_us",
            "library_device_us", "plain_device_us", "device_us_cuda_events_idle_stream",
            "bound_share", "library_bwd_only_ms", "library_bwd_only_device_us")},
    }, {
        "name": "ssd_chunk", "route": "cuda",
        "source": SSD_SOURCE, "replaces": TPU_K6,
        "launches": lm["hymba-1.5b"]["launches"]["ssd_chunk"],
        "launches_by_path": lm_paths["ssd_chunk"],
        "max_abs_err": max(r["max_abs_err"] for k, r in lmk.items() if k.startswith("K6_")),
        "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None, "shape": "hymba B=4 S=4096 H=50 P=64 N=16 G=1 bf16",
        "device_us": k6["device_us"],
        "device_us_cuda_events_idle_stream": k6["device_us_cuda_events_idle_stream"],
        "bound_share": k6["bound_share"], "scratch_bytes": k6["scratch_bytes"],
        "device_us_by_pass": k6["device_us_by_pass"],
        **{label: {k: lmk[f"K6_{label}"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "device_us",
            "device_us_cuda_events_idle_stream", "bound_share", "scratch_bytes",
            "device_us_by_pass")}
           for label in ("mamba2", "hymba_32k")},
    }, {
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": SSD_BWD_SOURCE, "replaces": TPU_K6B,
        "launches": lt["mamba2-780m"]["launches"]["ssd_chunk_bwd"],
        "launches_by_path": lm_paths["ssd_chunk_bwd"],
        "max_abs_err": max([r["max_abs_err"] for k, r in lmk.items() if k.startswith("K6b_")]
                           + [c["max_abs_err"] for c in lmk_cases if c["kernel"] == "K6b"]),
        "max_rel_err": max(max(r["rel_err"].values()) for k, r in lmk.items()
                           if k.startswith("K6b_")),
        "ms": k6b["ms"], "plain_ms": k6b["plain_ms"],
        "bound_ms": k6b["bound_ms"], "bound_by": k6b["bound_by"],
        "library_ms": None, "shape": "mamba2 B=4 S=4096 H=48 P=64 N=128 G=1 bf16",
        "device_us": k6b["device_us"], "plain_device_us": k6b["plain_device_us"],
        "device_us_cuda_events_idle_stream": k6b["device_us_cuda_events_idle_stream"],
        "bound_share": k6b["bound_share"], "scratch_bytes": k6b["scratch_bytes"],
        "device_us_by_pass": k6b["device_us_by_pass"],
        "rates_by_pass": k6b["rates_by_pass"],
        "device_ms_per_train_step": {a: lt[a]["k6b_device_ms_per_step"]
                                     for a in LM_TRAIN_SSM_ARCHS},
        "own_device_ms_per_train_step": {a: lt[a].get("k6b_own_device_ms_per_step")
                                         for a in LM_TRAIN_SSM_ARCHS},
        "rates_by_pass_in_train_step": {a: lt[a].get("k6b_rates_by_pass")
                                        for a in LM_TRAIN_SSM_ARCHS},
        "ptxas": lmk["ptxas_k6b"],
        "hymba": {k: lmk["K6b_hymba"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "device_us", "plain_device_us",
            "device_us_cuda_events_idle_stream", "bound_share", "scratch_bytes",
            "device_us_by_pass", "rates_by_pass")},
    }], "wrappers_off_main_path": [{
        "name": "fused_recency_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": TPU_K1W,
        "launches": sl["launches"]["fused_recency_attention"],
        "max_abs_err": max(k1w["max_abs_err"], k1wt["max_abs_err"]), "ms": k1w["ms"],
        "plain_ms": k1w["plain_ms"], "bound_ms": k1w["bound_ms"],
        "bound_by": k1w["bound_by"], "library_ms": None, "shape": "S=4400",
        "device_us": k1w["device_us"],
        "train": {k: k1wt[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "device_us", "bound_share")},
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
