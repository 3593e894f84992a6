#!/usr/bin/env python3
"""Smoke run of the PyTorch port of EPIC on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. The card's name and power limit; TF32 off; the CUDA kernels built from
   ``src/repro_torch/kernels/*/csrc``, one ``nvcc`` each, in parallel;
   ``-Xptxas -v`` of each kernel (registers, shared memory, spills: the
   reproject-match kernels, the two flash kernels and the SSD and RWKV6
   kernels must spill nothing) and the tensor-core instructions in
   ``cuobjdump -sass``: ``HGMMA`` on bf16 (the wgmma flash kernel),
   ``IMMA`` on s8 (the int8 product and the fused int8 convolution),
   ``HMMA`` on TF32 (the 3xTF32 flash kernel and the two scans).
2. Each of the kernel's three launches (``reproject_match_pallas``,
   ``reproject_match_pallas_tiled``, ``reproject_match_fused``) against the
   plain PyTorch version on the card, at the main path's shapes and at edge
   cases (N = 1, 7, 13, 25, 193; P = 2, 5, 32; 144x144 and 256x256
   frames): diff and coverage within 1e-5, bbox within 1e-3, the three
   launches bitwise equal to each other and to the plain version in the
   kernel's summation order (``warp_order.py``, bool rows included), the
   fused rows equal to the thresholded scores.
3. Kernel and plain-version times (CUDA graphs of many launches, CUDA
   events) beside the least time the card could take and the launch floor
   (a one-element elementwise launch timed the same way); the three
   launches at a scale shape (512x512 frame, N = 3072, not the main path);
   each wrapper call must be one device launch (``torch.profiler``).
4. EPIC's main path at the default full width (``EPICConfig()``: 128x128
   frames, patch 16, capacity 192, window 32) with seeded random depth and
   HIR networks, 96 synthetic frames ingested in chunks of 8 through
   ``EPICCompressor``: dense on ``"fused"`` (the default), sparse on
   ``"pallas_tiled"`` (``prefilter_k=24, patch_k=16``), dense on
   ``"pallas"``; then dense ``"fused"`` once more with the oracle depth
   track, which loads the match path.  Each run must launch its kernel,
   keep its state on the card, and agree with the same run on ``"ref"``
   (counters exact; a differing decision must be traced to a score within
   1e-5 of its threshold).  One more session of each run under
   ``torch.profiler`` gives its device busy time and device launches per
   processed frame.
5. The flash-attention kernels against their plain version on the card,
   at the main path's shape (q ``(4, 32, 1024, 64)``, kv heads 4, causal)
   in bf16 (wgmma) and float32 (3xTF32), at Zamba2-2.7B's shared attention
   (q ``(4, 32, 1024, 160)``, kv heads 32, causal) in both, and at edge
   shapes (S = 1, 100, 2048; head dims 8, 16, 128, 160; MHA, MQA;
   non-causal); then bf16 on wgmma at head dims 64 and 128, GQA groups 1,
   4 and 8, S = 1, 64, 100, 1024 and 2048, and every (dtype, head dim) of
   the 3xTF32 kernel (float32 at 8-160, bf16 at 8, 16, 32, 160) at GQA
   groups 1 and 4, S = 1, 100 and 1024, each causal and full, in the
   models' layout ((B, S, H, D) seen as (B, H, S, D)), bitwise equal to
   the contiguous layout: within 2e-5 in float32 and 3e-2 in bf16, the
   reference's gates.
6. At the main shape: the bf16 wgmma kernel's time, the float32 3xTF32
   kernel's, and the 3xTF32 kernel's in bf16 at Zamba2-2.7B's shared
   attention, their plain version's and
   ``F.scaled_dot_product_attention``'s (the library yardstick, never
   called by the port), each beside its bound (bf16 at 989 TFLOP/s and
   3.35 TB/s, float32 at 67 TFLOP/s), the 3xTF32 kernel's also beside its
   design's floor on the tensor cores (three TF32 products per float32
   product, one and two for bf16's Q K^T and P V, at 495 TFLOP/s), and in
   TFLOP/s.
7. The EFM answer path at full width: TinyLlama-1.1B (22 layers, d_model
   2048) with seeded random bf16 weights and ``attn_backend="pallas"``
   prefills 4 prompts of 1024 seeded token ids (``jit_prefill``) and
   decodes 32 greedy tokens (``greedy_decode_loop``): 22 flash launches
   per prefill (wgmma in bf16, 3xTF32 in float32).  The same run on ``"ref"``, then both in float32.  In
   float32 the logits agree within 1e-3 and the tokens are equal; in bf16
   the prefill logits agree within 0.5 and a differing token must be
   traced to a top-2 margin within 0.5 in both runs' logits.
8. Where phase 7's bf16 ``"pallas"`` time goes: prefill and decode under
   ``torch.profiler`` (device busy time, idle share, launches, time by
   kernel).
9. The int8 product kernel against its plain version on the card,
   exactly: at the reference test's shapes, the all--128 case at K = 512,
   and the eight products the int8 depth network hands it for one frame;
   then the fused int8 convolution (``qconv_int8_pallas``) bitwise equal
   to its plain version on the eight layers' operands of that frame (both
   recorded from a ``forward_int8`` call) and at edge cases (odd H and W
   at stride 2, K = 27, N = 1 without ReLU, M = 75, K = 300, an all-zero
   input, inputs half a step between two int8 values).
10. Their times (CUDA graph replay between CUDA events): the product
   kernel beside its plain version, ``torch._int_mm``'s on the shapes
   padded to what it takes (the library yardstick, never called by the
   port) and the bound; the 8 fused launches beside their plain version,
   the eager chains they replace (the plain composition around the
   product kernel) and the bound.
11. EPIC's deployment path: ``EPICConfig()`` with phase 4's depth network
   quantised to int8 on a ``depth_training_batch`` and the HIR network,
   96 frames on ``"fused"``: with the fused launch (``matmul_backend=
   "pallas"``, the main path: 8 launches per processed frame, no launch
   of the product kernel) and with the plain version (``"ref"``, exact);
   counters and state of the kernel run bitwise equal to the plain run's;
   frames/s, and the depth stage's device time and device launches per
   processed frame beside the fp32 network's.
12. The four baselines (``fv``, ``sd``, ``td``, ``gc``) and EPIC (phase
   11's int8 run) on the same stream on the card: retained bytes, token
   stream shape, and the energy model's Figure 6 energy and memory ratios
   to FVS (``stream_counters``, ``core/energy.py``).
13. The RWKV6 and Mamba-2 SSD scan kernels against their plain version
   (the chunked form) on the card: at the reference test's shapes (and
   against the sequential oracle there), at the full-width shapes of
   RWKV6-3B (r (4, 40, 1024, 64), chunk 32) and Zamba2-2.7B (x (4, 80,
   1024, 64), N 64, chunk 64) in float32 and bf16, contiguous and in the
   layout the models hand over ((B, T, H, .) seen as (B, H, T, .), read
   through its strides), and on a strong-decay draw (w_log = -exp(2 z)):
   within 2e-4, the reference's gate.
   Both kernels return their output as the (B, H, T, .) view of a
   (B, T, H, .) buffer.
14. Their times at the full-width shapes in the models' layout (CUDA graph
   replay between CUDA events) beside the plain version's and the bound
   (the products the chunked form needs, over the lower triangle, at the
   float32 CUDA-core peak; for both kernels also the function's floor on
   the tensor cores, and the bytes their designs move; for the RWKV6
   kernel its exponentials).  ``scripts/time_port_paths.py`` times a
   parent tree's scan kernels, their prefills and the int8 depth stage
   beside these in one call.
15. The RWKV6 and hybrid answer paths at full width: RWKV6-3B (32 layers,
   d_model 2560) and Zamba2-2.7B (54 Mamba-2 layers, d_model 2560, 9
   shared-attention invocations), seeded random bf16 weights, prefill 4
   prompts of 1024 seeded token ids (``jit_prefill``) on
   ``scan_backend="pallas"`` (one kernel launch per layer: 32 and 54) and
   on ``"chunked"``, then 8 greedy tokens (``greedy_decode_loop``); the
   same in float32 at a cut depth (8 and 12 layers), where logits, greedy
   tokens and the serve state of the two backends agree within 1e-3.  The
   bf16 ``"pallas"`` prefill and decode are profiled as in phase 8, with
   the scan kernels' share of the device time and their device launches
   (three a scan).  Zamba2-2.7B runs once more with its shared attention
   on the flash kernel too (``attn_backend="pallas"``: 9 launches of the
   3xTF32 kernel at head dim 160 a prefill, beside the 54 scans), in bf16
   at full depth (held to the ``"ref"``-attention run by phase 7's bf16
   rule) and in float32 at the cut depth (within 1e-3 of it), and is
   profiled with the flash kernel's share.
16. Multi-stream serving, in a process of its own (``chip_smoke.py
   --serve``, on phase 1's libraries).  (a) The pool's launches at 32
   slots: ``rm_fused``
   and ``rm_scores`` (192 entries a slot, each slot its own 128x128 frame)
   and the fused int8 convolution with one scale per image (the depth
   network's 8 layers), each one launch under ``torch.func.vmap`` and
   every slot bitwise its own launch; times beside the vmapped plain
   version and the bound.  (b) ``StreamServer`` over ``EPICCompressor(
   EPICConfig(prefilter_k=8))`` at published widths, ``ServerConfig(
   capacity=32, chunk_frames=8, k_ladder=(8, 16, 24, 48),
   eviction="lru")``: 24 live streams of 12 chunks, 4 closed and 4
   admitted mid-run, on the oracle depth track with no network (every
   live stream bitwise its solo adaptive session), again with
   ``tiers=(8, 24)`` (bitwise the flat pool), and on the fp32 and int8
   depth tracks with the HIR network (``k_trajectory``, counters and
   integer state equal to the solo sessions, the largest float difference
   within ``SERVE_FLOAT_TOL``: cuDNN may convolve a frame differently at
   batch 32); each run's launches counted from 0 just before its first
   tick to just after its last, one of each kernel a frame of each rung
   group.  (c) Readings beside the card's name and power limit: no host
   sync in a tick's dispatch (sync-debug mode "error"), aggregate
   frames/s, tick latency median and p99, device idle share, peak device
   memory a slot, and device launches per tick-frame at 8 and at 32 live
   streams; held: every recorded tick at either count dispatches the same
   host ops in the same order (one step program, one launch of each
   kernel a frame for all slots; only the host-made slot lists differ in
   length).
17. The wire in front of phase 16's server, in the same process after
   it.  (a) Phase 16's schedule recorded by the port's ``record_streams``
   (EPWF bytes), each stream driven by a ``ResumableSession`` through a
   ``FaultyTransport`` (seeded drops, duplicates, reordering, corruption,
   truncation) and ``Loopback`` into a strict-seq ``IngestServer`` in
   front of a ``StreamServer`` of phase 16's config: on the oracle track
   every live stream bitwise phase 16's direct run, on the int8 depth
   track with HIR integers equal to it and floats within
   ``SERVE_FLOAT_TOL``; a short run (4 streams, 3 chunks) through
   ``serve_unix`` with each tick on another thread bitwise the
   ``Loopback`` run.  (b) Crash and restore: the oracle schedule over a
   Unix socket into a serving process of its own (``chip_smoke.py
   --wire-server``) that checkpoints every 2 ticks through
   ``ServeCheckpointer`` (``AsyncSaver``, with the wire cursors) and is
   killed at tick 7; a fresh process restores the newest complete
   checkpoint (``restore_server(..., with_ingest=True)``), the clients
   RESUME and replay from their windows, and every live stream ends
   bitwise equal to the uninterrupted direct run, with one step program
   a variant.  Launches are counted in each wire run and in the restored
   run from 0 before its first tick to after its last: 1 ``rm_fused`` a
   frame of each rung group and 8 (int8 track) or 0 fused int8 launches.
   (c) The EVU probe (Table 1's setting 1 at ``--quick``'s stream counts):
   seeded 64x64 streams rendered on the card, HIR fine-tuned with
   ``hir.loss_fn`` (300 SGD steps, lr 0.05, batch 64), EPIC's token
   streams (one ``StreamPool`` step a chunk), the benchmark's question
   set, then ``evu.train_eval`` (``EVUConfig(d_model=64, batch=16,
   lr=2e-3, steps=450)``); ``forward``, the gradient and one Adam step
   within 1e-5 of the CPU's.  (d) Readings beside the card's name and
   power limit: wire frames/s, host time of decode and submit a chunk,
   tick latency median and p99 through the wire beside phase 16's direct
   figure, NACKs by reason, checkpoint snapshot time and bytes on disk a
   slot, restore time to the first served tick, EVU train steps/s and
   test accuracy.
18. The rest of the zoo at full width, in the main process after phase
   15 (before 16-17), phase 7's prompts, seeded random bf16 weights drawn
   on the card, each model freed before the next.  (a) DeepSeek-V2-Lite-16B
   (MLA, 64 experts top-6 + 2 shared) on ``attn_backend="chunked"`` and
   ``"ref"`` (MLA has no kernel): prefill and 8 greedy tokens, held by
   phase 7's bf16 rule; readings: the cache bytes a token (MLA against
   decompressed K/V), capacity C and the dropped share of the first MoE
   layer's assignments at the prefill, the decode beside the bytes of
   every parameter; profiled with the expert products' share (a
   ``record_function`` range); float32 at 1 dense + 2 MoE layers,
   capacity factor 8: the absorbed decode at position t after a prefill
   of t tokens within 1e-3 of the forward's logits at t.
   (b) Llama-3.2-Vision-11B with its tanh gates drawn nonzero and a seeded
   (4, 1600, 4096) ``img_embed``: prefill (40 flash launches, wgmma at
   head dim 128, GQA 32/8) and 8 greedy tokens on ``"pallas"`` and
   ``"ref"`` (phase 7's bf16 rule); the Figure-1 chain: phase 11's int8
   EPIC session's ``tokens(state, capacity)`` projected to d_model by a
   seeded matrix and tiled over the batch as ``img_embed``, prefill and 8
   tokens, the cross-KV cache bytes at N and at 1600; profiled with the
   flash kernel's share; float32 at 2 groups (10 self layers, 3xTF32
   flash) within 1e-3 of ``"ref"``.  (c) SeamlessM4T-large-v2 on a seeded
   (4, 512, 1024) ``src_embed``: forward (48 flash launches: 24
   non-causal at S 512, 24 causal at S 1024) on ``"pallas"`` and
   ``"ref"``, the last position's logits within 0.5; prefill (the encoder
   and the cross cache: 24 launches) and 8 greedy tokens from position 0;
   profiled; float32 at 2 + 2 layers within 1e-3.
   18a (the deterministic MoE combine): the DeepSeek-V2-Lite-16B bf16
   ``"chunked"`` prefill runs twice more; the two logits and the first
   MoE layer's routing (gates and expert ids, recorded at ``moe._route``)
   bitwise equal; readings: the prefill in 5 alternating pairs with the
   fixed-order combine and with the ``index_add_`` scatter swapped in
   (beside PR 24's 145-155 ms), whether two scatter prefills agree, and
   each combine alone at the first MoE layer's shapes.
19. Training, in a process of its own (``chip_smoke.py --train``, started
   after phase 18, so its memory readings are its own).  (a)
   TinyLlama-1.1B at full width in bf16 with ``remat=True``, ``"dots"``:
   ``make_train_step`` with ``AdamWConfig()`` and no warmup takes 8 steps
   on one seeded 4 x 1024 batch: the loss finite at every step and lower
   at the end, the parameters moved; one step each with remat off,
   ``"dots"`` and ``"full"`` from the same state: the losses equal, the
   gradient norms within 1%.  Readings beside the card's name and power
   limit: the step time (median after 2 warm steps), tokens/s, peak
   memory of each run, the gradient norm.  (b) float32 at 2 layers and
   full width, batch 2 x 256: loss, gradients and one AdamW step on the
   card held to the same step of the port on the CPU (``TRAIN_TOL``; the
   parameters by the CPU tests' rule, which exempts the elements whose
   gradient is a rounding residue), ``accum=2`` held to ``accum=1``.
   (c) RWKV6, the hybrid, DeepSeek-V3 (MTP on), the VLM (gates drawn
   nonzero) and the encoder-decoder at their smoke configurations in
   float32: one train step on the card held to the CPU.  No kernel
   launches in (a)-(c): training runs the reference's ``"ref"`` and
   ``"chunked"`` forms.  (d) Every kernel wrapper refuses an input that
   requires grad on the card: ``flash_attention_pallas`` with
   ``q.requires_grad``, (b)'s loss on ``attn_backend="pallas"``, the
   RWKV6 and hybrid prefills on ``scan_backend="pallas"`` under grad, the
   int8 convolution and reproject-match: each raises before a launch.
   (e) With cuDNN's switches at PyTorch's defaults (TF32 allowed, set
   inside the phase and restored after), the fp32 depth stage
   (``predict_fullres``) and HIR on the card within 1e-5 of the CPU and
   the gradient of ``depth.loss_fn`` within ``TRAIN_TOL``; beside them,
   as a reading, the same depth stage with ``conv2d_same``'s scope
   lifted.
20. Distribution, in a process of its own (``chip_smoke.py --dist``,
   started after phase 19) on a one-rank NCCL group from an in-process
   store (``launch.mesh.make_host_mesh``, ``make_stream_mesh``).  (a)
   ``jit_train_step`` of TinyLlama-1.1B in bf16 at full width (remat
   ``"dots"``, 4 x 1024 tokens) on the (data 1, model 1) mesh takes 4
   steps from phase 19a's seeded state: its first step held to
   ``make_train_step``'s by ``hold_step`` (``TRAIN_TOL``), and whether
   they are bitwise equal printed; with ``grad_axis="data"`` the gradients
   the step exchanges (recorded at ``ef_int8_allreduce``) equal
   ``decompress(compress(g))`` of ``optim/compress.py`` bitwise, the int8
   payload and scales exactly; readings: the step time (median of steps
   1-3) beside phase 19a's, peak memory.  (b) ``StreamServer`` on the
   stream mesh, 8 slots, 8 live streams x 4 chunks, one closed and one
   admitted, the ladder ``SERVE_LADDER``: on the oracle and int8 depth
   tracks, every stream's state bitwise the ``mesh=None`` run's,
   ``k_trajectory`` equal, ``rm_fused`` and ``qconv_int8`` launches equal;
   then one more chunk queued on every stream, the sharded server saved
   (``serve/checkpoint.save_server``): its step directory byte-equal to
   the ``mesh=None`` server's (the manifest's ``time`` and the scheduler's
   measured costs aside, every npz member), restored into a fresh sharded
   server and ticked, bitwise the uninterrupted runs.
   (c) ``jit_prefill`` and ``jit_decode_step`` of TinyLlama-1.1B bf16 on
   the mesh with ``attn_backend="pallas"``: 4 x 1024 and 8 greedy tokens,
   the logits bitwise ``mesh=None``'s, 22 flash launches a prefill.  (d)
   ``moe_ffn`` with ``moe_impl="ep"`` on the one-rank mesh returns to the
   sort path (``moe_ffn_ep`` gives ``None`` at ``n_ep == 1``): bitwise
   ``moe_ffn_sort``'s output at DeepSeek-V2-Lite-16B's width.  20a also
   reads, for phase 21b, the bytes placing 19a's parameters and moments
   asks the allocator for and one step's peak from them.
21. The dry-run, in a process of its own (``chip_smoke.py --dryrun``,
   started after phase 20; no card: a fake process group takes the
   process's one default group).  (a) ``launch.dryrun.run_cell`` at full
   width on DRYRUN_CELLS (TinyLlama-1.1B train_4k on 16x16, Qwen2.5-3B
   prefill_32k on 16x16, DeepSeek-V3-671B decode_32k on 2x16x16): each
   ``ok``; per-device bytes, peak against 80 GB, flops and collective
   bytes printed.  (b) The dry-run of phase 20a's step on a (1, 1) mesh on
   a fake world of one: its parameters' and moments' bytes held equal to
   the bytes phase 20a's placement asked the caching allocator for
   (``requested_bytes``; the ``memory_allocated`` growth printed beside
   it), its peak printed beside the card's.

It then prints one JSON line ``{"kernels": [...]}`` (flash attention has
three rows: ``flash_attention_pallas``, the bf16 wgmma instance of the
main path, with the launches of phase 7's prefill and phase 18's bf16 VLM
prefill and SeamlessM4T forward; ``flash_attention_pallas/tf32``, the 3xTF32 instance in
float32, with the launches of phase 7's float32 prefill and of phase
18's float32 ``"pallas"`` VLM prefill and SeamlessM4T forward; and
``flash_attention_pallas/tf32_d160``, the same kernel in bf16 at head dim
160, with the launches of phase 15's Zamba2-2.7B prefill; the int8 kernel
two: ``int8_matmul_pallas/qconv``, the fused launch of the int8 main path,
and ``int8_matmul_pallas``, the op's product kernel, held and timed in
phases 9-10 at the main path's product shapes, whose work the fused launch
does on the main path: 0 launches there; and the pool path's two rows,
``reproject_match_fused/slots`` and ``int8_matmul_pallas/qconv/slots``:
phase 16's launches at 32 slots, with the launches of its serving runs
and of phase 17's two wire runs and its restored run),
the card's name and power limit, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_FRAMES = 96
CHUNK = 8
TAU, O_MIN, C_MIN = 0.08, 0.5, 0.6  # EPICConfig() thresholds
SCORE_TOL, BBOX_TOL = 1e-5, 1e-3

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # tensor cores, dense
# Arithmetic per warped pixel in csrc/reproject_match.cu: lift 6, rigid
# transform 18, projection 6, window-local coordinates and floor 6,
# bilinear weights 6, three channels of 4-tap sample and |difference| 30,
# channel mean 1, masked sum 1.
FLOP_PER_PIXEL = 74
FLOP_PER_PAIR = 13  # fused: one (entry, patch) overlap test and its bits

RM_SOURCE = "src/repro_torch/kernels/reproject_match/csrc/reproject_match.cu"
FA_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_wgmma.cu")
FA_TF32_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_tf32.cu")
I8_SOURCE = "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu"
SSD_SOURCE = "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu"
RWKV_SOURCE = "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"
KERNELS = {  # wrapper name -> (the TPU kernel it replaces, its source)
    "reproject_match_pallas":
        ("src/repro/kernels/reproject_match/kernel.py:204", RM_SOURCE),
    "reproject_match_pallas_tiled":
        ("src/repro/kernels/reproject_match/kernel.py:313", RM_SOURCE),
    "reproject_match_fused":
        ("src/repro/kernels/reproject_match/fused.py:121", RM_SOURCE),
    "flash_attention_pallas":
        ("src/repro/kernels/flash_attention/kernel.py:99", FA_SOURCE),
    "flash_attention_pallas/tf32":
        ("src/repro/kernels/flash_attention/kernel.py:99", FA_TF32_SOURCE),
    "flash_attention_pallas/tf32_d160":
        ("src/repro/kernels/flash_attention/kernel.py:99", FA_TF32_SOURCE),
    "int8_matmul_pallas":
        ("src/repro/kernels/int8_matmul/kernel.py:56", I8_SOURCE),
    "int8_matmul_pallas/qconv":
        ("src/repro/kernels/int8_matmul/kernel.py:56", I8_SOURCE),
    "mamba2_ssd_pallas":
        ("src/repro/kernels/mamba2_ssd/kernel.py:79", SSD_SOURCE),
    "rwkv6_scan_pallas":
        ("src/repro/kernels/rwkv6_scan/kernel.py:94", RWKV_SOURCE),
    # Phase 16's pool path: the same launches at B = SERVE_SLOTS slots.
    "reproject_match_fused/slots":
        ("src/repro/kernels/reproject_match/fused.py:121", RM_SOURCE),
    "int8_matmul_pallas/qconv/slots":
        ("src/repro/kernels/int8_matmul/kernel.py:56", I8_SOURCE),
}

# Flash attention: the reference's gates (tests/test_kernels.py:182,196).
FA_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# Zamba2-2.7B's shared attention in its prefill: b, hq, hkv, s, d, causal.
ZAMBA_ATTN = (4, 32, 32, 1024, 160, True)
# The EFM path (phase 7): TinyLlama-1.1B, 4 prompts of 1024 tokens, 32 new.
EFM_ARCH, EFM_BATCH, EFM_PROMPT, EFM_NEW = "tinyllama-1.1b", 4, 1024, 32
# float32 "pallas" vs "ref": the kernel and the masked softmax sum in other
# orders; 22 layers carry that to a few 1e-5 in logits of order 1 (4 layers
# on the CPU: 7e-6).  1e-3 leaves room and still catches a wrong layer.
F32_LOGIT_TOL = 1e-3
# bf16: every layer rounds its activations to 8 bits, and "ref" rounds its
# attention logits to bf16 where the kernel keeps them in f32 (4 layers on
# the CPU: 0.055 in logits of std 1).  A differing greedy token must come
# from two candidates within this margin in both runs' logits.
BF16_LOGIT_TOL = 0.5
# bf16 MLA on "chunked" vs "ref" over one layer, relative to the largest
# |output|: "ref" rounds its probabilities to bf16 before the product with
# v, "chunked" keeps them in f32, and both round the output to bf16 (one
# unit in the last place is 2^-8 of it): 2e-2 is a few such units.
MLA_BF16_TOL = 2e-2
INT8_OP_PER_S = 1979e12  # tensor cores, dense
TF32_FLOP_PER_S = 495e12  # tensor cores, dense
# int8 matmul: the reference test's shapes (tests/test_kernels.py:136-139)
# and the products of the int8 depth network at its 64x64 input, per
# processed frame: (layer, M, K, N).
I8_TEST_SHAPES = ((128, 128, 128), (256, 384, 128), (130, 200, 70),
                  (1, 9, 1), (64, 1, 64))
DEPTH_GEMMS = (
    ("enc0", 1024, 27, 16), ("enc1.pw", 256, 16, 32), ("enc2.pw", 64, 32, 64),
    ("enc3.pw", 64, 64, 64), ("dec0.pw", 256, 64, 32),
    ("dec1.pw", 1024, 32, 16), ("dec2.pw", 4096, 16, 16),
    ("head", 4096, 144, 1),
)
# Baselines at EPIC's budget (EPICConfig().capacity patches; FV unbounded).
BASELINE_BUDGET = 192
TOKENS = 256
# The scans: the reference's gate (tests/test_kernels.py:231-232, 263-264),
# its test shapes (:218-223, :250-255) and the full-width shapes of the
# two models' prefills (4 prompts of 1024 tokens).
SCAN_TOL = 2e-4
RWKV_TEST_SHAPES = ((1, 2, 128, 32, 32, 32), (2, 4, 256, 64, 64, 64),
                    (1, 1, 64, 16, 48, 16), (1, 2, 192, 64, 64, 64))
SSD_TEST_SHAPES = ((1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64),
                   (1, 1, 64, 64, 64, 64), (1, 3, 192, 32, 64, 32))
RWKV_FULL = (4, 40, 1024, 64, 64, 32)  # b, h, t, k, v, chunk
SSD_FULL = (4, 80, 1024, 64, 64, 64)  # b, h, t, p, n, chunk
# Phase 15: the recurrent answer paths, their float32 check's cut depth.
SSM_ARCHS = {"rwkv6-3b": ("rwkv6_scan_pallas", 8),
             "zamba2-2.7b": ("mamba2_ssd_pallas", 12)}
HYBRID = "zamba2-2.7b"  # runs its shared attention on the flash kernel too
SSM_NEW = 8
# Phase 16: StreamServer over EPICConfig() (published widths): a pool of 32
# slots, 24 live streams of 12 chunks, 4 closed and 4 admitted mid-run,
# the adaptive-K ladder of the sparse TRD, and a tiered run.
SERVE_SLOTS, SERVE_LIVE, SERVE_CHUNKS, SERVE_CHURN = 32, 24, 12, 4
SERVE_LADDER = (8, 16, 24, 48)
SERVE_TIERS = (8, 24)
# Largest float difference a predicted depth track's served stream may
# keep from its solo session on the card (integers must be equal): cuDNN
# convolves a frame differently at batch 32 than at 1.  The readings
# were 1.04e-06 (fp32) and 1.19e-07 (int8) on an H100.
SERVE_FLOAT_TOL = 1e-5
# Ticks recorded at each live count for 16c: every one must dispatch the
# same host ops (host_ops).
SERVE_PROFILED_TICKS = 4
# Phase 17: the wire in front of phase 16's server.  Late joiner j is wire
# stream WIRE_LATE + j; the lossy link's per-frame fault rates (after one
# round delivered whole); the short Unix-socket run's streams; the crash:
# a checkpoint every WIRE_CKPT_EVERY ticks, the kill at tick
# WIRE_CRASH_TICK.
WIRE_LATE = 100
WIRE_FAULTS = {"drop": 0.05, "dup": 0.05, "reorder": 0.05, "corrupt": 0.05,
               "truncate": 0.02}
WIRE_SHORT = 4
WIRE_CKPT_EVERY, WIRE_CRASH_TICK = 2, 7
WIRE_QUIET_S = 0.05  # the serving process ticks a partial round after this
# The EVU probe, as benchmarks/evu_accuracy.py's setting 1 (--quick's
# stream counts): 64x64 streams of 40 frames, 5 objects, 4 segments, DC
# buffer 48; card vs CPU within EVU_TOL (float32, TF32 off).
EVU_HW, EVU_PATCH, EVU_FRAMES, EVU_OBJ, EVU_SEG = 64, 16, 40, 5, 4
EVU_CAP, EVU_TRAIN, EVU_TEST = 48, 24, 12
EVU_TOL = 1e-5
# Phase 18: the MoE/MLA, VLM and encoder-decoder answer paths at full
# width, phase 7's prompts and ZOO_NEW greedy tokens; the float32 checks'
# cut depths (MoE layers after the dense one; VLM groups of 5 self layers;
# encoder and decoder layers each); the Figure-1 chain's projection of
# EPIC's token features to d_model is seeded, times this scale.
ZOO_MOE = "deepseek-v2-lite-16b"
ZOO_VLM = "llama-3.2-vision-11b"
ZOO_ENCDEC = "seamless-m4t-large-v2"
ZOO_NEW = 8
ZOO_F32_MOE, ZOO_F32_GROUPS, ZOO_F32_ENCDEC = 2, 2, 2
# Phase 18a: prefill pairs timed with each MoE combine, and the calls
# timed of each combine alone.
MOE_PAIRS, MOE_COMBINE_CALLS = 5, 20
FIG1_PROJ_SCALE = 0.05
# Phase 19: training.  TinyLlama-1.1B at full width in bf16 (4 x 1024
# tokens, 8 AdamW steps, 2 of them warm-up for the step time); float32 at
# TRAIN_F32_LAYERS layers and full width on 2 x 256 tokens; the other
# families at their smoke configurations on 2 x 16 tokens.  TRAIN_TOL:
# card against CPU in float32 (TF32 off), the loss relative to itself and
# each gradient (or first moment) leaf relative to its largest reference
# value; parameters after a step within what a gradient that close can
# move them (``step_err``).
TRAIN_STEPS, TRAIN_WARM, TRAIN_BATCH, TRAIN_SEQ = 8, 2, 4, 1024
TRAIN_F32_LAYERS, TRAIN_F32_BATCH, TRAIN_F32_SEQ = 2, 2, 256
TRAIN_SMOKE = ("rwkv6-3b", "zamba2-2.7b", "deepseek-v3-671b",
               "llama-3.2-vision-11b", "seamless-m4t-large-v2")
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ = 2, 16
TRAIN_TOL = 1e-4
# Phase 20: the sharded train step takes DIST_STEPS steps (the first held,
# the rest timed); the stream-sharded server: DIST_SLOTS slots, as many
# live streams of DIST_CHUNKS chunks, one closed and one admitted at
# DIST_CHURN_AT; the EP check's tokens.
DIST_STEPS = 4
DIST_SLOTS, DIST_CHUNKS, DIST_CHURN_AT = 8, 4, 2
DIST_EP_TOKENS = (2, 512)
# Phase 21: the dry-run's full-width cells (arch, shape, multi-pod mesh).
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", False),
                ("qwen2.5-3b", "prefill_32k", False),
                ("deepseek-v3-671b", "decode_32k", True))


def _need(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Phase 1: card and build.
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def set_numerics(torch) -> None:
    torch.backends.cudnn.allow_tf32 = False  # cuDNN would convolve in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # same convolutions each run
    torch.backends.cudnn.benchmark = False


def phase_build(torch) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.flash_attention.kernel import LIBRARY as fa_lib
    from repro_torch.kernels.int8_matmul.kernel import LIBRARY as i8_lib
    from repro_torch.kernels.mamba2_ssd.kernel import LIBRARY as ssd_lib
    from repro_torch.kernels.reproject_match.kernel import LIBRARY as rm_lib
    from repro_torch.kernels.rwkv6_scan.kernel import LIBRARY as rwkv_lib

    set_numerics(torch)
    t0 = time.perf_counter()
    libs = (rm_lib, fa_lib, i8_lib, ssd_lib, rwkv_lib)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc each, together
        paths = list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        lib.library()
    print(f"[1] built {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in paths:
        for line in path.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("entry function '", "registers",
                                       "spill", "wgmma")):
                line = line.strip().replace("ptxas info    : ", "")
                print(f"    {path.name.rsplit('_', 1)[0]}: {line[:160]}")
    check_no_spills(paths[0], "rm_", 4)
    print("[1] reproject_match: 4 rm_* kernels, 0 spills")
    for lib, kernel, count, pattern in (
            (fa_lib, "fa_wgmma_kernel", 2, r"HGMMA\.[\w.]*BF16"),
            (fa_lib, "fa_tf32_kernel", 10, r"HG?MMA\.[\w.]*TF32"),
            (i8_lib, None, 0, r"IG?MMA\.[\w.]*S8"),
            (ssd_lib, "ssd_", 6, r"HG?MMA\.[\w.]*TF32"),
            (rwkv_lib, "rwkv_", 14, r"HG?MMA\.[\w.]*TF32")):
        check_tensor_core_build(paths[libs.index(lib)], kernel, count,
                                pattern)


def check_no_spills(path, kernel, count) -> None:
    """The library at ``path`` has ``count`` kernels whose (mangled) name
    holds ``kernel``, and none of them spills (its ``-Xptxas -v`` log)."""
    import re

    name = path.name.rsplit("_", 1)[0]
    log = path.with_suffix(".log").read_text()
    blocks = [b for b in log.split("Compiling entry function '")[1:]
              if kernel in b.split("'")[0]]
    _need(len(blocks) == count, f"{len(blocks)} {kernel} kernels in "
          f"the ptxas log of {name}, not {count}")
    for block in blocks:
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", block)
        _need(spills and all(n == "0" for n in spills),
              f"a {kernel} kernel spills: {block[:300]}")


def check_tensor_core_build(path, kernel, count, pattern) -> None:
    """The ``count`` kernels whose name holds ``kernel`` (none if None)
    spill nothing (``-Xptxas -v``), and the library runs its tensor-core
    instructions: ``pattern`` in its SASS (``cuobjdump -sass``): ``HGMMA``
    on bf16 for flash attention (wgmma), ``IMMA`` on s8 for the int8
    kernels, ``HMMA`` on TF32 for the two scans (mma.sync)."""
    import re
    import shutil

    name = path.name.rsplit("_", 1)[0]
    if kernel is not None:
        check_no_spills(path, kernel, count)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    found = [line.split(";")[0].split("*/")[-1].strip()
             for line in sass.splitlines() if re.search(pattern, line)]
    _need(len(found) > 0, f"no {pattern} in the SASS of {name}")
    kinds = sorted(set(re.search(pattern, f).group(0) for f in found))
    spilled = "" if kernel is None else f", {count} {kernel}* kernels, 0 spills"
    print(f"[1] {name} SASS: {len(found)} tensor-core instructions "
          f"({', '.join(kinds)}), e.g. {found[0]!r}{spilled}")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version.
# ---------------------------------------------------------------------------


def make_inputs(torch, device, n, p, hw, seed):
    """Entries for one frame: a third cut from the (smooth) frame and
    moved slightly, so that they match; the rest random content and
    motion.  Returns ``(args, intr)``."""
    import numpy as np

    from repro_torch.core import geometry as geo

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    frame = np.stack(
        [0.5 + 0.4 * np.sin(xx / 9.0 + k) * np.cos(yy / 11.0 - k)
         for k in range(3)], -1,
    )
    g = hw // p
    cells = rng.integers(0, g * g, n)
    origin = np.stack([(cells // g) * p, (cells % g) * p], -1)
    rgb = rng.uniform(size=(n, p, p, 3))
    depth = rng.uniform(1.0, 4.0, size=(n, p, p))
    angles = rng.normal(scale=0.05, size=(n, 3))
    trans = rng.normal(scale=0.1, size=(n, 3))
    same = np.arange(n) % 3 == 0
    for i in np.flatnonzero(same):
        oy, ox = origin[i]
        rgb[i] = frame[oy:oy + p, ox:ox + p]
    angles[same] *= 0.02
    trans[same] *= 0.2

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    t_rel = geo.pose_from_rt(geo.rotation_xyz(t(angles)), t(trans))
    intr = geo.Intrinsics.create(0.8 * hw, hw / 2.0, hw / 2.0, device)
    return [t(rgb), t(depth), t(origin), t_rel.contiguous(), t(frame)], intr


def edge_inputs(torch, device, p=16, hw=128):
    """All pixels behind the camera; the top rows behind (invalid bbox,
    valid pixels); windows clamped at the four frame corners; a valid bbox
    with no pixel in its window (nvalid == 0)."""
    import numpy as np

    from repro_torch.core import geometry as geo

    trans = np.array(
        [[0, 0, -10], [0, 0, -1], [-0.1, -0.1, 0], [0.1, -0.1, 0],
         [-0.1, 0.1, 0], [0.1, 0.1, 0], [6, 0, 0]], np.float32,
    )
    n = len(trans)
    t_rel = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    t_rel[:, :3, 3] = trans
    origin = np.array(
        [[56, 56], [56, 56], [0, 0], [0, hw - p], [hw - p, 0],
         [hw - p, hw - p], [56, 56]], np.float32,
    )
    depth = np.ones((n, p, p), np.float32)
    depth[1] = np.linspace(0.5, 1.5, p, dtype=np.float32)[:, None]
    rng = np.random.default_rng(3)
    rgb = rng.uniform(size=(n, p, p, 3)).astype(np.float32)
    frame = rng.uniform(size=(hw, hw, 3)).astype(np.float32)
    args = [torch.as_tensor(a, device=device)
            for a in (rgb, depth, origin, t_rel, frame)]
    return args, geo.Intrinsics.create(0.8 * hw, hw / 2.0, hw / 2.0, device)


def check_kernels(torch, args, intr, window, label):
    """Hold the three launches against the plain version; returns the
    largest |kernel - plain| over diff, coverage and bbox."""
    from repro_torch.core import geometry as geo
    from repro_torch.kernels.reproject_match.fused import (
        patch_grid_origins, reproject_match_fused)
    from repro_torch.kernels.reproject_match.kernel import (
        reproject_match_pallas, reproject_match_pallas_tiled)
    from repro_torch.kernels.reproject_match.ref import reproject_match_ref
    from repro_torch.kernels.reproject_match.warp_order import (
        reproject_match_fused_warp_order)

    plain = reproject_match_ref(*args, intr, window)
    warp = reproject_match_fused_warp_order(
        *args, intr, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN
    )
    a = reproject_match_pallas(*args, intr, window=window)
    b = reproject_match_pallas_tiled(*args, intr, window=window)
    fd, fc, fb, pair, ovok = reproject_match_fused(
        *args, intr, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN
    )
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, (fd, fc, fb)):
        _need(torch.equal(x, y) and torch.equal(x, z),
              f"{label}: the three launches differ")
    for x, y in zip((fd, fc, fb, pair, ovok), warp):
        _need(torch.equal(x, y), f"{label}: the kernel differs from the "
              "plain version in its summation order")
    errs = [float((x - y).abs().max()) if x.numel() else 0.0
            for x, y in zip(a, plain)]
    _need(errs[0] <= SCORE_TOL and errs[1] <= SCORE_TOL
          and errs[2] <= BBOX_TOL, f"{label}: kernel vs plain {errs}")

    p = args[0].shape[1]
    frame = args[4]
    origins = patch_grid_origins(frame.shape[0], frame.shape[1], p,
                                 frame.device)

    def rows(diff, cov, bbox):
        ov = geo.bbox_overlap_fraction(bbox[:, None], origins[None], p)
        ok = ((diff <= TAU) & (cov >= C_MIN))[:, None] & (ov >= O_MIN)
        return ok, ov >= O_MIN, ov

    own_pair, own_ov, _ = rows(fd, fc, fb)
    _need(torch.equal(pair, own_pair) and torch.equal(ovok, own_ov),
          f"{label}: fused rows differ from its own thresholded scores")
    ref_pair, ref_ov, ov = rows(*plain)
    near = (((plain[0] - TAU).abs() <= SCORE_TOL)
            | ((plain[1] - C_MIN).abs() <= SCORE_TOL))[:, None] | (
        (ov - O_MIN).abs() <= SCORE_TOL)
    flips = (pair != ref_pair) | (ovok != ref_ov)
    _need(not bool((flips & ~near).any()),
          f"{label}: fused rows differ from the thresholded plain scores")
    torch.cuda.synchronize()
    print(f"[2] {label}: N={args[0].shape[0]} P={p} "
          f"frame={tuple(frame.shape[:2])} window={window} "
          f"max|err| diff={errs[0]:.3g} cov={errs[1]:.3g} bbox={errs[2]:.3g}"
          f" (bitwise the kernel's order) matches={int(pair.sum())} "
          f"near-threshold flips={int(flips.sum())}")
    return max(errs)


def phase_kernels(torch, device):
    """Returns each wrapper's largest |kernel - plain| at its main-path
    shape: N = 192 for the dense launches, K = 24 for the tiled one."""
    args, intr = make_inputs(torch, device, 192, 16, 128, SEED)
    dense = check_kernels(torch, args, intr, 32, "main N=192")
    args, intr = make_inputs(torch, device, 24, 16, 128, SEED + 1)
    errs = {"reproject_match_pallas": dense, "reproject_match_fused": dense,
            "reproject_match_pallas_tiled": check_kernels(
                torch, args, intr, 32, "sparse K=24")}
    for n in (1, 7, 13, 25, 193):
        args, intr = make_inputs(torch, device, n, 16, 128, n)
        check_kernels(torch, args, intr, 32, f"N={n}")
    for n, p in ((25, 2), (13, 5)):
        args, intr = make_inputs(torch, device, n, p, 128, n + p)
        check_kernels(torch, args, intr, 16, f"patch {p}")
    args, intr = make_inputs(torch, device, 25, 16, 144, 8)
    check_kernels(torch, args, intr, 32, "144x144 frame (M=81)")
    args, intr = make_inputs(torch, device, 64, 16, 128, 5)
    check_kernels(torch, args, intr, 64, "window 64")
    args, intr = make_inputs(torch, device, 16, 16, 256, 6)
    check_kernels(torch, args, intr, 64, "256x256 frame")
    args, intr = make_inputs(torch, device, 9, 32, 256, 7)
    check_kernels(torch, args, intr, 64, "patch 32")
    for window in (16, 32, 64):
        args, intr = edge_inputs(torch, device)
        check_kernels(torch, args, intr, window, f"edge cases w={window}")
    return errs


# ---------------------------------------------------------------------------
# Phase 3: times.
# ---------------------------------------------------------------------------


def device_ms(torch, fn, per_graph=50, replays=20):
    """Device time of one ``fn()``: a CUDA graph of ``per_graph`` calls,
    replayed ``replays`` times between CUDA events (host overhead out)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def device_profile(torch, fn):
    """One ``fn()`` under ``torch.profiler``: ``(device busy us, device
    launches, the device rows of key_averages())``."""
    from torch.autograd import DeviceType

    rows = [e for e in profiled(torch, fn) if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in rows),
            sum(e.count for e in rows), rows)


def profiled(torch, fn):
    """One ``fn()`` under ``torch.profiler``: its ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    # An empty session first: two runs of phase 16c counted 6 more device
    # launches in the first profiled tick after another profiled tick, as
    # if device records of one session had reached the next.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof.key_averages()


def host_ops(torch, fn):
    """The names of the ops one ``fn()`` dispatches on the host, in order:
    ``torch.profiler`` on the CPU alone, which records each op as it is
    called.  Unlike a device trace, which can lose or
    carry over records at a session's edges (see ``profiled``), it is the
    same for the same calls.  The CUDA runtime calls it also records
    (``cudaMalloc``, ``cudaStreamIsCapturing``) are the caching
    allocator's while its cache fills, not the ops', and are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if not e.name.startswith("cuda")]


def device_launches_per_call(torch, fn, calls=5, tries=3):
    """``(device kernels per fn(), retakes)`` under ``torch.profiler``, over
    ``calls`` calls of an ``fn`` that launches at least one kernel a call.
    A trace that recorded fewer device events than calls (none at all, or
    4 of 5 once, in an H100 run where the same call had recorded 1 a call
    before) lost events, and is taken again, up to ``tries`` times;
    ``retakes`` counts those, for the output to show."""
    for retakes in range(tries):
        launches = device_profile(
            torch, lambda: [fn() for _ in range(calls)])[1]
        if launches >= calls:
            break
    return launches / calls, retakes


def bound(args, fused: bool):
    """Least time on the card: ``(ms, "bytes" | "operations")``."""
    rgb, depth, origin, t_rel, frame = args
    n, p = rgb.shape[0], rgb.shape[1]
    m = (frame.shape[0] // p) * (frame.shape[1] // p)
    nbytes = sum(t.numel() * 4 for t in args) + 3 * 4 + n * 8 * 4
    flops = n * p * p * FLOP_PER_PIXEL
    if fused:
        nbytes += 2 * n * m  # the two bool rows
        flops += n * m * FLOP_PER_PAIR
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


RM_SHAPES = {  # wrapper -> entries at the main path's shapes
    "reproject_match_pallas": 192,
    "reproject_match_pallas_tiled": 24,  # the sparse path's K
    "reproject_match_fused": 192,
}
# Scale, not the main path: a 512x512 frame with EPICConfig()'s ratio of
# capacity to patches (192 / 64), P = 16, window 32.
RM_SCALE = (3072, 16, 512)


def rm_calls(torch, args, intr, window=32):
    """``{wrapper: (kernel call, plain call)}`` on the same inputs."""
    from repro_torch.kernels.reproject_match import fused, kernel, ref

    def plain():
        ref.reproject_match_ref(*args, intr, window)

    return {
        "reproject_match_pallas": (
            lambda: kernel.reproject_match_pallas(*args, intr, window=window),
            plain),
        "reproject_match_pallas_tiled": (
            lambda: kernel.reproject_match_pallas_tiled(*args, intr,
                                                        window=window),
            plain),
        "reproject_match_fused": (
            lambda: fused.reproject_match_fused(
                *args, intr, window=window, tau=TAU, o_min=O_MIN,
                c_min=C_MIN),
            lambda: fused.reproject_match_fused_ref(
                *args, intr, window=window, tau=TAU, o_min=O_MIN,
                c_min=C_MIN)),
    }


def launch_floor_ms(torch, device):
    """A one-element elementwise launch in CUDA-graph replay: the least a
    launch costs in ``device_ms``."""
    x = torch.zeros(1, device=device)
    return device_ms(torch, lambda: x.add_(1.0))


def phase_times(torch, device):
    times = {}
    floor_ms = launch_floor_ms(torch, device)
    print(f"[3] launch floor (one-element add_, graph replay): "
          f"{floor_ms * 1e3:.3f} us")
    for name, n in RM_SHAPES.items():
        args, intr = make_inputs(torch, device, n, 16, 128, SEED)
        k_fn, p_fn = rm_calls(torch, args, intr)[name]
        ms, plain_ms = device_ms(torch, k_fn), device_ms(torch, p_fn)
        bound_ms, bound_by = bound(args, name == "reproject_match_fused")
        launches, retakes = device_launches_per_call(torch, k_fn)
        _need(launches == 1, f"{name}: {launches} device launches a call")
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        print(f"[3] {name}: N={n} kernel {ms * 1e3:.3f} us "
              f"({ms / floor_ms:.2f}x the launch floor), plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
              f"({bound_by}), {launches:g} device launch a call "
              f"(short traces retaken: {retakes})")
    n, p, hw = RM_SCALE
    args, intr = make_inputs(torch, device, n, p, hw, SEED)
    for name, (k_fn, _) in rm_calls(torch, args, intr).items():
        ms = device_ms(torch, k_fn, per_graph=20)
        bound_ms, bound_by = bound(args, name == "reproject_match_fused")
        print(f"[3] scale, not the main path: {name} N={n} P={p} "
              f"{hw}x{hw} frame: kernel {ms * 1e3:.3f} us, bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}; {ms / bound_ms:.2f}x)")
    return times


# ---------------------------------------------------------------------------
# Phase 4: the main path.
# ---------------------------------------------------------------------------


def state_leaves(state):
    return [*state.bypass, *state.buf, state.t]


def trace_flip(torch, cfg, models, state, chunk, kernel_backend):
    """Replay a chunk frame by frame from ``state`` on both backends; at
    the first frame whose stats differ, show that every differing decision
    comes from a score within 1e-5 of its threshold.  Returns the message."""
    from repro_torch.core import geometry as geo
    from repro_torch.core import pipeline as pipe
    from repro_torch.kernels.reproject_match.kernel import (
        reproject_match_pallas)
    from repro_torch.kernels.reproject_match.ref import reproject_match_ref

    kcfg, rcfg = cfg, cfg._replace(backend="ref")
    for i in range(chunk.n_frames):
        x = (chunk.frames[i], chunk.poses[i], chunk.gazes[i],
             None if chunk.depth is None else chunk.depth[i])
        ks, kst = pipe.process_frame(state, *x, models, kcfg)
        _, rst = pipe.process_frame(state, *x, models, rcfg)
        if all(torch.equal(a, b) for a, b in zip(kst, rst)):
            state = ks
            continue
        buf = state.buf
        intr = cfg.intrinsics(buf.rgb.device)
        t_rel = (geo.invert_pose(chunk.poses[i]) @ buf.pose).contiguous()
        args = (buf.rgb, buf.depth, buf.origin, t_rel, chunk.frames[i], intr)
        pd, pc, pb = reproject_match_ref(*args, cfg.window)
        kd, kc, kb = reproject_match_pallas(*args, window=cfg.window)
        differ = (((pd <= cfg.tau) != (kd <= cfg.tau))
                  | ((pc >= cfg.c_min) != (kc >= cfg.c_min))) & buf.valid
        near = (((pd - cfg.tau).abs() <= SCORE_TOL)
                | ((pc - cfg.c_min).abs() <= SCORE_TOL))
        _need(bool(differ.any()) and not bool((differ & ~near).any()),
              f"{kernel_backend}: frame {i} of the chunk differs from ref "
              "with no near-threshold score to explain it")
        idx = torch.nonzero(differ).flatten().tolist()
        return (f"flip at chunk frame {i}: entries {idx} diff "
                f"{pd[idx].tolist()} (kernel {kd[idx].tolist()}) coverage "
                f"{pc[idx].tolist()} (kernel {kc[idx].tolist()})")
    raise AssertionError(f"{kernel_backend}: chunk differs but no frame does")


def run_session(torch, comp, stream, device):
    """Ingest the stream in chunks; returns (state, stats, pre-chunk
    states, chunks, seconds)."""
    from repro_torch.api import SensorChunk, concat_stats, iter_chunks

    state = comp.init()
    stats, befores, chunks = [], [], []
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for chunk in iter_chunks(SensorChunk(*stream), CHUNK):
        befores.append(state)
        chunks.append(chunk)
        state, cs = comp.step(state, chunk)
        stats.append(cs)
    torch.cuda.synchronize(device)
    return (state, concat_stats(stats), befores, chunks,
            time.perf_counter() - t0)


def main_path_inputs(torch, device, n_frames=N_FRAMES):
    """The main path's stream and networks, all made from ``SEED``:
    ``(stream, depth_track, models)``; ``stream`` is (frames, poses,
    gazes) of ``StreamConfig()`` at 128x128."""
    import numpy as np

    from repro_torch.core import depth as depth_mod
    from repro_torch.core import hir as hir_mod
    from repro_torch.core import pipeline as pipe
    from repro_torch.data import synthetic

    scfg = synthetic.StreamConfig(n_frames=n_frames, hw=(128, 128))
    s, _ = synthetic.generate_stream(np.random.default_rng(SEED), scfg,
                                     device=device)
    hir = hir_mod.init_params(
        torch.Generator(device=device).manual_seed(SEED + 1))
    with torch.no_grad():
        # Random weights put most logits on one side of 0; centre the
        # last bias on the first chunk's median logit, so that about
        # half of the patches are salient.
        logits = hir(depth_mod.resize_image(s.frames[:CHUNK], 64),
                     hir_mod.gaze_heatmap(s.gazes[:CHUNK], 64, scfg.hw),
                     pipe.EPICConfig().grid)
        hir.b3 -= logits.median()
    models = pipe.EPICModels(
        depth_model=depth_mod.init_params(
            torch.Generator(device=device).manual_seed(SEED)),
        hir_model=hir,
    )
    return (s.frames, s.poses, s.gazes), s.depth, models


def kernel_wrappers():
    """Every kernel wrapper of the port, by the name of its TPU kernel;
    each counts its launches in ``.launches``."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.reproject_match import fused, kernel
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas

    return {
        "reproject_match_pallas": kernel.reproject_match_pallas,
        "reproject_match_pallas_tiled": kernel.reproject_match_pallas_tiled,
        "reproject_match_fused": fused.reproject_match_fused,
        "flash_attention_pallas": flash_attention_pallas,
        "int8_matmul_pallas": int8_matmul_pallas,
        "int8_matmul_pallas/qconv": qconv_int8_pallas,
        "mamba2_ssd_pallas": mamba2_ssd_pallas,
        "rwkv6_scan_pallas": rwkv6_scan_pallas,
    }


def phase_main_path(torch, device, n_frames=N_FRAMES):
    """The main-path runs; returns each kernel's launch count."""
    from repro_torch.api import EPICCompressor, SensorChunk
    from repro_torch.core import pipeline as pipe

    wrappers = kernel_wrappers()
    stream, depth_track, models = main_path_inputs(torch, device, n_frames)
    cfg0 = pipe.EPICConfig()
    _need(cfg0.backend == "fused", "the default backend is not the kernel")

    # Warm-up (cuDNN, allocator) on one chunk, not counted.
    warm = EPICCompressor(cfg0._replace(backend="ref"), models, device=device)
    warm.step(warm.init(), SensorChunk(*(x[:CHUNK] for x in stream)))

    # The random depth network warps wrongly, so the main path matches
    # few patches; a last run with the oracle depth track loads the match
    # path (popularity bumps, newest-first choice) on the card as well.
    oracle = models._replace(depth_model=None)
    launches = {}
    for run, kw, name, run_models, run_stream in (
        ("fused", dict(backend="fused"), "reproject_match_fused", models,
         stream),
        ("pallas_tiled", dict(backend="pallas_tiled", prefilter_k=24,
                              patch_k=16), "reproject_match_pallas_tiled",
         models, stream),
        ("pallas", dict(backend="pallas"), "reproject_match_pallas", models,
         stream),
        ("fused, oracle depth", dict(backend="fused"),
         "reproject_match_fused", oracle, stream + (depth_track,)),
    ):
        cfg = cfg0._replace(**kw)
        for w in wrappers.values():
            w.launches = 0
        comp = EPICCompressor(cfg, run_models, device=device)
        state, stats, befores, chunks, secs = run_session(
            torch, comp, run_stream, device)
        counts = {k: w.launches for k, w in wrappers.items()}
        launches.setdefault(name, counts[name])
        processed = int(stats.processed.sum())
        busy_us, dev_launches, _ = device_profile(
            torch, lambda: run_session(torch, comp, run_stream, device))
        _need(counts[name] > 0, f"{run}: {name} was never launched")
        _need(all(t.device == device for t in state_leaves(state)),
              f"{run}: state left the card")
        _need(all(bool(torch.isfinite(t).all()) for t in state_leaves(state)
                  if t.dtype.is_floating_point), f"{run}: non-finite state")
        exported = comp.export(state)
        _need(tuple(exported.rgb.shape) == (cfg.capacity, 16, 16, 3),
              f"{run}: export shape {tuple(exported.rgb.shape)}")

        ref_comp = EPICCompressor(cfg._replace(backend="ref"), run_models,
                                  device=device)
        rstate, rstats, _, _, rsecs = run_session(
            torch, ref_comp, run_stream, device)
        verdict = "counters and state equal to ref"
        for c, (before, chunk) in enumerate(zip(befores, chunks)):
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            if not all(torch.equal(a[sl], b[sl])
                       for a, b in zip(stats, rstats)
                       if a.dtype != torch.float32):
                verdict = trace_flip(torch, cfg, run_models, before, chunk,
                                     run)
                break
        else:
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(state_leaves(state), state_leaves(rstate))]
            _need(max(errs) <= SCORE_TOL,
                  f"{run}: state differs from ref by {max(errs)}")
        print(
            f"[4] {run}: {n_frames / secs:.1f} frames/s (ref "
            f"{n_frames / rsecs:.1f}), processed {processed}/{n_frames}, "
            f"matched {int(stats.n_matched.sum())}, inserted "
            f"{int(stats.n_inserted.sum())}, occupancy "
            f"{int(stats.buffer_valid[-1])}/{cfg.capacity}, full checks "
            f"{int(stats.n_full_checks.sum())}, prefilter overflow "
            f"{int(stats.n_prefilter_overflow.sum())}, launches {counts} "
            f"({counts[name] / max(processed, 1):.2f} per processed frame); "
            f"profiled session: device busy {busy_us / n_frames:.1f} us and "
            f"{dev_launches / n_frames:.1f} device launches per frame, "
            f"{busy_us / max(processed, 1):.1f} us and "
            f"{dev_launches / max(processed, 1):.1f} per processed frame; "
            f"{verdict}"
        )
    return launches


# ---------------------------------------------------------------------------
# Phase 5: flash attention against its plain version.
# ---------------------------------------------------------------------------


def fa_inputs(torch, device, b, hq, hkv, s, d, dtype, seed, bshd=False):
    """q, k, v from a seed: (B, H, S, D) tensors, or with ``bshd`` the (B,
    H, S, D) views of (B, S, H, D) tensors (the models' layout)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if bshd:
        return [torch.randn(b, s, h, d, generator=g, device=device).to(
            dtype).transpose(1, 2) for h in (hq, hkv, hkv)]
    return [torch.randn(b, h, s, d, generator=g, device=device).to(dtype)
            for h in (hq, hkv, hkv)]


def fa_check(torch, label, q, k, v, causal):
    """One launch against the plain version; returns max |kernel - plain|
    and the output."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain)

    out = flash_attention_pallas(q, k, v, causal=causal)
    torch.cuda.synchronize()
    plain = flash_attention_plain(q, k, v, causal=causal)
    _need(out.dtype == q.dtype and out.shape == q.shape,
          f"flash {label}: output {out.dtype} {tuple(out.shape)}")
    _need(bool(torch.isfinite(out).all()), f"flash {label}: non-finite output")
    err = float((out.float() - plain.float()).abs().max())
    tol = FA_TOL[str(q.dtype).split(".")[1]]
    _need(err <= tol, f"flash {label} {q.dtype}: kernel vs plain {err} > {tol}")
    return err, out


def phase_flash(torch, device):
    """Returns the largest |kernel - plain| at the main path's shape of the
    bf16 wgmma instance (the path's) and of the float32 3xTF32 instance,
    and at Zamba2-2.7B's shared attention of the bf16 3xTF32 instance.
    Phase 18's calls are held at their shapes, in the models' layout."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.models import encdec

    main = (EFM_BATCH, 32, 4, EFM_PROMPT, 64, True)
    vlm, ed = get_config(ZOO_VLM), get_config(ZOO_ENCDEC)
    zoo = {
        f"{ZOO_VLM} self": (EFM_BATCH, vlm.n_heads, vlm.n_kv_heads,
                            EFM_PROMPT, vlm.head_dim_, True),
        f"{ZOO_ENCDEC} encoder": (EFM_BATCH, ed.n_heads, ed.n_kv_heads,
                                  encdec.src_len(ed, EFM_PROMPT),
                                  ed.head_dim_, False),
        f"{ZOO_ENCDEC} decoder": (EFM_BATCH, ed.n_heads, ed.n_kv_heads,
                                  EFM_PROMPT, ed.head_dim_, True),
    }
    cases = [
        ("main", main),
        ("Zamba2", ZAMBA_ATTN),
        *zoo.items(),
        ("S=1", (2, 8, 2, 1, 64, True)),
        ("S=100", (2, 8, 2, 100, 64, True)),
        ("S=2048", (1, 16, 2, 2048, 64, True)),
        ("D=8", (2, 4, 2, 256, 8, True)),
        ("D=16", (2, 4, 2, 256, 16, True)),
        ("D=128 MHA", (2, 8, 8, 512, 128, True)),
        ("MQA", (2, 8, 1, 256, 64, True)),
        ("non-causal", (2, 8, 4, 384, 64, False)),
        ("non-causal S=100 D=128", (1, 6, 2, 100, 128, False)),
        ("D=160 GQA", (2, 8, 2, 512, 160, True)),
        ("non-causal S=100 D=160", (1, 4, 1, 100, 160, False)),
        ("S=2048 D=128", (1, 8, 8, 2048, 128, True)),
    ]
    errs = {}
    for i, (label, (b, hq, hkv, s, d, causal)) in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = fa_inputs(torch, device, b, hq, hkv, s, d, dtype, i,
                                bshd=label in zoo)
            err, _ = fa_check(torch, label, q, k, v, causal)
            name = str(dtype).split(".")[1]
            if label in ("main", "Zamba2"):
                errs[label, name] = err
            print(f"[5] flash {label}: q {(b, hq, s, d)} kv heads {hkv} "
                  f"causal={causal} {name} ({route(dtype, d)}"
                  f"{', strided' if label in zoo else ''}): max|err| "
                  f"{err:.3g} (tol {FA_TOL[name]})")
    # bf16 on the tensor cores in the models' layout, bitwise equal to the
    # contiguous layout.
    worst, n = 0.0, 0
    for d in (64, 128):
        for group in (1, 4, 8):
            for s in (1, 64, 100, 1024, 2048):
                for causal in (True, False):
                    b, hq = (1 if s >= 1024 else 2), 8
                    q, k, v = fa_inputs(torch, device, b, hq, hq // group, s,
                                        d, torch.bfloat16, n, bshd=True)
                    label = (f"bf16 D={d} group={group} S={s} "
                             f"causal={causal} strided")
                    err, out = fa_check(torch, label, q, k, v, causal)
                    _, dense = fa_check(torch, label, q.contiguous(),
                                        k.contiguous(), v.contiguous(),
                                        causal)
                    _need(torch.equal(out, dense), f"flash {label}: the "
                          f"strided and contiguous layouts differ")
                    worst, n = max(worst, err), n + 1
    print(f"[5] flash bf16 tensor cores: {n} cases (D 64, 128; GQA groups 1,"
          f" 4, 8; S 1, 64, 100, 1024, 2048; causal and full) in the models'"
          f" layout, each bitwise equal to the contiguous layout: max|err| "
          f"{worst:.3g} (tol {FA_TOL['bfloat16']})")
    # Every (dtype, head dim) of the 3xTF32 kernel in the models' layout,
    # bitwise equal to the contiguous layout.
    worst, n = {"float32": 0.0, "bfloat16": 0.0}, 0
    for dtype, dims in ((torch.float32, (8, 16, 32, 64, 128, 160)),
                        (torch.bfloat16, (8, 16, 32, 160))):
        name = str(dtype).split(".")[1]
        for d in dims:
            _need(route(dtype, d) == "tf32", f"{name} D={d}: {route(dtype, d)}")
            for group in (1, 4):
                for s in (1, 100, 1024):
                    for causal in (True, False):
                        b, hq = (1 if s >= 1024 else 2), 8
                        q, k, v = fa_inputs(torch, device, b, hq, hq // group,
                                            s, d, dtype, n, bshd=True)
                        label = (f"{name} D={d} group={group} S={s} "
                                 f"causal={causal} strided")
                        err, out = fa_check(torch, label, q, k, v, causal)
                        _, dense = fa_check(torch, label, q.contiguous(),
                                            k.contiguous(), v.contiguous(),
                                            causal)
                        _need(torch.equal(out, dense), f"flash {label}: the "
                              f"strided and contiguous layouts differ")
                        worst[name], n = max(worst[name], err), n + 1
    print(f"[5] flash 3xTF32: {n} cases (float32 D 8, 16, 32, 64, 128, 160; "
          f"bf16 D 8, 16, 32, 160; GQA groups 1, 4; S 1, 100, 1024; causal "
          f"and full) in the models' layout, each bitwise equal to the "
          f"contiguous layout: max|err| float32 {worst['float32']:.3g} (tol "
          f"{FA_TOL['float32']}), bf16 {worst['bfloat16']:.3g} (tol "
          f"{FA_TOL['bfloat16']})")
    return {"flash_attention_pallas": errs["main", "bfloat16"],
            "flash_attention_pallas/tf32": errs["main", "float32"],
            "flash_attention_pallas/tf32_d160": errs["Zamba2", "bfloat16"]}


def fa_bound(b, hq, hkv, s, d, causal, elem_bytes, flop_per_s):
    """Least time of one attention call: ``(ms, "bytes" | "operations",
    flop)``.  q, k, v read once, o written once; 2 FLOP per multiply-add
    of QK^T and of PV, over the key positions causal attention needs
    (S (S + 1) / 2 pairs per head), at ``flop_per_s`` (the bf16
    tensor-core peak, or float32's on the CUDA cores)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flop = 4 * b * hq * d * pairs
    nbytes = (2 * b * hq + 2 * b * hkv) * s * d * elem_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / flop_per_s * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", flop
    return t_ops, "operations", flop


# ---------------------------------------------------------------------------
# Phase 6: flash attention times.
# ---------------------------------------------------------------------------


def phase_flash_times(torch, device):
    """Per row of the kernels line: the kernel (bf16 on wgmma at the main
    shape; 3xTF32 in float32 at the main shape and in bf16 at Zamba2-2.7B's
    shared attention), the plain version and
    ``F.scaled_dot_product_attention`` (yardstick only), beside the bound
    at the dtype's peak and, for the 3xTF32 kernel, its design's floor on
    the tensor cores (``tf32_products`` TF32 products per product of the
    function, at 495 TFLOP/s).  Returns the rows of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas, flash_attention_plain, route)

    main = (EFM_BATCH, 32, 4, EFM_PROMPT, 64, True)
    rows = {}
    for name, shape, dtype, peak, tf32_products, per in (
            ("flash_attention_pallas", main, torch.bfloat16, BF16_FLOP_PER_S,
             None, 20),
            ("flash_attention_pallas/tf32", main, torch.float32,
             FP32_FLOP_PER_S, 3.0, 10),
            ("flash_attention_pallas/tf32_d160", ZAMBA_ATTN, torch.bfloat16,
             BF16_FLOP_PER_S, 1.5, 10)):
        q, k, v = fa_inputs(torch, device, *shape[:5], dtype, 0)
        ms = device_ms(torch, lambda: flash_attention_pallas(q, k, v),
                       per_graph=per)
        plain_ms = device_ms(torch, lambda: flash_attention_plain(q, k, v),
                             per_graph=5)
        library_ms = device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), per_graph=per)
        # the path's layout: q, k contiguous after RoPE, v a (B, S, H, D)
        # view
        vs = v.transpose(1, 2).contiguous().transpose(1, 2)
        strided_ms = device_ms(torch, lambda: flash_attention_pallas(q, k, vs),
                               per_graph=per)
        bound_ms, bound_by, flop = fa_bound(*shape, q.element_size(), peak)
        floor = ""
        if tf32_products is not None:
            floor_ms = tf32_products * flop / TF32_FLOP_PER_S * 1e3
            floor = (f"; 3xTF32 floor {floor_ms * 1e3:.2f} us "
                     f"({tf32_products:g} TF32 products a product at "
                     f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s; kernel at "
                     f"{floor_ms / ms:.1%} of it)")
        dt = str(dtype).split(".")[1]
        print(f"[6] {name}: q {tuple(q.shape)} {dt}, kv heads {shape[2]}, "
              f"causal, {route(dtype, shape[4])}: kernel {ms * 1e3:.2f} us "
              f"({flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s; v strided "
              f"{strided_ms * 1e3:.2f} us), plain {plain_ms * 1e3:.2f} us, "
              f"scaled_dot_product_attention {library_ms * 1e3:.2f} us "
              f"({flop / (library_ms * 1e-3) / 1e12:.1f} TFLOP/s), bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}: {flop / 1e9:.2f} GFLOP "
              f"at {peak / 1e12:.0f} TFLOP/s; kernel at "
              f"{bound_ms / ms:.1%} of it){floor}")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=library_ms)
        del q, k, v, vs
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# Phase 7: the EFM answer path.
# ---------------------------------------------------------------------------


def efm_run(torch, device, backend, dtype, wrappers):
    """TinyLlama-1.1B on ``backend`` with all dtypes ``dtype``: a warm-up
    prefill, then (counts set to 0) a timed prefill and 32 greedy tokens.
    Returns a dict of the results and readings."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.efm import (greedy_decode_loop, jit_prefill,
                                       pad_for_decode)

    cfg = get_config(EFM_ARCH).replace(
        attn_backend=backend, param_dtype=dtype, compute_dtype=dtype,
        cache_dtype=dtype)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab, (EFM_BATCH, EFM_PROMPT)), device=device)
    batch = {"tokens": tokens}
    prefill = jit_prefill(model)

    # Record each decode step's logits (for the token trace) while the
    # loop runs through the model's own step.
    steps = []

    def decode_step(p, c, t, pos):
        logits, c = model.decode_step(p, c, t, pos)
        steps.append(logits[:, -1].float().clone())
        return logits, c

    recording = dataclasses.replace(model, decode_step=decode_step)

    prefill(params, batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    cache = pad_for_decode(model, cache, EFM_NEW)
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    out, cache = greedy_decode_loop(recording, params, cache, first,
                                    EFM_PROMPT, EFM_NEW)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decode_launches = {k: w.launches - launches[k]
                       for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    _need(tuple(logits.shape) == (EFM_BATCH, 1, cfg.vocab)
          and logits.dtype == torch.float32, f"{backend} {dtype}: logits "
          f"{tuple(logits.shape)} {logits.dtype}")
    _need(tuple(out.shape) == (EFM_BATCH, EFM_NEW + 1),
          f"{backend} {dtype}: tokens {tuple(out.shape)}")
    _need(int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
          f"{backend} {dtype}: token ids out of range")
    step_logits = torch.stack(steps)  # (EFM_NEW, B, V)
    _need(bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(step_logits).all()),
          f"{backend} {dtype}: non-finite logits")
    _need(tuple(cache["k"].shape) == (
        cfg.n_layers, EFM_BATCH, cfg.n_kv_heads, EFM_PROMPT + EFM_NEW,
        cfg.head_dim_) and cache["k"].dtype == cfg.cachedt,
        f"{backend} {dtype}: cache {tuple(cache['k'].shape)}")
    print(f"[7] {EFM_ARCH} {dtype} attn_backend={backend!r}: prefill "
          f"{EFM_BATCH}x{EFM_PROMPT} tokens in {t_prefill * 1e3:.2f} ms "
          f"({EFM_BATCH * EFM_PROMPT / t_prefill:.0f} tokens/s), decode "
          f"{EFM_NEW} steps in {t_decode * 1e3:.2f} ms "
          f"({EFM_BATCH * EFM_NEW / t_decode:.1f} tokens/s, "
          f"{t_decode / EFM_NEW * 1e3:.2f} ms/step), peak memory "
          f"{peak / 2**30:.2f} GiB; launches in prefill {launches}, in "
          f"decode {decode_launches}")
    result = dict(logits=logits[:, -1], steps=step_logits, tokens=out,
                  launches=launches)
    del params, cache, model, recording
    torch.cuda.empty_cache()
    return result


def trace_token_flips(kern, ref, label, tol=BF16_LOGIT_TOL):
    """At the first differing token of each prompt, both runs' logits that
    chose it must put the two candidates within ``tol``."""
    notes = []
    for b in range(EFM_BATCH):
        diff = (kern["tokens"][b] != ref["tokens"][b]).nonzero().flatten()
        if not len(diff):
            continue
        t = int(diff[0])  # t = 0 is the prefill's argmax
        tk, tr = int(kern["tokens"][b, t]), int(ref["tokens"][b, t])
        lk = kern["logits"][b] if t == 0 else kern["steps"][t - 1, b]
        lr = ref["logits"][b] if t == 0 else ref["steps"][t - 1, b]
        mk = float(lk[tk] - lk[tr])
        mr = float(lr[tr] - lr[tk])
        _need(0 <= mk <= tol and 0 <= mr <= tol,
              f"{label}: prompt {b} token {t} differs ({tk} vs {tr}) with "
              f"margins {mk}, {mr} above {tol}")
        notes.append(f"prompt {b} token {t}: {tk} vs {tr}, margins "
                     f"{mk:.4f} / {mr:.4f}")
    return notes


def phase_efm(torch, device, wrappers):
    """The EFM runs; returns the flash launches of the main path's run
    (bf16, ``"pallas"``: the wgmma instance) and of the float32
    ``"pallas"`` run (the 3xTF32 instance)."""
    from repro_torch.configs import get_config

    n_layers = get_config(EFM_ARCH).n_layers
    runs = {}
    for dtype in ("bfloat16", "float32"):
        for backend in ("pallas", "ref"):
            runs[dtype, backend] = efm_run(torch, device, backend, dtype,
                                           wrappers)
        kern, ref = runs[dtype, "pallas"], runs[dtype, "ref"]
        _need(kern["launches"]["flash_attention_pallas"] == n_layers,
              f"{dtype}: {kern['launches']['flash_attention_pallas']} flash "
              f"launches in one prefill, not {n_layers}")
        _need(ref["launches"]["flash_attention_pallas"] == 0,
              f"{dtype}: the ref run launched the flash kernel")
        err = float((kern["logits"] - ref["logits"]).abs().max())
        same = bool(torch.equal(kern["tokens"], ref["tokens"]))
        if dtype == "float32":
            step_err = float((kern["steps"] - ref["steps"]).abs().max())
            _need(same, f"float32: greedy tokens differ between the "
                  f"backends:\n{kern['tokens']}\n{ref['tokens']}")
            _need(max(err, step_err) <= F32_LOGIT_TOL,
                  f"float32: logits differ by {err} (prefill), {step_err} "
                  f"(decode) > {F32_LOGIT_TOL}")
            print(f"[7] float32 pallas vs ref: max|d logits| prefill "
                  f"{err:.3g}, decode steps {step_err:.3g} (tol "
                  f"{F32_LOGIT_TOL}); greedy tokens equal")
        else:
            _need(err <= BF16_LOGIT_TOL, f"bfloat16: prefill logits differ "
                  f"by {err} > {BF16_LOGIT_TOL}")
            notes = trace_token_flips(kern, ref, "bfloat16")
            n_diff = int((kern["tokens"] != ref["tokens"]).sum())
            print(f"[7] bfloat16 pallas vs ref: max|d logits| prefill "
                  f"{err:.3g} (tol {BF16_LOGIT_TOL}); greedy tokens "
                  f"{'equal' if same else f'{n_diff} differ'}"
                  + "".join(f"; {n}" for n in notes))
    return {"flash_attention_pallas": runs["bfloat16", "pallas"][
                "launches"]["flash_attention_pallas"],
            "flash_attention_pallas/tf32": runs["float32", "pallas"][
                "launches"]["flash_attention_pallas"]}


# ---------------------------------------------------------------------------
# Phase 8: where the EFM path's time goes.
# ---------------------------------------------------------------------------


def phase_efm_profile(torch, device):
    """Phase 7's bf16 ``"pallas"`` run under ``torch.profiler``: for the
    prefill and the 32-step decode, a warm-up, a timed run (host clock, no
    profiler) and a profiled run; prints wall time, device busy time (the
    sum of the device-side events) and the idle share it leaves of the
    unprofiled wall time, device launches, and the device time by kernel.
    """
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.efm import (greedy_decode_loop, jit_prefill,
                                       pad_for_decode)

    cfg = get_config(EFM_ARCH).replace(attn_backend="pallas")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (EFM_BATCH, EFM_PROMPT)), device=device)}
    prefill = jit_prefill(model)
    logits, cache = prefill(params, batch)
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    padded = pad_for_decode(model, cache, EFM_NEW)

    def run_decode():
        state = {k: c.clone() for k, c in padded.items()}
        greedy_decode_loop(model, params, state, first, EFM_PROMPT, EFM_NEW)

    profile_steps(torch, f"[8] {EFM_ARCH} bf16", (
        ("prefill", lambda: prefill(params, batch), 1, "prefill"),
        ("decode", run_decode, EFM_NEW, "step")))
    del params, cache, padded, model
    torch.cuda.empty_cache()


def profile_steps(torch, label, runs, focus=(), ranges=()):
    """For each ``(name, fn, per, unit)``: a warm-up, a timed run (host
    clock, no profiler) and a run under ``torch.profiler``; prints wall
    time, device busy time (the sum of the device-side events) and the
    idle share it leaves of the unprofiled wall time, device launches, and
    the device time by kernel, each per ``unit`` (``per`` of them a run),
    the share of the kernels whose name holds each string of ``focus``,
    and the device time of the kernels launched inside each
    ``torch.profiler.record_function`` range named in ``ranges``.  Returns
    the last run's device busy time and its ranges' device times, in us.
    """
    from torch.autograd import DeviceType

    out = {}
    for name, fn, per, unit in runs:
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        averages = profiled(torch, fn)
        # A range also shows on the device timeline, as a row of its own
        # spanning its kernels: not a kernel, so not counted as busy.
        rows = [e for e in averages if e.device_type == DeviceType.CUDA
                and e.key not in ranges]
        busy_us = sum(e.self_device_time_total for e in rows)
        launches = sum(e.count for e in rows)
        _need(busy_us > 0, f"profile of the {name}: no device time")
        print(f"{label} {name}: wall {wall_us / per:.1f} "
              f"us/{unit}, device busy {busy_us / per:.1f} us/{unit}, idle "
              f"share {1 - busy_us / wall_us:.3f}, device launches "
              f"{launches / per:.1f}/{unit}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.self_device_time_total / per:10.1f} us/{unit} "
                  f"{e.self_device_time_total / busy_us:6.1%} "
                  f"{e.count:6d} x  {e.key[:70]}")
        for part in focus:
            mine = [e for e in rows if part in e.key]
            us = sum(e.self_device_time_total for e in mine)
            print(f"{label} {name}: kernels named *{part}*: {us / per:.1f} "
                  f"us/{unit} ({us / busy_us:.1%} of device busy), "
                  f"{sum(e.count for e in mine) / per:.1f} launches/{unit}")
        out = {"busy_us": busy_us}
        for part in ranges:
            us = sum(e.device_time_total for e in averages if e.key == part
                     and e.device_type == DeviceType.CPU)
            out[part] = us
            print(f"{label} {name}: kernels inside {part!r}: {us / per:.1f} "
                  f"us/{unit} ({us / busy_us:.1%} of device busy)")
    return out


# ---------------------------------------------------------------------------
# Phases 9-10: the int8 kernels against their plain versions; times.
# ---------------------------------------------------------------------------


def depth_operands(torch, q, rgb64):
    """What one ``forward_int8`` on ``"ref"`` hands its 8 dense and
    pointwise layers, recorded by wrapping ``int8_ops.qconv_int8``: the
    ``(args, kwargs)`` of each layer, and the ``(A, B)`` of the int8
    product under each (its quantised im2col rows and its weights)."""
    from repro_torch.core import depth as depth_mod
    from repro_torch.kernels.int8_matmul import qconv as qc

    ops, convs = depth_mod.int8_ops, []
    inner = ops.qconv_int8

    def record(x, xscale, qw, wscale, b, *, stride=1, relu=True,
               backend="ref"):
        convs.append(((x.clone(), xscale.clone(), qw, wscale, b),
                      dict(stride=stride, relu=relu)))
        return inner(x, xscale, qw, wscale, b, stride=stride, relu=relu,
                     backend=backend)

    ops.qconv_int8 = record
    backend = q.matmul_backend
    try:
        q.matmul_backend = "ref"
        depth_mod.forward_int8(q, rgb64)
    finally:
        ops.qconv_int8 = inner
        q.matmul_backend = backend
    products = []
    for (x, xscale, qw, _, _), kw in convs:
        qx, _ = qc.quantize_activation(x, xscale)
        cols, _ = qc.im2col(qx, qc.kernel_size(x, qw), kw["stride"])
        products.append((cols.contiguous(), qw))
    got = [(a.shape[0], a.shape[1], b.shape[1]) for a, b in products]
    _need(got == [g[1:] for g in DEPTH_GEMMS],
          f"int8 depth products {got}, not {DEPTH_GEMMS}")
    return products, convs


def qconv_edge_cases(torch, device):
    """``(label, args, kwargs)`` of the fused launch at edge cases: odd H
    and W at stride 2, K = 27, N = 1 without ReLU, M = 75, K = 300 (two
    staged tiles), an all-zero input (the scale clamped to 1e-8) and
    inputs half a step between two int8 values (rounded to even)."""
    g = torch.Generator(device=device).manual_seed(SEED + 18)
    cases = []
    for label, shape, k, cout, stride, relu in (
            ("odd H, W, stride 2", (2, 33, 31, 8), 3, 16, 2, True),
            ("K=27, stride 2", (1, 15, 17, 3), 3, 5, 2, True),
            ("N=1, no ReLU", (1, 12, 10, 16), 3, 1, 1, False),
            ("M=75", (3, 5, 5, 12), 1, 70, 1, True),
            ("K=300", (1, 9, 7, 300), 1, 9, 1, True),
            ("all zero", (1, 6, 6, 8), 3, 4, 2, True),
            ("half steps", (1, 10, 13, 4), 3, 6, 1, True)):
        x = 2 * torch.randn(shape, generator=g, device=device)
        xscale = x.abs().amax()
        if label == "all zero":
            x.zero_()
            xscale = xscale * 0
        elif label == "half steps":  # xscale 127: a step of exactly 1.0
            x = torch.round(x * 40) + 0.5
            xscale = torch.tensor(127.0, device=device)
        qw = torch.randint(-127, 128, (k * k * shape[-1], cout), generator=g,
                           device=device, dtype=torch.int8)
        wscale = 1e-3 + 2e-2 * torch.rand(cout, generator=g, device=device)
        b = torch.randn(cout, generator=g, device=device)
        cases.append((label, (x, xscale, qw, wscale, b),
                      dict(stride=stride, relu=relu)))
    return cases


def phase_int8(torch, device):
    """Returns the depth network's operands for one frame and the largest
    |kernel - plain| of the product kernel and of the fused launch."""
    from repro_torch.core import depth as depth_mod
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.int8_matmul.qconv import (qconv_int8_pallas,
                                                       qconv_int8_ref)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    stream, _, models = main_path_inputs(torch, device, CHUNK)
    q = quantised_models(torch, device, models).depth_model
    rgb64 = depth_mod.resize_image(stream[0][:1], depth_mod.DEPTH_INPUT)
    g = torch.Generator(device=device).manual_seed(SEED)
    cases = []
    for m, k, n in I8_TEST_SHAPES:
        cases.append((f"{m}x{k}x{n}", [
            torch.randint(-128, 128, shape, generator=g, device=device,
                          dtype=torch.int8) for shape in ((m, k), (k, n))]))
    cases.append(("all -128, K=512", [
        torch.full(shape, -128, dtype=torch.int8, device=device)
        for shape in ((64, 512), (512, 64))]))
    products, convs = depth_operands(torch, q, rgb64)
    cases += [(name, ab) for (name, *_), ab in zip(DEPTH_GEMMS, products)]
    worst = 0
    for label, (a, b) in cases:
        out = int8_matmul_pallas(a, b)
        torch.cuda.synchronize()
        plain = int8_matmul_ref(a, b)
        _need(out.dtype == torch.int32 and tuple(out.shape) == (
            a.shape[0], b.shape[1]), f"int8 {label}: {out.dtype} "
            f"{tuple(out.shape)}")
        err = int((out.long() - plain.long()).abs().max())
        _need(err == 0, f"int8 {label}: kernel differs from plain by {err}")
        worst = max(worst, err)
        print(f"[9] int8 {label}: M={a.shape[0]} K={a.shape[1]} "
              f"N={b.shape[1]} equal to the plain version (|C| <= "
              f"{int(plain.abs().max())})")
    _need(int(int8_matmul_pallas(*cases[len(I8_TEST_SHAPES)][1])[0, 0])
          == 512 * 128 * 128, "int8: the all -128 product is not 2^23")

    qcases = [(name, *conv) for (name, *_), conv in zip(DEPTH_GEMMS, convs)]
    qworst = 0.0
    for label, args, kw in qcases + qconv_edge_cases(torch, device):
        out = qconv_int8_pallas(*args, **kw)
        torch.cuda.synchronize()
        plain = qconv_int8_ref(*args, **kw)
        err = float((out - plain).abs().max())
        qworst = max(qworst, err)
        _need(out.dtype == torch.float32 and out.shape == plain.shape
              and torch.equal(out, plain), f"qconv {label}: {out.dtype} "
              f"{tuple(out.shape)}, differs from plain by {err}")
        print(f"[9] qconv {label}: x {tuple(args[0].shape)}, weight "
              f"{tuple(args[2].shape)}, {kw}: bitwise equal to the plain "
              f"version (max |y| {float(plain.abs().max()):.4g})")
    return (products, convs), worst, qworst


def i8_bound(m, k, n):
    """Least time of one product: ``(ms, "bytes" | "operations")``; A and B
    read once as int8, C written once as int32; 2 operations per
    multiply-add at the int8 tensor-core peak."""
    t_bytes = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_OP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_int8_times(torch, device, operands):
    """Times at the depth network's eight layers: the product kernel
    beside its plain version and ``torch._int_mm``, the fused launch beside
    its plain version and the eager chain it replaces (the product kernel
    inside the plain composition); returns each row's numbers summed over
    the eight (one processed frame)."""
    import torch.nn.functional as F

    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
    from repro_torch.kernels.int8_matmul.qconv import (qconv_int8_pallas,
                                                       qconv_int8_ref)
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

    products, convs = operands
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0)
    nbytes = flop = 0
    for (name, m, k, n), (a, b) in zip(DEPTH_GEMMS, products):
        # torch._int_mm takes M > 16 and K, N multiples of 8 (K > 16 too,
        # on some versions): zero-padded copies, made once, outside the
        # timing.
        kp, np_ = max(-(-k // 8) * 8, 24), -(-n // 8) * 8
        ap = F.pad(a, (0, kp - k)).contiguous()
        bp = F.pad(b, (0, np_ - n, 0, kp - k)).contiguous()
        _need(torch.equal(torch._int_mm(ap, bp)[:, :n],
                          int8_matmul_ref(a, b)),
              f"int8 {name}: torch._int_mm on the padded shapes differs")
        ms = device_ms(torch, lambda: int8_matmul_pallas(a, b))
        plain_ms = device_ms(torch, lambda: int8_matmul_ref(a, b))
        library_ms = device_ms(torch, lambda: torch._int_mm(ap, bp))
        b_ms, b_by = i8_bound(m, k, n)
        print(f"[10] int8 {name} ({m}x{k}x{n}): kernel {ms * 1e3:.2f} us, "
              f"plain {plain_ms * 1e3:.2f} us, torch._int_mm "
              f"({m}x{kp}x{np_}) {library_ms * 1e3:.2f} us, bound "
              f"{b_ms * 1e3:.4f} us ({b_by})")
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["library_ms"] += library_ms
        nbytes += m * k + k * n + 4 * m * n
        flop += 2 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / INT8_OP_PER_S * 1e3
    total["bound_ms"], total["bound_by"] = (
        (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
    print(f"[10] int8, the 8 products of one processed frame: kernel "
          f"{total['ms'] * 1e3:.2f} us, plain {total['plain_ms'] * 1e3:.2f} "
          f"us, torch._int_mm {total['library_ms'] * 1e3:.2f} us, bound "
          f"{total['bound_ms'] * 1e3:.4f} us ({total['bound_by']}: "
          f"{nbytes} bytes, {flop} operations)")

    fused = dict(ms=0.0, plain_ms=0.0, library_ms=None)
    chain_ms = 0.0
    nbytes = flop = 0
    for (name, m, k, n), (args, kw) in zip(DEPTH_GEMMS, convs):
        ms = device_ms(torch, lambda: qconv_int8_pallas(*args, **kw))
        plain_ms = device_ms(torch, lambda: qconv_int8_ref(*args, **kw))
        eager_ms = device_ms(torch, lambda: qconv_int8_ref(
            *args, **kw, matmul=int8_matmul_pallas))
        # x read once, weights, scales and bias once, y written once
        # (float32); the int8 products at the int8 tensor-core peak.
        x, _, qw, wscale, b = args
        layer_bytes = 4 * x.numel() + qw.numel() + 4 * (
            1 + wscale.numel() + b.numel()) + 4 * m * n
        b_ms = max(layer_bytes / HBM_BYTES_PER_S,
                   2 * m * k * n / INT8_OP_PER_S) * 1e3
        print(f"[10] qconv {name} (x {tuple(x.shape)}, {m}x{k}x{n}): fused "
              f"{ms * 1e3:.2f} us, the eager chain it replaces (product "
              f"kernel) {eager_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} "
              f"us, bound {b_ms * 1e3:.4f} us")
        fused["ms"] += ms
        fused["plain_ms"] += plain_ms
        chain_ms += eager_ms
        nbytes += layer_bytes
        flop += 2 * m * k * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / INT8_OP_PER_S * 1e3
    fused["bound_ms"], fused["bound_by"] = (
        (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
    print(f"[10] qconv, the 8 fused launches of one processed frame: "
          f"{fused['ms'] * 1e3:.2f} us, the eager chains they replace "
          f"{chain_ms * 1e3:.2f} us, plain {fused['plain_ms'] * 1e3:.2f} us, "
          f"bound {fused['bound_ms'] * 1e3:.4f} us ({fused['bound_by']}: "
          f"{nbytes} bytes, {flop} operations); no PyTorch call convolves "
          f"int8 on CUDA")
    return {"int8_matmul_pallas": total, "int8_matmul_pallas/qconv": fused}


# ---------------------------------------------------------------------------
# Phase 11: EPIC's int8 deployment path.
# ---------------------------------------------------------------------------


def quantised_models(torch, device, models):
    """Phase 4's networks with the depth network quantised to int8 on a
    seeded ``depth_training_batch``."""
    import numpy as np

    from repro_torch.core import depth as depth_mod
    from repro_torch.data import synthetic

    rgb64, _ = synthetic.depth_training_batch(
        np.random.default_rng(SEED + 2),
        synthetic.StreamConfig(hw=(128, 128)), CHUNK, device=device)
    q = depth_mod.quantize_params(models.depth_model, rgb64)
    return models._replace(depth_model=q)


def phase_int8_main_path(torch, device, n_frames=N_FRAMES):
    """The int8 compressor on the fused launch (the main path) and on the
    plain version, and the fp32 compressor; returns the launches of the
    two int8 kernels in the main path's run (the product kernel's are 0:
    the fused launch does its work) and the main path's ``(compressor,
    state, stats)``."""
    from repro_torch.api import EPICCompressor
    from repro_torch.core import depth as depth_mod
    from repro_torch.core import pipeline as pipe

    wrappers = kernel_wrappers()
    stream, _, models = main_path_inputs(torch, device, n_frames)
    qmodels = quantised_models(torch, device, models)
    q = qmodels.depth_model
    cfg = pipe.EPICConfig()
    runs = {}
    for label, run_models, backend in (
            ("int8, fused", qmodels, "pallas"),
            ("int8, plain", qmodels, "ref"),
            ("fp32", models, None)):
        if backend is not None:
            q.matmul_backend = backend
        comp = EPICCompressor(cfg, run_models, device=device)
        # Warm-up on one chunk, not counted.
        run_session(torch, comp, tuple(x[:CHUNK] for x in stream), device)
        for w in wrappers.values():
            w.launches = 0
        state, stats, _, _, secs = run_session(torch, comp, stream, device)
        counts = {k: w.launches for k, w in wrappers.items()}
        frame = stream[0][0]

        def depth():
            return depth_mod.predict_fullres(run_models.depth_model, frame)

        depth_ms = device_ms(torch, depth, per_graph=20)
        _, depth_launches, _ = device_profile(torch, depth)
        runs[label] = (comp, state, stats, counts)
        processed = max(int(stats.processed.sum()), 1)
        print(f"[11] {label}: {n_frames / secs:.1f} frames/s, processed "
              f"{int(stats.processed.sum())}/{n_frames}, depth stage "
              f"{depth_ms * 1e3:.2f} us of device time and {depth_launches} "
              f"device launches per processed frame; launches in the run: "
              f"qconv {counts['int8_matmul_pallas/qconv']} "
              f"({counts['int8_matmul_pallas/qconv'] / processed:.2f} per "
              f"processed frame), int8_matmul "
              f"{counts['int8_matmul_pallas']} "
              f"({counts['int8_matmul_pallas'] / processed:.2f}), "
              f"reproject_match_fused {counts['reproject_match_fused']}")
    q.matmul_backend = "pallas"

    comp, state, stats, counts = runs["int8, fused"]
    _, rstate, rstats, rcounts = runs["int8, plain"]
    processed = int(stats.processed.sum())
    _need(counts["int8_matmul_pallas/qconv"] == 8 * processed > 0,
          f"int8: {counts['int8_matmul_pallas/qconv']} fused launches for "
          f"{processed} processed frames, not 8 each")
    _need(counts["int8_matmul_pallas"] == 0,
          "int8: the main path launched the product kernel")
    _need(rcounts["int8_matmul_pallas"] == 0
          and rcounts["int8_matmul_pallas/qconv"] == 0,
          "int8: the plain run launched a kernel")
    _need(all(torch.equal(a, b) for a, b in zip(stats, rstats)),
          "int8: counters differ from the plain version")
    _need(all(torch.equal(a, b) for a, b in
              zip(state_leaves(state), state_leaves(rstate))),
          "int8: state differs from the plain version")
    _need(all(t.device == device for t in state_leaves(state)),
          "int8: state left the card")
    _need(all(bool(torch.isfinite(t).all()) for t in state_leaves(state)
              if t.dtype.is_floating_point), "int8: non-finite state")
    fp32_stats = runs["fp32"][2]
    print(f"[11] int8 fused run vs the plain run: "
          f"counters and state bitwise equal; matched "
          f"{int(stats.n_matched.sum())} (fp32 "
          f"{int(fp32_stats.n_matched.sum())}), inserted "
          f"{int(stats.n_inserted.sum())} (fp32 "
          f"{int(fp32_stats.n_inserted.sum())}), occupancy "
          f"{int(stats.buffer_valid[-1])}/{cfg.capacity}; depth weights "
          f"{depth_mod.memory_bytes(models.depth_model, True)} bytes in "
          f"int8, {depth_mod.memory_bytes(models.depth_model, False)} in "
          f"fp32")
    launches = {k: counts[k] for k in
                ("int8_matmul_pallas/qconv", "int8_matmul_pallas")}
    return launches, (comp, state, stats)


# ---------------------------------------------------------------------------
# Phase 12: baselines, tokens and the energy model.
# ---------------------------------------------------------------------------


def phase_baselines(torch, device, epic, n_frames=N_FRAMES):
    """``epic`` is ``(compressor, state, stats)`` of phase 11's int8 run
    on the same stream."""
    from repro_torch.api import BaselineConfig, get_compressor
    from repro_torch.core import energy
    from repro_torch.core import pipeline as pipe
    from repro_torch.core import retained as ret

    stream, _, _ = main_path_inputs(torch, device, n_frames)
    h, w = stream[0].shape[1:3]
    ecomp, estate, estats = epic
    counters = {}
    for name, budget in (("fv", -1), ("sd", BASELINE_BUDGET),
                         ("td", BASELINE_BUDGET), ("gc", BASELINE_BUDGET)):
        cfg = BaselineConfig(frame_hw=(h, w), patch=16, budget_patches=budget,
                             n_frames=n_frames)
        comp = get_compressor(name)(cfg, device=device)
        state, stats, _, _, secs = run_session(torch, comp, stream, device)
        tokens = comp.tokens(state, TOKENS)
        rp = comp.export(state)
        n_valid = int(rp.valid.sum())
        _need(int(stats.buffer_valid[-1]) == n_valid == min(
            cfg.capacity, int(state.cursor)) > 0,
            f"{name}: occupancy {int(stats.buffer_valid[-1])}, {n_valid} "
            f"valid, cursor {int(state.cursor)}")
        _need(int(state.frame_idx) == n_frames, f"{name}: frame clock "
              f"{int(state.frame_idx)}")
        _need(tuple(tokens.tokens.shape) == (TOKENS, 198) and
              int(tokens.mask.sum()) == min(TOKENS, n_valid)
              and bool(torch.isfinite(tokens.tokens).all()),
              f"{name}: tokens {tuple(tokens.tokens.shape)}")
        _need(all(t.device == device for t in (*rp[:4], state.cursor)),
              f"{name}: state left the card")
        # What each system reads out per frame (its schedule): SD a
        # downsampled frame, GC the crop, TD and FV whole frames.
        side = (comp._gg * cfg.patch if name == "sd" else
                comp._select_spec()[1]["crop"] if name == "gc" else h)
        stored = int(rp.memory_bytes())
        counters[name] = energy.StreamCounters(
            n_frames=n_frames, frame_px=side * side,
            n_processed=int(stats.processed.sum()), patch_px=256,
            stored_bytes=stored, h264=True)
        print(f"[12] {name}: {n_frames / secs:.1f} frames/s, retained "
              f"{n_valid} patches, {stored} bytes (Table-1 record), tokens "
              f"{tuple(tokens.tokens.shape)} with {int(tokens.mask.sum())} "
              f"valid")
    etokens = ecomp.tokens(estate, TOKENS)
    _need(bool(torch.isfinite(etokens.tokens).all()), "epic: tokens")
    epic_c = pipe.stream_counters(ecomp.cfg, estats)
    _need(epic_c.n_processed == int(estats.processed.sum()) and
          epic_c.depth_macs == pipe.depth_mod_macs() * epic_c.n_processed,
          "epic: stream_counters disagree with the stats")
    print(f"[12] epic (int8 depth): retained "
          f"{int(ecomp.export(estate).valid.sum())} patches, "
          f"{int(ecomp.export(estate).memory_bytes())} bytes (Table-1 "
          f"record), {epic_c.stored_bytes} bytes as DC entries; tokens "
          f"{tuple(etokens.tokens.shape)} with {int(etokens.mask.sum())} "
          f"valid; counters {epic_c}")
    fvs = energy.StreamCounters(
        n_frames=n_frames, frame_px=h * w, n_processed=n_frames,
        stored_bytes=n_frames * h * w * ret.RGB_BYTES_PER_PX, h264=True,
        patch_px=256)
    systems = {"FVS": fvs, "SDS": counters["sd"], "TDS": counters["td"],
               "GCS": counters["gc"], "EPIC+GPU": epic_c, "EPIC+Acc": epic_c,
               "EPIC+Acc+InSensor": epic_c}
    e_fvs = energy.total_energy("FVS", fvs)
    m_fvs = energy.memory_footprint_bytes(fvs)
    for system, c in systems.items():
        e = energy.total_energy(system, c)
        m = energy.memory_footprint_bytes(c)
        _need(e > 0 and m > 0, f"{system}: energy {e}, memory {m}")
        print(f"[12] Figure 6 {system}: energy {e * 1e3:.4f} mJ, memory "
              f"{m} bytes; FVS / {system}: energy {e_fvs / e:.2f}x, memory "
              f"{m_fvs / m:.2f}x")


# ---------------------------------------------------------------------------
# Phases 13-14: the scan kernels against their plain version; times.
# ---------------------------------------------------------------------------


def rwkv_inputs(torch, device, b, h, t, dk, dv, dtype, seed, strong=False,
                native=False):
    """The reference test's draws (tests/test_kernels.py:205-215), on the
    card; ``strong`` takes w_log = -exp(2 z).  ``native`` lays r, k, v,
    w_log out as the model hands them over: (B, T, H, .) seen as
    (B, H, T, .)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*shape):
        if native:
            return torch.randn(shape[0], shape[2], shape[1], shape[3],
                               generator=g, device=device).transpose(1, 2)
        return torch.randn(*shape, generator=g, device=device)

    r, k, v = 0.5 * n(b, h, t, dk), 0.5 * n(b, h, t, dk), 0.5 * n(b, h, t, dv)
    z = n(b, h, t, dk)
    w = -torch.exp(2.0 * z) if strong else -torch.exp(0.5 * z - 2.0)
    u = 0.3 * torch.randn(h, dk, generator=g, device=device)
    return [x.to(dtype) for x in (r, k, v, w, u)]


def ssd_inputs(torch, device, b, h, t, p, n, dtype, seed, strong=False,
               native=False):
    """The reference test's draws (tests/test_kernels.py:241-247);
    ``native`` lays x and a_log out as the model hands them over."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    if native:
        x, z = (0.5 * rn(b, t, h, p).transpose(1, 2),
                rn(b, t, h).transpose(1, 2))
    else:
        x, z = 0.5 * rn(b, h, t, p), rn(b, h, t)
    a = -torch.exp(2.0 * z) if strong else -torch.exp(0.5 * z - 2.0)
    return [y.to(dtype) for y in (x, a, 0.5 * rn(b, t, n), 0.5 * rn(b, t, n))]


def phase_scans(torch, device):
    """Returns the largest |kernel - plain| of each kernel at its model's
    full-width shape, in the path's dtype (RWKV6 bf16, SSD float32) and
    layout ((B, T, H, .) seen transposed), as the models hand them over."""
    from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_ref
    from repro_torch.kernels.rwkv6_scan.chunked import rwkv6_scan_chunked
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    f32, bf16 = torch.float32, torch.bfloat16
    ops = {"rwkv6_scan_pallas": (rwkv_inputs, rwkv6_scan_pallas,
                                 rwkv6_scan_chunked, rwkv6_scan_ref, bf16),
           "mamba2_ssd_pallas": (ssd_inputs, mamba2_ssd_pallas,
                                 mamba2_ssd_chunked, mamba2_ssd_ref, f32)}
    cases = []
    for name, shapes, full in (("rwkv6_scan_pallas", RWKV_TEST_SHAPES,
                                RWKV_FULL),
                               ("mamba2_ssd_pallas", SSD_TEST_SHAPES,
                                SSD_FULL)):
        for shape in shapes:
            for strong in (False, True):
                cases.append((name, shape, f32, strong, False))
        for dtype in (f32, bf16):
            for strong in (False, True):
                for native in (False, True):
                    cases.append((name, full, dtype, strong, native))
    main_err = {}
    for i, (name, shape, dtype, strong, native) in enumerate(cases):
        make, kernel, chunked, ref, path_dtype = ops[name]
        *dims, chunk = shape
        args = make(torch, device, *dims, dtype, SEED + i, strong, native)
        out, state = kernel(*args, chunk=chunk)
        torch.cuda.synchronize()
        _need(out.dtype == torch.float32 and bool(torch.isfinite(out).all())
              and bool(torch.isfinite(state).all()),
              f"{name} {shape}: output {out.dtype}, not finite")
        _need(out.transpose(1, 2).is_contiguous(),
              f"{name} {shape}: the output is not a view of a (B, T, H, .) "
              f"buffer")
        p_out, p_state = chunked(*args, chunk=chunk)
        err = max(float((out - p_out).abs().max()),
                  float((state - p_state).abs().max()))
        line = (f"[13] {name} {tuple(dims)} chunk {chunk} "
                f"{str(dtype).split('.')[1]}{' strong decay' if strong else ''}"
                f"{' (B,T,H,.) layout' if native else ''}"
                f": kernel vs plain max|err| {err:.3g} (tol {SCAN_TOL})")
        _need(err <= SCAN_TOL, line)
        if shape not in (RWKV_FULL, SSD_FULL):
            r_out, r_state = ref(*args)
            ref_err = max(float((out - r_out).abs().max()),
                          float((state - r_state).abs().max()))
            line += f", vs the sequential oracle {ref_err:.3g}"
            _need(ref_err <= SCAN_TOL, line)
        print(line)
        if native and dtype == path_dtype and not strong:
            main_err[name] = err
    return main_err


def rwkv_bound(b, h, t, dk, dv, c, elem_bytes):
    """Least time of one RWKV6 scan: ``(ms, "bytes" | "operations",
    flop, bytes)``.  r, k, w_log, v read once in their type, u as float32,
    o and S written once as float32; 2 FLOP per multiply-add of the
    products the chunked form needs, at the float32 peak (no tensor
    cores): the intra-chunk r k^T and A v over the C (C + 1) / 2 pairs
    s <= t (the diagonal is the bonus), r~ S and k^T v over K x V."""
    nbytes = (3 * dk + dv) * b * h * t * elem_bytes + 4 * h * dk + 4 * (
        b * h * t * dv + b * h * dk * dv)
    pairs = c * (c + 1) // 2
    flop = b * h * (t // c) * (2 * pairs * (dk + dv) + 4 * c * dk * dv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, flop, nbytes


def ssd_bound(b, h, t, p, n, c, elem_bytes):
    """Least time of one SSD scan, as :func:`rwkv_bound`: x, a_log, B, C
    read once, y and h written once as float32; C B^T over the C (C + 1) / 2
    pairs s <= t once per batch row and chunk (B and C are shared by the
    heads), and per head M x over those pairs, C h and B^T x over N x P."""
    nbytes = (b * h * t * p + b * h * t + 2 * b * t * n) * elem_bytes + 4 * (
        b * h * t * p + b * h * n * p)
    pairs = c * (c + 1) // 2
    flop = b * (t // c) * (2 * pairs * n
                           + h * (2 * pairs * p + 4 * c * n * p))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOP_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, flop, nbytes


def ssd_tensor_core_bound(b, h, t, p, n, c, elem_bytes):
    """The SSD function's floor on the tensor cores (the kernel's header):
    the three TF32 products of 3xTF32 at 495 TFLOP/s, or the function's
    own bytes (:func:`ssd_bound`); and the bytes this design moves besides:
    the chunk states through device memory (written, read and overwritten
    with the incoming states, read) and a second read of x.  Returns
    ``(ms, "bytes" | "operations", design_ms)``."""
    _, _, flop, nbytes = ssd_bound(b, h, t, p, n, c, elem_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flop / TF32_FLOP_PER_S * 1e3
    states = 4 * b * h * (t // c) * n * p
    design = nbytes + 4 * states + b * h * t * p * elem_bytes
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, design / HBM_BYTES_PER_S * 1e3


def rwkv_tensor_core_bound(b, h, t, dk, dv, c, elem_bytes, leaf=8):
    """The RWKV6 function's floor on the tensor cores (the kernel's
    header), as :func:`ssd_tensor_core_bound`: the three TF32 products of
    3xTF32 at 495 TFLOP/s, or the function's own bytes
    (:func:`rwkv_bound`); and what this design adds: the chunk states
    through device memory (written, read and overwritten with the incoming
    states, read) and a second read of k, v and w_log; and its
    exponentials, one MUFU.EX2 each at 16 a clock per SM (132 SMs at the
    H100 SXM's 1.98 GHz boost clock): per chunk k exp(W_C - W), exp(W_C),
    r exp(We), the operands of each level of products between leaves of
    ``leaf`` rows, and the pairs within each leaf.  Returns ``(ms, "bytes"
    | "operations", design_ms, exponentials, exp_ms)``."""
    _, _, flop, nbytes = rwkv_bound(b, h, t, dk, dv, c, elem_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flop / TF32_FLOP_PER_S * 1e3
    states = 4 * b * h * (t // c) * dk * dv
    design = nbytes + 4 * states + (2 * dk + dv) * b * h * t * elem_bytes
    levels = max(0, (-(-c // leaf) - 1).bit_length())
    pairs = sum(n * (n - 1) // 2 for n in
                (min(leaf, c - i) for i in range(0, c, leaf)))
    exps = b * h * (t // c) * dk * (2 * c + 1 + levels * c + pairs)
    exp_ms = exps / (16 * 132 * 1.98e9) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return (max(t_bytes, t_ops), by, design / HBM_BYTES_PER_S * 1e3, exps,
            exp_ms)


def phase_scan_times(torch, device):
    """Kernel and plain times at the full-width shapes, in the dtype and
    layout each model hands its scan (RWKV6 bf16, SSD float32)."""
    from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.rwkv6_scan.chunked import rwkv6_scan_chunked
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas

    times = {}
    for name, make, kernel, chunked, shape, dtype, bound_fn in (
            ("rwkv6_scan_pallas", rwkv_inputs, rwkv6_scan_pallas,
             rwkv6_scan_chunked, RWKV_FULL, torch.bfloat16, rwkv_bound),
            ("mamba2_ssd_pallas", ssd_inputs, mamba2_ssd_pallas,
             mamba2_ssd_chunked, SSD_FULL, torch.float32, ssd_bound)):
        *dims, chunk = shape
        args = make(torch, device, *dims, dtype, SEED, native=True)
        ms = device_ms(torch, lambda: kernel(*args, chunk=chunk), per_graph=5,
                       replays=10)
        plain_ms = device_ms(torch, lambda: chunked(*args, chunk=chunk),
                             per_graph=2, replays=5)
        elem = torch.finfo(dtype).bits // 8
        bound_ms, bound_by, flop, nbytes = bound_fn(*dims, chunk, elem)
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None)
        if name == "mamba2_ssd_pallas":
            tc_ms, tc_by, design_ms = ssd_tensor_core_bound(*dims, chunk,
                                                            elem)
            exps = ""
        else:
            tc_ms, tc_by, design_ms, n_exp, exp_ms = rwkv_tensor_core_bound(
                *dims, chunk, elem)
            exps = (f"; its {n_exp / 1e6:.1f} M exponentials "
                    f"{exp_ms * 1e3:.2f} us")
        extra = (f"; the function's floor on the tensor cores (3xTF32) "
                 f"{tc_ms * 1e3:.2f} us ({tc_by}), kernel "
                 f"{ms / tc_ms:.2f}x it; this design's bytes (the chunk "
                 f"states through device memory) {design_ms * 1e3:.2f} us"
                 + exps)
        print(f"[14] {name}: {tuple(dims)} chunk {chunk} "
              f"{str(dtype).split('.')[1]}: kernel {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({bound_by}: {flop / 1e9:.3f} GFLOP at 67 TFLOP/s f32, "
              f"{nbytes / 1e6:.1f} MB at 3.35 TB/s){extra}; kernel at "
              f"{flop / (ms * 1e-3) / 1e12:.2f} TFLOP/s; no single PyTorch "
              f"call computes this op")
    return times


# ---------------------------------------------------------------------------
# Phase 15: the RWKV6 and hybrid answer paths.
# ---------------------------------------------------------------------------


def recurrent_run(torch, device, arch, scan_backend, dtype, wrappers,
                  n_layers=None, attn_backend="ref"):
    """``arch`` on ``scan_backend`` (and, for the hybrid's shared
    attention, ``attn_backend``) with all dtypes ``dtype`` (``n_layers``
    cuts the depth): a warm-up prefill, then (counts set to 0) a timed
    prefill and ``SSM_NEW`` greedy tokens.  Returns the results."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.efm import (greedy_decode_loop, jit_prefill,
                                       pad_for_decode)

    cfg = get_config(arch).replace(param_dtype=dtype, compute_dtype=dtype,
                                   cache_dtype=dtype,
                                   attn_backend=attn_backend)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = build_model(cfg, device=device, scan_backend=scan_backend)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (EFM_BATCH, EFM_PROMPT)), device=device)}
    prefill = jit_prefill(model)
    steps = []

    def decode_step(p, c, t, pos):
        logits, c = model.decode_step(p, c, t, pos)
        steps.append(logits[:, -1].float().clone())
        return logits, c

    recording = dataclasses.replace(model, decode_step=decode_step)

    prefill(params, batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    prefill_state = {k: v.clone() for k, v in state.items()}
    state = pad_for_decode(model, state, SSM_NEW)
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    out, state = greedy_decode_loop(recording, params, state, first,
                                    EFM_PROMPT, SSM_NEW)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decode_launches = {k: w.launches - launches[k]
                       for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()

    label = f"{arch} {dtype} scan_backend={scan_backend!r}"
    if attn_backend != "ref":
        label += f" attn_backend={attn_backend!r}"
    _need(tuple(logits.shape) == (EFM_BATCH, 1, cfg.vocab)
          and logits.dtype == torch.float32,
          f"{label}: logits {tuple(logits.shape)} {logits.dtype}")
    _need(tuple(out.shape) == (EFM_BATCH, SSM_NEW + 1)
          and int(out.min()) >= 0 and int(out.max()) < cfg.vocab,
          f"{label}: tokens {tuple(out.shape)}")
    step_logits = torch.stack(steps)
    _need(bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(step_logits).all()),
          f"{label}: non-finite logits")
    _need(all(v.device == device and (not v.dtype.is_floating_point
                                      or bool(torch.isfinite(v).all()))
              for v in state.values()), f"{label}: serve state")
    _need(not any(decode_launches.values()),
          f"{label}: decode launched {decode_launches}")
    depth = "" if n_layers is None else f" (depth cut to {n_layers})"
    print(f"[15] {label}{depth}: prefill {EFM_BATCH}x{EFM_PROMPT} tokens "
          f"in {t_prefill * 1e3:.2f} ms ({EFM_BATCH * EFM_PROMPT / t_prefill:.0f}"
          f" tokens/s), decode {SSM_NEW} steps in {t_decode * 1e3:.2f} ms "
          f"({t_decode / SSM_NEW * 1e3:.2f} ms/step, "
          f"{EFM_BATCH * SSM_NEW / t_decode:.1f} tokens/s), peak memory "
          f"{peak / 2**30:.2f} GiB; launches in prefill "
          f"{ {k: v for k, v in launches.items() if v} }")
    result = dict(logits=logits[:, -1], steps=step_logits, tokens=out,
                  launches=launches, state=prefill_state)
    del params, state, model, recording
    torch.cuda.empty_cache()
    return result


def profile_recurrent(torch, device, arch, attn_backend="ref"):
    """Phase 15's bf16 ``"pallas"`` run of ``arch`` under
    ``torch.profiler``, as phase 8 profiles TinyLlama's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.efm import (greedy_decode_loop, jit_prefill,
                                       pad_for_decode)

    cfg = get_config(arch).replace(attn_backend=attn_backend)
    model = build_model(cfg, device=device, scan_backend="pallas")
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (EFM_BATCH, EFM_PROMPT)), device=device)}
    prefill = jit_prefill(model)
    logits, state = prefill(params, batch)
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)

    def run_decode():
        fresh = pad_for_decode(model, {k: v.clone() for k, v in
                                       state.items()}, SSM_NEW)
        greedy_decode_loop(model, params, fresh, first, EFM_PROMPT, SSM_NEW)

    attn = "" if attn_backend == "ref" else f", attention {attn_backend}"
    profile_steps(torch, f"[15] {arch} bf16 pallas{attn}", (
        ("prefill", lambda: prefill(params, batch), 1, "prefill"),
        ("decode", run_decode, SSM_NEW, "step")),
        focus=(("ssd_", "fa_tf32") if arch == HYBRID else ("rwkv_",)))
    del params, state, model
    torch.cuda.empty_cache()


def compare_runs(torch, kern, plain, label, dtype):
    """Phase 15's agreement of two runs: in float32 logits, decode logits
    and serve state (relative to its scale) within 1e-3 and the same
    greedy tokens or flips traced to a margin within it; in bf16 the
    prefill logits within 0.5 and every differing token traced to a top-2
    margin within 0.5 (phase 7's rule)."""
    err = float((kern["logits"] - plain["logits"]).abs().max())
    if dtype == "float32":
        step_err = float((kern["steps"] - plain["steps"]).abs().max())
        state_err = {}
        for k, v in kern["state"].items():
            if v.dtype.is_floating_point:
                scale = max(1.0, float(plain["state"][k].abs().max()))
                state_err[k] = float(
                    (v - plain["state"][k]).abs().max()) / scale
            else:
                _need(torch.equal(v, plain["state"][k]),
                      f"{label}: {k} differs between the runs")
        notes = trace_token_flips(kern, plain, label, F32_LOGIT_TOL)
        _need(max(err, step_err, *state_err.values()) <= F32_LOGIT_TOL,
              f"{label}: logits {err}, decode {step_err}, state (relative "
              f"to its scale) {state_err} > {F32_LOGIT_TOL}")
        print(f"[15] {label}: max|d logits| prefill {err:.3g}, decode "
              f"steps {step_err:.3g}, serve state (over its scale) "
              + ", ".join(f"{k} {e:.3g}" for k, e in state_err.items())
              + f" (tol {F32_LOGIT_TOL}); greedy tokens "
              + ("equal" if not notes else "; ".join(notes)))
    else:
        _need(err <= BF16_LOGIT_TOL, f"{label}: prefill logits differ by "
              f"{err} > {BF16_LOGIT_TOL}")
        notes = trace_token_flips(kern, plain, label)
        n_diff = int((kern["tokens"] != plain["tokens"]).sum())
        print(f"[15] {label}: max|d logits| prefill {err:.3g} (tol "
              f"{BF16_LOGIT_TOL}); greedy tokens "
              f"{'equal' if not n_diff else f'{n_diff} differ'}"
              + "".join(f"; {n}" for n in notes))


def phase_recurrent(torch, device, wrappers):
    """Both models on both scan backends, and the hybrid with its shared
    attention on the flash kernel; returns each kernel's launches in its
    model's bf16 ``"pallas"`` prefill."""
    from repro_torch.configs import get_config

    launches = {}
    for arch, (kernel, cut) in SSM_ARCHS.items():
        for dtype, n_layers in (("bfloat16", None), ("float32", cut)):
            kern = recurrent_run(torch, device, arch, "pallas", dtype,
                                 wrappers, n_layers)
            plain = recurrent_run(torch, device, arch, "chunked", dtype,
                                  wrappers, n_layers)
            cfg = get_config(arch)
            depth = n_layers or cfg.n_layers
            _need(kern["launches"][kernel] == depth,
                  f"{arch} {dtype}: {kern['launches'][kernel]} {kernel} "
                  f"launches in one prefill, not {depth}")
            _need(not any(plain["launches"].values())
                  and sum(kern["launches"].values()) == depth,
                  f"{arch} {dtype}: other kernels launched: "
                  f"{kern['launches']}, {plain['launches']}")
            what = f"{arch} {dtype}" + (f", {depth} layers"
                                        if n_layers else "")
            compare_runs(torch, kern, plain, f"{what} pallas vs chunked",
                         dtype)
            if dtype == "bfloat16":
                launches[kernel] = kern["launches"][kernel]
                profile_recurrent(torch, device, arch)
            if arch != HYBRID:
                continue
            # The shared attention on the 3xTF32 flash kernel (head dim
            # 160), held to the run above with attention on "ref".
            attn = recurrent_run(torch, device, arch, "pallas", dtype,
                                 wrappers, n_layers, attn_backend="pallas")
            n_inv = depth // cfg.shared_attn_period
            flash = attn["launches"]["flash_attention_pallas"]
            _need(flash == n_inv and attn["launches"][kernel] == depth
                  and sum(attn["launches"].values()) == depth + n_inv,
                  f"{arch} {dtype} attn_backend='pallas': launches "
                  f"{attn['launches']}, not {n_inv} flash and {depth} "
                  f"{kernel}")
            compare_runs(torch, attn, kern, f"{what} attention pallas vs "
                         f"ref", dtype)
            if dtype == "bfloat16":
                launches["flash_attention_pallas/tf32_d160"] = flash
                profile_recurrent(torch, device, arch, attn_backend="pallas")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: the rest of the zoo: MoE/MLA, VLM, encoder-decoder.
# ---------------------------------------------------------------------------


def zoo_tokens(torch, device, vocab):
    """Phase 7's prompts: EFM_BATCH x EFM_PROMPT seeded token ids."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return torch.as_tensor(rng.integers(0, vocab, (EFM_BATCH, EFM_PROMPT)),
                           device=device)


def zoo_decode_start(torch, model, batch, logits, state):
    """Where greedy decoding starts: after the prompt from its argmax,
    with room for ``ZOO_NEW`` tokens (``pad_for_decode``); for the
    encoder-decoder (its prefill runs the encoder only and returns no
    logits) at position 0 from the prompt's first token, against a fresh
    copy of the empty self-cache."""
    from repro_torch.serve.efm import pad_for_decode

    if logits is None:
        fresh = {k: v.clone() for k, v in state.items()}
        return fresh, batch["tokens"][:, :1].to(torch.int32), 0
    first = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return (pad_for_decode(model, state, ZOO_NEW), first,
            batch["tokens"].shape[1])


def zoo_run(torch, model, params, batch, wrappers, label, card):
    """A warm-up prefill, then (counts set to 0) a timed prefill and
    ``ZOO_NEW`` greedy tokens (``zoo_decode_start``).  Returns the
    results and readings."""
    import dataclasses

    from repro_torch.serve.efm import greedy_decode_loop, jit_prefill

    cfg = model.cfg
    prefill = jit_prefill(model)
    steps = []

    def decode_step(p, c, t, pos):
        logits, c = model.decode_step(p, c, t, pos)
        steps.append(logits[:, -1].float().clone())
        return logits, c

    recording = dataclasses.replace(model, decode_step=decode_step)
    prefill(params, batch)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    logits, state = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    b, s = batch["tokens"].shape
    _need(logits is None if cfg.family == "encdec" else (
        tuple(logits.shape) == (b, 1, cfg.vocab)
        and logits.dtype == torch.float32
        and bool(torch.isfinite(logits).all())),
        f"{label}: prefill logits")
    state, first, start = zoo_decode_start(torch, model, batch, logits,
                                           state)
    t0 = time.perf_counter()
    out, state = greedy_decode_loop(recording, params, state, first, start,
                                    ZOO_NEW)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    decode_launches = {k: w.launches - launches[k]
                       for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    step_logits = torch.stack(steps)
    _need(tuple(out.shape) == (b, ZOO_NEW + 1) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab, f"{label}: tokens {out.shape}")
    _need(bool(torch.isfinite(step_logits).all()),
          f"{label}: non-finite decode logits")
    _need(not any(decode_launches.values()),
          f"{label}: decode launched {decode_launches}")
    print(f"[18] {label}: prefill {b}x{s} tokens in {t_prefill * 1e3:.2f} "
          f"ms ({b * s / t_prefill:.0f} tokens/s), decode {ZOO_NEW} steps "
          f"from position {start} in {t_decode * 1e3:.2f} ms "
          f"({t_decode / ZOO_NEW * 1e3:.2f} ms/step, "
          f"{b * ZOO_NEW / t_decode:.1f} tokens/s), peak memory "
          f"{peak / 2**30:.2f} GiB; launches in prefill "
          f"{ {k: v for k, v in launches.items() if v} }; {card}")
    return dict(logits=None if logits is None else logits[:, -1],
                steps=step_logits, tokens=out, launches=launches,
                prefill_ms=t_prefill * 1e3, decode_ms=t_decode * 1e3)


def hold_zoo(kern, plain, label, dtype):
    """Phase 7's rules for two runs of one model: in float32 the prefill
    logits and every decode step's within ``F32_LOGIT_TOL``, in bf16 the
    prefill logits within ``BF16_LOGIT_TOL``; a differing greedy token
    traced to a top-2 margin within the tolerance in both runs."""
    tol = F32_LOGIT_TOL if dtype == "float32" else BF16_LOGIT_TOL
    errs = {}
    if kern["logits"] is not None:
        errs["prefill"] = float((kern["logits"] - plain["logits"]).abs().max())
    if dtype == "float32":
        errs["decode"] = float((kern["steps"] - plain["steps"]).abs().max())
    _need(all(e <= tol for e in errs.values()),
          f"{label}: max|d logits| {errs} > {tol}")
    notes = trace_token_flips(kern, plain, label, tol)
    n_diff = int((kern["tokens"] != plain["tokens"]).sum())
    held = ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
    print(f"[18] {label}: "
          + (f"max|d logits| {held} (tol {tol}); " if held else "")
          + "greedy tokens "
          + (f"{n_diff} differ" if n_diff else "equal")
          + "".join(f"; {n}" for n in notes))


def profile_zoo(torch, model, params, batch, label, card, focus=(),
                ranges=()):
    """A bf16 prefill and its decode steps under ``torch.profiler``, as
    phase 8 profiles TinyLlama's."""
    from repro_torch.serve.efm import greedy_decode_loop, jit_prefill

    prefill = jit_prefill(model)
    logits, state = prefill(params, batch)

    def run_decode():
        fresh, first, start = zoo_decode_start(torch, model, batch, logits,
                                               state)
        greedy_decode_loop(model, params, fresh, first, start, ZOO_NEW)

    profile_steps(torch, f"[18] {label} ({card})", (
        ("prefill", lambda: prefill(params, batch), 1, "prefill"),
        ("decode", run_decode, ZOO_NEW, "step")), focus=focus, ranges=ranges)


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def phase_zoo_moe(torch, device, wrappers, card):
    """(a) DeepSeek-V2-Lite-16B at full width in bf16 on ``"chunked"``
    and ``"ref"`` MLA, the two backends held on the first MoE layer's
    prefill input, its readings and profile; float32 at a cut depth,
    decode against forward."""
    from torch.profiler import record_function

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, deepseek, mla, moe
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve.efm import pad_for_decode

    cfg = get_config(ZOO_MOE)
    tokens = zoo_tokens(torch, device, cfg.vocab)
    batch = {"tokens": tokens}
    params = build_model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(SEED))
    models = {b: build_model(cfg.replace(attn_backend=b), device=device)
              for b in ("chunked", "ref")}
    runs = {b: zoo_run(torch, m, params, batch, wrappers,
                       f"{ZOO_MOE} bf16 attn_backend={b!r}", card)
            for b, m in models.items()}
    _need(not any(sum(r["launches"].values()) for r in runs.values()),
          f"{ZOO_MOE}: a kernel launched; MLA and MoE have none")
    kern = runs["chunked"]
    # Routing is a discrete decision on margins of ~1e-4 in probability
    # (64 experts near 1/64 each with random weights), which bf16
    # rounding crosses: the two attention backends route hundreds of
    # tokens a layer differently, so end to end their logits are a
    # reading.  MLA's backends are held on one layer's real input below.
    print(f"[18] {ZOO_MOE} bf16 chunked vs ref end to end (routed freely; "
          f"a reading, not held): max|d logits| prefill "
          f"{float((kern['logits'] - runs['ref']['logits']).abs().max()):.3g}"
          f", greedy tokens "
          f"{int((kern['tokens'] != runs['ref']['tokens']).sum())} of "
          f"{kern['tokens'].numel()} differ")
    phase_moe_determinism(torch, models["chunked"], params, batch, card)

    # The first MoE layer on the prefill's hidden state: MLA on "chunked"
    # against "ref", then the router's loads against the capacity.
    with torch.no_grad():
        x = L.embed(params["embed"], tokens, cfg.cdt)
        for i in range(cfg.first_k_dense):
            x = deepseek._dense_block(cfg, layer_params(
                params["dense_layers"], i), x)
        lp = layer_params(params["moe_layers"], 0)
        h = L.rmsnorm(lp["ln1"], x)
        attn = {b: mla.mla_full(lp["attn"], h, m.cfg).float()
                for b, m in models.items()}
        x = x + attn["chunked"].to(x.dtype)
        h = L.rmsnorm(lp["ln2"], x).reshape(-1, cfg.d_model)
        _, eids, _ = moe._route(lp["moe"], h, cfg)
    scale = float(attn["ref"].abs().max())
    err = float((attn["chunked"] - attn["ref"]).abs().max())
    _need(err <= MLA_BF16_TOL * scale, f"{ZOO_MOE} first MoE layer: MLA "
          f"chunked vs ref {err} > {MLA_BF16_TOL} x max|ref| {scale}")
    print(f"[18] {ZOO_MOE} bf16 first MoE layer, prefill input "
          f"{tuple(tokens.shape)}: MLA chunked vs ref max|d| {err:.3g}, "
          f"{err / scale:.3g} of max|ref| {scale:.3g} (tol {MLA_BF16_TOL})")
    del attn, x

    # Readings: the cache a token, the capacity and the drops of the first
    # MoE layer at this prefill, the decode beside its bound.
    serve = models["chunked"].init_serve(1, 1)
    per_token = tree_bytes(serve)
    full_kv = (cfg.n_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim
                              + cfg.v_head_dim) * 2 * cfg.n_layers)
    print(f"[18] {ZOO_MOE}: cache {per_token} bytes a token (MLA, "
          f"(kv_lora {cfg.kv_lora_rank} + rope {cfg.qk_rope_dim}) x 2 B x "
          f"{cfg.n_layers} layers), decompressed K/V would take {full_kv} "
          f"({full_kv / per_token:.2f}x); {card}")
    c = moe.moe_capacity(cfg, h.shape[0])
    loads = torch.bincount(eids.flatten(), minlength=cfg.moe_experts)
    n_assign = eids.numel()
    dropped = int(torch.clamp(loads - c, min=0).sum())
    print(f"[18] {ZOO_MOE} prefill, first MoE layer: T {h.shape[0]} tokens x "
          f"top-{cfg.moe_top_k} = {n_assign} assignments over "
          f"{cfg.moe_experts} experts, capacity C {c} (cf "
          f"{cfg.moe_capacity_factor}); loads min {int(loads.min())}, max "
          f"{int(loads.max())}; {dropped} dropped ({dropped / n_assign:.2%}); "
          f"{card}")
    experts = sum(tree_bytes(v) for k, v in params["moe_layers"][
        "moe"].items() if k.endswith("_w"))
    every = tree_bytes(params)
    step_ms = kern["decode_ms"] / ZOO_NEW
    print(f"[18] {ZOO_MOE} decode bound: every step runs all "
          f"{cfg.moe_experts} experts on C {moe.moe_capacity(cfg, EFM_BATCH)} "
          f"slots, reading {experts / 1e9:.2f} GB of expert weights "
          f"({experts / HBM_BYTES_PER_S * 1e3:.2f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) of {every / 1e9:.2f} GB of "
          f"parameters ({every / HBM_BYTES_PER_S * 1e3:.2f} ms); measured "
          f"{step_ms:.2f} ms/step ({every / HBM_BYTES_PER_S * 1e3 / step_ms:.1%}"
          f" of the bound); {card}")

    inner = moe._expert_ffn

    def marked(p, xg, cdt):
        with record_function("moe_expert_ffn"):
            return inner(p, xg, cdt)

    moe._expert_ffn = marked
    try:
        profile_zoo(torch, models["chunked"], params, batch,
                    f"{ZOO_MOE} bf16 chunked", card,
                    ranges=("moe_expert_ffn",))
    finally:
        moe._expert_ffn = inner
    del params, models, serve, h
    torch.cuda.empty_cache()

    # float32 at a cut depth: absorbed decode against the decompressed
    # forward, nothing dropped (the smoke config's capacity factor).
    f32 = cfg.replace(n_layers=cfg.first_k_dense + ZOO_F32_MOE,
                      param_dtype="float32", compute_dtype="float32",
                      cache_dtype="float32", moe_capacity_factor=8.0)
    params = build_model(f32, device=device).init(
        torch.Generator(device=device).manual_seed(SEED))
    errs = {}
    with torch.no_grad():
        fulls = {}
        for backend in ("chunked", "ref"):
            model = build_model(f32.replace(attn_backend=backend),
                                device=device)
            fulls[backend] = model.forward(params, batch)
        full = fulls["chunked"]
        errs["forward chunked vs ref"] = float(
            (full - fulls.pop("ref")).abs().max())
        logits, state = model.prefill(params, {"tokens": tokens[:, :-1]})
        state = pad_for_decode(model, state, 1)
        dec, _ = model.decode_step(params, state, tokens[:, -1:],
                                   EFM_PROMPT - 1)
    errs["prefill vs forward"] = float(
        (logits[:, -1] - full[:, -2]).abs().max())
    errs["decode vs forward"] = float((dec[:, -1] - full[:, -1]).abs().max())
    _need(all(e <= F32_LOGIT_TOL for e in errs.values()),
          f"{ZOO_MOE} float32: {errs} > {F32_LOGIT_TOL}")
    print(f"[18] {ZOO_MOE} float32, {f32.n_layers} layers (1 dense + "
          f"{ZOO_F32_MOE} MoE, cf 8, float32 cache): max|d logits| "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" (tol {F32_LOGIT_TOL})")
    del params, fulls, full, state
    torch.cuda.empty_cache()


def index_add_combine(torch, y, info, t, cdt):
    """The MoE combine before PR 27's: a bf16 ``index_add_`` scatter (on
    the card, atomics in no fixed order); timed beside the fixed-order
    one in 18a."""
    tok_by_slot, gate_by_slot, valid = info[:3]
    e, c, d = y.shape
    y_flat = y.reshape(e * c, d) * gate_by_slot[:, None].to(cdt)
    y_flat = torch.where(valid[:, None], y_flat, 0.0)
    return torch.zeros((t, d), dtype=cdt, device=y.device).index_add_(
        0, tok_by_slot.long(), y_flat)


def phase_moe_determinism(torch, model, params, batch, card):
    """18a: two more ``"chunked"`` prefills of the same prompts, the
    logits and the first MoE layer's routing (recorded at ``moe._route``)
    bitwise equal: the combine adds in a fixed order, with no atomics.
    Readings: the prefill with the fixed-order combine and with the
    ``index_add_`` scatter swapped in, in alternating pairs, and each
    combine alone at the first MoE layer's shapes (CUDA events)."""
    import statistics
    from unittest import mock

    from repro_torch.models import moe
    from repro_torch.serve.efm import jit_prefill

    prefill = jit_prefill(model)
    real_route = moe._route
    runs = []
    for _ in range(2):
        routes = []

        def route(p, x2, cfg):
            gates, eids, aux = real_route(p, x2, cfg)
            if not routes:  # the first MoE layer
                routes.append((gates.clone(), eids.clone()))
            return gates, eids, aux

        with mock.patch.object(moe, "_route", route):
            logits, _ = prefill(params, batch)
        torch.cuda.synchronize()
        runs.append((logits, *routes[0]))
    (l0, g0, e0), (l1, g1, e1) = runs
    same = {"logits": torch.equal(l0, l1), "gates": torch.equal(g0, g1),
            "expert ids": torch.equal(e0, e1)}
    _need(all(same.values()), f"18a: two runs of one {ZOO_MOE} prefill "
          f"differ: {same}, max|d logits| "
          f"{float((l0 - l1).abs().max()):.3g}")

    fixed = moe._combine
    combines = {"fixed order": fixed,
                "index_add_": lambda y, info, t, cdt: index_add_combine(
                    torch, y, info, t, cdt)}

    def timed(name):
        with mock.patch.object(moe, "_combine", combines[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(params, batch)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, logits

    times = {name: [] for name in combines}
    scatter = []
    for i in range(MOE_PAIRS):
        for name in (list(combines) if i % 2 == 0 else list(combines)[::-1]):
            ms, logits = timed(name)
            times[name].append(ms)
            if name == "index_add_" and len(scatter) < 2:
                scatter.append(logits)
    cfg = model.cfg
    gen = torch.Generator(device=l0.device).manual_seed(SEED)
    t = batch["tokens"].numel()
    x2 = torch.randn((t, cfg.d_model), generator=gen, device=l0.device)
    router = torch.randn((cfg.d_model, cfg.moe_experts), generator=gen,
                         device=l0.device) / math.sqrt(cfg.d_model)
    gates, eids, _ = moe._route({"router": router}, x2, cfg)
    c = moe.moe_capacity(cfg, t)
    _, info = moe._dispatch(x2, gates, eids, cfg.moe_experts, c)
    y = torch.randn((cfg.moe_experts, c, cfg.d_model), generator=gen,
                    device=l0.device).to(cfg.cdt)
    alone = {}
    for name, fn in combines.items():
        fn(y, info, t, cfg.cdt)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(MOE_COMBINE_CALLS):
            fn(y, info, t, cfg.cdt)
        end.record()
        torch.cuda.synchronize()
        alone[name] = start.elapsed_time(end) / MOE_COMBINE_CALLS
    print(f"[18a] {ZOO_MOE} bf16 chunked prefill, two runs: logits, the "
          f"first MoE layer's gates and expert ids bitwise equal "
          f"({tuple(e0.shape)} assignments); {card}")
    print(f"[18a] prefill ms in {MOE_PAIRS} alternating pairs: "
          + "; ".join(f"{k} median {statistics.median(v):.2f} ("
                      + ", ".join(f"{x:.2f}" for x in v) + ")"
                      for k, v in times.items())
          + f" (PR 24's reading with the scatter: 145-155 ms); two "
          f"index_add_ prefills bitwise equal: "
          f"{torch.equal(scatter[0], scatter[1])} (a reading); {card}")
    print(f"[18a] the combine alone at the first MoE layer's shapes "
          f"(y {tuple(y.shape)} bf16, {t} tokens, top-{cfg.moe_top_k}; CUDA "
          f"events over {MOE_COMBINE_CALLS} calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in alone.items())
          + f"; {card}")


def open_gates(torch, params, gen):
    """The VLM's tanh gates, 0 at init (which hides the image path),
    drawn from ``gen``: |gate| in [0.5, 1.5), either sign."""
    for key in ("gate_attn", "gate_mlp"):
        g = params["xattn_layers"][key]
        mag = torch.rand(g.shape, generator=gen, device=g.device) + 0.5
        sign = torch.randint(0, 2, g.shape, generator=gen,
                             device=g.device) * 2 - 1
        params["xattn_layers"][key] = (mag * sign).to(g.dtype)


def phase_zoo_vlm(torch, device, wrappers, epic, card):
    """(b) Llama-3.2-Vision-11B at full width in bf16 on ``"pallas"`` and
    ``"ref"``; the Figure-1 chain from phase 11's EPIC session; the
    profile; float32 at a cut depth.  Returns the flash launches of the
    bf16 and float32 ``"pallas"`` prefills."""
    from repro_torch.configs import get_config
    from repro_torch.core import packing
    from repro_torch.models import build_model, vision

    cfg = get_config(ZOO_VLM)
    g = vision.n_groups(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    tokens = zoo_tokens(torch, device, cfg.vocab)
    models = {b: build_model(cfg.replace(attn_backend=b), device=device)
              for b in ("pallas", "ref")}
    params = models["pallas"].init(gen)
    open_gates(torch, params, gen)
    img = torch.randn((EFM_BATCH, cfg.img_seq, cfg.d_model), generator=gen,
                      device=device)
    batch = {"tokens": tokens, "img_embed": img}
    runs = {b: zoo_run(torch, m, params, batch, wrappers,
                       f"{ZOO_VLM} bf16 attn_backend={b!r}, img_embed "
                       f"{tuple(img.shape)}", card) for b, m in models.items()}
    flash = runs["pallas"]["launches"]["flash_attention_pallas"]
    _need(flash == cfg.n_layers and sum(runs["pallas"]["launches"].values())
          == flash, f"{ZOO_VLM}: launches {runs['pallas']['launches']}, not "
          f"{cfg.n_layers} flash")
    _need(not any(runs["ref"]["launches"].values()),
          f"{ZOO_VLM}: the ref run launched {runs['ref']['launches']}")
    hold_zoo(runs["pallas"], runs["ref"],
             f"{ZOO_VLM} bf16 pallas vs ref", "bfloat16")

    # The Figure-1 chain (examples/serve_stream.py): EPIC's retained
    # patches as the cross-attention context.
    comp, state, _ = epic
    seq_len = comp.cfg.capacity
    stream = comp.tokens(state, seq_len)
    _need(tuple(stream.tokens.shape) == (seq_len, packing.TOKEN_FEAT)
          and bool(torch.isfinite(stream.tokens).all()),
          f"EPIC tokens {tuple(stream.tokens.shape)}")
    proj = torch.randn((packing.TOKEN_FEAT, cfg.d_model), generator=gen,
                       device=device) * FIG1_PROJ_SCALE
    img_epic = (stream.tokens @ proj).expand(EFM_BATCH, -1, -1).contiguous()
    fig = zoo_run(torch, models["pallas"], params,
                  {"tokens": tokens, "img_embed": img_epic}, wrappers,
                  f"{ZOO_VLM} bf16 pallas on EPIC's tokens, img_embed "
                  f"{tuple(img_epic.shape)}", card)
    _need(fig["launches"]["flash_attention_pallas"] == cfg.n_layers,
          f"Figure-1 chain: launches {fig['launches']}")

    def cross_bytes(n):
        return g * 2 * EFM_BATCH * cfg.n_kv_heads * n * cfg.head_dim_ * 2

    print(f"[18] Figure-1 chain: EPIC's int8 session (phase 11) gives N "
          f"{seq_len} tokens ({int(stream.mask.sum())} valid) of "
          f"{packing.TOKEN_FEAT} features, projected to d_model "
          f"{cfg.d_model} (seeded x {FIG1_PROJ_SCALE}), against img_seq "
          f"{cfg.img_seq}: cross-KV cache {cross_bytes(seq_len)} bytes at N, "
          f"{cross_bytes(cfg.img_seq)} at {cfg.img_seq} "
          f"({cfg.img_seq / seq_len:.2f}x); prefill {fig['prefill_ms']:.2f} "
          f"ms at N, {runs['pallas']['prefill_ms']:.2f} ms at "
          f"{cfg.img_seq}; decode {fig['decode_ms'] / ZOO_NEW:.2f} against "
          f"{runs['pallas']['decode_ms'] / ZOO_NEW:.2f} ms/step; {card}")
    profile_zoo(torch, models["pallas"], params, batch, f"{ZOO_VLM} bf16 "
                "pallas", card, focus=("fa_",))
    del params, models, img, img_epic, proj
    torch.cuda.empty_cache()

    # float32 at a cut depth: the flash kernel's 3xTF32 instance against
    # the masked softmax.
    f32 = cfg.replace(n_layers=ZOO_F32_GROUPS * cfg.cross_attn_period,
                      param_dtype="float32", compute_dtype="float32",
                      cache_dtype="float32")
    gen = torch.Generator(device=device).manual_seed(SEED)
    models = {b: build_model(f32.replace(attn_backend=b), device=device)
              for b in ("pallas", "ref")}
    params = models["pallas"].init(gen)
    open_gates(torch, params, gen)
    batch = {"tokens": tokens, "img_embed": torch.randn(
        (EFM_BATCH, cfg.img_seq, cfg.d_model), generator=gen, device=device)}
    f32_runs = {b: zoo_run(torch, m, params, batch, wrappers,
                           f"{ZOO_VLM} float32, {f32.n_layers} self layers, "
                           f"attn_backend={b!r}", card)
                for b, m in models.items()}
    f32_flash = f32_runs["pallas"]["launches"]["flash_attention_pallas"]
    _need(f32_flash == f32.n_layers, f"{ZOO_VLM} float32: {f32_flash} flash "
          f"launches, not {f32.n_layers}")
    hold_zoo(f32_runs["pallas"], f32_runs["ref"],
             f"{ZOO_VLM} float32 pallas vs ref", "float32")
    del params, models, batch
    torch.cuda.empty_cache()
    return flash, f32_flash


def encdec_forward(torch, model, params, batch, wrappers, label, card):
    """A warm-up forward, then (counts set to 0) a timed one; returns the
    logits and the flash launches."""
    with torch.no_grad():
        model.forward(params, batch)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        logits = model.forward(params, batch)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    b, s = batch["tokens"].shape
    _need(tuple(logits.shape) == (b, s, model.cfg.vocab)
          and bool(torch.isfinite(logits).all()), f"{label}: forward logits")
    print(f"[18] {label}: forward (encoder {tuple(batch['src_embed'].shape)}"
          f", decoder {b}x{s}) in {secs * 1e3:.2f} ms; launches {launches}; "
          f"{card}")
    return logits, launches.get("flash_attention_pallas", 0)


def phase_zoo_encdec(torch, device, wrappers, card):
    """(c) SeamlessM4T-large-v2 at full width in bf16: forward, prefill
    (the encoder and the cross cache) and greedy decode from position 0 on
    ``"pallas"`` and ``"ref"``, the profile; float32 at a cut depth.
    Returns the flash launches of the bf16 and float32 ``"pallas"``
    forwards."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, encdec

    cfg = get_config(ZOO_ENCDEC)
    launches = []
    for dtype, cut in (("bfloat16", None), ("float32", ZOO_F32_ENCDEC)):
        run_cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype,
                              cache_dtype=dtype)
        if cut:
            run_cfg = run_cfg.replace(n_layers=2 * cut, enc_layers=cut,
                                      dec_layers=cut)
        gen = torch.Generator(device=device).manual_seed(SEED)
        models = {b: build_model(run_cfg.replace(attn_backend=b),
                                 device=device) for b in ("pallas", "ref")}
        params = models["pallas"].init(gen)
        src = torch.randn((EFM_BATCH, encdec.src_len(cfg, EFM_PROMPT),
                           cfg.d_model), generator=gen, device=device)
        batch = {"tokens": zoo_tokens(torch, device, cfg.vocab),
                 "src_embed": src}
        what = f"{ZOO_ENCDEC} {dtype}" + (f", {cut} + {cut} layers"
                                          if cut else "")
        fwd, flash = {}, {}
        for b, m in models.items():
            fwd[b], flash[b] = encdec_forward(
                torch, m, params, batch, wrappers,
                f"{what} attn_backend={b!r}", card)
        n_layers = run_cfg.enc_layers + run_cfg.dec_layers
        _need(flash["pallas"] == n_layers and flash["ref"] == 0,
              f"{what}: flash launches {flash}, not {n_layers} and 0")
        tol = F32_LOGIT_TOL if cut else BF16_LOGIT_TOL
        err_all = float((fwd["pallas"] - fwd["ref"]).abs().max())
        err_last = float((fwd["pallas"][:, -1] - fwd["ref"][:, -1]).abs().max())
        held = err_all if cut else err_last
        _need(held <= tol, f"{what}: forward logits differ by {held} > {tol}")
        print(f"[18] {what} forward pallas vs ref: max|d logits| at the last "
              f"position {err_last:.3g}, at all {EFM_BATCH}x{EFM_PROMPT} "
              f"{err_all:.3g} (tol {tol} on the "
              f"{'all' if cut else 'last'})")
        del fwd
        runs = {b: zoo_run(torch, m, params, batch, wrappers,
                           f"{what} attn_backend={b!r}", card)
                for b, m in models.items()}
        _need(runs["pallas"]["launches"]["flash_attention_pallas"]
              == run_cfg.enc_layers, f"{what}: prefill launched "
              f"{runs['pallas']['launches']}, not {run_cfg.enc_layers} "
              f"(the encoder's, non-causal)")
        hold_zoo(runs["pallas"], runs["ref"],
                 f"{what} pallas vs ref", dtype)
        if not cut:
            profile_zoo(torch, models["pallas"], params, batch,
                        f"{what} pallas", card, focus=("fa_",))
        launches.append(flash["pallas"])
        del params, models, src, batch, runs
        torch.cuda.empty_cache()
    return tuple(launches)


def phase_zoo(torch, device, wrappers, epic, card):
    """Phase 18; returns the flash launches of its bf16 and float32
    ``"pallas"`` runs (the VLM's prefills, SeamlessM4T's forwards)."""
    phase_zoo_moe(torch, device, wrappers, card)
    vlm = phase_zoo_vlm(torch, device, wrappers, epic, card)
    ed = phase_zoo_encdec(torch, device, wrappers, card)
    print(f"[18] flash launches: {ZOO_VLM} prefill {vlm[0]} (float32 cut "
          f"{vlm[1]}), {ZOO_ENCDEC} forward {ed[0]} (float32 cut {ed[1]})")
    return {"flash_attention_pallas": vlm[0] + ed[0],
            "flash_attention_pallas/tf32": vlm[1] + ed[1]}


# ---------------------------------------------------------------------------
# Phase 16: multi-stream serving.
# ---------------------------------------------------------------------------


def slot_inputs(torch, device, slots, n, p=16, hw=128):
    """Phase 2's entries for ``slots`` slots, each with its own entries,
    transforms and frame (phase 2's frame rolled by the slot's index), the
    intrinsics shared: ``(args with a leading slot axis, intr)``."""
    per = []
    for s in range(slots):
        args, intr = make_inputs(torch, device, n, p, hw, SEED + 31 * s)
        args[4] = torch.roll(args[4], shifts=s, dims=1).contiguous()
        per.append(args)
    return [torch.stack(xs) for xs in zip(*per)], intr


def phase_serve_kernels(torch, device):
    """(a) The pool's launches at B = 32 slots: ``rm_fused`` and
    ``rm_scores`` (N = 192 entries a slot, 128x128 frames, window 32) and
    the fused int8 convolution with one scale per image (the depth
    network's eight layers, each slot's activations at another scale),
    each one launch under vmap and bitwise equal to per-slot launches;
    their times beside the plain version's (vmapped) and the bound (B
    times one slot's).  Returns ``(errs, times)`` of the two pool rows."""
    from repro_torch.core import depth as depth_mod
    from repro_torch.kernels.int8_matmul.qconv import (qconv_int8_pallas,
                                                       qconv_int8_ref)
    from repro_torch.kernels.reproject_match import fused, kernel, ref

    b, n = SERVE_SLOTS, 192
    args, intr = slot_inputs(torch, device, b, n)
    one = [x[0] for x in args]
    errs, times = {}, {}
    for name, wrapper, plain in (
            ("reproject_match_fused", fused.reproject_match_fused,
             lambda *a: fused.reproject_match_fused_ref(
                 *a, intr, window=32, tau=TAU, o_min=O_MIN, c_min=C_MIN)),
            ("reproject_match_pallas", kernel.reproject_match_pallas,
             lambda *a: ref.reproject_match_ref(*a, intr, 32))):
        def call(*a, wrapper=wrapper):
            if wrapper is fused.reproject_match_fused:
                return wrapper(*a, intr, window=32, tau=TAU, o_min=O_MIN,
                               c_min=C_MIN)
            return wrapper(*a, intr, window=32)

        batched_call = torch.func.vmap(call)
        plain_call = torch.func.vmap(plain)
        before = wrapper.launches
        got = batched_call(*args)
        torch.cuda.synchronize()
        _need(wrapper.launches == before + 1,
              f"{name}: {wrapper.launches - before} launches for {b} slots")
        for s in range(b):
            for x, y in zip(got, call(*(a[s] for a in args))):
                _need(torch.equal(x[s], y),
                      f"{name}: slot {s} of the batched launch differs from "
                      "its own launch")
        want = plain_call(*args)
        err = max(float((x - y).abs().max()) for x, y in
                  zip(got[:3], want[:3]))
        _need(err <= BBOX_TOL, f"{name}: batched launch vs plain {err}")
        ms = device_ms(torch, lambda: batched_call(*args), per_graph=20)
        plain_ms = device_ms(torch, lambda: plain_call(*args), per_graph=5,
                             replays=5)
        one_ms, bound_by = bound(one, name == "reproject_match_fused")
        launches, _ = device_launches_per_call(
            torch, lambda: batched_call(*args))
        _need(launches == 1, f"{name}: {launches} device launches for the "
              f"batched call")
        errs[name] = err
        times[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b * one_ms,
                           bound_by=bound_by)
        print(f"[16a] {name} at B={b} slots x N={n}: one launch, every slot "
              f"bitwise its own launch, max|err| vs plain {err:.3g}; "
              f"{ms * 1e3:.2f} us ({ms / b * 1e3:.3f} us a slot), plain "
              f"{plain_ms * 1e3:.1f} us, bound {b * one_ms * 1e3:.3f} us "
              f"({bound_by})")

    stream, _, models = main_path_inputs(torch, device, CHUNK)
    q = quantised_models(torch, device, models).depth_model
    rgb64 = depth_mod.resize_image(stream[0][:1], depth_mod.DEPTH_INPUT)
    _, convs = depth_operands(torch, q, rgb64)
    factors = torch.linspace(0.25, 4.0, b, device=device)
    ms = plain_ms = 0.0
    nbytes = nops = 0
    for (layer, m, k, nn), ((x, _, qw, wscale, bias), kw) in zip(
            DEPTH_GEMMS, convs):
        xs = (x[None] * factors[:, None, None, None, None]).contiguous()

        def conv(xi, qw=qw, wscale=wscale, bias=bias, kw=kw):
            return qconv_int8_pallas(xi, xi.abs().amax(), qw, wscale, bias,
                                     **kw)

        def conv_plain(xi, qw=qw, wscale=wscale, bias=bias, kw=kw):
            return qconv_int8_ref(xi, xi.abs().amax(), qw, wscale, bias,
                                  **kw)

        batched_call = torch.func.vmap(conv)
        before = qconv_int8_pallas.launches
        got = batched_call(xs)
        torch.cuda.synchronize()
        _need(qconv_int8_pallas.launches == before + 1,
              f"qconv {layer}: not one launch for {b} slots")
        for s in range(b):
            _need(torch.equal(got[s], conv(xs[s])),
                  f"qconv {layer}: slot {s} differs from its own launch")
        want = torch.func.vmap(conv_plain)(xs)
        _need(torch.equal(got, want),
              f"qconv {layer}: batched launch differs from plain")
        ms += device_ms(torch, lambda: batched_call(xs), per_graph=20)
        plain_ms += device_ms(torch, lambda: torch.func.vmap(conv_plain)(xs),
                              per_graph=5, replays=5)
        # Each image and its scale read once, each output written once,
        # the shared weights, scales and bias once.
        nbytes += b * (4 * x.numel() + 4 * m * nn + 4) + qw.numel() + 4 * (
            wscale.numel() + bias.numel())
        nops += 2 * b * m * k * nn
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / INT8_OP_PER_S * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    errs["int8_matmul_pallas/qconv"] = 0.0  # bitwise, checked above
    times["int8_matmul_pallas/qconv"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    print(f"[16a] qconv at B={b} slots, one scale per image (scales "
          f"0.25-4x apart), the 8 layers of one frame: 8 launches, every "
          f"slot bitwise its own launch and the plain version; "
          f"{ms * 1e3:.2f} us ({ms / b * 1e3:.3f} us a slot), plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})")
    # rm_scores is not on the pool's path (its backend is "fused"): its
    # numbers are printed above, its row stays phase 2's.
    del errs["reproject_match_pallas"], times["reproject_match_pallas"]
    return ({f"{k}/slots": v for k, v in errs.items()},
            {f"{k}/slots": v for k, v in times.items()})


def serve_feeds(torch, device, n, n_chunks, seed):
    """``n`` seeded 128x128 streams of ``n_chunks`` chunks each, on the
    card: lists of ``SensorChunk`` with the oracle depth track."""
    import numpy as np

    from repro_torch.api import SensorChunk
    from repro_torch.data import synthetic

    feeds = []
    for i in range(n):
        s, _ = synthetic.generate_stream(
            np.random.default_rng(seed + i),
            synthetic.StreamConfig(n_frames=n_chunks * CHUNK, hw=(128, 128)),
            device=device)
        feeds.append([SensorChunk(*(x[c * CHUNK:(c + 1) * CHUNK] for x in (
            s.frames, s.poses, s.gazes, s.depth))) for c in range(n_chunks)])
    return feeds


def serve_run(torch, device, models, founders, late, tiers=None,
              depth=True, on_tick=None):
    """The serving phase's schedule through ``StreamServer``: the founders
    admitted and streaming for half their chunks, then the first
    ``SERVE_CHURN`` of them closed and the late joiners admitted, and the
    rest streaming to the end.  Returns ``(server, served chunks by
    stream, seconds of each tick, rung groups dispatched)``: a rung group
    is one rung's body in a dispatch, which launches each kernel of the
    step once a frame for all its slots."""
    from repro_torch.api import EPICCompressor, SensorChunk
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve import ServerConfig, StreamServer

    cfg = pipe.EPICConfig(prefilter_k=SERVE_LADDER[0])
    srv = StreamServer(
        EPICCompressor(cfg, models, device=device),
        ServerConfig(capacity=SERVE_SLOTS, chunk_frames=CHUNK,
                     k_ladder=SERVE_LADDER, eviction="lru", tiers=tiers,
                     prewarm=tiers is not None))
    served = {}
    ticks = []
    groups = [0]
    rung_body = srv._rung_body

    def counted_body(k):  # called once for each rung of each dispatch
        groups[0] += 1
        return rung_body(k)

    srv._rung_body = counted_body

    def submit(sid, chunk):
        if not depth:
            chunk = SensorChunk(*chunk[:3])
        srv.submit(sid, chunk)
        served.setdefault(sid, []).append(chunk)

    half = SERVE_CHUNKS // 2
    for i in range(len(founders)):
        srv.admit(f"s{i}")
    for t in range(SERVE_CHUNKS):
        if t == half:
            for i in range(SERVE_CHURN):
                srv.close(f"s{i}")
            for j in range(len(late)):
                srv.admit(f"l{j}")
        for i, feed in enumerate(founders):
            if t < half or i >= SERVE_CHURN:
                submit(f"s{i}", feed[t])
        if t >= half:
            for j, feed in enumerate(late):
                submit(f"l{j}", feed[t - half])
        if on_tick is not None and on_tick(srv, t):
            continue
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        srv.tick()
        ticks.append(time.perf_counter() - t0)  # ends in the readback
    return srv, served, ticks, groups[0]


def compare_solo(torch, device, models, srv, served, label, exact):
    """Every live stream of ``srv`` against a solo ``EPICCompressor`` with
    the same ladder fed the chunks it was served: ``k_trajectory`` and the
    telemetry equal, and the state bitwise (``exact``) or its integer
    leaves equal and its float leaves within ``SERVE_FLOAT_TOL``; returns
    the largest float difference."""
    from repro_torch.api import EPICCompressor
    from repro_torch.core import pipeline as pipe

    cfg = pipe.EPICConfig(prefilter_k=SERVE_LADDER[0])
    worst, n_bitwise = 0.0, 0
    for sid in srv.live_sessions:
        solo = EPICCompressor(cfg, models, device=device,
                              k_ladder=SERVE_LADDER)
        state = solo.init()
        processed = inserted = 0
        for chunk in served[sid]:
            state, st = solo.step(state, chunk)
            processed += int(st.processed.sum())
            inserted += int(st.n_inserted.sum())
        tele = srv.telemetry(sid)
        _need(list(tele.k_trajectory) == list(solo.k_trajectory),
              f"{label} {sid}: k_trajectory {list(tele.k_trajectory)} vs "
              f"solo {list(solo.k_trajectory)}")
        _need((tele.n_processed, tele.n_inserted) == (processed, inserted),
              f"{label} {sid}: served counters differ from the solo run")
        mine = state_leaves(srv.state(sid))
        theirs = state_leaves(state)
        same = [torch.equal(a, b) for a, b in zip(mine, theirs)]
        n_bitwise += all(same)
        for i, (a, b, eq) in enumerate(zip(mine, theirs, same)):
            if a.dtype.is_floating_point:
                worst = max(worst, float((a - b).abs().max()))
            else:
                _need(eq, f"{label} {sid}: integer state leaf {i} differs "
                      "from solo")
        _need(not exact or all(same), f"{label} {sid}: state leaves "
              f"{[i for i, eq in enumerate(same) if not eq]} not bitwise "
              "the solo session's")
    _need(worst <= SERVE_FLOAT_TOL, f"{label}: a float state leaf differs "
          f"from solo by {worst:.3g} (limit {SERVE_FLOAT_TOL:g})")
    print(f"[16b] {label}: {len(srv.live_sessions)} live streams against "
          f"solo sessions: k_trajectory, counters and integer state equal, "
          f"{n_bitwise} bitwise, largest float difference {worst:.3g} "
          f"(limit {SERVE_FLOAT_TOL:g})")
    return worst


def phase_serve(torch, device, card):
    """(b) ``StreamServer`` over ``EPICCompressor(EPICConfig(), ...)`` at
    published widths, on the oracle, fp32 and int8 depth tracks, with a
    tiered run; (c) the readings.  Returns the pool rows' launches."""
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas
    from repro_torch.kernels.reproject_match import fused

    from repro_torch.core import pipeline as pipe

    _, _, models = main_path_inputs(torch, device, CHUNK)
    # The oracle track runs no network (the chunk's depth, every patch
    # salient): cuDNN may convolve a frame differently at batch 32 than
    # at 1, so only a track without convolutions can be held bitwise.
    oracle = pipe.EPICModels()
    qmodels = quantised_models(torch, device, models)
    _need(qmodels.depth_model.matmul_backend == "pallas",
          "int8 track: the depth network is not on the fused launch")
    founders = serve_feeds(torch, device, SERVE_LIVE, SERVE_CHUNKS,
                           SEED + 1000)
    late = serve_feeds(torch, device, SERVE_CHURN, SERVE_CHUNKS // 2,
                       SEED + 2000)
    wrappers = kernel_wrappers()
    counted = {"reproject_match_fused/slots": 0,
               "int8_matmul_pallas/qconv/slots": 0}

    def counted_run(label, run_models, per_frame_qconv, **kw):
        """One serving run with the counts set to 0 just before it and read
        just after its last tick (before any solo session runs): each
        kernel of the step launches once a frame for each rung group."""
        for w in wrappers.values():
            w.launches = 0
        srv, served, ticks, groups = serve_run(
            torch, device, run_models, founders, late, **kw)
        rm = wrappers["reproject_match_fused"].launches
        qc = wrappers["int8_matmul_pallas/qconv"].launches
        _need(rm == CHUNK * groups and qc == per_frame_qconv * CHUNK * groups,
              f"{label}: {rm} rm_fused and {qc} qconv launches for {groups} "
              f"rung groups of {CHUNK} frames")
        counted["reproject_match_fused/slots"] += rm
        counted["int8_matmul_pallas/qconv/slots"] += qc
        print(f"[16b] {label}: {len(ticks)} ticks, {groups} rung groups "
              f"({groups / len(ticks):.2f} a tick), "
              f"{srv.server_counters()['n_dispatches']} dispatches; launches "
              f"in the run: rm_fused {rm} ({rm / (CHUNK * groups):g} a frame "
              f"of each rung group, {rm / (CHUNK * len(ticks)):.2f} a "
              f"tick-frame), qconv {qc} ({qc / (CHUNK * groups):g} a frame "
              f"of each rung group)")
        return srv, served

    flat, served = counted_run("oracle depth, flat", oracle, 0)
    counts = dict(flat.server_counters())
    _need(counts["n_evicted"] == SERVE_CHURN
          and counts["n_admitted"] == SERVE_LIVE + SERVE_CHURN,
          f"oracle run: churn not as scheduled: {counts}")
    rungs = sorted({k for sid in flat.live_sessions
                    for k in flat.telemetry(sid).k_trajectory})
    print(f"[16b] oracle depth, flat pool of {SERVE_SLOTS}: {counts}; rungs "
          f"used {rungs}; programs {flat.step_cache_sizes()}")
    _need(all(v == 1 for v in flat.step_cache_sizes().values()),
          "oracle run: a step program was built twice")
    compare_solo(torch, device, oracle, flat, served, "oracle depth",
                 exact=True)

    tiered, _ = counted_run("oracle depth, tiered", oracle, 0,
                            tiers=SERVE_TIERS)
    for sid in flat.live_sessions:
        _need(all(torch.equal(a, b) for a, b in zip(
            state_leaves(tiered.state(sid)), state_leaves(flat.state(sid))))
            and list(tiered.telemetry(sid).k_trajectory)
            == list(flat.telemetry(sid).k_trajectory),
            f"tiered {sid}: differs from the flat pool")
    tc = tiered.server_counters()
    _need(all(v == 1 for v in tiered.step_cache_sizes().values()),
          "tiered run: a step program was built twice")
    print(f"[16b] oracle depth, tiers {SERVE_TIERS}: bitwise the flat pool "
          f"for every live stream; {tc['n_migrations']} migrations, "
          f"{tc['n_dispatches']} dispatches (flat {counts['n_dispatches']}); "
          f"programs {tiered.step_cache_sizes()}")

    for label, run_models, qconvs in (("fp32 depth", models, 0),
                                      ("int8 depth", qmodels,
                                       len(DEPTH_GEMMS))):
        srv, served = counted_run(label, run_models, qconvs, depth=False)
        compare_solo(torch, device, run_models, srv, served, label,
                     exact=False)
    int8_run = srv  # phase 17 serves the same chunks through the wire
    _need(all(counted.values()), f"a pool kernel was never launched: "
          f"{counted}")
    print(f"[16b] launches in the four serving runs, each counted from 0 "
          f"just before its first tick to just after its last: {counted}")

    # (c) Readings, on the oracle track's flat pool: a second run for the
    # times, a late tick's dispatch under sync-debug mode "error" and the
    # next tick profiled.
    def probe(srv, t):
        if t == SERVE_CHUNKS - 3:
            ready = srv._pop_ready()
            torch.cuda.set_sync_debug_mode("error")
            try:
                inflight = srv._dispatch(ready)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            srv._finish(*inflight)
            return True
        if t == SERVE_CHUNKS - 2:
            probe.busy_us, probe.launches, _ = device_profile(torch, srv.tick)
            _need(probe.launches > 0, "the profiled tick recorded no device "
                  "launch")
            return True
        return False

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    timed, _, ticks, _ = serve_run(torch, device, oracle, founders, late,
                                   on_tick=probe)
    peak = torch.cuda.max_memory_allocated(device) - base
    frames = SERVE_LIVE * CHUNK * len(ticks)
    steady = sorted(ticks[1:])
    med = steady[len(steady) // 2]
    p99 = steady[min(len(steady) - 1, int(0.99 * len(steady)))]
    print(f"[16c] {card}: sync-debug mode \"error\" around a tick's "
          f"_dispatch: no host sync")
    print(f"[16c] {card}: {SERVE_LIVE} live streams, {len(ticks)} timed "
          f"ticks of {CHUNK} frames: {frames / sum(ticks):.1f} frames/s "
          f"aggregate ({frames / sum(ticks) / SERVE_LIVE:.2f} per stream); "
          f"tick latency median {med * 1e3:.1f} ms, p99 {p99 * 1e3:.1f} ms "
          f"(first tick {ticks[0] * 1e3:.1f} ms, not in the median)")
    idle = 1 - probe.busy_us * 1e-6 / med
    print(f"[16c] {card}: device idle share {idle:.3f} (device busy "
          f"{probe.busy_us / 1e3:.2f} ms in a profiled tick, against the "
          f"median tick; {probe.launches} device launches, "
          f"{probe.launches / CHUNK:.1f} per tick-frame); peak device memory "
          f"{peak / 2**20:.1f} MiB for the pool, {peak / SERVE_SLOTS / 2**20:.2f}"
          f" MiB a slot")

    # The tick at 8 and at 32 live streams: one rung, the same step program
    # (the same host ops), only the mask differs.
    from repro_torch.api import EPICCompressor
    from repro_torch.serve import ServerConfig, StreamServer

    srv = StreamServer(EPICCompressor(pipe.EPICConfig(), oracle,
                                      device=device),
                       ServerConfig(capacity=SERVE_SLOTS, chunk_frames=CHUNK))
    feeds = founders + late + founders[:SERVE_SLOTS - SERVE_LIVE - SERVE_CHURN]
    few = SERVE_SLOTS // 4

    # Per live count: a warm tick after the admits, the recorded ticks,
    # then one traced tick for the device launches.  The submits' uploads
    # finish before each tick.
    ops, traced = {}, {}
    for live in (few, SERVE_SLOTS):
        for i in range(len(srv.live_sessions), live):
            srv.admit(i)
        for t in range(2 + SERVE_PROFILED_TICKS):
            for i in range(live):
                srv.submit(i, feeds[i][t])
            torch.cuda.synchronize(device)
            before = fused.reproject_match_fused.launches
            if t == 0:
                srv.tick()
                continue
            if t <= SERVE_PROFILED_TICKS:
                ops.setdefault(live, []).append(host_ops(torch, srv.tick))
            else:
                _, traced[live], _ = device_profile(torch, srv.tick)
            _need(fused.reproject_match_fused.launches - before == CHUNK,
                  f"{live} live: not one rm_fused launch a frame")
    seqs = ops[few] + ops[SERVE_SLOTS]
    first = collections.Counter(seqs[0])
    diff = {}
    for i, q in enumerate(seqs):
        if q != seqs[0]:
            c = collections.Counter(q)
            diff[i] = {k: (first[k], c[k]) for k in first.keys() | c.keys()
                       if first[k] != c[k]}
    _need(not diff, f"the host ops of a tick differ ({SERVE_PROFILED_TICKS} "
          f"ticks at {few} live, then at {SERVE_SLOTS}: "
          f"{[len(q) for q in seqs]} ops); for each tick that differs from "
          f"the first, the ops whose counts differ (first tick, that "
          f"tick): {diff}")
    _need(all(traced.values()), f"a traced tick recorded no device "
          f"launch: {traced}")
    _need(srv.step_cache_sizes() == {None: 1},
          f"programs {srv.step_cache_sizes()}")
    print(f"[16c] {card}: the same {len(seqs[0])} host ops, in order, in "
          f"each of {SERVE_PROFILED_TICKS} ticks at {few} live streams and at "
          f"{SERVE_SLOTS}; device launches per "
          f"tick-frame in a traced tick (a reading) {traced[few] / CHUNK:.1f}"
          f" at {few}, {traced[SERVE_SLOTS] / CHUNK:.1f} at {SERVE_SLOTS} "
          f"(one rm_fused launch a frame for all slots; qconv launches in the "
          f"int8 run {counted['int8_matmul_pallas/qconv/slots']})")
    return dict(counted=counted, flat=flat, int8=int8_run, qmodels=qmodels,
                founders=founders, late=late, tick_ms=(med * 1e3, p99 * 1e3))


# ---------------------------------------------------------------------------
# Phase 17: the wire in front of the StreamServer, crash and restore, EVU.
# ---------------------------------------------------------------------------
# Phase 19: training.
# ---------------------------------------------------------------------------


def train_batch(torch, cfg, b, s, seed, device):
    """A family's batch (tokens, and the VLM's or encoder-decoder's
    embeddings) drawn with numpy from ``seed``, on ``device``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s))}
    if cfg.family == "vlm":
        batch["img_embed"] = 0.1 * rng.standard_normal(
            (b, cfg.img_seq, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        from repro_torch.models import encdec

        batch["src_embed"] = 0.1 * rng.standard_normal(
            (b, encdec.src_len(cfg, s), cfg.d_model), dtype=np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def tree_to(torch, tree, device):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda x: x.to(device), tree)


def move_constant_leaves(torch, params, gen):
    """Every leaf an ``init`` fills with one value (norm scales, zero
    biases, the VLM's gates) moved by seeded noise of 0.1, so the step
    exercises the terms they would switch off."""
    from torch.utils import _pytree as pytree

    def move(x):
        if x.numel() > 1 and bool((x == x.flatten()[0]).all()):
            noise = torch.randn(x.shape, generator=gen, device=x.device)
            return (x.float() + 0.1 * noise).to(x.dtype)
        return x

    return pytree.tree_map(move, params)


def tree_err(torch, ref, got):
    """The largest difference of two trees' leaves, each relative to its
    reference leaf's largest |value|."""
    from torch.utils import _pytree as pytree

    worst = 0.0
    for a, b in zip(pytree.tree_leaves(ref), pytree.tree_leaves(got)):
        a, b = a.float().cpu(), b.float().cpu()
        scale = max(float(a.abs().max()), 1e-30)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return worst


def step_err(torch, ref_params, ref_mu, got_params, lr, beta1=0.9):
    """Parameters after one AdamW step from zero moments against a
    reference step, as the largest difference over what is allowed (pass:
    <= 1).  That step moves an element by lr g / (|g| + eps), g the
    clipped gradient (the reference's first moment over 1 - beta1), so a
    gradient within TRAIN_TOL of its leaf's largest |g| moves it by at
    most lr eps TRAIN_TOL max|g| / (|g| + eps)^2, never more than 2 lr;
    where the gradient is a rounding residue (below 1e-4 of the leaf's
    largest) only 2 lr holds.  Allowed: that, plus 1e-6 max|p|."""
    from torch.utils import _pytree as pytree

    eps = 1e-8
    worst = 0.0
    for a, m, b in zip(pytree.tree_leaves(ref_params),
                       pytree.tree_leaves(ref_mu),
                       pytree.tree_leaves(got_params)):
        a, b = a.float().cpu(), b.float().cpu()
        g = m.float().abs().cpu() / (1 - beta1)
        top = float(g.max())
        moved = lr * eps * TRAIN_TOL * top / (g + eps) ** 2
        allowed = torch.where(g >= 1e-4 * top, moved.clamp(max=2 * lr),
                              torch.full_like(g, 2 * lr))
        allowed = allowed + 1e-6 * float(a.abs().max())
        worst = max(worst, float(((a - b).abs() / allowed).max()))
    return worst


def fmt_errs(errs):
    return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())


def hold_step(torch, label, cpu, card, lr):
    """One train step's ``(params, opt, metrics)`` on the card against the
    CPU's: loss and gradient norm within TRAIN_TOL, the first moments
    (the clipped gradients) within TRAIN_TOL of their scale, the
    parameters by :func:`step_err`.  Returns the errors."""
    (p0, o0, m0), (p1, o1, m1) = cpu, card
    errs = {
        "loss": abs(float(m1["loss"]) - float(m0["loss"]))
        / abs(float(m0["loss"])),
        "gnorm": abs(float(m1["gnorm"]) - float(m0["gnorm"]))
        / float(m0["gnorm"]),
        "mu": tree_err(torch, o0.mu, o1.mu),
        "params": step_err(torch, p0, o0.mu, p1, lr),
    }
    _need(all(v <= TRAIN_TOL for k, v in errs.items() if k != "params")
          and errs["params"] <= 1.0,
          f"{label}: the step differs from the reference's: {fmt_errs(errs)}"
          )
    return errs


def one_step(torch, model, params, batch, *, accum=1, lr=3e-4):
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    step = train.make_train_step(model, adamw.AdamWConfig(lr=lr),
                                 accum=accum, warmup_steps=0)
    return step(params, adamw.init(params), batch, 0)


def ranged(torch, name, fn):
    """``fn`` inside a ``torch.profiler.record_function`` range ``name``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def phase_train_full_width(torch, device, card, wrappers):
    """(a) TinyLlama-1.1B at full width in bf16: three steps under each
    remat setting from one state (the last one timed warm), then 8 steps on
    one batch, and one of them profiled."""
    import statistics
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    cfg = get_config(EFM_ARCH).replace(remat=True, remat_policy="dots",
                                       param_dtype="bfloat16",
                                       compute_dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(SEED)
    params, opt = train.init_train_state(build_model(cfg, device=device), gen)
    batch = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, SEED, device)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(x.numel() for x in
                   torch.utils._pytree.tree_leaves(params))
    for w in wrappers.values():
        w.launches = 0
    one = {}
    for label, remat, policy in (("off", False, "dots"),
                                 ("dots", True, "dots"),
                                 ("full", True, "full")):
        model = build_model(cfg.replace(remat=remat, remat_policy=policy),
                            device=device)
        step = train.make_train_step(model, adamw.AdamWConfig(),
                                     warmup_steps=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for _ in range(TRAIN_WARM + 1):  # the last one warm
            t0 = time.perf_counter()
            m = step(params, opt, batch, 0)[2]  # the new state freed at once
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            one.setdefault(label, (float(m["loss"]), float(m["gnorm"])))
            del m
        one[label] += (torch.cuda.max_memory_allocated() / 2**30, secs[-1])
        print(f"[19a] remat {label}: loss {one[label][0]:.6f}, gnorm "
              f"{one[label][1]:.6f}, peak memory {one[label][2]:.2f} GiB, "
              f"step {secs[-1] * 1e3:.1f} ms warm (first "
              f"{secs[0] * 1e3:.1f} ms) ({card})")
    losses = {v[0] for v in one.values()}
    _need(len(losses) == 1, f"19a: remat changed the loss: {one}")
    g0 = one["off"][1]
    _need(all(abs(v[1] - g0) <= 0.01 * g0 for v in one.values()),
          f"19a: remat moved the gradient norm by more than 1%: {one}")

    model = build_model(cfg, device=device)
    step = train.make_train_step(model, adamw.AdamWConfig(), warmup_steps=0)
    probe = params["layers"]["mlp"]["up"]["w"][0, :4, :4].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, times = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch, i)
        loss = float(m["loss"])  # reads the step's end back: one sync
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        gnorms.append(float(m["gnorm"]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: w.launches for k, w in wrappers.items()}
    _need(all(math.isfinite(x) for x in losses), f"19a: losses {losses}")
    _need(losses[-1] < losses[0], f"19a: the loss did not fall: {losses}")
    _need(not torch.equal(probe, params["layers"]["mlp"]["up"]["w"][0, :4,
                                                                       :4]),
          "19a: the parameters did not change")
    med = statistics.median(times[TRAIN_WARM:])
    # The forward runs inside "value_and_grad"'s range; the backward's
    # kernels are launched by autograd's device thread, outside any range
    # of this one: they are the rest of the busy time.
    ranges = ("value_and_grad", "adamw.update")
    with mock.patch.object(train, "value_and_grad", ranged(
            torch, ranges[0], train.value_and_grad)), mock.patch.object(
            adamw, "update", ranged(torch, ranges[1], adamw.update)):
        prof = profile_steps(torch, "[19a]", [(
            f"train step (remat dots; {card})",
            lambda: step(params, opt, batch, 0), 1, "step")],
            focus=("gemm", "nvjet"), ranges=ranges)
    rest = prof["busy_us"] - sum(prof[r] for r in ranges)
    print(f"[19a] train step (remat dots; {card}): backward and "
          f"recomputation (launched by autograd's device thread) "
          f"{rest:.1f} us/step ({rest / prof['busy_us']:.1%} of device "
          f"busy)")
    print(f"[19a] {EFM_ARCH} bf16, {n_params / 1e9:.3f} B parameters, remat "
          f"dots, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, AdamWConfig(): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; gnorm "
          f"{', '.join(f'{x:.4f}' for x in gnorms)}")
    print(f"[19a] step time median {med * 1e3:.1f} ms (steps "
          f"{TRAIN_WARM}-{TRAIN_STEPS - 1}: "
          f"{', '.join(f'{t * 1e3:.1f}' for t in times[TRAIN_WARM:])}), "
          f"{tokens / med:.0f} tokens/s, peak memory {peak:.2f} GiB "
          f"({card})")
    return {"step_ms": med * 1e3, "tokens_per_s": tokens / med,
            "peak_gib": peak, "launches": launches}


def phase_train_f32(torch, device, wrappers):
    """(b) float32 TinyLlama-1.1B at 2 layers and full width: the card
    against the CPU, and ``accum=2`` against ``accum=1`` on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    cfg = get_config(EFM_ARCH).replace(
        n_layers=TRAIN_F32_LAYERS, remat=False, param_dtype="float32",
        compute_dtype="float32")
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED)
    p_cpu = move_constant_leaves(torch, build_model(cfg, device=cpu).init(
        gen), gen)
    b_cpu = train_batch(torch, cfg, TRAIN_F32_BATCH, TRAIN_F32_SEQ, SEED, cpu)
    m_cpu, m_card = build_model(cfg, device=cpu), build_model(cfg,
                                                              device=device)
    p_card, b_card = tree_to(torch, p_cpu, device), tree_to(torch, b_cpu,
                                                            device)
    l0, g0 = train.value_and_grad(m_cpu.loss_fn, p_cpu, b_cpu)
    l1, g1 = train.value_and_grad(m_card.loss_fn, p_card, b_card)
    errs = {"loss": abs(float(l1) - float(l0)) / abs(float(l0)),
            "grads": tree_err(torch, g0, g1)}
    _need(errs["loss"] <= TRAIN_TOL and errs["grads"] <= TRAIN_TOL,
          f"19b: loss or gradients on the card differ from the CPU: {errs}")
    errs["step"] = hold_step(torch, "19b", one_step(torch, m_cpu, p_cpu,
                                                     b_cpu),
                             one_step(torch, m_card, p_card, b_card), 3e-4)
    one = one_step(torch, m_card, p_card, b_card)
    two = one_step(torch, m_card, p_card, b_card, accum=2)
    errs["accum"] = hold_step(torch, "19b accum=2", one, two, 3e-4)
    print(f"[19b] {EFM_ARCH} float32 at {TRAIN_F32_LAYERS} layers, "
          f"{TRAIN_F32_BATCH} x {TRAIN_F32_SEQ} tokens: card vs CPU loss "
          f"{errs['loss']:.3g}, gradients {errs['grads']:.3g} (relative, "
          f"tol {TRAIN_TOL}), one step: {fmt_errs(errs['step'])}; accum=2 "
          f"vs 1 on the card: {fmt_errs(errs['accum'])} (params: largest "
          f"difference over the allowed, pass <= 1)")
    return m_card, p_card, b_card


def phase_train_families(torch, device):
    """(c) One float32 train step of each other family at its smoke
    configuration, on the card against the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cpu = torch.device("cpu")
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        gen = torch.Generator().manual_seed(SEED)
        params = move_constant_leaves(
            torch, build_model(cfg, device=cpu).init(gen), gen)
        batch = train_batch(torch, cfg, TRAIN_SMOKE_BATCH, TRAIN_SMOKE_SEQ,
                            SEED, cpu)
        cpu_step = one_step(torch, build_model(cfg, device=cpu), params,
                            batch, lr=1e-3)
        card_step = one_step(torch, build_model(cfg, device=device),
                             tree_to(torch, params, device),
                             tree_to(torch, batch, device), lr=1e-3)
        errs = hold_step(torch, f"19c {arch}", cpu_step, card_step, 1e-3)
        print(f"[19c] {arch} ({cfg.family}{', MTP' if cfg.mtp else ''}) "
              f"float32 smoke, one step, card vs CPU: {fmt_errs(errs)}")


def phase_train_refusals(torch, device, f32, wrappers):
    """(d) The kernel wrappers under grad on the card: each raises before
    it launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import geometry as geo
    from repro_torch.launch import train
    from repro_torch.models import build_model

    def refuses(label, fn):
        before = {k: w.launches for k, w in wrappers.items()}
        try:
            fn()
        except RuntimeError as e:
            _need("requires grad" in str(e), f"19d {label}: {e}")
        else:
            raise AssertionError(f"19d {label}: no error under grad")
        _need({k: w.launches for k, w in wrappers.items()} == before,
              f"19d {label}: a kernel launched")
        print(f"[19d] {label}: refused before a launch")

    def rand(*shape, grad=False):
        return torch.rand(shape, device=device).requires_grad_(grad)

    q = rand(1, 4, 128, 64, grad=True)
    refuses("flash_attention_pallas, q.requires_grad",
            lambda: wrappers["flash_attention_pallas"](q, rand(1, 4, 128, 64),
                                                       rand(1, 4, 128, 64)))
    model, params, batch = f32
    kern = build_model(model.cfg.replace(attn_backend="pallas"),
                       device=device)
    refuses(f"{EFM_ARCH} float32 loss on attn_backend='pallas'",
            lambda: train.value_and_grad(kern.loss_fn, params, batch))
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        cfg = get_smoke_config(arch)
        m = build_model(cfg, device=device, scan_backend="pallas")
        p = m.init(torch.Generator(device=device).manual_seed(SEED))
        toks = train_batch(torch, cfg, 2, 64, SEED, device)
        live = torch.utils._pytree.tree_map(
            lambda x: x.detach().requires_grad_(True), p)
        refuses(f"{arch} prefill on scan_backend='pallas' under grad",
                lambda: m.prefill(live, toks))
    x = rand(1, 16, 16, 8, grad=True)
    refuses("qconv_int8_pallas, x.requires_grad",
            lambda: wrappers["int8_matmul_pallas/qconv"](
                x, rand(), torch.zeros(72, 8, dtype=torch.int8,
                                       device=device), rand(8), rand(8)))
    intr = geo.Intrinsics.create(51.2, 32.0, 32.0, device)
    for name in ("reproject_match_pallas", "reproject_match_pallas_tiled",
                 "reproject_match_fused"):
        refuses(f"{name}, entry_rgb.requires_grad",
                lambda: wrappers[name](
                    rand(2, 8, 8, 3, grad=True), rand(2, 8, 8), rand(2, 2),
                    rand(2, 4, 4), rand(64, 64, 3), intr, window=16))


def phase_train_fault(torch, device):
    """(e) The depth stage, HIR and the gradient of ``depth.loss_fn`` with
    cuDNN's switches at PyTorch's defaults, against the CPU."""
    from unittest import mock

    from repro_torch.core import depth as depth_mod
    from repro_torch.core import hir as hir_mod

    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    gen = torch.Generator().manual_seed(SEED)
    depth_cpu, hir_cpu = (depth_mod.init_params(gen),
                          hir_mod.init_params(gen))
    depth_card = depth_mod.init_params(gen).to(device)
    depth_card.load_state_dict(depth_cpu.state_dict())
    hir_card = hir_mod.init_params(gen).to(device)
    hir_card.load_state_dict(hir_cpu.state_dict())
    frame = torch.rand((128, 128, 3), generator=gen)
    rgb = torch.rand((4, 64, 64, 3), generator=gen)
    heat = torch.rand((4, 64, 64), generator=gen)
    target = 1.0 + 3.0 * torch.rand((4, 64, 64), generator=gen)

    def depth_err():
        with torch.no_grad():
            d0 = depth_mod.predict_fullres(depth_cpu, frame)
            d1 = depth_mod.predict_fullres(depth_card, frame.to(device))
        return float(((d1.cpu() - d0).abs() / (d0.abs() + 1.0)).max())

    try:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = (
            True, False, False)  # PyTorch's defaults
        errs = {"depth": depth_err()}
        with torch.no_grad():
            h0 = hir_mod.forward(hir_cpu, rgb, heat, 4)
            h1 = hir_mod.forward(hir_card, rgb.to(device), heat.to(device), 4)
        errs["hir"] = float((h1.cpu() - h0).abs().max())
        grads = []
        for model, dev in ((depth_cpu, "cpu"), (depth_card, device)):
            model.zero_grad()
            depth_mod.loss_fn(model, rgb.to(dev), target.to(dev)).backward()
            grads.append([p.grad for p in model.parameters()])
        errs["grad"] = tree_err(torch, *grads)
        _need(errs["depth"] <= 1e-5 and errs["hir"] <= 1e-5
              and errs["grad"] <= TRAIN_TOL,
              f"19e: with cuDNN at its defaults the card differs: {errs}")
        _need((cudnn.allow_tf32, cudnn.deterministic) == (True, False),
              "19e: conv2d_same did not restore cuDNN's switches")
        with mock.patch.object(depth_mod, "_exact_cudnn",
                               lambda: cudnn.flags(enabled=True,
                                                   allow_tf32=True)):
            unscoped = depth_err()
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved
    print(f"[19e] cuDNN at PyTorch's defaults (TF32 allowed): depth stage "
          f"{errs['depth']:.3g} from the CPU (relative, tol 1e-5), HIR "
          f"{errs['hir']:.3g} (tol 1e-5), depth.loss_fn gradient "
          f"{errs['grad']:.3g} (tol {TRAIN_TOL}); with conv2d_same's scope "
          f"lifted (a reading): depth stage {unscoped:.3g}")


def train_main() -> int:
    """``chip_smoke.py --train``: phase 19; prints its results as one JSON
    line, last."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    set_numerics(torch)
    card = card_line()
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    full = phase_train_full_width(torch, device, card, wrappers)
    torch.cuda.empty_cache()
    for w in wrappers.values():
        w.launches = 0
    f32 = phase_train_f32(torch, device, wrappers)
    phase_train_families(torch, device)
    launches = {k: w.launches + full["launches"][k]
                for k, w in wrappers.items()}
    _need(not any(launches.values()),
          f"19: training launched a kernel: {launches}")
    print(f"[19] kernel launches in (a)-(c): {launches}")
    phase_train_refusals(torch, device, f32, wrappers)
    phase_train_fault(torch, device)
    print(f"[19] phase 19 took {time.perf_counter() - t0:.1f} s ({card})")
    full.pop("launches")
    print(json.dumps({"train": full}))
    return 0


def phase_train_process() -> dict:
    """Phase 19 in a process of its own (``chip_smoke.py --train``); its
    lines pass through, its last line is its results as JSON."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--train"], stdout=subprocess.PIPE, text=True,
                         timeout=600)
    lines = out.stdout.splitlines()
    print("\n".join(lines[:-1] if out.returncode == 0 else lines),
          flush=True)
    _need(out.returncode == 0 and lines,
          f"phase 19 failed (exit {out.returncode})")
    return json.loads(lines[-1])["train"]


# ---------------------------------------------------------------------------
# Phase 20: the mesh and distribution layer on a one-rank NCCL group.
# ---------------------------------------------------------------------------


def whole(torch, tree):
    """A tree of DTensors gathered whole (plain tensors kept)."""
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def trees_equal(torch, a, b):
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def phase_dist_train(torch, device, mesh, card):
    """(a) ``jit_train_step`` at full width on the (1, 1) mesh against
    ``make_train_step``; the EF-int8 exchange against ``optim/compress``."""
    import statistics
    from unittest import mock

    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import compression, train
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, compress

    cfg = get_config(EFM_ARCH).replace(remat=True, remat_policy="dots",
                                       param_dtype="bfloat16",
                                       compute_dtype="bfloat16")
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    shape = ShapeSpec("smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    step_fn, specs = train.jit_train_step(model, mesh, adamw.AdamWConfig(),
                                          shape_spec=shape, warmup_steps=0)
    # What phase 21b's dry-run predicts: the bytes the parameters and
    # moments take once placed by their specs, and one step's peak.
    def allocated():
        torch.cuda.synchronize()
        return (torch.cuda.memory_stats()["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    before = allocated()
    params, opt = train.init_train_state(model, gen)
    placed = (S.place_tree(params, S.named(mesh, specs["params"])),
              S.place_tree(opt, S.named(mesh, specs["opt"])))
    requested, resident = (a - b for a, b in zip(allocated(), before))
    n_tensors = len(pytree.tree_leaves((params, opt)))
    batch = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, SEED, device)
    plain = train.make_train_step(model, adamw.AdamWConfig(),
                                  warmup_steps=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, o, m = step_fn(*placed, batch, 0)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated()
    del placed
    ref = plain(params, opt, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = (whole(torch, p), adamw.AdamWState(
        whole(torch, o.step), whole(torch, o.mu), whole(torch, o.nu)), m)
    errs = hold_step(torch, "20a", ref, first, 3e-4)
    bitwise = {"loss": torch.equal(ref[2]["loss"], m["loss"]),
               "params": trees_equal(torch, ref[0], first[0]),
               "moments": trees_equal(torch, ref[1].mu, first[1].mu)
               and trees_equal(torch, ref[1].nu, first[1].nu)}
    del ref, first
    losses, times = [float(m["loss"])], []
    for i in range(1, DIST_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, batch, i)
        losses.append(float(m["loss"]))  # reads the step's end back
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    _need(all(math.isfinite(x) for x in losses), f"20a: losses {losses}")
    med = statistics.median(times)
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    print(f"[20a] {EFM_ARCH} bf16 remat dots, {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens, jit_train_step on mesh {axes}: "
          f"first step vs make_train_step {fmt_errs(errs)} (tol {TRAIN_TOL}; "
          f"params: largest difference over the allowed, pass <= 1); "
          f"bitwise {bitwise}; losses {', '.join(f'{x:.4f}' for x in losses)}")
    print(f"[20a] placed parameters and moments: {requested} bytes "
          f"requested in {n_tensors} tensors, memory_allocated growth "
          f"{resident} bytes; one step's peak from them "
          f"{step_peak / 2**30:.2f} GiB (max_memory_allocated) ({card})")
    print(f"[20a] sharded step time median {med * 1e3:.1f} ms (steps 1-"
          f"{DIST_STEPS - 1}: {', '.join(f'{t * 1e3:.1f}' for t in times)}),"
          f" peak memory {peak:.2f} GiB ({card})")
    del p, o, m

    # The EF-int8 exchange over "data", recorded where the step calls it.
    seen = {}
    real = compression.ef_int8_allreduce

    def recording(grads, axis, mesh_=None):
        out = real(grads, axis, mesh_)
        seen["in"], seen["out"] = grads, out
        return out

    ef_step, _ = train.jit_train_step(model, mesh, adamw.AdamWConfig(),
                                      shape_spec=shape, warmup_steps=0,
                                      grad_axis="data")
    plain_ef = train.make_train_step(model, adamw.AdamWConfig(),
                                     warmup_steps=0, grad_axis="data")
    with mock.patch.object(compression, "ef_int8_allreduce", recording):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m_ef = ef_step(params, opt, batch, 0)
        loss_ef = float(m_ef["loss"])
        t_ef = time.perf_counter() - t0
        grads = seen["in"]
        q, scales, _ = compress.compress(grads, compress.init(grads))
        payload = all(
            torch.equal(a, qq) and torch.equal(b, ss) for (a, b), qq, ss in
            zip((compression.quantize(g) for g in pytree.tree_leaves(grads)),
                pytree.tree_leaves(q), pytree.tree_leaves(scales)))
        rec = compress.decompress(q, scales)
        exchanged = all(torch.equal(a, b.to(a.dtype)) for a, b in zip(
            pytree.tree_leaves(seen["out"]), pytree.tree_leaves(rec)))
        del q, scales, rec, grads, seen["in"], seen["out"]
        with use_mesh(mesh):
            _, _, m_plain = plain_ef(params, opt, batch, 0)
    _need(payload and exchanged, f"20a: the EF-int8 exchange differs from "
          f"optim/compress: payload and scales {payload}, exchanged "
          f"gradients {exchanged}")
    print(f"[20a] grad_axis='data': int8 payload and float32 scales equal "
          f"optim/compress.compress exactly; the exchanged gradients "
          f"(gathered in int8 over NCCL) bitwise decompress(compress(g)); "
          f"loss {loss_ef:.6f} (unsharded step with the exchange "
          f"{float(m_plain['loss']):.6f}); step {t_ef * 1e3:.1f} ms with the "
          f"exchange ({card})")
    return {"step_ms": med * 1e3, "peak_gib": peak, "bitwise": bitwise,
            "requested": requested, "resident": resident,
            "n_tensors": n_tensors, "step_peak": step_peak}


def dist_serve_run(torch, device, models, founders, late, mesh, depth):
    """The phase-20 schedule through ``StreamServer``: every founder
    streaming, the first closed and the late joiner admitted at tick
    ``DIST_CHURN_AT``.  Returns the server and its ticks' kernel
    launches."""
    from repro_torch.api import EPICCompressor, SensorChunk
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve import ServerConfig, StreamServer

    wrappers = kernel_wrappers()
    srv = StreamServer(
        EPICCompressor(pipe.EPICConfig(prefilter_k=SERVE_LADDER[0]), models,
                       device=device),
        ServerConfig(capacity=DIST_SLOTS, chunk_frames=CHUNK,
                     k_ladder=SERVE_LADDER), mesh=mesh)

    def chunk(c):
        return c if depth else SensorChunk(*c[:3])

    for i in range(len(founders)):
        srv.admit(f"s{i}")
    for w in wrappers.values():
        w.launches = 0
    for t in range(DIST_CHUNKS):
        if t == DIST_CHURN_AT:
            srv.close("s0")
            srv.admit("l0")
        for i, feed in enumerate(founders):
            if i or t < DIST_CHURN_AT:
                srv.submit(f"s{i}", chunk(feed[t]))
        if t >= DIST_CHURN_AT:
            srv.submit("l0", chunk(late[0][t - DIST_CHURN_AT]))
        srv.tick()
    torch.cuda.synchronize(device)
    return srv, {k: wrappers[k].launches for k in (
        "reproject_match_fused", "int8_matmul_pallas/qconv")}


def phase_dist_serve(torch, device, card):
    """(b) The stream-sharded ``StreamServer`` against ``mesh=None``."""
    from repro_torch.core import pipeline as pipe
    from repro_torch.launch.mesh import make_stream_mesh

    mesh = make_stream_mesh(device=device)
    _, _, models = main_path_inputs(torch, device, CHUNK)
    # One chunk more a stream than the schedule takes: queued before the
    # checkpoint.
    founders = serve_feeds(torch, device, DIST_SLOTS, DIST_CHUNKS + 1,
                           SEED + 3000)
    late = serve_feeds(torch, device, 1, DIST_CHUNKS - DIST_CHURN_AT + 1,
                       SEED + 4000)
    for label, run_models, depth in (
            ("oracle depth", pipe.EPICModels(), True),
            ("int8 depth", quantised_models(torch, device, models), False)):
        local, n_local = dist_serve_run(torch, device, run_models, founders,
                                        late, None, depth)
        t0 = time.perf_counter()
        sharded, n_sharded = dist_serve_run(torch, device, run_models,
                                            founders, late, mesh, depth)
        dt = time.perf_counter() - t0
        for sid in local.live_sessions:
            _need(trees_equal(torch, sharded.state(sid), local.state(sid))
                  and list(sharded.telemetry(sid).k_trajectory)
                  == list(local.telemetry(sid).k_trajectory),
                  f"20b {label} {sid}: the stream-sharded server differs "
                  f"from mesh=None")
        _need(n_sharded == n_local and all(n_sharded.values())
              if label == "int8 depth" else n_sharded == n_local
              and n_sharded["reproject_match_fused"] > 0,
              f"20b {label}: launches {n_sharded} vs mesh=None {n_local}")
        rungs = sorted({k for sid in local.live_sessions
                        for k in local.telemetry(sid).k_trajectory})
        print(f"[20b] {label}: StreamServer on make_stream_mesh() "
              f"({DIST_SLOTS} slots, {DIST_SLOTS} streams x {DIST_CHUNKS} "
              f"chunks, 1 closed, 1 admitted, rungs used {rungs}): every "
              f"live stream's state and k_trajectory bitwise the mesh=None "
              f"run's; launches {n_sharded} (mesh=None {n_local}); "
              f"{DIST_CHUNKS} ticks in {dt * 1e3:.1f} ms ({card})")
        dist_serve_checkpoint(torch, device, run_models, mesh, local,
                              sharded, founders, late, depth, label)


def step_dir_bytes(d):
    """A checkpoint step directory's bytes, but for its clock readings:
    the manifest's text without ``time`` and with the scheduler's cost
    keys but not its measured costs, and each npz member's bytes (a zip
    member's header holds its write time)."""
    import os
    import zipfile

    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man.pop("time")
    man["serve"]["scheduler_cost"] = [k for k, _ in
                                      man["serve"]["scheduler_cost"]]
    out = {"manifest.json": json.dumps(man)}
    for name in sorted(os.listdir(d)):
        if name.endswith(".npz"):
            with zipfile.ZipFile(os.path.join(d, name)) as z:
                for member in z.namelist():
                    out[f"{name}/{member}"] = z.read(member)
    return out


def dist_serve_checkpoint(torch, device, models, mesh, local, sharded,
                          founders, late, depth, label):
    """(b) One more chunk queued on every live stream; the stream-sharded
    server's checkpoint byte-equal to the ``mesh=None`` server's, restored
    into a fresh sharded server and ticked: bitwise the uninterrupted
    runs."""
    import os
    import tempfile

    from repro_torch.api import EPICCompressor, SensorChunk
    from repro_torch.serve import StreamServer
    from repro_torch.serve.checkpoint import restore_server, save_server

    extra = {f"s{i}": feed[DIST_CHUNKS] for i, feed in enumerate(founders)}
    extra["l0"] = late[0][DIST_CHUNKS - DIST_CHURN_AT]
    for srv in (local, sharded):
        for sid in srv.live_sessions:
            c = extra[sid]
            srv.submit(sid, c if depth else SensorChunk(*c[:3]))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = save_server(os.path.join(tmp, "sharded"), sharded.n_ticks,
                           sharded)
        t_save = time.perf_counter() - t0
        plain = save_server(os.path.join(tmp, "local"), local.n_ticks, local)
        got, want = step_dir_bytes(path), step_dir_bytes(plain)
        _need(got == want, f"20b {label}: the sharded server's checkpoint "
              f"differs from mesh=None's in "
              f"{sorted(k for k in want if got.get(k) != want[k])}")
        fresh = StreamServer(
            EPICCompressor(sharded.compressor.cfg, models, device=device),
            sharded.cfg, mesh=mesh)
        t0 = time.perf_counter()
        restored = restore_server(os.path.join(tmp, "sharded"),
                                  fresh.compressor, server=fresh).server
        t_restore = time.perf_counter() - t0
    for srv in (sharded, restored, local):
        srv.tick()
    torch.cuda.synchronize(device)
    for sid in local.live_sessions:
        _need(trees_equal(torch, restored.state(sid), sharded.state(sid))
              and trees_equal(torch, restored.state(sid), local.state(sid))
              and list(restored.telemetry(sid).k_trajectory)
              == list(sharded.telemetry(sid).k_trajectory),
              f"20b {label} {sid}: the restored sharded server differs "
              f"from the uninterrupted runs after a tick")
    print(f"[20b] {label}: checkpoint of the sharded server with "
          f"{len(local.live_sessions)} chunks queued: the manifest and "
          f"{len(want) - 1} npz members "
          f"byte-equal to mesh=None's (write times and measured "
          f"scheduler costs aside); save {t_save * 1e3:.1f} ms, restore into "
          f"a fresh sharded server {t_restore * 1e3:.1f} ms; one more tick "
          f"bitwise the uninterrupted sharded and mesh=None runs")


def phase_dist_efm(torch, device, mesh, card):
    """(c) ``jit_prefill``/``jit_decode_step`` on the mesh against
    ``mesh=None``, TinyLlama-1.1B bf16 on the flash kernel."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import build_model
    from repro_torch.serve import efm

    cfg = get_config(EFM_ARCH).replace(attn_backend="pallas",
                                       param_dtype="bfloat16",
                                       compute_dtype="bfloat16")
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(SEED))
    tokens = zoo_tokens(torch, device, cfg.vocab)
    b, s = tokens.shape
    batch = {"tokens": tokens}
    prefill, _ = efm.jit_prefill(model, mesh, ShapeSpec("p", "prefill", s, b))
    decode, _ = efm.jit_decode_step(model, mesh,
                                    ShapeSpec("d", "decode", s + ZOO_NEW, b))
    plain_prefill, plain_decode = efm.jit_prefill(model), \
        efm.jit_decode_step(model)
    flash = kernel_wrappers()["flash_attention_pallas"]
    plain_prefill(params, batch)  # warm-up
    flash.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    n_flash = flash.launches
    ref_logits, ref_cache = plain_prefill(params, batch)
    _need(torch.equal(logits.full_tensor(), ref_logits),
          "20c: the sharded prefill's logits differ from mesh=None's")
    _need(n_flash == cfg.n_layers, f"20c: {n_flash} flash launches in the "
          f"sharded prefill, not {cfg.n_layers}")
    state = efm.pad_for_decode(model, whole(torch, cache), ZOO_NEW)
    ref_state = efm.pad_for_decode(model, ref_cache, ZOO_NEW)
    tok = torch.argmax(ref_logits[:, -1:], dim=-1).to(torch.int32)
    for i in range(ZOO_NEW):
        lg, state = decode(params, state, tok, s + i)
        rlg, ref_state = plain_decode(params, ref_state, tok, s + i)
        _need(torch.equal(lg.full_tensor(), rlg),
              f"20c: decode step {i} differs from mesh=None")
        tok = torch.argmax(rlg[:, -1:], dim=-1).to(torch.int32)
        state = whole(torch, state)
    print(f"[20c] {EFM_ARCH} bf16 attn_backend='pallas' on the mesh: "
          f"prefill {b}x{s} ({n_flash} flash launches, {t_prefill * 1e3:.2f}"
          f" ms) and {ZOO_NEW} greedy tokens, logits bitwise mesh=None's "
          f"({card})")


def phase_dist_ep(torch, device, mesh):
    """(d) ``moe_impl="ep"`` on the one-rank mesh takes the sort path."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe

    cfg = get_config(ZOO_MOE).replace(moe_impl="ep")
    gen = torch.Generator(device=device).manual_seed(SEED)
    p = moe.init_moe(gen, cfg, device=device)
    x = (0.3 * torch.randn((*DIST_EP_TOKENS, cfg.d_model), generator=gen,
                           device=device)).to(cfg.cdt)
    with torch.no_grad(), use_mesh(mesh):
        none = moe.moe_ffn_ep(p, x, cfg)
        y, aux = moe.moe_ffn(p, x, cfg)
        ys, auxs = moe.moe_ffn_sort(p, x, cfg)
    _need(none is None and torch.equal(y, ys) and torch.equal(aux, auxs),
          "20d: moe_impl='ep' on one rank differs from the sort path")
    print(f"[20d] {ZOO_MOE} moe_ffn, moe_impl='ep' on the one-rank mesh: "
          f"moe_ffn_ep returns None (n_ep 1), output bitwise moe_ffn_sort's "
          f"at {tuple(x.shape)}")


def dist_main() -> int:
    """``chip_smoke.py --dist``: phase 20; prints its results as one JSON
    line, last."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    set_numerics(torch)
    card = card_line()
    t0 = time.perf_counter()
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device=device)
    _need(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"20: the group is {dist.get_backend()} of "
          f"{dist.get_world_size()} ranks")
    try:
        out = phase_dist_train(torch, device, mesh, card)
        torch.cuda.empty_cache()
        phase_dist_serve(torch, device, card)
        torch.cuda.empty_cache()
        phase_dist_efm(torch, device, mesh, card)
        torch.cuda.empty_cache()
        phase_dist_ep(torch, device, mesh)
    finally:
        dist.destroy_process_group()
    print(f"[20] phase 20 took {time.perf_counter() - t0:.1f} s ({card})")
    print(json.dumps({"dist": out}))
    return 0


def phase_dist_process(train: dict) -> dict:
    """Phase 20 in a process of its own (``chip_smoke.py --dist``); its
    lines pass through, its last line is its results as JSON."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--dist"], stdout=subprocess.PIPE, text=True,
                         timeout=400)
    lines = out.stdout.splitlines()
    print("\n".join(lines[:-1] if out.returncode == 0 else lines),
          flush=True)
    _need(out.returncode == 0 and lines,
          f"phase 20 failed (exit {out.returncode})")
    res = json.loads(lines[-1])["dist"]
    print(f"[20a] sharded step median {res['step_ms']:.1f} ms beside phase "
          f"19a's make_train_step {train['step_ms']:.1f} ms "
          f"({res['step_ms'] / train['step_ms']:.3f}x); peak memory "
          f"{res['peak_gib']:.2f} GiB beside {train['peak_gib']:.2f} GiB")
    return res


# ---------------------------------------------------------------------------
# Phase 21: the dry-run on fake process groups.
# ---------------------------------------------------------------------------


def phase_dryrun_cells():
    """(a) ``run_cell`` at full width on DRYRUN_CELLS: each must be ``ok``."""
    from repro_torch.launch import dryrun as D

    out = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        rec = D.run_cell(arch, shape, multi_pod, verbose=False)
        _need(rec["ok"], f"21a {arch} x {shape} x {rec['mesh']}: "
              f"{rec.get('error')}\n{rec.get('traceback', '')}")
        coll = rec["collectives"]
        print(f"[21a] {arch} x {shape} x {rec['mesh']}: ok, traced in "
              f"{rec['trace_s']} s on a fake world of "
              f"{512 if multi_pod else 256}; per device: parameters "
              f"{rec['param_bytes_per_device']} B, moments "
              f"{rec.get('opt_bytes_per_device', '-')} B, cache "
              f"{rec.get('cache_bytes_per_device', '-')} B, arguments "
              f"{rec['argument_size_in_bytes']} B, outputs "
              f"{rec['output_size_in_bytes']} B, temp "
              f"{rec['temp_size_in_bytes']} B, peak {rec['peak_bytes']} B "
              f"({'fits' if rec['fits'] else 'does not fit'} in 80 GB); "
              f"flops {rec['flops']:.4e}; collectives "
              f"{dict(sorted(coll['counts'].items()))}, "
              f"{coll['total_bytes']:.6e} B, wire {coll['wire_bytes']:.6e} B")
        out.append({k: rec.get(k) for k in (
            "arch", "shape", "mesh", "trace_s", "peak_bytes", "fits")})
    return out


def phase_dryrun_reckoning():
    """(b) The dry-run of phase 20a's step: TinyLlama-1.1B bf16, remat
    ``"dots"``, TRAIN_BATCH x TRAIN_SEQ tokens on a (1, 1) mesh on a fake
    world of one."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.models import build_model

    cfg = get_config(EFM_ARCH).replace(remat=True, remat_policy="dots",
                                       param_dtype="bfloat16",
                                       compute_dtype="bfloat16")
    t0 = time.perf_counter()
    with D.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        lowered = D.lower(build_model(cfg, device="meta"),
                          ShapeSpec("smoke", "train", TRAIN_SEQ, TRAIN_BATCH),
                          mesh)
        got = D.trace(lowered)
    res = {"resident": D.local_bytes(lowered.args[:2]), "peak": got["peak"],
           "arguments": D.local_bytes(lowered.args)}
    print(f"[21b] dry-run of phase 20a's step ({EFM_ARCH} bf16, remat dots, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens, (1, 1) mesh): parameters and "
          f"moments {res['resident']} B, arguments {res['arguments']} B, "
          f"peak {got['peak']} B; traced in "
          f"{time.perf_counter() - t0:.1f} s")
    return res


def dryrun_main() -> int:
    """``chip_smoke.py --dryrun``: phase 21, on the host (a fake process
    group holds the process's one default group); prints its results as
    one JSON line, last."""
    sys.path.insert(0, str(ROOT / "src"))
    t0 = time.perf_counter()
    cells = phase_dryrun_cells()
    reckoning = phase_dryrun_reckoning()
    print(f"[21] phase 21 took {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"dryrun": {"cells": cells, "reckoning": reckoning}}))
    return 0


def phase_dryrun_process(dist: dict, card: str) -> dict:
    """Phase 21 in a process of its own (``chip_smoke.py --dryrun``); its
    lines pass through.  (b) held: the predicted resident bytes of the
    parameters and moments equal to the bytes phase 20a's placement of
    them asked the caching allocator for (its ``requested_bytes``);
    beside them, as readings, the growth of ``memory_allocated`` (block
    sizes: 512-byte rounding, and a reused cached block is not split
    when less than 1 MB would remain) and the predicted peak beside
    phase 20a's one step."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--dryrun"], stdout=subprocess.PIPE, text=True,
                         timeout=300)
    lines = out.stdout.splitlines()
    print("\n".join(lines[:-1] if out.returncode == 0 else lines),
          flush=True)
    _need(out.returncode == 0 and lines,
          f"phase 21 failed (exit {out.returncode})")
    res = json.loads(lines[-1])["dryrun"]
    pred, got, n = (res["reckoning"]["resident"], dist["requested"],
                    dist["n_tensors"])
    _need(pred == got, f"21b: predicted resident bytes {pred}, the card's "
          f"requested bytes {got} over {n} tensors")
    peak = res["reckoning"]["peak"]
    print(f"[21b] resident parameters and moments: predicted {pred} B, the "
          f"card's requested bytes {got} B over {n} tensors (equal); "
          f"memory_allocated growth {dist['resident']} B "
          f"(+{dist['resident'] - pred} B of block rounding); one step's "
          f"peak: "
          f"predicted {peak / 2**30:.2f} GiB beside the card's "
          f"{dist['step_peak'] / 2**30:.2f} GiB (ratio "
          f"{peak / dist['step_peak']:.3f}) ({card})")
    return res


# ---------------------------------------------------------------------------


def wire_ids():
    """Wire stream ids of phase 16's streams: founder ``i`` is ``i``, late
    joiner ``j`` is ``WIRE_LATE + j``; with phase 16's names."""
    ids = {i: f"s{i}" for i in range(SERVE_LIVE)}
    ids.update({WIRE_LATE + j: f"l{j}" for j in range(SERVE_CHURN)})
    return ids


def wire_schedule(founders, late, depth, tmp):
    """Phase 16's schedule as EPWF bytes: the founders' and the late
    joiners' chunks recorded by the port's ``record_streams`` (a founder
    closed at the churn keeps its first half), read back and grouped by
    tick: ``{tick: [(stream id, chunk as a view of the trace), ...]}``."""
    from repro_torch.api import SensorChunk
    from repro_torch.wire import codec, trace

    half = SERVE_CHUNKS // 2

    def feed(chunks):
        return [SensorChunk(*c[:3], c.depth if depth else None)
                for c in chunks]

    sched = {}
    for name, feeds, start in (
            ("founders", {i: feed(f[:half] if i < SERVE_CHURN else f)
                          for i, f in enumerate(founders)}, 0),
            ("late", {WIRE_LATE + j: feed(f) for j, f in enumerate(late)},
             half)):
        path = str(tmp / f"{name}.wtrace")
        trace.record_streams(feeds, path, chunk_period_ns=1,
                             open_close=False, start_ns=start)
        for rec in trace.TraceReader(path):
            frame = codec.decode_frame(rec.message)
            sched.setdefault(rec.timestamp_ns, []).append(
                (frame.stream_id, frame.chunk))
    return sched


def count_groups(srv):
    """Count the rung groups ``srv`` dispatches (each launches every kernel
    of the step once a frame for all its slots) in ``srv.groups``."""
    srv.groups = 0
    body = srv._rung_body

    def counted(k):
        srv.groups += 1
        return body(k)

    srv._rung_body = counted


def check_launches(label, wrappers, groups, per_frame_qconv, counted):
    rm = wrappers["reproject_match_fused"].launches
    qc = wrappers["int8_matmul_pallas/qconv"].launches
    _need(groups > 0 and rm == CHUNK * groups
          and qc == per_frame_qconv * CHUNK * groups,
          f"{label}: {rm} rm_fused and {qc} qconv launches for {groups} "
          f"rung groups of {CHUNK} frames")
    counted["reproject_match_fused/slots"] += rm
    counted["int8_matmul_pallas/qconv/slots"] += qc
    return rm, qc


def wire_server(device, models):
    from repro_torch.api import EPICCompressor
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve import ServerConfig, StreamServer
    from repro_torch.wire.server import IngestServer

    srv = StreamServer(
        EPICCompressor(pipe.EPICConfig(prefilter_k=SERVE_LADDER[0]), models,
                       device=device),
        ServerConfig(capacity=SERVE_SLOTS, chunk_frames=CHUNK,
                     k_ladder=SERVE_LADDER, eviction="lru"))
    return srv, IngestServer(srv, strict_seq=True)


def wire_run(torch, device, models, sched, plan=None):
    """Phase 16's schedule through ``Loopback`` into an ``IngestServer``
    (strict seqs) in front of a ``StreamServer``, each stream driven by a
    ``ResumableSession``, through a ``FaultyTransport`` when ``plan`` is
    given; one tick a round, the tick timed as phase 16's.  Returns
    ``(server, ingest, tick seconds, host seconds of each data frame's
    decode and submit, sessions, wall seconds of the run: encode, link,
    decode, submit and ticks)``."""
    from repro_torch.wire.fault import FaultyTransport
    from repro_torch.wire.server import Loopback, ResumableSession

    srv, ingest = wire_server(device, models)
    count_groups(srv)
    host = []
    handle = ingest.handle_message

    def timed(msg):
        t0 = time.perf_counter()
        out = handle(msg)
        if bytes(memoryview(msg)[:4]) == b"EPWF":
            host.append(time.perf_counter() - t0)
        return out

    ingest.handle_message = timed
    link = Loopback(ingest)
    if plan is not None:
        link = FaultyTransport(link, plan)
    sessions, ticks = {}, []
    half = SERVE_CHUNKS // 2
    wall = time.perf_counter()
    for t in range(SERVE_CHUNKS):
        if t == half:
            for i in range(SERVE_CHURN):
                _need(sessions.pop(i).close().ok, f"CLOSE {i} refused")
        for sid, chunk in sched[t]:
            if sid not in sessions:
                sessions[sid] = ResumableSession(link, sid, window=32,
                                                 drain=ingest.tick)
                _need(sessions[sid].open().ok, f"OPEN {sid} refused")
            _need(sessions[sid].send_chunk(chunk).ok,
                  f"stream {sid} seq {t} not delivered")
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ingest.tick()
        ticks.append(time.perf_counter() - t0)
    if plan is not None:
        # A frame lost at a stream's end has no later frame to reveal the
        # gap: the link turns clean, every session resumes and replays
        # what the server lacks from its window.
        plan.rates = {}
        for s in sessions.values():
            s.resume()
    while any(len(q) for q in srv._queues.values()):
        ingest.tick()
    torch.cuda.synchronize(device)
    return srv, ingest, ticks, host, sessions, time.perf_counter() - wall


def compare_direct(torch, direct, srv, label, exact):
    """Every live stream of the wire run against phase 16's direct run of
    the same chunks: ``k_trajectory`` and counters equal, the state
    bitwise (``exact``) or integers equal and floats within
    ``SERVE_FLOAT_TOL``; returns the largest float difference."""
    ids = wire_ids()
    _need(sorted(ids[s] for s in srv.live_sessions)
          == sorted(direct.live_sessions),
          f"{label}: live streams {sorted(srv.live_sessions)} are not the "
          f"direct run's")
    worst = 0.0
    for sid in srv.live_sessions:
        mine, theirs = srv.telemetry(sid), direct.telemetry(ids[sid])
        _need(list(mine.k_trajectory) == list(theirs.k_trajectory)
              and (mine.n_chunks, mine.n_processed, mine.n_inserted)
              == (theirs.n_chunks, theirs.n_processed, theirs.n_inserted),
              f"{label} {sid}: k_trajectory or counters differ from the "
              f"direct run")
        for i, (a, b) in enumerate(zip(state_leaves(srv.state(sid)),
                                       state_leaves(direct.state(ids[sid])))):
            same = torch.equal(a, b)
            if a.dtype.is_floating_point and not exact:
                worst = max(worst, float((a - b).abs().max()))
            else:
                _need(same, f"{label} {sid}: state leaf {i} is not the "
                      "direct run's")
    _need(worst <= SERVE_FLOAT_TOL, f"{label}: a float state leaf differs "
          f"from the direct run by {worst:.3g}")
    return worst


def serve_in_thread(ingest, path):
    """``ingest.serve_unix(path)`` on an asyncio loop of its own thread;
    returns ``(stop, thread)``: ``stop()`` ends the loop after cancelling
    its connection handlers."""
    import asyncio
    import threading

    loop = asyncio.new_event_loop()
    up = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        server = loop.run_until_complete(ingest.serve_unix(path))
        up.set()
        loop.run_forever()
        server.close()
        tasks = asyncio.all_tasks(loop)
        for task in tasks:
            task.cancel()
        loop.run_until_complete(asyncio.gather(*tasks,
                                               return_exceptions=True))
        loop.close()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    _need(up.wait(60), "serve_unix did not start")

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        _need(not thread.is_alive(), "the receiver thread did not stop")

    return stop


def unix_run(torch, device, models, sched, tmp, threaded):
    """The short run (``WIRE_SHORT`` streams, 3 chunks) through
    ``serve_unix`` (``threaded``: an asyncio receiver thread submits while
    another thread ticks) or through ``Loopback``; returns the server."""
    import threading

    from repro_torch.wire import codec
    from repro_torch.wire.server import Loopback, WireClient

    srv, ingest = wire_server(device, models)
    rounds = [[(sid, c) for sid, c in sched[t] if sid < WIRE_SHORT]
              for t in range(3)]
    if not threaded:
        client, tick = Loopback(ingest), ingest.tick
    else:
        path = str(tmp / "short.sock")
        stop = serve_in_thread(ingest, path)
        client = WireClient(unix_path=path, timeout=60)

        def tick():
            ticker = threading.Thread(target=ingest.tick)
            ticker.start()
            ticker.join(120)
            _need(not ticker.is_alive(), "a tick thread did not finish")
    try:
        for sid in range(WIRE_SHORT):
            _need(client.send(codec.encode_control(codec.OP_OPEN, sid)).ok,
                  f"OPEN {sid}")
        for t, batch in enumerate(rounds):
            for sid, chunk in batch:
                _need(client.send(codec.encode_chunk(
                    chunk, stream_id=sid, seq=t, timestamp_ns=t)).ok,
                    f"stream {sid} seq {t}")
            tick()
    finally:
        if threaded:
            client.close()
            stop()
    return srv


def phase_wire(torch, device, card, ctx):
    """Phase 17 (a) wire serving, (b) crash and restore; returns the
    ``/slots`` rows' launches with these runs' added."""
    import tempfile

    from repro_torch.core import pipeline as pipe
    from repro_torch.runtime.fault import FaultPlan

    counted = dict(ctx["counted"])
    wrappers = kernel_wrappers()
    oracle = pipe.EPICModels()
    (ROOT / "build").mkdir(exist_ok=True)  # ignored by git
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        tmp = Path(d)
        oracle_sched = wire_schedule(ctx["founders"], ctx["late"], True, tmp)
        runs = {}
        for label, models, qconvs, sched, direct, exact in (
                ("oracle depth", oracle, 0, oracle_sched, ctx["flat"], True),
                ("int8 depth", ctx["qmodels"], len(DEPTH_GEMMS),
                 wire_schedule(ctx["founders"], ctx["late"], False, tmp),
                 ctx["int8"], False)):
            plan = FaultPlan(seed=SEED, rates=WIRE_FAULTS, warmup=SERVE_LIVE)
            for w in wrappers.values():
                w.launches = 0
            srv, ingest, ticks, host, sessions, wall = wire_run(
                torch, device, models, sched, plan)
            rm, qc = check_launches(f"wire, {label}", wrappers, srv.groups,
                                    qconvs, counted)
            worst = compare_direct(torch, direct, srv, f"wire, {label}",
                                   exact)
            _need(all(v == 1 for v in srv.step_cache_sizes().values()),
                  f"wire, {label}: a step program was built twice")
            runs[label] = (srv, ingest, ticks, host, sessions, wall)
            print(f"[17a] wire, {label}: {len(srv.live_sessions)} live "
                  f"streams through Loopback, FaultyTransport "
                  f"{dict(plan.counts)} and ResumableSession (strict seqs): "
                  + ("bitwise the direct run" if exact else
                     f"integers equal to the direct run, largest float "
                     f"difference {worst:.3g}")
                  + f"; {srv.groups} rung groups, rm_fused {rm}, qconv {qc}")
        srv, ingest, ticks, host, sessions, wall = runs["oracle depth"]
        frames = srv.frames_served
        steady = sorted(ticks[1:])
        med, p99 = steady[len(steady) // 2], steady[
            min(len(steady) - 1, int(0.99 * len(steady)))]
        hsort = sorted(host)
        retrans = {k: sum(getattr(s, k) for s in sessions.values())
                   for k in ("n_retransmits", "n_damage_retries",
                             "n_already_served", "n_resumes")}
        print(f"[17d] {card}: wire, oracle depth: {len(host)} data frames "
              f"decoded and submitted, host time a chunk median "
              f"{hsort[len(hsort) // 2] * 1e3:.3f} ms, p99 "
              f"{hsort[int(0.99 * len(hsort))] * 1e3:.3f} ms; "
              f"{frames / wall:.1f} wire frames/s aggregate ({frames} "
              f"frames served in {wall:.3f} s of wall time: encode, link, "
              f"decode, submit and ticks; {frames / sum(ticks):.1f} over "
              f"the ticks alone); tick latency median {med * 1e3:.1f} ms, p99 "
              f"{p99 * 1e3:.1f} ms through the wire, direct (phase 16) "
              f"median {ctx['tick_ms'][0]:.1f} ms, p99 "
              f"{ctx['tick_ms'][1]:.1f} ms; NACKs by reason "
              f"{ingest.nacks}; session recovery {retrans}")

        a = unix_run(torch, device, oracle, oracle_sched, tmp, False)
        b = unix_run(torch, device, oracle, oracle_sched, tmp, True)
        for sid in range(WIRE_SHORT):
            _need(all(torch.equal(x, y) for x, y in zip(
                state_leaves(a.state(sid)), state_leaves(b.state(sid)))),
                f"serve_unix {sid}: differs from the Loopback run")
        print(f"[17a] serve_unix with ticks on another thread: "
              f"{WIRE_SHORT} streams x 3 chunks bitwise the Loopback run")

        crash_and_restore(torch, device, ctx, oracle_sched, tmp, counted)
    return counted


# -- (b) crash and restore: the serving process is killed and restored in a
# fresh one, the clients in this process resuming over a Unix socket.


class _Supervisor:
    """Runs the serving process (``chip_smoke.py --wire-server``) and,
    when it has died, starts the restoring one in its place."""

    def __init__(self, sock, ckpt, done):
        self.sock, self.ckpt, self.done = sock, ckpt, done
        self.procs = []
        self.restarted = False
        self.start("fresh")

    def start(self, mode):
        import os

        if os.path.exists(self.sock):
            os.unlink(self.sock)
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--wire-server",
             mode, self.sock, self.ckpt, self.done],
            stdout=subprocess.PIPE, text=True)
        self.procs.append((mode, proc, []))
        for line in proc.stdout:
            line = line.rstrip("\n")
            if line == "ready":
                return
            self.procs[-1][2].append(line)
            print(line, flush=True)
        raise AssertionError(f"the {mode} serving process exited before it "
                             f"was ready ({proc.wait()})")

    def ensure_up(self):
        mode, proc, _ = self.procs[-1]
        _need(proc.poll() is None or mode == "fresh",
              f"the restoring process died ({proc.returncode})")
        if proc.poll() is not None:
            for line in proc.stdout:
                print(line.rstrip("\n"), flush=True)
            _need(proc.returncode != 0, "the serving process ended on its "
                  "own before the crash")
            self.restarted = True
            self.start("restore")

    def finish(self):
        mode, proc, _ = self.procs[-1]
        out, _ = proc.communicate(timeout=300)
        lines = out.splitlines()
        for line in lines[:-1]:
            print(line, flush=True)
        _need(proc.returncode == 0 and lines,
              f"the {mode} serving process failed ({proc.returncode})")
        return json.loads(lines[-1])


class _Redial:
    """A ``WireClient`` whose redial first makes sure a serving process is
    up (the supervisor restores a dead one)."""

    def __init__(self, sup):
        from repro_torch.wire.server import WireClient

        self.sup = sup
        self.client = WireClient(unix_path=sup.sock, timeout=120,
                                 reconnect_attempts=50, backoff_max=0.5)

    def send(self, msg):
        return self.client.send(msg)

    def reconnect(self):
        self.sup.ensure_up()
        self.client.reconnect()


def clients_run(sup, sched):
    """The clients of phase 17 (b): phase 16's schedule, one
    ``ResumableSession`` a stream over its own socket; a client whose
    stream the restored checkpoint predates opens it again and replays its
    window from seq 0, and a close it predates is made again.  Returns the
    restored process's results, the sessions, and the newest checkpoint's
    bytes on disk and step."""
    from repro_torch.checkpoint import store
    from repro_torch.wire import codec
    from repro_torch.wire.server import ResumableSession, ResumeError

    sessions, closed = {}, []
    half = SERVE_CHUNKS // 2

    link = _Redial(sup)

    def control(op, sid, ok_also):
        for _ in range(3):
            try:
                r = link.send(codec.encode_control(op, sid))
            except (ConnectionError, OSError):
                link.reconnect()
                continue
            _need(r.ok or r.status_name in ok_also, f"{op} {sid}: {r}")
            return
        raise AssertionError(f"control {op} for {sid} undeliverable")

    def wait():
        time.sleep(0.002)  # the serving process ticks on its own

    def send(sid, chunk):
        s = sessions[sid]
        try:
            _need(s.send_chunk(chunk).ok, f"stream {sid} not delivered")
        except ResumeError as e:
            # Opened after the restored checkpoint: open again and replay
            # the whole window.
            _need("unknown_stream" in str(e), str(e))
            control(codec.OP_OPEN, sid, ())
            s.last_acked = -1
            s.resume()

    for t in range(SERVE_CHUNKS):
        if sup.restarted and closed:
            # A close the restored checkpoint predates is made again.
            for sid in closed:
                control(codec.OP_CLOSE, sid, ("unknown_stream",))
            closed = []
        if t == half:
            for i in range(SERVE_CHURN):
                sessions.pop(i)
                control(codec.OP_CLOSE, i, ("unknown_stream",))
                closed.append(i)
        for sid, chunk in sched[t]:
            if sid not in sessions:
                sessions[sid] = ResumableSession(_Redial(sup), sid,
                                                 window=32, drain=wait,
                                                 max_retries=5000)
                control(codec.OP_OPEN, sid, ("dup_stream",))
            send(sid, chunk)
    if closed and sup.restarted:
        for sid in closed:
            control(codec.OP_CLOSE, sid, ("unknown_stream",))
    _need(sup.restarted, f"the serving process was not killed at tick "
          f"{WIRE_CRASH_TICK}")
    Path(sup.done).touch()
    result = sup.finish()
    link.client.close()
    for s in sessions.values():
        s.transport.client.close()
    steps = store.complete_steps(sup.ckpt)
    step_dir = Path(sup.ckpt) / f"step_{steps[-1]:08d}"
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    return result, sessions, nbytes, steps[-1]


def crash_and_restore(torch, device, ctx, sched, tmp, counted):
    """Phase 16's oracle schedule through a Unix socket into a serving
    process that checkpoints every ``WIRE_CKPT_EVERY`` ticks and is killed
    at tick ``WIRE_CRASH_TICK``; a fresh process restores the newest
    complete checkpoint with the wire cursors, the clients RESUME and
    replay from their windows, and every live stream must end bitwise equal
    to the uninterrupted direct run, with one step program a variant."""
    from repro_torch.api import EPICCompressor
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve.checkpoint import restore_server

    sup = _Supervisor(str(tmp / "serve.sock"), str(tmp / "ckpt"),
                      str(tmp / "done"))
    try:
        result, sessions, nbytes, step = clients_run(sup, sched)
    finally:
        for _, proc, _ in sup.procs:  # no serving process outlives this
            if proc.poll() is None:
                proc.kill()
                proc.wait(60)
    counted["reproject_match_fused/slots"] += result["rm_fused"]
    counted["int8_matmul_pallas/qconv/slots"] += result["qconv"]
    _need(result["rm_fused"] == CHUNK * result["groups"]
          and result["qconv"] == 0 and result["groups"] > 0,
          f"restored run: launches {result}")
    _need(all(v == 1 for v in result["programs"]),
          f"restored run: step programs {result['programs']}")
    comp = EPICCompressor(pipe.EPICConfig(prefilter_k=SERVE_LADDER[0]),
                          pipe.EPICModels(), device=device)
    srv, _, _ = restore_server(result["final"], comp)
    worst = compare_direct(torch, ctx["flat"], srv, "crash and restore",
                           True)
    resumes = sum(s.n_resumes for s in sessions.values())
    print(f"[17b] crash at tick {WIRE_CRASH_TICK}, restored from step "
          f"{result['restored_step']} in a fresh process: "
          f"{len(srv.live_sessions)} live streams bitwise the uninterrupted "
          f"direct run ({resumes} RESUMEs); restored run {result['ticks']} "
          f"ticks, {result['groups']} rung groups, rm_fused "
          f"{result['rm_fused']}, qconv {result['qconv']}, programs "
          f"{result['programs']}")
    _need(worst == 0.0, "crash and restore: not bitwise")
    print(f"[17d] checkpoint on disk: {nbytes} bytes for step {step} "
          f"of a {SERVE_SLOTS}-slot pool, {nbytes / SERVE_SLOTS:.0f} bytes a "
          f"slot (queued chunks and metadata included)")


def card_device(torch):
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


def wire_server_main(mode, sock, ckpt, done) -> int:
    """``chip_smoke.py --wire-server MODE SOCK CKPT DONE``: the serving
    process of phase 17 (b).  ``fresh`` builds the server, checkpoints
    every ``WIRE_CKPT_EVERY`` ticks and kills itself at tick
    ``WIRE_CRASH_TICK``; ``restore`` restores the newest complete
    checkpoint with its wire cursors, serves to the end (the file DONE
    exists and every queue is empty), saves a final checkpoint and prints
    its results as one JSON line, last.  Ticks run on this thread, the
    receiver on an asyncio thread; a tick runs when every live stream has
    a chunk queued, when a stream's queue is full, or when the socket has
    been quiet for ``WIRE_QUIET_S``."""
    import os
    import signal

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    device = card_device(torch)
    set_numerics(torch)
    from repro_torch.api import EPICCompressor
    from repro_torch.core import pipeline as pipe
    from repro_torch.serve.checkpoint import (ServeCheckpointer,
                                              restore_server, save_server)

    t_start = time.perf_counter()
    if mode == "fresh":
        srv, ingest = wire_server(device, pipe.EPICModels())
        restored_step = None
    else:
        comp = EPICCompressor(pipe.EPICConfig(prefilter_k=SERVE_LADDER[0]),
                              pipe.EPICModels(), device=device)
        t_restore = time.perf_counter()
        srv, ingest, restored_step = restore_server(ckpt, comp,
                                                    with_ingest=True)
        torch.cuda.synchronize(device)
        print(f"[17d] restore_server: {time.perf_counter() - t_restore:.3f}"
              f" s (read step {restored_step}, copies in place)", flush=True)
        _need(srv.step_cache_sizes() == {}, "restore built a step program")
    ckpt_writer = ServeCheckpointer(ckpt, srv, every_ticks=WIRE_CKPT_EVERY,
                                    ingest=ingest)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    count_groups(srv)
    last_msg = [time.monotonic()]
    handle = ingest.handle_message

    def stamped(msg):
        last_msg[0] = time.monotonic()
        return handle(msg)

    ingest.handle_message = stamped
    stop = serve_in_thread(ingest, sock)
    print("ready", flush=True)
    ticks, first_tick = [], None
    while True:
        lens = [len(q) for q in srv._queues.values()]
        queued = sum(lens)
        quiet = time.monotonic() - last_msg[0] > WIRE_QUIET_S
        if queued and (queued >= len(lens) or quiet
                       or max(lens) >= srv.cfg.queue_depth):
            t0 = time.perf_counter()
            ingest.tick()
            torch.cuda.synchronize(device)
            ticks.append(time.perf_counter() - t0)
            if first_tick is None and mode == "restore":
                first_tick = time.perf_counter()
                print(f"[17d] restore: {first_tick - t_restore:.3f} s from "
                      f"restore_server to the end of the first served tick "
                      f"(the clients' reconnects and the step program's "
                      f"build included; {first_tick - t_start:.3f} s from "
                      f"the process's start of serving)", flush=True)
            t0 = time.perf_counter()
            if ckpt_writer.maybe_save():
                print(f"[17d] checkpoint at tick {srv.n_ticks}: snapshot "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms on the tick "
                      f"path (the write runs on a thread)", flush=True)
            if mode == "fresh" and srv.n_ticks == WIRE_CRASH_TICK:
                print(f"[17b] serving process: killed at tick "
                      f"{srv.n_ticks}", flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
        elif os.path.exists(done) and not queued:
            break
        else:
            time.sleep(0.0005)
    rm = wrappers["reproject_match_fused"].launches
    qc = wrappers["int8_matmul_pallas/qconv"].launches
    ckpt_writer.wait()
    final = str(Path(ckpt).parent / "final")
    save_server(final, srv.n_ticks, srv, ingest=ingest)  # takes the lock
    stop()
    print(json.dumps({"rm_fused": rm, "qconv": qc, "groups": srv.groups,
                      "ticks": len(ticks), "restored_step": restored_step,
                      "programs": list(srv.step_cache_sizes().values()),
                      "final": final}))
    return 0


# -- (c) EVU on the card: benchmarks/evu_accuracy.py's protocol, setting 1.


def evu_streams(torch, device, seed, n):
    """``n`` seeded 64x64 streams of ``EVU_FRAMES`` frames, ``EVU_OBJ``
    objects, ``EVU_SEG`` fixation segments, rendered on the card."""
    import numpy as np

    from repro_torch.data import synthetic

    cfg = synthetic.StreamConfig(n_frames=EVU_FRAMES, hw=(EVU_HW, EVU_HW),
                                 n_obj=EVU_OBJ, n_segments=EVU_SEG)
    return [synthetic.generate_stream(np.random.default_rng(seed + i), cfg,
                                      device=device)[0] for i in range(n)]


def evu_train_hir(torch, device, streams):
    """Fine-tune the HIR network on attended-object relevance labels: the
    benchmark's 300 SGD steps at lr 0.05, batch 64."""
    from repro_torch.core import depth as depth_mod
    from repro_torch.core import hir as hir_mod
    from repro_torch.data import synthetic

    rgb = torch.cat([depth_mod.resize_image(s.frames, hir_mod.HIR_INPUT)
                     for s in streams])
    heat = torch.cat([hir_mod.gaze_heatmap(s.gazes, hir_mod.HIR_INPUT,
                                           (EVU_HW, EVU_HW))
                      for s in streams])
    lab = torch.cat([synthetic.patch_relevance_labels(
        s.obj_id, s.gaze_target, EVU_PATCH) for s in streams])
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    model = hir_mod.init_params(g)
    grid = EVU_HW // EVU_PATCH
    for _ in range(300):
        idx = torch.randint(0, rgb.shape[0], (64,), generator=g,
                            device=device)
        loss = hir_mod.loss_fn(model, rgb[idx], heat[idx], lab[idx], grid)
        model.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.05 * p.grad
    return model, float(loss.detach())


def evu_tokens(torch, device, streams, hir_model):
    """EPIC at setting 1 (DC buffer ``EVU_CAP``) over every stream, one
    ``StreamPool`` step a chunk; each export packed into ``EVU_CAP`` tokens
    with the gaze-proximity saliency of ``benchmarks/evu_accuracy.py``."""
    from repro_torch.api import EPICCompressor, SensorChunk, StreamPool
    from repro_torch.core import packing
    from repro_torch.core import pipeline as pipe

    cfg = pipe.EPICConfig(frame_hw=(EVU_HW, EVU_HW), patch=EVU_PATCH,
                          capacity=EVU_CAP, tau=0.10, gamma=0.015, theta=8,
                          window=16)
    comp = EPICCompressor(cfg, pipe.EPICModels(hir_model=hir_model),
                          device=device)
    pool = StreamPool(comp, len(streams))
    states = pool.init()
    with torch.no_grad():
        for lo in range(0, EVU_FRAMES, CHUNK):
            chunk = SensorChunk(*(torch.stack([getattr(s, f)[lo:lo + CHUNK]
                                               for s in streams])
                                  for f in ("frames", "poses", "gazes",
                                            "depth")))
            states, _ = pool.step(states, chunk)
        rps = pool.export(states)
    out = []
    for i, s in enumerate(streams):
        rp = type(rps)(*(None if x is None else x[i] for x in rps))
        ti = rp.t.to(torch.int32).clamp(0, s.gazes.shape[0] - 1)
        center = rp.origin.flip(-1) + EVU_PATCH / 2.0
        d = torch.linalg.norm(center - s.gazes[ti.long()], dim=-1)
        prox = torch.exp(-0.5 * (d / EVU_PATCH) ** 2)
        out.append(packing.pack_retained(rp, EVU_CAP, float(EVU_FRAMES),
                                         float(EVU_HW), saliency=prox))
    return out


def evu_questions(torch, streams, token_sets):
    """(stream tokens, segment) -> attended-object questions, as
    ``benchmarks/evu_accuracy.py:162-185`` builds them."""
    toks, masks, segs, labels = [], [], [], []
    for s, ts in zip(streams, token_sets):
        seg_of = s.segment_of_frame.cpu()
        tgt = s.gaze_target.cpu()
        targets = [int(tgt[seg_of == seg][0]) for seg in range(EVU_SEG)]
        for seg in range(EVU_SEG):
            toks.append(ts.tokens)
            masks.append(ts.mask)
            segs.append(seg)
            labels.append(targets[seg] - 1)
    dev = toks[0].device
    return {"tokens": torch.stack(toks), "mask": torch.stack(masks),
            "seg": torch.tensor(segs, dtype=torch.int32, device=dev),
            "label": torch.tensor(labels, dtype=torch.int32, device=dev)}


def phase_evu(torch, device, card):
    """Phase 17 (c): the EVU probe on the card, trained as Table 1's
    setting 1, and its forward, gradient and Adam step against the CPU."""
    from repro_torch.core import evu

    train = evu_streams(torch, device, SEED + 3000, EVU_TRAIN)
    test = evu_streams(torch, device, SEED + 4000, EVU_TEST)
    hir_model, hir_loss = evu_train_hir(torch, device, train)
    train_ds = evu_questions(torch, train,
                             evu_tokens(torch, device, train, hir_model))
    test_ds = evu_questions(torch, test,
                            evu_tokens(torch, device, test, hir_model))
    cfg = evu.EVUConfig(n_classes=EVU_OBJ, n_segments=EVU_SEG, batch=16,
                        d_model=64, lr=2e-3, steps=450)
    _need(tuple(train_ds["tokens"].shape[1:]) == (EVU_CAP, 198)
          and bool(train_ds["mask"].any()), "EVU: token streams malformed")

    # forward, the gradient of loss_fn and one Adam step: card vs CPU
    p0 = evu.init_params(torch.Generator(device=device).manual_seed(SEED),
                         cfg)
    batch = {k: x[:cfg.batch] for k, x in train_ds.items()}
    cpu = {k: x.cpu() for k, x in batch.items()}
    p_cpu = evu.tree_map(lambda x: x.cpu(), p0)
    errs = {}
    errs["forward"] = float((evu.forward(p0, batch["tokens"], batch["mask"],
                                         batch["seg"], cfg).cpu()
                             - evu.forward(p_cpu, cpu["tokens"], cpu["mask"],
                                           cpu["seg"], cfg)).abs().max())
    _, g = evu.grad(p0, batch, cfg)
    _, g_cpu = evu.grad(p_cpu, cpu, cfg)
    errs["grad"] = max(float((a.cpu() - b).abs().max()
                             / max(1.0, float(b.abs().max())))
                       for a, b in zip(evu.leaves(g), evu.leaves(g_cpu)))
    # The Adam update is held on one gradient, the CPU's (the gradients
    # themselves are held above): Adam's first step is lr * g / (|g| + eps),
    # so a gradient entry within rounding of 0 may take either sign.
    zeros = evu.tree_map(torch.zeros_like, p0)
    zeros_cpu = evu.tree_map(torch.zeros_like, p_cpu)
    p1 = evu.adam_update(p0, zeros, zeros,
                         evu.tree_map(lambda x: x.to(device), g_cpu), 0,
                         cfg)[0]
    p1_cpu = evu.adam_update(p_cpu, zeros_cpu, zeros_cpu, g_cpu, 0, cfg)[0]
    errs["adam"] = max(float((a.cpu() - b).abs().max())
                       for a, b in zip(evu.leaves(p1), evu.leaves(p1_cpu)))
    _need(all(v <= EVU_TOL for v in errs.values()),
          f"EVU on the card differs from the CPU: {errs}")

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    acc, params = evu.train_eval(SEED, train_ds, test_ds, cfg, device=device)
    torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    _need(all(bool(torch.isfinite(x).all()) for x in evu.leaves(params)),
          "EVU: non-finite parameters after training")
    _need(acc > 1.0 / EVU_OBJ, f"EVU: test accuracy {acc:.3f} is no better "
          f"than chance ({1 / EVU_OBJ:.2f})")
    print(f"[17c] EVU on the card: forward, gradient (relative to the "
          f"leaf's scale) and one Adam update on the CPU's gradient against "
          f"the CPU: "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (limit {EVU_TOL:g})")
    print(f"[17d] {card}: EVU (Table 1 setting 1: {EVU_TRAIN} train and "
          f"{EVU_TEST} test streams, DC buffer {EVU_CAP}, HIR fine-tuned to "
          f"loss {hir_loss:.4f}): {cfg.steps} Adam steps in {dt:.2f} s, "
          f"{cfg.steps / dt:.1f} train steps/s; test accuracy {acc:.4f} on "
          f"{test_ds['label'].shape[0]} questions")


# ---------------------------------------------------------------------------


def phase_serve_process() -> dict:
    """Phases 16-17 in a process of its own (``chip_smoke.py --serve``), on the
    libraries phase 1 built: after the earlier phases, ``torch.profiler``
    in this process recorded no device event for phase 16's calls (a
    fresh process records them; the cause was not found).  Its lines pass
    through; its last line is its results as JSON."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--serve"], stdout=subprocess.PIPE, text=True,
                         timeout=900)
    lines = out.stdout.splitlines()
    # The last line is the results' JSON, unless the process failed.
    print("\n".join(lines[:-1] if out.returncode == 0 else lines),
          flush=True)
    _need(out.returncode == 0 and lines,
          f"phases 16-17 failed (exit {out.returncode})")
    return json.loads(lines[-1])["serve"]


def serve_main() -> int:
    """``chip_smoke.py --serve``: phases 16 and 17; prints their results
    as one JSON line, last."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    set_numerics(torch)
    errs, times = phase_serve_kernels(torch, device)
    card = card_line()
    ctx = phase_serve(torch, device, card)
    launches = phase_wire(torch, device, card, ctx)
    phase_evu(torch, device, card)
    print(json.dumps({"serve": {"errs": errs, "times": times,
                                "launches": launches}}))
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    phase_build(torch)
    errs = phase_kernels(torch, device)
    times = phase_times(torch, device)
    launches = phase_main_path(torch, device)
    errs.update(phase_flash(torch, device))
    times.update(phase_flash_times(torch, device))
    launches.update(phase_efm(torch, device, kernel_wrappers()))
    phase_efm_profile(torch, device)
    operands, *i8_errs = phase_int8(torch, device)
    errs["int8_matmul_pallas"], errs["int8_matmul_pallas/qconv"] = i8_errs
    times.update(phase_int8_times(torch, device, operands))
    i8_launches, epic = phase_int8_main_path(torch, device)
    launches.update(i8_launches)
    phase_baselines(torch, device, epic)
    errs.update(phase_scans(torch, device))
    times.update(phase_scan_times(torch, device))
    launches.update(phase_recurrent(torch, device, kernel_wrappers()))
    for name, n in phase_zoo(torch, device, kernel_wrappers(), epic,
                             card).items():
        launches[name] += n
    torch.cuda.empty_cache()  # the card's memory to phase 19's process
    dist = phase_dist_process(phase_train_process())
    phase_dryrun_process(dist, card)
    serve = phase_serve_process()
    errs.update(serve["errs"])
    times.update(serve["times"])
    launches.update(serve["launches"])

    rows = []
    for name, (replaces, source) in KERNELS.items():
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=launches[name], max_abs_err=errs[name],
                   library_ms=None)
        row.update(times[name])
        rows.append(row)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--wire-server"]:
        sys.exit(wire_server_main(*sys.argv[2:6]))
    if sys.argv[1:] == ["--train"]:
        sys.exit(train_main())
    if sys.argv[1:] == ["--dist"]:
        sys.exit(dist_main())
    if sys.argv[1:] == ["--dryrun"]:
        sys.exit(dryrun_main())
    sys.exit(serve_main() if sys.argv[1:] == ["--serve"] else main())
