#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --backward-times [ROOT]
    python3 chip_smoke.py --forward-times [ROOT]
    python3 chip_smoke.py --semamba

The second form runs only the builds and phase 7 with the chip_smoke.py
and the package of the checkout at ROOT (default: this one), then prints
one JSON line of every backward case's times, each backward kernel's
device time at the G step's shape and, for the wide backward, at G 404,
T 641, D 128 and 320, and the library route's backward at head dims 64,
128 and 320 in both types: run it on two checkouts in one call to
compare their kernels on one card. The third does the same
for kernel #1: the builds, then its cases at every shape of PERF.md's
kernel table, fp32 and bf16 (the wide heads' at D 80, 100, 128, 256 and
320 and D 128's offset case among them), against the plain version, the
128-channel 1-head model's enhance call and G step, the library route at
head dims 64, 128 and 320, and phase 9's G step against float64 at three
seeded batches. The fourth runs only phase 22, SEMamba's kernels, in
about a minute with their builds.

CMGAN at its full published width (64 channels, 4 TSCBs, 4 heads of dim
16, 201 bins, discriminator ndf 16) with seeded random weights, through
the hand-written CUDA kernels: offline enhancement, GAN training,
evaluation, streaming and the TCP server; then the 48 kHz long-form
preset (6 TSCBs, 601 bins) at its full width, and the published width
again with the JAX package's trained weights (phase 20).
Phases, each printing lines, none catching its own
failure, none falling back to the CPU or to a plain version:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the build of every kernel source (started together) and of the
     host PESQ scorer; each kernel's registers and spills, and the count of
     wgmma (HGMMA), TMA (UTMALDG or UBLKCP) and mma.sync (HMMA)
     instructions in each attention library, the forward, the backward and
     the wide ones (each fails without wgmma and TMA, or with mma.sync);
     the wide plan against the libraries: the forward's passes and the
     columns a consumer warpgroup owns, the backward's passes, how often
     each kernel computes a tile pair's logits;
  2. the attention forward kernel against its plain PyTorch version on the
     card, fp32 and bf16, at the 4 s bucket (T = 641) and the 16 s segment
     (T = 2561), each type with a t_valid < T case, q_offset = 128 and
     100 cases (the second with masked keys), masked keys at an offset at
     head dims 32 and 64, a max_pos = 64 case (most tile pairs clipped), a
     t_valid = 1 case and a max_pos = 1536 case, each also holding the
     row log-sum-exp against the plain logits' (LSE_TOL);
     head dims 8 (zero-padded to 16), 32 and 64; the tile-by-tile plain
     versions against both kernels at one small shape; a tiny model of 2
     heads of dim 8 through kernel #1 against 'xla'; the wide kernels
     (head dims over 64) at D 80, 100, 128, 256 and 320, the forward also
     at bf16 D 100 with masked keys and an offset (the producer's cp.async
     copies) and at t_valid 1, their walk's plain versions against them, the
     wide forward at D 64 beside kernel #1 (for the record), a 1-TSCB model
     of 128 channels in 1 head, 'auto' against 'xla' on a 6 s track and one
     G step, and one of 320 channels in 1 head;
  3. a 16 s track through Enhancer.enhance(mode='bucket') in fp32: exactly
     4 kernel launches, finite output of the input's length, agreement
     with attention_impl='xla', and the realtime factor;
  4. the same track in bf16 against fp32, and its realtime factor;
  5. enhance_batch on 16 two-second tracks (dense attention, no launches);
  6. the enhance CLI on a written 5 s wav, with --torch_ckpt and with
     --model_path on the same weights (two runs of one path, both rounded
     to 16 bits: within EVAL_TRACK_REL);
  7. the attention backward kernel against autograd through the plain
     version: fp32 and bf16 at the training shape (G = 1616, T = 641) and
     at T = 2561, a t_valid < T, a q_offset and a max_pos = 64 case, a
     t_valid = 1 case (dq, dk and dE are zero) and a max_pos = 1536 case
     (a table of 3073 rows); head dims 8, 32 and 64, fp32 and bf16; the
     wide backward at D 80, 100, 128, 256 and 320, and at D 128 with an
     offset and with one valid key, and its kernels' device time (D 128
     and 320) with and without the dq kernel's dE writes; every case run
     twice, its dq, dk, dv and dE bitwise equal; the fp32 kernels' and
     plain versions' distance from float64 at D 16 and, for the wide
     backward, D 128 (within WIDE_FLOAT64_FACTOR); the backward's device
     time by kernel;
  8. the fused LayerNorm kernel against its plain version and against
     F.layer_norm at [1616*321, 64] and [5136*101, 64], and at the widths
     63, 65, 513 and 1024, fp32 and bf16, forward and gradient, with the
     path its plan picks; [8b] the models' LayerNorm on it without
     autograd: 8 x 36000 and 8 x 16 s enhancement calls against
     nn.LayerNorm forced (1e-5), 40 launches a call, the calls' ms both
     ways, none in a train_step;
  9. one G step at cut_len 64000, batch 4, fp32: attention_impl='auto'
     (4 forward and 4 backward launches) against 'xla' (none), loss and
     every parameter's gradient; and both against the dense path in float64
     on one utterance, the kernels' path within GSTEP_TRUTH_FACTOR of dense
     fp32's distance;
 10. the train CLI on a written VCTK-DEMAND-shaped directory at cut_len
     64000: an epoch, its test pass and checkpoint, then --resume for one
     more; launch counts, moved parameters, the continued step counter,
     PESQ-invalid batches; d_step driven once with valid labels and once
     with a failed one;
 11. the train CLI at the default cut_len 32000 (no launches), host and
     host_async, fp32 and --bf16;
 12. utterances per second of Trainer.train_step for each of those and in
     the device label mode, the host PESQ scorer's share of a step, and a
     profile of one G step;
 13. the evaluate CLI on a written test dir of 8 pairs (2 to 20 s) with
     weights written by save_variables: bucketed fp32 and --bf16 (kernel
     launches as enhance_batch's grouping implies), --exact on two
     tracks; the aggregates, a saved track against Enhancer.enhance, the
     clean-against-clean scores, realtime factors and the host metrics'
     share of the wall time;
 14. the batched torch PESQ on the card against the same function on the
     CPU and against the host C++ scorer, a silent row's label, and its
     time a batch beside the host scorer's;
 15. the fused G + label + D step (pesq_label_mode='device') at cut_len
     64000: launch counts, the label and D phases, then the whole step,
     under torch.cuda.set_sync_debug_mode("error"), its D update against
     d_step fed the same labels, a failed label's bitwise undo, and one
     epoch of the train CLI with --pesq_label_mode device;
 16. the streaming engine, fp32 and bf16: a 20 s StreamingEnhancer stream
     pushed in blocks of 3000 and of 700 (equal, no launches at the default
     window), a StreamBatcher of 8 slots with 3 staggered streams against
     solo streams, the long-context window (left_context 48000, 601 frames)
     at 1 and 8 slots through kernel #1 (4 launches a tick) against 'xla',
     ms a tick and streams served in real time at 1/8/32 slots (default)
     and 1/8 (long context), a long-context tick's profile, and kernel #1
     at the streaming shapes (G 404 and 3232, T 601);
 17. the TCP server: solo mode in a thread (a 20 s track equal to the
     direct stream), 8 slots with 8 concurrent clients, then
     `python -m cmgan_torch.cli.serve --slots 4 --left_context 48000` as
     its own process with two clients and a SIGTERM shutdown, its streams
     against an fp32 batcher (the CLI pins TF32 off); every stream
     complete, no session aborted, each client's realtime factor;
 18. the 48 kHz long-form preset: a 30 s track (4801 frames) in bucket
     mode, fp32 and bf16, 6 launches of kernel #1 (G 1204, T 4801), its
     realtime factor, peak memory and device profile, and trace() around
     one call checked for the kernel; kernel #1 at that shape against its
     plain version; 'auto' against 'xla' on a 10 s track; the matmul DFT
     against torch.fft at n_fft 400 and 1200; the preset's train_step at
     its cut_len 96000;
 19. data and sequence parallelism (cmgan_torch.parallel): a NCCL process
     group of one rank; a device-label train_step at cut_len 64000 with
     mesh=make_mesh(...) against the same step without a mesh (losses and
     every state tensor bitwise), its second step under
     set_sync_debug_mode("error");
     seq_rel_attention's per-rank function for ranks 0 to 3 in one process
     at G 1204, T 4801 (t_loc 1280, keys padded to 5120), fp32 and bf16,
     forward against the unsharded kernel #1 and backward (kernel #2 at
     each offset, dk, dv, dE summed) against the unsharded kernel #2, each
     rank's backward run twice and bitwise equal, each
     rank's launches timed beside the unsharded one and the rank's plain
     versions; long_form_48k() with
     attention_impl='seq' at world 1 on a 30 s track against 'auto', and
     the preset's G step through 'seq' (kernels at T 384, t_valid 321)
     against 'xla', then one Trainer.train_step through 'seq'; over the same
     one-rank mesh, a Trainer whose train loader is sharded by data rank
     (load_data at the mesh's data size and rank) on a written dataset at
     cut_len 64000, batch 4: one epoch (one step) through train_epoch in the
     device and in the host label mode, each against the global-loader step
     on the same rows (every state tensor bitwise equal), with
     its launches; then host seconds a batch (prefetch 0) over one epoch of
     128 files for a global loader of 4 x 8 rows (what each of 8 data ranks
     read before loaders were sharded) and a local one of 4 rows at process 0
     of 8, beside [12]'s G step;
 20. trained weights: the JAX package's fold-1 EMA generator as
     tests/torch_data/r05_fold1_ema/generator.pt, loaded through
     inference.load_generator, on the 4 s track of golden_4s.npz in bucket
     mode: (a) fp32 through kernel #1 (4 launches) against the JAX
     package's own output, (b) against 'xla', (c) bf16 against fp32; (d) a
     16 s track 'auto' against 'xla' and bf16 against fp32; (e) one
     device-label train_step at cut_len 64000 from the trained generator,
     run twice from one state: every state tensor bitwise equal; against
     the JAX package's own outputs (golden_stream.npz, golden_gstep.npz):
     (f) a 2-slot StreamBatcher on golden_stream.npz's two tracks opened at
     its ticks, at the default window (361 frames, no launches) and the
     long-context one (601 frames, kernel #1 4 times a tick), every slot's
     emissions, fp32 and bf16; (g) `python -m cmgan_torch.cli.serve --slots
     2 --left_context 48000 --torch_ckpt ...generator.pt` as its own
     process with two concurrent clients, stopped by SIGTERM; (h) one
     Trainer G step (fp32, dropout 0, deterministic algorithms) at cut_len
     64000, batch 2, on golden_gstep.npz's seeded batch and discriminator:
     kernels #1 and #2 4 launches each, the loss and every parameter's
     gradient, and the worst parameter's distance from a float64 step;
 21. the bench (cmgan_torch.bench): every cell once at BENCH_REPS repeats
     with a traced window each, its JSON lines and summary printed, any
     failed check failing the run; the tools' lockstep ticks and the DSP's
     share; and the library route for kernels #1 and #2 at every shape of
     PERF.md's kernel table (the position bias formed as [G, Tq, Tk] by one
     einsum, then scaled_dot_product_attention with it; in chunks of
     groups where the bias is too large), fp32 and bf16, forward and
     backward, each part timed apart, the kernel timed beside it and held
     against it.
 22. SEMamba's kernels (csrc/selective_scan.cu, csrc/fused_rmsnorm.cu) at
     the shapes of the sem16k_eval_16s_b8_fp32 cell (8 x 16 s, d_inner
     256): the selective scan at 800 rows of 2561 steps and 20488 rows of
     100, both directions, on the layout the model gives it (z and dt, B,
     C strided views of the projections' outputs), against its plain
     version (SCAN_TOL) and bitwise equal on a second run; the causal conv
     + SiLU on the in-projection's strided half against its plain version
     and against F.conv1d + SiLU; RMSNorm at [2048800, 64] against its
     plain version and F.rms_norm; each timed (CUDA events and device
     time) beside its plain version, the library's call and its bounds
     (the scan's at the benchmark's operand boundary,
     perfbench.archs.semamba.scan_work, at its own operands and at the
     special-function units' rate); then one enhancement call of the
     published SEMamba on 8 x 16 s with the three launch counters set to
     0 just before it: 16 launches of each.

Then the phases' seconds and the whole run's, the card's line, a JSON line
with each kernel's numbers, and, last,
{"ok": true, "device": {...}}. Exits non-zero without CUDA, or without
the `cmgan_torch` package beside this file.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import inspect
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

STARTED = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000

# H100 SXM published peaks (700 W): fp32 outside the tensor cores, bf16
# dense tensor-core rate, HBM bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# the attention kernels' fp32 route: each product as six products of bf16 parts
ATTN_PEAK_FLOPS = {"float32": 989e12 / 6, "bfloat16": 989e12}
EXP_PER_CLOCK_SM = 16     # results of the special-function units, a clock and multiprocessor
# SEMamba's kernels against their plain versions (rtol, atol): float32 sums in
# another order, and the scan's decays by the fast 2^x unit (2 ulp) compounded
# over the row; a wrong state, skip, gate or direction misses them by far
SCAN_TOL = (1e-4, 1e-5)
CONV_TOL = (1e-5, 1e-6)
RMS_TOL = (1e-5, 1e-6)

# stated tolerances
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 8e-3)}  # (atol, rtol)
# kernel #1's row log-sum-exp against the plain logits' logsumexp, absolute:
# fp32 a few ulp of lse (~10 at these shapes); bf16 2^-9, since the kernel
# sums the weights after rounding each to bf16 for P . V (each within 2^-9
# of itself, so the sum, and its log within 2^-9)
LSE_TOL = {"float32": 1e-5, "bfloat16": 2 ** -9}
FLASH_VS_XLA_REL = 1e-4   # fp32: attention sums in another order (~1e-6), 100x margin
BF16_VS_FP32_REL = 5e-2   # bf16 keeps 8 significant bits; 1.6e-2 measured on a CPU run
PLAIN_GROUP_CHUNK = 32    # groups per plain-version call, so its [g, T, T] logits fit
# backward kernel against autograd through the plain version, as a share of
# the reference's largest entry: fp32 sums in another order (2e-6 seen; the
# table's gradient, whose rows 0 and 2*max_pos sum every distant pair, 4e-6);
# bf16 rounds each output once (2^-8 of its binade) and takes delta from the
# bf16-rounded forward output (5e-3 seen). Two runs of one case are bitwise
# equal: every backward path sums in a fixed order.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# fp32 kernels against float64, relative L2, over the plain fp32 versions' own
# distance: the kernels sum in another order and take exp by the fast unit
# (both ~1x seen); a tensor-core accumulator chain would show as ~8x
FLOAT64_FACTOR = 4.0
# the wide backward at head dim 128 against float64: its gradients at most this
# many times as far as the plain fp32 version's (its logits sum two depth
# chunks, each from zero, in fp32; its products on dS, dR, P^T and dS^T are
# fresh a tile and added in fp32)
WIDE_FLOAT64_FACTOR = 1.25
LN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (6.25e-2, 1.6e-2)}  # (atol, rtol); bf16: one ulp
# G step, flash against dense, fp32, relative L2: the loss and all gradients
# as one vector within GSTEP_REL, each parameter's gradient within
# GSTEP_PARAM_REL. The forward paths agree to ~1e-6, but float32 carries this
# net's gradient only to ~1e-3 (dense fp32 against dense fp64, measured in
# phase 9), and which cuDNN algorithms run shifts single parameters by as much.
GSTEP_REL = 1e-3
GSTEP_PARAM_REL = 5e-3
# against float64 the kernels' path may be this many times as far as dense
# fp32 (1.0001x at [9]'s batch, 1.0000x-1.015x at three more seeded batches:
# both sit at float32's own distance, which at one batch differs by up to 3x
# between two correct fp32 implementations)
GSTEP_TRUTH_FACTOR = 1.25
TRAIN_BATCH = 4
# the wide kernels' head dims in [2] / [7], and the models that run them: 128
# channels in 1 head (head dim 128), one TSCB, with its G step's batch; 320
# channels in 1 head (head dim 320: the forward's widest one-pass head)
WIDE_HEAD_DIMS = (80, 100, 128, 256, 320)
WIDE_MODEL = dict(num_channels=128, attn_heads=1, num_tscb_blocks=1)
WIDE_STEP_BATCH = 2
WIDEST_MODEL = dict(num_channels=320, attn_heads=1, num_tscb_blocks=1)
FLASH_CUT, DEFAULT_CUT = 64000, 32000   # 641 and 321 frames
EVAL_SECONDS = (2, 3, 4, 5, 6, 8, 12, 20)   # [13] the test dir's track lengths
EVAL_EXACT = ("p3.wav", "p7.wav")           # [13] --exact on the 5 s and 20 s tracks
EVAL_ALONE, EVAL_BATCHED = "p7.wav", "p2.wav"  # [13] the 20 s track; the 4 s one, in a batch
# [13] a saved track against Enhancer.enhance on the same weights, both rounded
# to 16-bit PCM as the CLI saves: the 20 s track takes the same path in both;
# [6] holds the enhance CLI's --model_path against its --torch_ckpt so too
EVAL_TRACK_REL = 1e-5
# [14] the torch PESQ on the card against the same function on the CPU, MOS:
# float32 FFTs of two libraries (1.2e-6 seen on the CPU against JAX)
PESQ_DEVICE_ATOL = 1e-3
# [15] D's parameters after the fused step against d_step fed the same labels
# from a copy of the state, relative L2 (cuDNN deterministic for both)
FUSED_VS_D_STEP_REL = 1e-5
# [16] streaming: the default window (24000 + 8000 + 4000 samples, 361 frames,
# dense attention) and the long-context one (48000 + 8000 + 4000, 601 frames,
# kernel #1 once a TSCB a tick)
CHUNK, LOOKAHEAD, LONG_CONTEXT = 8000, 4000, 48000
# a slot of a StreamBatcher against a solo StreamingEnhancer on the same
# chunks, relative L2: another batch size may make cuDNN choose another
# algorithm, which sums in another order (fp32: ~1e-7); in bf16 another order
# can move a result as far as bf16 stands from fp32
SLOT_VS_SOLO_REL = {"float32": 1e-5, "bfloat16": BF16_VS_FP32_REL}
STREAM_TICKS, STREAM_WARMUP = 20, 3   # timed ticks (median) after warm-up ticks
# [17] the served streams of the CLI's process (TF32 pinned off by its main())
# against an fp32 batcher of its slot count in this process, same seeded
# weights: another process may make cuDNN choose other fp32 algorithms, which
# sum in another order (~1e-7, as [16]'s slots against solo streams)
SERVE_PROCESS_REL = 1e-5
SERVE_WAIT = 300          # seconds any client or server start may take
# [18] the 48 kHz preset: 'auto' against 'xla' on a track whose dense logits
# fit the card; the matmul DFT against torch.fft (float32 sums of n_fft
# products in another order, ~1e-7 seen on the CPU); its train_step's batch
LONG_XLA_SECONDS = 10
MATMUL_DFT_REL = 1e-5
# batch 4 of the 2 s window does not fit the 80 GB card without remat (phase
# 12's batch; measured: out of memory)
PRESET_TRAIN_BATCH, PRESET_TRAIN_REMAT = 4, True
# [19] a data-parallel step over a one-rank mesh against the step without one,
# deterministic algorithms on both: the mesh's collectives over one rank copy
# and divide by 1, and kernel #2 sums in a fixed order, so the losses and
# every state tensor are bitwise equal. (Compared after one step.)
# the 48 kHz preset's 4801 frames split over 4 seq ranks (t_loc 1280) at its
# G of 1204; 'seq' at world 1 against 'auto': kernel #1 both, over 4864 keys
# (63 masked) against 4801, sums in another order (~1e-7)
SEQ_G, SEQ_T, SEQ_RANKS = 1204, 4801, 4
SEQ_VS_AUTO_REL = 1e-4
# [19d] a loader sharded by data rank at world 1 against the global loader:
# the same rows through the same step, every state tensor bitwise equal. (b)
# times loaders over LOADER_FILES written files for LOADER_RANKS data ranks
LOADER_FILES, LOADER_RANKS = 128, 8
# [20] the trained generator and the JAX package's output on its 4 s track
# (tests/test_torch_trained.py writes both): the port's fp32 against it, and
# 'auto' against 'xla', within FLASH_VS_XLA_REL; bf16 against fp32 within
# TRAINED_BF16_REL, the bound the CPU tests set for this checkpoint
# (test_torch_models.py; the JAX package's own bf16 stands 6.8e-3 from its
# fp32 on this track); the long track's length
TRAINED_DIR = os.path.join(ROOT, "tests", "torch_data", "r05_fold1_ema")
TRAINED_BF16_REL = 2e-2
TRAINED_LONG_SECONDS = 16
# [20] (f)-(h) read golden_stream.npz and golden_gstep.npz (the tracks, the
# batch's and the discriminator's seeds, the JAX package's outputs): (f) the
# port's StreamBatcher against the JAX package's within FLASH_VS_XLA_REL,
# bf16 against the card's fp32 within TRAINED_BF16_REL; (g) the served
# streams against the golden within SERVE_PROCESS_REL + FLASH_VS_XLA_REL, and
# against (f)'s fp32 batcher within SERVE_PROCESS_REL; (h) the G step's loss
# within TRAINED_GSTEP_LOSS_REL (the CPU tests' rtol for losses,
# test_torch_train.py), its gradient within GSTEP_REL as one vector and
# GSTEP_PARAM_REL for the worst parameter (the limits of [9] and of the
# bench's 64000 cell)
TRAINED_GSTEP_LOSS_REL = 1e-5
# [21] the bench's timed repeats a metric in this run (the bench's own default
# is 5; here every cell runs once, briefly); the library route's chunks of
# groups: a forward's [g, Tq, Tk] bias at most 16 GB (a second one is made
# while it is timed, and SDPA may copy it to pad its rows), a backward's a
# quarter of that (the bias, its gradient and SDPA's copies live together)
BENCH_REPS = 2
LIBRARY_BIAS_BYTES = {False: 16e9, True: 4e9}


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return 1e6 * float(out.strip().splitlines()[0])


def attention_bound(dtype_name, g, tq, tk, t_valid, q_offset, max_pos, backward: bool, d=16):
    """The least time the card could take for the attention function (or its
    gradient) on these shapes: the largest of its products at the tensor
    cores' rate, its bytes at the memory's rate and its exponentials (one a
    query-key pair) at the special-function units' rate. The counts are the
    package's (`ops.flash_attention.attention_work`, which the bench counts
    by too): a clipped pair needs no position product. d: the head dim the
    caller asks for (not the width the kernels pad it to)."""
    import torch

    from cmgan_torch.ops.flash_attention import attention_work

    es = 2 if dtype_name == "bfloat16" else 4
    work = attention_work(g, tq, tk, t_valid, q_offset, max_pos, d, es, backward)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {
        "operations": work["flop"] / ATTN_PEAK_FLOPS[dtype_name],
        "bytes": work["bytes"] / PEAK_BYTES,
        "exp": work["exps"] / (EXP_PER_CLOCK_SM * sms * max_sm_clock_hz()),
    }
    by = max(times, key=times.get)
    return {"bound_ms": 1e3 * times[by], "bound_by": by, "flop": work["flop"],
            "bytes": work["bytes"], "exps": work["exps"],
            "clipped_share": work["far"] / (tq * t_valid),
            "bound_parts_ms": {k: 1e3 * v for k, v in times.items()}}


def synthetic_track(n: int, seed: int, sr: int = SR):
    """A seeded sum of amplitude-modulated harmonics plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = rng.uniform(100, 220)
    x = sum(np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 6.3)) / h for h in range(1, 6))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
    return (0.05 * x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel_case(dtype_name, g, tq, tk, t_valid, q_offset, seed, max_pos=512, tag="[2]",
                      d=16):
    import torch

    from cmgan_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    # q pre-scaled by dim_head**-0.5 as the conformer passes it
    q = randn(g, tq, d, scale=d ** -0.5)
    k, v = randn(g, tk, d), randn(g, tk, d)
    table = randn(2 * max_pos + 1, d)
    band = fa.make_rel_band(table, tk, max_pos)

    def kernel():
        return fa.flash_rel_attention_at(q, k, v, table, max_pos, t_valid, q_offset)

    def plain():
        return torch.cat([
            fa.reference_attention(q[s:s + PLAIN_GROUP_CHUNK], k[s:s + PLAIN_GROUP_CHUNK],
                                   v[s:s + PLAIN_GROUP_CHUNK], band, t_valid, q_offset)
            for s in range(0, g, PLAIN_GROUP_CHUNK)
        ])

    def plain_lse():
        return torch.cat([
            fa.reference_logits(q[s:s + PLAIN_GROUP_CHUNK], k[s:s + PLAIN_GROUP_CHUNK], band,
                                t_valid, q_offset).logsumexp(-1)
            for s in range(0, g, PLAIN_GROUP_CHUNK)
        ])

    count = fa.launches
    out = kernel()
    launched = fa.launches - count
    ref = plain()
    # the row log-sum-exp the backward recomputes the weights from: the
    # wrapper's launch with it, at the kernels' head dim (zero columns added)
    width = fa.kernel_head_dim(d)
    _, lse = fa._launch_forward(*(torch.nn.functional.pad(t, (0, width - d))
                                  for t in (q, k, v, table)),
                                max_pos, t_valid, q_offset, True)
    lse_err = (lse - plain_lse()).abs().max().item()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = KERNEL_TOL[dtype_name]
    close = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
    finite = bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(lse).all())
    if launched != 1 or out.shape != q.shape:
        raise AssertionError(f"the wrapper launched {launched} kernels, out {tuple(out.shape)}")

    ms = cuda_ms(kernel, reps=10)
    plain_ms = cuda_ms(plain, reps=2)
    case = {
        "dtype": dtype_name, "G": g, "Tq": tq, "Tk": tk, "D": d, "t_valid": t_valid,
        "q_offset": q_offset, "max_pos": max_pos, "max_abs_err": err, "tol": [atol, rtol],
        "lse_err": lse_err, "lse_tol": LSE_TOL[dtype_name], "ms": ms, "plain_ms": plain_ms,
        **attention_bound(dtype_name, g, tq, tk, t_valid, q_offset, max_pos, backward=False, d=d),
    }
    log(f"{tag} kernel {json.dumps(case)}")
    if not (close and finite and lse_err <= LSE_TOL[dtype_name]):
        raise AssertionError(f"kernel disagrees with the plain version: {case}")
    return case


def check_tiled_against_kernels(seed=3):
    """[2] the tile-by-tile plain versions (64-wide tiles, as the kernels
    walk) against both kernels at one small shape where every kind of tile
    pair occurs, fp32, within the kernels' limits."""
    import torch

    from cmgan_torch.ops import flash_attention as fa

    g, tq, tk, t_valid, q_offset, max_pos = 8, 300, 450, 430, 100, 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(g, tq, 16, generator=gen, device="cuda") * 0.25
    k, v = (torch.randn(g, tk, 16, generator=gen, device="cuda") for _ in range(2))
    table = torch.randn(2 * max_pos + 1, 16, generator=gen, device="cuda")
    cot = torch.randn(g, tq, 16, generator=gen, device="cuda")
    kinds = {}
    for *_, kind in fa._tile_pairs(tq, t_valid, q_offset, max_pos, 64):
        kinds[kind] = kinds.get(kind, 0) + 1
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    out = fa.flash_rel_attention_at(*leaves, max_pos, t_valid, q_offset)
    grads = torch.autograd.grad(out, leaves, cot)
    tiled_out = fa.tiled_attention(q, k, v, table, max_pos, t_valid, q_offset, tile=64)
    tiled = fa.tiled_attention_grads(q, k, v, table, max_pos, t_valid, q_offset, cot, tile=64)
    torch.cuda.synchronize()
    atol, rtol = KERNEL_TOL["float32"]
    ok = torch.allclose(out, tiled_out, atol=atol, rtol=rtol)
    errs = {"out": (out - tiled_out).abs().max().item()}
    for name, a, b in zip(("dq", "dk", "dv", "dE"), grads, tiled):
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        ok = ok and errs[name] <= BWD_TOL["float32"]
    log(f"[2] tiled plain versions vs kernels, G {g} Tq {tq} Tk {tk} t_valid {t_valid} q_offset "
        f"{q_offset} max_pos {max_pos}, tile pairs {kinds}: {json.dumps(errs)}")
    if not ok or len(kinds) != 3:
        raise AssertionError("the kernels disagree with their tile-by-tile plain versions")


def realtime_factor(fn, audio_seconds: float, reps: int = 3) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return audio_seconds * reps / (time.perf_counter() - t0)


def device_breakdown(fn, wall_ms: float, top: int = 8, tag: str = "[3]") -> dict:
    """Profile one call: the device kernels' summed time against the
    call's unprofiled wall time, and the kernels that take the most.
    Returns each kernel's device ms by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"{tag} profile: device kernels {busy_ms:.2f} ms in a {wall_ms:.2f} ms call "
        f"({100 * busy_ms / wall_ms:.1f}% busy)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"{tag}   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count} {e.key[:90]}")
    return {e.key: e.self_device_time_total / 1e3 for e in kernels}


def device_ms(fn, reps: int) -> float:
    """Device time of fn() over reps calls, summed over every kernel it
    launches (torch.profiler), after one warm-up call: the kernels' own time,
    without the host's time to launch them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def rounded(values, digits: int = 6) -> list:
    return [round(float(v), digits) for v in values]


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bound_ms(flops: float, nbytes: float, dtype_name: str):
    """The least time the card could take: (ms, 'operations' or 'bytes')."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_backward_case(dtype_name, g, tq, tk, t_valid, q_offset, seed, chunk=PLAIN_GROUP_CHUNK,
                        max_pos=512, d=16):
    """The backward kernel against autograd through the plain version."""
    import torch

    from cmgan_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    q = randn(g, tq, d, scale=d ** -0.5)
    k, v = randn(g, tk, d), randn(g, tk, d)
    table = randn(2 * max_pos + 1, d)
    cot = randn(g, tq, d)

    # through the public wrapper: the autograd.Function's forward and backward
    leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
    fwd0, bwd0 = fa.launches, fa.backward_launches
    out = fa.flash_rel_attention_at(*leaves, max_pos, t_valid, q_offset)
    grads = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    if (fa.launches - fwd0, fa.backward_launches - bwd0) != (1, 1):
        raise AssertionError("the wrapper did not launch one forward and one backward")
    # once more on the same inputs: every sum in a fixed order, the same bits
    again = torch.autograd.grad(fa.flash_rel_attention_at(*leaves, max_pos, t_valid, q_offset),
                                leaves, cot)
    bitwise = all(torch.equal(a, b) for a, b in zip(grads, again))
    del again

    def plain():
        ref = [torch.zeros_like(t, dtype=torch.float32) for t in (q, k, v, table)]
        for s in range(0, g, chunk):
            sl = slice(s, s + chunk)
            dq, dk, dv, dt = fa.reference_attention_grads(
                q[sl], k[sl], v[sl], table, max_pos, t_valid, q_offset, cot[sl])
            ref[0][sl], ref[1][sl], ref[2][sl] = dq.float(), dk.float(), dv.float()
            ref[3] += dt.float()
        return ref

    ref = plain()
    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name]
    errs, ok = {}, bitwise
    # with one valid key the weights are the constant 1: dq, dk and dE are zero
    # and their references hold rounding noise, so the cotangent's largest entry is the scale
    floor = cot.float().abs().max().item() if t_valid == 1 else 0.0
    for name, a, b in zip(("dq", "dk", "dv", "dE"), grads, ref):
        err, top = (a.float() - b).abs().max().item(), b.abs().max().item()
        errs[name] = {"max_abs_err": err, "ref_max": top}
        ok = (ok and bool(torch.isfinite(a.float()).all()) and err <= tol * max(top, floor)
              and a.dtype == dtype)

    # the backward alone at the kernels' width (a narrower head is padded to it)
    width = fa.kernel_head_dim(d)
    qp, kp, vp, tp, cp = (torch.nn.functional.pad(x, (0, width - d))
                          for x in (q, k, v, table, cot))
    outp, lse = fa._launch_forward(qp, kp, vp, tp, max_pos, t_valid, q_offset, True)
    ms = cuda_ms(lambda: fa._launch_backward(qp, kp, vp, tp, outp, lse, cp, max_pos,
                                             t_valid, q_offset), reps=5)
    plain_ms = cuda_ms(plain, reps=1)
    case = {
        "dtype": dtype_name, "G": g, "Tq": tq, "Tk": tk, "D": d, "t_valid": t_valid,
        "q_offset": q_offset, "max_pos": max_pos, "errors": errs, "tol_of_ref_max": tol,
        "bitwise": bitwise,
        "max_abs_err": max(e["max_abs_err"] for n, e in errs.items() if n != "dE"),
        "ms": ms, "plain_ms": plain_ms,
        **attention_bound(dtype_name, g, tq, tk, t_valid, q_offset, max_pos, backward=True, d=d),
    }
    log(f"[7] backward kernel {json.dumps(case)}; two runs "
        + ("bitwise equal" if bitwise else "DIFFER"))
    if not ok:
        raise AssertionError(f"backward kernel disagrees with the plain version: {case}")
    return case


def check_against_float64(seed=13, d=16):
    """[7] what the fp32 route is worth: both kernels and their plain versions
    against the same function in float64, relative L2, at G 16, T 641. The
    kernels may be at most FLOAT64_FACTOR times as far as the plain versions;
    at a wide head (d 128) the backward's gradients WIDE_FLOAT64_FACTOR times."""
    import torch

    from cmgan_torch.ops import flash_attention as fa

    g, t, max_pos = 16, 641, 512
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(g, t, d, generator=gen, device="cuda") * d ** -0.5
    k, v, cot = (torch.randn(g, t, d, generator=gen, device="cuda") for _ in range(3))
    table = torch.randn(2 * max_pos + 1, d, generator=gen, device="cuda")

    with float_means_double():  # the plain version widens with .float()
        wide = [x.double() for x in (q, k, v, table)]
        truth = [fa.reference_attention(*wide[:3], fa.make_rel_band(wide[3], t, max_pos), t),
                 *fa.reference_attention_grads(*wide, max_pos, t, 0, cot.double())]
    plain = [fa.reference_attention(q, k, v, fa.make_rel_band(table, t, max_pos), t),
             *fa.reference_attention_grads(q, k, v, table, max_pos, t, 0, cot)]
    leaves = [x.clone().requires_grad_() for x in (q, k, v, table)]
    out = fa.flash_rel_attention_at(*leaves, max_pos, t, 0)
    kernel = [out.detach(), *torch.autograd.grad(out, leaves, cot)]
    torch.cuda.synchronize()

    def rel(a, b):
        return ((a.double() - b).norm() / b.norm()).item()

    report, ok = {}, all(x.dtype == torch.float64 for x in truth)
    for name, a, b, c in zip(("out", "dq", "dk", "dv", "dE"), plain, kernel, truth):
        report[name] = {"plain": rel(a, c), "kernel": rel(b, c)}
        factor = WIDE_FLOAT64_FACTOR if fa.wide_head_dim(d) and name != "out" else FLOAT64_FACTOR
        report[name]["limit"] = factor * report[name]["plain"]
        ok = ok and report[name]["kernel"] <= report[name]["limit"]
    log(f"[7] fp32 against float64, rel L2, G {g} T {t} D {d}: {json.dumps(report)}")
    if not ok:
        raise AssertionError("the fp32 kernels are further from float64 than allowed")


def backward_profile(dtype_name, g=1616, t=641, max_pos=512, reps=3, d=16):
    """[7] device time of each kernel of one backward launch (at the training
    shape, or at head dim d). For a wide head, the same again with the dq
    kernel's dE writes off (a wrong dE, for those writes' share only).
    Returns {kernel: ms} of the run with them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cmgan_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, cot = ((torch.randn(g, t, d, generator=gen, device="cuda") * s).to(dtype)
                    for s in (d ** -0.5, 1.0, 1.0, 1.0))
    table = torch.randn(2 * max_pos + 1, d, generator=gen, device="cuda").to(dtype)
    out, lse = fa._launch_forward(q, k, v, table, max_pos, t, 0, True)

    def run():
        fa._launch_backward(q, k, v, table, out, lse, cot, max_pos, t, 0)

    def times():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        return {e.key[e.key.index("flash_rel"):][:44]: e.self_device_time_total / 1e3 / reps
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "flash_rel" in e.key}

    with_writes = times()
    for name, ms in with_writes.items():
        log(f"[7] backward {dtype_name} G {g} T {t} D {d}: {ms:.3f} ms a launch, {name}")
    if fa.wide_head_dim(d):
        lib = fa._wide_bwd_kernel()
        lib.cmgan_flash_rel_attention_wide_de_writes(0)
        try:
            without = times()
        finally:
            lib.cmgan_flash_rel_attention_wide_de_writes(1)
        name = next(n for n in with_writes if "bwd_q" in n)
        share = 1 - without[name] / with_writes[name]
        log(f"[7] backward {dtype_name} D {d}: the dq/dE kernel {with_writes[name]:.3f} ms with "
            f"its dE writes, {without[name]:.3f} ms without: their share {100 * share:.1f}%")
    return with_writes


def check_layernorm_case(dtype_name, n, seed, c=64, eps=1e-5):
    """The LayerNorm kernel against its plain version and F.layer_norm."""
    import torch
    import torch.nn.functional as F

    from cmgan_torch.ops import fused_norm as fn

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(n, c, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    scale = torch.rand(c, generator=gen, device="cuda") + 0.5
    bias = torch.randn(c, generator=gen, device="cuda") * 0.5
    cot = torch.randn(n, c, generator=gen, device="cuda").to(dtype)

    def grads(f):
        leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
        y = f(*leaves)
        return [y.detach()] + list(torch.autograd.grad(y, leaves, cot))

    count = fn.launches
    got = grads(lambda a, s, b: fn.fused_layernorm(a, s, b, eps))
    if fn.launches - count != 1:
        raise AssertionError("fused_layernorm did not launch its kernel")
    ref = grads(lambda a, s, b: fn._ln_reference(a, s, b, eps))
    lib = grads(lambda a, s, b: F.layer_norm(a.float(), (c,), s, b, eps).to(dtype))
    torch.cuda.synchronize()
    atol, rtol = LN_TOL[dtype_name]
    err = (got[0].float() - ref[0].float()).abs().max().item()
    err_lib = (got[0].float() - lib[0].float()).abs().max().item()
    ok = bool(torch.isfinite(got[0].float()).all())
    ok = ok and torch.allclose(got[0].float(), ref[0].float(), atol=atol, rtol=rtol)
    ok = ok and torch.allclose(got[0].float(), lib[0].float(), atol=atol, rtol=rtol)
    grad_err = {}
    for name, a, b, l in zip(("dx", "dscale", "dbias"), got[1:], ref[1:], lib[1:]):
        top = b.float().abs().max().item()
        grad_err[name] = (a.float() - b.float()).abs().max().item() / top
        # the sums over n rows run in another order; bf16 rounds dx once
        lim = 1e-4 if dtype_name == "float32" or name != "dx" else 1.6e-2
        ok = ok and grad_err[name] <= lim
        ok = ok and (a.float() - l.float()).abs().max().item() / top <= max(lim, 2e-3)

    ms = cuda_ms(lambda: fn.fused_layernorm(x, scale, bias, eps), reps=20)
    plain_ms = cuda_ms(lambda: fn._ln_reference(x, scale, bias, eps), reps=5)
    # the one PyTorch call for the same function, fp32 statistics inside
    sc, bi = scale.to(dtype), bias.to(dtype)
    library_ms = cuda_ms(lambda: F.layer_norm(x, (c,), sc, bi, eps), reps=20)
    # the kernels alone: at the narrow widths a call's host time is longer
    kernel_device_ms = device_ms(lambda: fn.fused_layernorm(x, scale, bias, eps), reps=20)
    library_device_ms = device_ms(lambda: F.layer_norm(x, (c,), sc, bi, eps), reps=20)
    es = torch.finfo(dtype).bits // 8
    b_ms, b_by = bound_ms(8 * n * c, 2 * n * c * es + 8 * c, dtype_name)
    case = {"dtype": dtype_name, "N": n, "C": c, "plan": fn.plan(c, es, aligned=True).__dict__,
            "max_abs_err": err, "max_abs_err_vs_library": err_lib,
            "grad_err_of_ref_max": grad_err, "tol": [atol, rtol], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": kernel_device_ms,
            "library_device_ms": library_device_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"[8] layernorm kernel {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"layernorm kernel disagrees: {case}")
    return case


@contextlib.contextmanager
def aten_layernorm():
    """The models' LayerNorm forced onto `nn.LayerNorm`, grad mode aside."""
    import torch

    from cmgan_torch.models import layers

    dispatch = layers.LayerNorm.forward
    layers.LayerNorm.forward = lambda self, x: torch.nn.LayerNorm.forward(self, x.float())
    try:
        yield
    finally:
        layers.LayerNorm.forward = dispatch


def layernorm_dispatch_on_card(smi: str) -> dict:
    """[8b] the models' LayerNorm on kernel #3 where autograd does not record:
    the generator at the streaming cell's shape (8 windows of 36000 samples)
    under inference_mode against the same weights with `nn.LayerNorm` forced
    (relative L2 under 1e-5), 40 launches a forward, the call's time both
    ways there and at 8 x 16 s, and no launch in a `Trainer.train_step`.
    TF32 off, as main() runs: in TF32 the kernel's last-bit differences from
    ATen's LayerNorm flip the convolutions' roundings, and the outputs part
    by about 1e-4."""
    import numpy as np
    import torch

    from cmgan_torch import inference
    from cmgan_torch.cli import pin_fp32
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.ops import fused_norm
    from cmgan_torch.train import Trainer

    pin_fp32()
    cfg = CMGANConfig()
    model = inference.load_generator(cfg, None, None, "cuda", seed=5)
    rec = {}
    for name, samples in (("stream", 36000), ("eval", 16 * SR)):
        audio = torch.from_numpy(np.stack([synthetic_track(samples, 60 + i)
                                           for i in range(8)])).cuda()

        def call():
            return inference.enhance_tensor(model, cfg.dsp, audio)

        with torch.inference_mode():
            before = fused_norm.launches
            got = call().cpu().numpy()
            launches = fused_norm.launches - before
            kernel_ms = cuda_ms(call, reps=3)
            with aten_layernorm():
                want = call().cpu().numpy()
                aten_ms = cuda_ms(call, reps=3)
        rec[name] = {"rel_l2": rel_l2(got, want), "launches": launches, "ms": kernel_ms,
                     "aten_ms": aten_ms}
        del audio
    trainer = Trainer(train_config(DEFAULT_CUT, mode="device"), [None], None, device="cuda")
    clean, noisy = train_batch(DEFAULT_CUT, seed=81)
    before = fused_norm.launches
    trainer.train_step(clean, noisy)
    torch.cuda.synchronize()
    rec["train_step_launches"] = fused_norm.launches - before
    del trainer, model
    torch.cuda.empty_cache()
    log(f"[8b] the models' LayerNorm through kernel #3 on {smi}: {json.dumps(rec)}")
    if rec["stream"]["rel_l2"] >= 1e-5 or rec["eval"]["rel_l2"] >= 1e-5:
        raise AssertionError(f"the LayerNorm kernel moves the generator's output: {rec}")
    if rec["stream"]["launches"] != 40 or rec["eval"]["launches"] != 40:
        raise AssertionError(f"the generator did not run 40 LayerNorm kernels a forward: {rec}")
    if rec["train_step_launches"] != 0:
        raise AssertionError(f"a train_step launched the LayerNorm kernel: {rec}")
    return rec


def ptxas_usage(nvcc_log: str):
    """(kernel, 'N registers, S B spill stores, L B spill loads') for each
    entry function of `nvcc -Xptxas=-v`'s report; the kernel as its name and
    template arguments, read from the mangled name (13__nv_bfloat16: bf16,
    f: fp32, Li<n>E: the integer n)."""
    import re

    out, name, spills = [], None, ""
    for line in nvcc_log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"\d(flash_rel_(?:wide_(?:fwd|bwd_q|bwd_kv|bwd_prologue|split)|fwd|bwd_kv"
                             r"|bwd_q|bwd_prologue|bwd|delta|sum_partials)"
                             r"|layernorm_(?:regs|span|long))[IE]", mangled)
            dtype = "bf16" if "bfloat16" in mangled else "fp32"
            ints = re.findall(r"Li(\d+)E", mangled)
            name = f"{base.group(1) if base else mangled[-48:]}<{', '.join([dtype, *ints])}>"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            spills = f"{spill.group(1)} B spill stores, {spill.group(2)} B spill loads"
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out.append((name, f"{used.group(1)} registers, {spills}"))
            name = None
    return out


def sass_counts(path: str) -> dict:
    """Instructions in a library's SASS (cuobjdump beside nvcc): HGMMA
    (wgmma), UTMALDG (TMA tensor loads), UBLKCP (bulk copies), and HMMA
    (mma.sync, the tensor-core route before Hopper's)."""
    import re

    from cmgan_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", text)) for op in ("HGMMA", "UTMALDG", "UBLKCP", "HMMA")}


def build_all():
    """[1] every kernel source and the host PESQ scorer, one build each, all
    started together; each kernel's registers and spills as ptxas reports
    them, and the attention kernels' shared memory a block at each head dim."""
    from concurrent.futures import ThreadPoolExecutor

    from cmgan_torch.metrics import pesq_native
    from cmgan_torch.ops import _build
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.ops import fused_norm

    t0 = time.perf_counter()
    names = (fa.KERNEL, fa.BWD_KERNEL, fa.WIDE_KERNEL, fa.WIDE_BWD_KERNEL, fused_norm.KERNEL)
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:  # one nvcc a source, together
        pesq_build = pool.submit(pesq_native.build)
        futures = [pool.submit(_build.build, name) for name in names]
    failed = [str(f.exception()) for f in futures if f.exception() is not None]
    if failed:  # every source's errors, not only the first's
        raise RuntimeError("\n".join(failed))
    for build in (f.result() for f in futures):
        log(f"[1] built {os.path.relpath(build.path, ROOT)} in {build.seconds:.2f} s")
        for kernel, usage in ptxas_usage(build.log):
            log(f"[1]   {kernel}: {usage}")
        for line in sorted({ln.strip() for ln in build.log.splitlines()
                            if "warning" in ln or "(C75" in ln}):
            log(f"[1]   ptxas: {line}")  # C7515 / C7512: wgmma serialized
    for name, future in zip(names, futures):
        if name == fused_norm.KERNEL:
            continue  # kernel #3 has no products
        sass = sass_counts(future.result().path)
        log(f"[1] library {name}: {json.dumps(sass)} instructions in its SASS")
        if not (sass["HGMMA"] and sass["UTMALDG"] + sass["UBLKCP"]) or sass["HMMA"]:
            raise AssertionError(f"the library {name} lacks wgmma or TMA, or keeps mma.sync")
    fwd_lib, bwd_lib = fa._kernel(), fa._bwd_kernel()
    for bf16 in (0, 1):
        for hd in fa.KERNEL_HEAD_DIMS:
            log(f"[1] dynamic shared memory a block, {'bf16' if bf16 else 'fp32'}, head dim {hd}: "
                f"forward {fwd_lib.cmgan_flash_rel_attention_fwd_smem(bf16, hd)} B; backward dq/dE "
                f"kernel {bwd_lib.cmgan_flash_rel_attention_bwd_smem(bf16, hd, 0, 512)} B, dk/dv "
                f"kernel {bwd_lib.cmgan_flash_rel_attention_bwd_smem(bf16, hd, 1, 512)} B (one block "
                f"an SM, at every max_pos); rows of the backward's scratch at G 1616, T 641, max_pos "
                f"512 (a consumer warpgroup's partial sums of dE each, then the rows' statistics): "
                f"{bwd_lib.cmgan_flash_rel_attention_bwd_partial_rows(bf16, hd, 1616, 641, 512)}")
    wide, wide_bwd = fa._wide_kernel(), fa._wide_bwd_kernel()
    for bf16 in (0, 1):
        fwd_smem = [wide.cmgan_flash_rel_attention_fwd_smem(bf16, d) for d in (128, 256, 320)]
        log(f"[1] wide kernels' dynamic shared memory a block, {'bf16' if bf16 else 'fp32'}: forward "
            f"at D 128 / 256 / 320 {fwd_smem} B; backward at any head dim "
            f"dq/dE kernel {wide_bwd.cmgan_flash_rel_attention_bwd_smem(bf16, 128, 0, 512)} B, "
            f"dk/dv kernel {wide_bwd.cmgan_flash_rel_attention_bwd_smem(bf16, 128, 1, 512)} B; "
            f"rows of the backward's scratch (a dq/dE block's partial sums of dE each, then the "
            f"rows' statistics) at G 404, T 641, max_pos 512, D 128 / 320: "
            f"{wide_bwd.cmgan_flash_rel_attention_bwd_partial_rows(bf16, 128, 404, 641, 512)} / "
            f"{wide_bwd.cmgan_flash_rel_attention_bwd_partial_rows(bf16, 320, 404, 641, 512)}")
    for hd in (80, 100, 128, 256, 320, 512):
        p = fa.plan(hd)
        lib_slabs = [wide.cmgan_flash_rel_attention_wide_slab(hd, 0),
                     *(wide_bwd.cmgan_flash_rel_attention_wide_slab(hd, w) for w in (1, 2))]
        passes = [wide.cmgan_flash_rel_attention_wide_passes(hd, 0),
                  *(wide_bwd.cmgan_flash_rel_attention_wide_passes(hd, w) for w in (1, 2))]
        log(f"[1] wide plan, head dim {hd}: forward (passes, columns a consumer warpgroup) "
            f"{p.slabs['fwd']}; backward (passes, columns a pass) dq/dE {p.slabs['bwd_q']}, dk/dv "
            f"{p.slabs['bwd_k']}; the libraries' columns {lib_slabs}, passes {passes}: the forward "
            f"computes a tile pair's logits {passes[0]} times, each backward kernel {passes[1]}; "
            f"{p.padded_columns} padded logit columns")
        if (lib_slabs != [p.slabs[n][1] for n in ("fwd", "bwd_q", "bwd_k")]
                or passes != [p.slabs[n][0] for n in ("fwd", "bwd_q", "bwd_k")]):
            raise AssertionError("ops.flash_attention.plan and the wide libraries disagree")
    log(f"[1] built {os.path.relpath(pesq_build.result(), ROOT)} (host PESQ scorer, g++); "
        f"all builds {time.perf_counter() - t0:.2f} s")


def head_dim_cases():
    """[2] kernel #1 at head dims other than 16 (8 runs zero-padded to 16; 32
    and 64 are instantiations of their own), fp32 and bf16, at the 4 s bucket's
    shape."""
    return [check_kernel_case(dt, 404, 641, 641, 641, 0, seed=20 + d, d=d)
            for d in (8, 32, 64) for dt in ("float32", "bfloat16")]


def backward_head_dim_cases():
    """[7] kernel #2 at head dims 8 (zero-padded to 16), 32 and 64, fp32 and
    bf16 (fp32 at 64 runs one consumer warpgroup a block)."""
    return [check_backward_case(dt, 404, 641, 641, 641, 0, seed=30 + d, d=d)
            for d in (8, 32, 64) for dt in ("float32", "bfloat16")]


def wide_head_dim_cases():
    """[2] kernel #1's wide path (head dims over 64) at D 80, 100, 128, 256 and
    320, fp32 and bf16, at the 4 s bucket's shape; at D 128 with a query
    offset and masked keys; bf16 at D 100 the same (rows of 200 bytes: the
    producer's cp.async copies in place of TMA); and at D 128 with one valid
    key, fp32 and bf16."""
    cases = [check_kernel_case(dt, 404, 641, 641, 641, 0, seed=40 + d, d=d)
             for d in WIDE_HEAD_DIMS for dt in ("float32", "bfloat16")]
    cases.append(check_kernel_case("float32", 404, 320, 641, 600, 128, seed=41, d=128))
    cases.append(check_kernel_case("bfloat16", 404, 320, 641, 600, 128, seed=42, d=100))
    cases += [check_kernel_case(dt, 101, 641, 641, 1, 0, seed=43, d=128)
              for dt in ("float32", "bfloat16")]
    return cases


def check_wide_walk_against_kernels(seed=4):
    """[2] the wide kernels' walk in plain PyTorch (64-column chunks, the
    forward's one pass of two halves, the backward's passes, dE a tile pair
    at a time) against the wide kernels at one small shape where every kind
    of tile pair occurs, fp32, at D 100 (a padded depth step, rows TMA
    cannot take) and D 320 (the forward's widest one-pass head, three passes
    a backward kernel)."""
    import torch

    from cmgan_torch.ops import flash_attention as fa

    g, tq, tk, t_valid, q_offset, max_pos = 8, 300, 450, 430, 100, 64
    kinds = {}
    for *_, kind in fa._tile_pairs(tq, t_valid, q_offset, max_pos, 64):
        kinds[kind] = kinds.get(kind, 0) + 1
    for d in (100, 320):
        gen = torch.Generator(device="cuda").manual_seed(seed + d)
        q = torch.randn(g, tq, d, generator=gen, device="cuda") * d ** -0.5
        k, v = (torch.randn(g, tk, d, generator=gen, device="cuda") for _ in range(2))
        table = torch.randn(2 * max_pos + 1, d, generator=gen, device="cuda")
        cot = torch.randn(g, tq, d, generator=gen, device="cuda")
        leaves = [t.clone().requires_grad_() for t in (q, k, v, table)]
        out = fa.flash_rel_attention_at(*leaves, max_pos, t_valid, q_offset)
        grads = torch.autograd.grad(out, leaves, cot)
        walk_out = fa.wide_attention(q, k, v, table, max_pos, t_valid, q_offset)
        walk = fa.wide_attention_grads(q, k, v, table, max_pos, t_valid, q_offset, cot)
        torch.cuda.synchronize()
        atol, rtol = KERNEL_TOL["float32"]
        ok = torch.allclose(out, walk_out, atol=atol, rtol=rtol)
        errs = {"out": (out - walk_out).abs().max().item()}
        for name, a, b in zip(("dq", "dk", "dv", "dE"), grads, walk):
            errs[name] = ((a - b).abs().max() / b.abs().max()).item()
            ok = ok and errs[name] <= BWD_TOL["float32"]
        log(f"[2] wide walk's plain versions vs wide kernels, D {d}, G {g} Tq {tq} Tk {tk} t_valid "
            f"{t_valid} q_offset {q_offset} max_pos {max_pos}, tile pairs {kinds}: {json.dumps(errs)}")
        if not ok or len(kinds) != 3:
            raise AssertionError("the wide kernels disagree with their walk's plain versions")


def wide_kernel_at_64(smi: str):
    """[2] for the record: the wide forward at D 64 (the wrapper sends D 64 to
    kernel #1) through its own entry, G 404, T 641, fp32 and bf16, against
    the plain version and beside kernel #1's time in the same call."""
    import torch

    from cmgan_torch.ops import flash_attention as fa

    lib = fa._wide_kernel()
    g, t, d, max_pos = 404, 641, 64, 512
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        gen = torch.Generator(device="cuda").manual_seed(64)
        q, k, v = ((torch.randn(g, t, d, generator=gen, device="cuda") * s).to(dtype)
                   for s in (d ** -0.5, 1.0, 1.0))
        table = torch.randn(2 * max_pos + 1, d, generator=gen, device="cuda").to(dtype)
        out = torch.empty_like(q)

        def wide():
            rc = fa.wide_forward(lib, q, k, v, table, out, None, max_pos, t, 0)
            if rc != 0:
                raise RuntimeError(f"the wide forward at D 64 failed: CUDA error {rc}")

        wide()
        band = fa.make_rel_band(table, t, max_pos)
        ref = torch.cat([fa.reference_attention(q[s:s + PLAIN_GROUP_CHUNK], k[s:s + PLAIN_GROUP_CHUNK],
                                                v[s:s + PLAIN_GROUP_CHUNK], band, t)
                         for s in range(0, g, PLAIN_GROUP_CHUNK)])
        torch.cuda.synchronize()
        atol, rtol = KERNEL_TOL[dt]
        err = (out.float() - ref.float()).abs().max().item()
        ms = cuda_ms(wide, reps=10)
        ms_1 = cuda_ms(lambda: fa.flash_rel_attention_at(q, k, v, table, max_pos), reps=10)
        log(f"[2] wide forward at D 64 (not the wrapper's route), {dt}, G {g} T {t}: {ms:.3f} ms; "
            f"kernel #1 {ms_1:.3f} ms; max abs err {err:.3e} on {smi}")
        if not torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol):
            raise AssertionError("the wide forward at D 64 disagrees with the plain version")


def wide_summary(cases, library):
    """The kernels line's numbers of a wide kernel: its fp32 case at D 128,
    beside [21]'s library route there."""
    def main(records):
        return next(c for c in records if c["D"] == 128 and c["dtype"] == "float32"
                    and c["q_offset"] == 0)

    return {k: main(cases)[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by")} | {"library_ms": main(library)["library_ms"]}


def wide_backward_cases():
    """[7] kernel #2's wide path at D 80, 100, 128, 256 and 320, fp32 and
    bf16, at D 128 with a query offset and masked keys, and at D 128 with one
    valid key (every key tile but the first wholly masked), fp32 and bf16."""
    cases = [check_backward_case(dt, 404, 641, 641, 641, 0, seed=50 + d, d=d)
             for d in WIDE_HEAD_DIMS for dt in ("float32", "bfloat16")]
    cases.append(check_backward_case("float32", 404, 320, 641, 600, 128, seed=51, d=128))
    cases += [check_backward_case(dt, 101, 641, 641, 1, 0, seed=52, d=128)
              for dt in ("float32", "bfloat16")]
    return cases


def wide_head_model():
    """[2] a 1-TSCB model of 128 channels in 1 head (head dim 128, the wide
    kernels) on a 6 s track in bucket mode (961 frames): 'auto' against 'xla'
    and its launches; then one G step of it at cut_len 64000 (641 frames),
    'auto' against 'xla': loss and every gradient, one forward and one
    backward launch. Returns the enhancement's and the step's launches."""
    import numpy as np
    import torch

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import init_train_state

    track = synthetic_track(6 * SR, seed=22)
    auto = Enhancer(CMGANConfig(model=ModelConfig(**WIDE_MODEL)), device="cuda", seed=2)
    xla = Enhancer(CMGANConfig(model=ModelConfig(**WIDE_MODEL, attention_impl="xla")),
                   auto.model.state_dict(), device="cuda")
    fa.launches = fa.backward_launches = 0
    y = auto.enhance(track, mode="bucket")
    enhance_launches = fa.launches
    err = rel_l2(y, xla.enhance(track, mode="bucket"))
    log(f"[2] wide model, {WIDE_MODEL}, 6 s bucket: launches {enhance_launches}, 'auto' "
        f"against 'xla' rel L2 {err:.3e} (tol {FLASH_VS_XLA_REL})")
    del auto, xla
    if enhance_launches != 1 or not np.all(np.isfinite(y)) or not err <= FLASH_VS_XLA_REL:
        raise AssertionError("the 128-channel 1-head model missed the wide kernel or disagrees")

    clean, noisy = (torch.from_numpy(a[:WIDE_STEP_BATCH]).cuda()
                    for a in train_batch(FLASH_CUT, seed=42))
    fresh = init_train_state(train_config(FLASH_CUT, model=WIDE_MODEL), seed=0,
                             steps_per_epoch=1, device="cuda")
    weights = ({k: v.clone() for k, v in fresh.gen.state_dict().items()},
               {k: v.clone() for k, v in fresh.disc.state_dict().items()})
    del fresh
    loss_f, g_f, _, fwd_f, bwd_f, _ = g_step_gradients("auto", clean, noisy, weights,
                                                       model=WIDE_MODEL)
    loss_d, g_d, _, fwd_d, bwd_d, _ = g_step_gradients("xla", clean, noisy, weights,
                                                       model=WIDE_MODEL)
    whole = whole_rel_l2(g_f, g_d)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    log(f"[2] wide model G step, cut_len {FLASH_CUT}, batch {WIDE_STEP_BATCH}: launches "
        f"{fwd_f} fwd / {bwd_f} bwd ('xla' {fwd_d} / {bwd_d}); loss rel {loss_rel:.3e}, all "
        f"gradients rel L2 {whole:.3e} (tol {GSTEP_REL})")
    if (fwd_f, bwd_f, fwd_d, bwd_d) != (1, 1, 0, 0) or not (loss_rel <= GSTEP_REL
                                                             and whole <= GSTEP_REL):
        raise AssertionError("the wide model's G step missed the wide kernels or disagrees")
    return enhance_launches, fwd_f, bwd_f


def wide_model_times(reps: int = 5) -> dict:
    """`--forward-times`: [2]'s 128-channel 1-head model (head dim 128)
    through the checkout's package: ms a 6 s enhance call in bucket mode and
    ms a G step at cut_len 64000, batch WIDE_STEP_BATCH (forward, loss and
    the generator's gradients), each the mean of `reps` calls after one
    warm-up, host clock around synchronised calls; with each one's
    launches of kernels #1 and #2."""
    import torch

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import init_train_state
    from cmgan_torch.train import steps as tsteps

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    track = synthetic_track(6 * SR, seed=22)
    enh = Enhancer(CMGANConfig(model=ModelConfig(**WIDE_MODEL)), device="cuda", seed=2)
    fa.launches = 0
    record = {"enhance_ms": ms(lambda: enh.enhance(track, mode="bucket")),
              "enhance_launches": fa.launches / (reps + 1)}
    del enh
    cfg = train_config(FLASH_CUT, model=WIDE_MODEL)
    state = init_train_state(cfg, seed=0, steps_per_epoch=1, device="cuda")
    clean, noisy = (torch.from_numpy(a[:WIDE_STEP_BATCH]).cuda()
                    for a in train_batch(FLASH_CUT, seed=42))

    def g_step():
        out = tsteps._generator_forward(state.gen, clean, noisy, cfg)
        loss, _, _ = tsteps._generator_loss(state.disc, out, clean, cfg.train.loss_weights)
        torch.autograd.grad(loss, list(state.gen.parameters()))

    fa.launches = fa.backward_launches = 0
    record["g_step_ms"] = ms(g_step)
    record["g_step_launches"] = [fa.launches / (reps + 1), fa.backward_launches / (reps + 1)]
    del state
    torch.cuda.empty_cache()
    log(f"[2] wide model {WIDE_MODEL} times: {json.dumps(record)}")
    return record


def widest_head_model():
    """[2] a 1-TSCB model of 320 channels in 1 head (head dim 320: the wide
    forward's two consumer warpgroups own 160 columns each, one pass) on a
    6 s track in bucket mode: 'auto' against 'xla', one wide launch. Returns
    the launches."""
    import numpy as np

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa

    track = synthetic_track(6 * SR, seed=23)
    auto = Enhancer(CMGANConfig(model=ModelConfig(**WIDEST_MODEL)), device="cuda", seed=3)
    xla = Enhancer(CMGANConfig(model=ModelConfig(**WIDEST_MODEL, attention_impl="xla")),
                   auto.model.state_dict(), device="cuda")
    fa.launches = 0
    y = auto.enhance(track, mode="bucket")
    launches = fa.launches
    err = rel_l2(y, xla.enhance(track, mode="bucket"))
    log(f"[2] widest model, {WIDEST_MODEL}, 6 s bucket: launches {launches}, 'auto' against "
        f"'xla' rel L2 {err:.3e} (tol {FLASH_VS_XLA_REL})")
    if launches != 1 or not np.all(np.isfinite(y)) or not err <= FLASH_VS_XLA_REL:
        raise AssertionError("the 320-channel 1-head model missed the wide kernel or disagrees")
    return launches


def two_heads_of_dim_8():
    """[2] a tiny model of 16 channels in 2 heads of dim 8 (1 TSCB) on a 6 s
    track in bucket mode (961 frames): 'auto' takes kernel #1, zero-padded to
    dim 16, once, and agrees with 'xla'."""
    import numpy as np

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa

    tiny = dict(num_channels=16, attn_heads=2, num_tscb_blocks=1, dense_depth=2)
    track = synthetic_track(6 * SR, seed=21)
    auto = Enhancer(CMGANConfig(model=ModelConfig(**tiny)), device="cuda", seed=1)
    xla = Enhancer(CMGANConfig(model=ModelConfig(**tiny, attention_impl="xla")),
                   auto.model.state_dict(), device="cuda")
    fa.launches = 0
    y = auto.enhance(track, mode="bucket")
    launches = fa.launches
    err = rel_l2(y, xla.enhance(track, mode="bucket"))
    log(f"[2] tiny model, 2 heads of dim 8, 6 s bucket: launches {launches}, 'auto' against "
        f"'xla' rel L2 {err:.3e} (tol {FLASH_VS_XLA_REL})")
    if launches != 1 or not np.all(np.isfinite(y)) or not err <= FLASH_VS_XLA_REL:
        raise AssertionError("the 2-head model missed kernel #1 or disagrees with 'xla'")


def layernorm_width_cases():
    """[8] kernel #3 at widths off its pair path: odd (63, 65), wider than a
    warp keeps in registers (513 odd, 1024 even), fp32 and bf16."""
    return [check_layernorm_case(dt, 65536, seed=12, c=c)
            for c in (63, 65, 513, 1024) for dt in ("float32", "bfloat16")]


def train_config(cut_len: int, attention_impl: str = "auto", mode: str = "host", model=None):
    import dataclasses

    from cmgan_torch.config import CMGANConfig, ModelConfig, TrainConfig

    return CMGANConfig(
        model=ModelConfig(attention_impl=attention_impl, **(model or {})),
        train=dataclasses.replace(TrainConfig(), batch_size=TRAIN_BATCH, cut_len=cut_len,
                                  pesq_label_mode=mode),
    )


def train_batch(cut_len: int, seed: int, batch: int = TRAIN_BATCH):
    import numpy as np

    clean = np.stack([synthetic_track(cut_len, seed + i) for i in range(batch)])
    rng = np.random.default_rng(seed)
    return clean, clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32)


@contextlib.contextmanager
def float_means_double():
    """Within the block, Tensor.float() returns float64: the models' norms
    and losses widen to "float" by that call, so a model moved to float64
    with .double() then computes in float64 throughout."""
    import torch

    widen = torch.Tensor.float
    torch.Tensor.float = lambda t, *args, **kwargs: t.double()
    try:
        yield
    finally:
        torch.Tensor.float = widen


def g_step_gradients(impl, clean, noisy, weights, double=False, dropout=True, model=None,
                     cfg=None, mesh=None):
    """The G step's loss and generator gradients at cut_len 64000 from the
    given weights (of the published model, or of ModelConfig(**model); or
    of `cfg` at its own window, over `mesh`); returns (loss, gradients as
    float64, parameter names, forward launches, backward launches, peak
    GiB)."""
    import torch

    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import init_train_state
    from cmgan_torch.train import steps as tsteps
    from cmgan_torch.train.state import rng_scope

    cfg = cfg or train_config(FLASH_CUT, impl, model=model)
    state = init_train_state(cfg, seed=0, steps_per_epoch=1, device="cuda", mesh=mesh)
    state.gen.load_state_dict(weights[0])
    state.disc.load_state_dict(weights[1])
    state.gen.train(), state.disc.train()
    if not dropout:
        for module in (*state.gen.modules(), *state.disc.modules()):
            if isinstance(module, torch.nn.Dropout):
                module.p = 0.0
    if double:
        state.gen.double(), state.disc.double()
        clean, noisy = clean.double(), noisy.double()
    fa.launches = fa.backward_launches = 0
    torch.cuda.reset_peak_memory_stats()
    # the same dropout masks for every float32 run
    with rng_scope(state), (float_means_double() if double else contextlib.nullcontext()):
        out = tsteps._generator_forward(state.gen, clean, noisy, cfg)
        loss, _, _ = tsteps._generator_loss(state.disc, out, clean, cfg.train.loss_weights)
        grads = torch.autograd.grad(loss, list(state.gen.parameters()))
    torch.cuda.synchronize()
    result = (loss.item(), [g.double() for g in grads],
              [n for n, _ in state.gen.named_parameters()], fa.launches, fa.backward_launches,
              torch.cuda.max_memory_allocated() / 2**30)
    del state, out, loss, grads
    torch.cuda.empty_cache()
    return result


def whole_rel_l2(a, b) -> float:
    """Relative L2 of all gradients a against b, taken as one vector."""
    import torch

    return (torch.cat([(x - y).reshape(-1) for x, y in zip(a, b)]).norm()
            / torch.cat([y.reshape(-1) for y in b]).norm()).item()


def g_step_flash_vs_dense():
    """[9] the G step's loss and gradients, 'auto' (the kernels) against 'xla'."""
    import torch

    from cmgan_torch.train import init_train_state

    clean, noisy = (torch.from_numpy(a).cuda() for a in train_batch(FLASH_CUT, seed=40))
    fresh = init_train_state(train_config(FLASH_CUT), seed=0, steps_per_epoch=1, device="cuda")
    weights = ({k: v.clone() for k, v in fresh.gen.state_dict().items()},
               {k: v.clone() for k, v in fresh.disc.state_dict().items()})
    del fresh

    loss_f, g_f, names, fwd_f, bwd_f, mem_f = g_step_gradients("auto", clean, noisy, weights)
    loss_d, g_d, _, fwd_d, bwd_d, mem_d = g_step_gradients("xla", clean, noisy, weights)
    log(f"[9] G step cut_len {FLASH_CUT} batch {TRAIN_BATCH} fp32: loss flash {loss_f:.6f} "
        f"dense {loss_d:.6f}; launches flash {fwd_f} fwd / {bwd_f} bwd, dense {fwd_d} / {bwd_d}; "
        f"peak memory flash {mem_f:.2f} GiB, dense {mem_d:.2f} GiB")
    if (fwd_f, bwd_f, fwd_d, bwd_d) != (4, 4, 0, 0):
        raise AssertionError("expected 4 forward and 4 backward launches with 'auto', 0 with 'xla'")
    top = max(g.norm().item() for g in g_d)
    # a bias in front of an InstanceNorm has gradient 0 by construction: both
    # sides then hold rounding noise of a sum over B*T*F terms. A gradient
    # below 1e-2 of the largest one is measured against that, not against itself.
    rels = sorted(
        (((a - b).norm() / max(b.norm().item(), 1e-2 * top)).item(), b.norm().item(), name)
        for name, a, b in zip(names, g_f, g_d))
    for rel, norm, name in rels[-3:]:
        log(f"[9]   rel L2 {rel:.3e} (gradient norm {norm:.3e}, largest {top:.3e}) {name}")
    worst, _, worst_name = rels[-1]
    whole = whole_rel_l2(g_f, g_d)
    loss_rel = abs(loss_f - loss_d) / abs(loss_d)
    log(f"[9] flash vs dense: loss rel {loss_rel:.3e}, all gradients rel L2 {whole:.3e} "
        f"(tol {GSTEP_REL}), worst parameter {worst:.3e} ({worst_name}) of {len(names)} "
        f"(tol {GSTEP_PARAM_REL})")
    if not (loss_rel <= GSTEP_REL and whole <= GSTEP_REL and worst <= GSTEP_PARAM_REL):
        raise AssertionError("the G step through the kernels disagrees with the dense one")

    r = g_step_float64()
    err_d, err_f = r["dense_fp32"], r["flash_fp32"]
    log(f"[9] batch 1, dropout off, all gradients rel L2 against dense float64: dense fp32 "
        f"{err_d:.3e}, flash fp32 {err_f:.3e} ({r['launches'][0]} fwd / {r['launches'][1]} bwd "
        f"launches; limit {GSTEP_TRUTH_FACTOR} x dense); flash against dense fp32 "
        f"{r['flash_vs_dense']:.3e}")
    if r["launches"] != [4, 4] or not err_f <= GSTEP_TRUTH_FACTOR * err_d:
        raise AssertionError("the kernels' gradients are further from float64 than dense float32's")


def g_step_float64(seed: int = 40, m=None) -> dict:
    """What float32 itself is worth in the G step ([9]), with the functions
    of the chip_smoke module m (default this one; or another checkout's):
    the first utterance of [9]'s batch drawn from `seed`, dropout off (its
    masks depend on the type), the generator's gradients by dense fp32
    ('xla') and through the kernels ('auto') against the dense path in
    float64, relative L2 of all gradients as one vector."""
    import torch

    from cmgan_torch.train import init_train_state

    m = m or sys.modules[__name__]
    clean, noisy = (torch.from_numpy(a).cuda()[:1]
                    for a in m.train_batch(m.FLASH_CUT, seed=seed))
    fresh = init_train_state(m.train_config(m.FLASH_CUT), seed=0, steps_per_epoch=1,
                             device="cuda")
    weights = ({k: v.clone() for k, v in fresh.gen.state_dict().items()},
               {k: v.clone() for k, v in fresh.disc.state_dict().items()})
    del fresh
    _, truth, *_ = m.g_step_gradients("xla", clean, noisy, weights, double=True, dropout=False)
    _, d32, *_ = m.g_step_gradients("xla", clean, noisy, weights, dropout=False)
    _, f32, _, fwd, bwd, _ = m.g_step_gradients("auto", clean, noisy, weights, dropout=False)
    return {"seed": seed, "dense_fp32": whole_rel_l2(d32, truth),
            "flash_fp32": whole_rel_l2(f32, truth), "flash_vs_dense": whole_rel_l2(f32, d32),
            "launches": [fwd, bwd]}


def write_pairs(root: str, seconds, seed0: int):
    """Seeded clean/noisy pairs, {clean,noisy}/pN.wav, pair N seconds[N] long."""
    import numpy as np

    from cmgan_torch.data import write_wav

    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(root, kind))
    for i, sec in enumerate(seconds):
        clean = synthetic_track(sec * SR, seed0 + i)
        noise = np.random.default_rng(seed0 + 500 + i).standard_normal(clean.shape)
        write_wav(os.path.join(root, "clean", f"p{i}.wav"), clean, SR)
        write_wav(os.path.join(root, "noisy", f"p{i}.wav"),
                  clean + (0.05 * noise).astype(np.float32), SR)


def write_dataset(root: str, n_train: int = 12, n_test: int = 4, seconds: int = 5):
    """A seeded VCTK-DEMAND-shaped directory: {train,test}/{clean,noisy}/pN.wav."""
    for split, count, seed0 in (("train", n_train, 1000), ("test", n_test, 2000)):
        write_pairs(os.path.join(root, split), [seconds] * count, seed0)


class LabelCount:
    """Counts the batches the host labeler scored and the ones it failed."""

    def __init__(self):
        from cmgan_torch.train import loop

        self.loop, self.inner = loop, loop.pesq_labels_host
        self.batches = self.invalid = 0

    def __call__(self, clean, est):
        scores = self.inner(clean, est)
        self.batches += 1
        self.invalid += int(scores.min() < 0)
        return scores

    def __enter__(self):
        self.loop.pesq_labels_host = self
        return self

    def __exit__(self, *exc):
        self.loop.pesq_labels_host = self.inner


def run_train_cli(data_dir, save_dir, cut_len, extra=()):
    """One epoch through the CLI; returns (trainer, fwd launches, bwd launches,
    label counts, the checkpoint written)."""
    import torch

    from cmgan_torch.cli import train as cli
    from cmgan_torch.ops import flash_attention as fa

    before = set(os.listdir(save_dir)) if os.path.isdir(save_dir) else set()
    fa.launches = fa.backward_launches = 0
    with LabelCount() as labels:
        trainer = cli.main(["--data_dir", data_dir, "--save_model_dir", save_dir, "--epochs", "1",
                            "--batch_size", str(TRAIN_BATCH), "--cut_len", str(cut_len),
                            "--log_interval", "1", *extra])
    torch.cuda.synchronize()
    new = sorted(set(os.listdir(save_dir)) - before)
    if len(new) != 1 or "nan" in new[0] or "inf" in new[0]:
        raise AssertionError(f"expected one checkpoint with a finite test loss, got {new}")
    for module in (trainer.state.gen, trainer.state.disc):
        if not all(bool(torch.isfinite(p).all()) for p in module.state_dict().values()):
            raise AssertionError("non-finite weights after training")
    return trainer, fa.launches, fa.backward_launches, labels, os.path.join(save_dir, new[0])


def train_through_cli(tmp: str):
    """[10] and [11]; returns the launches of the first epoch at cut_len 64000."""
    import numpy as np
    import torch

    from cmgan_torch.train import init_train_state

    data_dir = os.path.join(tmp, "data")
    write_dataset(data_dir)
    blocks = 4
    steps, test_batches = 12 // TRAIN_BATCH, 4 // TRAIN_BATCH

    save = os.path.join(tmp, "ckpt64")
    fresh = init_train_state(train_config(FLASH_CUT), 0, steps, device="cuda")
    init = [{k: v.clone() for k, v in m.state_dict().items()} for m in (fresh.gen, fresh.disc)]
    del fresh
    trainer, fwd, bwd, labels, ckpt = run_train_cli(data_dir, save, FLASH_CUT)
    log(f"[10] train CLI cut_len {FLASH_CUT}: steps {trainer.state.step}, launches {fwd} fwd / "
        f"{bwd} bwd, labeled batches {labels.batches} of which invalid {labels.invalid}, "
        f"checkpoint {os.path.basename(ckpt)}")
    want = (blocks * (steps + test_batches), blocks * steps)
    if (fwd, bwd) != want or trainer.state.step != steps:
        raise AssertionError(f"expected {want} launches and {steps} steps")
    moved_g = sum(not torch.equal(v, init[0][k]) for k, v in trainer.state.gen.state_dict().items())
    d_now = trainer.state.disc.state_dict()
    moved_d = sum(not torch.equal(v, init[1][k]) for k, v in d_now.items())
    d_weights_moved = not torch.equal(d_now["conv1.layer.weight"], init[1]["conv1.layer.weight"])
    log(f"[10] moved tensors: generator {moved_g}/{len(init[0])}, discriminator "
        f"{moved_d}/{len(init[1])} (its weights {'moved' if d_weights_moved else 'did not move'})")
    if moved_g < len(init[0]) // 2 or moved_d == 0:
        raise AssertionError("training did not move the parameters")
    if labels.invalid < steps and not d_weights_moved:
        raise AssertionError("a valid batch did not move the discriminator's weights")
    main_launches = (fwd, bwd)

    resumed, fwd, bwd, labels, ckpt2 = run_train_cli(data_dir, save, FLASH_CUT, ["--resume", ckpt])
    log(f"[10] resumed: steps {resumed.state.step}, launches {fwd} fwd / {bwd} bwd, invalid "
        f"batches {labels.invalid}/{labels.batches}, checkpoint {os.path.basename(ckpt2)}")
    if resumed.state.step != 2 * steps or (fwd, bwd) != want:
        raise AssertionError("the resumed run did not continue the step counter")

    # d_step driven directly: valid labels move D, a failed label moves nothing
    state = resumed.state
    clean, noisy = train_batch(FLASH_CUT, seed=60)
    _, handoff = resumed.g_step(state, clean, noisy)

    def snapshot():
        opt = state.disc_opt.state_dict()["state"]
        return ([v.clone() for v in state.disc.state_dict().values()],
                [torch.as_tensor(v).clone() for s in opt.values() for v in s.values()])

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a[0] + a[1], b[0] + b[1]))

    s0 = snapshot()
    loss_ok = resumed.d_step(state, handoff["clean_mag"], handoff["est_mag"],
                             np.full(TRAIN_BATCH, 2.5, np.float32)).item()
    s1 = snapshot()
    bad = np.full(TRAIN_BATCH, 2.5, np.float32)
    bad[1] = -1.0
    loss_skip = resumed.d_step(state, handoff["clean_mag"], handoff["est_mag"], bad).item()
    s2 = snapshot()
    log(f"[10] d_step: valid labels loss {loss_ok:.5f}, D moved {not same(s0, s1)}; a -1 label "
        f"loss {loss_skip}, D and its Adam state unchanged {same(s1, s2)}")
    if same(s0, s1) or not same(s1, s2) or loss_skip != 0.0 or not np.isfinite(loss_ok):
        raise AssertionError("d_step's update or skip path is wrong")
    del trainer, resumed, state
    torch.cuda.empty_cache()

    # -- 11. the default window: dense attention, no launches --
    for mode in ("host", "host_async"):
        for extra in ((), ("--bf16",)):
            save = os.path.join(tmp, f"ckpt32_{mode}_{'bf16' if extra else 'fp32'}")
            trainer, fwd, bwd, labels, _ = run_train_cli(
                data_dir, save, DEFAULT_CUT, ["--pesq_label_mode", mode, *extra])
            log(f"[11] train CLI cut_len {DEFAULT_CUT} {mode} {'bf16' if extra else 'fp32'}: steps "
                f"{trainer.state.step}, launches {fwd} fwd / {bwd} bwd, invalid batches "
                f"{labels.invalid}/{labels.batches}")
            if (fwd, bwd) != (0, 0) or trainer.state.step != steps:
                raise AssertionError("the default window must take no kernel launch")
            del trainer
            torch.cuda.empty_cache()
    return main_launches


def training_rates(smi: str):
    """[12] utterances per second of train_step in the three label modes,
    PESQ's share, a G-step profile; returns one G step's ms at cut_len
    64000, batch 4, fp32."""
    import torch

    from cmgan_torch.train import Trainer
    from cmgan_torch.train.steps import pesq_labels_host

    reps = 3
    for cut in (FLASH_CUT, DEFAULT_CUT):
        clean, noisy = train_batch(cut, seed=80)
        for dtype, dname in ((None, "fp32"), (torch.bfloat16, "bf16")):
            for mode in ("host", "host_async", "device"):
                trainer = Trainer(train_config(cut, mode=mode), [None], None, dtype=dtype,
                                  device="cuda")

                def steps(n):
                    for _ in range(n):
                        trainer.train_step(clean, noisy)
                    trainer.drain_pending_d()
                    torch.cuda.synchronize()

                steps(1)  # warm-up
                t0 = time.perf_counter()
                steps(reps)
                step_s = (time.perf_counter() - t0) / reps
                line = (f"[12] train_step cut_len {cut} batch {TRAIN_BATCH} {dname} {mode}: "
                        f"{TRAIN_BATCH / step_s:.3f} utterances/s ({1e3 * step_s:.1f} ms a step)")
                if mode == "host":
                    _, handoff = trainer.g_step(trainer.state, clean, noisy)
                    est = handoff["est_audio"].cpu().numpy()
                    t0 = time.perf_counter()
                    pesq_labels_host(clean, est)
                    pesq_s = time.perf_counter() - t0
                    line += f", host PESQ {1e3 * pesq_s:.1f} ms = {100 * pesq_s / step_s:.1f}% of a step"
                log(f"{line} on {smi}")
                if mode == "host" and dtype is None and cut == FLASH_CUT:
                    def g_only():
                        trainer.g_step(trainer.state, clean, noisy)
                        torch.cuda.synchronize()

                    g_only()
                    t0 = time.perf_counter()
                    g_only()
                    g_ms = 1e3 * (time.perf_counter() - t0)
                    log(f"[12] one G step cut_len {cut} fp32: {g_ms:.1f} ms on {smi}")
                    device_breakdown(g_only, g_ms, top=12, tag="[12]")
                del trainer
                torch.cuda.empty_cache()
    return g_ms


def expected_eval_launches(cfg, seconds, exact: bool, batch_cap: int = 8) -> int:
    """Kernel #1 launches the evaluate CLI should make on tracks of these
    lengths: one a TSCB for each model call whose segments reach
    FLASH_MIN_FRAMES, the calls as Enhancer.enhance_batch groups the tracks
    (bucket mode: whole seconds, same-length tracks together, longer than
    cut_len one at a time) or one a track (exact)."""
    import math

    import numpy as np

    from cmgan_torch.inference import BATCH_BUDGET_SAMPLES, segment_track
    from cmgan_torch.models.conformer import FLASH_MIN_FRAMES

    dsp, cut = cfg.dsp, cfg.eval.cut_len

    def call(n):  # one model call on a track of n samples, as enhance folds it
        segments, _ = segment_track(np.ones(n, np.float32), dsp.hop, cut)
        flash = dsp.num_frames(segments.shape[1]) >= FLASH_MIN_FRAMES
        return cfg.model.num_tscb_blocks if flash else 0

    if exact:
        return sum(call(sec * SR) for sec in seconds)
    groups = {}
    launches = 0
    for sec in seconds:
        padded = sec * SR   # whole seconds: the bucket is the track's own length
        if padded > cut:
            launches += call(padded)
        else:
            groups[padded] = groups.get(padded, 0) + 1
    for padded, count in groups.items():
        cap = max(1, min(batch_cap, BATCH_BUDGET_SAMPLES // padded))
        launches += math.ceil(count / cap) * call(padded)
    return launches


def evaluate_cli(tmp: str, smi: str):
    """[13] the evaluate CLI at full width on a written test dir; returns the
    fp32 bucketed run's kernel #1 launches."""
    import shutil

    import numpy as np
    import torch

    from cmgan_torch.checkpoint import save_variables
    from cmgan_torch.cli import evaluate as cli
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.data import read_wav, write_wav
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.metrics import compute_metrics
    from cmgan_torch.ops import flash_attention as fa

    cfg = CMGANConfig()
    test_dir = os.path.join(tmp, "eval")
    write_pairs(test_dir, EVAL_SECONDS, seed0=3000)
    exact_dir = os.path.join(tmp, "eval_exact")
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(exact_dir, kind))
        for name in EVAL_EXACT:
            shutil.copy(os.path.join(test_dir, kind, name), os.path.join(exact_dir, kind, name))
    enh = Enhancer(cfg, device="cuda", seed=0)
    weights = os.path.join(tmp, "generator")
    save_variables(weights, enh.model.state_dict())

    exact_seconds = [EVAL_SECONDS[int(n[1:-4])] for n in EVAL_EXACT]
    runs = (("fp32", (), EVAL_SECONDS, False), ("fp32 again", (), EVAL_SECONDS, False),
            ("bf16", ("--bf16",), EVAL_SECONDS, False),
            ("bf16 again", ("--bf16",), EVAL_SECONDS, False),
            ("exact fp32", ("--exact",), exact_seconds, True))
    limits = {"pesq": (1.0, 4.65), "csig": (1.0, 5.0), "cbak": (1.0, 5.0), "covl": (1.0, 5.0),
              "ssnr": (-10.0, 35.0), "stoi": (-1.0, 1.0)}
    fp32_launches = None
    for name, extra, seconds, exact in runs:
        save = os.path.join(tmp, "tracks_" + name.split()[0])
        directory = exact_dir if exact else test_dir
        fa.launches = 0
        result = cli.main(["--test_dir", directory, "--model_path", weights, "--json",
                           "--save_tracks", "--save_dir", save, *extra])
        torch.cuda.synchronize()
        launches, want = fa.launches, expected_eval_launches(cfg, seconds, exact)
        share = 1.0 - result["realtime_factor"] / result["enhance_realtime_factor"]
        log(f"[13] evaluate {name}: {len(seconds)} tracks, {sum(seconds)} s; realtime_factor "
            f"{result['realtime_factor']}, enhance_realtime_factor "
            f"{result['enhance_realtime_factor']}, host metrics {100 * share:.1f}% of the wall "
            f"time; kernel #1 launches {launches} (expected {want}) on {smi}")
        bad = [k for k, (lo, hi) in limits.items()
               if not (np.isfinite(result[k]) and lo <= result[k] <= hi)]
        if bad or launches != want or want == 0 or result["tracks"] != len(seconds):
            raise AssertionError(f"evaluate {name}: aggregates out of range {bad} or "
                                 f"{launches} launches, expected {want}")
        if name == "fp32":
            fp32_launches = launches

    # a saved track against Enhancer.enhance on the same weights, both as the
    # CLI saves them (16-bit PCM); the 20 s track is enhanced alone in both
    for name, limit in ((EVAL_ALONE, EVAL_TRACK_REL), (EVAL_BATCHED, None)):
        noisy, _ = read_wav(os.path.join(test_dir, "noisy", name))
        ref_path = os.path.join(tmp, "ref_" + name)
        write_wav(ref_path, enh.enhance(noisy[0], mode="bucket"), SR)
        ref, _ = read_wav(ref_path)
        saved, _ = read_wav(os.path.join(tmp, "tracks_fp32", name))
        err = rel_l2(saved[0], ref[0])
        log(f"[13] saved {name} ({saved.shape[1] / SR:.0f} s) against Enhancer.enhance, 16-bit "
            f"PCM both: rel L2 {err:.3e}" + (f" (tol {limit})" if limit else
                                            " (batched with 7 padding rows; no limit)"))
        if limit is not None and not err <= limit:
            raise AssertionError("the evaluate CLI's track disagrees with Enhancer.enhance")
    clean, _ = read_wav(os.path.join(test_dir, "clean", EVAL_EXACT[0]))
    scores = compute_metrics(clean[0], clean[0], SR)
    log(f"[13] compute_metrics(clean, clean), {clean.shape[1] / SR:.0f} s: pesq {scores[0]:.6f} "
        f"stoi {scores[5]:.9f}")
    if not (abs(scores[0] - 4.64) <= 0.01 and abs(scores[5] - 1.0) <= 1e-6):
        raise AssertionError("clean against clean must score PESQ 4.64 and STOI 1")
    del enh
    torch.cuda.empty_cache()
    return fp32_launches


def device_pesq(smi: str):
    """[14] the batched torch PESQ on the card: against the CPU, against the
    host C++ scorer, a silent row, and ms a batch beside the host scorer."""
    import numpy as np
    import torch

    from cmgan_torch.metrics.pesq_native import pesq_batch
    from cmgan_torch.metrics.pesq_torch import pesq_labels_torch, pesq_mos_torch
    from cmgan_torch.train import init_train_state, make_train_steps
    from cmgan_torch.train.steps import pesq_labels_host

    # three speech-like pairs at three SNRs and one G step's est_audio
    clean = np.stack([synthetic_track(FLASH_CUT, 4000 + i) for i in range(4)])
    noise = np.random.default_rng(4000).standard_normal(clean.shape).astype(np.float32)
    deg = clean + np.array([0.005, 0.02, 0.06, 0.0], np.float32)[:, None] * noise
    cfg = train_config(FLASH_CUT)
    state = init_train_state(cfg, 0, 1, device="cuda")
    batch_clean, batch_noisy = train_batch(FLASH_CUT, seed=90)
    _, handoff = make_train_steps(cfg, 1)[0](state, batch_clean, batch_noisy)
    clean[3], deg[3] = batch_clean[0], handoff["est_audio"][0].cpu().numpy()
    del state, handoff
    torch.cuda.empty_cache()

    ref, dg = torch.from_numpy(clean), torch.from_numpy(deg)
    on_card = pesq_mos_torch(ref.cuda(), dg.cuda()).cpu().numpy()
    on_cpu = pesq_mos_torch(ref, dg).numpy()
    host = pesq_batch(clean, deg)
    err, err_host = float(np.abs(on_card - on_cpu).max()), float(np.abs(on_card - host).max())
    log(f"[14] pesq_mos_torch B 4 x {FLASH_CUT}: card {rounded(on_card)}, CPU "
        f"{rounded(on_cpu)}, host C++ {rounded(host)}; max |card - CPU| "
        f"{err:.3e} (tol {PESQ_DEVICE_ATOL}), max |card - host C++| {err_host:.3e} (no limit)")
    if not (np.all(np.isfinite(on_card)) and err <= PESQ_DEVICE_ATOL):
        raise AssertionError("the torch PESQ on the card disagrees with the CPU")
    silent = ref.clone()
    silent[1] = 0.0
    labels = pesq_labels_torch(silent.cuda(), dg.cuda()).cpu().numpy()
    log(f"[14] labels with a silent clean row: {rounded(labels)}")
    if labels[1] != -1.0 or not np.all(labels[[0, 2, 3]] >= 1.0):
        raise AssertionError("a silent row must be labeled -1 and the others scored")

    timings = {}
    for b, n in ((4, FLASH_CUT), (16, DEFAULT_CUT)):
        c = np.stack([synthetic_track(n, 5000 + i) for i in range(b)])
        d = c + 0.02 * np.random.default_rng(5000).standard_normal(c.shape).astype(np.float32)
        cc, dd = torch.from_numpy(c).cuda(), torch.from_numpy(d).cuda()
        ms = cuda_ms(lambda: pesq_labels_torch(cc, dd), reps=10)
        pesq_labels_host(c, d)
        t0 = time.perf_counter()
        for _ in range(3):
            pesq_labels_host(c, d)
        host_ms = 1e3 * (time.perf_counter() - t0) / 3
        timings[f"{b}x{n}"] = {"device_ms": ms, "host_ms": host_ms}
        log(f"[14] labels B {b} x {n}: pesq_labels_torch {ms:.3f} ms on the card (CUDA events), "
            f"host C++ scorer {host_ms:.1f} ms (host clock) on {smi}")
    return timings


class LabelSpy:
    """Wraps the fused step's label function: snapshots the discriminator's
    state where its phase begins (after the G phase), keeps the labels, and
    can turn on torch.cuda.set_sync_debug_mode("error") from there on."""

    def __init__(self, state, error_mode: bool = False):
        from cmgan_torch.train import steps

        self.steps, self.inner = steps, steps.pesq_labels_torch
        self.state, self.error_mode = state, error_mode

    def __call__(self, clean, est):
        import torch

        if self.error_mode:
            torch.cuda.set_sync_debug_mode("error")
        self.disc = [t.clone() for t in self.state.disc.state_dict().values()]
        self.opt = [t.clone() for s in self.state.disc_opt.state.values() for t in s.values()]
        self.labels = self.inner(clean, est)
        return self.labels

    def __enter__(self):
        self.steps.pesq_labels_torch = self
        return self

    def __exit__(self, *exc):
        import torch

        self.steps.pesq_labels_torch = self.inner
        torch.cuda.set_sync_debug_mode(0)


def fused_step_on_card(tmp: str, smi: str):
    """[15] the fused G + label + D step at cut_len 64000, batch 4, fp32;
    returns its forward and backward launches."""
    import copy

    import numpy as np
    import torch

    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import init_train_state, make_train_steps

    cfg = train_config(FLASH_CUT, mode="device")
    state = init_train_state(cfg, 0, 10, device="cuda")
    g_step, d_step, _, _, fused_step = make_train_steps(cfg, 10)
    if not all(g["capturable"] for g in state.disc_opt.param_groups):
        raise AssertionError("device mode on the GPU needs the capturable discriminator optimizer")
    clean, noisy = train_batch(FLASH_CUT, seed=100)
    fa.launches = fa.backward_launches = 0
    metrics, loss = fused_step(state, clean, noisy)  # the first call also moves the constants
    torch.cuda.synchronize()
    launches, blocks = (fa.launches, fa.backward_launches), cfg.model.num_tscb_blocks
    log(f"[15] fused step cut_len {FLASH_CUT} batch {TRAIN_BATCH} fp32: gen loss "
        f"{metrics['gen_loss'].item():.5f}, disc loss {loss.item():.5f}, launches {launches[0]} "
        f"fwd / {launches[1]} bwd")
    if launches != (blocks, blocks) or not (np.isfinite(loss.item()) and loss.item() > 0):
        raise AssertionError("the fused step must launch one forward and one backward kernel "
                             "a TSCB")

    # its D update against d_step fed the same labels, from a copy of the state;
    # the label and D phases under the sync checker
    clean, noisy = train_batch(FLASH_CUT, seed=101)
    torch.backends.cudnn.deterministic = True
    twin = copy.deepcopy(state)
    with LabelSpy(state, error_mode=True) as spy:
        _, loss = fused_step(state, clean, noisy)
    _, handoff = g_step(twin, clean, noisy)
    twin_loss = d_step(twin, handoff["clean_mag"], handoff["est_mag"], spy.labels.cpu().numpy())
    torch.backends.cudnn.deterministic = False
    err = whole_rel_l2([p.detach().double() for p in state.disc.parameters()],
                       [p.detach().double() for p in twin.disc.parameters()])
    log(f"[15] label and D phases ran under set_sync_debug_mode('error'); labels "
        f"{rounded(spy.labels.cpu().numpy())}; D loss fused {loss.item():.6f}, "
        f"d_step {twin_loss.item():.6f}; D parameters rel L2 {err:.3e} "
        f"(tol {FUSED_VS_D_STEP_REL})")
    if not err <= FUSED_VS_D_STEP_REL:
        raise AssertionError("the fused step's D update disagrees with d_step")
    del twin, handoff

    # a failed label: the D phase is undone bitwise, the G update stands
    clean, noisy = train_batch(FLASH_CUT, seed=102)
    clean[1] = 0.0
    gen_before = [p.detach().clone() for p in state.gen.parameters()]
    with LabelSpy(state, error_mode=True) as spy:
        _, loss = fused_step(state, clean, noisy)
    same = (all(torch.equal(a, b) for a, b in zip(state.disc.state_dict().values(), spy.disc))
            and all(torch.equal(a, b) for a, b in zip(
                [t for s in state.disc_opt.state.values() for t in s.values()], spy.opt)))
    g_moved = not all(torch.equal(p, q) for p, q in zip(state.gen.parameters(), gen_before))
    log(f"[15] a silent clean row: labels {rounded(spy.labels.cpu().numpy())}, "
        f"D loss {loss.item()}, D parameters, buffers and AdamW state bitwise unchanged {same}, "
        f"G moved {g_moved}")
    if not (same and g_moved and loss.item() == 0.0 and spy.labels[1].item() == -1.0):
        raise AssertionError("a failed label must leave the discriminator's state as it was")

    # the whole step under the sync checker, inputs already on the card (the
    # copy of a host batch to the card waits for the host by nature)
    clean_d, noisy_d = (torch.from_numpy(a).cuda() for a in train_batch(FLASH_CUT, seed=103))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused_step(state, clean_d, noisy_d)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("[15] the whole fused step ran under set_sync_debug_mode('error')")
    del state
    torch.cuda.empty_cache()

    # one epoch of the train CLI in device mode
    data_dir = os.path.join(tmp, "data")
    write_dataset(data_dir)
    steps, test_batches = 12 // TRAIN_BATCH, 4 // TRAIN_BATCH
    fresh = init_train_state(cfg, 0, steps, device="cuda")
    d0 = fresh.disc.conv1.layer.weight.detach().clone()
    del fresh
    trainer, fwd, bwd, labels, ckpt = run_train_cli(data_dir, os.path.join(tmp, "ckpt_device"),
                                                    FLASH_CUT, ["--pesq_label_mode", "device"])
    d_updates = [int(s["step"].item()) for s in trainer.state.disc_opt.state.values()]
    d_moved = not torch.equal(trainer.state.disc.conv1.layer.weight, d0)
    log(f"[15] train CLI --pesq_label_mode device cut_len {FLASH_CUT}: steps "
        f"{trainer.state.step}, launches {fwd} fwd / {bwd} bwd, D updates {max(d_updates)}, D "
        f"moved {d_moved}, host-labeled test batches {labels.batches}, checkpoint "
        f"{os.path.basename(ckpt)}")
    want = (blocks * (steps + test_batches), blocks * steps)
    if (fwd, bwd) != want or trainer.state.step != steps or not d_moved:
        raise AssertionError(f"expected {want} launches, {steps} steps and a moved D")
    del trainer
    torch.cuda.empty_cache()
    return launches


def stream_solo(cfg, model, track, block: int, **kw):
    """A track through a solo StreamingEnhancer on the card, pushed in blocks."""
    import numpy as np

    from cmgan_torch.streaming import StreamingEnhancer

    s = StreamingEnhancer(cfg, model, device="cuda", **kw)
    parts = [s.push(track[i:i + block]) for i in range(0, track.size, block)]
    return np.concatenate(parts + [s.flush()])


def stream_emissions(batcher, tracks, starts, ticks=None):
    """Tracks through a StreamBatcher as the server drives it: track i opens a
    slot at tick starts[i], feeds a chunk a tick (the last one zero-padded),
    drains the lookahead with zero chunks and closes. Runs every tick, or
    the first `ticks`. Returns each track's emissions, one array a tick it
    fed, and the ticks run."""
    import numpy as np

    chunk = batcher.chunk
    drain = -(-batcher.lookahead // chunk) + 1
    plans = []
    for track in tracks:
        n = -(-track.size // chunk) + drain
        padded = np.zeros(n * chunk, np.float32)
        padded[:track.size] = track
        plans.append(padded.reshape(n, chunk))
    slots, outs, run = [None] * len(tracks), [[] for _ in tracks], 0
    end = max(s + len(p) for s, p in zip(starts, plans))
    for tick in range(end if ticks is None else ticks):
        blocks = {}
        for i, (start, plan) in enumerate(zip(starts, plans)):
            if tick == start:
                slots[i] = batcher.open()
            if start <= tick < start + len(plan):
                blocks[slots[i]] = plan[tick - start]
        run += bool(blocks)
        result = batcher.step(blocks)
        for i, (start, plan) in enumerate(zip(starts, plans)):
            if start <= tick < start + len(plan):
                outs[i].append(np.asarray(result[slots[i]], np.float32))
                if tick == start + len(plan) - 1:
                    batcher.close(slots[i])
    return outs, run


def stream_slots(batcher, tracks, starts):
    """stream_emissions' outputs aligned and trimmed to the tracks'
    lengths, and the ticks run."""
    import numpy as np

    outs, ticks = stream_emissions(batcher, tracks, starts)
    return [np.concatenate(o)[:t.size] for o, t in zip(outs, tracks)], ticks


def tick_ms(cfg, model, slots: int, left_context: int):
    """Median ms of a StreamBatcher tick with every slot active (host clock
    from a synchronized card to the estimate read back); returns it with the
    batcher and the tick's blocks."""
    import numpy as np
    import torch

    from cmgan_torch.streaming import StreamBatcher

    b = StreamBatcher(cfg, model, num_slots=slots, left_context=left_context, device="cuda")
    blocks = {b.open(): synthetic_track(CHUNK, seed=300 + i) for i in range(slots)}
    times = []
    for _ in range(STREAM_WARMUP + STREAM_TICKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.step(blocks)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times[STREAM_WARMUP:])), b, blocks


def streaming_on_card(smi: str):
    """[16] the streaming engine at full width: block-size invariance, slots
    against solo streams, the long-context window through kernel #1 against
    'xla', ms a tick, a tick's profile, kernel #1 at the streaming shapes.
    Returns (kernel #1's launches on the long-context streams, its cases)."""
    import numpy as np
    import torch

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import load_generator
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.streaming import StreamBatcher

    cfg = CMGANConfig()
    cfg_xla = CMGANConfig(model=ModelConfig(attention_impl="xla"))
    models = {"float32": load_generator(cfg, None, None, "cuda", seed=0)}
    state = models["float32"].state_dict()
    models["bfloat16"] = load_generator(cfg, state, torch.bfloat16, "cuda")
    blocks = cfg.model.num_tscb_blocks
    window = 24000 + CHUNK + LOOKAHEAD
    log(f"[16] windows: default {window} samples ({cfg.dsp.num_frames(window)} frames), "
        f"long-context {LONG_CONTEXT + CHUNK + LOOKAHEAD} "
        f"({cfg.dsp.num_frames(LONG_CONTEXT + CHUNK + LOOKAHEAD)} frames); algorithmic latency "
        f"{CHUNK + LOOKAHEAD} samples = {1e3 * (CHUNK + LOOKAHEAD) / SR:.0f} ms")

    track = synthetic_track(20 * SR, seed=200)
    for dt, model in models.items():
        fa.launches = 0
        by3000 = stream_solo(cfg, model, track, 3000)
        by700 = stream_solo(cfg, model, track, 700)
        log(f"[16] {dt} solo 20 s at the default window: out len {by3000.size}, rms "
            f"{float(np.sqrt(np.mean(by3000 ** 2))):.6f}, blocks of 3000 against 700 max abs "
            f"{float(np.abs(by3000 - by700).max()):.3e}, kernel #1 launches {fa.launches}")
        if (by3000.shape != track.shape or not np.all(np.isfinite(by3000))
                or not np.array_equal(by3000, by700) or fa.launches != 0):
            raise AssertionError("a stream depends on its push block size, is not whole, or "
                                 "launched kernel #1 at the default window")
        tracks = [synthetic_track(sec * SR, seed=210 + i) for i, sec in enumerate((6, 5, 4))]
        outs, ticks = stream_slots(StreamBatcher(cfg, model, num_slots=8, device="cuda"),
                                   tracks, starts=(0, 2, 5))
        errs = [rel_l2(o, stream_solo(cfg, model, t, t.size)) for o, t in zip(outs, tracks)]
        log(f"[16] {dt} StreamBatcher 8 slots, 3 active from ticks 0, 2, 5 ({ticks} ticks): "
            f"rel L2 against solo streams {[f'{e:.3e}' for e in errs]} "
            f"(tol {SLOT_VS_SOLO_REL[dt]})")
        if not all(e <= SLOT_VS_SOLO_REL[dt] for e in errs):
            raise AssertionError("a slot disagrees with its solo stream")

    # the long-context window: kernel #1 once a TSCB a tick, against 'xla'
    dense = load_generator(cfg_xla, state, None, "cuda")
    streaming_launches = 0
    for slots in (1, 8):
        tracks = [synthetic_track(4 * SR, seed=230 + i) for i in range(slots)]
        fa.launches = 0
        outs, ticks = stream_slots(StreamBatcher(cfg, models["float32"], num_slots=slots,
                                                 left_context=LONG_CONTEXT, device="cuda"),
                                   tracks, [0] * slots)
        launches = fa.launches
        streaming_launches += launches
        ref, _ = stream_slots(StreamBatcher(cfg_xla, dense, num_slots=slots,
                                            left_context=LONG_CONTEXT, device="cuda"),
                              tracks, [0] * slots)
        err = rel_l2(np.concatenate(outs), np.concatenate(ref))
        log(f"[16] long-context fp32, {slots} slot(s), {ticks} ticks: kernel #1 launches "
            f"{launches} (expected {blocks * ticks}), flash against xla rel L2 {err:.3e} "
            f"(tol {FLASH_VS_XLA_REL})")
        if launches != blocks * ticks or not err <= FLASH_VS_XLA_REL:
            raise AssertionError("the long-context stream missed kernel #1 or disagrees with xla")
    del dense
    torch.cuda.empty_cache()

    # ms a tick, streams served in real time
    for dt, model in models.items():
        for left_context, slot_counts in ((24000, (1, 8, 32)), (LONG_CONTEXT, (1, 8))):
            for slots in slot_counts:
                ms, b, blocks_in = tick_ms(cfg, model, slots, left_context)
                log(f"[16] tick {dt} left_context {left_context} slots {slots}: {ms:.3f} ms "
                    f"(median of {STREAM_TICKS}), streams in real time "
                    f"{slots * CHUNK / SR / (ms / 1e3):.2f} on {smi}")
                if dt == "float32" and left_context == LONG_CONTEXT and slots == 8:
                    times = device_breakdown(lambda: b.step(blocks_in), ms, top=10, tag="[16]")
                    flash = sum(v for k, v in times.items() if "flash_rel" in k)
                    log(f"[16] kernel #1 in one long-context tick of 8 slots: {flash:.3f} ms, "
                        f"{100 * flash / sum(times.values()):.1f}% of the device time, "
                        f"{100 * flash / ms:.1f}% of the tick")
                del b
    # kernel #1 at the streaming shapes: G = 404 x slots, T = 601
    t = cfg.dsp.num_frames(LONG_CONTEXT + CHUNK + LOOKAHEAD)
    cases = [check_kernel_case(dt, 404 * slots, t, t, t, 0, seed=16 + slots, tag="[16]")
             for dt in ("float32", "bfloat16") for slots in (1, 8)]
    del models
    torch.cuda.empty_cache()
    return streaming_launches, cases


class ErrorLog(logging.Handler):
    """Keeps the messages of the records at ERROR or above."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def timed_clients(addr, tracks):
    """Each track through its own concurrent enhance_via_server client;
    returns the outputs and each client's wall seconds."""
    import threading

    from cmgan_torch.cli.serve import enhance_via_server

    outs, walls, errors = [None] * len(tracks), [None] * len(tracks), []

    def run(i):
        t0 = time.perf_counter()
        try:
            outs[i] = enhance_via_server(addr, tracks[i], block=3000, timeout=SERVE_WAIT)
        except Exception as exc:  # reported below, with the others
            errors.append(f"client {i}: {exc!r}")
        walls[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(tracks))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(2 * SERVE_WAIT)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"a served stream did not complete: {errors}")
    return outs, walls


def check_served(tag, outs, walls, tracks, refs, limit, smi, phase="[17]"):
    """Every stream complete and within `limit` (rel L2) of its reference stream."""
    import numpy as np

    for i, (out, wall, track, ref) in enumerate(zip(outs, walls, tracks, refs)):
        err = rel_l2(out, ref)
        log(f"{phase} {tag} client {i}: {track.size / SR:.0f} s in {wall:.3f} s wall, realtime "
            f"factor {track.size / SR / wall:.2f}, out len {out.size}, rel L2 against its reference "
            f"stream {err:.3e} (tol {limit}) on {smi}")
        if out.shape != track.shape or not np.isfinite(out).all() or not err <= limit:
            raise AssertionError(f"{tag}: a served stream is incomplete or disagrees")


def serve_process(args, tracks, tag):
    """`python -m cmgan_torch.cli.serve --port 0` with `args` as its own
    process: waits until it serves, runs each track through its own
    concurrent client, stops it by SIGTERM. Raises unless it ran with TF32
    off (its main() pins it) and stopped cleanly. Returns the clients'
    outputs and wall seconds."""
    import re
    import signal
    import threading

    cmd = [sys.executable, "-m", "cmgan_torch.cli.serve", "--port", "0", *args]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.DEVNULL,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    lines, ready = [], threading.Event()

    def read_stderr():
        for line in proc.stderr:
            lines.append(line.rstrip())
            if "serving on" in line:
                ready.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        t0 = time.perf_counter()
        if not ready.wait(SERVE_WAIT):
            raise AssertionError(f"{tag} the server process did not start: {lines[-20:]}")
        started = re.search(r"serving on [^:]+:(\d+) \(TF32: cuDNN (\w+), matmul (\w+)\)",
                            next(l for l in lines if "serving on" in l))
        port = int(started.group(1))
        server_tf32 = (started.group(2) == "True", started.group(3) == "True")
        log(f"{tag} {' '.join(cmd[1:])}: serving on port {port} after "
            f"{time.perf_counter() - t0:.1f} s, TF32 cuDNN {server_tf32[0]}, matmul "
            f"{server_tf32[1]}")
        outs, walls = timed_clients(("127.0.0.1", port), tracks)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(SERVE_WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(SERVE_WAIT)
    stopped = [l for l in lines if "stopped after" in l]
    log(f"{tag} server process exit code {rc}; {stopped[-1] if stopped else 'no tick count'}")
    if server_tf32 != (False, False):
        raise AssertionError(f"{tag} the serve CLI runs with TF32 on: cuDNN, matmul {server_tf32}")
    if rc != 0 or not stopped or any("batcher.step failed" in l or "Traceback" in l
                                     for l in lines):
        raise AssertionError(f"{tag} the server process failed or did not stop cleanly: "
                             f"{lines[-30:]}")
    return outs, walls


def serving_on_card(smi: str):
    """[17] the TCP server: solo mode in a thread against the direct stream,
    8 slots with 8 concurrent clients, then the CLI as its own process at the
    long-context window with two clients and a clean shutdown."""
    import threading

    import numpy as np
    import torch

    from cmgan_torch.cli.serve import make_server
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.inference import load_generator
    from cmgan_torch.streaming import StreamBatcher

    cfg = CMGANConfig()
    model = load_generator(cfg, None, None, "cuda", seed=0)   # as the CLI's random init
    errors = ErrorLog()
    logging.getLogger("cmgan_torch.serve").addHandler(errors)
    try:
        for slots, seconds in ((0, (20,)), (8, (3, 4, 5, 6, 7, 8, 9, 10))):
            server = make_server(cfg, model, port=0, slots=slots, device="cuda")
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            try:
                tracks = [synthetic_track(s * SR, seed=400 + i) for i, s in enumerate(seconds)]
                outs, walls = timed_clients(server.server_address, tracks)
                refs = [stream_solo(cfg, model, t, t.size) for t in tracks]
                ticks = server.worker.ticks if slots else None
            finally:
                server.shutdown()
                server.server_close()
                thread.join(SERVE_WAIT)
            if slots == 0:
                check_served("solo", outs, walls, tracks, refs, 0.0, smi)  # must be equal
            else:
                check_served(f"{slots} slots", outs, walls, tracks, refs,
                             SLOT_VS_SOLO_REL["float32"], smi)
                log(f"[17] {slots} slots: {len(tracks)} concurrent clients, {ticks} server "
                    f"ticks, {sum(seconds)} s of audio in {max(walls):.3f} s")
        if errors.messages:
            raise AssertionError(f"the server logged errors: {errors.messages}")
    finally:
        logging.getLogger("cmgan_torch.serve").removeHandler(errors)

    # the real entry point, as its own process
    cmd = ["--slots", "4", "--left_context", str(LONG_CONTEXT)]
    tracks = [synthetic_track(6 * SR, seed=420 + i) for i in range(2)]
    outs, walls = serve_process(cmd, tracks, "[17]")
    # the direct streams: an fp32 batcher of the server's 4 slots (the same
    # shapes a tick), TF32 off as in this process
    refs, _ = stream_slots(StreamBatcher(cfg, model, num_slots=4, left_context=LONG_CONTEXT,
                                         device="cuda"), tracks, [0, 0])
    check_served("the CLI, 4 slots, long context", outs, walls, tracks, refs,
                 SERVE_PROCESS_REL, smi)
    del model
    torch.cuda.empty_cache()


def long_form_on_card(smi: str):
    """[18] the 48 kHz long-form preset (`long_form_48k()`: 64 channels, 6
    TSCBs, 4 heads of dim 16, 601 bins) with seeded random weights. Returns
    (kernel #1's launches on the 30 s fp32 call, its cases at the preset's
    shape)."""
    import dataclasses

    import numpy as np
    import torch

    from cmgan_torch.config import long_form_48k
    from cmgan_torch.dsp import istft, stft
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import Trainer
    from cmgan_torch.utils import trace

    cfg = long_form_48k()
    sr, seconds = cfg.dsp.sample_rate, cfg.eval.cut_len // cfg.dsp.sample_rate
    frames = cfg.dsp.num_frames(cfg.eval.cut_len)
    groups = (cfg.dsp.num_freqs + 1) // 2 * cfg.model.attn_heads   # the encoder halves the bins
    blocks = cfg.model.num_tscb_blocks
    dense_gb = 4 * groups * frames * frames / 1e9
    log(f"[18] long_form_48k: {sr} Hz, n_fft {cfg.dsp.n_fft}, hop {cfg.dsp.hop}, "
        f"{cfg.dsp.num_freqs} bins, {blocks} TSCBs, a {seconds} s window of {frames} frames: "
        f"kernel #1 at G {groups}, T {frames}, {blocks} launches a segment; 'xla' is not run "
        f"there (its dense logits would be [{groups}, {frames}, {frames}], {dense_gb:.1f} GB "
        f"each in fp32)")
    track = synthetic_track(seconds * sr, seed=48, sr=sr)

    outs, state, launches_fp32 = {}, None, 0
    for dtype in (torch.float32, torch.bfloat16):
        name = "fp32" if dtype == torch.float32 else "bf16"
        enh = Enhancer(cfg, state, dtype=dtype, device="cuda", seed=0)
        state = enh.model.state_dict()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = 0
        y = enh.enhance(track, mode="bucket")
        launches = fa.launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        outs[name] = y
        if dtype == torch.float32:
            launches_fp32 = launches
        rtf = realtime_factor(lambda: enh.enhance(track, mode="bucket"), seconds, reps=2)
        log(f"[18] {seconds} s at {sr} Hz {name}: launches {launches} (expected {blocks}), out "
            f"len {y.shape[0]}, rms {float(np.sqrt(np.mean(y ** 2))):.6f}, peak memory "
            f"{peak:.2f} GiB, realtime factor {rtf:.2f}x ({1e3 * seconds / rtf:.1f} ms a call) "
            f"on {smi}")
        if launches != blocks or y.shape != track.shape or not np.all(np.isfinite(y)):
            raise AssertionError(f"the 48 kHz {name} call missed kernel #1 or is not whole")
        if dtype == torch.float32:
            device_breakdown(lambda: enh.enhance(track, mode="bucket"), 1e3 * seconds / rtf,
                             top=12, tag="[18]")
            with tempfile.TemporaryDirectory(dir=ROOT) as logdir:
                with trace(logdir) as prof:
                    enh.enhance(track, mode="bucket")
                names = os.listdir(logdir)
                with open(os.path.join(logdir, names[0])) as f:
                    events = json.load(f)["traceEvents"]
            kernel_events = sum(e.get("cat") == "kernel" and "flash_rel_fwd" in e.get("name", "")
                                for e in events)
            profiled = [e for e in prof.key_averages() if "flash_rel_fwd" in e.key]
            log(f"[18] trace(): {names[0]}, {len(events)} events, {kernel_events} kernel events "
                f"of flash_rel_fwd, {sum(e.count for e in profiled)} counted by key_averages()")
            if len(names) != 1 or kernel_events != blocks:
                raise AssertionError("trace() did not capture kernel #1")
        del enh
        torch.cuda.empty_cache()
    err16 = rel_l2(outs["bf16"], outs["fp32"])
    log(f"[18] bf16 against fp32: rel L2 {err16:.3e} (tol {BF16_VS_FP32_REL})")
    if not err16 <= BF16_VS_FP32_REL:
        raise AssertionError("the 48 kHz bf16 call is too far from fp32")

    # kernel #1 at the preset's shape against its plain version
    cases = [check_kernel_case(dt, groups, frames, frames, frames, 0, seed=48, tag="[18]")
             for dt in ("float32", "bfloat16")]

    # 'auto' against 'xla' where the dense logits fit the card
    short = synthetic_track(LONG_XLA_SECONDS * sr, seed=49, sr=sr)
    auto = Enhancer(cfg, state, device="cuda")
    fa.launches = 0
    y_auto = auto.enhance(short, mode="bucket")
    launches = fa.launches
    del auto
    torch.cuda.empty_cache()
    xla_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attention_impl="xla"))
    xla = Enhancer(xla_cfg, state, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    y_xla = xla.enhance(short, mode="bucket")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del xla
    torch.cuda.empty_cache()
    err = rel_l2(y_auto, y_xla)
    log(f"[18] {LONG_XLA_SECONDS} s ({cfg.dsp.num_frames(short.size)} frames): 'auto' "
        f"launches {launches}, against 'xla' rel L2 {err:.3e} (tol {FLASH_VS_XLA_REL}); "
        f"'xla' peak memory {peak:.2f} GiB")
    if launches != blocks or not err <= FLASH_VS_XLA_REL:
        raise AssertionError("the 48 kHz flash path disagrees with 'xla'")

    # the matmul DFT against torch.fft on the card
    for n_fft, hop in ((400, 100), (cfg.dsp.n_fft, cfg.dsp.hop)):
        x = torch.from_numpy(np.stack([synthetic_track(10 * sr, seed=50 + i, sr=sr)
                                       for i in range(4)])).cuda()
        spec = stft(x, n_fft, hop)
        spec_mm = stft(x, n_fft, hop, dft_impl="matmul")
        y_fft = istft(spec, n_fft, hop, length=x.shape[-1])
        y_mm = istft(spec, n_fft, hop, length=x.shape[-1], dft_impl="matmul")
        errs = [((a - b).norm() / b.norm()).item() for a, b in ((spec_mm, spec), (y_mm, y_fft))]
        ms = [cuda_ms(f, reps=10) for f in (
            lambda: stft(x, n_fft, hop), lambda: stft(x, n_fft, hop, dft_impl="matmul"))]
        log(f"[18] stft/istft 'matmul' against 'fft', n_fft {n_fft} hop {hop}, 4 x 10 s: rel L2 "
            f"{errs[0]:.3e} / {errs[1]:.3e} (tol {MATMUL_DFT_REL}); stft {ms[0]:.3f} ms 'fft', "
            f"{ms[1]:.3f} ms 'matmul'")
        if not max(errs) <= MATMUL_DFT_REL:
            raise AssertionError("the matmul DFT disagrees with torch.fft on the card")

    # one train_step of the preset at its own cut_len (dense), fp32, host labels
    train_cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=PRESET_TRAIN_REMAT),
        train=dataclasses.replace(cfg.train, batch_size=PRESET_TRAIN_BATCH))
    cut = cfg.train.cut_len
    clean = np.stack([synthetic_track(cut, 90 + i, sr=sr) for i in range(PRESET_TRAIN_BATCH)])
    noisy = clean + (0.05 * np.random.default_rng(90).standard_normal(clean.shape)).astype(
        np.float32)
    trainer = Trainer(train_cfg, [None], None, device="cuda")
    fa.launches = fa.backward_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen_loss, disc_loss = trainer.train_step(clean, noisy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        gen_loss, disc_loss = trainer.train_step(clean, noisy)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[18] train_step cut_len {cut} ({cfg.dsp.num_frames(cut)} frames) batch "
        f"{PRESET_TRAIN_BATCH} remat {PRESET_TRAIN_REMAT} fp32 host labels: {step_ms:.1f} ms a "
        f"step, peak memory {peak:.2f} GiB, gen loss {float(gen_loss):.5f}, disc loss "
        f"{float(disc_loss):.5f}, launches {fa.launches} fwd / {fa.backward_launches} bwd on {smi}")
    if trainer.state.step != 3 or not (np.isfinite(float(gen_loss)) and np.isfinite(float(disc_loss))):
        raise AssertionError("the preset's train_step did not run")
    del trainer
    torch.cuda.empty_cache()
    return launches_fp32, cases


def state_tensors(trainer) -> dict:
    """Every tensor a train step changes, by name, cloned: both models'
    state_dicts and both AdamW states."""
    state, out = trainer.state, {}
    for tag, model, opt in (("G", state.gen, state.gen_opt), ("D", state.disc, state.disc_opt)):
        out.update({f"{tag} {k}": v.clone() for k, v in model.state_dict().items()})
        for name, p in model.named_parameters():
            out.update({f"{tag} {name} {k}": v.clone() for k, v in opt.state[p].items()})
    return out


def worst_rel(a: dict, b: dict):
    """(name, largest |a - b| over the largest |b|) of the tensor where that
    is largest, and how many tensors differ at all."""
    worst, differ = ("", 0.0), 0
    for name, y in b.items():
        x, y = a[name].double(), y.double()
        diff = (x - y).abs().max().item()
        if diff:
            differ += 1
            rel = diff / max(y.abs().max().item(), 1e-30)
            worst = max(worst, (name, rel), key=lambda w: w[1])
    return worst, differ


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (cuDNN's, index_put_'s) within the block, so
    two runs of one step differ only where their code does."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def mesh_step_on_card(store: str, smi: str):
    """[19a] a device-label Trainer.train_step at cut_len 64000 over a NCCL
    process group of one rank (mesh=make_mesh(...): every collective call
    site of a data-parallel step) against the same step with no mesh, both
    under deterministic algorithms; then a second step of the mesh's, the
    batch on the card, under set_sync_debug_mode("error"). Joins the
    process group (world 1, a FileStore at `store`) and leaves it up;
    returns the mesh and the mesh step's (forward, backward) launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cmgan_torch.config import MeshConfig
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.parallel import make_mesh
    from cmgan_torch.train import Trainer

    cfg = train_config(FLASH_CUT, mode="device")
    batches = [train_batch(FLASH_CUT, seed=s) for s in (190, 191)]
    with deterministic():
        ref = Trainer(cfg, [None] * 10, None, device="cuda")   # before the group: no mesh
        ref_losses = [float(x) for x in ref.train_step(*batches[0])]
        ref_state = state_tensors(ref)
        del ref
        dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
        mesh = make_mesh(MeshConfig(), "cuda")
        par = Trainer(cfg, [None] * 10, None, device="cuda", mesh=mesh)
        fa.launches = fa.backward_launches = 0
        losses = [float(x) for x in par.train_step(*batches[0])]
        torch.cuda.synchronize()
        launches = (fa.launches, fa.backward_launches)
        got = state_tensors(par)
    on_card = [torch.from_numpy(a).cuda() for a in batches[1]]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        par.train_step(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    (worst_name, worst), differ = worst_rel(got, ref_state)
    blocks = cfg.model.num_tscb_blocks
    log(f"[19a] NCCL world 1, mesh {mesh.shape} on {mesh.device}: device-label train_step "
        f"cut_len {FLASH_CUT} batch {TRAIN_BATCH}, launches {launches[0]} fwd / {launches[1]} "
        f"bwd; losses mesh {losses}, no mesh {ref_losses}; of {len(got)} state tensors "
        + ("all bitwise equal" if not differ else
           f"{differ} differ, the most {worst:.3e} of its largest entry ({worst_name})")
        + f"; a second step ran under set_sync_debug_mode('error'), on {smi}")
    if launches != (blocks, blocks) or set(got) != set(ref_state) or differ \
            or losses != ref_losses:
        raise AssertionError("the step over a one-rank mesh is not bitwise the step without one")
    del par
    torch.cuda.empty_cache()
    return mesh, launches


def seq_rank_cases(smi, dtype_name, g, t, n, seed, max_pos=512, d=16):
    """[19b] the per-rank function of seq_rel_attention for ranks 0 .. n-1
    in one process: each rank's forward (kernel #1 at q_offset r * t_loc,
    keys padded to n * t_loc, t_valid t) against the unsharded kernel #1,
    and its backward (kernel #2 at each offset; dq concatenated, dk, dv and
    the table's gradient summed) against the unsharded kernel #2. Returns
    (forward cases, backward cases), one a rank, timed beside the
    unsharded launch and the rank's plain versions (forward; autograd
    through it)."""
    import torch
    import torch.nn.functional as F

    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.ops import seq_attention as sa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    q = randn(g, t, d, scale=d ** -0.5)
    k, v, cot = randn(g, t, d), randn(g, t, d), randn(g, t, d)
    table = randn(2 * max_pos + 1, d)
    t_loc = sa.local_block(t, n)
    tk = n * t_loc

    leaves = [x.clone().requires_grad_() for x in (q, k, v, table)]
    full = fa.flash_rel_attention_at(*leaves, max_pos)
    full_grads = torch.autograd.grad(full, leaves, cot)
    cot_pad = F.pad(cot, (0, 0, 0, tk - t))
    fa.launches = fa.backward_launches = 0
    blocks, sums = [], [torch.zeros_like(x, dtype=torch.float32) for x in (q, k, v, table)]

    def rank_grads(r):
        leaves = [x.clone().requires_grad_() for x in (q, k, v, table)]
        out = sa.local_attention(*leaves, max_pos, r, n)
        return out, torch.autograd.grad(out, leaves, cot_pad[:, r * t_loc:(r + 1) * t_loc])

    per_rank = []
    for r in range(n):
        out, grads = rank_grads(r)
        blocks.append(out.detach())
        per_rank.append(grads)
        for acc, x in zip(sums, grads):
            acc += x.float()
    torch.cuda.synchronize()
    launches = (fa.launches, fa.backward_launches)
    if launches != (n, n):
        raise AssertionError(f"{n} ranks launched {launches} kernels, not {n} and {n}")
    # each rank's backward once more on the same inputs: the same bits
    bitwise = [all(torch.equal(a, b) for a, b in zip(rank_grads(r)[1], per_rank[r]))
               for r in range(n)]
    del per_rank
    out = torch.cat(blocks, dim=1)[:, :t].float()
    fwd_err = (out - full.detach().float()).abs().max().item()
    atol, rtol = KERNEL_TOL[dtype_name]
    fwd_ok = torch.allclose(out, full.detach().float(), atol=atol, rtol=rtol)
    tol = BWD_TOL[dtype_name]
    bwd_errs, bwd_ok = {}, all(bitwise)
    for name, a, b in zip(("dq", "dk", "dv", "dE"), sums, full_grads):
        err, top = (a - b.float()).abs().max().item(), b.float().abs().max().item()
        bwd_errs[name] = {"max_abs_err": err, "ref_max": top}
        bwd_ok = bwd_ok and bool(torch.isfinite(a).all()) and err <= tol * top

    # each rank's launches, timed, beside the unsharded one and its plain versions
    kp, vp, qp = (F.pad(x, (0, 0, 0, tk - t)) for x in (k, v, q))
    band = fa.make_rel_band(table, tk, max_pos)
    full_fwd_ms = cuda_ms(lambda: fa.flash_rel_attention_at(q, k, v, table, max_pos), reps=5)
    out_f, lse_f = fa._launch_forward(q, k, v, table, max_pos, t, 0, True)
    full_bwd_ms = cuda_ms(lambda: fa._launch_backward(q, k, v, table, out_f, lse_f, cot,
                                                      max_pos, t, 0), reps=3)
    fwd_cases, bwd_cases = [], []
    for r in range(n):
        off = r * t_loc
        q_r, c_r = qp[:, off:off + t_loc].contiguous(), cot_pad[:, off:off + t_loc].contiguous()
        ms = cuda_ms(lambda: fa.flash_rel_attention_at(q_r, kp, vp, table, max_pos, t, off), reps=5)
        out_r, lse_r = fa._launch_forward(q_r, kp, vp, table, max_pos, t, off, True)
        bwd_ms = cuda_ms(lambda: fa._launch_backward(q_r, kp, vp, table, out_r, lse_r, c_r,
                                                     max_pos, t, off), reps=3)

        def plain_fwd():
            for s in range(0, g, PLAIN_GROUP_CHUNK):
                sl = slice(s, s + PLAIN_GROUP_CHUNK)
                fa.reference_attention(q_r[sl], kp[sl], vp[sl], band, t, off)

        def plain_bwd(chunk=16):
            for s in range(0, g, chunk):
                sl = slice(s, s + chunk)
                fa.reference_attention_grads(q_r[sl], kp[sl], vp[sl], table, max_pos, t, off,
                                             c_r[sl])

        plain_ms, plain_bwd_ms = cuda_ms(plain_fwd, reps=1), cuda_ms(plain_bwd, reps=1)
        shape = {"dtype": dtype_name, "rank": r, "ranks": n, "G": g, "Tq": t_loc, "Tk": tk,
                 "D": d, "t_valid": t, "q_offset": off, "max_pos": max_pos}
        fwd_cases.append({**shape, "ms": ms, "unsharded_ms": full_fwd_ms, "plain_ms": plain_ms,
                          "max_abs_err": fwd_err, "tol": [atol, rtol],
                          **attention_bound(dtype_name, g, t_loc, tk, t, off, max_pos,
                                            backward=False, d=d)})
        bwd_cases.append({**shape, "ms": bwd_ms, "unsharded_ms": full_bwd_ms,
                          "plain_ms": plain_bwd_ms, "bitwise": bitwise[r],
                          "errors": bwd_errs, "tol_of_ref_max": tol,
                          "max_abs_err": max(e["max_abs_err"] for m, e in bwd_errs.items()
                                             if m != "dE"),
                          **attention_bound(dtype_name, g, t_loc, tk, t, off, max_pos,
                                            backward=True, d=d)})
        log(f"[19b] {dtype_name} rank {r}/{n}: kernel #1 at Tq {t_loc}, Tk {tk}, t_valid {t}, "
            f"q_offset {off}: {ms:.3f} ms (bound {fwd_cases[-1]['bound_ms']:.3f}, "
            f"{fwd_cases[-1]['bound_by']}; plain {plain_ms:.2f}); kernel #2 {bwd_ms:.3f} ms "
            f"(bound {bwd_cases[-1]['bound_ms']:.3f}, {bwd_cases[-1]['bound_by']}; plain "
            f"{plain_bwd_ms:.2f}); its backward twice: "
            + ("bitwise equal" if bitwise[r] else "DIFFER"))
    full_fwd_bound = attention_bound(dtype_name, g, t, t, t, 0, max_pos, backward=False, d=d)
    full_bwd_bound = attention_bound(dtype_name, g, t, t, t, 0, max_pos, backward=True, d=d)
    log(f"[19b] {dtype_name} G {g}, T {t} unsharded: kernel #1 {full_fwd_ms:.3f} ms (bound "
        f"{full_fwd_bound['bound_ms']:.3f}, {full_fwd_bound['bound_by']}), kernel #2 "
        f"{full_bwd_ms:.3f} ms (bound {full_bwd_bound['bound_ms']:.3f}, "
        f"{full_bwd_bound['bound_by']}); {n} ranks in all {sum(c['ms'] for c in fwd_cases):.3f} / "
        f"{sum(c['ms'] for c in bwd_cases):.3f} ms; forward max abs err {fwd_err:.3e} (tol "
        f"{atol}, {rtol}), backward {json.dumps(bwd_errs)} (tol {tol} of ref max) on {smi}")
    if not (fwd_ok and bwd_ok):
        raise AssertionError(f"the {n} ranks' kernels disagree with the unsharded ones")
    del q, k, v, cot, kp, vp, qp, band, full, full_grads, sums, blocks
    torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


def long_form_seq_on_card(mesh, smi: str):
    """[19c] long_form_48k() with attention_impl='seq' over the one-rank
    mesh: a 30 s track against 'auto' (both through kernel #1: at Tq = Tk
    4864, t_valid 4801, and at T 4801), and the preset's G step at its
    cut_len 96000 through 'seq' (kernels #1 and #2 at T 384, t_valid 321)
    against 'xla', then one Trainer.train_step through each (the same
    dropout masks: both draw them from the seed in one order). Returns the
    launches of the 30 s call and of the train_step."""
    import dataclasses

    import numpy as np
    import torch

    from cmgan_torch.config import long_form_48k
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.ops import seq_attention as sa
    from cmgan_torch.train import Trainer, init_train_state

    base = long_form_48k()

    def impl(name, **model):
        return dataclasses.replace(base, model=dataclasses.replace(
            base.model, attention_impl=name, **model))

    sr, seconds = base.dsp.sample_rate, base.eval.cut_len // base.dsp.sample_rate
    frames, blocks = base.dsp.num_frames(base.eval.cut_len), base.model.num_tscb_blocks
    track = synthetic_track(seconds * sr, seed=148, sr=sr)
    auto = Enhancer(base, None, device="cuda", seed=0)
    state = auto.model.state_dict()
    fa.launches = 0
    y_auto = auto.enhance(track, mode="bucket")
    auto_launches = fa.launches
    rtf_auto = realtime_factor(lambda: auto.enhance(track, mode="bucket"), seconds, reps=2)
    del auto
    seq = Enhancer(impl("seq"), state, mesh=mesh)
    fa.launches = 0
    y_seq = seq.enhance(track, mode="bucket")
    seq_launches = fa.launches
    rtf = realtime_factor(lambda: seq.enhance(track, mode="bucket"), seconds, reps=2)
    del seq
    torch.cuda.empty_cache()
    err = rel_l2(y_seq, y_auto)
    t_loc = sa.local_block(frames, mesh.seq_size)
    log(f"[19c] long_form_48k 'seq' over {mesh.shape}, {seconds} s ({frames} frames): launches "
        f"{seq_launches} (kernel #1 at Tq = Tk {t_loc}, t_valid {frames}), 'auto' {auto_launches};"
        f" rel L2 against 'auto' {err:.3e} (tol {SEQ_VS_AUTO_REL}); realtime factor {rtf:.2f}x, "
        f"'auto' {rtf_auto:.2f}x, on {smi}")
    if (seq_launches, auto_launches) != (blocks, blocks) or y_seq.shape != track.shape \
            or not np.all(np.isfinite(y_seq)) or not err <= SEQ_VS_AUTO_REL:
        raise AssertionError("the 48 kHz 'seq' call disagrees with 'auto'")

    # the preset's G step through 'seq' against 'xla', from the same weights
    train = dataclasses.replace(base.train, batch_size=PRESET_TRAIN_BATCH)
    cut = base.train.cut_len
    clean = np.stack([synthetic_track(cut, 150 + i, sr=sr) for i in range(PRESET_TRAIN_BATCH)])
    noisy = clean + (0.05 * np.random.default_rng(150).standard_normal(clean.shape)).astype(
        np.float32)
    clean_d, noisy_d = torch.from_numpy(clean).cuda(), torch.from_numpy(noisy).cuda()
    seq_cfg = dataclasses.replace(impl("seq", remat=PRESET_TRAIN_REMAT), train=train)
    xla_cfg = dataclasses.replace(impl("xla", remat=PRESET_TRAIN_REMAT), train=train)
    fresh = init_train_state(xla_cfg, seed=0, steps_per_epoch=1, device="cuda")
    weights = ({k: v.clone() for k, v in fresh.gen.state_dict().items()},
               {k: v.clone() for k, v in fresh.disc.state_dict().items()})
    del fresh
    # dropout off: its masks differ between the two paths
    loss_s, g_s, names, fwd, bwd, _ = g_step_gradients("seq", clean_d, noisy_d, weights,
                                                       dropout=False, cfg=seq_cfg, mesh=mesh)
    loss_x, g_x, _, fwd_x, bwd_x, _ = g_step_gradients("xla", clean_d, noisy_d, weights,
                                                       dropout=False, cfg=xla_cfg)
    top = max(g.norm().item() for g in g_x)
    worst = max(((a - b).norm() / max(b.norm().item(), 1e-2 * top)).item()
                for a, b in zip(g_s, g_x))
    whole = whole_rel_l2(g_s, g_x)
    loss_rel = abs(loss_s - loss_x) / abs(loss_x)
    t_train = sa.local_block(base.dsp.num_frames(cut), mesh.seq_size)
    log(f"[19c] preset G step cut_len {cut} batch {PRESET_TRAIN_BATCH} remat "
        f"{PRESET_TRAIN_REMAT}, 'seq' (kernels at T {t_train}, t_valid "
        f"{base.dsp.num_frames(cut)}: {fwd} fwd / {bwd} bwd launches) against 'xla' "
        f"({fwd_x} / {bwd_x}): loss rel {loss_rel:.3e}, all gradients rel L2 {whole:.3e} (tol "
        f"{GSTEP_REL}), worst parameter {worst:.3e} (tol {GSTEP_PARAM_REL})")
    if bwd != blocks or fwd < blocks or (fwd_x, bwd_x) != (0, 0) or not (
            loss_rel <= GSTEP_REL and whole <= GSTEP_REL and worst <= GSTEP_PARAM_REL):
        raise AssertionError("the preset's G step through 'seq' disagrees with 'xla'")

    xla = Trainer(xla_cfg, [None], None, device="cuda")
    xla_losses = np.array([float(x) for x in xla.train_step(clean, noisy)])
    del xla
    trainer = Trainer(seq_cfg, [None], None, device="cuda", mesh=mesh)
    fa.launches = fa.backward_launches = 0
    losses = np.array([float(x) for x in trainer.train_step(clean, noisy)])
    train_launches = (fa.launches, fa.backward_launches)
    rel = np.abs(losses - xla_losses) / np.abs(xla_losses)
    log(f"[19c] preset Trainer.train_step through 'seq': gen, disc loss {rounded(losses, 7)}, "
        f"'xla' {rounded(xla_losses, 7)} (rel {rounded(rel, 9)}, tol {GSTEP_REL}), launches "
        f"{train_launches[0]} fwd / {train_launches[1]} bwd")
    if train_launches[1] != blocks or trainer.state.step != 1 or not np.all(rel <= GSTEP_REL):
        raise AssertionError("the preset's train_step through 'seq' disagrees with 'xla'")
    del trainer
    torch.cuda.empty_cache()
    return seq_launches, train_launches


def local_loader_on_card(mesh, tmp: str, smi: str, g_ms: float):
    """[19d] (a) a Trainer over the one-rank mesh whose train loader is
    sharded by data rank (load_data at the mesh's data size and rank) over a
    written dataset at cut_len 64000, batch 4: one epoch (one step) through
    train_epoch, which feeds the loader's rows to the step as local rows, in
    the device and in the host label mode; each against a Trainer on the
    same mesh fed the same rows as a global batch through train_step, both
    under deterministic algorithms: every state tensor bitwise equal. (b)
    host seconds a batch, prefetch 0, over one
    epoch of LOADER_FILES written files: a global loader of batch x
    LOADER_RANKS rows and a local one of batch rows at process 0 of
    LOADER_RANKS, beside [12]'s G step. Returns (a)'s (forward, backward)
    launches by mode."""
    import torch

    from cmgan_torch.data.dataset import BatchLoader, DemandDataset, load_data
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import Trainer

    data_dir = os.path.join(tmp, "data19d")
    write_dataset(data_dir, n_train=TRAIN_BATCH, n_test=1)
    blocks, launches = train_config(FLASH_CUT).model.num_tscb_blocks, {}
    for mode in ("device", "host"):
        cfg = train_config(FLASH_CUT, mode=mode)
        with deterministic():
            train, _ = load_data(data_dir, TRAIN_BATCH, FLASH_CUT, cfg.train.seed,
                                 num_processes=mesh.data_size, process_index=mesh.data_rank)
            local = Trainer(cfg, train, None, device="cuda", mesh=mesh)
            if not local.local_rows or local.steps_per_epoch != 1:
                raise AssertionError("the sharded loader is not taken as this data rank's rows")
            fa.launches = fa.backward_launches = 0
            local.train_epoch(0)
            torch.cuda.synchronize()
            launches[mode] = (fa.launches, fa.backward_launches)
            got = state_tensors(local)
            del local
            rows, _ = load_data(data_dir, TRAIN_BATCH, FLASH_CUT, cfg.train.seed)
            rows.prefetch = 0
            (batch,) = list(rows)
            ref = Trainer(cfg, [None], None, device="cuda", mesh=mesh)
            ref.train_step(*batch)
            torch.cuda.synchronize()
            want = state_tensors(ref)
            del ref
        (worst_name, worst), differ = worst_rel(got, want)
        log(f"[19d] local loader (process {train.process_index} of {train.num_processes}), "
            f"{mode} labels, one epoch of {TRAIN_BATCH} rows: launches {launches[mode][0]} fwd / "
            f"{launches[mode][1]} bwd; of {len(want)} state tensors against the global-loader "
            "step " + ("all bitwise equal" if not differ else
                       f"{differ} differ, the most {worst:.3e} of its largest entry ({worst_name})")
            + f", on {smi}")
        if launches[mode] != (blocks, blocks) or set(got) != set(want) or differ:
            raise AssertionError("the local-loader step is not bitwise the global-loader step")
        torch.cuda.empty_cache()

    # (b) what a rank's loader reads: every rank the global batch, or its shard
    times_dir = os.path.join(tmp, "data19d_times")
    write_dataset(times_dir, n_train=LOADER_FILES, n_test=1)
    ds = DemandDataset(os.path.join(times_dir, "train"), FLASH_CUT)
    loaders = {
        "global": lambda: BatchLoader(ds, TRAIN_BATCH * LOADER_RANKS, prefetch=0),
        "local": lambda: BatchLoader(ds, TRAIN_BATCH, num_processes=LOADER_RANKS,
                                     process_index=0, prefetch=0),
    }
    list(loaders["global"]())   # every file read once: both timings from the page cache
    per_batch = {name: [] for name in loaders}
    for _ in range(2):
        for name, make in loaders.items():
            loader = make()
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            per_batch[name].append((time.perf_counter() - t0) / n)
    glob, loc = min(per_batch["global"]), min(per_batch["local"])
    log(f"[19d] host seconds a batch, prefetch 0, one epoch of {LOADER_FILES} files at cut_len "
        f"{FLASH_CUT}: global loader {TRAIN_BATCH * LOADER_RANKS} rows {per_batch['global']}, "
        f"local loader {TRAIN_BATCH} rows at process 0 of {LOADER_RANKS} {per_batch['local']}; "
        f"best {glob:.6f} s against {loc:.6f} s ({glob / loc:.2f}x), beside a G step of "
        f"{g_ms:.1f} ms ([12], cut_len {FLASH_CUT}, batch {TRAIN_BATCH}): {100e3 * glob / g_ms:.2f}% "
        f"and {100e3 * loc / g_ms:.2f}% of it; a local batch's reads reach a G step at "
        f"{g_ms / (1e3 * loc):.0f} data ranks' worth of rows, on {smi}")
    if not (glob > 0 and loc > 0):
        raise AssertionError("the loader timings are not positive")
    return launches


def parallel_on_card(smi: str, g_ms: float):
    """[19] data and sequence parallelism: (a) a step over a NCCL mesh of
    one rank, (b) a 4-rank sequence split's kernels in one process at the
    48 kHz preset's shape, (c) the preset through 'seq', (d) a loader
    sharded by data rank over the mesh and the loaders' host time. Returns
    the launch counts and the per-rank kernel cases; ends the process
    group."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        try:
            mesh, step_launches = mesh_step_on_card(os.path.join(tmp, "store"), smi)
            local_launches = local_loader_on_card(mesh, tmp, smi, g_ms)
            fwd_cases, bwd_cases = [], []
            for dt in ("float32", "bfloat16"):
                f, b = seq_rank_cases(smi, dt, SEQ_G, SEQ_T, SEQ_RANKS, seed=190)
                fwd_cases += f
                bwd_cases += b
            seq_launches, train_launches = long_form_seq_on_card(mesh, smi)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    return step_launches, local_launches, seq_launches, train_launches, fwd_cases, bwd_cases


def trained_weights_on_card(smi: str):
    """[20] the JAX package's trained fold-1 EMA generator (generator.pt in
    TRAINED_DIR, loaded through inference.load_generator) and its own output
    on the 4 s track of golden_4s.npz: (a) the port's Enhancer in bucket
    mode, fp32, 'auto' (4 launches of kernel #1) against that output; (b)
    'xla' against 'auto'; (c) bf16 against the card's fp32, beside the JAX
    package's bf16 against its fp32; (d) a 16 s track of the same recipe,
    'auto' against 'xla' and bf16 against fp32; (e) one device-label
    train_step at cut_len 64000 from the trained generator and a seeded
    discriminator, run twice from one state under deterministic algorithms:
    every state tensor bitwise equal; then (f)-(h) against the JAX
    package's streams, served streams and G step (trained_streams,
    trained_g_step). Returns (a)'s launches, (e)'s (forward, backward)
    launches, (f)'s launches by window and (h)'s (forward, backward)."""
    import numpy as np
    import torch

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import Enhancer, load_generator
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import Trainer, init_train_state

    sd = torch.load(os.path.join(TRAINED_DIR, "generator.pt"), map_location="cpu",
                    weights_only=True)
    golden = load_npz(os.path.join(TRAINED_DIR, "golden_4s.npz"))
    blocks = CMGANConfig().model.num_tscb_blocks

    def enhance(track, impl, dtype):
        cfg = CMGANConfig(model=ModelConfig(attention_impl=impl))
        enh = Enhancer(cfg, load_generator(cfg, sd, dtype, "cuda"), dtype=dtype, device="cuda")
        fa.launches = 0
        y = enh.enhance(track, mode="bucket")
        torch.cuda.synchronize()
        if y.shape != track.shape or not np.all(np.isfinite(y)):
            raise AssertionError(f"[20] {impl} {dtype}: not finite or not the input's length")
        return y, fa.launches

    errs, launches = {}, {}
    tracks = {"4 s": golden["noisy"],
              f"{TRAINED_LONG_SECONDS} s": synthetic_track(TRAINED_LONG_SECONDS * SR, seed=20)}
    for name, track in tracks.items():
        y32, launches[name] = enhance(track, "auto", torch.float32)
        y_xla, _ = enhance(track, "xla", torch.float32)
        y16, launches[name + " bf16"] = enhance(track, "auto", torch.bfloat16)
        errs[name] = {"auto_vs_xla": rel_l2(y32, y_xla), "bf16_vs_fp32": rel_l2(y16, y32)}
        if name == "4 s":
            errs[name]["fp32_vs_jax"] = rel_l2(y32, golden["enhanced_fp32"])
            errs[name]["jax_bf16_vs_jax_fp32"] = rel_l2(golden["enhanced_bf16"],
                                                        golden["enhanced_fp32"])
            errs[name]["bf16_vs_jax_bf16"] = rel_l2(y16, golden["enhanced_bf16"])
        torch.cuda.empty_cache()
    log(f"[20] trained generator (fold-1 EMA), bucket mode, kernel #1 launches {launches}; rel L2 "
        f"{json.dumps(errs)} (tol: fp32 against the JAX package and 'auto' against 'xla' "
        f"{FLASH_VS_XLA_REL}, bf16 against fp32 {TRAINED_BF16_REL}), on {smi}")
    ok = all(n == blocks for n in launches.values())
    for e in errs.values():
        ok = ok and e["auto_vs_xla"] <= FLASH_VS_XLA_REL and e["bf16_vs_fp32"] <= TRAINED_BF16_REL
    if not (ok and errs["4 s"]["fp32_vs_jax"] <= FLASH_VS_XLA_REL):
        raise AssertionError("[20] the trained generator's outputs disagree")

    # (e) one training step from the trained generator, twice from one state
    cfg = train_config(FLASH_CUT, mode="device")
    batch = train_batch(FLASH_CUT, seed=200)
    runs = []
    with deterministic():
        for _ in range(2):
            state = init_train_state(cfg, cfg.train.seed, steps_per_epoch=10, device="cuda")
            state.gen.load_state_dict(sd, strict=True)
            trainer = Trainer(cfg, [None] * 10, None, device="cuda", state=state)
            fa.launches = fa.backward_launches = 0
            losses = [float(x) for x in trainer.train_step(*batch)]
            torch.cuda.synchronize()
            runs.append((losses, (fa.launches, fa.backward_launches), state_tensors(trainer)))
            del trainer, state
    (worst_name, worst), differ = worst_rel(runs[1][2], runs[0][2])
    log(f"[20] device-label train_step from the trained generator, cut_len {FLASH_CUT} batch "
        f"{TRAIN_BATCH}, twice from one state: losses {runs[0][0]} / {runs[1][0]}, launches "
        f"{runs[0][1]} / {runs[1][1]}; of {len(runs[0][2])} state tensors "
        + ("all bitwise equal" if not differ else
           f"{differ} differ, the most {worst:.3e} of its largest entry ({worst_name})"))
    if differ or runs[0][0] != runs[1][0] or runs[0][1] != (blocks, blocks) \
            or runs[1][1] != runs[0][1] or not np.all(np.isfinite(runs[0][0])):
        raise AssertionError("[20] two runs of one train step are not bitwise equal")
    step_launches = runs[0][1]
    del runs
    torch.cuda.empty_cache()
    stream_launches = trained_streams(sd, smi)
    gstep_launches = trained_g_step(sd, smi)
    return launches["4 s"], step_launches, stream_launches, gstep_launches


def load_npz(path) -> dict:
    import numpy as np

    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def trained_streams(sd, smi: str):
    """[20] (f) the port's StreamBatcher on the card, 'auto', from the
    trained generator, on golden_stream.npz's tracks opened at its ticks, at
    each of its windows: every slot's emissions, tick by tick, against the
    JAX package's (fp32), kernel #1's launches a tick, bf16 against fp32;
    (g) the serve CLI with --torch_ckpt at the long-context window as its own
    process, two concurrent clients, against the golden and against (f).
    Returns kernel #1's launches in (f)'s fp32 runs, by window."""
    import numpy as np
    import torch

    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.streaming import StreamBatcher

    golden = load_npz(os.path.join(TRAINED_DIR, "golden_stream.npz"))
    opens = [int(t) for t in golden["open_ticks"]]
    tracks = [golden[f"track_{i}"] for i in range(len(opens))]
    chunk, lookahead = int(golden["chunk"]), int(golden["lookahead"])
    cfg = CMGANConfig()
    blocks = cfg.model.num_tscb_blocks
    launches, card = {}, {}
    for lc in (int(x) for x in golden["left_contexts"]):
        frames = cfg.dsp.num_frames(lc + chunk + lookahead)
        per_tick = blocks if lc == LONG_CONTEXT else 0
        outs = {}
        for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
            batcher = StreamBatcher(cfg, sd, num_slots=len(tracks), chunk=chunk,
                                    left_context=lc, lookahead=lookahead, dtype=dtype,
                                    device="cuda")
            fa.launches = 0
            emitted, ticks = stream_emissions(batcher, tracks, opens)
            torch.cuda.synchronize()
            if name == "fp32":
                launches[lc] = fa.launches
            if fa.launches != per_tick * ticks:
                raise AssertionError(f"[20] (f) {name} window {frames} frames: kernel #1 launched "
                                     f"{fa.launches} times in {ticks} ticks, not {per_tick} a tick")
            for i, e in enumerate(emitted):
                sizes = [t.size for t in e]
                if sizes != golden[f"emitted_{lc}_{i}"].tolist():
                    raise AssertionError(f"[20] (f) slot {i} emitted {sizes}")
            outs[name] = [np.concatenate(e) for e in emitted]
            del batcher
        card[lc] = outs["fp32"]
        errs = {i: {"fp32_vs_jax": rel_l2(outs["fp32"][i], golden[f"out_{lc}_{i}"]),
                    "bf16_vs_fp32": rel_l2(outs["bf16"][i], outs["fp32"][i])}
                for i in range(len(tracks))}
        log(f"[20] (f) StreamBatcher {len(tracks)} slots, trained generator, left_context {lc} "
            f"({frames} frames), tracks of {[t.size / SR for t in tracks]} s opened at ticks "
            f"{opens}, {ticks} ticks: kernel #1 launches {launches[lc]} ({per_tick} a tick); rel "
            f"L2 {json.dumps(errs)} (tol: fp32 against the JAX package {FLASH_VS_XLA_REL}, bf16 "
            f"against fp32 {TRAINED_BF16_REL}) on {smi}")
        if not all(e["fp32_vs_jax"] <= FLASH_VS_XLA_REL and e["bf16_vs_fp32"] <= TRAINED_BF16_REL
                   for e in errs.values()):
            raise AssertionError("[20] (f) the trained generator's streams disagree")
        torch.cuda.empty_cache()

    # (g) the serve CLI as its own process, from generator.pt
    ckpt = os.path.relpath(os.path.join(TRAINED_DIR, "generator.pt"), ROOT)
    outs, walls = serve_process(["--slots", str(len(tracks)), "--left_context",
                                 str(LONG_CONTEXT), "--torch_ckpt", ckpt], tracks, "[20] (g)")
    check_served("the CLI, trained generator, against the JAX package's streams", outs, walls,
                 tracks, [golden[f"out_{LONG_CONTEXT}_{i}"][:t.size] for i, t in enumerate(tracks)],
                 SERVE_PROCESS_REL + FLASH_VS_XLA_REL, smi, phase="[20] (g)")
    check_served("the CLI, trained generator, against (f)'s batcher", outs, walls, tracks,
                 [o[:t.size] for o, t in zip(card[LONG_CONTEXT], tracks)],
                 SERVE_PROCESS_REL, smi, phase="[20] (g)")
    return launches


def seeded_disc(names, shapes, seed: int):
    """The discriminator's flax variables (params, batch_stats) as nested
    dicts of float32 arrays, made leaf by leaf from a numpy seed. names:
    "collection:module:leaf"; shapes: "AxBxC". Kernels N(0, 1/fan_in);
    biases N(0, 0.05^2); InstanceNorm scales, PReLU and sigmoid slopes their
    init (1, 0.25, 1) plus N(0, 0.05^2); spectral-norm u N(0, 1), sigma 1."""
    import numpy as np

    trees = {"params": {}, "batch_stats": {}}
    for index, (name, text) in enumerate(zip(names, shapes)):
        collection, module, leaf = str(name).split(":")
        shape = tuple(int(n) for n in str(text).split("x") if n)
        z = np.random.default_rng([seed, index]).standard_normal(shape)
        kind = leaf.rsplit("/", 1)[-1]
        if kind == "kernel":
            x = z / np.sqrt(np.prod(shape[:-1]))
        elif kind == "u":
            x = z
        elif kind == "sigma":
            x = np.ones(shape)
        else:
            x = {"bias": 0.0, "scale": 1.0, "alpha": 0.25, "slope": 1.0}[kind] + 0.05 * z
        trees[collection].setdefault(module, {})[leaf] = np.asarray(x, np.float32)
    return trees["params"], trees["batch_stats"]


def grad_sketch(index: int, g, seed: int, size: int = 64):
    """A linear sketch of `size` numbers of one parameter's gradient: a
    count sketch (each entry added, with a random sign, into one of `size`
    buckets, both drawn from the seed and the parameter's index), or the
    gradient itself, zero-padded, where it has at most `size` entries. For
    any two gradients a and b, sketch(a) - sketch(b) = sketch(a - b), whose
    squared norm is ||a - b||^2 in expectation (relative spread
    sqrt(2 / size), 18% at 64): a golden holds a gradient's distance from
    its own without storing it."""
    import numpy as np

    g = np.asarray(g, np.float64).reshape(-1)
    if g.size <= size:
        return np.pad(g, (0, size - g.size))
    rng = np.random.default_rng([seed, index])
    bucket = rng.integers(0, size, g.size)
    sign = 2.0 * rng.integers(0, 2, g.size) - 1.0
    return np.bincount(bucket, weights=sign * g, minlength=size)


def gradient_errors(golden: dict, grads: dict):
    """A generator gradient (name -> array, the port's names) against
    golden_gstep.npz's: each parameter's distance, from the sketches (exact
    for the leaves stored whole, `grad:<name>`), over its golden norm, or
    over 1e-2 of the largest golden norm where that is more (as
    bench.gradient_rel); and all parameters as one vector. Returns (whole,
    {name: relative distance})."""
    import numpy as np

    names, norms = [str(n) for n in golden["grad_names"]], golden["grad_norms"]
    if set(grads) != set(names):
        raise ValueError(f"gradient names differ: {sorted(set(grads) ^ set(names))[:5]}")
    size, seed = golden["grad_sketch"].shape[1], int(golden["sketch_seed"])
    floor = 1e-2 * float(norms.max())
    dist = {}
    for index, name in enumerate(names):
        g = np.asarray(grads[name], np.float64)
        whole = golden.get(f"grad:{name}")
        if whole is not None:
            dist[name] = float(np.linalg.norm(g - whole))
        else:
            dist[name] = float(np.linalg.norm(grad_sketch(index, g, seed, size)
                                              - golden["grad_sketch"][index]))
    total = float(np.sqrt(sum(d * d for d in dist.values())) / np.sqrt(np.sum(norms ** 2)))
    return total, {n: d / max(float(norm), floor) for (n, d), norm in zip(dist.items(), norms)}


def trained_g_step(sd, smi: str):
    """[20] (h) one G step of the port's Trainer on the card ('auto', fp32,
    TF32 off, deterministic algorithms, dropout 0) from the trained
    generator and golden_gstep.npz's seeded discriminator on its seeded
    batch, read through bench.g_step_record (the loss, and the gradient from
    AdamW's first moment): the loss, every parameter's gradient (sketched)
    and the attention leaves' whole gradients against the JAX package's
    step. Then the same step in float64 ('xla', remat), the gradient both
    float32 steps are rounded from: the worst parameter's distance from it,
    the port's exact and the JAX package's through the sketch. Returns
    kernel #1's and #2's launches."""
    import dataclasses

    import numpy as np
    import torch

    from cmgan_torch.bench import g_step_record
    from cmgan_torch.config import CMGANConfig, ModelConfig, TrainConfig
    from cmgan_torch.convert import disc_state_dict_from_flax
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.train import Trainer, init_train_state

    golden = load_npz(os.path.join(TRAINED_DIR, "golden_gstep.npz"))
    cut, batch = int(golden["cut_len"]), int(golden["batch"])
    clean, noisy = train_batch(cut, int(golden["batch_seed"]), batch)
    sumsq = [np.sum(np.square(x, dtype=np.float64)) for x in (clean, noisy)]
    if not np.allclose(sumsq, golden["batch_sumsq"], rtol=1e-6, atol=0):
        raise AssertionError(f"[20] (h) the seeded batch is not the golden's: {sumsq}")
    no_dropout = dict(attn_dropout=0.0, ff_dropout=0.0, disc_dropout=0.0)
    cfg = CMGANConfig(model=ModelConfig(attention_impl="auto", **no_dropout),
                      train=dataclasses.replace(TrainConfig(), batch_size=batch, cut_len=cut))
    disc = disc_state_dict_from_flax(*seeded_disc(golden["disc_names"], golden["disc_shapes"],
                                                  int(golden["disc_seed"])))
    with deterministic():
        state = init_train_state(cfg, seed=0, steps_per_epoch=1, device="cuda")
        state.gen.load_state_dict(sd, strict=True)
        state.disc.load_state_dict(disc, strict=True)
        trainer = Trainer(cfg, [None], None, device="cuda", state=state)
        fa.launches = fa.backward_launches = 0
        audio, loss, moments = g_step_record(trainer, clean, noisy)
        torch.cuda.synchronize()
        launched = (fa.launches, fa.backward_launches)
    beta1 = trainer.state.gen_opt.param_groups[0]["betas"][0]
    names = [name for name, _ in trainer.state.gen.named_parameters()]
    got = {n: (m / (1 - beta1)).cpu().numpy() for n, m in zip(names, moments)}
    finite = bool(torch.isfinite(audio).all()) and audio.shape == (batch, cut)
    del trainer, state, audio, moments
    torch.cuda.empty_cache()
    loss_rel = abs(loss - float(golden["loss"])) / abs(float(golden["loss"]))
    whole, per = gradient_errors(golden, got)
    worst = max(per, key=per.get)
    attention = {n[len("grad:"):]: per[n[len("grad:"):]] for n in golden if n.startswith("grad:")}

    # the float64 step (dropout 0, remat to hold float64 activations)
    c, n = (torch.from_numpy(x).cuda() for x in (clean, noisy))
    cfg64 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attention_impl="xla",
                                                               remat=True))
    _, truth, _, _, _, _ = g_step_gradients("xla", c, n, (sd, disc), double=True, cfg=cfg64)
    index = names.index(worst)
    t = truth[index].cpu().numpy()
    port64 = float(np.linalg.norm(got[worst] - t) / np.linalg.norm(t))
    jax64 = float(np.linalg.norm(golden["grad_sketch"][index] - grad_sketch(
        index, t, int(golden["sketch_seed"]), golden["grad_sketch"].shape[1])) / np.linalg.norm(t))
    del truth, c, n
    torch.cuda.empty_cache()

    blocks = cfg.model.num_tscb_blocks
    log(f"[20] (h) Trainer.g_step from the trained generator, cut_len {cut} batch {batch}, fp32, "
        f"dropout 0: kernel launches {launched[0]} forward / {launched[1]} backward; loss "
        f"{loss:.8f}, the JAX package's {float(golden['loss']):.8f}, rel {loss_rel:.3e} (tol "
        f"{TRAINED_GSTEP_LOSS_REL}); enhanced audio finite {finite}")
    log(f"[20] (h) gradients against the JAX package's: all {len(names)} parameters as one "
        f"vector rel L2 {whole:.3e} (tol {GSTEP_REL}), worst parameter {per[worst]:.3e} "
        f"({worst}; tol {GSTEP_PARAM_REL}); the attention leaves whole: {json.dumps(attention)}; "
        f"the worst parameter's float32 gradients against the float64 step's, rel L2: the "
        f"port's {port64:.3e}, the JAX package's {jax64:.3e} (sketched) on {smi}")
    if launched != (blocks, blocks):
        raise AssertionError(f"[20] (h) expected {blocks} launches of kernels #1 and #2")
    if not (finite and loss_rel <= TRAINED_GSTEP_LOSS_REL and whole <= GSTEP_REL
            and per[worst] <= GSTEP_PARAM_REL):
        raise AssertionError("[20] (h) the G step from the trained generator disagrees with the "
                             "JAX package's")
    return launched


def library_route(dtype_name, g, tq, tk, t_valid, q_offset, seed, backward: bool, max_pos=512,
                  d=16):
    """[21] the library route for kernel #1 (backward: #2) on the inputs of
    [2]'s (or [7]'s) case at this seed: the position bias formed as
    [G, Tq, Tk] by one einsum over the band gathered in fp32 (keys from
    t_valid masked by -inf), then scaled_dot_product_attention with it as
    the mask (q carries the scale), each part timed apart, in G-chunks whose
    bias fits LIBRARY_BIAS_BYTES (the chunks' times summed); held against
    the kernel's output (and gradients) on the same inputs, and the kernel
    timed beside it."""
    import torch
    import torch.nn.functional as F

    from cmgan_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    q = randn(g, tq, d, scale=d ** -0.5)
    k, v = randn(g, tk, d), randn(g, tk, d)
    table = randn(2 * max_pos + 1, d)
    i = torch.arange(tq, device="cuda") + q_offset
    dist = i[:, None] - torch.arange(tk, device="cuda")[None, :] + tk - 1
    mask = torch.zeros(tq, tk, dtype=dtype, device="cuda")
    mask[:, t_valid:] = float("-inf")

    def bias_of(q, table):
        rel = fa.make_rel_band(table.float(), tk, max_pos)[dist].to(dtype)
        bias = torch.einsum("gid,ijd->gij", q, rel)
        return bias + mask if t_valid < tk else bias

    def attend(q, k, v, bias):
        return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=bias[None],
                                              scale=1.0)[0]

    def kernel(*x):
        return fa.flash_rel_attention_at(*x, max_pos, t_valid, q_offset)

    step = max(1, min(g, int(LIBRARY_BIAS_BYTES[backward] // (tq * tk * q.element_size()))))
    chunks = [slice(s, s + step) for s in range(0, g, step)]
    record = {"dtype": dtype_name, "G": g, "Tq": tq, "Tk": tk, "D": d, "t_valid": t_valid,
              "q_offset": q_offset, "max_pos": max_pos, "chunks": len(chunks),
              "bias_gb": g * tq * tk * q.element_size() / 1e9}
    if not backward:
        with torch.no_grad():
            ref = kernel(q, k, v, table)
            record["kernel_ms"] = cuda_ms(lambda: kernel(q, k, v, table), reps=5)
            out = torch.empty_like(q)
            record["bias_ms"] = record["sdpa_ms"] = 0.0
            for sl in chunks:
                bias = bias_of(q[sl], table)
                out[sl] = attend(q[sl], k[sl], v[sl], bias)
                record["sdpa_ms"] += cuda_ms(lambda: attend(q[sl], k[sl], v[sl], bias), reps=2)
                del bias
                record["bias_ms"] += cuda_ms(lambda: bias_of(q[sl], table), reps=2)
        record["library_ms"] = record["bias_ms"] + record["sdpa_ms"]
        errs = {"out": rel_l2(out.float().cpu().numpy(), ref.float().cpu().numpy())}
        del out, ref
    else:
        cot = randn(g, tq, d)
        kernel_leaves = [x.clone().requires_grad_() for x in (q, k, v, table)]
        want = torch.autograd.grad(kernel(*kernel_leaves), kernel_leaves, cot)
        del kernel_leaves
        # the backward kernel alone, at its width (a narrower head is padded to it)
        width = fa.kernel_head_dim(d)
        qp, kp, vp, tp, cp = (F.pad(x, (0, width - d)) for x in (q, k, v, table, cot))
        outp, lse = fa._launch_forward(qp, kp, vp, tp, max_pos, t_valid, q_offset, True)
        record["kernel_ms"] = cuda_ms(lambda: fa._launch_backward(
            qp, kp, vp, tp, outp, lse, cp, max_pos, t_valid, q_offset), reps=3)
        del qp, kp, vp, tp, cp, outp, lse
        lib = [torch.zeros_like(x, dtype=torch.float32) for x in (q, k, v, table)]
        for key in ("bias_fwd_ms", "sdpa_fwd_ms", "sdpa_bwd_ms", "bias_bwd_ms"):
            record[key] = 0.0
        for sl in chunks:
            ql, kl, vl = (x[sl].clone().requires_grad_() for x in (q, k, v))
            tl = table.clone().requires_grad_()
            bias = bias_of(ql, tl)
            bias_leaf = bias.detach().requires_grad_()
            out = attend(ql, kl, vl, bias_leaf)
            dq, dk, dv, dbias = torch.autograd.grad(out, [ql, kl, vl, bias_leaf], cot[sl],
                                                    retain_graph=True)
            dq_bias, dtable = torch.autograd.grad(bias, [ql, tl], dbias, retain_graph=True)
            lib[0][sl], lib[1][sl], lib[2][sl] = (dq + dq_bias).float(), dk.float(), dv.float()
            lib[3] += dtable.float()
            del dq, dk, dv, dq_bias, dtable
            record["sdpa_bwd_ms"] += cuda_ms(lambda: torch.autograd.grad(
                out, [ql, kl, vl, bias_leaf], cot[sl], retain_graph=True), reps=2)
            record["bias_bwd_ms"] += cuda_ms(lambda: torch.autograd.grad(
                bias, [ql, tl], dbias, retain_graph=True), reps=2)
            record["sdpa_fwd_ms"] += cuda_ms(lambda: attend(ql, kl, vl, bias_leaf), reps=2)
            del out, dbias
            record["bias_fwd_ms"] += cuda_ms(lambda: bias_of(ql, tl), reps=2)
            del ql, kl, vl, tl, bias, bias_leaf
        record["library_ms"] = record["sdpa_bwd_ms"] + record["bias_bwd_ms"]
        errs = {n: ((a - b.float()).abs().max() / b.float().abs().max()).item()
                for n, a, b in zip(("dq", "dk", "dv", "dE"), lib, want)}
        del lib, want
    torch.cuda.empty_cache()
    record["rel_err_against_kernel"] = errs
    # the bias rounds to the input type: bf16 holds to its own limit
    limit = (BWD_TOL[dtype_name] if backward else
             KERNEL_TOL["float32"][1] if dtype_name == "float32" else BF16_VS_FP32_REL)
    log(f"[21] library route {'backward' if backward else 'forward'} {json.dumps(record)} "
        f"(limit {limit})")
    if not all(e <= limit for e in errs.values()):
        raise AssertionError("[21] the library route disagrees with the kernel")
    return record


def library_cases():
    """[21] the library route at every shape of PERF.md's kernel table, fp32
    and bf16, with the backward wherever the row has one: kernel #1 at the
    16 s segment, the G step's shape (G 1616, T 641), the streaming shapes
    (G 404 and 3232, T 601), the 48 kHz segment (G 1204, T 4801: its fp32
    bias is 111 GB, so in chunks), head dims 8, 32 and 64, the wide heads
    and their offset case, one rank of 4 in the 48 kHz sequence split (Tq
    1280, Tk 5120 from q_offset 0 to 3840); kernel #2 at the G step's
    shape, head dims 8, 32 and 64, max_pos 1536, the wide heads and the
    split. Returns (forward records, backward records)."""
    both = ("float32", "bfloat16")
    t601 = 601
    fwd = [library_route(dt, 404, 2561, 2561, 2561, 0, seed=2561, backward=False) for dt in both]
    fwd += [library_route(dt, 1616, 641, 641, 641, 0, seed=5, backward=False) for dt in both]
    fwd += [library_route(dt, 404 * slots, t601, t601, t601, 0, seed=16 + slots, backward=False)
            for dt in both for slots in (1, 8)]
    fwd += [library_route(dt, SEQ_G, SEQ_T, SEQ_T, SEQ_T, 0, seed=18, backward=False)
            for dt in both]
    fwd += [library_route(dt, 404, 641, 641, 641, 0, seed=20 + d, backward=False, d=d)
            for d in (8, 32, 64) for dt in both]
    fwd += [library_route(dt, 404, 641, 641, 641, 0, seed=40 + d, backward=False, d=d)
            for d in WIDE_HEAD_DIMS for dt in both]
    fwd.append(library_route("float32", 404, 320, 641, 600, 128, seed=41, backward=False, d=128))
    from cmgan_torch.ops import seq_attention as sa

    t_loc = sa.local_block(SEQ_T, SEQ_RANKS)
    t_pad = SEQ_RANKS * t_loc
    fwd += [library_route(dt, SEQ_G, t_loc, t_pad, SEQ_T, r * t_loc, seed=60 + r, backward=False)
            for dt in both for r in range(SEQ_RANKS)]
    bwd = [library_route(dt, 1616, 641, 641, 641, 0, seed=7, backward=True) for dt in both]
    bwd += [library_route(dt, 404, 641, 641, 641, 0, seed=30 + d, backward=True, d=d)
            for d in (8, 32, 64) for dt in both]
    bwd += [library_route(dt, 32, 2561, 2561, 2561, 0, seed=16, backward=True, max_pos=1536)
            for dt in both]
    bwd += [library_route(dt, 404, 641, 641, 641, 0, seed=50 + d, backward=True, d=d)
            for d in WIDE_HEAD_DIMS for dt in both]
    bwd.append(library_route("float32", 404, 320, 641, 600, 128, seed=51, backward=True, d=128))
    bwd += [library_route(dt, SEQ_G, t_loc, t_pad, SEQ_T, r * t_loc, seed=70 + r, backward=True)
            for dt in both for r in range(SEQ_RANKS)]
    return fwd, bwd


def bench_on_card(smi: str):
    """[21] every cell of the bench (cmgan_torch.bench) once, BENCH_REPS
    repeats each, a traced window each; the bench's tools (lockstep ticks,
    the DSP's share); the library route for kernels #1 and #2. Returns
    kernel #1's and #2's library records."""
    import numpy as np
    import torch

    from cmgan_torch import bench
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.inference import load_generator
    from cmgan_torch.tools import profile_dsp_share, serving_bench

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ctx = bench.Run(smi, seed=0, reps=BENCH_REPS, trace_dir=tmp)
        summary = bench.run(list(bench.CELLS), ctx, emit=lambda line: log(f"[21] {line}"))
    log(f"[21] bench summary {json.dumps(summary)}")

    cfg = CMGANConfig()
    model = load_generator(cfg, None, torch.bfloat16, "cuda")
    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        (16, 2 * SR))).astype(np.float32)).cuda()
    share = profile_dsp_share.dsp_share(model, cfg.dsp, x, iters=5)
    log(f"[21] tools.profile_dsp_share, 16 x 2 s bf16: {json.dumps(share)} on {smi}")
    del model, x
    fp32 = load_generator(cfg, None, None, "cuda")
    ticks = serving_bench.lockstep_ticks(cfg, fp32, 8, 5, 2, seed=0)
    log(f"[21] tools.serving_bench lockstep, 8 streams: ms a tick "
        f"{json.dumps(rounded([1e3 * s for s in ticks], 3))} on {smi}")
    del fp32
    torch.cuda.empty_cache()

    return library_cases()


def backward_phase(m):
    """[7] with the functions of the chip_smoke module m (this file, or
    another checkout's with the same functions): kernel #2's cases, the wide
    backward's, their device profiles and the fp32 kernels against float64.
    Returns (kernel #2's cases, the wide backward's cases, kernel #2's device
    ms by kernel at the G step's shape, by type, and under "wide_g404" the
    wide backward's at G 404, T 641, D 128 and 320)."""
    bwd_cases = [m.check_backward_case(dt, 1616, 641, 641, 641, 0, seed=7)
                 for dt in ("float32", "bfloat16")]
    bwd_cases += m.backward_head_dim_cases()
    bwd_cases.append(m.check_backward_case("float32", 101, 2561, 2561, 2561, 0, seed=8, chunk=16))
    bwd_cases.append(m.check_backward_case("bfloat16", 101, 2561, 2561, 2561, 0, seed=8, chunk=16))
    for dt in ("float32", "bfloat16"):  # most tile pairs clipped
        bwd_cases.append(m.check_backward_case(dt, 404, 641, 641, 641, 0, seed=12, max_pos=64))
    bwd_cases.append(m.check_backward_case("float32", 404, 641, 641, 600, 0, seed=9))
    bwd_cases.append(m.check_backward_case("float32", 101, 1280, 2560, 2560, 128, seed=10,
                                           chunk=16))
    for dt in ("float32", "bfloat16"):
        bwd_cases.append(m.check_backward_case(dt, 101, 641, 641, 1, 0, seed=15))  # one valid key
        # the longest table the kernels take (2 * 1536 + 1 rows)
        bwd_cases.append(m.check_backward_case(dt, 32, 2561, 2561, 2561, 0, seed=16, chunk=16,
                                               max_pos=1536))
    wide_bwd_cases = m.wide_backward_cases()
    wide_profiles = {dt: {d: m.backward_profile(dt, g=404, d=d) for d in (128, 320)}
                     for dt in ("float32", "bfloat16")}
    m.check_against_float64()
    if "d" in inspect.signature(m.check_against_float64).parameters:
        m.check_against_float64(d=128)
    profiles = {dt: m.backward_profile(dt) for dt in ("float32", "bfloat16")}
    profiles["wide_g404"] = wide_profiles
    return bwd_cases, wide_bwd_cases, profiles


def forward_phase(m):
    """`--forward-times`: kernel #1 at every shape of PERF.md's kernel table,
    fp32 and bf16, with the functions of the chip_smoke module m (this file,
    or another checkout's with the same functions): the 16 s segment, the G
    step's shape, the streaming shapes, the 48 kHz segment, the four ranks of
    its sequence split, head dims 8, 32 and 64, the wide heads (D 80, 100,
    128, 256 and 320 at G 404, T 641), and fp32 D 128 at Tq 320, t_valid 600,
    q_offset 128."""
    from cmgan_torch.ops import seq_attention as sa

    t_loc = sa.local_block(SEQ_T, SEQ_RANKS)
    cases = []
    for dt in ("float32", "bfloat16"):
        cases.append(m.check_kernel_case(dt, 404, 2561, 2561, 2561, 0, seed=2561))
        cases.append(m.check_kernel_case(dt, 1616, 641, 641, 641, 0, seed=5))
        for slots in (1, 8):
            cases.append(m.check_kernel_case(dt, 404 * slots, 601, 601, 601, 0, seed=16 + slots))
        cases.append(m.check_kernel_case(dt, SEQ_G, SEQ_T, SEQ_T, SEQ_T, 0, seed=18))
        for r in range(SEQ_RANKS):
            cases.append(m.check_kernel_case(dt, SEQ_G, t_loc, SEQ_RANKS * t_loc, SEQ_T, r * t_loc,
                                             seed=60 + r))
        for d in (8, 32, 64):
            cases.append(m.check_kernel_case(dt, 404, 641, 641, 641, 0, seed=20 + d, d=d))
        for d in WIDE_HEAD_DIMS:
            cases.append(m.check_kernel_case(dt, 404, 641, 641, 641, 0, seed=40 + d, d=d))
    cases.append(m.check_kernel_case("float32", 404, 320, 641, 600, 128, seed=41, d=128))
    return cases


def times(root: str, phase: str) -> int:
    """`--backward-times [ROOT]` / `--forward-times [ROOT]`: [1]'s builds and
    [7] (or kernel #1's cases) with the chip_smoke.py (and so the package) of
    the checkout at ROOT, then one JSON line of every case's shape, times and
    bound, and the library route in both types at head dims 64, 128 and 320
    (forward: also [2]'s 128-channel model's enhance call and G step;
    backward: also the device ms of
    each of kernel #2's kernels at the G step's shape and of the wide
    backward's at G 404, T 641, D 128 and 320)."""
    import importlib.util

    import torch

    root = os.path.abspath(root)
    if not os.path.isdir(os.path.join(root, "cmgan_torch")):
        print(f"chip_smoke: no cmgan_torch package in {root}", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_at_root",
                                                  os.path.join(root, "chip_smoke.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[1] card: {smi}; checkout {root}")
    m.build_all()
    keys = ("dtype", "G", "Tq", "Tk", "D", "t_valid", "q_offset", "max_pos", "ms", "plain_ms",
            "bound_ms", "bound_by", "bitwise", "max_abs_err", "lse_err")
    record = {"root": root, "card": smi}
    if phase == "backward":
        bwd_cases, wide_cases, record["backward_profile"] = backward_phase(m)
        cases = bwd_cases + wide_cases
        record["library"] = [
            {k: r[k] for k in ("dtype", "D", "library_ms", "kernel_ms", "sdpa_bwd_ms",
                               "bias_bwd_ms")}
            for r in (library_route(dt, 404, 641, 641, 641, 0, seed=94 + d - 64, backward=True,
                                    d=d)
                      for d in (64, 128, 320) for dt in ("float32", "bfloat16"))]
    else:
        record["wide_model"] = wide_model_times()
        cases = forward_phase(m)
        # [9]'s reading, at its own batch and two more
        record["g_step_float64"] = [g_step_float64(seed, m) for seed in (40, 41, 42)]
        record["library"] = [
            {k: r[k] for k in ("dtype", "D", "library_ms", "kernel_ms", "bias_ms", "sdpa_ms")}
            for r in (library_route(dt, 404, 641, 641, 641, 0, seed=84 + d - 64, backward=False,
                                    d=d)
                      for d in (64, 128, 320) for dt in ("float32", "bfloat16"))]
    record["cases"] = [{k: c.get(k) for k in keys} for c in cases]
    for case in record["cases"]:
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
    print(json.dumps(record))
    return 0


def sfu_ms(ops: float) -> float:
    """ops results of the special-function units at their rate on this card."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * ops / (EXP_PER_CLOCK_SM * sms * max_sm_clock_hz())


def check_scan_case(rows, length, reverse, seed, d=256, n=16, r=4):
    """[22] the selective scan at one of the cell's shapes and direction,
    on operands laid out as the model gives them (z the in-projection's
    second half, dt, B and C thirds of the x-projection's output), against
    its plain version, twice (bitwise), timed beside its bounds."""
    import math

    import torch

    from cmgan_torch.ops import selective_scan as ss
    from perfbench.archs.semamba import SCAN_PEAK_FLOPS, scan_work

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn(rows, length, d, generator=gen, device="cuda")
    xz = torch.randn(rows, length, 2 * d, generator=gen, device="cuda")
    x_dbl = torch.randn(rows, length, r + 2 * n, generator=gen, device="cuda")
    z, dt, B, C = xz[..., d:], x_dbl[..., :r], x_dbl[..., r:r + n], x_dbl[..., r + n:]
    dt_w = torch.rand(d, r, generator=gen, device="cuda") - 0.5
    lo, hi = math.log(1e-3), math.log(1e-1)
    delta = torch.exp(torch.rand(d, generator=gen, device="cuda") * (hi - lo) + lo)
    dt_bias = delta + torch.log(-torch.expm1(-delta))
    A = -torch.arange(1, n + 1, dtype=torch.float32, device="cuda").repeat(d, 1)
    D = torch.rand(d, generator=gen, device="cuda") + 0.5
    args = (u, dt, dt_w, dt_bias, A, B, C, D, z)

    def kernel():
        return ss.selective_scan(*args, reverse=reverse)

    def plain():
        return ss._scan_plain(*args, reverse)

    count = ss.launches
    y, again = kernel(), kernel()
    launched = ss.launches - count
    ref = plain()
    torch.cuda.synchronize()
    rtol, atol = SCAN_TOL
    err = (y - ref).abs().max().item()
    bitwise = torch.equal(y, again)
    ok = launched == 2 and bool(torch.isfinite(y).all()) and bitwise
    ok = ok and torch.allclose(y, ref, rtol=rtol, atol=atol)
    del again, ref
    ms = cuda_ms(kernel, reps=10)
    kernel_device_ms = device_ms(kernel, reps=10)
    plain_ms = cuda_ms(plain, reps=1)
    tokens = rows * length
    w = scan_work(rows, length, d, n, 4)
    b_ms, b_by = max((1e3 * w["bytes"] / PEAK_BYTES, "bytes"),
                     (1e3 * w["flop"] / SCAN_PEAK_FLOPS, "operations"))
    # what the kernel itself reads and writes: u, z, y of d floats a step,
    # dt (r) in place of delta, B and C (n each); the parameters once
    own_bytes = 4 * (tokens * (3 * d + r + 2 * n) + d * (n + r + 2))
    # its special-function results: n decays a (step, channel), softplus's
    # and SiLU's exponentials and SiLU's reciprocal
    sfu = tokens * d * (n + 3)
    case = {"rows": rows, "L": length, "D": d, "N": n, "R": r, "reverse": reverse,
            "max_abs_err": err, "ref_max": y.abs().max().item(), "tol": [rtol, atol],
            "bitwise_repeat": bitwise, "ms": ms, "device_ms": kernel_device_ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms, "own_bytes_bound_ms": 1e3 * own_bytes / PEAK_BYTES,
            "own_bytes_share": 1e3 * own_bytes / PEAK_BYTES / ms, "sfu_bound_ms": sfu_ms(sfu),
            "sfu_share": sfu_ms(sfu) / ms}
    log(f"[22] selective scan {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"the scan kernel disagrees with its plain version or itself: {case}")
    return case


def check_conv_case(rows, length, reverse, seed, d=256, k=4):
    """[22] the causal conv + SiLU on the in-projection's strided half
    against its plain version and, forward, against F.conv1d + SiLU, the
    library's call: on the same strided [rows, L, D] operand, and on a
    contiguous [rows, D, L] one (the published layout)."""
    import torch
    import torch.nn.functional as F

    from cmgan_torch.ops import selective_scan as ss

    gen = torch.Generator(device="cuda").manual_seed(seed)
    xz = torch.randn(rows, length, 2 * d, generator=gen, device="cuda")
    x = xz[..., :d]
    w = torch.randn(d, k, generator=gen, device="cuda") * 0.5
    b = torch.randn(d, generator=gen, device="cuda")

    def kernel():
        return ss.causal_conv1d_silu(x, w, b, reverse)

    def library(xt):
        return F.silu(F.conv1d(xt, w[:, None], b, padding=k - 1, groups=d)[..., :length])

    count = ss.conv_launches
    y = kernel()
    launched = ss.conv_launches - count
    ref = ss._conv_plain(x, w, b, reverse)
    torch.cuda.synchronize()
    rtol, atol = CONV_TOL
    ok = launched == 1 and torch.allclose(y, ref, rtol=rtol, atol=atol)
    case = {"rows": rows, "L": length, "D": d, "K": k, "reverse": reverse,
            "max_abs_err": (y - ref).abs().max().item(), "tol": [rtol, atol]}
    del ref
    if not reverse:
        lib = library(x.transpose(1, 2))
        case["max_abs_err_vs_library"] = (y - lib.transpose(1, 2)).abs().max().item()
        ok = ok and torch.allclose(y, lib.transpose(1, 2), rtol=rtol, atol=atol)
        del lib
        native = x.transpose(1, 2).contiguous()
        case["library_ms"] = cuda_ms(lambda: library(x.transpose(1, 2)), reps=10)
        case["library_device_ms"] = device_ms(lambda: library(x.transpose(1, 2)), reps=10)
        case["library_ms_contiguous_dl"] = cuda_ms(lambda: library(native), reps=10)
        case["library_device_ms_contiguous_dl"] = device_ms(lambda: library(native), reps=10)
        del native
    tokens = rows * length
    b_ms, b_by = bound_ms(tokens * d * (2 * k + 4), 4 * (2 * tokens * d + d * (k + 1)), "float32")
    case.update({"ms": cuda_ms(kernel, reps=10), "device_ms": device_ms(kernel, reps=10),
                 "plain_ms": cuda_ms(lambda: ss._conv_plain(x, w, b, reverse), reps=3),
                 "bound_ms": b_ms, "bound_by": b_by})
    case["bound_share"] = b_ms / case["ms"]
    log(f"[22] causal conv {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"the conv kernel disagrees with its plain version or F.conv1d: {case}")
    return case


def check_rmsnorm_case(n, seed, c=64, eps=1e-5):
    """[22] RMSNorm's kernel against its plain version and F.rms_norm."""
    import torch
    import torch.nn.functional as F

    from cmgan_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, c, generator=gen, device="cuda") * 2 + 0.5
    weight = torch.rand(c, generator=gen, device="cuda") + 0.5

    def kernel():
        return fn.fused_rmsnorm(x, weight, eps)

    def library():
        return F.rms_norm(x, (c,), weight, eps)

    count = fn.rms_launches
    y = kernel()
    launched = fn.rms_launches - count
    ref, lib = fn._rms_reference(x, weight, eps), library()
    torch.cuda.synchronize()
    rtol, atol = RMS_TOL
    ok = launched == 1 and torch.allclose(y, ref, rtol=rtol, atol=atol)
    ok = ok and torch.allclose(y, lib, rtol=rtol, atol=atol)
    b_ms, b_by = bound_ms(3 * n * c, 4 * (2 * n * c + c), "float32")
    case = {"N": n, "C": c, "max_abs_err": (y - ref).abs().max().item(),
            "max_abs_err_vs_library": (y - lib).abs().max().item(), "tol": [rtol, atol],
            "ms": cuda_ms(kernel, reps=20), "device_ms": device_ms(kernel, reps=20),
            "plain_ms": cuda_ms(lambda: fn._rms_reference(x, weight, eps), reps=5),
            "library_ms": cuda_ms(library, reps=20), "library_device_ms": device_ms(library, reps=20),
            "bound_ms": b_ms, "bound_by": b_by}
    case["bound_share"] = b_ms / case["ms"]
    log(f"[22] rmsnorm {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"the RMSNorm kernel disagrees with its plain version or F.rms_norm: "
                             f"{case}")
    return case


def semamba_on_card(smi: str) -> list:
    """[22] SEMamba's kernels at the cell's shapes, then their launches in one
    enhancement call of the published model on 8 x 16 s. Returns the
    kernels line's entries for the three kernels."""
    import numpy as np
    import torch

    from cmgan_torch import inference
    from cmgan_torch.cli import pin_fp32
    from cmgan_torch.config import semamba_16k
    from cmgan_torch.ops import fused_norm
    from cmgan_torch.ops import selective_scan as ss

    pin_fp32()
    # the cell's shapes: 8 x 16 s is 2561 frames; the encoder halves 201 bins to 100
    time_rows, freq_rows = (8 * 100, 2561), (8 * 2561, 100)
    scans, convs = [], []
    for i, (rows, length) in enumerate((time_rows, freq_rows)):
        for reverse in (False, True):
            scans.append(check_scan_case(rows, length, reverse, seed=60 + i))
            convs.append(check_conv_case(rows, length, reverse, seed=70 + i))
            torch.cuda.empty_cache()
    norm = check_rmsnorm_case(8 * 2561 * 100, seed=80)
    torch.cuda.empty_cache()

    cfg = semamba_16k()
    model = inference.load_generator(cfg, None, None, "cuda", seed=5)
    audio = torch.from_numpy(np.stack([synthetic_track(16 * SR, 90 + i) for i in range(8)])).cuda()

    def call():
        return inference.enhance_tensor(model, cfg.dsp, audio)

    with torch.inference_mode():
        ss.launches = ss.conv_launches = fused_norm.rms_launches = 0
        out = call()
        torch.cuda.synchronize()
        counts = {"scan": ss.launches, "conv": ss.conv_launches, "rmsnorm": fused_norm.rms_launches}
        call_ms = cuda_ms(call, reps=3)
    finite = bool(torch.isfinite(out).all())
    log(f"[22] SEMamba 8 x 16 s call on {smi}: launches {json.dumps(counts)}, {call_ms:.2f} ms a "
        f"call, finite {finite}")
    del model, audio, out
    torch.cuda.empty_cache()
    if counts != {"scan": 16, "conv": 16, "rmsnorm": 16} or not finite:
        raise AssertionError(f"the SEMamba call did not launch each kernel 16 times: {counts}")
    main_scan, main_conv = scans[0], convs[0]
    return [{
        "name": "selective_scan",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/selective_scan.cu",
        "replaces": None,
        "path": "SEMamba's Mamba mixers (16 a call of 8 x 16 s)",
        "launches": counts["scan"],
        "call_ms": call_ms,
        **{k: main_scan[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by")},
        "cases": scans,
    }, {
        "name": "causal_conv1d_silu",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/selective_scan.cu",
        "replaces": None,
        "path": "SEMamba's Mamba mixers, before the scan (16 a call)",
        "launches": counts["conv"],
        **{k: main_conv[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                     "bound_by")},
        "cases": convs,
    }, {
        "name": "fused_rmsnorm",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/fused_rmsnorm.cu",
        "replaces": None,
        "path": "SEMamba's pre-norm Blocks (16 a call)",
        "launches": counts["rmsnorm"],
        **{k: norm[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        "cases": [norm],
    }]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "cmgan_torch")):
        print("chip_smoke: the cmgan_torch package is not beside this script", file=sys.stderr)
        return 1
    if sys.argv[1:2] in (["--backward-times"], ["--forward-times"]):
        phase = sys.argv[1].removeprefix("--").removesuffix("-times")
        return times(sys.argv[2] if len(sys.argv) > 2 else ROOT, phase)
    sys.path.insert(0, ROOT)
    if sys.argv[1:] == ["--semamba"]:
        smi = nvidia_smi()
        log(f"[1] card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        print(json.dumps({"kernels": semamba_on_card(smi)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                  "kind": torch.cuda.get_device_name(0),
                                                  "count": torch.cuda.device_count()}}))
        return 0

    import numpy as np

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.data import read_wav, write_wav
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.ops import fused_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    laps, last = {}, [time.perf_counter()]

    def lap(name: str):
        now = time.perf_counter()
        laps[name], last[0] = round(now - last[0], 2), now

    # -- 1. card, versions, build --
    smi = nvidia_smi()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[1] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    build_all()

    lap("1 build")

    # -- 2. kernel against its plain version --
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        for t in (641, 2561):
            cases.append(check_kernel_case(dtype_name, 404, t, t, t, 0, seed=t))
    for dtype_name in ("float32", "bfloat16"):
        cases.append(check_kernel_case(dtype_name, 404, 2561, 2561, 2400, 0, seed=1))
        cases.append(check_kernel_case(dtype_name, 404, 1280, 2560, 2560, 128, seed=2))
        # masked keys at an offset off the tiles, and past the queries' tiles
        cases.append(check_kernel_case(dtype_name, 404, 1280, 2560, 2400, 100, seed=3))
        cases.append(check_kernel_case(dtype_name, 404, 320, 641, 600, 128, seed=7, d=32))
        cases.append(check_kernel_case(dtype_name, 404, 320, 641, 600, 128, seed=7, d=64))
        # most tile pairs clipped
        cases.append(check_kernel_case(dtype_name, 404, 641, 641, 641, 0, seed=4, max_pos=64))
        # the G step's forward shape at cut_len 64000, batch 4
        cases.append(check_kernel_case(dtype_name, 1616, 641, 641, 641, 0, seed=5))
        cases.append(check_kernel_case(dtype_name, 101, 641, 641, 1, 0, seed=6))  # one valid key
        # the longest table the kernels take (2 * 1536 + 1 rows)
        cases.append(check_kernel_case(dtype_name, 32, 2561, 2561, 2561, 0, seed=8, max_pos=1536))
    cases += head_dim_cases()
    check_tiled_against_kernels()
    main_case = cases[1]  # fp32 at the 16 s segment, the main path's shape
    two_heads_of_dim_8()
    wide_cases = wide_head_dim_cases()
    check_wide_walk_against_kernels()
    wide_kernel_at_64(smi)
    wide_launches, wide_step_fwd, wide_step_bwd = wide_head_model()
    widest_launches = widest_head_model()

    lap("2 forward kernel")

    # -- 3. the main path, fp32 --
    cfg = CMGANConfig()
    track = synthetic_track(16 * SR, seed=0)
    enh32 = Enhancer(cfg, dtype=torch.float32, device="cuda", seed=0)
    fa.launches = 0
    y32 = enh32.enhance(track, mode="bucket")
    main_launches = fa.launches
    log(f"[3] 16 s bucket fp32: launches {main_launches}, out len {y32.shape[0]}, "
        f"rms {float(np.sqrt(np.mean(y32 ** 2))):.6f}")
    if main_launches != cfg.model.num_tscb_blocks:
        raise AssertionError(f"expected {cfg.model.num_tscb_blocks} kernel launches, "
                             f"got {main_launches}")
    if y32.shape != track.shape or not np.all(np.isfinite(y32)):
        raise AssertionError("fp32 output is not finite or not the input's length")
    state = enh32.model.state_dict()
    xla = Enhancer(CMGANConfig(model=ModelConfig(attention_impl="xla")), state, device="cuda")
    y_xla = xla.enhance(track, mode="bucket")
    del xla
    torch.cuda.empty_cache()
    err = rel_l2(y32, y_xla)
    log(f"[3] flash vs xla: rel L2 {err:.3e} (tol {FLASH_VS_XLA_REL}), "
        f"max abs {float(np.abs(y32 - y_xla).max()):.3e}")
    if not err <= FLASH_VS_XLA_REL:
        raise AssertionError("flash path disagrees with the dense path")
    rtf32 = realtime_factor(lambda: enh32.enhance(track, mode="bucket"), 16.0)
    log(f"[3] 16 s fp32 realtime factor {rtf32:.2f}x on {smi}")
    device_breakdown(lambda: enh32.enhance(track, mode="bucket"), 16e3 / rtf32)

    # -- 4. bf16 --
    enh16 = Enhancer(cfg, state, dtype=torch.bfloat16, device="cuda")
    fa.launches = 0
    y16 = enh16.enhance(track, mode="bucket")
    bf16_launches = fa.launches
    err16 = rel_l2(y16, y32)
    log(f"[4] 16 s bucket bf16: launches {bf16_launches}, rel L2 vs fp32 {err16:.3e} "
        f"(tol {BF16_VS_FP32_REL})")
    if bf16_launches != cfg.model.num_tscb_blocks or not np.all(np.isfinite(y16)):
        raise AssertionError("bf16 path did not take the kernel or is not finite")
    if not err16 <= BF16_VS_FP32_REL:
        raise AssertionError("bf16 output too far from fp32")
    rtf16 = realtime_factor(lambda: enh16.enhance(track, mode="bucket"), 16.0)
    log(f"[4] 16 s bf16 realtime factor {rtf16:.2f}x on {smi}")

    # -- 5. enhance_batch, 16 two-second tracks (dense attention) --
    tracks = [synthetic_track(2 * SR, seed=100 + i) for i in range(16)]
    for name, enh in (("fp32", enh32), ("bf16", enh16)):
        fa.launches = 0
        outs = enh.enhance_batch(tracks, batch_cap=16)
        if fa.launches != 0 or any(o.shape != t.shape or not np.all(np.isfinite(o))
                                   for o, t in zip(outs, tracks)):
            raise AssertionError(f"enhance_batch {name}: bad output or unexpected launches")
        rtf = realtime_factor(lambda: enh.enhance_batch(tracks, batch_cap=16), 32.0)
        log(f"[5] enhance_batch 16 x 2 s {name}: realtime factor {rtf:.2f}x on {smi}")

    # -- 6. the CLI --
    from cmgan_torch.cli import enhance as cli

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ckpt = os.path.join(tmp, "generator.pt")
        torch.save(state, ckpt)
        noisy = synthetic_track(5 * SR, seed=5)
        write_wav(os.path.join(tmp, "noisy.wav"), noisy, SR)
        cli.main(["--input", os.path.join(tmp, "noisy.wav"),
                  "--output", os.path.join(tmp, "enhanced.wav"), "--torch_ckpt", ckpt])
        out, sr = read_wav(os.path.join(tmp, "enhanced.wav"))
        # the same weights as the port's own generator file, through --model_path
        from cmgan_torch.checkpoint import save_variables

        save_variables(os.path.join(tmp, "generator_vars"), state)
        cli.main(["--input", os.path.join(tmp, "noisy.wav"),
                  "--output", os.path.join(tmp, "enhanced_vars.wav"),
                  "--model_path", os.path.join(tmp, "generator_vars")])
        out_vars, _ = read_wav(os.path.join(tmp, "enhanced_vars.wav"))
    vars_err = rel_l2(out_vars, out)
    log(f"[6] cli: wrote {out.shape[1]} samples at {sr} Hz from {noisy.shape[0]}; "
        f"--model_path on the same weights: bitwise equal {np.array_equal(out, out_vars)}, "
        f"rel L2 {vars_err:.3e} (tol {EVAL_TRACK_REL})")
    if out.shape != (1, noisy.shape[0]) or sr != SR:
        raise AssertionError("CLI output has the wrong length or rate")
    if out_vars.shape != out.shape or not vars_err <= EVAL_TRACK_REL:
        raise AssertionError("--model_path and --torch_ckpt on the same weights disagree")

    del enh32, enh16
    torch.cuda.empty_cache()

    lap("3-6 enhancement")

    # -- 7. the backward kernel against autograd through the plain version --
    bwd_cases, wide_bwd_cases, _ = backward_phase(sys.modules[__name__])
    bwd_main = bwd_cases[0]  # fp32 at the training shape

    lap("7 backward kernel")

    # -- 8. the LayerNorm kernel against its plain version and F.layer_norm --
    ln_cases = [check_layernorm_case(dt, n, seed=11)
                for dt in ("float32", "bfloat16") for n in (1616 * 321, 5136 * 101)]
    ln_main = ln_cases[0]
    ln_cases += layernorm_width_cases()
    # its public entry, driven here on an activation-shaped tensor, forward
    # and backward; the models' path is [8b]
    fused_norm.launches = 0
    x = torch.randn(TRAIN_BATCH * 101, 641, 64, device="cuda", requires_grad=True)
    fused_norm.fused_layernorm(x, torch.ones(64, device="cuda"),
                               torch.zeros(64, device="cuda")).square().mean().backward()
    ln_launches = fused_norm.launches
    if ln_launches != 1 or not bool(torch.isfinite(x.grad).all()):
        raise AssertionError("fused_layernorm's public entry did not launch its kernel")
    del x
    ln_models = layernorm_dispatch_on_card(smi)

    lap("8 layernorm kernel")

    # -- 9 .. 12. training --
    g_step_flash_vs_dense()
    lap("9 G step")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        train_fwd, train_bwd = train_through_cli(tmp)
    lap("10-11 train CLI")
    g_ms = training_rates(smi)
    lap("12 training rates")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        eval_launches = evaluate_cli(tmp, smi)
    lap("13 evaluate CLI")
    pesq_times = device_pesq(smi)
    lap("14 device PESQ")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        fused_fwd, fused_bwd = fused_step_on_card(tmp, smi)
    lap("15 fused step")
    streaming_launches, stream_cases = streaming_on_card(smi)
    lap("16 streaming")
    serving_on_card(smi)
    lap("17 serving")
    long_launches, long_cases = long_form_on_card(smi)
    lap("18 48 kHz preset")
    (mesh_launches, local_launches, seq_launches, seq_train, seq_fwd_cases,
     seq_bwd_cases) = parallel_on_card(smi, g_ms)
    lap("19 parallel")
    trained_launches, trained_step, trained_stream, trained_gstep = trained_weights_on_card(smi)
    lap("20 trained weights")
    library_fwd, library_bwd = bench_on_card(smi)
    lap("21 bench")
    semamba_kernels = semamba_on_card(smi)
    lap("22 SEMamba kernels")
    log(f"seconds by phase: {json.dumps(laps)}, in all {sum(laps.values()):.1f} "
        f"(imports and the card's start not counted); the whole run "
        f"{time.perf_counter() - STARTED:.1f} s")

    kernels = {"kernels": [{
        "name": "flash_rel_attention",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/flash_rel_attention.cu",
        "replaces": "cmgan_tpu/ops/flash_attention.py:91",
        "launches": main_launches,
        "launches_train_epoch": train_fwd,
        "launches_evaluate": eval_launches,
        "launches_fused_step": fused_fwd,
        "launches_streaming": streaming_launches,
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": library_fwd[0]["library_ms"],
        "library_route": library_fwd,
        "launches_48k": long_launches,
        "launches_mesh_step": mesh_launches[0],
        "launches_local_loader_epoch": {m: n[0] for m, n in local_launches.items()},
        "launches_seq_48k": seq_launches,
        "launches_seq_train_step": seq_train[0],
        "launches_trained_4s": trained_launches,
        "launches_trained_step": trained_step[0],
        "launches_trained_stream": trained_stream,
        "launches_trained_gstep": trained_gstep[0],
        "cases": cases,
        "cases_streaming": stream_cases,
        "cases_48k": long_cases,
        "cases_seq_ranks": seq_fwd_cases,
    }, {
        "name": "flash_rel_attention_bwd",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/flash_rel_attention_bwd.cu",
        "replaces": "cmgan_tpu/ops/flash_attention.py:250",
        "launches": train_bwd,
        "launches_fused_step": fused_bwd,
        "launches_mesh_step": mesh_launches[1],
        "launches_local_loader_epoch": {m: n[1] for m, n in local_launches.items()},
        "launches_seq_train_step": seq_train[1],
        "launches_trained_step": trained_step[1],
        "launches_trained_gstep": trained_gstep[1],
        "cases_seq_ranks": seq_bwd_cases,
        "max_abs_err": bwd_main["max_abs_err"],
        "ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": library_bwd[0]["library_ms"],
        "library_route": library_bwd,
        "cases": bwd_cases,
    }, {
        "name": "flash_rel_attention_wide",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/flash_rel_attention_wide.cu",
        "replaces": "cmgan_tpu/ops/flash_attention.py:91",
        "path": f"head dims over 64; the model {WIDE_MODEL} on a 6 s track",
        "launches": wide_launches,
        "launches_widest_model": widest_launches,
        "launches_g_step": wide_step_fwd,
        **wide_summary(wide_cases, library_fwd),
        "cases": wide_cases,
    }, {
        "name": "flash_rel_attention_wide_bwd",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/flash_rel_attention_wide_bwd.cu",
        "replaces": "cmgan_tpu/ops/flash_attention.py:250",
        "path": f"head dims over 64; one G step of the model {WIDE_MODEL}",
        "launches": wide_step_bwd,
        **wide_summary(wide_bwd_cases, library_bwd),
        "cases": wide_bwd_cases,
    }, {
        "name": "fused_layernorm",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/fused_layernorm.cu",
        "replaces": "cmgan_tpu/ops/fused_norm.py:36",
        "launches": ln_launches,
        "path": "models.layers.LayerNorm on CUDA without autograd (40 a generator forward), "
                "and ops.fused_layernorm, the op's public entry",
        "models": ln_models,
        "max_abs_err": ln_main["max_abs_err"],
        "ms": ln_main["ms"],
        "plain_ms": ln_main["plain_ms"],
        "bound_ms": ln_main["bound_ms"],
        "bound_by": ln_main["bound_by"],
        "library_ms": ln_main["library_ms"],
        "cases": ln_cases,
    }, *semamba_kernels]}
    log(f"device PESQ against the host scorer: {json.dumps(pesq_times)}")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
