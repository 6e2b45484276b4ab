#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Offline enhancement at CMGAN's full published width (64 channels, 4
TSCBs, 4 heads of dim 16, 201 bins) with seeded random weights, through
the hand-written CUDA flash-attention kernel. Phases, each printing a
line, none catching its own failure:

  1. the card (nvidia-smi name and power limit), torch and CUDA versions,
     and the kernel build;
  2. the kernel against its plain PyTorch version on the card, fp32 and
     bf16, at the 4 s bucket (T = 641) and the 16 s segment (T = 2561),
     with a t_valid < T case and a q_offset = 128 case;
  3. a 16 s track through Enhancer.enhance(mode='bucket') in fp32: exactly
     4 kernel launches, finite output of the input's length, agreement
     with attention_impl='xla', and the realtime factor;
  4. the same track in bf16 against fp32, and its realtime factor;
  5. enhance_batch on 16 two-second tracks (dense attention, no launches);
  6. the enhance CLI on a written 5 s wav.

Then a JSON line with each kernel's numbers, the card's line, and, last,
{"ok": true, "device": {...}}. Exits non-zero without CUDA, or without
the `cmgan_torch` package beside this file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 16000

# H100 SXM published peaks (700 W): fp32 outside the tensor cores, bf16
# dense tensor-core rate, HBM bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# stated tolerances
KERNEL_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-3, 8e-3)}  # (atol, rtol)
FLASH_VS_XLA_REL = 1e-4   # fp32: attention sums in another order (~1e-6), 100x margin
BF16_VS_FP32_REL = 5e-2   # bf16 keeps 8 significant bits; 1.6e-2 measured on a CPU run
PLAIN_GROUP_CHUNK = 32    # groups per plain-version call, so its [g, T, T] logits fit


def log(msg: str):
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def synthetic_track(n: int, seed: int):
    """A seeded sum of amplitude-modulated harmonics plus noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
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


def check_kernel_case(dtype_name, g, tq, tk, t_valid, q_offset, seed):
    import torch

    from cmgan_torch.ops import flash_attention as fa

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, max_pos = fa.HEAD_DIM, 512

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)

    # q pre-scaled by dim_head**-0.5 as the conformer passes it
    q = randn(g, tq, d, scale=0.25)
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

    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    atol, rtol = KERNEL_TOL[dtype_name]
    close = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
    finite = bool(torch.isfinite(out.float()).all())

    ms = cuda_ms(kernel, reps=10)
    plain_ms = cuda_ms(plain, reps=2)
    es = torch.finfo(dtype).bits // 8
    flops = 3 * 2 * g * tq * t_valid * d  # content, position and P.V terms
    nbytes = es * d * (2 * g * tq + 2 * g * tk + table.shape[0])
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    case = {
        "dtype": dtype_name, "G": g, "Tq": tq, "Tk": tk, "t_valid": t_valid,
        "q_offset": q_offset, "max_abs_err": err, "tol": [atol, rtol],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flop": flops, "bytes": nbytes,
    }
    log(f"[2] kernel {json.dumps(case)}")
    if not (close and finite):
        raise AssertionError(f"kernel disagrees with the plain version: {case}")
    return case


def realtime_factor(fn, audio_seconds: float, reps: int = 3) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return audio_seconds * reps / (time.perf_counter() - t0)


def device_breakdown(fn, wall_ms: float, top: int = 8):
    """Profile one call: the device kernels' summed time against the
    call's unprofiled wall time, and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[3] profile: device kernels {busy_ms:.2f} ms in a {wall_ms:.2f} ms call "
        f"({100 * busy_ms / wall_ms:.1f}% busy)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]:
        ms = e.self_device_time_total / 1e3
        log(f"[3]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{e.count} {e.key[:90]}")


def rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "cmgan_torch")):
        print("chip_smoke: the cmgan_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    import numpy as np

    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.data import read_wav, write_wav
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import _build
    from cmgan_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # -- 1. card, versions, build --
    smi = nvidia_smi()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[1] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    build = _build.build(fa.KERNEL)
    log(f"[1] built {os.path.relpath(build.path, ROOT)} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1]   {line.strip()}")

    # -- 2. kernel against its plain version --
    cases = []
    for dtype_name in ("float32", "bfloat16"):
        for t in (641, 2561):
            cases.append(check_kernel_case(dtype_name, 404, t, t, t, 0, seed=t))
    cases.append(check_kernel_case("float32", 404, 2561, 2561, 2400, 0, seed=1))
    cases.append(check_kernel_case("float32", 404, 1280, 2560, 2560, 128, seed=2))
    main_case = cases[1]  # fp32 at the 16 s segment, the main path's shape

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
    log(f"[6] cli: wrote {out.shape[1]} samples at {sr} Hz from {noisy.shape[0]}")
    if out.shape != (1, noisy.shape[0]) or sr != SR:
        raise AssertionError("CLI output has the wrong length or rate")

    kernels = {"kernels": [{
        "name": "flash_rel_attention",
        "route": "cuda",
        "source": "cmgan_torch/ops/csrc/flash_rel_attention.cu",
        "replaces": "cmgan_tpu/ops/flash_attention.py:91",
        "launches": main_launches,
        "max_abs_err": main_case["max_abs_err"],
        "max_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,
        "cases": cases,
    }]}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
