"""Where kernel #2's dq/dE kernel spends its time, by ablation, on one NVIDIA GPU.

A profiler sees each kernel whole; this tool builds copies of the backward
library of the head dim asked for (`ops/csrc/flash_rel_attention_bwd.cu`
up to 64, `ops/csrc/flash_rel_attention_wide_bwd.cu` past it) with one phase
of the dq/dE kernel's mixed tile pairs left out (the source's
`CMGAN_BWD_ABLATE` bits, given as `-D`) and times every kernel of a backward
launch (torch.profiler's device time) beside the whole library on the same
inputs, in one process on one card, fp32 and bf16: at the G step's shape (G
1616, T 641, D 16) by default, at G 404, T 641 for a wide head:

    dr_writes     dR not written into shared memory
    dr_products   no dq += dR . E_w and no dE_w = dR^T . Q
    flush         no read-modify-write of the rows of partial sums
    position      every tile pair taken as clipped (no R, no skew, no dR;
                  in the wide library in its dk/dv kernel too)

The time a copy saves is what that phase costs on the critical path, what
the other warpgroups do not hide. The copies compute wrong results; they
are timed and nothing else. Prints one JSON line.

    python3 -m cmgan_torch.tools.backward_ablation [--head-dim D]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cmgan_torch.ops import _build
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.tools import nvidia_smi, require_cuda

# what is left out -> the kernel's CMGAN_BWD_ABLATE bits (0: the whole kernel)
ABLATIONS = {"dr_writes": 1, "dr_products": 2, "flush": 4, "position": 8}
SHAPE = (1616, 641, 16)   # the G step's at cut_len 64000, batch 4
WIDE_SHAPE = (404, 641)   # a wide head's: [2]'s 1-head model of 128 channels, 4 s bucket
REPS = 5


def build(root: str, d: int) -> dict:
    """{name: the backward library of head dim d built with its ablation
    bits}, the nvcc runs started together."""
    name = fa.WIDE_BWD_KERNEL if fa.wide_head_dim(d) else fa.BWD_KERNEL
    source = os.path.join(_build.CSRC, f"{name}.cu")
    bits = {"kernel": 0, **ABLATIONS}
    runs = {name: (os.path.join(root, f"{name}.so"),
                   subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS,
                                     f"-DCMGAN_BWD_ABLATE={b}", "-o",
                                     os.path.join(root, f"{name}.so"), source],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            for name, b in bits.items()}
    libs = {}
    for name, (path, run) in runs.items():
        log = run.communicate()[0].decode(errors="replace")
        if run.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(path)
        lib.cmgan_flash_rel_attention_bwd.argtypes = fa._BWD_ARGS
        lib.cmgan_flash_rel_attention_bwd.restype = ctypes.c_int
        rows = lib.cmgan_flash_rel_attention_bwd_partial_rows
        rows.argtypes, rows.restype = [ctypes.c_int] * 5, ctypes.c_int
        lib.cmgan_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cmgan_cuda_error_string.restype = ctypes.c_char_p
        if fa.wide_head_dim(d):
            rows = lib.cmgan_flash_rel_attention_wide_bwd_rows
            rows.argtypes, rows.restype = [ctypes.c_int] * 6, ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, q, k, v, table, out, lse, cot, max_pos: int):
    """One backward launch (its four kernels) of the library `lib`."""
    g, t, d = q.shape
    bf16 = int(q.dtype == torch.bfloat16)
    rows = fa.backward_scratch_rows(lib, bf16, g, t, t, d, max_pos)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(g, t, dtype=torch.float32, device=q.device)
    dtable = torch.empty(table.shape, dtype=torch.float32, device=q.device)
    partials = torch.empty(rows, table.numel(), dtype=torch.float32, device=q.device)
    rc = lib.cmgan_flash_rel_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
        cot.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), dtable.data_ptr(), partials.data_ptr(), g, t, t, d, max_pos, t, 0,
        bf16, rows, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def kernel_ms(fn, reps: int = REPS) -> dict:
    """{kernel: device ms a call} over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[e.key.index("flash_rel"):].split("<")[0].split("(")[0]:
            e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "flash_rel" in e.key}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head-dim", type=int, default=SHAPE[2],
                        help="16, 32 or 64 (the tensor-core library) or any width over 64")
    args = parser.parse_args(argv)
    require_cuda("backward_ablation")
    max_pos = 512
    d = fa.kernel_head_dim(args.head_dim)
    g, t = WIDE_SHAPE if fa.wide_head_dim(d) else SHAPE[:2]
    dq_kernel = "flash_rel_wide_bwd_q" if fa.wide_head_dim(d) else "flash_rel_bwd_q"
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT if os.path.isdir(_build.BUILD_ROOT)
                                     else None) as root:
        libs = build(root, d)
        cases = []
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(g, t, d, generator=gen, device="cuda") * d ** -0.5).to(dtype)
            k, v, cot = (torch.randn(g, t, d, generator=gen, device="cuda").to(dtype)
                         for _ in range(3))
            table = torch.randn(2 * max_pos + 1, d, generator=gen, device="cuda").to(dtype)
            out, lse = fa._launch_forward(q, k, v, table, max_pos, t, 0, True)
            ms = {name: kernel_ms(lambda lib=lib: launch(lib, q, k, v, table, out, lse, cot,
                                                         max_pos))
                  for name, lib in libs.items()}
            dq_ms = {name: m[dq_kernel] for name, m in ms.items()}
            cases.append({"G": g, "T": t, "D": d, "dtype": str(dtype).split(".")[1],
                          "kernels_ms": ms["kernel"], "dq_kernel_ms": dq_ms,
                          "saved_ms": {name: dq_ms["kernel"] - dq_ms[name] for name in ABLATIONS}})
            del q, k, v, cot, table, out, lse
    print(json.dumps({"card": nvidia_smi(), "max_pos": max_pos, "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
