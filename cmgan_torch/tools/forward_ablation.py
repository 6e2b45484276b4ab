"""Where kernel #1's forward spends its time, by ablation, on one NVIDIA GPU.

A profiler sees one kernel; this tool builds copies of the forward library
of the head dim asked for (`ops/csrc/flash_rel_attention.cu` up to 64,
`ops/csrc/flash_rel_attention_wide.cu` past it) with one phase of the
consumers' tile left out (the source's `CMGAN_FWD_ABLATE` bits, given as
`-D`) and times each beside the whole kernel on the same inputs, in one
process on one card, fp32 and bf16: at the 16 s segment's shape and the G
step's (D 16) by default, at G 404, T 641 for a wide head:

    values     no P . V (the output stays zero; the wide kernel stages no V)
    position   no R product and no skew (every tile pair taken as clipped)
    exp        the softmax's exponentials left out (its FMA kept)

The time a copy saves is what that phase costs on the critical path, what
the other warpgroups do not hide. The copies compute wrong results; they
are timed and nothing else. Prints one JSON line.

    python3 -m cmgan_torch.tools.forward_ablation [--head-dim D]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from cmgan_torch.ops import _build
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.tools import nvidia_smi, require_cuda

# what is left out -> the kernel's CMGAN_FWD_ABLATE bits (0: the whole kernel)
ABLATIONS = {"values": 1, "position": 2, "exp": 4}
SHAPES = [(404, 2561, 16), (1616, 641, 16)]   # the 16 s segment, the G step's shape
WIDE_SHAPE = (404, 641)   # a wide head's: [2]'s 1-head model of 128 channels, 4 s bucket
REPS = 10


def build(root: str, d: int) -> dict:
    """{name: the forward library of head dim d built with its ablation
    bits}, the nvcc runs started together."""
    wide = fa.wide_head_dim(d)
    source = os.path.join(_build.CSRC, f"{fa.WIDE_KERNEL if wide else fa.KERNEL}.cu")
    bits = {"kernel": 0, **ABLATIONS}
    runs = {name: (os.path.join(root, f"{name}.so"),
                   subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS,
                                     f"-DCMGAN_FWD_ABLATE={b}", "-o",
                                     os.path.join(root, f"{name}.so"), source],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
            for name, b in bits.items()}
    libs = {}
    for name, (path, run) in runs.items():
        log = run.communicate()[0].decode(errors="replace")
        if run.returncode:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
        lib = ctypes.CDLL(path)
        if wide:
            fa.bind_wide_forward(lib)
        else:
            lib.cmgan_flash_rel_attention_fwd.argtypes = fa._FWD_ARGS
            lib.cmgan_flash_rel_attention_fwd.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, q, k, v, table, out, max_pos: int):
    g, t, d = q.shape
    if fa.wide_head_dim(d):
        rc = fa.wide_forward(lib, q, k, v, table, out, None, max_pos, t, 0)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return
    rc = lib.cmgan_flash_rel_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(), None,
        g, t, t, d, max_pos, t, 0, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def device_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--head-dim", type=int, default=SHAPES[0][2],
                        help="16, 32 or 64 (the tensor-core library) or any width over 64")
    args = parser.parse_args(argv)
    require_cuda("forward_ablation")
    max_pos = 512
    d = fa.kernel_head_dim(args.head_dim)
    shapes = [(*WIDE_SHAPE, d)] if fa.wide_head_dim(d) else [(g, t, d) for g, t, _ in SHAPES]
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT if os.path.isdir(_build.BUILD_ROOT)
                                     else None) as root:
        libs = build(root, d)
        cases = []
        gen = torch.Generator(device="cuda").manual_seed(0)
        for g, t, d in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                q = (torch.randn(g, t, d, generator=gen, device="cuda") * d ** -0.5).to(dtype)
                k, v = (torch.randn(g, t, d, generator=gen, device="cuda").to(dtype)
                        for _ in range(2))
                table = torch.randn(2 * max_pos + 1, d, generator=gen, device="cuda").to(dtype)
                out = torch.empty_like(q)
                ms = {name: device_ms(lambda lib=lib: launch(lib, q, k, v, table, out, max_pos))
                      for name, lib in libs.items()}
                cases.append({"G": g, "T": t, "D": d, "dtype": str(dtype).split(".")[1],
                              "ms": ms, "saved_ms": {name: ms["kernel"] - ms[name]
                                                     for name in ABLATIONS}})
                del q, k, v, table, out
    print(json.dumps({"card": nvidia_smi(), "max_pos": max_pos, "cases": cases}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
