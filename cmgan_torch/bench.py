"""The port's bench on one NVIDIA GPU: the counterpart of the root
`bench.py` (the JAX package's) and of its measuring tools, which live in
`cmgan_torch/tools/` (`serving_bench`, `serve_e2e_bench`,
`profile_dsp_share`).

    python3 -m cmgan_torch.bench [--cell NAME ...] [--seed N] [--reps N]
                                 [--trace DIR] [--model_path PATH]

Every cell runs CMGAN at its full published width (64 channels, 4 TSCBs,
4 heads of dim 16, 201 bins; the 48 kHz preset's 6 TSCBs and 601 bins)
through the functions users call, with weights drawn from --seed or
read from --model_path (a 16 kHz generator: the 48 kHz cell always
draws its own). The cells (`CELLS`):

- `enhance_*`: `inference.enhance_tensor`, the device part of every
  `Enhancer` call, on seeded segments. Wall realtime factor: calls
  chained, output feeding input, one sync at the end of a repeat (as the
  root bench.py). Device realtime factor: one CUDA graph of K chained
  windows, captured after a warm call (kernels built, cuFFT plans made)
  and replayed; its output is held against K eager calls, and the
  difference of the two per-window times is the dispatch overhead.
- `train_*`: `Trainer.train_step` in each label mode, after a warm step.
- `stream_ticks`: `StreamBatcher.step` at several slot counts.
- `serve_e2e_8`: loopback clients through `cli.serve.make_server`.

The work of an enhancement call is counted once from shapes on the
meta device (`call_work`), never from a timed run: FLOPs by PyTorch's
own formulas (`torch.utils.flop_counter`, what FlopCounterMode counts:
convolutions and matrix products); bytes as every op eager PyTorch
issues reads its tensor inputs once and writes its outputs once (views
and allocations move none). The attention function, which the CUDA
kernels hide from both counts, is counted by the algorithm's formula
(`ops.flash_attention.attention_work`) in place of whatever ran it, so
a call counts the same under 'xla' and 'auto'. Shares of the H100's
peaks (989 TFLOP/s bf16, 3.35 TB/s) follow from those counts.

Each cell checks what it ran and fails the run when a check misses:
kernel launches equal to those its shapes imply, finite outputs and
losses, fp32 kernel cells against attention_impl='xla' (relative L2
1e-4; a training cell's G step also its gradients, 1e-3 as one vector
and the worst parameter), bf16 against fp32 (5e-2), the graph
against eager calls (1e-6). Training repeats run on one trainer and
host_async's deferred D update is drained once, after the last.

Output: one JSON line a cell (the card's name and power limit, every
metric with its unit, median, quartiles and sample count, the launches
and the checks), then one summary line with the root bench.py's keys
(`h100` where it has `v5e`). Without CUDA it raises: no time is ever
taken on the CPU. TF32 is pinned off, as in the CLIs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from cmgan_torch.config import CMGANConfig, ModelConfig, TrainConfig, long_form_48k
from cmgan_torch.dsp import hamming_window
from cmgan_torch.inference import enhance_tensor, load_generator
from cmgan_torch.models import TSCNet
from cmgan_torch.models.conformer import FLASH_MIN_FRAMES, RelPosAttention
from cmgan_torch.models.layers import Linear
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.tools import load_weights, nvidia_smi, require_cuda, stats
from cmgan_torch.tools.serve_e2e_bench import serve_clients
from cmgan_torch.tools.serving_bench import batcher_ticks

BASELINE_RTF = 50.0        # the root bench.py's north star: 50x realtime per chip
# published peaks of one H100 SXM at 700 W (chip_smoke.py's): the bf16
# dense tensor-core rate and the HBM3 bandwidth
H100_PEAK_FLOPS = 989e12
H100_PEAK_BYTES = 3.35e12
GRAPH_REPLAYS = 3          # replays of the K-window graph (the root bench.py's chain dispatches)
TRAIN_STEPS = 2            # train_step calls a timed repeat
# the train loader's length: the LR schedule's steps an epoch (the root
# bench.py's sized stub says 1000)
TRAIN_EPOCH_STEPS = 1000
TICKS_A_REP, TICK_WARMUP = 4, 3   # stream ticks timed a repeat; untimed first ticks
CHUNK, LOOKAHEAD = 8000, 4000     # the streaming engine's defaults (0.5 s, 0.25 s)
# checks, at chip_smoke.py's limits
FLASH_VS_XLA_REL = 1e-4    # fp32: the kernel sums in another order (~1e-6)
BF16_VS_FP32_REL = 5e-2
GRAPH_VS_EAGER_REL = 1e-6  # the same kernels in the same order: 0 expected
# the G step's gradients through the kernels against 'xla': all as one
# vector at chip_smoke.py [9]'s limit, and the worst parameter's at 5x the
# most that sound runs on an H100 read (1.5e-4 in train_b4_64000_fp32,
# 2.0e-4 in [9]), tight enough that a 1% error in dk fails it
GSTEP_REL = 1e-3
GSTEP_PARAM_REL = 1e-3
# the dense path's [G, T, T] logits of a 30 s 48 kHz window are 111 GB in
# fp32, more than the card holds: that cell holds 'auto' against 'xla' on
# a window of this many seconds (as chip_smoke.py [18] does)
XLA_SECONDS_48K = 10


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


class Checks:
    """A cell's checks: each a value, its limit and whether it held."""

    def __init__(self):
        self.items = {}

    def at_most(self, name: str, value: float, limit: float):
        self.items[name] = {"value": value, "limit": limit, "ok": bool(value <= limit)}

    def equal(self, name: str, value, expected):
        self.items[name] = {"value": value, "expected": expected, "ok": value == expected}

    def holds(self, name: str, ok: bool):
        self.items[name] = {"ok": bool(ok)}


# -- the work of a call, from shapes -----------------------------------------

_NO_TRAFFIC = {
    torch.ops.aten._unsafe_view.default,   # a view of a fresh tensor
    torch.ops.aten.empty.memory_format,    # allocations, written by the next op
    torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default,
    torch.ops.aten.new_empty.default,
}
_METADATA = {
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
    torch.ops.prim.device.default,
}


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _WorkCounter(TorchDispatchMode):
    """FLOPs (torch.utils.flop_counter's formulas) and bytes (inputs read
    once, outputs written once) of every op eager PyTorch issues, composite
    ops decomposed into the ops that run, as FlopCounterMode decomposes
    them. Ops inside a RelPosAttention but outside its linear layers (the
    attention function, whichever implementation runs it) are left out and
    counted once a call by `attention_work` instead."""

    def __init__(self):
        super().__init__()
        self.flop = self.bytes = self.attention_flop = self.attention_bytes = 0
        self._skip = 0

    def watch(self, model: torch.nn.Module) -> list:
        """Hooks that mark the attention function's ops; remove them after."""
        hooks = []
        for m in model.modules():
            if isinstance(m, RelPosAttention):
                hooks += [m.register_forward_pre_hook(self._attention_in),
                          m.register_forward_hook(self._attention_out)]
                for lin in m.children():
                    if isinstance(lin, Linear):
                        hooks += [lin.register_forward_pre_hook(self._linear_in),
                                  lin.register_forward_hook(self._linear_out)]
        return hooks

    def _attention_in(self, module, args):
        b, n, _ = args[0].shape
        elem = torch.finfo(module.compute_dtype or torch.float32).bits // 8
        work = fa.attention_work(b * module.heads, n, n, n, 0, module.max_pos_emb,
                                 module.dim_head, elem)
        self.attention_flop += work["flop"]
        self.attention_bytes += work["bytes"]
        self._skip += 1

    def _attention_out(self, module, args, out):
        self._skip -= 1

    def _linear_in(self, module, args):
        self._skip -= 1

    def _linear_out(self, module, args, out):
        self._skip += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._skip:
            return out
        if func._overloadpacket in flop_registry:
            self.flop += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        views = any(r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns)
        if not views and func not in _NO_TRAFFIC:
            # copy_ reads only its source; every other op reads all its inputs
            reads = args[1:] if func is torch.ops.aten.copy_.default else (args, kwargs)
            self.bytes += _tensor_bytes(reads) + _tensor_bytes(out)
        return out


def call_work(cfg: CMGANConfig, dtype, batch: int, samples: int) -> dict:
    """The work of one `enhance_tensor` call on [batch, samples] with the
    generator of `cfg.model` computing in `dtype`, counted from shapes on
    the meta device: {'flop', 'bytes', 'attention_flop', 'attention_bytes'}
    (the attention parts, by `attention_work`, are within the totals)."""
    meta = torch.device("meta")
    with meta:
        model = TSCNet(cfg.model, dtype=dtype).eval()
    x = torch.empty(batch, samples, device=meta)
    hamming_window(cfg.dsp.n_fft, torch.float32, meta)  # the cached window, made outside the count
    counter = _WorkCounter()
    hooks = counter.watch(model)
    try:
        with torch.inference_mode(), counter:
            enhance_tensor(model, cfg.dsp, x)
    finally:
        for h in hooks:
            h.remove()
    return {"flop": counter.flop + counter.attention_flop,
            "bytes": counter.bytes + counter.attention_bytes,
            "attention_flop": counter.attention_flop, "attention_bytes": counter.attention_bytes}


def kernel_launches(cfg: CMGANConfig, samples: int) -> int:
    """Kernel #1 launches of one generator forward on segments of `samples`:
    one a conformer whose sequence takes the kernel, in each TSCB. The time
    conformer runs over the segment's frames, the frequency conformer over
    the encoder's (F + 1) // 2 bins; 'auto' takes the kernel from
    FLASH_MIN_FRAMES tokens, 'flash' always."""
    impl = cfg.model.attention_impl

    def takes(tokens: int) -> int:
        return int(impl == "flash" or (impl == "auto" and tokens >= FLASH_MIN_FRAMES))

    frames = cfg.dsp.num_frames(samples)
    bins = (cfg.model.num_features + 1) // 2
    return cfg.model.num_tscb_blocks * (takes(frames) + takes(bins))


def chained(call, x: torch.Tensor, k: int) -> torch.Tensor:
    """k calls, each output the next input."""
    for _ in range(k):
        x = call(x)
    return x


def capture_chain(call, x: torch.Tensor, k: int):
    """One CUDA graph of `chained(call, x, k)`, x its static input; returns
    (graph, static output). Warm `call` before: the kernels are built and
    cuFFT's plans made at first use, neither of which a capture may do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # allocations of the warm-up stay off the graph's pool
        call(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chained(call, x, k)
    return graph, out


def timed_traced(fn, logdir: str, untraced_s: float, top: int = 8) -> dict:
    """One window of fn() under `utils.trace`: its wall time, the device
    kernels' summed time (busy share), the kernels that take the most, and
    the trace's cost against the untraced time of the same window."""
    from torch.autograd import DeviceType

    from cmgan_torch.utils import trace

    with trace(logdir) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    tops = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top]
    return {
        "window_ms": 1e3 * wall, "device_busy_ms": 1e3 * busy, "busy_share": busy / wall,
        "tracing_overhead": wall / untraced_s - 1.0,
        "top": [{"name": e.key[:120], "ms": e.self_device_time_total / 1e3, "count": e.count,
                 "share_of_busy": e.self_device_time_total / 1e6 / busy} for e in tops],
    }


def g_step_record(trainer, clean, noisy) -> tuple:
    """One G step from a fresh trainer's state: (enhanced audio, loss, the
    gradient it applied, in float64). The gradient is read from AdamW's
    first moment, 0.1 x the gradient after the first step; the update
    itself, about lr x sign(gradient) at that step, would hide a wrong one."""
    metrics, handoff = trainer.g_step(trainer.state, clean, noisy)
    opt = trainer.state.gen_opt
    return (handoff["est_audio"].clone(), float(metrics["gen_loss"]),
            [opt.state[p]["exp_avg"].double() for p in trainer.state.gen.parameters()])


def gradient_rel(grads, ref) -> tuple:
    """(relative L2 of all gradients as one vector, the worst parameter's).
    A bias in front of an InstanceNorm has gradient 0 by construction and
    both sides hold rounding noise: a parameter's difference is measured
    against the larger of its reference's norm and 1e-2 of the largest."""
    top = max(float(torch.linalg.vector_norm(g)) for g in ref)
    whole = rel_l2(torch.cat([g.reshape(-1) for g in grads]),
                   torch.cat([g.reshape(-1) for g in ref]))
    worst = max(float(torch.linalg.vector_norm(a - b)) / max(float(torch.linalg.vector_norm(b)),
                                                               1e-2 * top)
                for a, b in zip(grads, ref))
    return whole, worst


def free_card():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# -- cells ---------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What every cell shares: the card, the seed, repeats, the trace
    directory, the 16 kHz generator's weights (None: drawn from the seed),
    and the root bench.py's keys gathered for the summary line."""
    smi: str
    seed: int = 0
    reps: int = 5
    trace_dir: str | None = None
    weights: dict | None = None
    summary: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Enhance:
    preset: str        # 'default' (16 kHz) or 'long_form_48k'
    dtype: torch.dtype
    batch: int
    seconds: int
    calls: int         # chained calls a timed repeat
    chain_k: int       # windows in the CUDA graph
    why: str
    headline: bool = False   # gives the summary line's enhancement keys

    def config(self, attention_impl: str = "auto") -> CMGANConfig:
        cfg = long_form_48k() if self.preset == "long_form_48k" else CMGANConfig()
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, attention_impl=attention_impl))

    def samples(self) -> int:
        return self.config().dsp.sample_rate * self.seconds

    def expected_launches(self) -> dict:
        return {"kernel_1_a_call": kernel_launches(self.config(), self.samples())}

    def run(self, name: str, ctx: Run) -> dict:
        cfg = self.config()
        samples, audio = self.samples(), self.batch * self.seconds
        weights = None if self.preset == "long_form_48k" else ctx.weights
        model = load_generator(cfg, weights, self.dtype, "cuda", seed=ctx.seed)
        rng = np.random.default_rng(ctx.seed)
        x = torch.from_numpy((0.1 * rng.standard_normal((self.batch, samples))).astype(np.float32))
        x = x.cuda()
        checks = Checks()

        def call(inp):
            return enhance_tensor(model, cfg.dsp, inp)

        with torch.inference_mode():
            fa.launches = 0
            out = call(x)
            torch.cuda.synchronize()
            launches = {"kernel_1_a_call": fa.launches}
            checks.equal("launches", launches, self.expected_launches())
            checks.holds("finite_output_of_input_shape",
                         out.shape == x.shape and bool(torch.isfinite(out).all()))
            self._reference_checks(cfg, model, x, out, checks)

            torch.cuda.reset_peak_memory_stats()
            call(x)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()

            wall = []
            for _ in range(ctx.reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                chained(call, x, self.calls)
                torch.cuda.synchronize()
                wall.append((time.perf_counter() - t0) / self.calls)

            graph, graph_out = capture_chain(call, x, self.chain_k)
            graph.replay()
            eager = chained(call, x, self.chain_k)
            torch.cuda.synchronize()
            checks.at_most("graph_vs_eager_rel_l2", rel_l2(graph_out, eager), GRAPH_VS_EAGER_REL)
            del eager
            device = []
            for _ in range(GRAPH_REPLAYS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                graph.replay()
                torch.cuda.synchronize()
                device.append((time.perf_counter() - t0) / self.chain_k)
            del graph, graph_out

            traced = None
            if ctx.trace_dir:
                traced = timed_traced(lambda: call(x), os.path.join(ctx.trace_dir, name),
                                      float(np.median(wall)))
        del model, x, out
        free_card()

        work = call_work(cfg, self.dtype, self.batch, samples)
        device_s = float(np.median(device))
        metrics = {
            "realtime_factor": stats([audio / s for s in wall], "audio s / wall s"),
            "ms_a_call": stats([1e3 * s for s in wall], "ms"),
            "device_realtime_factor": stats([audio / s for s in device],
                                            "audio s / s, replayed CUDA graph"),
            "device_ms_a_call": stats([1e3 * s for s in device], "ms, replayed CUDA graph"),
            "dispatch_overhead_ms": stats([1e3 * (s - device_s) for s in wall],
                                          "ms a call: wall less the graph's median"),
            "achieved_tflops_per_sec": stats([work["flop"] / s / 1e12 for s in wall], "TFLOP/s"),
            "mfu_vs_h100_bf16_peak": stats([work["flop"] / s / H100_PEAK_FLOPS for s in wall],
                                           "share of 989 TFLOP/s"),
            "device_tflops_per_sec": stats([work["flop"] / s / 1e12 for s in device], "TFLOP/s"),
            "device_mfu_vs_h100_bf16_peak": stats(
                [work["flop"] / s / H100_PEAK_FLOPS for s in device], "share of 989 TFLOP/s"),
            "hbm_bw_utilization_vs_h100_peak": stats(
                [work["bytes"] / s / H100_PEAK_BYTES for s in wall], "share of 3.35 TB/s"),
            "device_hbm_bw_utilization_vs_h100_peak": stats(
                [work["bytes"] / s / H100_PEAK_BYTES for s in device], "share of 3.35 TB/s"),
            "peak_memory_gib": stats([peak / 2**30], "GiB, torch.cuda.max_memory_allocated"),
        }
        if self.headline:
            med = {k: v["median"] for k, v in metrics.items()}
            rtf = med["realtime_factor"]
            ctx.summary.update({
                "metric": "enhancement_realtime_factor_per_chip",
                "value": rtf,
                "unit": f"audio_sec/sec (16 kHz, batch {self.batch}, "
                        f"{'bf16' if self.dtype == torch.bfloat16 else 'fp32'})",
                "vs_baseline": rtf / BASELINE_RTF,
                "device_realtime_factor": med["device_realtime_factor"],
                "chain_k": self.chain_k,
                "dispatch_overhead_ms": med["dispatch_overhead_ms"],
                "program_tflops_per_dispatch": work["flop"] / 1e12,
                "achieved_tflops_per_sec": med["achieved_tflops_per_sec"],
                "mfu_vs_h100_bf16_peak": med["mfu_vs_h100_bf16_peak"],
                "device_tflops_per_sec": med["device_tflops_per_sec"],
                "device_mfu_vs_h100_bf16_peak": med["device_mfu_vs_h100_bf16_peak"],
                "program_eager_op_gbytes_per_dispatch": work["bytes"] / 1e9,
                "hbm_bw_utilization_vs_h100_peak": med["hbm_bw_utilization_vs_h100_peak"],
                "device_hbm_bw_utilization_vs_h100_peak":
                    med["device_hbm_bw_utilization_vs_h100_peak"],
            })
        return {"setting": {"preset": self.preset, "dtype": str(self.dtype), "batch": self.batch,
                            "seconds": self.seconds, "frames": cfg.dsp.num_frames(samples),
                            "calls_a_repeat": self.calls, "chain_k": self.chain_k,
                            "why": self.why},
                "work": work, "metrics": metrics, "launches": launches,
                "checks": checks.items, "trace": traced}

    def _reference_checks(self, cfg, model, x, out, checks: Checks):
        """fp32 kernel cells against 'xla' on the same weights, bf16 against
        fp32. The 48 kHz cell's 'xla' check runs on a shorter window."""
        state = model.state_dict()
        if self.dtype == torch.bfloat16:
            ref = load_generator(cfg, state, torch.float32, "cuda")
            checks.at_most("bf16_vs_fp32_rel_l2", rel_l2(out, enhance_tensor(ref, cfg.dsp, x)),
                           BF16_VS_FP32_REL)
        elif kernel_launches(cfg, x.shape[1]):
            if self.preset == "long_form_48k":
                x = x[:, :cfg.dsp.sample_rate * XLA_SECONDS_48K]
                out = enhance_tensor(model, cfg.dsp, x)
            ref = load_generator(self.config("xla"), state, torch.float32, "cuda")
            checks.at_most("auto_vs_xla_rel_l2", rel_l2(out, enhance_tensor(ref, cfg.dsp, x)),
                           FLASH_VS_XLA_REL)
        else:
            return
        del ref
        free_card()


@dataclasses.dataclass(frozen=True)
class Train:
    batch: int
    cut_len: int
    remat: bool
    modes: tuple
    why: str
    headline: bool = False   # gives the summary line's training keys

    def config(self, mode: str, seed: int, attention_impl: str = "auto") -> CMGANConfig:
        return CMGANConfig(
            model=ModelConfig(attention_impl=attention_impl, remat=self.remat),
            train=dataclasses.replace(TrainConfig(), batch_size=self.batch, cut_len=self.cut_len,
                                      pesq_label_mode=mode, seed=seed),
        )

    def expected_launches(self) -> dict:
        """Kernels #1 and #2 a step: the generator's forward (twice with
        remat: the backward recomputes it) and its backward."""
        n = kernel_launches(self.config("host", 0), self.cut_len)
        return {"kernel_1_a_step": n * (2 if self.remat else 1), "kernel_2_a_step": n}

    def run(self, name: str, ctx: Run) -> dict:
        from cmgan_torch.train import Trainer

        rng = np.random.default_rng(ctx.seed + 1)
        clean = (0.1 * rng.standard_normal((self.batch, self.cut_len))).astype(np.float32)
        noisy = clean + (0.03 * rng.standard_normal(clean.shape)).astype(np.float32)
        # a loader of global batches, as Trainer checks; its length is the epoch
        loader = [(clean, noisy)] * TRAIN_EPOCH_STEPS
        checks, metrics, launches, traced = Checks(), {}, {}, None

        for mode in self.modes:
            trainer = Trainer(self.config(mode, ctx.seed), loader, None, device="cuda")
            fa.launches = fa.backward_launches = 0
            torch.cuda.reset_peak_memory_stats()
            trainer.train_step(clean, noisy)
            trainer.drain_pending_d()
            torch.cuda.synchronize()
            launches[mode] = {"kernel_1_a_step": fa.launches,
                              "kernel_2_a_step": fa.backward_launches}
            checks.equal(f"{mode}_launches", launches[mode], self.expected_launches())
            # every repeat on one trainer, as an epoch runs: host_async's
            # deferred D update of a repeat's last step overlaps the next
            # repeat's first G step, and is drained once, after the last
            times, disc_losses = [], []
            for _ in range(ctx.reps):
                t0 = time.perf_counter()
                for _ in range(TRAIN_STEPS):
                    gen_loss, disc_loss = trainer.train_step(clean, noisy)
                    disc_losses.append(disc_loss)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) / TRAIN_STEPS)
            disc_losses.append(trainer.drain_pending_d())
            torch.cuda.synchronize()
            checks.holds(f"{mode}_losses_finite", bool(torch.isfinite(gen_loss)) and all(
                bool(torch.isfinite(torch.as_tensor(v))) for v in disc_losses if v is not None))
            metrics[f"{mode}_steps_per_sec"] = stats([1 / s for s in times], "steps/s")
            metrics[f"{mode}_utt_per_sec"] = stats([self.batch / s for s in times],
                                                  "utterances/s")
            metrics[f"{mode}_peak_memory_gib"] = stats(
                [torch.cuda.max_memory_allocated() / 2**30], "GiB")
            if ctx.trace_dir and traced is None:
                def g_step():
                    trainer.g_step(trainer.state, clean, noisy)

                g_step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g_step()
                torch.cuda.synchronize()
                traced = {"window": f"one G step ({mode} mode's trainer)",
                          **timed_traced(g_step, os.path.join(ctx.trace_dir, name),
                                         time.perf_counter() - t0, top=12)}
            del trainer
            free_card()

        if self.expected_launches()["kernel_1_a_step"]:
            self._g_step_vs_xla(clean, noisy, loader, ctx, checks)
        if self.headline:
            med = {k: v["median"] for k, v in metrics.items()}
            ctx.summary.update({
                "train_steps_per_sec": med["device_steps_per_sec"],
                "train_utt_per_sec": med["device_utt_per_sec"],
                "train_host_steps_per_sec": med["host_steps_per_sec"],
                "train_host_utt_per_sec": med["host_utt_per_sec"],
                "train_batch": self.batch,
                "train_dtype": "fp32",
            })
        return {"setting": {"batch": self.batch, "cut_len": self.cut_len,
                            "frames": CMGANConfig().dsp.num_frames(self.cut_len),
                            "remat": self.remat, "modes": list(self.modes), "dtype": "fp32",
                            "steps_a_repeat": TRAIN_STEPS,
                            "host_async_drain": "once, after the last timed repeat",
                            "why": self.why},
                "metrics": metrics, "launches": launches, "checks": checks.items,
                "trace": traced}

    def _g_step_vs_xla(self, clean, noisy, loader, ctx: Run, checks: Checks):
        """One G step through the kernels against 'xla', from the same seeded
        state and dropout stream: the enhanced audio and the loss (the
        forward, kernel #1) and the gradient (kernel #2)."""
        from cmgan_torch.train import Trainer

        runs = []
        for impl in ("auto", "xla"):
            trainer = Trainer(self.config("host", ctx.seed, impl), loader, None, device="cuda")
            runs.append(g_step_record(trainer, clean, noisy))
            del trainer
            free_card()
        (audio, loss, grads), (audio_xla, loss_xla, grads_xla) = runs
        checks.at_most("g_step_audio_auto_vs_xla_rel_l2", rel_l2(audio, audio_xla),
                       FLASH_VS_XLA_REL)
        checks.at_most("g_step_loss_auto_vs_xla_rel", abs(loss - loss_xla) / abs(loss_xla),
                       FLASH_VS_XLA_REL)
        whole, worst = gradient_rel(grads, grads_xla)
        checks.at_most("g_step_gradients_auto_vs_xla_rel_l2", whole, GSTEP_REL)
        checks.at_most("g_step_worst_parameter_gradient_auto_vs_xla_rel", worst, GSTEP_PARAM_REL)


@dataclasses.dataclass(frozen=True)
class Stream:
    widths: tuple      # (slots, left_context) of each StreamBatcher
    why: str

    def expected_launches(self) -> dict:
        return {f"kernel_1_a_tick_{slots}_{left}": kernel_launches(
                    CMGANConfig(), left + CHUNK + LOOKAHEAD)
                for slots, left in self.widths}

    def run(self, name: str, ctx: Run) -> dict:
        cfg = CMGANConfig()
        model = load_generator(cfg, ctx.weights, None, "cuda", seed=ctx.seed)
        checks, metrics, launches, traced = Checks(), {}, {}, None
        for slots, left in self.widths:
            key = f"{slots}_{left}"
            times, batcher, blocks = batcher_ticks(
                cfg, model, slots, TICKS_A_REP * ctx.reps, TICK_WARMUP, ctx.seed,
                chunk=CHUNK, left_context=left, lookahead=LOOKAHEAD)
            fa.launches = 0
            batcher.step(blocks)
            launches[f"kernel_1_a_tick_{key}"] = fa.launches
            chunk_s = CHUNK / cfg.dsp.sample_rate
            metrics[f"tick_ms_{key}"] = stats([1e3 * s for s in times], "ms a tick, every slot on")
            metrics[f"realtime_streams_{key}"] = stats([slots * chunk_s / s for s in times],
                                                       "streams: slots x chunk / tick")
        if ctx.trace_dir:  # the last width's tick
            traced = {"window": f"one tick, {slots} slots, left_context {left}",
                      **timed_traced(lambda: batcher.step(blocks),
                                     os.path.join(ctx.trace_dir, name), float(np.median(times)))}
        del batcher
        checks.equal("launches", launches, self.expected_launches())
        self._auto_vs_xla(cfg, model, ctx, checks)
        del model
        free_card()
        return {"setting": {"widths": [list(w) for w in self.widths], "chunk": CHUNK,
                            "lookahead": LOOKAHEAD, "dtype": "fp32",
                            "ticks_a_run": TICKS_A_REP * ctx.reps, "warmup_ticks": TICK_WARMUP,
                            "why": self.why},
                "metrics": metrics, "launches": launches, "checks": checks.items,
                "trace": traced}

    def _auto_vs_xla(self, cfg, model, ctx: Run, checks: Checks):
        """The widest window that takes the kernel, its slots' outputs over a
        few ticks against the same weights through 'xla'."""
        from cmgan_torch.streaming import StreamBatcher

        slots, left = max((w for w in self.widths
                           if kernel_launches(cfg, w[1] + CHUNK + LOOKAHEAD)),
                          key=lambda w: (w[1], w[0]))
        xla_cfg = CMGANConfig(model=ModelConfig(attention_impl="xla"))
        xla = load_generator(xla_cfg, model.state_dict(), None, "cuda")
        rng = np.random.default_rng(ctx.seed + 2)
        feeds = (0.1 * rng.standard_normal((4, slots, CHUNK))).astype(np.float32)
        outs = []
        for c, m in ((cfg, model), (xla_cfg, xla)):
            b = StreamBatcher(c, m, num_slots=slots, chunk=CHUNK, left_context=left,
                              lookahead=LOOKAHEAD, device="cuda")
            opened = [b.open() for _ in range(slots)]
            ticks = [b.step(dict(zip(opened, feed))) for feed in feeds]
            outs.append(np.concatenate([np.concatenate([t[s] for s in opened]) for t in ticks]))
        del xla
        checks.at_most(f"auto_vs_xla_rel_l2_{slots}_{left}",
                       float(np.linalg.norm(outs[0] - outs[1]) / np.linalg.norm(outs[1])),
                       FLASH_VS_XLA_REL)


@dataclasses.dataclass(frozen=True)
class Serve:
    clients: int
    seconds: tuple     # the shortest and the longest track
    left_context: int
    why: str

    def expected_launches(self) -> dict:
        return {"kernel_1_a_tick": kernel_launches(
            CMGANConfig(), self.left_context + CHUNK + LOOKAHEAD)}

    def run(self, name: str, ctx: Run) -> dict:
        cfg = CMGANConfig()
        sr = cfg.dsp.sample_rate
        model = load_generator(cfg, ctx.weights, None, "cuda", seed=ctx.seed)
        rng = np.random.default_rng(ctx.seed + 3)
        lengths = np.linspace(self.seconds[0], self.seconds[1], self.clients)
        tracks = [(0.1 * rng.standard_normal(int(s * sr))).astype(np.float32) for s in lengths]
        audio = float(sum(t.size for t in tracks)) / sr
        checks, runs = Checks(), []
        for _ in range(ctx.reps):
            runs.append(serve_clients(cfg, model, self.clients, tracks, CHUNK, self.left_context,
                                      LOOKAHEAD))
        per_tick = self.expected_launches()["kernel_1_a_tick"]
        checks.holds("every_stream_complete_and_finite", all(
            o.shape == t.shape and bool(np.isfinite(o).all())
            for r in runs for o, t in zip(r["outputs"], tracks)))
        checks.equal("launches_equal_ticks_times_per_tick",
                     [r["launches"] for r in runs], [per_tick * r["ticks"] for r in runs])
        del model
        free_card()
        metrics = {
            "served_realtime_factor": stats([audio / r["wall_s"] for r in runs],
                                            "audio s of all clients / wall s"),
            "client_realtime_factor": stats(
                [t.size / sr / w for r in runs for t, w in zip(tracks, r["client_wall_s"])],
                "a client's audio s / its wall s"),
            "tick_ms": stats([1e3 * r["step_s"] / r["ticks"] for r in runs],
                             "ms in StreamBatcher.step a tick"),
            "step_share_of_wall": stats([r["step_s"] / r["wall_s"] for r in runs],
                                        "the tick thread's time in steps over the wall"),
            "active_slots_a_tick": stats([r["lanes"] / r["ticks"] for r in runs], "slots"),
        }
        return {"setting": {"clients": self.clients, "slots": self.clients,
                            "track_seconds": [float(s) for s in lengths],
                            "chunk": CHUNK, "left_context": self.left_context,
                            "lookahead": LOOKAHEAD, "dtype": "fp32", "why": self.why},
                "metrics": metrics,
                "launches": {"kernel_1": [r["launches"] for r in runs],
                             "ticks": [r["ticks"] for r in runs]},
                "checks": checks.items, "trace": None}


CELLS = {
    "enhance_2s_b16_bf16": Enhance(
        "default", torch.bfloat16, 16, 2, 10, 20, headline=True,
        why="the root bench.py's headline shape: 16 x 2 s in bf16 (321 frames, dense)"),
    "train_b8_remat_fp32": Train(
        8, 32000, True, ("device", "host"), headline=True,
        why="the root bench.py's training keys: batch 8, remat, the default 2 s window"),
    "enhance_16s_fp32": Enhance(
        "default", torch.float32, 1, 16, 10, 20,
        why="an evaluation segment (EvalConfig.cut_len), bucket mode: 2561 frames, kernel #1"),
    "enhance_16s_bf16": Enhance(
        "default", torch.bfloat16, 1, 16, 10, 20,
        why="the same segment in bf16"),
    "enhance_48k_30s_fp32": Enhance(
        "long_form_48k", torch.float32, 1, 30, 2, 4,
        why="the 48 kHz long-form preset's 30 s window: 4801 frames, kernel #1; "
            "the longest call of the cells, so fewer calls a repeat and windows a graph"),
    "train_b4_64000_fp32": Train(
        4, 64000, False, ("host", "host_async", "device"),
        why="training that reaches kernels #1 and #2: 641 frames"),
    "stream_ticks": Stream(
        ((1, 24000), (8, 24000), (32, 24000), (1, 48000), (8, 48000)),
        why="serving density: the default window (361 frames, dense) and left_context "
            "48000 (601 frames, kernel #1)"),
    "serve_e2e_8": Serve(
        8, (3, 10), 48000,
        why="the served realtime factor: 8 loopback clients on 8 slots, long windows"),
}


def build_kernels():
    """Kernels #1 and #2 and the host PESQ scorer, built side by side
    before any cell (each builds at first use otherwise)."""
    from cmgan_torch.metrics import pesq_native
    from cmgan_torch.ops import _build

    with ThreadPoolExecutor(3) as pool:
        futures = [pool.submit(_build.build, fa.KERNEL), pool.submit(_build.build, fa.BWD_KERNEL),
                   pool.submit(pesq_native.build)]
    for f in futures:
        f.result()


class BenchFailed(RuntimeError):
    pass


def run(names, ctx: Run, emit=print) -> dict:
    """Run the named cells in order, emitting one JSON line each; returns
    the summary record. Raises BenchFailed after the last cell if any
    check missed."""
    failed = {}
    for name in names:
        t0 = time.perf_counter()
        record = CELLS[name].run(name, ctx)
        bad = [k for k, c in record["checks"].items() if not c["ok"]]
        if bad:
            failed[name] = bad
        emit(json.dumps({"cell": name, "card": ctx.smi, "ok": not bad,
                         "seconds": time.perf_counter() - t0, **record}))
    if failed:
        raise BenchFailed(f"failed checks: {json.dumps(failed)}")
    return {**ctx.summary, "card": ctx.smi, "cells": list(names)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The PyTorch port's bench on one NVIDIA GPU")
    p.add_argument("--cell", action="append", choices=list(CELLS),
                   help="a cell to run (repeatable); default: every cell")
    p.add_argument("--seed", type=int, default=0, help="weights and data")
    p.add_argument("--reps", type=int, default=5, help="timed repeats a metric")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="trace one more window of each cell into DIR")
    p.add_argument("--model_path", default=None,
                   help="the 16 kHz generator: a port train state or generator file "
                        "(save_variables); default: drawn from --seed")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    require_cuda("cmgan_torch.bench")
    from cmgan_torch.cli import pin_fp32

    pin_fp32()
    ctx = Run(nvidia_smi(), args.seed, args.reps, args.trace, load_weights(args.model_path))
    build_kernels()
    print(json.dumps(run(args.cell or list(CELLS), ctx)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
