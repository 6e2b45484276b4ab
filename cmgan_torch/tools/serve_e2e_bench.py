"""End-to-end serving on one NVIDIA GPU: loopback clients through the
port's TCP server. The counterpart of the root tools/serve_e2e_bench.py.

For each width S, starts `cli.serve.make_server(slots=S)` in this
process and S client threads, each streaming its track through
`enhance_via_server` in chunk-sized frames at full rate (a capacity
measurement, not pacing). Reports the aggregate audio seconds enhanced a
wall second (the realtime streams the server carries), each client's
realtime factor, and the split of the tick thread's time: in
`StreamBatcher.step` (host windows, the device call, the read-back)
against the wall, and the slots a tick carried.

    python3 -m cmgan_torch.tools.serve_e2e_bench [--model_path CKPT]
        [--widths 8,16,32] [--track_seconds 20] [--chunk_seconds 0.5]
        [--left_context_s 1.0] [--lookahead_s 0.25] [--bf16] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from cmgan_torch.cli.serve import enhance_via_server, make_server
from cmgan_torch.ops import flash_attention as fa
from cmgan_torch.tools import load_weights, nvidia_smi, require_cuda, stats

WAIT = 300.0   # seconds any client, or the server's warm-up, may take


def serve_clients(cfg, model, slots: int, tracks, chunk: int, left_context: int,
                  lookahead: int) -> dict:
    """One server of `slots` slots on an ephemeral loopback port, one warm-up
    stream, then every track through its own client thread at once. Returns
    the wall seconds of all clients, each client's seconds and output, the
    ticks run, the seconds the tick thread spent in `StreamBatcher.step`, the
    slots those ticks carried and kernel #1's launches: all counted from the
    measured clients' start."""
    server = make_server(cfg, model, port=0, slots=slots, chunk=chunk,
                         left_context=left_context, lookahead=lookahead, device="cuda")
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    worker, addr = server.worker, server.server_address[:2]
    try:
        enhance_via_server(addr, tracks[0][:4 * chunk], block=chunk, timeout=WAIT)
        deadline = time.monotonic() + WAIT
        with worker.cond:  # the warm-up's slot frees a few drain ticks after its client
            while worker.sessions and time.monotonic() < deadline:
                worker.cond.wait(0.1)
            if worker.sessions:
                raise TimeoutError("the warm-up stream did not end")
            ticks0, launches0 = worker.ticks, fa.launches
        batcher, step = worker.batcher, worker.batcher.step
        split = {"step_s": 0.0, "lanes": 0}

        def timed_step(blocks):
            t0 = time.perf_counter()
            out = step(blocks)
            split["step_s"] += time.perf_counter() - t0
            split["lanes"] += len(blocks)
            return out

        batcher.step = timed_step
        results = [None] * len(tracks)

        def client(i):
            t0 = time.perf_counter()
            try:
                est = enhance_via_server(addr, tracks[i], block=chunk, timeout=WAIT)
                results[i] = (time.perf_counter() - t0, est)
            except Exception as exc:  # re-raised below, in the caller's thread
                results[i] = exc

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(tracks))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        wall = time.perf_counter() - t0
        with worker.cond:
            ticks, launches = worker.ticks - ticks0, fa.launches - launches0
        for r in results:
            if isinstance(r, Exception):
                raise r
            if r is None:
                raise TimeoutError(f"a client did not finish within {WAIT} s")
    finally:
        server.shutdown()
        server.server_close()
        worker.thread.join(timeout=WAIT)  # a tick in a device call may outlive shutdown's join
    return {"wall_s": wall, "client_wall_s": [r[0] for r in results],
            "outputs": [r[1] for r in results], "ticks": ticks, "launches": launches, **split}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Loopback clients through the port's server")
    p.add_argument("--model_path", default=None,
                   help="a port train state or generator file; default: seeded weights")
    p.add_argument("--widths", default="8,16,32")
    p.add_argument("--track_seconds", type=float, default=20.0)
    p.add_argument("--chunk_seconds", type=float, default=0.5)
    p.add_argument("--left_context_s", type=float, default=1.0)
    p.add_argument("--lookahead_s", type=float, default=0.25)
    p.add_argument("--bf16", action="store_true", help="the bf16 generator")
    p.add_argument("--json", default=None)
    return p.parse_args(argv)


def main(argv=None):
    import torch

    from cmgan_torch.cli import pin_fp32
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.inference import load_generator

    args = parse_args(argv)
    require_cuda("serve_e2e_bench")
    pin_fp32()
    cfg = CMGANConfig()
    sr = cfg.dsp.sample_rate
    model = load_generator(cfg, load_weights(args.model_path),
                           torch.bfloat16 if args.bf16 else None, "cuda")
    chunk = int(args.chunk_seconds * sr)
    n = int(args.track_seconds * sr)
    rng = np.random.default_rng(0)
    smi = nvidia_smi()
    rows = []
    for s in (int(w) for w in args.widths.split(",")):
        tracks = [(0.1 * rng.standard_normal(n)).astype(np.float32) for _ in range(s)]
        r = serve_clients(cfg, model, s, tracks, chunk, int(args.left_context_s * sr),
                          int(args.lookahead_s * sr))
        row = {
            "streams": s, "wall_s": r["wall_s"], "audio_seconds": s * n / sr,
            "e2e_rt_streams": s * n / sr / r["wall_s"],
            "client_realtime_factor": stats([n / sr / w for w in r["client_wall_s"]], "x"),
            "output_complete": all(o.shape == t.shape and bool(np.isfinite(o).all())
                                   for o, t in zip(r["outputs"], tracks)),
            "ticks": r["ticks"], "tick_ms": 1e3 * r["step_s"] / r["ticks"],
            "step_share_of_wall": r["step_s"] / r["wall_s"],
            "active_slots_a_tick": r["lanes"] / r["ticks"],
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": smi, "model_path": args.model_path, "dtype": "bf16" if args.bf16 else "fp32",
           "chunk_seconds": args.chunk_seconds, "left_context_s": args.left_context_s,
           "lookahead_s": args.lookahead_s, "track_seconds": args.track_seconds, "rows": rows}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    if not all(r["output_complete"] for r in rows):
        raise SystemExit("a stream came back incomplete or not finite")


if __name__ == "__main__":
    main()
