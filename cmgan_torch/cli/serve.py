"""Streaming enhancement server on the GPU: the JAX package's
`cli/serve.py`, ported. It exposes the streaming engine
(cmgan_torch/streaming.py) over TCP so non-Python clients can stream
audio through the card.

    python -m cmgan_torch.cli.serve --port 7860 --model_path <ckpt> \
        [--slots 8] [--left_context 48000] [--bf16] [--device cuda]

Protocol (one connection = one audio stream, mono float32 @ 16 kHz):
  - every frame is <uint32 little-endian byte length> + payload
  - client sends raw float32 PCM blocks of any size
  - server replies with enhanced float32 PCM frames as output becomes
    ready (the stream runs `latency` samples behind the input)
  - a ZERO-LENGTH frame from the client flushes: the server emits the
    remaining tail, answers with a zero-length frame, and closes.

The generator is put on the device once; every connection shares it. By
default each connection gets its own StreamingEnhancer (independent
normalization/crossfade state, a batch of one a tick). With `--slots N`,
concurrent connections are multiplexed into one fixed-shape batch of N
(streaming.StreamBatcher behind a BatcherWorker tick thread): more
streams per card, with output asynchronous to input within the latency
budget. The window is left_context + chunk + lookahead samples: from
51100 samples (for instance `--left_context 48000`) each tick runs the
flash-attention kernel once per TSCB; the first such tick of a process
builds it when `cmgan_torch/ops/_build/` does not hold it yet.
"""

from __future__ import annotations

import argparse
import logging
import queue
import signal
import socket
import socketserver
import struct
import threading
import time

import numpy as np

from cmgan_torch.cli import pin_fp32

log = logging.getLogger("cmgan_torch.serve")

_LEN = struct.Struct("<I")
# per-frame cap: 16 MiB = ~4 min of float32 @ 16 kHz per frame, far
# above any sane streaming block, far below a memory-exhaustion header
MAX_FRAME_BYTES = 16 << 20


class ProtocolError(ValueError):
    pass


def _recv_exact(sock, n: int) -> bytes | None:
    parts = []
    got = 0
    while got < n:
        part = sock.recv(n - got)
        if not part:
            return None
        parts.append(part)
        got += len(part)
    return b"".join(parts)


def recv_frame(sock) -> bytes | None:
    """None on EOF; b'' is a valid (flush/end) frame.

    Raises ProtocolError on a hostile/corrupt header: length over
    MAX_FRAME_BYTES (a 4-byte header can demand a ~4 GiB allocation) or
    not a whole number of float32 samples.
    """
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n == 0:
        return b""
    if n > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {n} bytes exceeds cap {MAX_FRAME_BYTES}")
    if n % 4:
        raise ProtocolError(f"frame length {n} is not a multiple of 4")
    return _recv_exact(sock, n)


def send_frame(sock, payload: bytes):
    sock.sendall(_LEN.pack(len(payload)) + payload)


_DONE = object()  # out-queue sentinel: stream fully delivered
_ABORT = object()  # out-queue sentinel: stream dropped server-side —
# the sender must NOT emit the b'' clean-completion frame (a live
# client would misread a truncated stream as complete); the socket is
# simply closed.

# Backpressure cap on un-enhanced buffered input per connection: the
# worker drains one chunk per slot per device tick, so a client that
# uploads faster than the tick rate (e.g. a whole file at once) would
# otherwise grow _SlotSession.pending without bound. 30 s of audio is
# far above any real-time burst; past it, feed() blocks (which stops
# the handler reading the socket — natural TCP backpressure).
MAX_PENDING_SAMPLES = 16_000 * 30


class _SlotSession:
    """One connection's view of a shared BatcherWorker slot."""

    def __init__(self, worker, slot: int):
        self.worker = worker
        self.slot = slot
        self.pending = np.zeros(0, np.float32)  # guarded by worker.cond
        self.n_in = 0
        self.draining = False
        self.zero_chunks_left = 0
        self.delivered = 0
        self.out_q = queue.Queue()

    def feed(self, block: np.ndarray):
        with self.worker.cond:
            # backpressure: wait for the worker to drain below the cap
            # (bail out if the session was aborted/failed meanwhile, or
            # the worker died — otherwise this would block forever)
            while (
                self.pending.size + block.size > MAX_PENDING_SAMPLES
                and self.worker.sessions.get(self.slot) is self
                and self.worker.thread.is_alive()
            ):
                self.worker.cond.wait(1.0)
            if self.worker.sessions.get(self.slot) is not self:
                return  # aborted server-side; handler will tear down
            self.pending = np.concatenate([self.pending, block])
            self.n_in += block.size
            self.worker.cond.notify_all()

    def finish(self):
        """No more input: pad the remainder and schedule the drain ticks
        that flush the lookahead delay (StreamingEnhancer.flush logic,
        expressed as ordinary ticks)."""
        with self.worker.cond:
            self.draining = True
            b = self.worker.batcher
            self.zero_chunks_left = -(-b.lookahead // b.chunk) + 1
            self.worker.cond.notify_all()


class BatcherWorker:
    """Owns a StreamBatcher and a tick thread; concurrent connections
    share one fixed-shape device batch instead of stepping a batch of one
    each (`--slots`). Sessions attach via `open_session`, feed
    asynchronously, and read enhanced audio from their own queue — the
    worker coalesces whichever sessions have a full chunk into each
    device step. `ticks` counts the steps that ran."""

    def __init__(self, cfg, weights, num_slots, **stream_kw):
        from cmgan_torch.streaming import StreamBatcher

        self.batcher = StreamBatcher(
            cfg, weights, num_slots=num_slots, **stream_kw
        )
        self.cond = threading.Condition()
        self.sessions = {}  # slot -> _SlotSession
        self._to_close = []  # slots freed by abort, recycled by the worker
        self._stop = False
        self.ticks = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def open_session(self, timeout: float = 30.0):
        """Claim a slot (waits up to `timeout` for one to free)."""
        deadline = time.monotonic() + timeout
        with self.cond:
            while not self.batcher._free:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(
                        f"no free slot within {timeout}s "
                        f"({self.batcher.num_slots} busy)"
                    )
                self.cond.wait(left)
            slot = self.batcher.open()
            sess = _SlotSession(self, slot)
            self.sessions[slot] = sess
            return sess

    def abort(self, sess: _SlotSession):
        """Drop a session (client vanished). The slot is recycled by the
        worker thread (not here): batcher.step may be running outside
        the lock, and an open() re-using the slot concurrently with that
        step's state writes would race."""
        with self.cond:
            if self.sessions.pop(sess.slot, None) is not None:
                self._to_close.append(sess.slot)
                sess.out_q.put(_ABORT)  # unblock the connection's sender
                self.cond.notify_all()

    def shutdown(self):
        with self.cond:
            self._stop = True
            self.cond.notify_all()
        self.thread.join(timeout=10)

    # ------------------------------------------------------------------
    def _gather(self):
        """Under cond: pop one chunk from every ready session."""
        chunk = self.batcher.chunk
        blocks = {}
        for slot, s in self.sessions.items():
            if s.pending.size >= chunk:
                blocks[slot] = s.pending[:chunk]
                s.pending = s.pending[chunk:]
            elif s.draining:
                if s.pending.size:  # final partial chunk, zero-padded
                    blocks[slot] = np.concatenate(
                        [s.pending,
                         np.zeros(chunk - s.pending.size, np.float32)]
                    )
                    s.pending = np.zeros(0, np.float32)
                elif s.zero_chunks_left > 0:
                    s.zero_chunks_left -= 1
                    blocks[slot] = np.zeros(chunk, np.float32)
        return blocks

    def _drain_closes(self):
        """Under cond, worker thread only (never concurrent with step)."""
        while self._to_close:
            self.batcher.close(self._to_close.pop())
        self.cond.notify_all()

    def _run(self):
        while True:
            with self.cond:
                self._drain_closes()
                blocks = self._gather()
                while not blocks and not self._stop:
                    self.cond.wait(0.1)
                    self._drain_closes()
                    blocks = self._gather()
                if self._stop:
                    return
            # device step OUTSIDE the lock: feeds/opens stay responsive
            try:
                outs = self.batcher.step(blocks)
            except Exception:
                # a failed device step (bad state, CUDA error) must not
                # silently kill the single tick thread — that would hang
                # every current and future batched connection on a _DONE
                # that never arrives. Abort the sessions that were in
                # flight and keep ticking for new ones.
                log.exception("batcher.step failed; aborting %d sessions",
                              len(self.sessions))
                with self.cond:
                    for slot, s in list(self.sessions.items()):
                        del self.sessions[slot]
                        self._to_close.append(slot)
                        s.out_q.put(_ABORT)
                    self.cond.notify_all()
                continue
            with self.cond:
                self.ticks += 1
                self.cond.notify_all()  # wake feeds blocked on backpressure
                for slot, out in outs.items():
                    s = self.sessions.get(slot)
                    if s is None:  # aborted mid-step
                        continue
                    out = out[: s.n_in - s.delivered]  # trim drain excess
                    if out.size:
                        s.delivered += out.size
                        s.out_q.put(out)
                    if (
                        s.draining
                        and s.pending.size == 0
                        and (s.zero_chunks_left == 0
                             or s.delivered >= s.n_in)
                    ):
                        s.out_q.put(_DONE)
                        del self.sessions[slot]
                        self.batcher.close(slot)
                        self.cond.notify_all()


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv = self.server
        if getattr(srv, "worker", None) is not None:
            self._handle_batched(srv)
        else:
            self._handle_solo(srv)

    def _handle_solo(self, srv):
        from cmgan_torch.streaming import StreamingEnhancer

        enh = StreamingEnhancer(
            srv.cfg,
            srv.model,  # the shared generator: no weights copied per connection
            chunk=srv.stream_args["chunk"],
            left_context=srv.stream_args["left_context"],
            lookahead=srv.stream_args["lookahead"],
            emit=srv.stream_args["emit"],
            device=srv.stream_args["device"],
        )
        log.info("stream from %s (latency %d samples)",
                 self.client_address, enh.latency_samples)
        while True:
            try:
                frame = recv_frame(self.request)
            except ProtocolError as exc:
                log.warning("dropping %s: %s", self.client_address, exc)
                return
            if frame is None:  # client vanished
                return
            if frame == b"":
                tail = enh.flush()  # 1-D: num_streams == 1 per connection
                if tail.size:
                    send_frame(self.request, tail.astype("<f4").tobytes())
                send_frame(self.request, b"")
                return
            block = np.frombuffer(frame, dtype="<f4").astype(np.float32)
            out = enh.push(block)
            if out.size:
                send_frame(self.request, out.astype("<f4").tobytes())

    def _handle_batched(self, srv):
        """Same wire protocol, but enhancement rides the shared
        BatcherWorker batch. A sender thread forwards enhanced audio as
        it becomes ready (output is asynchronous to input here)."""
        try:
            sess = srv.worker.open_session()
        except RuntimeError as exc:
            log.warning("rejecting %s: %s", self.client_address, exc)
            return
        log.info("stream from %s (slot %d, latency %d samples)",
                 self.client_address, sess.slot,
                 srv.worker.batcher.latency_samples)

        def sender():
            while True:
                item = sess.out_q.get()
                if item is _DONE:
                    try:
                        send_frame(self.request, b"")
                    except OSError:
                        pass
                    return
                if item is _ABORT:
                    # server-side drop: close WITHOUT the b'' completion
                    # frame so the client sees a truncated stream, not a
                    # clean finish; the shutdown also unblocks the
                    # handler thread's recv_frame.
                    try:
                        self.request.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
                try:
                    send_frame(self.request, item.astype("<f4").tobytes())
                except OSError:
                    return

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        try:
            while True:
                try:
                    frame = recv_frame(self.request)
                except ProtocolError as exc:
                    log.warning("dropping %s: %s", self.client_address, exc)
                    return
                if frame is None:
                    return
                if frame == b"":
                    sess.finish()
                    # bounded: if the worker cannot deliver _DONE within
                    # the drain budget (it should take a few ticks), the
                    # finally-abort below unblocks the sender via _ABORT
                    # rather than hanging this connection forever.
                    t.join(timeout=120.0)
                    if t.is_alive():
                        log.warning("drain timed out for %s (slot %d)",
                                    self.client_address, sess.slot)
                    return
                sess.feed(np.frombuffer(frame, dtype="<f4").astype(np.float32))
        finally:
            srv.worker.abort(sess)
            t.join(timeout=5.0)


class StreamServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def make_server(cfg, weights, host="127.0.0.1", port=7860,
                chunk=8000, left_context=24000, lookahead=4000,
                emit="wola", slots=0, dtype=None, device="cuda"):
    """slots=0: one StreamingEnhancer per connection (a batch of one a
    tick each). slots=N: an N-slot BatcherWorker — concurrent connections
    share one fixed-shape batch of N (more streams per card; output
    becomes asynchronous to input within the latency budget).

    `weights` as for streaming.StreamingEnhancer (a TSCNet on `device`, a
    reference-layout state_dict, or None for a seeded random init). The
    generator is put on the device once, here, and shared by every
    connection. The default device is the GPU; without CUDA this raises
    unless device="cpu"."""
    from cmgan_torch.inference import load_generator

    model = load_generator(cfg, weights, dtype, device)
    server = StreamServer((host, port), _Handler)
    server.cfg = cfg
    server.model = model
    server.stream_args = {
        "chunk": chunk, "left_context": left_context, "lookahead": lookahead,
        "emit": emit, "device": device,
    }
    server.worker = None
    if slots > 0:
        server.worker = BatcherWorker(
            cfg, model, num_slots=slots, chunk=chunk,
            left_context=left_context, lookahead=lookahead, emit=emit,
            device=device,
        )
        _orig_close = server.server_close

        def _close():
            server.worker.shutdown()
            _orig_close()

        server.server_close = _close
    return server


def enhance_via_server(addr, track: np.ndarray, block: int = 3000,
                       timeout: float = 600.0) -> np.ndarray:
    """Reference client: stream `track` through a server, return the
    enhanced track (aligned, same length). A reader thread drains
    server frames concurrently with the send loop, exactly as a
    real-time client would. Every socket operation waits at most
    `timeout` seconds. Raises ConnectionError if the server closes the
    stream without its zero-length completion frame (a session the
    server aborted), TimeoutError if the stream does not end in time."""
    track = np.asarray(track, np.float32).reshape(-1)
    out = []
    ended = {"complete": False, "error": None}
    done = threading.Event()
    with socket.create_connection(addr, timeout=timeout) as sock:
        def reader():
            try:
                while True:
                    frame = recv_frame(sock)
                    if frame is None:
                        break
                    if frame == b"":
                        ended["complete"] = True
                        break
                    out.append(np.frombuffer(frame, dtype="<f4"))
            except (OSError, ProtocolError) as exc:
                ended["error"] = exc
            finally:
                done.set()

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        for lo in range(0, track.size, block):
            send_frame(sock, track[lo : lo + block].astype("<f4").tobytes())
        send_frame(sock, b"")
        if not done.wait(timeout):
            raise TimeoutError("server did not finish the stream in time")
    if not ended["complete"]:
        raise ConnectionError(
            f"the server ended the stream without its completion frame ({ended['error']})")
    est = np.concatenate(out) if out else np.zeros(0, np.float32)
    return est[: track.size]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CMGAN streaming server (PyTorch port)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860, help="0 picks a free port (logged)")
    p.add_argument("--model_path", type=str, default=None,
                   help="the port's checkpoint: a full train state or a generator file "
                   "(save_variables); random init if omitted")
    p.add_argument("--torch_ckpt", type=str, default=None,
                   help="a reference-layout generator state_dict (.pt) instead")
    p.add_argument("--chunk", type=int, default=8000,
                   help="emission granularity in samples (0.5 s default)")
    p.add_argument("--left_context", type=int, default=24000,
                   help="past context in samples; windows of 51100 samples or more "
                   "(e.g. 48000 here) run the flash-attention kernel")
    p.add_argument("--lookahead", type=int, default=4000)
    p.add_argument("--emit", type=str, default="wola",
                   choices=["wola", "crossfade"],
                   help="seam handling (see streaming.StreamingEnhancer)")
    p.add_argument("--slots", type=int, default=0,
                   help="batch N concurrent connections into one "
                   "fixed-shape device batch (0 = a batch of one per connection)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 window compute")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    pin_fp32()
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)

    import torch

    from cmgan_torch.cli.evaluate import load_state_dict
    from cmgan_torch.config import CMGANConfig

    server = make_server(
        CMGANConfig(), load_state_dict(args), host=args.host, port=args.port,
        chunk=args.chunk, left_context=args.left_context,
        lookahead=args.lookahead, emit=args.emit, slots=args.slots,
        dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
    )
    host, port = server.server_address[:2]
    # pin_fp32 turned TF32 off (PyTorch's defaults would run cuDNN's convs
    # in TF32, ~1e-3 from float32): the log says what the ticks run under
    log.info("serving on %s:%d (TF32: cuDNN %s, matmul %s)", host, port,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def stop(signum, frame):  # SIGTERM (a service manager's stop) shuts down as Ctrl-C does
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if server.worker is not None:
            log.info("stopped after %d ticks", server.worker.ticks)


if __name__ == "__main__":
    main()
