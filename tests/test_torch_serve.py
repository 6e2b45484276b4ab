"""The port's streaming TCP server (cmgan_torch/cli/serve.py) on the CPU,
tiny model: the cases of test_serve.py, and the served output against the
JAX package's server on the same weights.

Every wait is bounded: clients carry a timeout, joins carry a timeout and
are checked after.
"""

import socket
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmgan_tpu import config as jcfg
from cmgan_tpu.cli import serve as jserve
from cmgan_tpu.models.generator import TSCNet as JaxTSCNet
from cmgan_torch import config as tcfg
from cmgan_torch.cli import serve as serve_mod
from cmgan_torch.cli.serve import (
    _DONE,
    MAX_FRAME_BYTES,
    BatcherWorker,
    ProtocolError,
    enhance_via_server,
    make_server,
    recv_frame,
    send_frame,
)
from cmgan_torch.convert import state_dict_from_flax
from cmgan_torch.inference import load_generator
from cmgan_torch.streaming import StreamingEnhancer
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

TINY = dict(num_channels=16, num_tscb_blocks=1, dense_depth=2, attn_heads=2)
ATOL, RTOL = 2e-4, 1e-3   # against JAX, as for the offline Enhancer
KW = dict(chunk=2000, left_context=4000, lookahead=1000)
WAIT = 60


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(3)
    model = JaxTSCNet(jcfg.ModelConfig(**TINY, attention_impl="xla"))
    variables = jax.jit(model.init)({"params": jax.random.key(0)}, jnp.zeros((1, 21, 201, 2)))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables["params"],
    )
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    cfg = tcfg.CMGANConfig(model=tcfg.ModelConfig(**TINY))
    sd = state_dict_from_flax(params, stats, num_tscb=1, depth=2)
    return cfg, load_generator(cfg, sd, device="cpu"), {"params": params, "batch_stats": stats}


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(WAIT)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def served(weights):
    cfg, model, _ = weights
    server = make_server(cfg, model, port=0, device="cpu", **KW)  # ephemeral port
    thread = _serve(server)
    yield cfg, model, server.server_address
    _stop(server, thread)


@pytest.fixture(scope="module")
def served_batched(weights):
    cfg, model, _ = weights
    server = make_server(cfg, model, port=0, slots=3, device="cpu", **KW)
    thread = _serve(server)
    yield cfg, model, server.server_address
    _stop(server, thread)


def _direct(cfg, model, track):
    e = StreamingEnhancer(cfg, model, device="cpu", **KW)
    return np.concatenate([e.push(track), e.flush()])[: track.size]


def _track(n, seed, amp=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * amp).astype(np.float32)


def _concurrently(addr, tracks, block):
    results = {}

    def run(name):
        results[name] = enhance_via_server(addr, tracks[name], block=block, timeout=WAIT)

    threads = [threading.Thread(target=run, args=(n,)) for n in tracks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(2 * WAIT)
        assert not t.is_alive()
    return results


def test_served_stream_matches_direct(served):
    """The protocol adds no resampling, reordering or loss."""
    cfg, model, addr = served
    track = _track(9500, 0)
    via_server = enhance_via_server(addr, track, block=1700, timeout=WAIT)
    direct = _direct(cfg, model, track)
    assert via_server.shape == direct.shape == track.shape
    np.testing.assert_allclose(via_server, direct, atol=1e-6)


def test_two_concurrent_streams_are_independent(served):
    cfg, model, addr = served
    tracks = {"a": _track(6000, 1), "b": _track(6000, 2, 0.05)}
    results = _concurrently(addr, tracks, block=1300)
    np.testing.assert_allclose(results["a"], _direct(cfg, model, tracks["a"]), atol=1e-6)
    assert results["b"].shape == tracks["b"].shape
    assert not np.allclose(results["a"], results["b"])


def test_protocol_rejects_hostile_headers():
    """A 4-byte header must not be able to demand a huge allocation or a
    payload that is not whole float32 samples."""

    def run_case(header_n, payload=b""):
        a, b = socket.socketpair()
        b.settimeout(WAIT)
        try:
            a.sendall(struct.pack("<I", header_n) + payload)
            a.shutdown(socket.SHUT_WR)
            return recv_frame(b)
        finally:
            a.close()
            b.close()

    with pytest.raises(ProtocolError):
        run_case(MAX_FRAME_BYTES + 4)
    with pytest.raises(ProtocolError):
        run_case(6, b"abcdef")
    assert run_case(0) == b""
    assert run_case(8, b"12345678") == b"12345678"


def test_batched_server_matches_direct(served_batched):
    cfg, model, addr = served_batched
    track = _track(9500, 7)
    via_server = enhance_via_server(addr, track, block=1700, timeout=WAIT)
    assert via_server.shape == track.shape
    np.testing.assert_allclose(via_server, _direct(cfg, model, track), atol=2e-5, rtol=1e-4)


def test_batched_server_concurrent_streams_match_direct(served_batched):
    """Three concurrent connections (the slot count) each reproduce their
    own solo output: slot isolation under real concurrency."""
    cfg, model, addr = served_batched
    tracks = {"a": _track(9500, 8), "b": _track(6200, 9, 0.05), "c": _track(12000, 10, 0.2)}
    results = _concurrently(addr, tracks, block=1300)
    for name, track in tracks.items():
        assert results[name].shape == track.shape
        np.testing.assert_allclose(results[name], _direct(cfg, model, track),
                                   atol=2e-5, rtol=1e-4, err_msg=name)


def test_batched_server_slot_reuse_across_serial_connections(served_batched):
    cfg, model, addr = served_batched
    for i in range(5):  # > 3 slots, one after another
        track = _track(4200, 20 + i)
        out = enhance_via_server(addr, track, block=2100, timeout=WAIT)
        np.testing.assert_allclose(out, _direct(cfg, model, track), atol=2e-5, rtol=1e-4)


def test_batched_worker_survives_step_failure(weights):
    """A failed tick aborts the in-flight sessions as truncated streams (EOF
    with no completion frame; enhance_via_server raises for one) and the
    worker keeps serving later connections."""
    cfg, model, _ = weights
    server = make_server(cfg, model, port=0, slots=2, device="cpu", **KW)
    thread = _serve(server)
    try:
        worker = server.worker
        orig = worker.batcher.step
        armed = {"on": True}

        def boom(blocks):
            if armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected device failure")
            return orig(blocks)

        worker.batcher.step = boom
        track = _track(4000, 3)
        with socket.create_connection(server.server_address, timeout=WAIT) as sock:
            send_frame(sock, track.astype("<f4").tobytes())  # 2 chunks
            frames = []
            while (f := recv_frame(sock)) is not None:
                frames.append(f)
        assert b"" not in frames  # no clean-completion frame after an abort
        assert worker.thread.is_alive()

        armed["on"] = True
        with pytest.raises(ConnectionError):
            enhance_via_server(server.server_address, track, block=1300, timeout=WAIT)

        # the worker keeps ticking: a fresh connection works end to end
        out = enhance_via_server(server.server_address, track, block=1300, timeout=WAIT)
        np.testing.assert_allclose(out, _direct(cfg, model, track), atol=2e-5, rtol=1e-4)
    finally:
        _stop(server, thread)


def test_feed_backpressure_bounds_pending(weights, monkeypatch):
    """A client uploading faster than the tick rate does not grow the
    host buffers: feed() blocks at MAX_PENDING_SAMPLES and the stream still
    completes exactly."""
    cfg, model, _ = weights
    chunk = KW["chunk"]
    cap = 3 * chunk
    monkeypatch.setattr(serve_mod, "MAX_PENDING_SAMPLES", cap)
    worker = BatcherWorker(cfg, model, num_slots=1, emit="wola", device="cpu", **KW)
    try:
        orig = worker.batcher.step

        def slow(blocks):
            time.sleep(0.05)  # the upload outruns the tick rate
            return orig(blocks)

        worker.batcher.step = slow
        sess = worker.open_session()
        track = _track(20 * chunk, 4)

        def feeder():
            for lo in range(0, track.size, chunk):
                sess.feed(track[lo : lo + chunk])
            sess.finish()

        t = threading.Thread(target=feeder, daemon=True)
        t.start()
        outs, max_pending = [], 0
        while (item := sess.out_q.get(timeout=WAIT)) is not _DONE:
            outs.append(item)
            with worker.cond:
                max_pending = max(max_pending, sess.pending.size)
        t.join(WAIT)
        assert not t.is_alive()
        assert max_pending <= cap
        est = np.concatenate(outs)
        assert est.size == track.size
        assert worker.ticks == 20 + 1  # the chunks, then one drain tick covers the lookahead
        np.testing.assert_allclose(est, _direct(cfg, model, track), atol=2e-5, rtol=1e-4)
    finally:
        worker.shutdown()
        assert not worker.thread.is_alive()


@pytest.mark.parametrize("slots", [0, 3])
def test_served_output_matches_the_jax_server(weights, slots):
    """The same track through the JAX package's server and the port's, on
    the same weights and chunks."""
    cfg, model, variables = weights
    jax_cfg = jcfg.CMGANConfig(model=jcfg.ModelConfig(**TINY, attention_impl="xla"))
    track = _track(9500, 30)
    ours_srv = make_server(cfg, model, port=0, slots=slots, device="cpu", **KW)
    jax_srv = jserve.make_server(jax_cfg, variables, port=0, slots=slots, **KW)
    threads = [_serve(ours_srv), _serve(jax_srv)]
    try:
        ours = enhance_via_server(ours_srv.server_address, track, block=1700, timeout=WAIT)
        ref = jserve.enhance_via_server(jax_srv.server_address, track, block=1700, timeout=WAIT)
    finally:
        _stop(ours_srv, threads[0])
        _stop(jax_srv, threads[1])
    assert ours.shape == ref.shape == track.shape
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)
