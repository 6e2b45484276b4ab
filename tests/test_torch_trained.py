"""The port against the JAX package with trained weights, and the files
that carry those weights and the JAX package's outputs to a host without
JAX (tests/trained_golden.py says what each file holds).

tests/torch_data/r05_fold1_ema/ holds:
- generator.pt: the committed fold-1 EMA generator
  (reports/trained_generator_r05_fold1_ema), written by the JAX package's
  save_torch_generator in the CMGAN reference layout, which the port loads
  with strict=True;
- golden_4s.npz: `noisy`, a seeded 4 s synthetic track, and the JAX
  package's Enhancer output for it in bucket mode (641 frames) with
  attention_impl='xla', `enhanced_fp32` and `enhanced_bf16`;
- golden_stream.npz: the JAX package's StreamBatcher (2 slots) on two
  seeded tracks at the default window and the long-context one;
- golden_gstep.npz: one G step of the JAX package at cut_len 64000 from
  the trained generator: its losses and its gradients' norms, sketches and
  attention leaves.

chip_smoke.py [20] reads them on the GPU, where there is no JAX. Rebuild
them (JAX needed, on the CPU; the G step at batch 2 takes minutes and
about 33 GB of host memory) with

    python tests/test_torch_trained.py --write [generator golden_4s golden_stream golden_gstep]

(all four when no name is given). The JAX side runs attention_impl='xla'
in float32, with dropout 0 in the G step.

Tolerances, relative L2: a fresh JAX run 1e-5 of the stored output (the
same program on the same CPU; float32 sums whose order the thread count
may change); the port's CPU Enhancer and StreamBatcher 2e-4, the
generator parity test_torch_models.py holds (fp32 sums of two libraries in
another order, through 4 conformer blocks and both decoders).

Time: a full-width streaming tick (2 windows of 361 frames) takes about
22 s on one CPU thread, so the port's streams are held here over their
first PREFIX_TICKS ticks (a slot's output at a tick depends only on the
chunks it has been fed); chip_smoke.py [20] holds every tick of both
windows on the GPU, and the G step too. The fresh JAX runs of the stream
and G-step goldens take minutes and are marked slow.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)
from trained_golden import (
    ATTENTION_LEAVES, CHUNK, DATA, DISC_SEED, GENERATOR, GOLDEN, GSTEP, GSTEP_BATCH, GSTEP_CUT,
    GSTEP_SEED, LEFT_CONTEXTS, LOOKAHEAD, OPEN_TICKS, SKETCH, SKETCH_SEED, SLOTS, STREAM,
    gradient_errors, gstep_batch, load, run_stream, seeded_disc, shape_text, sketch,
    stream_tracks, synthetic_track,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CKPT = os.path.join(ROOT, "reports", "trained_generator_r05_fold1_ema")
SR, SECONDS, SEED = 16000, 4, 20
JAX_RERUN_REL = 1e-5
PORT_REL = 2e-4
GRAD_RERUN_REL = 1e-4
PREFIX_TICKS = 2
GOLDEN_BYTES = 2_000_000   # golden_stream.npz and golden_gstep.npz together
LOSS_TERMS = ("loss", "loss_ri", "loss_mag", "loss_time", "loss_gan")


def jax_enhance(variables, noisy, dtype=None):
    """The JAX package's Enhancer in bucket mode, attention_impl='xla'."""
    from cmgan_tpu.config import CMGANConfig, ModelConfig
    from cmgan_tpu.inference import Enhancer

    cfg = CMGANConfig(model=ModelConfig(attention_impl="xla"))
    return Enhancer(cfg, variables, dtype=dtype).enhance(noisy, mode="bucket")


def jax_stream(variables, left_context: int):
    """The JAX package's StreamBatcher, 'xla', fp32, on the golden's tracks."""
    from cmgan_tpu.config import CMGANConfig, ModelConfig
    from cmgan_tpu.streaming import StreamBatcher

    cfg = CMGANConfig(model=ModelConfig(attention_impl="xla"))
    batcher = StreamBatcher(cfg, variables, num_slots=SLOTS, chunk=CHUNK,
                            left_context=left_context, lookahead=LOOKAHEAD)
    return run_stream(batcher, stream_tracks(), OPEN_TICKS)


def stream_arrays(variables) -> dict:
    arrays = {f"track_{i}": t for i, t in enumerate(stream_tracks())}
    arrays.update(open_ticks=np.asarray(OPEN_TICKS), left_contexts=np.asarray(LEFT_CONTEXTS),
                  chunk=np.asarray(CHUNK), lookahead=np.asarray(LOOKAHEAD))
    for lc in LEFT_CONTEXTS:
        for i, ticks in enumerate(jax_stream(variables, lc)):
            arrays[f"out_{lc}_{i}"] = np.concatenate(ticks)
            arrays[f"emitted_{lc}_{i}"] = np.asarray([t.size for t in ticks])
    return arrays


def port_parameter_names():
    from cmgan_torch.config import ModelConfig
    from cmgan_torch.models import TSCNet

    return [n for n, _ in TSCNet(ModelConfig()).named_parameters()]


def jax_gstep_config():
    import dataclasses

    from cmgan_tpu.config import CMGANConfig, ModelConfig, TrainConfig

    # remat: the same gradient in less memory (each block's forward is recomputed)
    return CMGANConfig(
        model=ModelConfig(attention_impl="xla", attn_dropout=0.0, ff_dropout=0.0,
                          disc_dropout=0.0, remat=True),
        train=dataclasses.replace(TrainConfig(), batch_size=GSTEP_BATCH, cut_len=GSTEP_CUT))


def disc_layout(cfg):
    """The names ("collection:module:leaf") and shapes of the JAX
    discriminator's variables, in a fixed order."""
    import jax

    from cmgan_tpu.train import init_train_state

    state = init_train_state(cfg, 0, 10)
    names, shapes = [], []
    for collection, tree in (("params", state.disc_params), ("batch_stats", state.disc_stats)):
        for module in sorted(tree):
            for leaf in sorted(tree[module]):
                names.append(f"{collection}:{module}:{leaf}")
                shapes.append(shape_text(np.shape(jax.device_get(tree[module][leaf]))))
    return names, shapes


def gstep_arrays(variables) -> dict:
    """One G step of the JAX package from the trained generator, composed
    of its own step's pieces (_generator_forward, _generator_loss) under
    jax.value_and_grad, as its g_step composes them."""
    import jax
    import jax.numpy as jnp

    from cmgan_tpu.models import MetricDiscriminator, TSCNet
    from cmgan_tpu.train import steps as jsteps
    from cmgan_torch.convert import state_dict_from_flax

    cfg = jax_gstep_config()
    names, shapes = disc_layout(cfg)
    disc_params, disc_stats = seeded_disc(names, shapes, DISC_SEED)
    clean, noisy = gstep_batch()
    gen, disc = TSCNet(cfg.model), MetricDiscriminator(cfg.model)
    key = jax.random.key(0)   # dropout 0: the key draws nothing

    def loss_fn(params):
        out = jsteps._generator_forward(
            gen, {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(clean), jnp.asarray(noisy), cfg, train=True, dropout_rng=key)
        target = out["clean_audio_n"] if cfg.train.time_loss_domain == "normalized" else clean
        total, _, parts, _ = jsteps._generator_loss(
            disc, {"params": disc_params, "batch_stats": disc_stats}, out, jnp.asarray(target),
            cfg.train.loss_weights, train=True, dropout_rng=key)
        return total, parts

    (loss, parts), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    port = state_dict_from_flax(jax.tree.map(np.asarray, grads),
                                jax.tree.map(np.asarray, variables["batch_stats"]))
    grad_names = port_parameter_names()
    g = [port[n].numpy().astype(np.float64) for n in grad_names]
    arrays = dict(
        cut_len=np.asarray(GSTEP_CUT), batch=np.asarray(GSTEP_BATCH),
        batch_seed=np.asarray(GSTEP_SEED), disc_seed=np.asarray(DISC_SEED),
        sketch_seed=np.asarray(SKETCH_SEED),
        batch_sumsq=np.asarray([np.sum(np.square(clean, dtype=np.float64)),
                                np.sum(np.square(noisy, dtype=np.float64))]),
        disc_names=np.asarray(names), disc_shapes=np.asarray(shapes),
        loss=np.asarray(float(loss), np.float64), grad_names=np.asarray(grad_names),
        grad_norms=np.asarray([np.linalg.norm(x) for x in g]),
        grad_sketch=np.stack([sketch(i, x) for i, x in enumerate(g)]),
    )
    arrays.update({k: np.asarray(float(v), np.float64) for k, v in parts.items()})
    arrays.update({f"grad:{n}": port[n].numpy() for n in ATTENTION_LEAVES})
    return arrays


def write(names):
    """Write the named files (generator, golden_4s, golden_stream,
    golden_gstep) from the committed checkpoint."""
    import jax.numpy as jnp

    from cmgan_tpu.checkpoint import restore_variables
    from cmgan_tpu.checkpoint.torch_import import save_torch_generator

    variables = restore_variables(CKPT)
    os.makedirs(DATA, exist_ok=True)
    if "generator" in names:
        save_torch_generator(GENERATOR, variables)
    if "golden_4s" in names:
        noisy = synthetic_track(SECONDS * SR, SEED)
        np.savez(GOLDEN, noisy=noisy, enhanced_fp32=jax_enhance(variables, noisy),
                 enhanced_bf16=jax_enhance(variables, noisy, jnp.bfloat16))
    if "golden_stream" in names:
        np.savez(STREAM, **stream_arrays(variables))
    if "golden_gstep" in names:
        np.savez(GSTEP, **gstep_arrays(variables))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def variables():
    from cmgan_tpu.checkpoint import restore_variables

    return restore_variables(CKPT)


@pytest.fixture(scope="module")
def golden():
    return load(GOLDEN)


@pytest.fixture(scope="module")
def stream_golden():
    return load(STREAM)


@pytest.fixture(scope="module")
def gstep_golden():
    return load(GSTEP)


def test_generator_file_is_the_checkpoint(variables, tmp_path):
    """generator.pt is save_torch_generator of the checkpoint, tensor by
    tensor and bitwise, and loads into the port with strict=True."""
    from cmgan_tpu.checkpoint.torch_import import save_torch_generator
    from cmgan_torch.config import ModelConfig
    from cmgan_torch.models import TSCNet

    fresh = tmp_path / "generator.pt"
    save_torch_generator(str(fresh), variables)
    want = torch.load(fresh, weights_only=True)
    got = torch.load(GENERATOR, weights_only=True)
    assert list(got) == list(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    TSCNet(ModelConfig()).load_state_dict(got, strict=True)


def test_golden_is_the_jax_package_output(variables, golden):
    noisy = golden["noisy"]
    np.testing.assert_array_equal(noisy, synthetic_track(SECONDS * SR, SEED))
    out = jax_enhance(variables, noisy)
    assert out.shape == noisy.shape and golden["enhanced_bf16"].shape == noisy.shape
    assert rel_l2(out, golden["enhanced_fp32"]) <= JAX_RERUN_REL


def test_port_matches_the_jax_package_with_trained_weights(golden):
    """The port's Enhancer on the CPU (the kernels' plain versions) from
    generator.pt against the JAX package's output."""
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.inference import Enhancer

    sd = torch.load(GENERATOR, weights_only=True)
    out = Enhancer(CMGANConfig(), sd, device="cpu").enhance(golden["noisy"], mode="bucket")
    assert out.shape == golden["noisy"].shape and np.all(np.isfinite(out))
    assert rel_l2(out, golden["enhanced_fp32"]) <= PORT_REL


def test_stream_golden_holds_its_keys_shapes_and_dtypes(stream_golden):
    g = stream_golden
    assert os.path.getsize(STREAM) + os.path.getsize(GSTEP) <= GOLDEN_BYTES
    tracks = stream_tracks()
    for i, track in enumerate(tracks):
        np.testing.assert_array_equal(g[f"track_{i}"], track)
    assert g["open_ticks"].tolist() == list(OPEN_TICKS)
    assert g["left_contexts"].tolist() == list(LEFT_CONTEXTS)
    assert (int(g["chunk"]), int(g["lookahead"])) == (CHUNK, LOOKAHEAD)
    drain = -(-LOOKAHEAD // CHUNK) + 1
    for lc in LEFT_CONTEXTS:
        for i, track in enumerate(tracks):
            out, emitted = g[f"out_{lc}_{i}"], g[f"emitted_{lc}_{i}"]
            ticks = -(-track.size // CHUNK) + drain
            assert out.dtype == np.float32 and emitted.shape == (ticks,)
            # the first tick withholds the lookahead, every later one emits a chunk
            assert emitted.tolist() == [CHUNK - LOOKAHEAD] + [CHUNK] * (ticks - 1)
            assert out.shape == (emitted.sum(),) and np.all(np.isfinite(out))
            assert np.sqrt(np.mean(out[:track.size] ** 2)) > 1e-3


def test_gstep_golden_holds_its_keys_shapes_and_dtypes(gstep_golden):
    from cmgan_torch.config import ModelConfig
    from cmgan_torch.convert import disc_state_dict_from_flax
    from cmgan_torch.models import MetricDiscriminator

    g = gstep_golden
    assert (int(g["cut_len"]), int(g["batch"])) == (GSTEP_CUT, GSTEP_BATCH)
    assert (int(g["batch_seed"]), int(g["disc_seed"]), int(g["sketch_seed"])) == (
        GSTEP_SEED, DISC_SEED, SKETCH_SEED)
    clean, noisy = gstep_batch()
    assert clean.shape == noisy.shape == (GSTEP_BATCH, GSTEP_CUT)
    np.testing.assert_allclose(g["batch_sumsq"], [np.sum(np.square(clean, dtype=np.float64)),
                                                  np.sum(np.square(noisy, dtype=np.float64))],
                               rtol=1e-9)
    for k in LOSS_TERMS:
        assert g[k].dtype == np.float64 and g[k].shape == () and np.isfinite(g[k]), k
    names = port_parameter_names()
    assert g["grad_names"].tolist() == names
    assert g["grad_norms"].shape == (len(names),) and np.all(np.isfinite(g["grad_norms"]))
    assert g["grad_sketch"].shape == (len(names), SKETCH)
    for name in ATTENTION_LEAVES:
        whole = g[f"grad:{name}"]
        index = names.index(name)
        assert whole.dtype == np.float32 and np.linalg.norm(whole) > 0, name
        # the sketch here is the sketch the golden was written with
        np.testing.assert_allclose(sketch(index, whole), g["grad_sketch"][index],
                                   rtol=1e-12, atol=1e-12 * np.abs(whole).sum(), err_msg=name)
        np.testing.assert_allclose(np.linalg.norm(whole.astype(np.float64)),
                                   g["grad_norms"][index], rtol=1e-6, err_msg=name)
    # the discriminator made from its seed loads into the port, as chip_smoke.py loads it
    params, stats = seeded_disc(g["disc_names"], g["disc_shapes"], int(g["disc_seed"]))
    MetricDiscriminator(ModelConfig()).load_state_dict(
        disc_state_dict_from_flax(params, stats), strict=True)


def test_gradient_errors_measure_a_known_distance():
    """gradient_errors on a golden written from known gradients: the
    sketched distances of a perturbed copy within the sketch's spread of
    the true ones, and exact for whole leaves."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 64), "b": (300,), "c": (5,), ATTENTION_LEAVES[0]: (64, 64)}
    want = {n: rng.standard_normal(s) for n, s in shapes.items()}
    golden = {"grad_names": np.asarray(list(want)),
              "grad_norms": np.asarray([np.linalg.norm(x) for x in want.values()]),
              "grad_sketch": np.stack([sketch(i, x) for i, x in enumerate(want.values())]),
              "sketch_seed": np.asarray(SKETCH_SEED),
              f"grad:{ATTENTION_LEAVES[0]}": want[ATTENTION_LEAVES[0]]}
    got = {n: x * (1 + 0.01 * rng.standard_normal(x.shape)) for n, x in want.items()}
    whole, per = gradient_errors(golden, got)
    true = {n: np.linalg.norm(got[n] - want[n]) / np.linalg.norm(want[n]) for n in want}
    assert per[ATTENTION_LEAVES[0]] == pytest.approx(true[ATTENTION_LEAVES[0]], rel=1e-9)
    assert per["c"] == pytest.approx(true["c"], rel=1e-9)
    for n in ("a", "b"):
        assert 0.5 * true[n] <= per[n] <= 1.5 * true[n], (n, per[n], true[n])
    assert 0.005 <= whole <= 0.015
    assert gradient_errors(golden, want)[0] == 0.0
    with pytest.raises(ValueError):
        gradient_errors(golden, {"a": want["a"]})


def test_port_stream_matches_the_jax_package_with_trained_weights(stream_golden):
    """The port's StreamBatcher on the CPU from generator.pt at the default
    window (361 frames, dense attention), both slots over the first
    PREFIX_TICKS ticks as the golden opened them, against the JAX package's
    emissions."""
    from cmgan_torch.config import CMGANConfig
    from cmgan_torch.streaming import StreamBatcher

    sd = torch.load(GENERATOR, weights_only=True)
    lc = LEFT_CONTEXTS[0]
    batcher = StreamBatcher(CMGANConfig(), sd, num_slots=SLOTS, chunk=CHUNK, left_context=lc,
                            lookahead=LOOKAHEAD, device="cpu")
    emitted = run_stream(batcher, stream_tracks(), OPEN_TICKS, ticks=PREFIX_TICKS)
    for i, ticks in enumerate(emitted):
        assert len(ticks) == PREFIX_TICKS - OPEN_TICKS[i] > 0
        assert [t.size for t in ticks] == stream_golden[f"emitted_{lc}_{i}"][:len(ticks)].tolist()
        got = np.concatenate(ticks)
        assert np.all(np.isfinite(got))
        assert rel_l2(got, stream_golden[f"out_{lc}_{i}"][:got.size]) <= PORT_REL, i


@pytest.mark.slow  # two windows of the JAX package's streams at full width: minutes
def test_stream_golden_is_the_jax_package_output(variables, stream_golden):
    for lc in LEFT_CONTEXTS:
        for i, ticks in enumerate(jax_stream(variables, lc)):
            assert [t.size for t in ticks] == stream_golden[f"emitted_{lc}_{i}"].tolist()
            assert rel_l2(np.concatenate(ticks), stream_golden[f"out_{lc}_{i}"]) <= JAX_RERUN_REL


@pytest.mark.slow  # the JAX package's G step at full width and 641 frames: minutes
def test_gstep_golden_is_the_jax_package_output(variables, gstep_golden):
    """A fresh JAX G step against the stored one: the losses within
    JAX_RERUN_REL; the gradients, whose float32 sums over a deep net another
    thread count may reorder, within GRAD_RERUN_REL a parameter (sketched
    distance over its norm) and as one vector."""
    fresh, g = gstep_arrays(variables), gstep_golden
    for k in LOSS_TERMS:
        assert abs(fresh[k] - g[k]) <= JAX_RERUN_REL * abs(g[k]), k
    norms = g["grad_norms"]
    dist = np.linalg.norm(fresh["grad_sketch"] - g["grad_sketch"], axis=1)
    names = g["grad_names"].tolist()
    for n in ATTENTION_LEAVES:
        dist[names.index(n)] = np.linalg.norm(fresh[f"grad:{n}"] - g[f"grad:{n}"])
    assert np.linalg.norm(dist) <= GRAD_RERUN_REL * np.linalg.norm(norms)
    assert np.all(dist <= GRAD_RERUN_REL * np.maximum(norms, 1e-2 * norms.max()))


if __name__ == "__main__":
    files = ("generator", "golden_4s", "golden_stream", "golden_gstep")
    if sys.argv[1:2] != ["--write"] or not set(sys.argv[2:]) <= set(files):
        sys.exit(f"usage: python {os.path.relpath(__file__)} --write [{' '.join(files)}]")
    sys.path.insert(0, ROOT)
    chosen = sys.argv[2:] or list(files)
    write(chosen)
    print(f"wrote {', '.join(chosen)} in {os.path.relpath(DATA, ROOT)}")
