"""The port's data and sequence parallelism (`cmgan_torch.parallel`) on the
CPU: gloo process groups of 2 and 4 ranks in spawned processes (one pool
for the file), each held against the single-process port on the same
global batch, or against the JAX package's `Enhancer(mesh=...)`.

- A 2-rank data-parallel `Trainer.train_step` in each label mode.
- A D-skip forced by one rank's rows only, which skips on both ranks.
- `Enhancer.enhance_batch` split over 2 data ranks with an odd row count.
- JAX's sharded long-form enhancement case (tests/test_seq_parallel.py)
  at 4 seq ranks.
- A 'seq' Trainer at 2 x 2 data x seq: it constructs, steps and tests.
- The train CLI as torchrun starts it, over 2 ranks, each reading its
  data rank's shard.
- One epoch of 2 data ranks on train loaders sharded by data rank, in the
  host and device label modes, against one process fed both ranks' rows.
- The loaders of a 2 x 2 grid: the seq ranks of a data rank get its shard
  (the JAX loader's) bit for bit; a loader sharded for another mesh raises.

Dropout is off wherever two runs are compared (its streams differ).

Tolerances. A data-parallel step sums its losses and BatchNorm moments
per rank, then over ranks: float32 in another order. The first moments
of AdamW (0.1 x the gradient) as one vector a model: relative L2 1e-5.
Parameters: 1e-5 relative (to the entry, or to the tensor's largest
entry: p0 - lr lands near 0 for some) wherever the gradient is real
(|g| > 1e-6); an entry whose gradient is rounding noise around 0 (a conv bias in front
of an InstanceNorm) may step the other way, by up to 2 x lr. BatchNorm
running statistics: 1e-6. Losses: 1e-5 relative. The batches a loader yields: bit for bit (the same
files, crops and float32 casts). Enhanced audio: the
single-process rows to 1e-5 relative (eval mode: rows do not interact),
JAX's sharded pipeline to its own test's 5e-5 / 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as workers
from cmgan_tpu import config as jcfg
from cmgan_tpu.inference import Enhancer as JaxEnhancer
from cmgan_tpu.models import TSCNet as JaxTSCNet
from cmgan_torch import parallel
from cmgan_torch.config import CMGANConfig, DSPConfig, EvalConfig, MeshConfig, ModelConfig
from cmgan_torch.config import TrainConfig
from cmgan_torch.convert import state_dict_from_flax
from cmgan_tpu.data import dataset as jds
from cmgan_torch.data import write_wav
from cmgan_torch.data import dataset as tds
from cmgan_torch.inference import Enhancer, load_generator
from cmgan_torch.models import TSCNet
from cmgan_torch.train import Trainer, init_train_state

MODEL = dict(num_channels=16, num_tscb_blocks=2, dense_depth=2, attn_heads=1, ndf=4,
             attn_dropout=0.0, ff_dropout=0.0, disc_dropout=0.0, attention_impl="flash")
CUT, ROWS, SPE = 3200, 4, 10   # 33 frames, the global batch, steps per epoch
LR = TrainConfig().init_lr
MODES = ("host", "host_async", "device")
PAIR, QUAD = (0, 1), (0, 1, 2, 3)
# JAX's sharded long-form case: 4 kHz, n_fft 64, hop 16, a 4096-sample track (257 frames)
SEQ_DSP = dict(sample_rate=4000, n_fft=64, hop=16)
SEQ_MODEL = dict(num_channels=8, num_tscb_blocks=1, dense_depth=2, attn_heads=2, ndf=4)
# the 'seq' Trainer, as JAX's test_trainer_constructs_and_steps_with_seq_config
SEQ_TRAIN_MODEL = dict(num_channels=8, num_tscb_blocks=1, dense_depth=2, attn_heads=2,
                       attn_dropout=0.0, ff_dropout=0.0, disc_dropout=0.0)
SEQ_CUT = 4000   # 41 frames: rank 1's queries (offset 128) all lie past them


def _cfg(mode="host", mesh=MeshConfig(), model=MODEL, cut=CUT, dsp=DSPConfig()):
    return CMGANConfig(dsp=dsp, model=ModelConfig(**model), mesh=mesh,
                       train=dataclasses.replace(TrainConfig(), batch_size=ROWS, cut_len=cut,
                                                 pesq_label_mode=mode))


def _batch(seed=0, rows=ROWS, n=CUT, silent=None):
    rng = np.random.default_rng(seed)
    clean = (rng.standard_normal((rows, n)) * 0.1).astype(np.float32)
    noisy = clean + (rng.standard_normal((rows, n)) * 0.05).astype(np.float32)
    if silent is not None:   # a failed PESQ label
        clean[silent] = 0.0
    return clean, noisy


def _tracks():
    rng = np.random.default_rng(11)
    # bucketed to 1 s, 2 s and 1 s: groups of 2 and 1 rows, each padded to
    # batch_cap 3, then to 4 over 2 data ranks
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in (16000, 24000, 11200)]


def _jax_seq_case():
    dsp = jcfg.DSPConfig(**SEQ_DSP)
    base = jcfg.ModelConfig(**SEQ_MODEL, num_features=dsp.num_freqs, attention_impl="xla")
    track = (np.random.default_rng(0).standard_normal(4096) * 0.1).astype(np.float32)
    spec = jnp.zeros((1, dsp.num_frames(4096), dsp.num_freqs, 2), jnp.float32)
    variables = JaxTSCNet(base).init({"params": jax.random.key(0)}, spec)
    return dsp, base, track, variables


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("demand")
    rng = np.random.default_rng(0)
    for split, count in (("train", 4), ("test", 3)):
        for kind in ("clean", "noisy"):
            os.makedirs(root / split / kind)
        for i in range(count):
            clean = (0.1 * rng.standard_normal(5000)).astype(np.float32)
            noisy = clean + (0.03 * rng.standard_normal(5000)).astype(np.float32)
            write_wav(str(root / split / "clean" / f"p{i}.wav"), clean, 16000)
            write_wav(str(root / split / "noisy" / f"p{i}.wav"), noisy, 16000)
    return str(root)


def _cli_args(data_dir, save_dir):
    return ["--data_dir", data_dir, "--save_model_dir", save_dir, "--epochs", "1",
            "--batch_size", "1", "--cut_len", "1600", "--log_interval", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def ranked(data_dir, tmp_path_factory):
    """Every multi-rank case of this file in one pool of 4 processes; two
    2-rank cases run side by side where they can."""
    dp = MeshConfig(data_parallel=2)
    dsp, base, track, variables = _jax_seq_case()
    seq_sd = state_dict_from_flax(jax.tree.map(np.asarray, variables["params"]),
                                  jax.tree.map(np.asarray, variables["batch_stats"]),
                                  num_tscb=1, depth=2)
    seq_cfg = CMGANConfig(dsp=DSPConfig(**SEQ_DSP),
                          model=ModelConfig(**SEQ_MODEL, num_features=dsp.num_freqs,
                                            attention_impl="seq"),
                          eval=EvalConfig(cut_len=4000 * 16))
    small = CMGANConfig(model=ModelConfig(**dict(MODEL, num_tscb_blocks=1, attention_impl="auto")))
    cli_dir = str(tmp_path_factory.mktemp("cli"))
    cases = [
        ("enhance_seq4", QUAD, "enhance",
         dict(cfg=seq_cfg, state_dict=seq_sd, track=track, mode="exact", seq_parallel=4)),
        ("seq_trainer", QUAD, "train_step",
         dict(cfg=_cfg("host", MeshConfig(seq_parallel=2), SEQ_TRAIN_MODEL | {"attention_impl": "seq"},
                       SEQ_CUT, DSPConfig(dft_impl="matmul")),
              clean=_batch(5, n=SEQ_CUT)[0], noisy=_batch(5, n=SEQ_CUT)[1],
              steps_per_epoch=SPE, test=True)),
    ]
    side = [PAIR, (2, 3)]
    pairs = [(f"dp_{m}", "train_step", dict(cfg=_cfg(m, dp), clean=_batch()[0],
                                            noisy=_batch()[1], steps_per_epoch=SPE))
             for m in MODES]
    pairs += [(f"skip_{m}", "train_step",
               dict(cfg=_cfg(m, dp), clean=_batch(1, silent=3)[0],
                    noisy=_batch(1, silent=3)[1], steps_per_epoch=SPE))
              for m in ("host", "device")]
    pairs += [(f"local_{m}", "local_epoch", dict(cfg=_cfg(m, dp), data_dir=data_dir,
                                                batch_size=2))
              for m in ("host", "device")]
    pairs += [("enhance_batch", "enhance_batch",
               dict(cfg=small, state_dict=load_generator(small, None, device="cpu").state_dict(),
                    tracks=_tracks(), batch_cap=3, data_parallel=2)),
              ("cli", "train_cli", dict(argv=_cli_args(data_dir, cli_dir)))]
    cases += [(name, side[i % 2], fn, kw) for i, (name, fn, kw) in enumerate(pairs)]
    cases.append(("grid", QUAD, "grid_loaders",
                  dict(cfg=_cfg("host", MeshConfig(seq_parallel=2),
                                SEQ_TRAIN_MODEL | {"attention_impl": "seq"}, SEQ_CUT),
                       data_dir=data_dir, batch_size=1)))
    results = workers.run(cases)
    results["cli_dir"] = cli_dir
    return results


def _single_step(cfg, clean, noisy, test=False):
    trainer = Trainer(cfg, [None] * SPE,
                      workers.Batches([(clean[:-1], noisy[:-1])], clean.shape[0]) if test else None,
                      device="cpu")
    gen_loss, disc_loss = trainer.train_step(clean, noisy)
    if disc_loss is None:
        disc_loss = trainer.drain_pending_d()
    out = {"gen_loss": float(gen_loss), "disc_loss": float(disc_loss),
           **workers.step_state(trainer.state)}
    if test:
        out["test_loss"] = trainer.test()
    return out


def _rel_l2(a, b):
    """Relative L2 of the dicts' arrays as one vector (0 where both are 0:
    a skipped D update leaves its first moments at 0)."""
    a, b = (np.concatenate([x[k].ravel() for k in sorted(b)]) for x in (a, b))
    return np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0)


def _assert_same_step(got, ref):
    np.testing.assert_allclose(got["gen_loss"], ref["gen_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["disc_loss"], ref["disc_loss"], rtol=1e-5, atol=1e-12)
    for model in ("gen", "disc"):
        moments = ref[f"{model}_m"]
        assert sorted(got[f"{model}_m"]) == sorted(moments)
        if moments:
            assert _rel_l2(got[f"{model}_m"], moments) <= 1e-5, model
        for name, want in ref[model].items():
            have = got[model][name]
            if name in moments:
                assert np.abs(have - want).max() <= 2 * LR * 1.01, name
                real = np.abs(moments[name]) > 0.1 * 1e-6
                np.testing.assert_allclose(have[real], want[real], rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max(), err_msg=name)
            elif "running" in name:
                np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6, err_msg=name)
            else:   # spectral-norm u and sigma, BatchNorm's step count
                np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_data_parallel_step_matches_one_process(ranked, mode):
    ref = _single_step(_cfg(mode), *_batch())
    results = ranked[f"dp_{mode}"]
    assert [r["shape"] for r in results] == [{"data": 2, "seq": 1}] * 2
    moved = [n for n in ref["gen"] if "running_var" in n]
    assert moved and all(not np.array_equal(ref["gen"][n], np.ones_like(ref["gen"][n]))
                         for n in moved)
    assert ref["disc_m"], "the D step ran"
    for res in results:
        _assert_same_step(res, ref)
    for model in ("gen", "disc"):   # the ranks hold one state
        for name, a in results[0][model].items():
            np.testing.assert_array_equal(a, results[1][model][name], err_msg=name)
    # each data rank its own dropout stream, data rank 0 the single process's
    np.testing.assert_array_equal(results[0]["rng"], ref["rng"])
    assert not np.array_equal(results[1]["rng"], ref["rng"])


@pytest.mark.parametrize("mode", ("host", "device"))
def test_a_failed_label_on_one_rank_skips_the_d_step_on_both(ranked, mode):
    clean, noisy = _batch(1, silent=3)   # row 3 is data rank 1's
    fresh = init_train_state(_cfg(mode), 0, SPE, device="cpu")
    params = {n: p.detach().double().numpy() for n, p in fresh.disc.named_parameters()}
    ref = _single_step(_cfg(mode), clean, noisy)
    for res in (ref, *ranked[f"skip_{mode}"]):
        assert res["disc_loss"] == 0.0
        for name, p in params.items():
            np.testing.assert_array_equal(res["disc"][name], p, err_msg=name)
    # rank 0's own rows carry valid labels: the skip there is the global decision
    from cmgan_torch.train import pesq_labels_host

    assert pesq_labels_host(clean[:2], clean[:2]).min() >= 0.0
    for res in ranked[f"skip_{mode}"]:
        _assert_same_step(res, ref)


def test_enhance_batch_over_two_data_ranks(ranked):
    small = CMGANConfig(model=ModelConfig(**dict(MODEL, num_tscb_blocks=1, attention_impl="auto")))
    ref = Enhancer(small, None, device="cpu").enhance_batch(_tracks(), batch_cap=3)
    for res in ranked["enhance_batch"]:
        assert len(res["outs"]) == 3
        for got, want in zip(res["outs"], ref):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_seq_sharded_enhancer_matches_jax_sharded_enhancer(ranked):
    dsp, base, track, variables = _jax_seq_case()
    cfg = jcfg.CMGANConfig(dsp=dsp, model=dataclasses.replace(base, attention_impl="seq"),
                           eval=jcfg.EvalConfig(cut_len=4000 * 16))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "seq"))
    ref = JaxEnhancer(cfg, variables, mesh=mesh).enhance(track, mode="exact")
    for res in ranked["enhance_seq4"]:
        assert res["calls"] == 1   # one time conformer, through one rank's block
        assert res["out"].shape == track.shape
        np.testing.assert_allclose(res["out"], ref, atol=5e-5, rtol=1e-4)


def test_seq_trainer_constructs_steps_and_tests_on_a_2x2_grid(ranked):
    cfg = _cfg("host", MeshConfig(), SEQ_TRAIN_MODEL | {"attention_impl": "auto"}, SEQ_CUT,
               DSPConfig(dft_impl="matmul"))
    clean, noisy = _batch(5, n=SEQ_CUT)
    ref = _single_step(cfg, clean, noisy, test=True)
    results = ranked["seq_trainer"]
    assert [r["shape"] for r in results] == [{"data": 2, "seq": 2}] * 4
    for res in results:
        assert np.isfinite([res["gen_loss"], res["disc_loss"], res["test_loss"]]).all()
        np.testing.assert_allclose(res["test_loss"], ref["test_loss"], rtol=1e-5)
        _assert_same_step(res, ref)
    # ranks 2d and 2d + 1 hold data rank d's rows: one dropout stream
    assert [np.array_equal(results[i]["rng"], results[i + 1]["rng"]) for i in (0, 2)] == [True] * 2
    assert not np.array_equal(results[0]["rng"], results[2]["rng"])


def _shard_batches(data_dir, cut, rows, procs, index, package=tds):
    """One epoch of `package`'s train loader at process `index` of `procs`."""
    ds = package.DemandDataset(os.path.join(data_dir, "train"), cut)
    return list(package.BatchLoader(ds, rows, seed=TrainConfig().seed, num_processes=procs,
                                    process_index=index, prefetch=0))


def test_train_cli_under_torchrun(ranked, data_dir):
    """Each rank reads its data rank's shard (4 files over 2 ranks, a batch
    of 1: ceil(4 / 2) // 1 = 2 steps), the loader's rows go to the step as
    local rows, the two ranks' rows are disjoint, the generators equal."""
    results = ranked["cli"]
    for rank, res in enumerate(results):
        assert res["step"] == res["steps_per_epoch"] == 2 and res["batch_size"] == 2
        assert res["shape"] == {"data": 2, "seq": 1}
        assert res["loader"] == (2, rank, 1) and res["test_batch_size"] == 2
        assert res["local"] == [True, True]
        want = _shard_batches(data_dir, 1600, 1, 2, rank)
        assert len(res["batches"]) == len(want) == 2
        for got, (clean, _) in zip(res["batches"], want):
            np.testing.assert_array_equal(got, clean)
    for a, b in zip(results[0]["batches"], results[1]["batches"]):
        assert not any(np.array_equal(x, y) for x in a for y in b)
    shards = [set(tds.BatchLoader(tds.DemandDataset(os.path.join(data_dir, "train"), 1600), 1,
                                  num_processes=2, process_index=r)._epoch_indices())
              for r in (0, 1)]
    assert not shards[0] & shards[1] and len(shards[0] | shards[1]) == 4
    for name, a in results[0]["gen"].items():
        np.testing.assert_array_equal(a, results[1]["gen"][name], err_msg=name)
    names = os.listdir(ranked["cli_dir"])
    assert len(names) == 1 and names[0].startswith("CMGAN_epoch_0_")   # rank 0 wrote it


@pytest.mark.parametrize("mode", ("host", "device"))
def test_local_loader_epoch_matches_one_process(ranked, data_dir, mode):
    """Two data ranks, each on its data rank's shard of the 4 files (a batch
    of 2: one step), against one process fed rank 0's batch followed by
    rank 1's: the limits of _assert_same_step. (They hold for one step: a
    second compares states that the first step's noise entries have already
    split, and its BatchNorm statistics differ by ~4e-5.) The logged
    utterance count is the global batch's, 4."""
    results = ranked[f"local_{mode}"]
    for rank, res in enumerate(results):
        assert res["shape"] == {"data": 2, "seq": 1} and res["local_rows"]
        assert res["steps_per_epoch"] == 1 and res["local"] == [True]
        want = _shard_batches(data_dir, CUT, 2, 2, rank)
        assert len(res["batches"]) == len(want) == 1
        for (c1, n1), (c2, n2) in zip(res["batches"], want):
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(n1, n2)
        assert res["rates"] == [4.0]
    trainer = Trainer(_cfg(mode), [None], None, device="cpu")
    for (c0, n0), (c1, n1) in zip(results[0]["batches"], results[1]["batches"]):
        gen_loss, disc_loss = trainer.train_step(np.concatenate([c0, c1]), np.concatenate([n0, n1]))
    ref = {"gen_loss": float(gen_loss), "disc_loss": float(disc_loss),
           **workers.step_state(trainer.state)}
    for res in results:
        _assert_same_step(res, ref)


def test_seq_ranks_of_a_data_rank_get_its_shard(ranked, data_dir):
    """On a 2 x 2 grid, ranks 2d and 2d + 1 (data rank d) get the same
    batches, crops included, and they are the JAX BatchLoader's at
    process d of 2."""
    results = ranked["grid"]
    assert [(r["data_rank"], r["seq_rank"]) for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for d in (0, 1):
        want = _shard_batches(data_dir, SEQ_CUT, 1, 2, d, package=jds)
        for res in results[2 * d:2 * d + 2]:
            assert res["local_rows"] and len(res["batches"]) == len(want) == 2
            for (c1, n1), (c2, n2) in zip(res["batches"], want):
                np.testing.assert_array_equal(c1, c2)
                np.testing.assert_array_equal(n1, n2)
    assert not np.array_equal(results[0]["batches"][0][0], results[2]["batches"][0][0])


def test_a_loader_sharded_for_another_mesh_raises(ranked, data_dir):
    """On the 2 x 2 grid, a loader sharded by global rank over the world (4
    shards) and one of the other data rank both raise at construction on
    every rank; so does one sharded over 2 when the mesh has 2 data ranks
    but the shard is not this rank's, without any process group."""
    for res in ranked["grid"]:
        assert [e is not None and "fits neither" in e for e in res["errors"]] == [True, True]
    fake = parallel.Mesh(("data", "seq"), 2, 1, 1, 0, None, None, torch.device("cpu"))
    wrong = tds.BatchLoader(tds.DemandDataset(os.path.join(data_dir, "train"), CUT), 1,
                            num_processes=2, process_index=0)
    with pytest.raises(ValueError, match="process 0 of 2.*data rank 1 of 2"):
        Trainer(_cfg(), wrong, None, device="cpu", mesh=fake)


def test_freq_conformer_takes_auto_under_a_seq_config():
    """'seq' shards the time conformer only, as the JAX package does
    (cmgan_tpu/models/generator.py:131)."""
    model = TSCNet(ModelConfig(num_channels=16, num_tscb_blocks=2, attention_impl="seq"))
    for i in (1, 2):
        block = getattr(model, f"TSCB_{i}")
        assert block.time_conformer.attn.fn.attention_impl == "seq"
        assert block.freq_conformer.attn.fn.attention_impl == "auto"


def test_mesh_layout_and_its_errors():
    assert MeshConfig().layout(4) == (4, 1)
    assert MeshConfig(seq_parallel=2).layout(4) == (2, 2)
    assert MeshConfig(data_parallel=1, seq_parallel=4).layout(4) == (1, 4)
    for bad, world in ((MeshConfig(data_parallel=3), 4), (MeshConfig(seq_parallel=3), 4),
                       (MeshConfig(seq_parallel=8), 4)):
        with pytest.raises(ValueError, match="does not fill"):
            bad.layout(world)
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(MeshConfig(), "cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.init_from_env("cpu")
    fake = parallel.Mesh(("data", "seq"), 2, 1, 1, 0, None, None, torch.device("cpu"))
    assert parallel.shard_batch(fake, np.arange(6)).tolist() == [3, 4, 5]
    with pytest.raises(ValueError, match="split"):
        parallel.shard_batch(fake, np.arange(5))
