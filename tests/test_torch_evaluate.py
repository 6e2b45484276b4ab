"""The port's evaluate CLI on the CPU: the JAX package's flags plus
--device, the metric suite over a generated two-pair test directory at
the full published width, and the checkpoints --model_path takes; the
enhance CLI on the same checkpoints.

Tolerances: the CLI scores the enhanced tracks in float; it saves them as
16-bit PCM, so its aggregates equal the metrics of the saved tracks to
within the rounding to 16 bits: 1e-3 absolute (measured at most 1.5e-5,
on STOI). Loading a checkpoint is exact, and so is the enhance CLI's wav against
Enhancer's on the same weights (the same float32 path on the CPU, then the
same rounding to 16 bits): compared byte for byte.
"""

import json
import os

import numpy as np
import pytest
import torch

from cmgan_tpu.cli import evaluate as jax_cli
from cmgan_torch.checkpoint import save_train_state, save_variables
from cmgan_torch.cli import enhance as enhance_cli
from cmgan_torch.cli import evaluate as cli
from cmgan_torch.config import CMGANConfig
from cmgan_torch.data import read_wav, write_wav
from cmgan_torch.inference import Enhancer
from cmgan_torch.metrics import compute_metrics
from cmgan_torch.train import init_train_state

SR = 16000
KEYS = ("pesq", "csig", "cbak", "covl", "ssnr", "stoi")


@pytest.fixture(scope="module")
def test_dir(tmp_path_factory):
    """Two 1 s clean/noisy pairs: speech-like harmonics and white noise."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    for kind in ("clean", "noisy"):
        os.makedirs(root / kind)
    for i in range(2):
        f0 = rng.uniform(100, 220)
        clean = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6)) * 0.05
        clean = clean * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) + 0.02 * rng.standard_normal(SR)
        write_wav(str(root / "clean" / f"p{i}.wav"), clean.astype(np.float32), SR)
        write_wav(str(root / "noisy" / f"p{i}.wav"),
                  (clean + 0.03 * rng.standard_normal(SR)).astype(np.float32), SR)
    return str(root)


def test_flags_are_the_jax_packages():
    ours = vars(cli.parse_args(["--test_dir", "x"]))
    theirs = vars(jax_cli.parse_args(["--test_dir", "x"]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs


def test_evaluates_a_test_dir_on_the_cpu(test_dir, tmp_path, capsys):
    save = tmp_path / "tracks"
    result = cli.main(["--device", "cpu", "--json", "--test_dir", test_dir, "--save_tracks",
                       "--save_dir", str(save)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result and result["tracks"] == 2
    assert all(np.isfinite(result[k]) for k in (*KEYS, "realtime_factor",
                                                "enhance_realtime_factor"))
    assert set(os.listdir(save)) == {"p0.wav", "p1.wav"}
    per_track = []
    for name in ("p0.wav", "p1.wav"):
        clean, _ = read_wav(os.path.join(test_dir, "clean", name))
        est, sr = read_wav(str(save / name))
        assert sr == SR and est.shape == clean.shape
        per_track.append(compute_metrics(clean[0].astype(np.float64), est[0], SR))
    np.testing.assert_allclose([result[k] for k in KEYS], np.mean(per_track, axis=0),
                               atol=1e-3, rtol=0)


def test_model_path_takes_a_train_state_or_a_generator_file(tmp_path):
    state = init_train_state(CMGANConfig(), seed=3, steps_per_epoch=1, device="cpu")
    want = state.gen.state_dict()
    save_train_state(str(tmp_path / "full_state"), state)
    save_variables(str(tmp_path / "gen_ema"), want)
    torch.save(want, tmp_path / "generator.pt")
    for flag, name in (("--model_path", "full_state"), ("--model_path", "gen_ema"),
                       ("--torch_ckpt", "generator.pt")):
        got = cli.load_state_dict(cli.parse_args(["--test_dir", "x", flag, str(tmp_path / name)]))
        assert set(got) == set(want), name
        assert all(torch.equal(got[k], want[k]) for k in want), name
    assert cli.load_state_dict(cli.parse_args(["--test_dir", "x"])) is None   # seeded init


def test_exact_mode_and_the_model_path_reach_the_enhancer(test_dir, tmp_path, monkeypatch):
    """--exact enhances track by track in exact mode; --bf16 asks for bfloat16;
    --model_path's weights are the enhancer's."""
    state = init_train_state(CMGANConfig(), seed=4, steps_per_epoch=1, device="cpu")
    save_train_state(str(tmp_path / "ckpt"), state)
    seen = {}

    class Spy(Enhancer):
        def __init__(self, cfg, state_dict, dtype, device):
            seen.update(state_dict=state_dict, dtype=dtype, device=device,
                        cut_len=cfg.eval.cut_len)
            super().__init__(cfg, state_dict, dtype=torch.float32, device=device)

        def enhance(self, noisy, mode="bucket"):
            seen.setdefault("modes", []).append(mode)
            return super().enhance(noisy, mode)

    monkeypatch.setattr("cmgan_torch.inference.Enhancer", Spy)
    result = cli.main(["--device", "cpu", "--test_dir", test_dir, "--exact", "--limit", "1",
                       "--bf16", "--chunk_seconds", "2", "--model_path", str(tmp_path / "ckpt")])
    assert result["tracks"] == 1 and seen["modes"] == ["exact"]
    assert seen["dtype"] == torch.bfloat16 and seen["device"] == "cpu"
    assert seen["cut_len"] == 2 * SR
    assert all(torch.equal(seen["state_dict"][k], v) for k, v in state.gen.state_dict().items())


@pytest.mark.parametrize("kind", ["train_state", "variables", "none"])
def test_enhance_cli_reads_the_ports_checkpoints(test_dir, tmp_path, kind):
    """cli.enhance --model_path on a file of save_train_state and on one of
    save_variables (the _ema kind) writes what Enhancer writes on the
    generator's state_dict; with no checkpoint, the seeded random init."""
    state = init_train_state(CMGANConfig(), seed=5, steps_per_epoch=1, device="cpu")
    weights = state.gen.state_dict()
    flags = []
    if kind == "train_state":
        save_train_state(str(tmp_path / "ckpt"), state)
        flags = ["--model_path", str(tmp_path / "ckpt")]
    elif kind == "variables":
        save_variables(str(tmp_path / "ckpt_ema"), weights)
        flags = ["--model_path", str(tmp_path / "ckpt_ema")]
    else:
        weights = None
    noisy_path = os.path.join(test_dir, "noisy", "p0.wav")
    enhance_cli.main(["--input", noisy_path, "--output", str(tmp_path / "cli.wav"),
                      "--device", "cpu", *flags])
    noisy, sr = read_wav(noisy_path)
    want = Enhancer(CMGANConfig(), weights, device="cpu").enhance(noisy[0], mode="bucket")
    write_wav(str(tmp_path / "enhancer.wav"), want, sr)
    assert (tmp_path / "cli.wav").read_bytes() == (tmp_path / "enhancer.wav").read_bytes()
