"""The port's profiling utilities (`cmgan_torch.utils`) against the JAX
package's (`cmgan_tpu.utils`), and the trainer's JSONL metrics stream
(`Trainer(metrics_path=...)`) against the JAX trainer's, on the CPU.

StepTimer and MetricsLogger are the JAX package's, case for case as
tests/test_utils.py holds them. `trace` writes a Chrome trace of the CPU's
ops here (on the GPU it also records the kernels). The trainers' records
are compared by their keys, steps and epochs: their losses come from
models of different weights.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from cmgan_tpu import config as jcfg
from cmgan_tpu.train import Trainer as JaxTrainer
from cmgan_tpu.utils import MetricsLogger as JaxMetricsLogger
from cmgan_torch import config as tcfg
from cmgan_torch.train import Trainer
from cmgan_torch.utils import MetricsLogger, StepTimer, annotate, trace
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

MODEL = dict(num_channels=16, num_tscb_blocks=1, dense_depth=2, attn_heads=2, ndf=4)
BATCH, CUT = 8, 4000


def test_step_timer():
    t = StepTimer(window=4)
    assert t.tick() == 0.0 and t.steps_per_second() == 0.0
    for _ in range(3):
        time.sleep(0.01)
        t.tick()
    assert 0.005 < t.mean_step_seconds < 0.2
    assert t.steps_per_second() > 5


def test_metrics_logger_writes_the_jax_packages_records(tmp_path):
    files = {}
    for name, cls in (("ours", MetricsLogger), ("theirs", JaxMetricsLogger)):
        path = str(tmp_path / name / "m.jsonl")
        logger = cls(path)
        logger.log(1, loss=0.5, note="a", count=np.int64(3))
        logger.log(2, loss=torch.tensor(0.25))
        logger.close()
        files[name] = [json.loads(line) for line in open(path)]
    for ours, theirs in zip(*files.values()):
        assert ours.pop("time") <= time.time()
        theirs.pop("time")
        assert ours == theirs
    assert files["ours"][0] == {"step": 1, "loss": 0.5, "note": "a", "count": 3.0}
    assert files["ours"][1] == {"step": 2, "loss": 0.25}


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as prof:
        with annotate("cmgan_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = os.listdir(logdir)
    assert len(names) == 1 and names[0].endswith(".json")
    with open(os.path.join(logdir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "cmgan_step" for e in events)
    assert any(e.key == "cmgan_step" for e in prof.key_averages())


class _Batches:
    """Three seeded batches, the loader interface both trainers iterate."""

    def __init__(self):
        rng = np.random.default_rng(0)
        clean = (0.1 * rng.standard_normal((3, BATCH, CUT))).astype(np.float32)
        self.batches = [(c, c + (0.05 * rng.standard_normal(c.shape)).astype(np.float32))
                        for c in clean]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _train(make, cfg_module, mode, path):
    cfg = cfg_module.CMGANConfig(
        model=cfg_module.ModelConfig(**MODEL),
        train=dataclasses.replace(cfg_module.TrainConfig(), batch_size=BATCH, cut_len=CUT,
                                  pesq_label_mode=mode, log_interval=2),
    )
    trainer = make(cfg, _Batches(), metrics_path=path)
    trainer.train_epoch(0)
    trainer.metrics_logger.close()
    return trainer


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax") / "metrics.jsonl")
    _train(lambda cfg, loader, **kw: JaxTrainer(cfg, loader, **kw), jcfg, "host", path)
    return _records(path)


@pytest.mark.parametrize("mode", ["host", "host_async"])
def test_trainer_metrics_path_writes_the_jax_trainers_records(tmp_path, jax_records, mode):
    """One record a completed step, written where the loop reads the losses
    back (log_interval 2: steps 1-2, then 3 at the epoch's end; in
    host_async step 2's D loss arrives with step 3, so the first flush
    writes step 1 only), with the JAX trainer's keys."""
    path = str(tmp_path / "metrics.jsonl")
    trainer = _train(lambda cfg, loader, **kw: Trainer(cfg, loader, device="cpu", **kw),
                     tcfg, mode, path)
    ours = _records(path)
    assert trainer.state.step == 3
    assert [(r["step"], r["epoch"]) for r in ours] == [(r["step"], r["epoch"])
                                                       for r in jax_records] == [(1, 0), (2, 0),
                                                                                 (3, 0)]
    for r, j in zip(ours, jax_records):
        assert set(r) == set(j) == {"step", "time", "epoch", "gen_loss", "disc_loss",
                                    "step_seconds"}
        assert np.isfinite(r["gen_loss"]) and r["disc_loss"] >= 0 and r["step_seconds"] > 0
