"""Training orchestration: the GAN epoch loop on one device.

Same loop structure as the JAX package's Trainer (and the CMGAN
reference's): loss weights, LR schedule, per-epoch test pass and
checkpointing, with full-state checkpoints that resume, and the JAX
package's JSONL metrics stream (`metrics_path`). More than one device is
not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from cmgan_torch.checkpoint import (
    restore_train_state,
    restore_variables,
    save_train_state,
    save_variables,
)
from cmgan_torch.config import CMGANConfig
from cmgan_torch.data.dataset import BatchLoader
from cmgan_torch.train.state import TrainState, check_supported, init_train_state
from cmgan_torch.train.steps import make_train_steps, pesq_labels_host
from cmgan_torch.utils import MetricsLogger

log = logging.getLogger("cmgan_torch.train")


class Trainer:
    """dtype: compute type of the models' convs and linears (None:
    float32). The default device is the GPU; without CUDA pass
    device="cpu" explicitly (the CPU runs the kernels' plain versions).
    metrics_path: a JSONL file that gets one record a completed step
    (`step`, `time`, `epoch`, `gen_loss`, `disc_loss`, `step_seconds`),
    written where the loop reads the losses back (every log_interval
    steps and at the epoch's end), as in the JAX package."""

    def __init__(
        self,
        cfg: CMGANConfig,
        train_loader: BatchLoader,
        test_loader: Optional[BatchLoader] = None,
        dtype: torch.dtype | None = None,
        device="cuda",
        state: Optional[TrainState] = None,
        metrics_path: Optional[str] = None,
    ):
        check_supported(cfg)
        self.cfg = cfg
        self.metrics_logger = MetricsLogger(metrics_path) if metrics_path else None
        self.train_loader = train_loader
        self.test_loader = test_loader
        steps_per_epoch = max(len(train_loader), 1)
        (self.g_step, self.d_step, self.test_fwd, self.test_disc_loss,
         self.fused_step) = make_train_steps(cfg, steps_per_epoch)
        if state is None:
            state = init_train_state(cfg, cfg.train.seed, steps_per_epoch, dtype=dtype,
                                     device=device)
        self.state = state
        self.ema_params = None
        if cfg.train.gen_ema_decay > 0.0:
            self._seed_ema(self.state.gen.state_dict())
        self._label_pool = None
        self._pending_d = None  # (handoff, scores_future, step) in host_async mode
        if cfg.train.pesq_label_mode == "host_async":
            # one worker keeps label batches ordered; its only job is the
            # est_audio device fetch + the C++ PESQ batch
            self._label_pool = ThreadPoolExecutor(max_workers=1)

    # ------------------------------------------------------------------
    def train_step(self, clean: np.ndarray, noisy: np.ndarray):
        """One GAN step; returns (gen_loss, disc_loss) as 0-d DEVICE
        tensors (not fetched: callers decide when to sync).

        pesq_label_mode='host': the G phase, the native CPU scorer, the D
        phase, in that order. 'device': one fused step with the labels
        computed on the device; nothing is read back to the host, so steps
        queue up on the device and the loop blocks only where it fetches
        losses (every log_interval steps). 'host_async': the same scorer
        runs in a background thread while the device goes on; the D update for step
        t is applied during step t+1, so the generator sees D one step
        stale and the deferred update reads the spectral-norm state as
        batch t+1's G phase left it. The deferred update keeps the
        synchronous StepLR epoch through the stashed post-G step. Returns
        the PREVIOUS batch's disc loss, or None on the first step of an
        epoch; `drain_pending_d()` applies the final deferred update.
        """
        if self.cfg.train.pesq_label_mode == "device":
            metrics, disc_loss = self.fused_step(self.state, clean, noisy)
            self._maybe_ema()
            return metrics["gen_loss"], disc_loss
        metrics, handoff = self.g_step(self.state, clean, noisy)
        self._maybe_ema()
        if self.cfg.train.pesq_label_mode == "host_async":
            future = self._label_pool.submit(
                lambda est_dev, c=clean: pesq_labels_host(c, est_dev.cpu().numpy()),
                handoff["est_audio"],
            )
            disc_loss = self.drain_pending_d()
            self._pending_d = (handoff, future, self.state.step)
            return metrics["gen_loss"], disc_loss
        scores = pesq_labels_host(clean, handoff["est_audio"].cpu().numpy())
        disc_loss = self.d_step(self.state, handoff["clean_mag"], handoff["est_mag"], scores)
        return metrics["gen_loss"], disc_loss

    def drain_pending_d(self):
        """Apply the deferred discriminator update (host_async mode).

        Returns its disc loss as a device scalar, or None if nothing is
        pending. Called automatically each step and at epoch end, so every
        G step still gets exactly one matching D update, with the schedule
        evaluated at the stashed post-G step.
        """
        if self._pending_d is None:
            return None
        handoff, future, at_step = self._pending_d
        self._pending_d = None
        return self.d_step(self.state, handoff["clean_mag"], handoff["est_mag"],
                           future.result(), at_step)

    def _seed_ema(self, gen_state_dict):
        names = [n for n, _ in self.state.gen.named_parameters()]
        self.ema_params = {
            n: gen_state_dict[n].detach().to(self.state.device, torch.float32).clone()
            for n in names
        }

    @torch.no_grad()
    def _maybe_ema(self):
        """Fold the freshest generator params into the EMA tree
        (gen_ema_decay > 0): ema <- d * ema + (1 - d) * params."""
        if self.ema_params is None:
            return
        d = float(self.cfg.train.gen_ema_decay)
        ema = list(self.ema_params.values())
        params = [p.detach().float() for p in self.state.gen.parameters()]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, params, alpha=1.0 - d)

    def ema_variables(self):
        """The generator's state_dict with EMA-smoothed parameters (the
        current BatchNorm stats ride along, standard EMA practice).
        Requires cfg.train.gen_ema_decay > 0."""
        if self.ema_params is None:
            raise ValueError("gen_ema_decay is 0: no EMA tree is tracked")
        variables = {k: v.detach().clone() for k, v in self.state.gen.state_dict().items()}
        variables.update({k: v.clone() for k, v in self.ema_params.items()})
        return variables

    def restore_checkpoint(self, path: str):
        """Restore a full TrainState checkpoint into this trainer.

        When an EMA tree is tracked (gen_ema_decay > 0), it is restored
        from the sibling ``<path>_ema`` variables if present (written by
        save_checkpoint), else re-seeded from the restored raw weights,
        never left tracking the pre-restore init.
        """
        restore_train_state(path, self.state)
        if self.ema_params is not None:
            seed = self.state.gen.state_dict()
            ema_path = path + "_ema"
            if os.path.exists(ema_path):
                seed = restore_variables(ema_path, self.state.device)
                log.info("restored EMA tree from %s", ema_path)
            self._seed_ema(seed)
        return self.state

    def train_epoch(self, epoch: int):
        interval = self.cfg.train.log_interval
        async_mode = self.cfg.train.pesq_label_mode == "host_async"
        pending = {}  # step_in_epoch -> {rows, gen, disc}
        flush_t0 = time.perf_counter()
        global_step0 = self.state.step  # the step count before the epoch's first step

        def flush(step):
            # One blocking fetch for the whole window. Only COMPLETE steps
            # are fetched: in host_async mode a step's disc loss arrives
            # one call later, so the window's boundary step carries over
            # to the next flush.
            nonlocal flush_t0
            done = [s for s in sorted(pending) if "disc" in pending[s]]
            if not done:
                return
            fetched = torch.stack(
                [torch.stack([pending[s]["gen"].float(), pending[s]["disc"].float()])
                 for s in done]
            ).cpu().numpy()
            elapsed = time.perf_counter() - flush_t0
            flush_t0 = time.perf_counter()
            utt = sum(pending[s]["rows"] for s in done)
            rate = utt / elapsed if elapsed > 0 else 0.0
            if self.metrics_logger is not None:
                for s, (g, d) in zip(done, fetched):
                    self.metrics_logger.log(global_step0 + s, epoch=epoch, gen_loss=float(g),
                                            disc_loss=float(d), step_seconds=elapsed / len(done))
            gen_loss, disc_loss = fetched[-1]
            log.info("epoch %d step %d loss %.5f disc_loss %.5f (%.1f utt/s)",
                     epoch, step, float(gen_loss), float(disc_loss), rate)
            for s in done:
                del pending[s]

        step = 0
        for idx, (clean, noisy) in enumerate(self.train_loader):
            step = idx + 1
            gen_dev, disc_dev = self.train_step(clean, noisy)
            pending[step] = {"rows": clean.shape[0], "gen": gen_dev}
            if async_mode:
                if disc_dev is not None:  # belongs to the previous step
                    pending[step - 1]["disc"] = disc_dev
            else:
                pending[step]["disc"] = disc_dev
            if step % interval == 0:
                flush(step)
        final_disc = self.drain_pending_d()
        if final_disc is not None:
            pending[step]["disc"] = final_disc
        flush(step)

    def test(self) -> float:
        """Per-epoch eval pass; returns the mean generator loss. Its labels
        come from the host scorer in every label mode, as in the JAX package.

        A batch of fewer rows than batch_size (the last one) is
        wrap-padded to the full size, and the averages are weighted by
        REAL rows only: padded duplicate rows never reach the reported
        loss.
        """
        if self.test_loader is None:
            return float("nan")
        size = self.test_loader.batch_size
        gen_total, disc_total, n = 0.0, 0.0, 0
        for clean, noisy in self.test_loader:
            real = clean.shape[0]
            if real < size:
                clean = np.resize(clean, (size, clean.shape[1]))
                noisy = np.resize(noisy, (size, noisy.shape[1]))
            metrics, handoff = self.test_fwd(self.state, clean, noisy)
            scores = pesq_labels_host(clean, handoff["est_audio"].cpu().numpy())
            disc_per_ex = self.test_disc_loss(
                self.state, handoff["clean_mag"], handoff["est_mag"], scores
            )
            gen_total += float(metrics["gen_loss_per_ex"][:real].sum())
            disc_total += float(disc_per_ex[:real].sum())
            n += real
        gen_avg = gen_total / max(n, 1)
        log.info("test: gen loss %.5f disc loss %.5f", gen_avg, disc_total / max(n, 1))
        return gen_avg

    def save_checkpoint(self, directory: str, epoch: int, test_loss: float) -> str:
        path = os.path.join(directory, f"CMGAN_epoch_{epoch}_{str(test_loss)[:5]}")
        save_train_state(path, self.state)
        log.info("saved checkpoint %s", path)
        if self.ema_params is not None:
            save_variables(path + "_ema", self.ema_variables())
            log.info("saved EMA variables %s_ema", path)
        return path

    def train(self):
        cfg = self.cfg.train
        for epoch in range(cfg.epochs):
            self.train_epoch(epoch)
            test_loss = self.test()
            self.save_checkpoint(cfg.save_model_dir, epoch, test_loss)
