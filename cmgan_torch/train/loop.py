"""Training orchestration: the GAN epoch loop.

Same loop structure as the JAX package's Trainer (and the CMGAN
reference's): loss weights, LR schedule, per-epoch test pass and
checkpointing, with full-state checkpoints that resume, and the JAX
package's JSONL metrics stream (`metrics_path`). With a mesh
(`cmgan_torch.parallel`) every rank runs this loop and steps on its data
rank's rows: its train loader yields either those rows alone (sharded by
data rank, as the JAX package's loader shards by process) or global
batches, of which the step takes them.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from cmgan_torch.checkpoint import (
    restore_train_state,
    restore_variables,
    save_train_state,
    save_variables,
)
from cmgan_torch.config import CMGANConfig
from cmgan_torch.data.dataset import BatchLoader
from cmgan_torch.parallel import (
    attach, collectives, is_writer, make_mesh, replicate_state, shard_batch,
)
from cmgan_torch.train.state import TrainState, check_supported, init_train_state
from cmgan_torch.train.steps import make_train_steps, pesq_labels_host
from cmgan_torch.utils import MetricsLogger, span

log = logging.getLogger("cmgan_torch.train")


def yields_local_rows(loader, mesh) -> bool:
    """Whether `loader` yields this data rank's rows alone: it is sharded
    as `load_data(num_processes=mesh.data_size, process_index=mesh.data_rank)`
    shards it. False for a loader of global batches (num_processes 1;
    a list of batches counts as one). A loader sharded any other way
    raises, since it would train on another data rank's rows: under a
    mesh the shard index is the DATA rank, which the seq ranks of one
    data index share, never the global rank. Over a mesh of one data
    rank the two are the same rows and the loader counts as local."""
    procs = getattr(loader, "num_processes", 1)
    index = getattr(loader, "process_index", 0)
    if mesh is not None and (procs, index) == (mesh.data_size, mesh.data_rank):
        return True
    if (procs, index) == (1, 0):
        return False
    where = ("no mesh" if mesh is None else
             f"data rank {mesh.data_rank} of {mesh.data_size} (mesh {mesh.shape})")
    raise ValueError(f"the train loader is sharded as process {index} of {procs}, which fits "
                     f"neither global batches nor {where}")


class Trainer:
    """dtype: compute type of the models' convs and linears (None:
    float32). The default device is the GPU; without CUDA pass
    device="cpu" explicitly (the CPU runs the kernels' plain versions).
    metrics_path: a JSONL file that gets one record a completed step
    (`step`, `time`, `epoch`, `gen_loss`, `disc_loss`, `step_seconds`),
    written where the loop reads the losses back (every log_interval
    steps and at the epoch's end), as in the JAX package.

    mesh: a `parallel.make_mesh` grid; the device is then the mesh's. With
    no mesh and a process group up, one is made from cfg.mesh. Rank 0
    alone writes checkpoints and metrics.

    The train loader yields global batches (num_processes 1: every rank
    reads them, train_epoch steps on its data rank's rows) or this data
    rank's rows alone (num_processes = the mesh's data size, process_index
    its data rank, as `load_data` shards); decided here once
    (`yields_local_rows`, in `local_rows`), and a loader sharded for
    another mesh raises. Its length is the epoch's steps, which drive the
    LR schedule: n // (B * P) for a global loader of B * P rows, ceil(n / P)
    // B for P shards of B rows (the JAX package's), equal on every rank.
    The test loader stays global on every mesh (see `test`)."""

    def __init__(
        self,
        cfg: CMGANConfig,
        train_loader: BatchLoader,
        test_loader: Optional[BatchLoader] = None,
        dtype: torch.dtype | None = None,
        device="cuda",
        state: Optional[TrainState] = None,
        metrics_path: Optional[str] = None,
        mesh=None,
    ):
        check_supported(cfg)
        if mesh is None and dist.is_initialized():
            mesh = make_mesh(cfg.mesh, device)
        self.local_rows = yields_local_rows(train_loader, mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.metrics_logger = (MetricsLogger(metrics_path)
                               if metrics_path and is_writer() else None)
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.steps_per_epoch = steps_per_epoch = max(len(train_loader), 1)
        (self.g_step, self.d_step, self.test_fwd, self.test_disc_loss,
         self.fused_step) = make_train_steps(cfg, steps_per_epoch, mesh)
        if state is None:
            state = init_train_state(cfg, cfg.train.seed, steps_per_epoch, dtype=dtype,
                                     device=device, mesh=mesh)
        elif mesh is not None:
            attach(state.gen, mesh)
            replicate_state(mesh, state)
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
    def train_step(self, clean: np.ndarray, noisy: np.ndarray, local: bool = False):
        """One GAN step on a global batch, or with local=True on this data
        rank's rows of one (what a loader sharded by data rank yields);
        returns (gen_loss, disc_loss) as 0-d DEVICE tensors (not fetched:
        callers decide when to sync), the global batch's means under a
        mesh, where each rank steps on (and labels) its data rank's rows.
        Without a mesh, or over one data rank, the two forms are one.

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
        with span("cmgan.train.step"):
            if self.mesh is not None and not local:
                clean, noisy = shard_batch(self.mesh, clean, noisy)
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
            with span("cmgan.train.labels"):
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
        never left tracking the pre-restore init. The loaders go on at the
        epoch that follows the restored step (the JAX package restarts
        them at epoch 0), so the shuffle, each rank's shard and the crops
        are those of the run without the restart.
        """
        restore_train_state(path, self.state)
        # checkpoints fall on epoch ends, so the step counts whole epochs
        for loader in (self.train_loader, self.test_loader):
            if hasattr(loader, "epoch"):
                loader.epoch = self.state.step // self.steps_per_epoch
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

        # the rows a step takes over all ranks: a local batch is one data rank's
        ranks = self.mesh.data_size if self.local_rows else 1
        step = 0
        for idx, (clean, noisy) in enumerate(self.train_loader):
            step = idx + 1
            gen_dev, disc_dev = self.train_step(clean, noisy, local=self.local_rows)
            pending[step] = {"rows": clean.shape[0] * ranks, "gen": gen_dev}
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
        wrap-padded to the full size (and on to a multiple of the data
        ranks), and the averages are weighted by REAL rows only: padded
        duplicate rows never reach the reported loss. Under a mesh each
        rank scores its rows and the per-row losses are gathered, so every
        rank returns the global mean. The test loader is global on every
        mesh (`load_data` shards the train loader only): each rank reads
        the test set whole and each item counts once. (The JAX package's
        loader would shard it too, wrap-padding duplicates into the last
        shards; over one process the two are the same.)
        """
        if self.test_loader is None:
            return float("nan")
        size = self.test_loader.batch_size
        if self.mesh is not None:
            size = -(-size // self.mesh.data_size) * self.mesh.data_size
        gen_total, disc_total, n = 0.0, 0.0, 0
        for clean, noisy in self.test_loader:
            real = clean.shape[0]
            if real < size:
                clean = np.resize(clean, (size, clean.shape[1]))
                noisy = np.resize(noisy, (size, noisy.shape[1]))
            if self.mesh is not None:
                clean, noisy = shard_batch(self.mesh, clean, noisy)
            metrics, handoff = self.test_fwd(self.state, clean, noisy)
            scores = pesq_labels_host(clean, handoff["est_audio"].cpu().numpy())
            disc_per_ex = self.test_disc_loss(
                self.state, handoff["clean_mag"], handoff["est_mag"], scores
            )
            gen_per_ex = metrics["gen_loss_per_ex"]
            if self.mesh is not None:
                gen_per_ex = collectives.gather_rows(gen_per_ex, self.mesh.data_group)
                disc_per_ex = collectives.gather_rows(disc_per_ex, self.mesh.data_group)
            gen_total += float(gen_per_ex[:real].sum())
            disc_total += float(disc_per_ex[:real].sum())
            n += real
        gen_avg = gen_total / max(n, 1)
        log.info("test: gen loss %.5f disc loss %.5f", gen_avg, disc_total / max(n, 1))
        return gen_avg

    def save_checkpoint(self, directory: str, epoch: int, test_loss: float) -> str:
        """Write the state (rank 0 only; the ranks hold the same state);
        returns the path on every rank."""
        path = os.path.join(directory, f"CMGAN_epoch_{epoch}_{str(test_loss)[:5]}")
        if not is_writer():
            return path
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
