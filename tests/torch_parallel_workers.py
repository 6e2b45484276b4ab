"""Multi-rank cases of the port's parallel tests, run in spawned processes.

`run(cases)` starts one pool of processes (spawn) and runs every case in
it: a case names the pool's processes it runs on, which join a gloo
process group of their own (a `FileStore` in a temporary directory) with
ranks 0, 1, ... in that order, while the other processes go on to their
next case. Every process takes its cases in list order, so cases that
share processes run in the same order on each. Process start-up is paid
once a pool. Each rank's result (a dict of numpy arrays and numbers)
comes back to the caller as results[name][rank].

Imports torch, numpy and the port only: JAX stays in the test process.
"""

from __future__ import annotations

import datetime
import logging
import os
import pickle
import socket
import tempfile
import types

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits for the others of its case before it fails
TIMEOUT = datetime.timedelta(seconds=180)


def run(cases) -> dict:
    """cases: [(name, processes (a tuple of pool indices), function name in
    this module, kwargs)]."""
    nprocs = 1 + max(p for _, procs, _, _ in cases for p in procs)
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _worker, args=(tmp, cases), nprocs=nprocs, join=True, start_method="spawn")
        results = {}
        for name, procs, _, _ in cases:
            results[name] = []
            for rank in range(len(procs)):
                with open(os.path.join(tmp, f"{name}.{rank}.pkl"), "rb") as f:
                    results[name].append(pickle.load(f))
        return results


def _worker(index: int, tmp: str, cases):
    torch.set_num_threads(1)
    for i, (name, procs, fn, kwargs) in enumerate(cases):
        if index not in procs:
            continue
        rank, world = procs.index(index), len(procs)
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store{i}"), world),
                                rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            result = globals()[fn](**kwargs)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        with open(os.path.join(tmp, f"{name}.{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)


def _mesh(data_parallel=-1, seq_parallel=1):
    from cmgan_torch.config import MeshConfig
    from cmgan_torch.parallel import make_mesh

    return make_mesh(MeshConfig(data_parallel=data_parallel, seq_parallel=seq_parallel), "cpu")


def _np(t):
    return t.detach().double().numpy()


# -- ops/seq_attention.py --

def seq_attention(q, k, v, table, max_pos):
    """seq_rel_attention over all ranks as one seq group: the output and
    the gradients of sum(sin(out)) in q, k, v and the table."""
    from cmgan_torch.ops import flash_attention as fa
    from cmgan_torch.ops.seq_attention import seq_rel_attention

    mesh = _mesh(seq_parallel=dist.get_world_size())
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, table)]
    calls = fa.plain_calls
    out = seq_rel_attention(*leaves, max_pos, mesh)
    grads = torch.autograd.grad(out.sin().sum(), leaves)
    return {"out": _np(out), "grads": [_np(g) for g in grads], "calls": fa.plain_calls - calls,
            "shape": mesh.shape}


def relpos_attention(state_dict, dim, x):
    """RelPosAttention('seq') on a 2 x 2 data x seq mesh: this data rank's
    rows of x in, its output and the gradient of its input out."""
    from cmgan_torch.models.conformer import RelPosAttention
    from cmgan_torch.parallel import attach, shard_batch

    mesh = _mesh(seq_parallel=2)
    module = RelPosAttention(dim, attention_impl="seq")
    module.load_state_dict(state_dict)
    attach(module, mesh)
    rows = torch.from_numpy(shard_batch(mesh, x)).requires_grad_()
    out = module(rows)
    (grad,) = torch.autograd.grad(out.sin().sum(), rows)
    return {"out": _np(out), "grad": _np(grad), "data_rank": mesh.data_rank,
            "seq_rank": mesh.seq_rank}


# -- train/, inference.py --

def step_state(state):
    """What a step changes: both models' state_dicts, AdamW's first
    moments (0.1 x the first step's gradient) and the dropout stream."""
    def moments(model, opt):
        return {n: _np(opt.state[p]["exp_avg"]) for n, p in model.named_parameters()
                if p in opt.state}

    return {"gen": {k: _np(v) for k, v in state.gen.state_dict().items()},
            "disc": {k: _np(v) for k, v in state.disc.state_dict().items()},
            "gen_m": moments(state.gen, state.gen_opt),
            "disc_m": moments(state.disc, state.disc_opt),
            "rng": state.rng_state.numpy()}


class Batches(list):
    """A test loader: a list of (clean, noisy) batches of batch_size rows."""

    def __init__(self, batches, batch_size: int):
        super().__init__(batches)
        self.batch_size = batch_size


def train_step(cfg, clean, noisy, steps_per_epoch, test=False):
    """A Trainer over every rank (cfg.mesh's layout) takes one train_step
    of the global batch; with test, then a test pass of its first rows."""
    from cmgan_torch.train import Trainer

    mesh = _mesh(cfg.mesh.data_parallel, cfg.mesh.seq_parallel)
    tests = Batches([(clean[:-1], noisy[:-1])], clean.shape[0]) if test else None
    trainer = Trainer(cfg, [None] * steps_per_epoch, tests, device="cpu", mesh=mesh)
    gen_loss, disc_loss = trainer.train_step(clean, noisy)
    if disc_loss is None:   # host_async: the D update of this step is pending
        disc_loss = trainer.drain_pending_d()
    out = {"gen_loss": float(gen_loss), "disc_loss": float(disc_loss), "shape": mesh.shape,
           **step_state(trainer.state)}
    if test:
        out["test_loss"] = trainer.test()
    return out


def record_steps(trainer):
    """Wrap trainer.train_step so each call keeps what it got (the batch,
    copied, and its `local` flag) and what it returned; returns the list
    the calls append to."""
    seen, step = [], trainer.train_step

    def recording(clean, noisy, local=False):
        out = step(clean, noisy, local=local)
        seen.append({"clean": np.array(clean), "noisy": np.array(noisy), "local": local,
                     "out": out})
        return out

    trainer.train_step = recording
    return seen


class _LoggedRates(logging.Handler):
    """The utterances/s of the train loop's log lines."""

    def __init__(self):
        super().__init__()
        self.rates = []

    def emit(self, record):
        if "utt/s" in record.msg:
            self.rates.append(record.args[-1])


def local_epoch(cfg, data_dir, batch_size):
    """Every rank a data rank, each with a train loader sharded by its data
    rank (load_data), one epoch of Trainer.train_epoch. The loop's clock
    ticks one second a reading, so each logged rate is the count of
    utterances its window stepped on. Returns each step's batch and the
    last step's losses, the logged rates and the state."""
    from cmgan_torch.data.dataset import load_data
    from cmgan_torch.train import Trainer, loop

    mesh = _mesh()
    train, _ = load_data(data_dir, batch_size, cfg.train.cut_len, cfg.train.seed,
                         num_processes=mesh.data_size, process_index=mesh.data_rank)
    trainer = Trainer(cfg, train, None, device="cpu", mesh=mesh)
    seen = record_steps(trainer)
    ticks = iter(range(10 ** 6))
    clock, loop.time = loop.time, types.SimpleNamespace(perf_counter=lambda: float(next(ticks)))
    rates = _LoggedRates()
    loop.log.addHandler(rates)
    loop.log.setLevel(logging.INFO)
    try:
        trainer.train_epoch(0)
    finally:
        loop.time = clock
        loop.log.removeHandler(rates)
    gen_loss, disc_loss = seen[-1]["out"]
    return {"gen_loss": float(gen_loss), "disc_loss": float(disc_loss), "shape": mesh.shape,
            "local_rows": trainer.local_rows, "steps_per_epoch": trainer.steps_per_epoch,
            "batches": [(b["clean"], b["noisy"]) for b in seen],
            "local": [b["local"] for b in seen], "rates": rates.rates,
            **step_state(trainer.state)}


def grid_loaders(cfg, data_dir, batch_size):
    """A Trainer on a 2-rank seq axis (data x seq over the world) with a
    train loader sharded by data rank: the batches of its first epoch as
    the Trainer iterates them. Then the errors (None if none) of Trainers
    given loaders sharded for another mesh: by global rank over the world,
    and by the other data rank."""
    from cmgan_torch.data.dataset import load_data
    from cmgan_torch.train import Trainer

    mesh = _mesh(seq_parallel=2)

    def loader(procs, index):
        return load_data(data_dir, batch_size, cfg.train.cut_len, cfg.train.seed,
                         num_processes=procs, process_index=index)[0]

    trainer = Trainer(cfg, loader(mesh.data_size, mesh.data_rank), None, device="cpu",
                      mesh=mesh)
    errors = []
    for procs, index in ((dist.get_world_size(), dist.get_rank()),
                         (mesh.data_size, 1 - mesh.data_rank)):
        try:
            Trainer(cfg, loader(procs, index), None, device="cpu", mesh=mesh)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return {"data_rank": mesh.data_rank, "seq_rank": mesh.seq_rank,
            "local_rows": trainer.local_rows, "batches": list(trainer.train_loader),
            "errors": errors}


def enhance_batch(cfg, state_dict, tracks, batch_cap, data_parallel):
    """Enhancer.enhance_batch with the rows split over the data ranks."""
    from cmgan_torch.inference import Enhancer

    mesh = _mesh(data_parallel, dist.get_world_size() // data_parallel)
    enh = Enhancer(cfg, state_dict, device="cpu", mesh=mesh)
    return {"outs": enh.enhance_batch(tracks, batch_cap=batch_cap)}


def enhance(cfg, state_dict, track, mode, seq_parallel):
    """Enhancer.enhance with the time conformer sharded over seq_parallel
    ranks (cfg's attention_impl 'seq')."""
    from cmgan_torch.inference import Enhancer
    from cmgan_torch.ops import flash_attention as fa

    mesh = _mesh(seq_parallel=seq_parallel)
    enh = Enhancer(cfg, state_dict, device="cpu", mesh=mesh)
    calls = fa.plain_calls
    out = enh.enhance(np.asarray(track), mode=mode)
    return {"out": out, "calls": fa.plain_calls - calls}


def train_cli(argv):
    """The train CLI as torchrun starts it: this process's rank and the
    world in the environment, no process group yet (the CLI joins one at
    a port rank 0 found free just before)."""
    from cmgan_torch.cli import train as cli_train
    from cmgan_torch.train import Trainer

    rank, world = dist.get_rank(), dist.get_world_size()
    port = [None]
    if rank == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port[0] = s.getsockname()[1]
    dist.broadcast_object_list(port, src=0)
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port[0]))
    seen, step = [], Trainer.train_step

    def recording(self, clean, noisy, local=False):
        seen.append((np.array(clean), local))
        return step(self, clean, noisy, local=local)

    Trainer.train_step = recording
    try:
        trainer = cli_train.main(argv)
    finally:
        Trainer.train_step = step
    loader = trainer.train_loader
    return {"step": trainer.state.step, "batch_size": trainer.cfg.train.batch_size,
            "shape": trainer.mesh.shape, "steps_per_epoch": trainer.steps_per_epoch,
            "loader": (loader.num_processes, loader.process_index, loader.batch_size),
            "test_batch_size": trainer.test_loader.batch_size,
            "batches": [c for c, _ in seen], "local": [flag for _, flag in seen],
            **step_state(trainer.state)}
