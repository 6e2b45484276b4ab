"""A (data, seq) grid of ranks over torch.distributed, one process a GPU.

The JAX package drives every local device from one process: a `Mesh` of
axes ('data', 'seq'), batches sharded over 'data', parameters replicated,
and GSPMD inserting the collectives. The port runs one process a GPU
(torchrun) and builds the same grid from process groups: rank
`d * seq + s` sits at data index d and seq index s, as the JAX mesh
reshapes its device list. Each rank holds its data index's rows of a
global batch; the ranks of one seq group hold the same rows and split
only the time conformer's attention (ops/seq_attention.py). What the
collectives are: parallel/collectives.py.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from cmgan_torch.config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the grid: its two groups, its coordinates and
    the device it computes on."""

    axis_names: tuple
    data_size: int
    seq_size: int
    data_rank: int
    seq_rank: int
    data_group: dist.ProcessGroup
    seq_group: dist.ProcessGroup
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (self.data_size, self.seq_size)))


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(cfg: MeshConfig | None = None, device="cuda") -> Mesh:
    """The (data, seq) groups of the running process group, laid out as
    `cfg` says (data_parallel -1: the world size over seq_parallel).

    Every rank creates every group, in the same order, as new_group
    requires. device: this rank's device; CUDA needs the NCCL backend and
    the CPU gloo (there is no fallback from one to the other)."""
    cfg = cfg or MeshConfig()
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a torch.distributed process group: call "
            "cmgan_torch.parallel.init_from_env() under torchrun, or "
            "torch.distributed.init_process_group"
        )
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    if backend != _backend_for(device):
        raise RuntimeError(f"a mesh on {device} needs the {_backend_for(device)} backend; "
                           f"the process group runs {backend}")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, sp = cfg.layout(world)
    grid = np.arange(world).reshape(dp, sp)
    data_index, seq_index = divmod(rank, sp)
    data_group = seq_group = None
    for s in range(sp):   # the ranks of one seq index, across the data axis
        group = dist.new_group(grid[:, s].tolist())
        if s == seq_index:
            data_group = group
    for d in range(dp):   # the ranks of one data index, across the seq axis
        group = dist.new_group(grid[d].tolist())
        if d == data_index:
            seq_group = group
    return Mesh((cfg.data_axis, cfg.seq_axis), dp, sp, data_index, seq_index,
                data_group, seq_group, device)


def init_from_env(device="cuda") -> torch.device:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this rank's device:
    cuda:{LOCAL_RANK} over NCCL, or, with device='cpu' (tests), the CPU
    over gloo."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK") if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {missing} not set; start the program with torchrun")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_from_env: CUDA is not available; pass device='cpu'")
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    dist.init_process_group(_backend_for(device), init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def shard_batch(mesh: Mesh, *arrays):
    """This data rank's rows of each global batch (leading axis split
    evenly over `data`, as PartitionSpec('data') does)."""
    out = []
    for a in arrays:
        rows = a.shape[0]
        if rows % mesh.data_size:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{mesh.data_size} data ranks")
        per = rows // mesh.data_size
        out.append(a[mesh.data_rank * per:(mesh.data_rank + 1) * per])
    return tuple(out) if len(out) > 1 else out[0]


def replicate_state(mesh: Mesh, module_or_state):
    """Broadcast parameters and buffers from rank 0 over the world, in
    place: an nn.Module, or a TrainState (both models). Returns it."""
    modules = ([module_or_state] if isinstance(module_or_state, torch.nn.Module)
               else [module_or_state.gen, module_or_state.disc])
    tensors = [t for m in modules for t in (*m.parameters(), *m.buffers())]
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            same = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in same])
            dist.broadcast(flat, src=0)
            for t, part in zip(same, flat.split([t.numel() for t in same])):
                t.copy_(part.view_as(t))
    return module_or_state


def attach(module: torch.nn.Module, mesh: Mesh | None) -> torch.nn.Module:
    """Hand `mesh` to every submodule that takes one (the conformer's
    attention and BatchNorm); None detaches. Returns the module."""
    for m in module.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    return module


def is_writer() -> bool:
    """Whether this process writes checkpoints and metrics: rank 0, or the
    only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
