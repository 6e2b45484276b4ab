"""Checkpoint I/O on `torch.save` of plain tensors.

`save_train_state` writes the FULL train state (both models with their
BatchNorm / spectral-norm buffers, both optimizer states, the step and
the dropout stream's state), so training resumes where it stopped.
`save_variables` / `restore_variables` handle one model's state_dict,
for instance the EMA generator; such a file is what the enhance CLI's
`--torch_ckpt` takes.
"""

from __future__ import annotations

import os
from typing import Dict

import torch


def save_train_state(path: str, state):
    """state: a `cmgan_torch.train.TrainState`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({
        "gen": state.gen.state_dict(),
        "disc": state.disc.state_dict(),
        "gen_opt": state.gen_opt.state_dict(),
        "disc_opt": state.disc_opt.state_dict(),
        "step": state.step,
        "rng_state": state.rng_state,
    }, path)


def restore_train_state(path: str, state):
    """Load a full checkpoint into `state` (built for the same config), in
    place, on the state's device; returns it."""
    ckpt = torch.load(path, map_location=state.device, weights_only=True)
    state.gen.load_state_dict(ckpt["gen"], strict=True)
    state.disc.load_state_dict(ckpt["disc"], strict=True)
    _load_optimizer(state.gen_opt, ckpt["gen_opt"])
    _load_optimizer(state.disc_opt, ckpt["disc_opt"])
    state.step = int(ckpt["step"])
    state.rng_state = ckpt["rng_state"].cpu()
    return state


def _load_optimizer(opt, saved):
    """Load an AdamW state_dict but keep this optimizer's `capturable` flag
    (the saving run's label mode may have been another), with each step
    count where that flag wants it: on the parameter's device when
    capturable, else on the CPU."""
    capturable = [group["capturable"] for group in opt.param_groups]
    opt.load_state_dict(saved)
    for group, flag in zip(opt.param_groups, capturable):
        group["capturable"] = flag
        for p in group["params"]:
            entry = opt.state.get(p)
            if entry and "step" in entry:
                entry["step"] = entry["step"].to(p.device if flag else "cpu", torch.float32)


def save_variables(path: str, variables: Dict[str, torch.Tensor]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in variables.items()}, path)


def restore_variables(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location=device, weights_only=True)


__all__ = ["restore_train_state", "restore_variables", "save_train_state", "save_variables"]
