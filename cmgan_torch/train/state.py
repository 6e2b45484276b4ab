"""GAN train state, LR schedules and optimizer construction.

The full state (both models with their BatchNorm / spectral-norm
buffers, both AdamW states, the step counter and the random state the
dropout masks are drawn from) is one object, checkpointable and
restorable (`cmgan_torch.checkpoint`). The steps update it in place.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from cmgan_torch.config import CMGANConfig
from cmgan_torch.models import MetricDiscriminator, TSCNet
from cmgan_torch.models.layers import torch_default_init_


@dataclasses.dataclass
class TrainState:
    gen: TSCNet
    disc: MetricDiscriminator
    gen_opt: torch.optim.AdamW
    disc_opt: torch.optim.AdamW
    step: int
    # state of the device's random generator as the next step will find
    # it: steps run under it and store what they leave (`rng_scope`)
    rng_state: torch.Tensor

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device


@contextlib.contextmanager
def rng_scope(state: TrainState):
    """Run a step's random draws (dropout) from the state's own stream.

    Forks the device's generator, continues from `state.rng_state`, and
    stores where the stream stands afterwards; the process-wide stream is
    left as it was. Nothing is seeded globally.
    """
    device = state.device
    cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[device] if cuda else []):
        if cuda:
            torch.cuda.set_rng_state(state.rng_state, device)
        else:
            torch.set_rng_state(state.rng_state)
        yield
        state.rng_state = torch.cuda.get_rng_state(device) if cuda else torch.get_rng_state()


def make_lr_schedule(cfg: CMGANConfig, steps_per_epoch: int, base_lr: float):
    """StepLR: x lr_gamma every decay_epochs epochs, keyed by the global step."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (cfg.train.lr_gamma ** (epoch // cfg.train.decay_epochs))

    return schedule


def make_disc_lr_schedule(cfg: CMGANConfig, steps_per_epoch: int):
    """The discriminator's StepLR on the shared global step: its update is
    skipped on PESQ-invalid batches, so its own step count falls behind
    and must not drive the decay."""
    return make_lr_schedule(cfg, steps_per_epoch, cfg.train.disc_lr_mult * cfg.train.init_lr)


def make_optimizer(module: torch.nn.Module, lr: float,
                   capturable: bool = False) -> torch.optim.AdamW:
    """AdamW over all parameters, decay 0.01 on every one of them: equal to
    `optax.adamw(lr, 0.9, 0.999, 1e-8, weight_decay=0.01)` term for term.
    The steps set the learning rate from the schedules before each update.

    capturable: keep Adam's step count on the parameters' (CUDA) device and
    compute the bias corrections there, so an update can be undone by a
    device-side select without reading anything back to the host (the
    fused step's skip); torch keeps the count on the CPU otherwise."""
    opt = torch.optim.AdamW(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01, capturable=capturable)
    # capturable is chosen for the device-side skip, not for CUDA graphs: torch
    # would warn once that it runs uncaptured
    opt._warned_capturable_if_run_uncaptured = True
    return opt


def init_adam_state(opt: torch.optim.AdamW):
    """Create AdamW's per-parameter state (step 0, zero moments) where torch
    has not yet, as its first step would; the step count on the parameter's
    device when the optimizer is capturable, else a CPU scalar."""
    for group in opt.param_groups:
        for p in group["params"]:
            state = opt.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32,
                                            device=p.device if group["capturable"] else "cpu")
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def check_supported(cfg: CMGANConfig):
    """Raise for what the trainer cannot do yet."""
    mode = cfg.train.pesq_label_mode
    if mode not in ("host", "host_async", "device"):
        raise ValueError(
            f"pesq_label_mode must be 'host', 'host_async' or 'device', got {mode!r}"
        )
    if cfg.mesh.data_parallel not in (-1, 1) or cfg.mesh.seq_parallel != 1:
        raise NotImplementedError(
            "training on more than one device waits for the multi-GPU slice; "
            f"got data_parallel={cfg.mesh.data_parallel}, seq_parallel={cfg.mesh.seq_parallel}"
        )


def init_train_state(cfg: CMGANConfig, seed: int, steps_per_epoch: int,
                     dtype: torch.dtype | None = None, device="cuda") -> TrainState:
    """Both models with torch-default weights drawn from `seed`, their
    optimizers, step 0, and a dropout stream seeded from `seed`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_train_state: CUDA is not available; pass device='cpu' to run on the CPU"
        )
    check_supported(cfg)
    init = torch.Generator().manual_seed(seed)
    gen = torch_default_init_(TSCNet(cfg.model, dtype=dtype), init).to(device)
    disc = torch_default_init_(MetricDiscriminator(cfg.model, dtype=dtype), init).to(device)
    return TrainState(
        gen=gen,
        disc=disc,
        gen_opt=make_optimizer(gen, make_lr_schedule(cfg, steps_per_epoch, cfg.train.init_lr)(0)),
        disc_opt=make_optimizer(disc, make_disc_lr_schedule(cfg, steps_per_epoch)(0),
                                capturable=cfg.train.pesq_label_mode == "device"
                                and device.type == "cuda"),
        step=0,
        rng_state=torch.Generator(device=device).manual_seed(seed).get_state(),
    )
