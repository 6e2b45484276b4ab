"""Architectures, one a module, found by name: `perfbench.archs.<arch>`,
where <arch> is the `arch` key of the configuration file.

Each module has
- check(cfg): raises ValueError where the file's sizes disagree;
- port_config(cfg, **train): the program's config for the file, with the
  training fields given;
- generator(cfg): the plain reference's generator, an nn.Module whose
  state dict loads into the program's generator with strict=True;
- seeded_state(module, seed, device): a state dict for `module` drawn
  from `seed` on `device`;
- enhance(model, x, cfg): the reference's signal path, segments [B, L]
  in, enhanced audio out, through `model`;
- reset_launches(), launches() -> {name: count}: the program's kernel
  counters over the window, read by the per-layer metrics.

The program's entry points are the same for every architecture:
`inference.load_generator`, `inference.enhance_tensor` and
`streaming.StreamBatcher` (perfbench/README.md).
"""

from __future__ import annotations

import importlib
import re

FUNCTIONS = ("check", "port_config", "generator", "seeded_state", "enhance",
             "reset_launches", "launches")
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load(cfg: dict):
    """The module of the configuration's `arch`."""
    name = cfg.get("arch")
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise ValueError(f"configuration {cfg.get('name')!r}: `arch` {name!r} names no module "
                         "of perfbench/archs/")
    return importlib.import_module(f"{__name__}.{name}")


def require(cfg: dict, arch: str, what: str):
    """Raises ValueError unless the configuration's `arch` is `arch`."""
    if cfg.get("arch") != arch:
        raise ValueError(f"{what} is {arch}'s alone; configuration {cfg.get('name')!r} has "
                         f"arch {cfg.get('arch')!r}")
