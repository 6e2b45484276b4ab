"""The port's boundaries: it imports nothing of JAX or of the JAX package,
defaults to the GPU, and its chip smoke refuses to run without one."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "cmgan_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "cmgan_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 15
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import cmgan_torch.inference, cmgan_torch.cli.enhance, cmgan_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,)
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_enhancer_defaults_to_cuda_and_raises_without_it():
    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import Enhancer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = CMGANConfig(model=ModelConfig(num_channels=16, num_tscb_blocks=1, dense_depth=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        Enhancer(cfg)
    assert Enhancer(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"ok"' not in proc.stdout
