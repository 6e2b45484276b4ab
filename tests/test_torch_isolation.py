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
    assert len(files) > 30
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"chip_smoke.py", "cmgan_torch/train/steps.py", "cmgan_torch/train/loop.py",
            "cmgan_torch/train/state.py", "cmgan_torch/models/discriminator.py",
            "cmgan_torch/metrics/pesq_native.py", "cmgan_torch/data/dataset.py",
            "cmgan_torch/checkpoint/__init__.py", "cmgan_torch/cli/train.py",
            "cmgan_torch/ops/fused_norm.py", "cmgan_torch/metrics/pesq_torch.py",
            "cmgan_torch/metrics/composite.py", "cmgan_torch/metrics/stoi.py",
            "cmgan_torch/metrics/pesq_ref.py", "cmgan_torch/cli/evaluate.py",
            "cmgan_torch/streaming.py", "cmgan_torch/cli/serve.py",
            "cmgan_torch/utils/__init__.py", "cmgan_torch/utils/profiling.py",
            "cmgan_torch/parallel/__init__.py", "cmgan_torch/parallel/mesh.py",
            "cmgan_torch/parallel/collectives.py", "cmgan_torch/ops/seq_attention.py"} <= rel
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import cmgan_torch.inference, cmgan_torch.cli.enhance, cmgan_torch.convert\n"
        "import cmgan_torch.cli.train, cmgan_torch.train, cmgan_torch.checkpoint\n"
        "import cmgan_torch.metrics, cmgan_torch.data.dataset, cmgan_torch.ops.fused_norm\n"
        "import cmgan_torch.models.discriminator, cmgan_torch.cli.evaluate\n"
        "import cmgan_torch.metrics.pesq_torch, cmgan_torch.metrics.composite\n"
        "import cmgan_torch.metrics.stoi, cmgan_torch.metrics.pesq_ref\n"
        "import cmgan_torch.streaming, cmgan_torch.cli.serve, cmgan_torch.utils\n"
        "import cmgan_torch.parallel, cmgan_torch.ops.seq_attention\n"
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


def test_streaming_and_server_default_to_cuda_and_raise_without_it():
    from cmgan_torch.cli import serve
    from cmgan_torch.config import CMGANConfig, ModelConfig
    from cmgan_torch.inference import load_generator
    from cmgan_torch.streaming import StreamBatcher, StreamingEnhancer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = CMGANConfig(model=ModelConfig(num_channels=16, num_tscb_blocks=1, dense_depth=1))
    model = load_generator(cfg, None, device="cpu")
    for make in (lambda **kw: StreamingEnhancer(cfg, model, **kw),
                 lambda **kw: StreamBatcher(cfg, model, **kw),
                 lambda **kw: serve.make_server(cfg, model, port=0, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert StreamingEnhancer(cfg, model, device="cpu").model is model
    assert StreamBatcher(cfg, model, device="cpu").device.type == "cpu"
    serve.make_server(cfg, model, port=0, device="cpu").server_close()
    assert serve.parse_args([]).device == "cuda"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_kernel_sources_are_in_the_tree_and_nothing_is_built_at_import():
    csrc = os.path.join(ROOT, "cmgan_torch", "ops", "csrc")
    assert {"flash_rel_attention.cu", "flash_rel_attention_bwd.cu",
            "fused_layernorm.cu"} <= set(os.listdir(csrc))
    assert os.path.exists(os.path.join(ROOT, "cmgan_torch", "native", "pesq", "pesq.cc"))
    code = (
        "import sys, subprocess\n"
        "def no(*a, **k): raise AssertionError('a build ran at import')\n"
        "subprocess.run = subprocess.Popen = no\n"
        "import cmgan_torch.train, cmgan_torch.cli.train, cmgan_torch.ops, cmgan_torch.metrics\n"
        "import cmgan_torch.cli.evaluate, cmgan_torch.metrics.pesq_torch\n"
        "import cmgan_torch.streaming, cmgan_torch.cli.serve, cmgan_torch.utils\n"
        "import cmgan_torch.parallel, cmgan_torch.ops.seq_attention\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_trainer_defaults_to_cuda_and_raises_without_it():
    from cmgan_torch.cli import train as cli_train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli_train.parse_args(["--data_dir", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        from cmgan_torch.config import CMGANConfig, ModelConfig
        from cmgan_torch.train import init_train_state

        init_train_state(CMGANConfig(model=ModelConfig(num_channels=16, num_tscb_blocks=1,
                                                       dense_depth=1, ndf=4)), 0, 1)


@pytest.mark.parametrize("name", ["enhance", "evaluate", "train", "serve"])
def test_every_cli_pins_tf32_off_before_anything_else(monkeypatch, name):
    """PyTorch's defaults run cuDNN's float32 convolutions in TF32; each
    CLI's main() turns TF32 off for convolutions and matmuls first, before
    it reads its arguments."""
    import importlib

    cli = importlib.import_module(f"cmgan_torch.cli.{name}")

    class Stop(Exception):
        pass

    def stop(argv=None):
        raise Stop

    monkeypatch.setattr(cli, "parse_args", stop)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(Stop):
        cli.main([])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
