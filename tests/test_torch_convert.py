"""The port's weight bridge against the JAX package's exporter, on the
committed JAX checkpoints."""

import os

import numpy as np
import pytest
import torch

from cmgan_tpu.checkpoint import restore_variables
from cmgan_tpu.checkpoint.torch_import import export_generator_state_dict, save_torch_generator
from cmgan_torch.config import ModelConfig
from cmgan_torch.convert import state_dict_from_flax
from cmgan_torch.models import TSCNet
from torch_threads import one_torch_thread  # noqa: F401  (one intra-op thread a test module)

REPORTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "reports")
CHECKPOINTS = ["trained_generator_r05_fold1_ema", "trained_generator_r04_ema",
               "trained_generator_r05_streamft500"]


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_state_dict_from_flax_equals_jax_export(name):
    variables = restore_variables(os.path.join(REPORTS, name))
    ours = state_dict_from_flax(variables["params"], variables["batch_stats"])
    ref = export_generator_state_dict(variables)
    assert len(ours) == len(ref) == 359
    assert set(ours) == set(ref)
    for key, value in ref.items():
        assert tuple(ours[key].shape) == np.shape(value), key
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)

    model = TSCNet(ModelConfig())
    model.load_state_dict(ours, strict=True)
    assert sum(p.numel() for p in model.parameters()) == 1_834_833


def test_pt_from_jax_package_loads_strict(tmp_path):
    """A `.pt` written by the JAX package's save_torch_generator is what
    the port's CLI takes as --torch_ckpt."""
    variables = restore_variables(os.path.join(REPORTS, CHECKPOINTS[0]))
    path = tmp_path / "generator.pt"
    save_torch_generator(str(path), variables)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = TSCNet(ModelConfig())
    model.load_state_dict(sd, strict=True)
    ours = state_dict_from_flax(variables["params"], variables["batch_stats"])
    for key, value in model.state_dict().items():
        assert torch.equal(value, ours[key]), key


def test_missing_entry_is_refused():
    variables = restore_variables(os.path.join(REPORTS, CHECKPOINTS[0]))
    sd = state_dict_from_flax(variables["params"], variables["batch_stats"])
    del sd["TSCB_1.time_conformer.attn.fn.rel_pos_emb.weight"]
    with pytest.raises(RuntimeError):
        TSCNet(ModelConfig()).load_state_dict(sd, strict=True)
