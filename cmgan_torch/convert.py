"""Carry the JAX package's generator and discriminator weights into the port.

The port's TSCNet uses the CMGAN reference's state_dict key layout, so a
reference checkpoint, or a `.pt` written from a JAX checkpoint, loads
with `strict=True`. `state_dict_from_flax` maps the JAX package's flax
variables (nested dicts of numpy arrays, as a checkpoint restores them)
onto that layout:

  flax Conv kernel  [kh, kw, I, O] -> Conv2d [O, I, kh, kw]  (H = time, W = freq)
  flax Conv1D       [k, I, O]      -> Conv1d [O, I, k]
  flax Dense        [I, O]         -> Linear [O, I]
  PReLU alpha -> weight; norm scale -> weight; BN mean/var -> running_mean/var

`disc_state_dict_from_flax` does the same for the metric discriminator,
whose spectral-norm state (`u`, `sigma` per wrapped kernel) flax keeps in
`batch_stats` under `SpectralNorm_<n>/<layer>/kernel/{u,sigma}`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _conv1d(w):
    return np.transpose(w, (2, 1, 0))


def _linear(w):
    return np.transpose(w, (1, 0))


def _ident(w):
    return w


def _conformer_map(t: str, f: str) -> Dict[str, tuple]:
    """Reference nesting: ff{1,2} = Scale(PreNorm(FeedForward)) with
    net.{0,3} linears; attn = PreNorm(Attention); conv.net indices 0 LN,
    2 pointwise in, 4 depthwise, 5 BatchNorm, 7 pointwise out."""
    m = {}
    for ff in ("ff1", "ff2"):
        m[f"{t}.{ff}.fn.norm.weight"] = (f"{f}/{ff}_norm/scale", _ident)
        m[f"{t}.{ff}.fn.norm.bias"] = (f"{f}/{ff}_norm/bias", _ident)
        for idx, name in ((0, "in_proj"), (3, "out_proj")):
            m[f"{t}.{ff}.fn.fn.net.{idx}.weight"] = (f"{f}/{ff}/{name}/dense/kernel", _linear)
            m[f"{t}.{ff}.fn.fn.net.{idx}.bias"] = (f"{f}/{ff}/{name}/dense/bias", _ident)
    m[f"{t}.attn.norm.weight"] = (f"{f}/attn_norm/scale", _ident)
    m[f"{t}.attn.norm.bias"] = (f"{f}/attn_norm/bias", _ident)
    for name in ("to_q", "to_kv", "to_out"):
        m[f"{t}.attn.fn.{name}.weight"] = (f"{f}/attn/{name}/dense/kernel", _linear)
    m[f"{t}.attn.fn.to_out.bias"] = (f"{f}/attn/to_out/dense/bias", _ident)
    m[f"{t}.attn.fn.rel_pos_emb.weight"] = (f"{f}/attn/rel_pos_emb", _ident)
    m[f"{t}.conv.net.0.weight"] = (f"{f}/conv/norm/scale", _ident)
    m[f"{t}.conv.net.0.bias"] = (f"{f}/conv/norm/bias", _ident)
    for idx, name in ((2, "pw_in"), (7, "pw_out")):
        m[f"{t}.conv.net.{idx}.weight"] = (f"{f}/conv/{name}/conv/kernel", _conv1d)
        m[f"{t}.conv.net.{idx}.bias"] = (f"{f}/conv/{name}/conv/bias", _ident)
    m[f"{t}.conv.net.4.conv.weight"] = (f"{f}/conv/dw_conv/conv/kernel", _conv1d)
    m[f"{t}.conv.net.4.conv.bias"] = (f"{f}/conv/dw_conv/conv/bias", _ident)
    m[f"{t}.conv.net.5.weight"] = (f"{f}/conv/bn/scale", _ident)
    m[f"{t}.conv.net.5.bias"] = (f"{f}/conv/bn/bias", _ident)
    m[f"{t}.post_norm.weight"] = (f"{f}/post_norm/scale", _ident)
    m[f"{t}.post_norm.bias"] = (f"{f}/post_norm/bias", _ident)
    return m


def _dense_block_map(t: str, f: str, depth: int) -> Dict[str, tuple]:
    m = {}
    for i in range(1, depth + 1):
        m[f"{t}.conv{i}.weight"] = (f"{f}/conv{i}/kernel", _conv2d)
        m[f"{t}.conv{i}.bias"] = (f"{f}/conv{i}/bias", _ident)
        m[f"{t}.norm{i}.weight"] = (f"{f}/norm{i}/scale", _ident)
        m[f"{t}.norm{i}.bias"] = (f"{f}/norm{i}/bias", _ident)
        m[f"{t}.prelu{i}.weight"] = (f"{f}/prelu{i}/alpha", _ident)
    return m


def _conv_norm_prelu(t: str, conv: str, norm: str, prelu: str) -> Dict[str, tuple]:
    """A reference Sequential(conv, InstanceNorm, PReLU) at key prefix t."""
    return {
        f"{t}.0.weight": (f"{conv}/conv/kernel", _conv2d),
        f"{t}.0.bias": (f"{conv}/conv/bias", _ident),
        f"{t}.1.weight": (f"{norm}/scale", _ident),
        f"{t}.1.bias": (f"{norm}/bias", _ident),
        f"{t}.2.weight": (f"{prelu}/alpha", _ident),
    }


def param_map(num_tscb: int = 4, depth: int = 4) -> Dict[str, tuple]:
    """torch key -> (flax params path, flax->torch transform)."""
    m = {}
    m.update(_conv_norm_prelu("dense_encoder.conv_1", "encoder/conv_in",
                              "encoder/norm_in", "encoder/prelu_in"))
    m.update(_dense_block_map("dense_encoder.dilated_dense", "encoder/dense", depth))
    m.update(_conv_norm_prelu("dense_encoder.conv_2", "encoder/conv_down",
                              "encoder/norm_down", "encoder/prelu_down"))
    for k in range(1, num_tscb + 1):
        for which in ("time", "freq"):
            m.update(_conformer_map(f"TSCB_{k}.{which}_conformer", f"tscb_{k}/{which}_conformer"))
    for dec in ("mask_decoder", "complex_decoder"):
        m.update(_dense_block_map(f"{dec}.dense_block", f"{dec}/dense", depth))
        m[f"{dec}.sub_pixel.conv.weight"] = (f"{dec}/sub_pixel/conv/conv/kernel", _conv2d)
        m[f"{dec}.sub_pixel.conv.bias"] = (f"{dec}/sub_pixel/conv/conv/bias", _ident)
        m[f"{dec}.norm.weight"] = (f"{dec}/norm/scale", _ident)
        m[f"{dec}.norm.bias"] = (f"{dec}/norm/bias", _ident)
        m[f"{dec}.prelu.weight"] = (f"{dec}/prelu/alpha", _ident)
    for name in ("conv_1", "final_conv"):
        m[f"mask_decoder.{name}.weight"] = (f"mask_decoder/{name}/conv/kernel", _conv2d)
        m[f"mask_decoder.{name}.bias"] = (f"mask_decoder/{name}/conv/bias", _ident)
    m["mask_decoder.prelu_out.weight"] = ("mask_decoder/prelu_out/alpha", _ident)
    m["complex_decoder.conv.weight"] = ("complex_decoder/conv/conv/kernel", _conv2d)
    m["complex_decoder.conv.bias"] = ("complex_decoder/conv/conv/bias", _ident)
    return m


def stats_map(num_tscb: int = 4) -> Dict[str, str]:
    """torch BatchNorm buffer key -> flax batch_stats path."""
    m = {}
    for k in range(1, num_tscb + 1):
        for which in ("time", "freq"):
            t, f = f"TSCB_{k}.{which}_conformer", f"tscb_{k}/{which}_conformer"
            m[f"{t}.conv.net.5.running_mean"] = f"{f}/conv/bn/mean"
            m[f"{t}.conv.net.5.running_var"] = f"{f}/conv/bn/var"
    return m


def _lookup(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def state_dict_from_flax(params: Mapping, batch_stats: Mapping, num_tscb: int = 4,
                         depth: int = 4) -> Dict[str, torch.Tensor]:
    """flax generator variables -> the port's (reference-layout) state_dict.

    params / batch_stats: the nested dicts of a JAX TSCNet's variables.
    BatchNorm's num_batches_tracked, which flax does not keep, is 0.
    """
    sd = {}
    for tkey, (fpath, tf) in param_map(num_tscb, depth).items():
        sd[tkey] = torch.tensor(np.ascontiguousarray(tf(_lookup(params, fpath))))
    for tkey, fpath in stats_map(num_tscb).items():
        sd[tkey] = torch.tensor(_lookup(batch_stats, fpath))
        sd[tkey.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


DISC_SN_LAYERS = ("conv1", "conv2", "conv3", "conv4", "fc1", "fc2")


def disc_state_dict_from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """flax MetricDiscriminator variables -> the port's state_dict.

    The n-th spectral-norm wrapper (flax names them in call order:
    conv1..conv4, fc1, fc2) keeps `u` [1, O] and the scalar `sigma`.
    """
    sd = {}
    for n, name in enumerate(DISC_SN_LAYERS):
        kernel = np.asarray(params[name]["kernel"])
        sd[f"{name}.layer.weight"] = _conv2d(kernel) if kernel.ndim == 4 else _linear(kernel)
        if "bias" in params[name]:
            sd[f"{name}.layer.bias"] = params[name]["bias"]
        stats = batch_stats[f"SpectralNorm_{n}"]
        sd[f"{name}.u"] = stats[f"{name}/kernel/u"]
        sd[f"{name}.sigma"] = stats[f"{name}/kernel/sigma"]
    for i in range(1, 5):
        sd[f"norm{i}.weight"] = params[f"norm{i}"]["scale"]
        sd[f"norm{i}.bias"] = params[f"norm{i}"]["bias"]
        sd[f"prelu{i}.weight"] = params[f"prelu{i}"]["alpha"]
    sd["fc_prelu.weight"] = params["fc_prelu"]["alpha"]
    sd["sigmoid.slope"] = params["sigmoid"]["slope"]
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
