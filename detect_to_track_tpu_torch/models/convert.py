"""weights across packages.

- `from_jax_params`: the JAX package's params pytree (nested dicts of numpy
  arrays, `DetectTrackModule.init(...)["params"]`) -> this port's
  state_dict. Conv kernels HWIO -> OIHW, Dense kernels (in, out) ->
  (out, in), FrozenBatchNorm scale / bias unchanged, `layer{l}_{b}` ->
  `layer{l}.{b}`, `downsample_conv` / `downsample_bn` -> `downsample.0` /
  `downsample.1`.
- `load_reference_state_dict`: a reference DetectTrackModule state_dict
  (torchvision backbone under `backbone.1.`, live BatchNorm statistics) ->
  this port's state_dict, folding each BatchNorm into its frozen affine.
  The counterpart of the JAX package's `convert_reference_state_dict`.
- `random_reference_state_dict`: random weights with the reference's keys,
  drawn with numpy from a seed, for smoke runs at any configuration.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .resnet import ARCHS

BN_EPS = 1e-5


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _jax_module_path(names) -> str:
    parts = []
    for n in names:
        m = re.fullmatch(r"layer(\d)_(\d+)", n)
        if m:
            parts += [f"layer{m.group(1)}", m.group(2)]
        elif n == "downsample_conv":
            parts += ["downsample", "0"]
        elif n == "downsample_bn":
            parts += ["downsample", "1"]
        else:
            parts.append(n)
    return ".".join(parts)


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX DetectTrackModule params -> this port's DetectTrackModule
    state_dict (float32 CPU tensors). Raises KeyError on a leaf it cannot
    place."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        *mods, leaf = path
        key = _jax_module_path(mods)
        if leaf == "kernel" and value.ndim == 4:  # conv, HWIO -> OIHW
            sd[f"{key}.weight"] = _t(np.transpose(value, (3, 2, 0, 1)))
        elif leaf == "kernel" and value.ndim == 2:  # dense, (in, out) -> (out, in)
            sd[f"{key}.weight"] = _t(value.T)
        elif leaf in ("bias", "scale"):
            sd[f"{key}.{leaf}"] = _t(value)
        else:
            raise KeyError(f"no counterpart for JAX param {'/'.join(path)} of shape {value.shape}")
    return sd


def load_reference_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """reference DetectTrackModule.state_dict() (numpy arrays or tensors) ->
    this port's state_dict, ready for `model.load_state_dict`."""
    sd = {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    bn_prefixes = {k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        new = key
        if key.startswith("backbone.1."):
            new = "backbone." + key[len("backbone.1.") :]
            prefix, _, leaf = key.rpartition(".")
            if prefix in bn_prefixes:
                if leaf != "weight":
                    continue  # folded with the weight below
                gamma = sd[f"{prefix}.weight"]
                beta = sd[f"{prefix}.bias"]
                scale = gamma / np.sqrt(sd[f"{prefix}.running_var"] + BN_EPS)
                bias = beta - sd[f"{prefix}.running_mean"] * scale
                port_prefix = new.rpartition(".")[0]
                out[f"{port_prefix}.scale"] = _t(scale)
                out[f"{port_prefix}.bias"] = _t(bias)
                continue
        elif key.startswith("rcnn."):
            new = key.replace("rcnn.cls_head.sm_conv", "rcnn.cls_sm_conv").replace(
                "rcnn.reg_head.sm_conv", "rcnn.reg_sm_conv"
            )
        out[new] = _t(value)
    return out


def random_reference_state_dict(cfg, seed: int = 0) -> Dict[str, np.ndarray]:
    """random float32 weights under the reference DetectTrackModule's keys for
    `cfg` (backbone convs and BatchNorm statistics under `backbone.1.`),
    drawn with numpy from `seed`: convs N(0, 1) * 0.05, biases N(0, 1) *
    0.1, BatchNorm gamma U(0.5, 1.5), beta and mean N(0, 1) * 0.1, var
    U(0.5, 1.5), the tracker's Linear N(0, 1) * 0.02."""
    conv_scale, bias_scale, fc_scale = 0.05, 0.1, 0.02
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}

    def conv(name, cin, cout, k, groups=1, bias=False):
        sd[f"{name}.weight"] = rng.standard_normal((cout, cin // groups, k, k), dtype=np.float32) * conv_scale
        if bias:
            sd[f"{name}.bias"] = rng.standard_normal(cout, dtype=np.float32) * bias_scale

    def bn(name, c):
        sd[f"{name}.weight"] = rng.random(c, dtype=np.float32) + 0.5
        sd[f"{name}.bias"] = rng.standard_normal(c, dtype=np.float32) * 0.1
        sd[f"{name}.running_mean"] = rng.standard_normal(c, dtype=np.float32) * 0.1
        sd[f"{name}.running_var"] = rng.random(c, dtype=np.float32) + 0.5

    blocks, groups, base_width = ARCHS[cfg.BACKBONE_ARCH]
    conv("backbone.1.conv1", 3, 64, 7)
    bn("backbone.1.bn1", 64)
    cin = 64
    for li, n in enumerate(blocks, start=1):
        planes = 64 * 2 ** (li - 1)
        width = int(planes * base_width / 64) * groups
        cout = planes * 4
        for bi in range(n):
            p = f"backbone.1.layer{li}.{bi}"
            conv(f"{p}.conv1", cin if bi == 0 else cout, width, 1)
            bn(f"{p}.bn1", width)
            conv(f"{p}.conv2", width, width, 3, groups)
            bn(f"{p}.bn2", width)
            conv(f"{p}.conv3", width, cout, 1)
            bn(f"{p}.bn3", cout)
            if bi == 0:
                conv(f"{p}.downsample.0", cin, cout, 1)
                bn(f"{p}.downsample.1", cout)
        cin = cout

    reg_ch, k, a = 512, cfg.K, cfg.n_anchors_per_cell
    conv("rpn.conv", 1024, reg_ch, 3, bias=True)
    conv("rpn.cls_fc", reg_ch, 2 * a, 1, bias=True)
    conv("rpn.reg_fc", reg_ch, 4 * a, 1, bias=True)
    conv("rcnn.channel_reduce", 2048, reg_ch, 3, bias=True)
    conv("rcnn.cls_head.sm_conv", reg_ch, (cfg.N_CLASSES + 1) * k * k, 1, bias=True)
    conv("rcnn.reg_head.sm_conv", reg_ch, 4 * k * k, 1, bias=True)
    fc_channels = (3 * (2 * cfg.D_MAX + 1) ** 2 + 2 * reg_ch) * k * k
    sd["c_tracker.reg_fc.weight"] = rng.standard_normal((4, fc_channels), dtype=np.float32) * fc_scale
    sd["c_tracker.reg_fc.bias"] = rng.standard_normal(4, dtype=np.float32) * bias_scale
    return sd
