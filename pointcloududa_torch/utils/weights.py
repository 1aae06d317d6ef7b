"""Carry the JAX package's weights into the port's modules.

Input: the flax variables of one network as numpy (or array-like) pytrees,
``{"params": ..., "batch_stats": ...}``. Output: a ``state_dict`` for the
port's module, in the reference's key layout, so
``pointcloududa_tpu/utils/torch_import.py`` is the exact inverse.

Layout conversions (flax -> torch): conv HWIO -> OIHW; Conv1d (1, I, O) ->
(O, I, 1); Dense (I, O) -> (O, I); BatchNorm {scale, bias} + {mean, var} ->
{weight, bias, running_mean, running_var} plus ``num_batches_tracked`` (0:
flax keeps no counter, and nothing reads it).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv2d(k):  # HWIO -> OIHW
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _conv1d(k):  # (1, I, O) -> (O, I, 1)
    return _t(np.transpose(np.asarray(k), (2, 1, 0)))


def _dense(k):  # (I, O) -> (O, I)
    return _t(np.asarray(k).T)


def _put_bn(sd, dst: str, params, stats) -> None:
    sd[f"{dst}.weight"] = _t(params["scale"])
    sd[f"{dst}.bias"] = _t(params["bias"])
    sd[f"{dst}.running_mean"] = _t(stats["mean"])
    sd[f"{dst}.running_var"] = _t(stats["var"])
    sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def generator_state_dict(variables: Dict[str, Any], drop: bool = False) -> Dict[str, torch.Tensor]:
    """flax ``SegmentationPointModel`` (standard layout) -> port
    ``SegmentationPointModel``. ``drop``: the decoder has Dropout layers,
    which shift the numbering of its double convs."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def put_pair(dst: str, src_params, src_stats, base: str, dropout: bool) -> None:
        # children: conv, lrelu, [dropout], bn, conv, lrelu, bn
        idx = ((0, 3), (4, 6)) if dropout else ((0, 2), (3, 5))
        for j, (ci, bi) in enumerate(idx, start=1):
            name = f"{base}_conv{j}"
            sd[f"{dst}.{ci}.weight"] = _conv2d(src_params[name]["Conv_0"]["kernel"])
            sd[f"{dst}.{ci}.bias"] = _t(src_params[name]["Conv_0"]["bias"])
            _put_bn(sd, f"{dst}.{bi}", src_params[name]["BatchNorm_0"], src_stats[name]["BatchNorm_0"])

    enc, enc_s = p["encoder"], s.get("encoder", {})
    n_block = sum(1 for k in enc if k.startswith("encoder") and k.endswith("_conv1"))
    sd["encoder.conv1_1.0.weight"] = _conv2d(enc["conv1_1_dead_kernel"])
    sd["encoder.conv1_1.0.bias"] = _t(enc["conv1_1_dead_bias"])
    for k in range(1, n_block + 1):
        put_pair(f"encoder.encoder{k}", enc, enc_s, f"encoder{k}", False)
        if k > 1:
            sd[f"encoder.conv1_{k}.0.weight"] = _conv2d(enc[f"conv1_{k}"]["kernel"])
            sd[f"encoder.conv1_{k}.0.bias"] = _t(enc[f"conv1_{k}"]["bias"])
    for name, v in p["bottleneck"].items():
        sd[f"bottleneck.{name}.0.weight"] = _conv2d(v["kernel"])
        sd[f"bottleneck.{name}.0.bias"] = _t(v["bias"])
    if "pointNet" in p:
        for name, v in p["pointNet"].items():
            conv = name != "final_fc"
            sd[f"pointNet.{name}.weight"] = _conv2d(v["kernel"]) if conv else _dense(v["kernel"])
            sd[f"pointNet.{name}.bias"] = _t(v["bias"])
    dec, dec_s = p["decoder"], s.get("decoder", {})
    for k in range(1, n_block + 1):
        sd[f"decoder.decoder1_{k}.1.weight"] = _conv2d(dec[f"decoder1_{k}"]["kernel"])
        sd[f"decoder.decoder1_{k}.1.bias"] = _t(dec[f"decoder1_{k}"]["bias"])
        put_pair(f"decoder.decoder2_{k}", dec, dec_s, f"decoder2_{k}", drop)
    sd["classifier.weight"] = _conv2d(p["classifier"]["kernel"])
    sd["classifier.bias"] = _t(p["classifier"]["bias"])
    return sd


def discriminator_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``UncertaintyDiscriminator`` -> port ``UncertaintyDiscriminator``."""
    return {f"{name}.weight": _conv2d(v["kernel"]) for name, v in variables["params"].items()}


def pointnetcls_state_dict(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``PointNetCls`` -> port ``PointNetCls``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put_stn(dst: str, sp, ss) -> None:
        for i in (1, 2, 3):
            sd[f"{dst}.conv{i}.weight"] = _conv1d(sp[f"conv{i}"]["Conv_0"]["kernel"])
            sd[f"{dst}.conv{i}.bias"] = _t(sp[f"conv{i}"]["Conv_0"]["bias"])
            _put_bn(sd, f"{dst}.bn{i}", sp[f"n_conv{i}"]["BatchNorm_0"], ss[f"n_conv{i}"]["BatchNorm_0"])
        for j in (1, 2, 3):
            sd[f"{dst}.fc{j}.weight"] = _dense(sp[f"fc{j}"]["Dense_0"]["kernel"])
            sd[f"{dst}.fc{j}.bias"] = _t(sp[f"fc{j}"]["Dense_0"]["bias"])
        for j, bn in ((1, 4), (2, 5)):
            _put_bn(sd, f"{dst}.bn{bn}", sp[f"n_fc{j}"]["BatchNorm_0"], ss[f"n_fc{j}"]["BatchNorm_0"])

    feat, feat_s = p["feat"], s["feat"]
    for stn in ("stn", "fstn"):
        if stn in feat:
            put_stn(f"feat.{stn}", feat[stn], feat_s[stn])
    for name, v in feat.items():
        if name.startswith("conv"):
            sd[f"feat.{name}.weight"] = _conv1d(v["Conv_0"]["kernel"])
            sd[f"feat.{name}.bias"] = _t(v["Conv_0"]["bias"])
            bn = f"bn_{name}"
            _put_bn(sd, f"feat.{name.replace('conv', 'bn')}", feat[bn]["BatchNorm_0"], feat_s[bn]["BatchNorm_0"])
    for j in (1, 2, 3):
        sd[f"fc{j}.weight"] = _dense(p[f"fc{j}"]["Dense_0"]["kernel"])
        sd[f"fc{j}.bias"] = _t(p[f"fc{j}"]["Dense_0"]["bias"])
    for bn in ("bn1", "bn2"):
        _put_bn(sd, bn, p[bn]["BatchNorm_0"], s[bn]["BatchNorm_0"])
    return sd


def state_dicts(nets: Dict[str, Any], drop: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"gen": vars, "d1": vars, "d2": vars, "d4": vars}`` (absent or None
    where disabled) -> the port's ``state_dict`` per network."""
    convert = {"gen": partial(generator_state_dict, drop=drop), "d1": discriminator_state_dict,
               "d2": discriminator_state_dict, "d4": pointnetcls_state_dict}
    return {k: convert[k](v) for k, v in nets.items() if v is not None}


def load_jax_variables(models, nets: Dict[str, Any], drop: bool = False) -> None:
    """Load ``nets`` (as for :func:`state_dicts`) into the port's
    (gen, d1, d2, d4) modules, strictly."""
    sds = state_dicts(nets, drop)
    for key, module in zip(("gen", "d1", "d2", "d4"), models):
        if module is not None:
            module.load_state_dict(sds[key], strict=True)
