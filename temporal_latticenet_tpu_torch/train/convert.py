"""JAX/flax parameter trees -> the port's ``state_dict``.

The port's modules are named after the reference PyTorch schema, the one the
JAX package's ``train/torch_convert.export_state_dict`` writes; this module
carries its own copy of that mapping (flax kernels are (in, out) and
transpose to torch's (out, in), lattice-conv kernels keep their (9*in, out)
layout), so ``LNNSeq.load_state_dict(params_from_jax(...), strict=True)``
loads weights trained with the JAX package.  Every ``experiment`` maps:
its pointnet may have no MLP layers (the no-elevate experiments and
``splat``) or carry the attention pool's ``gamma``, ``pre_conv_kernel``,
``att_activ`` and ``att_scores``, and the slice head of
``slice_no_deform`` has no deform weights.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_jax(params_np: Mapping, cfg) -> dict:
    """Nested dicts of numpy arrays (a flax ``params`` tree, with or without
    the top-level ``"params"`` key) -> {name: float32 tensor}."""
    if "params" in params_np and isinstance(params_np["params"], Mapping):
        params_np = params_np["params"]
    sd = {}

    def put(key, x, transpose=False):
        a = np.asarray(x, dtype=np.float32)
        sd[key] = torch.tensor(a.T if transpose else a)

    def linear(tpre, sub):
        put(tpre + ".weight", sub["kernel"], transpose=True)
        if "bias" in sub:
            put(tpre + ".bias", sub["bias"])

    def fusion(tpre, sub, kind):
        if kind in ("gru", "lstm"):
            cell = "GRU" if kind == "gru" else "lstm"
            linear(tpre + ".hidden_linear", sub["hidden_linear"])
            put(f"{tpre}.{cell}.weight_ih", sub[kind]["w_ih"], transpose=True)
            put(f"{tpre}.{cell}.weight_hh", sub[kind]["w_hh"], transpose=True)
            put(f"{tpre}.{cell}.bias_ih", sub[kind]["b_ih"])
            put(f"{tpre}.{cell}.bias_hh", sub[kind]["b_hh"])
        elif kind == "aflow":
            put(tpre + ".AFLOW.alpha", sub["alpha"])
            put(tpre + ".AFLOW.beta", sub["beta"])
            put(tpre + ".AFLOW.weight", sub["weight"])
            if "bias" in sub:
                put(tpre + ".AFLOW.bias", sub["bias"])
            linear(tpre + ".linear", sub["linear"])
        elif kind == "cga":
            linear(tpre + ".hidden_linear", sub["hidden_linear"])
            put(tpre + ".conv.weight", sub["conv"]["kernel"], transpose=True)
            put(tpre + ".groupnorm.gn.weight", sub["groupnorm"]["scale"])
            put(tpre + ".groupnorm.gn.bias", sub["groupnorm"]["bias"])
        elif kind == "linear":
            linear(tpre + ".hidden_linear", sub["hidden_linear"])
            linear(tpre + ".linear", sub["linear"])
        elif kind != "maxpool":
            raise ValueError(f"unknown fusion {kind!r}")

    def gn(tpre, sub):
        put(tpre + ".gn.gn.weight", sub["gn"]["scale"])
        put(tpre + ".gn.gn.bias", sub["gn"]["bias"])

    def gn_relu_conv(tpre, sub):
        gn(tpre, sub)
        put(tpre + ".conv.weight", sub["conv"]["kernel"])
        if "bias" in sub["conv"]:
            put(tpre + ".conv.bias", sub["conv"]["bias"])

    def gn_relu_1x1(tpre, sub):
        gn(tpre, sub)
        linear(tpre + ".conv", sub["conv"])

    def resnet(tpre, sub):
        gn_relu_conv(tpre + ".conv1", sub["conv1"])
        gn_relu_conv(tpre + ".conv2", sub["conv2"])

    def bottleneck(tpre, sub):
        gn_relu_1x1(tpre + ".contract", sub["contract"])
        gn_relu_conv(tpre + ".conv", sub["conv"])
        gn_relu_1x1(tpre + ".expand", sub["expand"])

    L = cfg.nr_downsamples
    for name, sub in params_np.items():
        if name == "point_net_seq":
            for i in range(len(cfg.pointnet_layers)):
                if f"layers_{i}_kernel" not in sub:
                    continue
                put(f"point_net_seq.layers.{i}.weight",
                    sub[f"layers_{i}_kernel"], transpose=True)
                put(f"point_net_seq.layers.{i}.bias", sub[f"layers_{i}_bias"])
            if "gamma" in sub:
                put("point_net_seq.gamma", sub["gamma"])
                put("point_net_seq.pre_conv.weight", sub["pre_conv_kernel"],
                    transpose=True)
                gn_relu_1x1("point_net_seq.att_activ", sub["att_activ"])
                gn_relu_1x1("point_net_seq.att_scores", sub["att_scores"])
            put("point_net_seq.last_conv.weight", sub["last_conv"]["kernel"])
            if "fusion_module" in sub:
                fusion("point_net_seq.fusion_module", sub["fusion_module"],
                       cfg.rnn_modules[0])
        elif name.startswith("recurrent_fusion_modules_"):
            slot = int(name.rsplit("_", 1)[1])
            fusion(f"recurrent_fusion_modules.{slot}", sub,
                   cfg.rnn_modules[slot + 1])
        elif name.startswith("resnet_blocks_per_down_lvl_list_"):
            i, j = map(int, name.split("list_")[1].split("_"))
            blk = (resnet if i < cfg.nr_levels_down_with_normal_resnet
                   else bottleneck)
            blk(f"resnet_blocks_per_down_lvl_list.{i}.{j}", sub)
        elif name.startswith("resnet_blocks_bottleneck_"):
            bottleneck(f"resnet_blocks_bottleneck.{int(name.rsplit('_', 1)[1])}",
                       sub)
        elif name.startswith("resnet_blocks_per_up_lvl_list_"):
            i, j = map(int, name.split("list_")[1].split("_"))
            blk = (resnet if i >= L - cfg.nr_levels_up_with_normal_resnet
                   else bottleneck)
            blk(f"resnet_blocks_per_up_lvl_list.{i}.{j}", sub)
        elif name.startswith("coarsens_list_"):
            gn_relu_conv(f"coarsens_list.{int(name.rsplit('_', 1)[1])}", sub)
        elif name.startswith("finefy_list_"):
            gn_relu_conv(f"finefy_list.{int(name.rsplit('_', 1)[1])}", sub)
        elif name == "slice_fast_cuda":
            if "deform_kernel" in sub:
                put("slice_fast_cuda.linear_deltaW.weight",
                    sub["deform_kernel"], transpose=True)
                put("slice_fast_cuda.linear_deltaW.bias", sub["deform_bias"])
            put("slice_fast_cuda.linear_clasify.weight",
                sub["classify_kernel"], transpose=True)
            put("slice_fast_cuda.linear_clasify.bias", sub["classify_bias"])
        else:
            raise KeyError(f"unmapped top-level module {name}")
    return sd
