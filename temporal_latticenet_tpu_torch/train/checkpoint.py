"""Checkpoints of the PyTorch port: weights, optimizer state and step in one
``torch.save`` file (``.ckpt``), the reference's config-encoding file
names, and the reference's ``.pt`` state_dicts.

A ``.ckpt`` resumes exactly: the model's ``state_dict``, the AdamW state
(its moments and amsgrad's ``max_exp_avg_sq``, the step of every
parameter, the groups' learning rates) and the loop's step count.

A ``.pt`` is a reference-schema state_dict (the reference's pretrained
checkpoints, and what the JAX package's
``train/torch_convert.export_state_dict`` writes from flax parameters).
The port's parameters already carry the reference's names and torch's
layouts, so a ``.pt`` needs no transposes: :func:`convert_state_dict`
resolves the nesting variants of the reference's blocks (``gn`` for
``gn.gn``, ``linear_classify`` for ``linear_clasify`` ...) onto the
port's names, :func:`validate_converted` checks every key and shape, and
``load_state_dict(strict=True)`` loads.  Any source key left unconsumed,
and any missing, extra or transposed key, fails with a report for each.
The JAX package's own flax ``.ckpt`` (msgpack) is not read: weights move
from it as a ``.pt`` in that schema.  Every ``experiment``'s schema loads:
no pointnet MLP for the no-elevate experiments and ``splat``, no deform
weights for ``slice_no_deform``, and the attention pool's ``gamma``,
``pre_conv``, ``att_activ`` and ``att_scores`` under the port's names.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import Mapping

import torch

from ..models.pointnet import NO_ELEVATE


def checkpoint_name(include_moving: bool, dataset_name: str, values_mode: str,
                    sigma: float, rnn_modules, frames: int, scope: int,
                    epoch: int, accumulate_clouds: bool = False) -> str:
    """The reference's file name schema (upstream train_ln.py:250)."""
    date_time = datetime.now().strftime("%d%m%Y_%H%M")
    return "{}_{}_{}_{}_sigma{}_type{}_frames{}_scope{}_epoch{}".format(
        date_time,
        "multi" if include_moving else "single",
        "Kitti" if dataset_name == "semantickitti" else "Paris",
        "Ref" if values_mode == "reflectance" else "xyz",
        str(sigma)[0:3],
        "-".join(rnn_modules) if not accumulate_clouds else "ACCUM",
        frames, scope, epoch)


def save(path: str, model: torch.nn.Module, optimizer=None, step: int = 0):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"model": model.state_dict(), "step": int(step)}
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    torch.save(payload, path)


def load(path: str, model: torch.nn.Module, optimizer=None, cfg=None) -> int:
    """Restore ``model`` (and ``optimizer``, when given and saved) from
    ``path`` in place; returns the saved step.

    A ``.pt`` path is a reference-schema state_dict
    (:func:`load_pt_checkpoint`): the weights load strictly, the optimizer
    starts fresh (the reference saves weights only) and the step is 0."""
    if path.endswith(".pt"):
        if cfg is None:
            raise ValueError("loading a .pt checkpoint needs the model cfg")
        load_pt_checkpoint(path, cfg, model)
        return 0
    payload = torch.load(path, map_location=model.device, weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    if optimizer is not None and "optimizer" in payload:
        optimizer.load_state_dict(payload["optimizer"])
    return int(payload["step"])


# ---------------------------------------------------------------------------
# reference .pt state_dicts
# ---------------------------------------------------------------------------

GN_INNER = ("gn.gn", "gn", "norm.gn", "norm", "bn")
CONV_INNER = ("conv", "conv.conv", "convolution", "linear")
SLICE_RENAMES = {"linear_classify": "linear_clasify"}


def _resolve_inner(sd: Mapping, prefix: str, candidates, want_ndim=None,
                   what: str = "module") -> str:
    """Tolerantly resolve the inner sub-module path under ``prefix``.

    The attribute names inside the reference's external blocks (GnReluConv
    etc.) are reconstructed from their published structure, so nesting
    variants like ``gn`` vs ``gn.gn`` must not silently fail.  Resolution
    order:

    1. each candidate ``prefix.<cand>.weight`` whose tensor has the expected
       rank (GN weights are 1-D, conv/linear weights 2-D -- within one block
       this disambiguates fully);
    2. fallback: the UNIQUE ``prefix.*.weight`` key of that rank;
    3. otherwise raise with a report of every key under the prefix.
    """
    for c in candidates:
        inner = f"{prefix}.{c}" if c else prefix
        k = inner + ".weight"
        if k in sd and (want_ndim is None or sd[k].dim() == want_ndim):
            return inner
    hits = sorted({k[: -len(".weight")] for k in sd
                   if k.startswith(prefix + ".") and k.endswith(".weight")
                   and (want_ndim is None or sd[k].dim() == want_ndim)})
    if len(hits) == 1:
        return hits[0]
    under = sorted(k for k in sd if k.startswith(prefix))
    raise KeyError(
        f"cannot resolve {what} under '{prefix}': tried {list(candidates)}, "
        f"rank-{want_ndim} matches: {hits or 'none'}; keys under prefix: "
        f"{under or 'none'}")


def _child(sd: Mapping, prefix: str, candidates, what: str) -> str:
    """Resolve a composite child module (one with weight keys below it)."""
    for c in candidates:
        if any(k.startswith(f"{prefix}.{c}.") for k in sd):
            return f"{prefix}.{c}"
    under = sorted(k for k in sd if k.startswith(prefix))
    raise KeyError(f"cannot resolve {what} under '{prefix}': tried "
                   f"{list(candidates)}; keys under prefix: {under or 'none'}")


def convert_state_dict(sd: Mapping, cfg) -> tuple[dict, dict]:
    """A reference LNN_SEQ state_dict -> the port's ``state_dict`` names.

    Walks the model of ``cfg`` as the JAX package's
    ``torch_convert.convert_state_dict`` does, resolving each block's inner
    paths with :func:`_resolve_inner`.  Returns ``(state_dict, report)``;
    ``report["unconsumed"]`` lists the source keys no part of the model
    read."""
    out: dict = {}
    consumed: set = set()

    def copy(src: str, dst: str, optional: bool = False):
        if optional and src not in sd:
            return
        out[dst] = sd[src]
        consumed.add(src)

    def weight_bias(src: str, dst: str):
        copy(src + ".weight", dst + ".weight")
        copy(src + ".bias", dst + ".bias", optional=True)

    def fusion(pre: str, kind: str):
        if kind in ("gru", "lstm"):
            cell = "GRU" if kind == "gru" else "lstm"
            weight_bias(pre + ".hidden_linear", pre + ".hidden_linear")
            for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                copy(f"{pre}.{cell}.{p}", f"{pre}.{cell}.{p}")
        elif kind == "cga":
            weight_bias(pre + ".hidden_linear", pre + ".hidden_linear")
            copy(pre + ".conv.weight", pre + ".conv.weight")
            weight_bias(pre + ".groupnorm.gn", pre + ".groupnorm.gn")
        elif kind == "linear":
            weight_bias(pre + ".hidden_linear", pre + ".hidden_linear")
            weight_bias(pre + ".linear", pre + ".linear")
        elif kind == "aflow":
            for p in ("alpha", "beta", "weight"):
                copy(f"{pre}.AFLOW.{p}", f"{pre}.AFLOW.{p}")
            copy(pre + ".AFLOW.bias", pre + ".AFLOW.bias", optional=True)
            weight_bias(pre + ".linear", pre + ".linear")
        elif kind != "maxpool":
            raise ValueError(kind)

    def gn_relu_conv(src: str, dst: str):
        weight_bias(_resolve_inner(sd, src, GN_INNER, 1, "groupnorm"),
                    dst + ".gn.gn")
        weight_bias(_resolve_inner(sd, src, CONV_INNER, 2, "conv"),
                    dst + ".conv")

    def resnet(src: str, dst: str):
        for name, cands in (("conv1", ("conv1", "gn_relu_conv1", "block1")),
                            ("conv2", ("conv2", "gn_relu_conv2", "block2"))):
            gn_relu_conv(_child(sd, src, cands, name), f"{dst}.{name}")

    def bottleneck(src: str, dst: str):
        for name, cands in (("contract", ("contract", "reduce", "down")),
                            ("conv", ("conv", "middle")),
                            ("expand", ("expand", "up"))):
            gn_relu_conv(_child(sd, src, cands, name), f"{dst}.{name}")

    pn = "point_net_seq"
    if cfg.experiment not in NO_ELEVATE:
        for i in range(len(cfg.pointnet_layers)):
            weight_bias(f"{pn}.layers.{i}", f"{pn}.layers.{i}")
    if cfg.experiment == "attention_pool":
        # the attention pool's parameters under the port's names (the
        # JAX package's export leaves them out, ROADMAP C-3); its two
        # GN-ReLU-1x1s nest as a GN-ReLU-conv does
        copy(f"{pn}.gamma", f"{pn}.gamma")
        copy(f"{pn}.pre_conv.weight", f"{pn}.pre_conv.weight")
        gn_relu_conv(f"{pn}.att_activ", f"{pn}.att_activ")
        gn_relu_conv(f"{pn}.att_scores", f"{pn}.att_scores")
    weight_bias(f"{pn}.last_conv", f"{pn}.last_conv")
    if cfg.sequence_learning and cfg.rnn_modules[0] != "none":
        fusion(f"{pn}.fusion_module", cfg.rnn_modules[0])
    for slot in range(3):
        kind = cfg.rnn_modules[slot + 1]
        if cfg.sequence_learning and kind != "none":
            fusion(f"recurrent_fusion_modules.{slot}", kind)

    L = cfg.nr_downsamples
    for i in range(L):
        for j in range(cfg.nr_blocks_down_stage[i]):
            pre = f"resnet_blocks_per_down_lvl_list.{i}.{j}"
            (resnet if i < cfg.nr_levels_down_with_normal_resnet
             else bottleneck)(pre, pre)
        gn_relu_conv(f"coarsens_list.{i}", f"coarsens_list.{i}")
    for j in range(cfg.nr_blocks_bottleneck):
        pre = f"resnet_blocks_bottleneck.{j}"
        bottleneck(pre, pre)
    for i in range(L):
        gn_relu_conv(f"finefy_list.{i}", f"finefy_list.{i}")
        for j in range(cfg.nr_blocks_up_stage[i]):
            pre = f"resnet_blocks_per_up_lvl_list.{i}.{j}"
            if any(k.startswith(pre + ".") for k in sd):
                (resnet if i >= L - cfg.nr_levels_up_with_normal_resnet
                 else bottleneck)(pre, pre)

    # the slice head's two Linears; the alternate spelling
    # "linear_classify" of the reference's "linear_clasify" [sic] is
    # accepted, any other slice key is left unconsumed
    for k in sd:
        if k.startswith("slice_fast_cuda."):
            head, _, leaf = k[len("slice_fast_cuda."):].rpartition(".")
            head = SLICE_RENAMES.get(head, head)
            if head in ("linear_deltaW", "linear_clasify"):
                copy(k, f"slice_fast_cuda.{head}.{leaf}")

    return out, {"unconsumed": sorted(set(sd) - consumed)}


def validate_converted(converted: Mapping, template: Mapping) -> None:
    """Key-by-key check of a converted state_dict against the model's:
    raises ValueError with a report for EACH missing, extra or mis-shaped
    key (a shape that is the model's reversed is named as transposed)."""
    problems = []
    for k in sorted(set(converted) | set(template)):
        if k not in template:
            problems.append(f"extra param not in model: {k} "
                            f"{tuple(converted[k].shape)}")
        elif k not in converted:
            problems.append(f"missing param: {k} (model wants "
                            f"{tuple(template[k].shape)})")
        else:
            got, want = tuple(converted[k].shape), tuple(template[k].shape)
            # load_state_dict reads a one-element vector into a 0-d
            # parameter (AFlow's alpha and beta are vectors in the schema)
            if got != want and not (got == (1,) and want == ()):
                problems.append(
                    f"shape mismatch at {k}: checkpoint {got} vs model {want}"
                    + (" (transposed?)" if got == want[::-1] else ""))
    if problems:
        raise ValueError(
            "converted state_dict does not match the model "
            f"({len(problems)} problem(s)):\n  " + "\n  ".join(problems))


def load_pt_checkpoint(path: str, cfg, model: torch.nn.Module) -> None:
    """A reference ``.pt`` state_dict -> ``model``, strictly.  Unconsumed
    source keys are a hard error: a key the converter did not route means
    the mapping (not the user) is wrong.  Prints which pointnet semantics
    the weights run under (``cfg.reference_bary_quirk``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    converted, report = convert_state_dict(sd, cfg)
    if report["unconsumed"]:
        raise ValueError(
            f"{len(report['unconsumed'])} checkpoint key(s) were not "
            f"consumed by the converter: {report['unconsumed']}")
    validate_converted(converted, model.state_dict())
    model.load_state_dict(converted, strict=True)
    print(f"loaded reference-schema weights {path} with "
          f"reference_bary_quirk={cfg.reference_bary_quirk} "
          + ("(the reference's bary-argmax quirk of the float32 per-frame "
             "pointnet)" if cfg.reference_bary_quirk
             else "(the intended argmax barycentric weights)"))
