"""The benchmark's weights: every entry of the model's state_dict schema
(names and shapes of the reference, which the port shares) drawn on the
device from the seed in one call, then scaled by the entry's kind.

* a matrix: N(0, 1/fan_in), fan_in its input width (a lattice
  convolution's (9 Cin, Cout) weight reads its rows; torch's (out, in)
  layout its columns); the deform slice's ``linear_deltaW`` at a tenth;
* a bias: N(0, 0.02^2);
* a GroupNorm gain 1 + N(0, 0.1^2), its shift N(0, 0.1^2);
* AFlow's alpha and beta 0.1 + N(0, 0.02^2).
"""

from __future__ import annotations

import math

import torch

from reference.models.blocks import LatticeConv, MaskedGroupNorm
from reference.models.fusion import _AFlowParams


def _kinds(model) -> dict:
    """{state_dict name: (kind, fan_in)}."""
    kinds = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, MaskedGroupNorm):
                kinds[name] = ("gn_" + pname, 0)
            elif isinstance(mod, _AFlowParams) and pname in ("alpha", "beta"):
                kinds[name] = ("aflow", 0)
            elif p.dim() == 1:
                kinds[name] = ("bias", 0)
            elif isinstance(mod, (LatticeConv, _AFlowParams)):
                kinds[name] = ("matrix", p.shape[0])
            else:
                kinds[name] = ("matrix", p.shape[1])
            if "linear_deltaW" in name and p.dim() == 2:
                kinds[name] = ("delta", p.shape[1])
    return kinds


def make_weights(model, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for ``model``'s state_dict."""
    schema = model.state_dict()
    kinds = _kinds(model)
    total = sum(t.numel() for t in schema.values())
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, t in schema.items():
        x = flat[at: at + t.numel()].view(t.shape)
        at += t.numel()
        kind, fan_in = kinds[name]
        if kind == "matrix":
            x = x / math.sqrt(fan_in)
        elif kind == "delta":
            x = x * (0.1 / math.sqrt(fan_in))
        elif kind == "bias":
            x = x * 0.02
        elif kind == "gn_weight":
            x = 1.0 + 0.1 * x
        elif kind == "gn_bias":
            x = 0.1 * x
        elif kind == "aflow":
            x = 0.1 + 0.02 * x
        out[name] = x.contiguous()
    return out
