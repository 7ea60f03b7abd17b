"""The port's initialisation (``LNNSeq.init_weights``) against the JAX
package's flax init, on the CPU, for the flagship fusions
(gru-gru-aflow-gru) at ``tests/test_torch_configs.py``'s ``TINY`` widths.

The two packages draw from different generators, so no value can match;
what must match is each parameter's distribution.  Each port parameter is
given the distribution of its module (:func:`_rules`), and both the port's
values and JAX's (through ``params_from_jax``, in the port's names and
layout) are held to it:

* constants: the GroupNorm scales (1) and biases (0), AFlow's alpha and
  beta (0.1), AFlow's unused conv weight and the deform head
  (``linear_deltaW``, 0), the pointnet's gamma where it has one (1): equal
  to the constant everywhere;
* U(+-b): the lattice convolutions' kernels, b = sqrt(6 / fan_in) over the
  true fan-in; their biases, the linear, 1x1 and GRU layers, b =
  1/sqrt(fan_in) (the GRU's hidden size): every value inside [-b, b], and
  with n >= 32 values the largest |value| above b (1 - 10/n) (the chance
  that n uniform draws all miss it is (1 - 10/n)^n < 5e-5) and the
  standard deviation within 5 standard errors (0.45/sqrt(n) relative) of
  b/sqrt(3);
* N(0, s): the pointnet MLP's kaiming-normal kernels, s = sqrt(2/fan_in):
  the standard deviation within 5 standard errors (0.71/sqrt(n)
  relative) of s.
"""

import math

import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models import blocks, fusion, pointnet
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

from .test_torch_configs import (RT, TINY, _clouds, _jparams,  # noqa: F401
                                 _one_torch_thread)

SE_UNIFORM = 0.45    # relative standard error of a uniform sample's std
SE_NORMAL = 0.71     # ... of a normal sample's std
N_SE = 5
MIN_N = 32           # fewer values: the bound alone


@pytest.fixture(scope="module")
def params():
    """The port's seed-0 parameters and JAX's, both in the port's names."""
    pos, val, _, mask = _clouds(1, 96, 80, 2.0, 0)
    jparams = _jparams(JModelConfig(**TINY), JRuntimeConfig(**RT),
                       (pos[0], val[0], mask[0]))
    cfg = ModelConfig(**TINY)
    model = LNNSeq(cfg, RuntimeConfig(**RT), device="cpu", seed=0)
    return model, params_from_jax(jparams, cfg)


def _rules(model):
    """{parameter name: ("const", value) | ("uniform", b) | ("normal", s)}
    from each module's kind and fan-in."""
    out = {}
    for mname, mod in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(mod, blocks.LatticeConv):
            out[pre + "weight"] = ("uniform", math.sqrt(6.0 / mod.fan_in))
            if mod.bias is not None:
                out[pre + "bias"] = ("uniform", 1.0 / math.sqrt(mod.fan_in))
        elif isinstance(mod, blocks.Linear):
            fan_in = mod.weight.shape[1]
            if mod.init == "zeros":
                w = b = ("const", 0.0)
            else:
                b = ("uniform", 1.0 / math.sqrt(fan_in))
                w = (("normal", math.sqrt(2.0 / fan_in))
                     if mod.init == "kaiming_normal" else b)
            out[pre + "weight"] = w
            if mod.bias is not None:
                out[pre + "bias"] = b
        elif isinstance(mod, blocks.MaskedGroupNorm):
            out[pre + "weight"] = ("const", 1.0)
            out[pre + "bias"] = ("const", 0.0)
        elif isinstance(mod, (fusion._GRUCell, fusion._LSTMCell)):
            for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                out[pre + p] = ("uniform", 1.0 / math.sqrt(mod.hidden))
        elif isinstance(mod, fusion._AFlowParams):
            for p in ("alpha", "beta"):
                if hasattr(mod, p):
                    out[pre + p] = ("const", 0.1)
            out[pre + "weight"] = ("const", 0.0)
            if mod.bias is not None:
                out[pre + "bias"] = ("uniform",
                                     1.0 / math.sqrt(mod.weight.shape[0]))
        elif isinstance(mod, pointnet.PointNetSeq) and hasattr(mod, "gamma"):
            out[pre + "gamma"] = ("const", 1.0)
    return out


def _holds(x: np.ndarray, rule) -> str | None:
    """Why ``x`` does not follow ``rule``, or None."""
    kind, arg = rule
    x = x.astype(np.float64).ravel()
    n = x.size
    if kind == "const":
        return None if (x == np.float32(arg)).all() else f"not all {arg}"
    std, top = x.std(), np.abs(x).max()
    if kind == "uniform":
        if top > arg:
            return f"|x| {top} above the bound {arg}"
        if n >= MIN_N and top < arg * (1 - 10 / n):
            return f"largest |x| {top} well inside the bound {arg}"
        want, se = arg / math.sqrt(3.0), SE_UNIFORM
    else:
        want, se = arg, SE_NORMAL
    if n >= MIN_N and abs(std / want - 1) > N_SE * se / math.sqrt(n):
        return f"std {std} for {want} over {n} values"
    return None


def test_init_weights_follow_flax_init(params):
    model, jax_sd = params
    port = {k: v.detach().numpy() for k, v in model.named_parameters()}
    rules = _rules(model)
    assert sorted(rules) == sorted(port)       # every parameter has a rule
    assert sorted(jax_sd) == sorted(port)
    kinds = {}
    for name, rule in rules.items():
        assert port[name].shape == tuple(jax_sd[name].shape), name
        for side, x in (("port", port[name]), ("jax", jax_sd[name].numpy())):
            why = _holds(x, rule)
            assert why is None, (side, name, rule, why)
        kinds[rule[0]] = kinds.get(rule[0], 0) + 1
    # the flagship holds all three kinds, and the zeros the docstring names
    assert kinds["const"] and kinds["uniform"] and kinds["normal"], kinds
    zeros = {k for k, r in rules.items() if r == ("const", 0.0)}
    assert {"recurrent_fusion_modules.1.AFLOW.weight",
            "slice_fast_cuda.linear_deltaW.weight",
            "slice_fast_cuda.linear_deltaW.bias"} <= zeros, zeros


def test_init_weights_is_the_seed_s_draw():
    """``init_weights(seed)`` redraws every random parameter from the seed:
    the same seed gives the same values, another seed other values."""
    cfg, rt = ModelConfig(**TINY), RuntimeConfig(**RT)
    a = LNNSeq(cfg, rt, device="cpu", seed=0)
    b = LNNSeq(cfg, rt, device="cpu", seed=1)
    b.init_weights(0)
    c = LNNSeq(cfg, rt, device="cpu", seed=1)
    rules = _rules(a)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if rules[name][0] != "const":
            assert not torch.equal(pa, pc), name
