"""Configuration of the PyTorch port: the hjson ``.cfg`` parser and the
typed model and runtime configuration.

A copy of the JAX package's ``config.py`` (the same parser, field names,
defaults and capacity rules), so that the port depends on nothing of that
package.  Runs are driven by one hjson ``.cfg`` file (``seq_config/``);
``hjson`` itself is not required: ``loads`` reads the subset the configs
use plus hjson's common extras -- ``//``/``#``/``/* */`` comments, unquoted
keys, optional commas, nested objects and arrays, double-, single- and
triple-single-quoted (multiline) strings, numbers and booleans.
"""

from __future__ import annotations

import dataclasses
import re
import textwrap

# ---------------------------------------------------------------------------
# hjson-subset parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<mstr>'''(?:[^']|'(?!''))*''')
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<punct>[{}\[\]:,])
  | (?P<word>[^\s{}\[\]:,"']+)
""", re.VERBOSE | re.DOTALL)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"cfg parse error at char {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        yield m.lastgroup, m.group()
    yield "eof", ""


class _Parser:
    def __init__(self, text: str):
        self.toks = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def parse_value(self):
        kind, tok = self.peek()
        if tok == "{":
            return self.parse_object()
        if tok == "[":
            return self.parse_array()
        self.next()
        if kind == "mstr":
            # hjson multiline string: strip the quotes and the common
            # leading whitespace (hjson trims to the opening-quote column;
            # textwrap.dedent is the practical equivalent for these configs)
            body = tok[3:-3]
            if body.startswith("\n"):
                body = body[1:]
            return textwrap.dedent(body).rstrip("\n")
        if kind == "str":
            return tok[1:-1].encode().decode("unicode_escape")
        if tok in ("true", "True"):
            return True
        if tok in ("false", "False"):
            return False
        if tok in ("null", "None"):
            return None
        try:
            return int(tok)
        except ValueError:
            pass
        try:
            return float(tok)
        except ValueError:
            return tok  # bare word -> string

    def parse_object(self):
        assert self.next()[1] == "{"
        out = {}
        while True:
            kind, tok = self.peek()
            if tok == "}":
                self.next()
                return out
            if tok == ",":
                self.next()
                continue
            key = self.next()[1]
            if kind == "str":
                key = key[1:-1]
            assert self.next()[1] == ":", f"expected ':' after key {key!r}"
            out[key] = self.parse_value()

    def parse_array(self):
        assert self.next()[1] == "["
        out = []
        while True:
            _, tok = self.peek()
            if tok == "]":
                self.next()
                return out
            if tok == ",":
                self.next()
                continue
            out.append(self.parse_value())


def loads(text: str) -> dict:
    p = _Parser(text)
    # allow a bare top-level object without braces (hjson permits it; our
    # cfgs always use key: {...} sections at top level)
    if p.peek()[1] == "{":
        return p.parse_object()
    out = {}
    while p.peek()[0] != "eof":
        kind, key = p.next()
        if kind == "str":
            key = key[1:-1]
        assert p.next()[1] == ":"
        out[key] = p.parse_value()
    return out


def load_file(path: str) -> dict:
    with open(path, "r") as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# cfgParser-compatible facade (the reference's cfgParser class)
# ---------------------------------------------------------------------------

class cfgParser:
    """Drop-in equivalent of the reference's cfgParser class."""

    def __init__(self, cfg_file: str):
        self.contents = load_file(cfg_file)

    def get_core_vars(self):
        return self.contents["core"]

    def get_train_vars(self):
        return self.contents["train"]

    def get_eval_vars(self):
        return self.contents["eval"]

    def get_model_vars(self):
        return self.contents["model"]

    def get_lattice_gpu_vars(self):
        return self.contents["lattice_gpu"]

    def _dataset_name(self):
        section = self.contents.get("train") or self.contents.get("eval")
        return section["dataset_name"]

    def get_loader_vars(self):
        return self.contents[f"loader_{'semantic_kitti' if self._dataset_name() == 'semantickitti' else 'paris_lille'}"]

    def get_loader_semantic_kitti_vars(self):
        return self.contents["loader_semantic_kitti"]

    def get_loader_paris_lille_vars(self):
        return self.contents["loader_paris_lille"]

    def get_label_mngr_vars(self):
        return self.get_loader_vars()["label_mngr"]

    def get_transformer_vars(self):
        return self.get_loader_vars()["transformer"]

    def get_runtime_vars(self):
        return self.contents.get("runtime", {})


# ---------------------------------------------------------------------------
# Typed model/runtime configuration
# ---------------------------------------------------------------------------

FUSION_KINDS = ("linear", "maxpool", "cga", "aflow", "lstm", "gru", "none")

VALID_EXPERIMENTS = (
    "none", "slice_no_deform", "pointnet_no_elevate", "pointnet_no_local_mean",
    "pointnet_no_elevate_no_local_mean", "splat", "attention_pool",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (the ``model:`` cfg section)."""

    nr_classes: int = 26
    positions_mode: str = "xyz"
    values_mode: str = "reflectance"
    pointnet_layers: tuple = (16, 32, 64)
    pointnet_start_nr_channels: int = 64
    nr_downsamples: int = 2
    nr_blocks_down_stage: tuple = (2, 2, 2)
    nr_blocks_bottleneck: int = 3
    nr_blocks_up_stage: tuple = (1, 2, 2)
    nr_levels_down_with_normal_resnet: int = 3
    nr_levels_up_with_normal_resnet: int = 3
    compression_factor: float = 1.0
    dropout_last_layer: float = 0.0
    experiment: str = "none"
    sequence_learning: bool = True
    rnn_modules: tuple = ("gru", "gru", "aflow", "gru")
    train_alpha_beta: bool = True
    use_center: bool = True
    frames_per_seq: int = 4
    # only the last up-stage's resnet blocks run (reference quirk); True
    # restores the "fixed" architecture
    apply_all_up_resnets: bool = False
    # operand type of the lattice convolutions and the pointnet MLP
    # (products accumulate in float32)
    compute_dtype: str = "bfloat16"
    # reference bary-argmax quirk of the f32 per-frame pointnet path
    reference_bary_quirk: bool = False

    def __post_init__(self):
        if self.experiment not in VALID_EXPERIMENTS:
            raise ValueError(f"invalid experiment {self.experiment!r}")
        mods = tuple(m.lower() if m.lower() in FUSION_KINDS[:-1] else "none"
                     for m in self.rnn_modules)
        object.__setattr__(self, "rnn_modules", mods)
        object.__setattr__(self, "pointnet_layers", tuple(self.pointnet_layers))
        object.__setattr__(self, "nr_blocks_down_stage",
                           tuple(self.nr_blocks_down_stage))
        object.__setattr__(self, "nr_blocks_up_stage",
                           tuple(self.nr_blocks_up_stage))
        if self.sequence_learning and all(m == "none" for m in self.rnn_modules):
            raise ValueError(
                "If sequence_learning, rnn_modules cannot all be none")

    # channel widths at the four fusion sites
    @property
    def early_channels(self):
        return self.pointnet_layers[-1] * 2

    @property
    def middle_channels(self):
        return self.pointnet_start_nr_channels

    @property
    def bottleneck_channels(self):
        return self.pointnet_start_nr_channels * 4

    @property
    def late_channels(self):
        return self.pointnet_start_nr_channels * 3


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static sizing: padded points per frame and per-level vertex
    capacities (the whole-sequence lattice is built at these sizes)."""

    max_points: int = 131072
    capacity_level0: int = 98304
    capacity_decay: float = 0.5
    min_capacity: int = 8192
    sigma: float = 0.6
    compute_dtype: str = "float32"
    # pointnet MLP + packed max for all frames at once over the
    # union-sorted rows (bf16 only); otherwise per frame over its own rows
    batched_pointnet: bool = True
    remat_mode: str = "full"
    # capacity of the trimmed (non-final) frames; 0 disables
    trim_capacity_level0: int = 0
    # capacity of the final frame; 0 disables
    final_capacity_level0: int = 0

    def capacities(self, nr_downsamples: int) -> tuple:
        caps = [self.capacity_level0]
        for _ in range(nr_downsamples):
            caps.append(max(int(caps[-1] * self.capacity_decay),
                            self.min_capacity))
        return tuple(caps)

    def _derived(self, level0: int, nr_downsamples: int) -> tuple:
        full = self.capacities(nr_downsamples)
        caps = [min(level0, full[0])]
        for i in range(nr_downsamples):
            caps.append(min(max(int(caps[-1] * self.capacity_decay),
                                self.min_capacity), full[i + 1]))
        return tuple(caps)

    def trim_capacities(self, nr_downsamples: int) -> tuple | None:
        """Per-level trimmed-frame capacities, or None when disabled."""
        if not self.trim_capacity_level0:
            return None
        return self._derived(self.trim_capacity_level0, nr_downsamples)

    def final_capacities(self, nr_downsamples: int) -> tuple | None:
        """Per-level final-frame capacities, or None when disabled."""
        if not self.final_capacity_level0:
            return None
        return self._derived(self.final_capacity_level0, nr_downsamples)


def model_config_from_cfg(parser: cfgParser, nr_classes: int) -> ModelConfig:
    m = parser.get_model_vars()
    loader = parser.get_loader_vars()
    return ModelConfig(
        nr_classes=nr_classes,
        positions_mode=m["positions_mode"],
        values_mode=m["values_mode"],
        pointnet_layers=tuple(m["pointnet_layers"]),
        pointnet_start_nr_channels=m["pointnet_start_nr_channels"],
        nr_downsamples=m["nr_downsamples"],
        nr_blocks_down_stage=tuple(m["nr_blocks_down_stage"]),
        nr_blocks_bottleneck=m["nr_blocks_bottleneck"],
        nr_blocks_up_stage=tuple(m["nr_blocks_up_stage"]),
        nr_levels_down_with_normal_resnet=m["nr_levels_down_with_normal_resnet"],
        nr_levels_up_with_normal_resnet=m["nr_levels_up_with_normal_resnet"],
        compression_factor=m["compression_factor"],
        dropout_last_layer=m["dropout_last_layer"],
        experiment=m.get("experiment", "none"),
        sequence_learning=m["sequence_learning"],
        rnn_modules=tuple(m["rnn_modules"]),
        # the reference never forwards these two to its AFlow modules (its
        # behaviour is always true/true); the cfg is honoured here
        train_alpha_beta=m.get("train_alpha_beta", True),
        use_center=m.get("use_center", True),
        frames_per_seq=(loader["frames_per_seq"] if m["sequence_learning"] else 1),
        compute_dtype=parser.get_runtime_vars().get("compute_dtype", "bfloat16"),
    )


def runtime_config_from_cfg(parser: cfgParser) -> RuntimeConfig:
    lat = parser.get_lattice_gpu_vars()
    sigma_str = str(lat.get("sigma_0", "0.6 3")).split()
    sigma = float(sigma_str[0])
    rt = parser.get_runtime_vars()
    cap = rt.get("capacity_level0", lat.get("hash_table_capacity", 65536))
    return RuntimeConfig(
        max_points=rt.get("max_points", 131072),
        capacity_level0=int(cap),
        capacity_decay=rt.get("capacity_decay", 0.5),
        min_capacity=rt.get("min_capacity", 4096),
        sigma=sigma,
        compute_dtype=rt.get("compute_dtype", "float32"),
        batched_pointnet=rt.get("batched_pointnet", True),
        remat_mode=rt.get("remat_mode", "full"),
        trim_capacity_level0=int(rt.get("trim_capacity_level0", 0)),
        final_capacity_level0=int(rt.get("final_capacity_level0", 0)),
    )


def nr_classes_from_cfg(parser: cfgParser) -> int:
    """Class count of the dataset: 26/20 for SemanticKITTI and 12/10 for
    Paris-Lille, with and without the moving classes."""
    loader = parser.get_loader_vars()
    name = parser._dataset_name()
    moving = loader.get("include_moving_classes", False)
    if name == "semantickitti":
        return 26 if moving else 20
    return 12 if moving else 10
