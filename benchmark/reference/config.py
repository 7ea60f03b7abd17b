"""Frozen copy of the port's ``config.py`` model and runtime dataclasses
(``ModelConfig``, ``RuntimeConfig``): the static hyperparameters and the
capacity rules the benchmark's float32 reference runs at.  The reference's
``compute_dtype`` may also be ``"float8_e4m3fn"`` (the precision control)."""

from __future__ import annotations

import dataclasses

# the fusions of the benchmark's configurations (models/fusion.py)
FUSION_KINDS = ("aflow", "gru", "none")


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
    # operand type of the lattice convolutions and the pointnet MLP
    # (products accumulate in float32)
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.experiment != "none" or self.dropout_last_layer:
            raise ValueError(f"the reference runs no experiment "
                             f"({self.experiment!r}) and no dropout")
        mods = tuple(m.lower() for m in self.rnn_modules)
        if any(m not in FUSION_KINDS for m in mods):
            raise ValueError(f"the reference has no fusion of {mods}")
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
    # the port's routes: the reference runs the pointnet per frame, with no
    # rematerialisation, whatever these say
    batched_pointnet: bool = True
    remat_mode: str = "full"
    # capacity of the trimmed (non-final) frames; 0 disables
    trim_capacity_level0: int = 0
    # capacity of the final frame; 0 disables
    final_capacity_level0: int = 0

    def __post_init__(self):
        if self.trim_capacity_level0 or self.final_capacity_level0:
            raise ValueError("the reference builds no trimmed lattice")

    def capacities(self, nr_downsamples: int) -> tuple:
        caps = [self.capacity_level0]
        for _ in range(nr_downsamples):
            caps.append(max(int(caps[-1] * self.capacity_decay),
                            self.min_capacity))
        return tuple(caps)
