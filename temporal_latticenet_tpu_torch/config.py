"""Typed model and runtime configuration of the PyTorch port.

A copy of ``ModelConfig`` and ``RuntimeConfig`` from the JAX package's
``config.py`` (same field names, defaults and capacity rules), so that the
port depends on nothing of that package.  The hjson ``.cfg`` parser is not
needed by the offline sequence forward and is not copied.
"""

from __future__ import annotations

import dataclasses

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
