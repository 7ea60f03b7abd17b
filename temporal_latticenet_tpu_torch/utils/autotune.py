"""Capacity autotuning: size the static vertex tables from measured data
(the PyTorch counterpart of the JAX package's ``utils/autotune.py``).

The capacities are the tables' shapes: oversizing wastes every
vertex-dimension operation and undersizing drops vertices to the invalid
bucket.  This helper builds the sequence lattice of a few sample sequences
at generous probe capacities (kernels K1-K3 on the card), reads each
level's union count, and returns capacities with headroom, rounded to
multiples of 256.

Usage:
    caps = autotune_capacities(seq_iter, nr_downsamples=2, sigma=0.6)
    rt = RuntimeConfig(capacity_level0=caps[0], ...)
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops import seq_lattice as sl


def _round_up(x: int, m: int = 256) -> int:
    return (int(x) + m - 1) // m * m


def autotune_capacities(sequences, nr_downsamples: int, sigma,
                        headroom: float = 1.4, min_capacity: int = 2048,
                        probe_capacity: int = 262144, max_samples: int = 4,
                        device=None):
    """Measure per-level union occupancy over sample sequences.

    Args:
      sequences: iterable of (positions (T, P, 3), mask (T, P)) pairs,
        numpy arrays or tensors (e.g. drawn from a dataset's frames).
      headroom: multiplier on the measured largest occupancy (augmentation,
        scene variation).
      probe_capacity: generous level-0 capacity for the measurement pass;
        a probe that itself fills up raises, because the measurement would
        be a lie.
      device: where the lattice is built (CUDA by default).

    Returns a tuple of nr_downsamples+1 capacities (multiples of 256).
    """
    dev = resolve_device(device)
    probe_caps = tuple(max(probe_capacity >> l, min_capacity)
                       for l in range(nr_downsamples + 1))
    worst = [0] * (nr_downsamples + 1)
    n = 0
    for positions, mask in sequences:
        with torch.no_grad():
            lat = sl.build_sequence_lattice(
                torch.as_tensor(positions, device=dev),
                torch.as_tensor(mask, device=dev), sigma, probe_caps,
                nr_downsamples)
            counts = torch.stack([lvl.counts[-1] for lvl in lat.levels])
        for l, c in enumerate(counts.tolist()):
            if c >= probe_caps[l]:
                raise ValueError(
                    f"probe capacity {probe_caps[l]} saturated at level {l}; "
                    "raise probe_capacity")
            worst[l] = max(worst[l], c)
        n += 1
        if n >= max_samples:
            break
    if n == 0:
        raise ValueError("no sample sequences provided")
    return tuple(max(_round_up(w * headroom), min_capacity) for w in worst)
