"""Permutohedral lattice math and packed keys of the PyTorch port against
the JAX package: keys and barycentric weights bit-equal for the same
pre-scaled input (the sigma division is context-dependent in XLA, so both
sides get the JAX package's ``scale_positions`` output)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from temporal_latticenet_tpu.ops import permutohedral as jpm
from temporal_latticenet_tpu.ops import vertex_table as jvt
from temporal_latticenet_tpu_torch.ops import permutohedral as tpm
from temporal_latticenet_tpu_torch.ops import vertex_table as tvt


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((n, 3)) * 30).astype(np.float32)
    pos[:200] = rng.integers(-6, 6, (200, 3))            # on-lattice ties
    pos[200:300] = np.round(pos[200:300] * 4) / 4
    return pos


@pytest.mark.parametrize("seed,sigma", [(0, 0.6), (1, 1.0), (2, 0.35)])
def test_keys_and_bary_bit_equal(seed, sigma, monkeypatch):
    pos = _cloud(seed)
    y = np.array(jpm.scale_positions(jnp.asarray(pos), sigma))
    # JAX's elevate on the same y: its scaling step is replaced by identity
    monkeypatch.setattr(jpm, "scale_positions", lambda p, s: p)
    jel = jpm.elevate(jnp.asarray(y), sigma)
    jkeys, jbary = jpm.find_enclosing_simplex(jel)
    tel = tpm.elevate_scaled(torch.from_numpy(y))
    np.testing.assert_array_equal(tel.numpy(), np.asarray(jel))
    tkeys, tbary = tpm.find_enclosing_simplex(tel)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(tbary.numpy(), np.asarray(jbary))

    jp = np.asarray(jvt.pack_keys(jkeys.reshape(-1, 3)))
    tp = tvt.pack_keys(tkeys.reshape(-1, 3))
    np.testing.assert_array_equal(tp.numpy(), jp.astype(np.int64))
    np.testing.assert_array_equal(
        tvt.unpack_keys(tp).numpy(),
        np.asarray(jvt.unpack_keys(jnp.asarray(jp))))


def test_scale_positions_and_tables():
    pos = _cloud(3, 500)
    np.testing.assert_array_equal(tpm.scale_factors(3), jpm.scale_factors(3))
    np.testing.assert_array_equal(tpm.neighbor_offsets(3),
                                  jpm.neighbor_offsets(3))
    # sigma 0.5: a power-of-two divisor, exact in any formulation
    np.testing.assert_array_equal(
        tpm.scale_positions(torch.from_numpy(pos), 0.5).numpy(),
        np.asarray(jpm.scale_positions(jnp.asarray(pos), 0.5)))
    np.testing.assert_array_equal(
        tpm.elevate(torch.from_numpy(pos), 0.5).numpy(),
        np.asarray(jpm.elevate(jnp.asarray(pos), 0.5)))


def test_pack_keys_sentinels_and_range():
    keys = np.array([[0, 0, 0], [4, 8, -12], [1, 5, 9],
                     [jvt.SENTINEL, 0, 0], [5000, 1, 1], [-5000, 3, 3]],
                    np.int32)
    jp = np.asarray(jvt.pack_keys(jnp.asarray(keys)))
    tp = tvt.pack_keys(torch.from_numpy(keys))
    np.testing.assert_array_equal(tp.numpy(), jp.astype(np.int64))
    assert (tp.numpy()[3:] == tvt.PACKED_SENTINEL).all()
    assert tvt.PACKED_SENTINEL == int(jvt.PACKED_SENTINEL)
    assert tvt.SENTINEL == int(jvt.SENTINEL)
