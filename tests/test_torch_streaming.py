"""The PyTorch port's streaming (frame-at-a-time) path against the JAX
package's, on the CPU: vertex tables, distribute, neighbor tables, coarse
tables and links (in full and incremental), the splat without a sorted
view, the per-frame packed max and pointnet, and the three streaming entry
points.

Integer structure (table fields, row and corner indices, counts, neighbor
tables) must be equal.  Floats: barycentric weights within 3e-5 of the JAX
package's jitted ones (jitted XLA contracts the simplex arithmetic into
fused multiply-adds; see test_torch_seq_lattice.py), relative positions
within 1e-5 (float32 means summed in another order), float32 splats within
1e-5, and bf16 network outputs within 2e-2 (operands round alike, but a
float32 sum that differs in its last bit can round to the neighbouring bf16
value downstream).  JAX weights come through ``params_from_jax``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.data.lidar_like import lidar_sequence
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.models.pointnet import PointNetSeq as JPointNet
from temporal_latticenet_tpu.ops import lattice_ops as jlo
from temporal_latticenet_tpu.ops import permutohedral as jpm
from temporal_latticenet_tpu.ops import segment as jseg
from temporal_latticenet_tpu.ops import vertex_table as jvt
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq
from temporal_latticenet_tpu_torch.models.pointnet import PointNetSeq
from temporal_latticenet_tpu_torch.ops import lattice_ops as tlo
from temporal_latticenet_tpu_torch.ops import permutohedral as tpm
from temporal_latticenet_tpu_torch.ops import segment as tseg
from temporal_latticenet_tpu_torch.ops import vertex_table as tvt
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train.convert import params_from_jax

# sigma 0.5 scales bit-identically in both packages (a power-of-two divisor)
SIGMA = 0.5
CAPS = (8192, 6144, 4096)
BARY = 3e-5
REL = 1e-5
F32 = 1e-5
BF16 = 2e-2
# the tiny streaming configuration of tests/test_seq_lattice.py:151-158
TINY_CFG = dict(nr_classes=5, pointnet_layers=(8, 16),
                pointnet_start_nr_channels=16, nr_blocks_down_stage=(1, 1, 1),
                nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1, 1),
                rnn_modules=("gru", "gru", "aflow", "gru"), frames_per_seq=3)
TINY_RT = dict(max_points=96, capacity_level0=1024, capacity_decay=0.5,
               min_capacity=256, sigma=0.6)


def _i64(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.array(x))


# the JAX package's functions, jitted (its eager dispatch is slow)
j_union = jax.jit(jvt.union_and_index)
j_lookup = jax.jit(jvt.lookup)
j_build_nbr = jax.jit(jlo.build_neighbor_table)
j_update_nbr = jax.jit(jlo.update_neighbor_table, static_argnums=3)
j_grow = jax.jit(jlo.grow_coarse_table)
j_grow_inc = jax.jit(jlo.grow_coarse_table_incremental, static_argnums=4)


def _same_table(j, t, name=""):
    for f in ("keys", "packed", "sorted_packed", "sorted_to_stable", "count"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      _i64(getattr(j, f)).astype(
                                          getattr(t, f).numpy().dtype),
                                      err_msg=f"{name}.{f}")


def _same_nbr(j, t, name=""):
    np.testing.assert_array_equal(t.idx.numpy(), _i64(j.idx),
                                  err_msg=name + ".idx")
    np.testing.assert_array_equal(t.found.numpy(), np.asarray(j.found),
                                  err_msg=name + ".found")


def _lattice_keys(rng, n, scale=6.0):
    """(n*4, 3) int32 simplex-vertex keys of random points (many
    duplicates: neighbouring points share vertices)."""
    pos = rng.standard_normal((n, 3)).astype(np.float32) * scale
    keys, _ = jpm.find_enclosing_simplex(jpm.elevate(jnp.asarray(pos), 1.0))
    return np.array(keys).reshape(-1, 3)


@pytest.mark.parametrize("cap", [4096, 300])
def test_union_and_index_and_lookup_match_jax(cap):
    """Two unions in a row (duplicates within and across them, invalid
    rows, out-of-range keys), unsaturated and saturated, then lookups of
    hits, misses, sentinel and out-of-range queries."""
    rng = np.random.default_rng(1)
    jt, tt = jvt.make_table(cap, 3), tvt.make_table(cap, "cpu")
    _same_table(jt, tt, "fresh")
    for step in range(2):
        keys = _lattice_keys(rng, 200)
        keys[::37] = 4 * 3000 + keys[::37] % 4        # out of range
        valid = rng.random(keys.shape[0]) > 0.1
        jt, jrow = j_union(jt, jnp.asarray(keys), jnp.asarray(valid))
        tt, trow = tvt.union_and_index(tt, _t(keys), _t(valid))
        _same_table(jt, tt, f"union {step}")
        np.testing.assert_array_equal(trow.numpy(), _i64(jrow))
    if cap == 300:
        assert int(tt.count) == cap                     # really full
    q = np.concatenate([_lattice_keys(rng, 100),
                        np.full((5, 3), tvt.SENTINEL, np.int32),
                        np.full((5, 3), 4 * 3000, np.int32)])
    np.testing.assert_array_equal(
        tvt.lookup(tt, _t(q)).numpy(), _i64(j_lookup(jt, jnp.asarray(q))))
    packed = tvt.pack_keys(_t(q))
    np.testing.assert_array_equal(tvt.lookup_packed(tt, packed).numpy(),
                                  tvt.lookup(tt, _t(q)).numpy())
    assert (tvt.lookup(tt, _t(q))[-10:] == -1).all()


@pytest.fixture(scope="module")
def frames():
    """Two LiDAR-like frames of 1,024 padded points."""
    pos, val, _, mask = lidar_sequence(np.random.default_rng(0), frames=2,
                                       max_points=1024, n_az=16)
    return pos, val, mask


@pytest.fixture(scope="module")
def streamed(frames):
    """Both packages stream the two frames through distribute and the full
    per-level build; the port also updates incrementally."""
    pos, _, mask = frames
    jdist = jax.jit(functools.partial(jlo.distribute, sigma=SIGMA))
    jtabs = [jvt.make_table(c, 3) for c in CAPS]
    ttabs = [tvt.make_table(c, "cpu") for c in CAPS]
    out = []
    for f in range(2):
        jtabs[0], jd = jdist(jtabs[0], jnp.asarray(pos[f]),
                             jnp.asarray(mask[f]))
        old = [tb.count for tb in ttabs]
        prev_t = list(ttabs)
        ttabs[0], td = tlo.distribute(ttabs[0], _t(pos[f]), _t(mask[f]),
                                      SIGMA)
        jl, tl = [], []
        for i in range(2):
            jtabs[i + 1], jlink = j_grow(jtabs[i], jtabs[i + 1])
            ttabs[i + 1], tlink = tlo.grow_coarse_table(ttabs[i],
                                                        ttabs[i + 1])
            jl.append(jlink)
            tl.append(tlink)
        out.append(dict(jd=jd, td=td, jtabs=list(jtabs), ttabs=list(ttabs),
                        jl=jl, tl=tl, old=old, prev=prev_t))
    return out


def test_distribute_matches_jax(frames, streamed):
    pos, _, mask = frames
    for f, s in enumerate(streamed):
        jd, td = s["jd"], s["td"]
        _same_table(s["jtabs"][0], s["ttabs"][0], f"frame {f}")
        for name in ("row_vertex", "point_vertex", "row_valid"):
            np.testing.assert_array_equal(
                getattr(td, name).numpy(),
                np.asarray(getattr(jd, name)).astype(
                    getattr(td, name).numpy().dtype), err_msg=name)
        for name, tol in (("row_bary", BARY), ("point_bary", BARY),
                          ("row_rel_pos", REL)):
            np.testing.assert_allclose(getattr(td, name).numpy(),
                                       np.asarray(getattr(jd, name)),
                                       rtol=0, atol=tol, err_msg=name)
        # K1's route (its plain version here) against the eager simplex
        # functions and the unpacked-key union
        keys, bary = tpm.find_enclosing_simplex(
            tpm.elevate(_t(pos[f]), SIGMA))
        tab, row = tvt.union_and_index(s["prev"][0], keys.reshape(-1, 3),
                                       _t(mask[f]).repeat_interleave(4))
        np.testing.assert_array_equal(row.numpy(), td.row_vertex.numpy())
        for fld in dataclasses.fields(tab):
            assert torch.equal(getattr(tab, fld.name),
                               getattr(s["ttabs"][0], fld.name)), fld.name
        np.testing.assert_array_equal(
            torch.where(td.row_valid, bary.reshape(-1), 0.0).numpy(),
            td.row_bary.numpy())
    assert int(streamed[1]["ttabs"][0].count) > int(streamed[0]["ttabs"][0]
                                                    .count)


def test_neighbor_tables_match_jax_and_rebuild(streamed):
    s0, s1 = streamed
    for lvl in range(3):
        want = j_build_nbr(s1["jtabs"][lvl])
        full = tlo.build_neighbor_table(s1["ttabs"][lvl])
        _same_nbr(want, full, f"build {lvl}")
        # frame 1 updated from frame 0's table: as JAX, and as a rebuild
        prev = tlo.build_neighbor_table(s0["ttabs"][lvl])
        got = tlo.update_neighbor_table(s1["ttabs"][lvl], prev,
                                        s1["old"][lvl], 4096)
        jprev = j_build_nbr(s0["jtabs"][lvl])
        jgot = j_update_nbr(s1["jtabs"][lvl], jprev,
                            jnp.int32(int(s1["old"][lvl])), 4096)
        _same_nbr(jgot, got, f"update {lvl}")
        assert torch.equal(got.idx, full.idx) and torch.equal(got.found,
                                                              full.found)


def test_coarse_tables_match_jax_full_and_incremental(streamed):
    s0, s1 = streamed
    for s in streamed:
        for i in range(2):
            _same_table(s["jtabs"][i + 1], s["ttabs"][i + 1], f"level {i+1}")
            np.testing.assert_array_equal(s["tl"][i].corner_idx.numpy(),
                                          _i64(s["jl"][i].corner_idx))
            np.testing.assert_allclose(s["tl"][i].corner_bary.numpy(),
                                       np.asarray(s["jl"][i].corner_bary),
                                       rtol=0, atol=BARY)
    # frame 1's links patched from frame 0's for the new fine vertices
    for i in range(2):
        tab, link = tlo.grow_coarse_table_incremental(
            s1["ttabs"][i], s0["ttabs"][i + 1], s1["old"][i], s0["tl"][i],
            2048)
        jtab, jlink = j_grow_inc(
            s1["jtabs"][i], s0["jtabs"][i + 1],
            jnp.int32(int(s1["old"][i])),
            jlo.LevelLink(corner_idx=s0["jl"][i].corner_idx,
                          corner_bary=s0["jl"][i].corner_bary), 2048)
        _same_table(jtab, tab, f"incremental {i + 1}")
        np.testing.assert_array_equal(link.corner_idx.numpy(),
                                      _i64(jlink.corner_idx))
        np.testing.assert_allclose(link.corner_bary.numpy(),
                                   np.asarray(jlink.corner_bary), rtol=0,
                                   atol=BARY)
        for fld in dataclasses.fields(tab):
            assert torch.equal(getattr(tab, fld.name),
                               getattr(s1["ttabs"][i + 1], fld.name))
        assert torch.equal(link.corner_idx, s1["tl"][i].corner_idx)
        assert torch.equal(link.corner_bary, s1["tl"][i].corner_bary)


def test_unsorted_splat_and_slice_match_jax(streamed):
    s = streamed[1]
    rng = np.random.default_rng(3)
    for i in range(2):
        cf, cc = CAPS[i], CAPS[i + 1]
        x = rng.standard_normal((cf, 32)).astype(np.float32)
        jl, tl = s["jl"][i], s["tl"][i]
        np.testing.assert_allclose(
            tlo.splat_to_coarse(_t(x), tl, cc).numpy(),
            np.asarray(jlo.splat_to_coarse(jnp.asarray(x), jl, cc)),
            rtol=0, atol=F32)
        xc = rng.standard_normal((cc, 32)).astype(np.float32)
        np.testing.assert_allclose(
            tlo.slice_to_fine(_t(xc), tl).numpy(),
            np.asarray(jlo.slice_to_fine(jnp.asarray(xc), jl)),
            rtol=0, atol=F32)
    with pytest.raises(ValueError):
        tlo.splat_to_coarse(_t(x), s["tl"][0])


def test_segment_max_with_bary_packed_bit_equal():
    rng = np.random.default_rng(4)
    r, c, segs = 5000, 16, 700
    data = rng.standard_normal((r, c)).astype(np.float32)
    data[::7] = data[::7].round(1)                     # ties in bf16
    bary = rng.random(r).astype(np.float32)
    ids = rng.integers(0, segs - 50, r)                # empty segments too
    valid = rng.random(r) > 0.2
    jmx, jb = jseg.segment_max_with_bary_packed(
        jnp.asarray(data), jnp.asarray(bary), jnp.asarray(ids), segs,
        jnp.asarray(valid))
    tmx, tb = tseg.segment_max_with_bary_packed(_t(data), _t(bary), _t(ids),
                                                segs, _t(valid))
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # the straight-through backward: the cotangent goes to the winning rows
    x = _t(data).requires_grad_()
    tmx, _ = tseg.segment_max_with_bary_packed(x, _t(bary), _t(ids), segs,
                                               _t(valid))
    tmx.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jax.grad(
        lambda d: jseg.segment_max_with_bary_packed(
            d, jnp.asarray(bary), jnp.asarray(ids), segs,
            jnp.asarray(valid))[0].sum())(jnp.asarray(data))))


# ---------------------------------------------------------------------------
# the per-frame pointnet and the entry points, at the tiny configuration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """Three frames of 80 points drifting by 0.3 per frame (the inputs of
    the JAX package's streaming test), the tiny model's JAX weights, and
    the JAX package's plain streaming log-probabilities."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(80, 3)).astype(np.float32) * 2
    pos = np.zeros((3, 96, 3), np.float32)
    val = np.zeros((3, 96, 1), np.float32)
    mask = np.zeros((3, 96), bool)
    for t in range(3):
        pos[t, :80] = base + t * 0.3
        val[t, :80] = rng.random((80, 1))
        mask[t, :80] = True
    jcfg, jrt = JModelConfig(**TINY_CFG), JRuntimeConfig(**TINY_RT)
    jmodel = JLNNSeq(jcfg, jrt)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(pos[0]), jnp.asarray(val[0]), jnp.asarray(mask[0]),
        j_init_state(jcfg, jrt), final=True))(jax.random.PRNGKey(0))
    params = {"params": params["params"]}
    ns, step, final = jengine.make_streaming_inference(jmodel, jcfg, jrt)
    s = ns()
    for t in range(2):
        s = step(params, pos[t], val[t], mask[t], s)
    logp, _, s, aux = final(params, pos[2], val[2], mask[2], s)
    return dict(pos=pos, val=val, mask=mask, jparams=params["params"],
                jlogp=np.asarray(logp), jaux=aux,
                jcounts=[int(tb.count) for tb in s.tables])


def _port_model(tiny, cfg=None):
    cfg = cfg or ModelConfig(**TINY_CFG)
    model = LNNSeq(cfg, RuntimeConfig(**TINY_RT), device="cpu")
    model.load_state_dict(params_from_jax(tiny["jparams"], cfg), strict=True)
    return model.eval()


def test_per_frame_pointnet_matches_jax(tiny):
    """MLP, packed max, the fewer-than-4-rows zeroing, early GRU fusion and
    the first lattice conv of one frame, on the JAX package's distribute
    output and neighbor table."""
    pos, val, mask = tiny["pos"][1], tiny["val"][1], tiny["mask"][1]
    jcfg = JModelConfig(**TINY_CFG)
    cap = TINY_RT["capacity_level0"]
    table, dist = jlo.distribute(jvt.make_table(cap, 3), jnp.asarray(pos),
                                 jnp.asarray(mask), TINY_RT["sigma"])
    nbr = j_build_nbr(table)
    vrows = np.repeat(val, 4, axis=0) * np.asarray(dist.row_valid)[:, None]
    h = np.random.default_rng(5).standard_normal((cap, 32)).astype(np.float32)
    h[0] = 0
    h[200:] = 0
    args = (jnp.int32(int(table.count)), jnp.asarray(h), jnp.int32(200),
            jnp.asarray(False))
    want, want_h = JPointNet(jcfg).apply(
        {"params": tiny["jparams"]["point_net_seq"]}, dist,
        jnp.asarray(vrows), nbr, *args)

    mod = _port_model(tiny).point_net_seq
    tdist = tlo.DistributeOut(*(
        _t(np.asarray(getattr(dist, f.name)).astype(np.int64)
           if np.asarray(getattr(dist, f.name)).dtype == np.int32
           else np.asarray(getattr(dist, f.name)))
        for f in dataclasses.fields(tlo.DistributeOut)))
    tnbr = tlo.NeighborTable(idx=_t(_i64(nbr.idx)), found=_t(nbr.found))
    with torch.no_grad():
        red = mod.reduce_frame(tdist, _t(vrows), cap)
        got, got_h = mod.fuse_and_conv(red, tnbr, torch.tensor(int(
            table.count)), _t(h), torch.tensor(200), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16,
                               atol=BF16)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=BF16,
                               atol=BF16)
    # the bf16 packed max has no argmax for the bary quirk (the JAX package
    # asserts the same)
    with pytest.raises(ValueError):
        PointNetSeq(ModelConfig(**TINY_CFG, reference_bary_quirk=True)
                    ).reduce_frame(tdist, _t(vrows), cap)


def _run_plain(model, cfg, rt, tiny):
    ns, step, final = engine.make_streaming_inference(model, cfg, rt)
    s = ns()
    for t in range(2):
        s = step(tiny["pos"][t], tiny["val"][t], tiny["mask"][t], s)
    return final(tiny["pos"][2], tiny["val"][2], tiny["mask"][2], s)


def test_streaming_plain_matches_jax(tiny):
    cfg, rt = ModelConfig(**TINY_CFG), RuntimeConfig(**TINY_RT)
    logp, sv, s, aux = _run_plain(_port_model(tiny), cfg, rt, tiny)
    assert [int(tb.count) for tb in s.tables] == tiny["jcounts"]
    np.testing.assert_array_equal(aux["point_vertex"].numpy(),
                                  _i64(tiny["jaux"]["point_vertex"]))
    np.testing.assert_array_equal(aux["occupancy"].numpy(),
                                  _i64(tiny["jaux"]["occupancy"]))
    assert s.t == 3 and sv.shape == (96, 5)
    m = tiny["mask"][2]
    np.testing.assert_allclose(logp.numpy()[m], tiny["jlogp"][m], rtol=0,
                               atol=BF16)


def test_streaming_incremental_matches_plain_and_overflow_is_sticky(tiny):
    cfg, rt = ModelConfig(**TINY_CFG), RuntimeConfig(**TINY_RT)
    model = _port_model(tiny)
    logp_a, _, sa, _ = _run_plain(model, cfg, rt, tiny)
    P, V, M = tiny["pos"], tiny["val"], tiny["mask"]

    new_fn, step_full, step_inc, final_inc = \
        engine.make_streaming_inference_incremental(model, cfg, rt,
                                                    max_new=512)
    s, fs = new_fn()
    s, fs = step_full(P[0], V[0], M[0], s, fs)
    s, fs = step_inc(P[1], V[1], M[1], s, fs)
    logp_b, _, s, fs, _ = final_inc(P[2], V[2], M[2], s, fs)
    assert not bool(fs.overflowed)
    np.testing.assert_allclose(logp_b.numpy()[M[2]], logp_a.numpy()[M[2]],
                               rtol=0, atol=1e-5)
    # the carried structures equal a full build on the final tables
    for lvl, tb in enumerate(s.tables):
        full = tlo.build_neighbor_table(tb)
        assert torch.equal(fs.nbrs[lvl].idx, full.idx)
        assert torch.equal(fs.nbrs[lvl].found, full.found)
        assert torch.equal(tb.count, sa.tables[lvl].count)

    # a bound of 8 new vertices trips the flag, which stays set
    new_fn, step_full, step_inc, _ = \
        engine.make_streaming_inference_incremental(model, cfg, rt, max_new=8)
    s, fs = new_fn()
    s, fs = step_full(P[0], V[0], M[0], s, fs)
    assert not bool(fs.overflowed)                 # a full build never does
    s, fs = step_inc(P[1], V[1], M[1], s, fs)
    assert bool(fs.overflowed)
    s, fs = step_inc(P[2], V[2], M[2], s, fs)
    assert bool(fs.overflowed)


@pytest.mark.parametrize("incremental", [False, True])
def test_streaming_batched_matches_single_streams(tiny, incremental):
    """Two streams (the frames and a shifted copy) stepped together give
    each single stream's outputs bit for bit."""
    cfg, rt = ModelConfig(**TINY_CFG), RuntimeConfig(**TINY_RT)
    model = _port_model(tiny)
    P, V, M = tiny["pos"], tiny["val"], tiny["mask"]
    PB = np.stack([P, P[:, ::-1] + 0.7], axis=1)        # (T, B, P, 3)
    VB = np.stack([V, V[:, ::-1]], axis=1)
    MB = np.stack([M, M[:, ::-1]], axis=1)
    fns = engine.make_streaming_inference_batched(
        model, cfg, rt, incremental=incremental, max_new=512)
    if incremental:
        new_b, step_full_b, step_b, final_b = fns
        new1, full1, step1, final1 = \
            engine.make_streaming_inference_incremental(model, cfg, rt, 512)
    else:
        new_b, step_b, final_b = fns
        step_full_b = step_b
        new1, step1, final1 = engine.make_streaming_inference(model, cfg, rt)
        full1 = step1
    carry = new_b(2)
    for t in range(2):
        carry = (step_full_b if t == 0 else step_b)(PB[t], VB[t], MB[t],
                                                    carry)
    logp, sv, carry, aux = final_b(PB[2], VB[2], MB[2], carry)
    assert logp.shape == (2, 96, 5) and len(carry) == 2
    assert aux["occupancy"].shape == (2, 3)
    for b in range(2):
        s = new1()
        for t in range(2):
            fn = full1 if t == 0 else step1
            s = fn(PB[t, b], VB[t, b], MB[t, b], *s) if incremental \
                else fn(PB[t, b], VB[t, b], MB[t, b], s)
        out = final1(PB[2, b], VB[2, b], MB[2, b], *s) if incremental \
            else final1(PB[2, b], VB[2, b], MB[2, b], s)
        assert torch.equal(out[0], logp[b])
        assert torch.equal(out[1], sv[b])
    with pytest.raises(NotImplementedError):
        engine.make_streaming_inference_batched(model, cfg, rt, mesh=object())


def test_streaming_forward_matches_offline(tiny):
    """``make_sequence_forward(precompute=False)`` against the offline
    forward on the same weights, within the JAX package's own tolerance
    for the same comparison (tests/test_seq_lattice.py:91)."""
    cfg, rt = ModelConfig(**TINY_CFG), RuntimeConfig(**TINY_RT)
    model = _port_model(tiny)
    P, V, M = tiny["pos"], tiny["val"], tiny["mask"]
    logp_s, _, aux_s = engine.make_sequence_forward(
        model, cfg, rt, precompute=False)(P, V, M)
    logp_o, _, aux_o = engine.make_sequence_forward(model, cfg, rt)(P, V, M)
    assert torch.equal(aux_s["point_vertex"], aux_o["point_vertex"])
    assert torch.equal(aux_s["occupancy"], aux_o["occupancy"])
    np.testing.assert_allclose(logp_s.numpy()[M[2]], logp_o.numpy()[M[2]],
                               rtol=0, atol=2e-3)
