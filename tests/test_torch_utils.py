"""The PyTorch port's utilities against the JAX package's on the CPU:
capacity autotuning, the AFlow attention data (``LNNSeq.sow_aux`` against
the JAX model's sown "aux" collection), the visualisation exports, the
``record_plys`` renderer, profiling, and the ``visualize_cli``.

Tolerances: the autotuned capacities and their counts are integers and
must be equal (sigma 0.5 scales bit-identically in both packages); the
AFlow neighbor indices equal, its weights within 2e-2 (bf16 network
features, as ``tests/test_torch_streaming.py``; measured: bit-equal); the
exports equal.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import record_plys as jrecord_plys
from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.data.lidar_like import lidar_sequence
from temporal_latticenet_tpu.data.ply import read_ply_vertices
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq
from temporal_latticenet_tpu.models import init_state as j_init_state
from temporal_latticenet_tpu.utils import autotune as jautotune
from temporal_latticenet_tpu.utils import visualization as jvis
from temporal_latticenet_tpu.utils.label_mngr import LabelMngr as JLabelMngr
from temporal_latticenet_tpu_torch import record_plys, visualize_cli
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.models.lnn_seq import LNNSeq, init_state
from temporal_latticenet_tpu_torch.train.convert import params_from_jax
from temporal_latticenet_tpu_torch.utils import autotune, profiling
from temporal_latticenet_tpu_torch.utils import visualization as vis
from temporal_latticenet_tpu_torch.utils.label_mngr import LabelMngr
from tests.test_loop import _patch_lengths, tiny_world  # noqa: F401
from tests.test_torch_streaming import TINY_CFG, TINY_RT

from .test_torch_configs import _one_torch_thread  # noqa: F401

SIGMA = 0.5


def _sequences(n=2, frames=3, points=512):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        pos, _, _, mask = lidar_sequence(rng, frames=frames,
                                         max_points=points, n_az=points // 64)
        out.append((pos, mask))
    return out


def test_autotune_matches_jax():
    """Equal capacities; with a headroom of 256 each capacity is 256 times
    its level's count, so the counts themselves are held equal too."""
    seqs = _sequences()
    kw = dict(nr_downsamples=2, sigma=SIGMA, probe_capacity=8192,
              min_capacity=256)
    for headroom in (1.4, 256.0):
        want = jautotune.autotune_capacities(seqs, headroom=headroom, **kw)
        got = autotune.autotune_capacities(seqs, headroom=headroom,
                                           device="cpu", **kw)
        assert got == want, headroom
    counts = [c // 256 for c in got]
    assert counts[0] > counts[1] > counts[2] > 0
    for mod, extra in ((jautotune, {}), (autotune, {"device": "cpu"})):
        with pytest.raises(ValueError, match="saturated"):
            mod.autotune_capacities(seqs, 2, SIGMA, probe_capacity=256,
                                    min_capacity=16, **extra)
        with pytest.raises(ValueError, match="no sample"):
            mod.autotune_capacities([], 2, SIGMA, **extra)


def _tiny_frames():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(80, 3)).astype(np.float32) * 2
    pos = np.zeros((3, 96, 3), np.float32)
    val = np.zeros((3, 96, 1), np.float32)
    mask = np.zeros((3, 96), bool)
    for t in range(3):
        pos[t, :80] = base + t * 0.3
        val[t, :80] = rng.random((80, 1))
        mask[t, :80] = True
    return pos, val, mask


def test_aflow_aux_matches_jax_sown():
    """Per frame after the first: the AFlow site's weights and neighbor
    indices under the JAX module path; the first frame (no previous frame)
    records nothing, and outside ``sow_aux`` nothing is recorded."""
    pos, val, mask = _tiny_frames()
    jcfg, jrt = JModelConfig(**TINY_CFG), JRuntimeConfig(**TINY_RT)
    jmodel = JLNNSeq(jcfg, jrt)
    params = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(pos[0]), jnp.asarray(val[0]), jnp.asarray(mask[0]),
        j_init_state(jcfg, jrt), final=True))(jax.random.PRNGKey(0))
    params = {"params": params["params"]}
    apply_aux = jax.jit(
        lambda prm, p, v, m, s, final: jmodel.apply(
            prm, p, v, m, s, final=final, mutable=["aux"]),
        static_argnames=("final",))

    cfg = ModelConfig(**TINY_CFG)
    model = LNNSeq(cfg, RuntimeConfig(**TINY_RT), device="cpu").eval()
    model.load_state_dict(params_from_jax(params["params"], cfg), strict=True)
    jstate = j_init_state(jcfg, jrt)
    state = init_state(cfg, model.rt, "cpu", tables=True)
    for t in range(3):
        final = t == 2
        (_, jstate, _), sown = apply_aux(params, jnp.asarray(pos[t]),
                                         jnp.asarray(val[t]),
                                         jnp.asarray(mask[t]), jstate, final)
        with torch.no_grad(), model.sow_aux() as got:
            _, state, _ = model(state, positions=torch.from_numpy(pos[t]),
                                values=torch.from_numpy(val[t]),
                                mask=torch.from_numpy(mask[t]), final=final)
        if t == 0:
            assert got == {}
            continue
        want = jax.tree_util.tree_map(np.asarray, sown["aux"])
        assert sorted(got) == sorted(want) == ["recurrent_fusion_modules_1"]
        site, jsite = got["recurrent_fusion_modules_1"], \
            want["recurrent_fusion_modules_1"]
        assert sorted(site) == sorted(jsite)
        (w,), (jw,) = site["aflow_weights"], jsite["aflow_weights"]
        (idx,), (jidx,) = site["aflow_neighbors"], jsite["aflow_neighbors"]
        np.testing.assert_array_equal(idx.numpy(), jidx.astype(np.int64))
        assert w.shape == jw.shape == (idx.shape[0], 9)
        np.testing.assert_array_equal(w.numpy(), jw)
        assert (w > 0).any()
    assert all(m.sown is None for m in model.recurrent_fusion_modules.values()
               if hasattr(m, "sown"))


def test_export_prediction_cloud_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(50, 3)).astype(np.float32)
    pred = rng.integers(0, 5, 50)
    gt = rng.integers(0, 5, 50)
    jvis.export_prediction_cloud(str(tmp_path / "jax" / "out.ply"), pos, pred,
                                 JLabelMngr(dataset="semantickitti"), gt)
    vis.export_prediction_cloud(str(tmp_path / "port" / "out.ply"), pos, pred,
                                LabelMngr(dataset="semantickitti"), gt)
    for name in ("out.ply", "out_gt.ply", "out_diff.ply"):
        want = read_ply_vertices(str(tmp_path / "jax" / name))
        got = read_ply_vertices(str(tmp_path / "port" / name))
        assert got.dtype == want.dtype and len(got) == 50
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_vertex_means_and_aflow_arrays_match_jax(tmp_path):
    """The same aux collection, once as numpy (the JAX package's form) and
    once as tensors (what ``sow_aux`` yields)."""
    rng = np.random.default_rng(1)
    w = rng.random((16, 9)).astype(np.float32)
    nbr = rng.integers(0, 16, (16, 9)).astype(np.int64)
    pos = rng.random((8, 3)).astype(np.float32)
    pv = np.zeros((8, 4), np.int64)
    pv[:, 0] = np.arange(8) % 4 + 1
    pv[:, 1] = rng.integers(0, 16, 8)
    np.testing.assert_array_equal(
        vis.vertex_mean_positions(torch.from_numpy(pos),
                                  torch.from_numpy(pv), 16),
        jvis.vertex_mean_positions(pos, pv, 16))
    site = "recurrent_fusion_modules_1"
    jkeys = jvis.export_aflow_arrays(
        str(tmp_path / "jax.npz"),
        {site: {"aflow_weights": (w,), "aflow_neighbors": (nbr,)}},
        pos, pv, 16)
    keys = vis.export_aflow_arrays(
        str(tmp_path / "port.npz"),
        {site: {"aflow_weights": (torch.from_numpy(w),),
                "aflow_neighbors": (torch.from_numpy(nbr),)}},
        torch.from_numpy(pos), torch.from_numpy(pv), 16)
    assert keys == jkeys
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    for k in jkeys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _kitti_predictions(root):
    """The synthetic layout of tests/test_utils.py:101-120."""
    rng = np.random.default_rng(0)
    seq_dir = root / "data" / "sequences" / "08"
    (seq_dir / "velodyne").mkdir(parents=True)
    (seq_dir / "labels").mkdir()
    pred_dir = root / "preds" / "sequences" / "08" / "predictions"
    pred_dir.mkdir(parents=True)
    for s in range(2):
        pts = rng.normal(size=(200, 4)).astype(np.float32) * 5
        pts.tofile(seq_dir / "velodyne" / f"{s:06d}.bin")
        np.full(200, 10, np.uint32).tofile(seq_dir / "labels"
                                           / f"{s:06d}.label")
        rng.integers(0, 20, 200).astype(np.uint32).tofile(
            pred_dir / f"{s:06d}.label")


def test_record_plys_matches_jax(tmp_path):
    """Both renderers on the same scans write the same frames."""
    import matplotlib.image as mpimg
    _kitti_predictions(tmp_path)
    args = (str(tmp_path / "data"), 8, str(tmp_path / "preds"))
    jrecord_plys.run(*args, str(tmp_path / "jax"), count=2)
    record_plys.main(["--dataset-path", args[0], "--sequence", "8",
                      "--predictions", args[2], "--count", "2",
                      "--out", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == \
        ["frame_00000.png", "frame_00001.png"]
    for n in names:
        np.testing.assert_array_equal(mpimg.imread(tmp_path / "port" / n),
                                      mpimg.imread(tmp_path / "jax" / n))


def test_matplotlib_only_where_rendering(tmp_path, monkeypatch):
    """Without matplotlib, ``record_plys.run`` and ``--render`` raise a
    clear ImportError; the CLIs import without it."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        record_plys.run(str(tmp_path), 8, str(tmp_path), str(tmp_path / "o"))
    with pytest.raises(ImportError, match="--render"):
        visualize_cli._render(str(tmp_path), 2)


def test_profiling_trace_holds_the_model_spans(tmp_path):
    """A streamed frame under ``trace``: the Chrome trace holds the
    frame's lattice and model spans (``utils/profiling.span``);
    ``enable_nan_debugging`` does what it says."""
    pos, val, mask = _tiny_frames()
    cfg = ModelConfig(**TINY_CFG)
    model = LNNSeq(cfg, RuntimeConfig(**TINY_RT), device="cpu").eval()
    state = init_state(cfg, model.rt, "cpu", tables=True)
    with profiling.trace(str(tmp_path / "prof")) as prof, torch.no_grad():
        model(state, positions=torch.from_numpy(pos[0]),
              values=torch.from_numpy(val[0]),
              mask=torch.from_numpy(mask[0]), final=True)
    assert prof is not None
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"tln.lattice.frame", "tln.lattice.distribute",
            "tln.model.pointnet", "tln.model.slice"} <= names
    with profiling.trace(None) as none:
        assert none is None
    profiling.enable_nan_debugging(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_visualize_cli_exports_npz(tiny_world, tmp_path):  # noqa: F811
    """The port's CLI on an aflow variant of the tiny world (the cfg of
    ``tests/test_visualize_cli.py``), on the CPU: one ``.npz`` per frame
    after the first, the weights finite and in [0, alpha*beta], the
    neighbors inside the vertex capacity, and the histogram with
    ``--render``."""
    from temporal_latticenet_tpu_torch import config
    from temporal_latticenet_tpu_torch.train import loop

    world, cfg_path = tiny_world
    text = (world / "cfg.cfg").read_text()
    a = 'rnn_modules: ["gru", "none", "none", "gru"]'
    assert a in text
    aflow_cfg = tmp_path / "aflow.cfg"
    aflow_cfg.write_text(text.replace(
        a, 'rnn_modules: ["none", "none", "aflow", "none"]'))
    parser = config.cfgParser(str(aflow_cfg))
    cfg = config.model_config_from_cfg(parser,
                                       config.nr_classes_from_cfg(parser))
    datasets = _patch_lengths(loop.make_datasets(
        parser, cfg, config.runtime_config_from_cfg(parser), ("valid",)))
    out = tmp_path / "vis"
    visualize_cli.run(str(aflow_cfg), None, str(out), seq_index=1,
                      render=True, datasets=datasets, device="cpu")
    assert sorted(os.listdir(out)) == ["aflow_frame1.npz",
                                       "aflow_weights_frame1.png"]
    data = np.load(out / "aflow_frame1.npz")
    assert sorted(data.files) == [
        "avg_position_per_vertex",
        "recurrent_fusion_modules_1/aflow_neighbors",
        "recurrent_fusion_modules_1/aflow_weights"]
    wts = data["recurrent_fusion_modules_1/aflow_weights"]
    nbr = data["recurrent_fusion_modules_1/aflow_neighbors"]
    assert wts.shape == nbr.shape == (512, 9)
    alpha_beta = np.float32(0.1) * np.float32(0.1)    # initial alpha, beta
    assert np.isfinite(wts).all() and 0 <= wts.min()
    assert wts.max() <= alpha_beta and (wts > 0).any()
    assert nbr.min() >= 0 and nbr.max() < 512
