"""The PyTorch port's host side against the JAX package's, with no JAX
compile: the ``.cfg`` parser and typed configs, the KITTI and Paris-Lille
metadata, ``SemanticKittiDataset`` and ``ParisLille3DDataset`` items
(bit-equal, augmentation on, one seed on both sides), the PLY reader and
writer, ``LabelMngr``, ``compute_class_weights`` and ``Scores``.

Everything here is numpy on the host: items are held with
``np.array_equal``, since one extra or reordered draw of the random
generator would change them."""

import dataclasses
import glob
import os

import numpy as np
import pytest

from temporal_latticenet_tpu import config as jconfig
from temporal_latticenet_tpu.data import kitti as jkitti
from temporal_latticenet_tpu.data import kitti_meta as jkitti_meta
from temporal_latticenet_tpu.data import parislille as jparislille
from temporal_latticenet_tpu.data import parislille_meta as jpl_meta
from temporal_latticenet_tpu.data import ply as jply
from temporal_latticenet_tpu.data import synthetic as jsynthetic
from temporal_latticenet_tpu.train import metrics as jmetrics
from temporal_latticenet_tpu.utils import label_mngr as jlabel_mngr
from temporal_latticenet_tpu_torch import config
from temporal_latticenet_tpu_torch.data import kitti, kitti_meta
from temporal_latticenet_tpu_torch.data import native_loader, parislille
from temporal_latticenet_tpu_torch.data import parislille_meta as pl_meta
from temporal_latticenet_tpu_torch.data import ply, synthetic
from temporal_latticenet_tpu_torch.train import metrics
from temporal_latticenet_tpu_torch.utils import label_mngr
from tests.test_data import _loader_config, mini_kitti  # noqa: F401
from tests.test_loop import CFG_TEMPLATE
from tests.test_parislille import PL_CFG, _write_pl_cloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(glob.glob(os.path.join(REPO, "seq_config", "*.cfg")))

# the hjson extras the parser accepts beyond the shipped configs
HJSON_EXTRAS = """
# hash comment
core: { a: 1, /* block */ b: 'single' }
train: {
    dataset_name: semantickitti   // bare word
    text: '''
        multi
          line
        '''
    list: [1, 2.5, -3e-2, true, null, "esc\\tape"]
}
"""


# ---------------------------------------------------------------------------
# cfg parser and typed configs
# ---------------------------------------------------------------------------

def _template_cfg(tmp_path):
    p = tmp_path / "template.cfg"
    p.write_text(CFG_TEMPLATE.format(ckpt="/c/", preds="/p",
                                     data="/d"))
    return str(p)


def _pl_template_cfg(tmp_path):
    p = tmp_path / "pl.cfg"
    p.write_text(PL_CFG.format(data="/d", ckpt="/c"))
    return str(p)


@pytest.mark.parametrize("which", [os.path.basename(c) for c in CFGS]
                         + ["test_loop_template", "parislille_template"])
def test_cfg_files_parse_equal(which, tmp_path):
    """Every shipped cfg, and the loop tests' templates, parse to the same
    dict and the same typed configs (every field) in both packages."""
    path = {"test_loop_template": lambda: _template_cfg(tmp_path),
            "parislille_template": lambda: _pl_template_cfg(tmp_path)}.get(
        which, lambda: os.path.join(REPO, "seq_config", which))()
    assert config.load_file(path) == jconfig.load_file(path)
    p, jp = config.cfgParser(path), jconfig.cfgParser(path)
    n = config.nr_classes_from_cfg(p)
    assert n == jconfig.nr_classes_from_cfg(jp)
    assert (dataclasses.asdict(config.model_config_from_cfg(p, n))
            == dataclasses.asdict(jconfig.model_config_from_cfg(jp, n)))
    assert (dataclasses.asdict(config.runtime_config_from_cfg(p))
            == dataclasses.asdict(jconfig.runtime_config_from_cfg(jp)))
    assert p.get_loader_vars() == jp.get_loader_vars()


def test_cfg_hjson_extras_and_defaults():
    """Comments, bare words, multiline and escaped strings parse as in JAX;
    the model computes in bf16 and the runtime in float32 unless the cfg
    says otherwise, and reference_bary_quirk is never read from a cfg."""
    assert config.loads(HJSON_EXTRAS) == jconfig.loads(HJSON_EXTRAS)
    assert config.loads(HJSON_EXTRAS)["train"]["text"] == "multi\n  line"
    p = config.cfgParser(CFGS[0])
    assert config.model_config_from_cfg(p, 26).compute_dtype == "bfloat16"
    assert config.runtime_config_from_cfg(p).compute_dtype == "float32"
    p.contents["runtime"]["reference_bary_quirk"] = True
    assert not config.model_config_from_cfg(p, 26).reference_bary_quirk


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moving", [False, True])
def test_metadata_tables_equal(moving):
    np.testing.assert_array_equal(kitti_meta.build_remap_lut(moving),
                                  jkitti_meta.build_remap_lut(moving))
    np.testing.assert_array_equal(kitti_meta.build_inverse_lut(moving),
                                  jkitti_meta.build_inverse_lut(moving))
    assert kitti_meta.nr_classes(moving) == jkitti_meta.nr_classes(moving)
    assert kitti_meta.SPLIT == jkitti_meta.SPLIT
    assert kitti_meta.SPLIT_LENGTHS == jkitti_meta.SPLIT_LENGTHS
    fine = np.array(sorted(jpl_meta.FINE_TO_COARSE_12) + [7, 999999999],
                    np.int64)
    np.testing.assert_array_equal(pl_meta.fine_to_coarse(fine, moving),
                                  jpl_meta.fine_to_coarse(fine, moving))
    np.testing.assert_array_equal(pl_meta.twelve_to_ten_lut(),
                                  jpl_meta.twelve_to_ten_lut())


# ---------------------------------------------------------------------------
# SemanticKITTI items
# ---------------------------------------------------------------------------

def _items_equal(a, b, path=lambda p: p):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        for f in ("positions", "values", "labels", "mask"):
            x, y = getattr(fa, f), getattr(fb, f)
            assert x.dtype == y.dtype, f
            assert np.array_equal(x, y), f
        assert (fa.n_points, path(fa.path), fa.last_n) == \
            (fb.n_points, path(fb.path), fb.last_n)


def _pair(tmp_path, split="valid", seed=None, use_native=False, train=False,
          **kw):
    lc = _loader_config(tmp_path, **kw)
    out = []
    for mod in (kitti, jkitti):
        ds = mod.SemanticKittiDataset(split, lc, {"values_mode": "reflectance"},
                                      sequence_learning=True, max_points=64,
                                      seed=seed, use_native=use_native)
        ds.dataset_lengths = [12]
        if train:
            # the train split's filters, shuffles and augmentation on the
            # fixture's sequence 08
            ds.split = ds.transformer.split = "train"
            ds.split_seqs = {"train": [8]}
        out.append(ds)
    return out


WINDOWS = {
    "windows": dict(),
    "accumulate": dict(accumulate_clouds=True),
    "seq_same_cloud": dict(seq_same_cloud=True),
    "xyz_values": dict(),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_kitti_windows_bit_equal(mini_kitti, case):  # noqa: F811
    """Windows (clamped at the sequence start), the accumulated cloud with
    its last_n, seq_same_cloud and the ones-valued features: every item of
    the split equal to JAX's."""
    tmp_path, _ = mini_kitti
    ds, jds = _pair(tmp_path, **WINDOWS[case])
    if case == "xyz_values":
        ds.feature_mode = jds.feature_mode = "xyz"
    assert len(ds) == len(jds)
    for i in range(12):
        _items_equal(ds[i], jds[i])


def test_kitti_debug_loader_and_overfit(mini_kitti):  # noqa: F811
    """debug_loader (one item from a hardcoded index, labels = frame index)
    and do_overfit's size.  The hardcoded index lies past the fixture, so
    both packages raise alike; a negative nr_clouds_to_skip moves it onto
    scan 6."""
    tmp_path, _ = mini_kitti
    ds, jds = _pair(tmp_path, debug_loader=True)
    assert len(ds) == len(jds) == 1
    for d in (ds, jds):
        with pytest.raises(IndexError):
            d[0]
        d.nr_clouds_to_skip = 6 - (4541 + 1101 + 4661 + 801 + 200)
    frames = ds[0]
    _items_equal(frames, jds[0])
    for i, f in enumerate(frames):
        assert np.array_equal(f.labels[:f.n_points],
                              np.full(f.n_points, i, np.int32))
    ds, jds = _pair(tmp_path, do_overfit=True, overfit_num_clouds=5)
    assert len(ds) == len(jds) == 5


def test_kitti_train_augmentation_bit_equal(mini_kitti):  # noqa: F811
    """The shipped train cfg's transformer (mirrors, rotations,
    translations), point shuffles and distance filters from one seed: the
    same items over several draws, and the generators end in the same
    state."""
    tmp_path, _ = mini_kitti
    tc = config.cfgParser(os.path.join(
        REPO, "seq_config", "lnn_train_semantic_kitti.cfg"))
    tf = dict(tc.get_transformer_vars(), random_subsample_percentage=0.2,
              random_stretch_xyz_magnitude=0.1,
              random_translation_xyz_magnitude=1.0)
    ds, jds = _pair(tmp_path, seed=3, train=True, transformer=tf,
                    shuffle_points=True, cap_distance=4.0, min_distance=0.5)
    for i in (11, 3, 0, 7, 7):
        _items_equal(ds[i], jds[i])
    assert ds.rng.bit_generator.state == jds.rng.bit_generator.state


def test_kitti_native_loader_matches(mini_kitti):  # noqa: F811
    """The native C++ loader through the port's bindings: equal to the
    port's numpy path (as the JAX package's test holds its own) and
    bit-equal to the JAX package's native items."""
    if native_loader.get_lib() is None:
        pytest.skip("native library unavailable")
    tmp_path, _ = mini_kitti
    kw = dict(cap_distance=4.0, min_distance=0.5)
    nat, jnat = _pair(tmp_path, seed=3, use_native=True, train=True, **kw)
    num, _ = _pair(tmp_path, seed=3, use_native=False, train=True, **kw)
    a, b, c = nat[6], jnat[6], num[6]
    _items_equal(a, b)
    for fa, fc in zip(a, c):
        assert fa.n_points == fc.n_points
        np.testing.assert_allclose(fa.positions, fc.positions, atol=1e-5)
        np.testing.assert_array_equal(fa.labels, fc.labels)


def test_kitti_measure_sequence_lengths_and_parsers(mini_kitti):  # noqa: F811
    tmp_path, _ = mini_kitti
    ds, jds = _pair(tmp_path, measure_sequence_lengths=True)
    assert ds.dataset_lengths == jds.dataset_lengths
    base = os.path.join(tmp_path, "sequences", "08")
    cal = kitti.parse_calibration(os.path.join(base, "calib.txt"))
    jcal = jkitti.parse_calibration(os.path.join(base, "calib.txt"))
    assert sorted(cal) == sorted(jcal)
    for p, jp in zip(kitti.parse_poses(os.path.join(base, "poses.txt"), cal),
                     jkitti.parse_poses(os.path.join(base, "poses.txt"),
                                        jcal)):
        assert np.array_equal(p, jp)
    lut = kitti_meta.build_remap_lut(True)
    lab = os.path.join(base, "labels", "000003.label")
    assert np.array_equal(kitti.load_label(lab, lut),
                          jkitti.load_label(lab, lut))


# ---------------------------------------------------------------------------
# Paris-Lille and PLY
# ---------------------------------------------------------------------------

def test_ply_round_trip_against_jax(tmp_path):
    """The port's writer writes JAX's bytes, and both readers read either
    file (binary and ascii) to the same structured array."""
    rng = np.random.default_rng(0)
    n = 50
    fields = {"x": rng.normal(size=n).astype(np.float32),
              "GPS_time": np.sort(rng.random(n)).astype(np.float64),
              "class": rng.integers(0, 9, n).astype(np.uint32),
              "i8": rng.integers(-5, 5, n).astype(np.int8)}
    ply.write_ply_vertices(str(tmp_path / "a.ply"), fields)
    jply.write_ply_vertices(str(tmp_path / "b.ply"), fields)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    v, jv = (ply.read_ply_vertices(str(tmp_path / "a.ply")),
             jply.read_ply_vertices(str(tmp_path / "a.ply")))
    assert v.dtype == jv.dtype and np.array_equal(v, jv)
    for k in fields:
        assert np.array_equal(v[k], fields[k])
    ascii_ply = (b"ply\nformat ascii 1.0\nelement vertex 2\nproperty float x"
                 b"\nproperty uchar c\nend_header\n1.5 3\n-2 7\n")
    (tmp_path / "c.ply").write_bytes(ascii_ply)
    v, jv = (ply.read_ply_vertices(str(tmp_path / "c.ply")),
             jply.read_ply_vertices(str(tmp_path / "c.ply")))
    assert np.array_equal(v, jv) and v["c"].tolist() == [3, 7]


def _big_pl_cloud(path, n=250_000, seconds=6.0):
    """A cloud whose 4-second windows hold over 100,000 points, the size
    above which the loader subsamples."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.random(n) * seconds)
    jply.write_ply_vertices(str(path), {
        "x": (rng.normal(size=n) * 3 + t).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
        "z": (rng.random(n) * 2).astype(np.float32),
        "GPS_time": t.astype(np.float64),
        "reflectance": rng.random(n).astype(np.float32),
        "class": rng.choice([202020000, 303020300, 303040202], n
                            ).astype(np.uint32)})


PL_CASES = {
    "valid": dict(split="valid"),
    "train_augmented": dict(
        split="train", shuffle_points=True, subsample_percentage=0.3,
        include_moving_classes=True,
        transformer=dict(random_translation_xz_magnitude=20.0,
                         rotation_y_max_angle=10.0, random_mirror_x=True,
                         random_mirror_z=True,
                         random_rotation_90_degrees_y=True)),
    "accumulate_moving": dict(split="valid", accumulate_clouds=True,
                              include_moving_classes=True, max_points=1024),
}


@pytest.mark.parametrize("case", sorted(PL_CASES))
def test_parislille_windows_bit_equal(tmp_path, case):
    """ParisLille3DDataset from its own copy of the same .ply files (each
    package ingests and caches its own): every window equal to JAX's, from
    one seed, also with augmentation and subsampling; a second dataset of
    each package reads its cache to the same windows."""
    kw = dict(PL_CASES[case])
    split = kw.pop("split")
    max_points = kw.pop("max_points", 4096)
    lc = dict(validation_cloud="Lille2.ply", include_moving_classes=False,
              frames_per_seq=3, cloud_scope=2, shuffle_points=False,
              accumulate_clouds=False, nr_clouds_to_read=-1,
              cap_distance=-1, subsample_percentage=0.0, transformer={})
    lc.update(kw)

    def datasets():
        return [mod.ParisLille3DDataset(
            split, dict(lc, dataset_path=str(tmp_path / sub)), {}, True,
            max_points=max_points, seed=5)
            for mod, sub in ((parislille, "port"), (jparislille, "jax"))]

    for sub in ("port", "jax"):
        (tmp_path / sub).mkdir()
        _write_pl_cloud(tmp_path / sub / "Lille1.ply", 1)
        _write_pl_cloud(tmp_path / sub / "Lille2.ply", 2)
        if split == "train":
            _big_pl_cloud(tmp_path / sub / "Lille3.ply")
    for ds, jds in (datasets(), datasets()):
        assert len(ds) == len(jds) > 2
        assert ds.dataset_lengths == jds.dataset_lengths
        for i in list(range(len(ds)))[-4:] + [0]:
            _items_equal(ds[i], jds[i], os.path.basename)
        assert ds.rng.bit_generator.state == jds.rng.bit_generator.state


def test_synthetic_sequence_equal():
    a = synthetic.synthetic_sequence(np.random.default_rng(4), 3, 500, 512)
    b = jsynthetic.synthetic_sequence(np.random.default_rng(4), 3, 500, 512)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# labels and scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset,moving", [("semantickitti", True),
                                            ("semantickitti", False),
                                            ("parislille", False)])
def test_label_mngr_and_class_weights(dataset, moving):
    m = label_mngr.LabelMngr(dataset=dataset, include_moving=moving)
    jm = jlabel_mngr.LabelMngr(dataset=dataset, include_moving=moving)
    assert m.names == jm.names and m.nr_classes() == jm.nr_classes()
    assert np.array_equal(m.colors_bgr, jm.colors_bgr)
    assert np.array_equal(m.frequencies, jm.frequencies)
    labels = np.arange(-2, m.nr_classes() + 3)
    assert np.array_equal(m.color_from_label_indices(labels),
                          jm.color_from_label_indices(labels))
    assert np.array_equal(m.color_rgb(1), jm.color_rgb(1))
    w = label_mngr.compute_class_weights(m.frequencies, 0)
    assert w.dtype == np.float32
    assert np.array_equal(w, jlabel_mngr.compute_class_weights(
        jm.frequencies, 0))


def test_label_mngr_from_files():
    root = os.path.join(REPO, "colorscheme_and_labels", "semantic-kitti")
    files = [os.path.join(root, f) for f in
             ("labels.txt", "color_scheme.txt", "frequency_26.txt")]
    m, jm = label_mngr.LabelMngr(*files), jlabel_mngr.LabelMngr(*files)
    assert m.names == jm.names
    assert np.array_equal(m.colors_bgr, jm.colors_bgr)
    assert np.array_equal(m.frequencies, jm.frequencies)


def test_scores_equal(tmp_path):
    """Streaming IoU over several seeded batches (the unlabeled index
    ignored, classes absent from some batches), best-epoch tracking and
    the CSV files: equal to JAX's."""
    rng = np.random.default_rng(9)
    s, js = metrics.Scores(), jmetrics.Scores()
    for epoch in range(2):
        for obj in (s, js):
            obj.start_fresh_eval()
        for _ in range(4):
            gt = rng.integers(0, 8, 300)
            pred = np.where(rng.random(300) < 0.6, gt,
                            rng.integers(0, 8, 300))
            for obj in (s, js):
                obj.accumulate_scores(pred, gt, unlabeled_idx=0,
                                      nr_classes=10)
        logits = rng.normal(size=(50, 10))
        gt = rng.integers(0, 10, 50)
        for obj in (s, js):
            obj.accumulate_logits(logits, gt, 0)
            obj.update_best()
        assert s.compute_stats() == js.compute_stats()
        assert s.avg_class_iou() == js.avg_class_iou()
        assert s.iou_per_class() == js.iou_per_class()
        assert (s.best_iou, s.best_iou_dict) == (js.best_iou, js.best_iou_dict)
    for obj, name in ((s, "port"), (js, "jax")):
        obj.write_iou_to_csv(str(tmp_path / f"{name}.csv"))
        obj.write_best_iou_to_csv(str(tmp_path / f"{name}_best.csv"))
    for name in ("", "_best"):
        assert ((tmp_path / f"port{name}.csv").read_text()
                == (tmp_path / f"jax{name}.csv").read_text())
