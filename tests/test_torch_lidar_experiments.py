"""The port's accuracy experiments (``temporal_latticenet_tpu_torch/
experiments/``) against the JAX package's scripts, on the CPU.

The JAX scripts are loaded from ``scripts/`` with ``importlib``: they
import only numpy at module level (the occupancy probes also jax, pinned
to the CPU).  The world writers must write byte-equal files; each
variant's cfg must be the JAX script's text and parse to equal typed
configs, and its windows through the port's loader must equal the JAX
package's bit for bit; the comparison table must be the same Markdown;
the occupancy probes must count what the JAX package's
``build_sequence_lattice`` counts (integer structure: equal).  One
end-to-end run of ``train_lidar`` at the smoke scale writes the JAX
script's results keys.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu import config as jconfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.data.kitti import \
    SemanticKittiDataset as JKittiDataset
from temporal_latticenet_tpu.data.lidar_like import \
    lidar_sequence as j_lidar_sequence
from temporal_latticenet_tpu.data.synthetic import \
    synthetic_sequence as j_synthetic_sequence
from temporal_latticenet_tpu.ops import seq_lattice as jsl
from temporal_latticenet_tpu_torch import config
from temporal_latticenet_tpu_torch.data.kitti import \
    SemanticKittiDataset as TKittiDataset
from temporal_latticenet_tpu_torch.data.lidar_like import lidar_sequence
from temporal_latticenet_tpu_torch.data.synthetic import synthetic_sequence
from temporal_latticenet_tpu_torch.experiments import (moving_table,
                                                       occupancy,
                                                       occupancy_worlds,
                                                       overfit_lidar,
                                                       train_lidar)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of scripts/train_lidar.py's results (:334-357)
RESULTS_KEYS = {"variant", "moving", "worlds", "scans",
                "train_windows_per_epoch", "epochs", "scale", "scope",
                "train_wall_s", "checkpoint", "miou_train", "iou_train",
                "miou_valid", "iou_valid"}
# occupancy probe capacities above the smoke scale's union counts (its
# own 4096/2048/1024 saturate, which would hide a difference)
PROBE_CAP0 = 32768
PROBE_MIN_CAP = 8192


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtl():
    return _script("train_lidar")


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_constants_equal(jtl):
    for name in ("TRAIN_TO_RAW", "SCALES", "CFG_TEMPLATE", "AUG_BLOCK",
                 "TRAIN_SEQS", "VALID_SEQS", "CLASS_NAMES"):
        assert getattr(train_lidar, name) == getattr(jtl, name), name
    jo = _script("overfit_lidar")
    assert overfit_lidar.TRAIN_TO_RAW == jo.TRAIN_TO_RAW
    assert overfit_lidar.CFG_TEMPLATE == jo.CFG_TEMPLATE
    jm = _script("moving_table")
    assert moving_table.VARIANTS == jm.VARIANTS
    assert moving_table.CLASSES == jm.CLASSES


@pytest.mark.parametrize("moving", [0, 1])
def test_write_moving_world_byte_equal(jtl, tmp_path, moving):
    beams, n_az = train_lidar.SCALES["smoke"][:2]
    for mod, root in ((jtl, tmp_path / "jax"), (train_lidar,
                                                tmp_path / "port")):
        for seq in ("00", "08"):
            mod.write_moving_world(str(root), seq, 3, beams, n_az,
                                   bool(moving), seed=1000 + int(seq))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(want) == 2 * (2 + 2 * 3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def test_overfit_write_world_byte_equal(tmp_path):
    jo = _script("overfit_lidar")
    jo.write_world(str(tmp_path / "jax"), n_scans=3, n_beams=16, n_az=256)
    overfit_lidar.write_world(str(tmp_path / "port"), n_scans=3, n_beams=16,
                              n_az=256)
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert len(want) == 3 * (2 + 2 * 3)
    assert got == want


def _jax_cfg(jtl, variant, epochs, scale, scope, aug, frames, rnn, remat,
             ckpt, preds, data, load_ckpt="false", load_model="",
             start_epoch=0):
    """The cfg text of scripts/train_lidar.py:253-320, line for line."""
    beams, n_az, max_points, cap0, min_cap = jtl.SCALES[scale]
    if variant == "accum":
        max_points *= 4
    seq_learning = "false" if variant == "static" else "true"
    accum = "true" if variant == "accum" else "false"
    if variant in ("temporal", "accum"):
        mods = (rnn.split(",") if rnn else ["gru", "gru", "aflow", "gru"])
    else:
        mods = ["none"] * 4
    rnn_s = "[" + ", ".join(f'"{m.strip()}"' for m in mods) + "]"
    return jtl.CFG_TEMPLATE.format(
        epochs=epochs, restart_epochs=max(epochs // 3, 5),
        cap=cap0, ckpt=ckpt, preds=preds, data=data,
        max_points=max_points, min_cap=min_cap, scope=scope,
        aug=jtl.AUG_BLOCK if aug else "",
        frames=frames if variant != "static" else 1,
        seq_learning=seq_learning, rnn_modules=rnn_s, accum=accum,
        remat=remat, load_ckpt=load_ckpt, load_model=load_model,
        start_epoch=start_epoch)


CFG_CASES = {
    "temporal": dict(variant="temporal", epochs=16, scale="full", scope=1,
                     aug=0, frames=4, rnn="", remat="full"),
    "static": dict(variant="static", epochs=16, scale="full", scope=1,
                   aug=0, frames=4, rnn="", remat="full"),
    "accum": dict(variant="accum", epochs=16, scale="full", scope=1, aug=0,
                  frames=4, rnn="", remat="full"),
    "generalization": dict(variant="temporal", epochs=12, scale="full",
                           scope=1, aug=1, frames=4, rnn="", remat="selective"),
    "rnn_resume": dict(variant="temporal", epochs=3, scale="small", scope=3,
                       aug=0, frames=3, rnn="gru, gru,gru,gru", remat="none",
                       load_ckpt="true", load_model="x_epoch1.ckpt",
                       start_epoch=2),
}


@pytest.mark.parametrize("case", sorted(CFG_CASES))
def test_variant_cfg_matches_jax(jtl, tmp_path, case):
    kw = dict(CFG_CASES[case], ckpt=str(tmp_path / "ckpt"),
              preds=str(tmp_path / "preds"), data=str(tmp_path / "data"))
    want = _jax_cfg(jtl, **kw)
    variant = kw.pop("variant")
    got = train_lidar.format_cfg(variant, **kw)
    assert got == want
    path = tmp_path / "cfg.cfg"
    path.write_text(got)
    p, jp = config.cfgParser(str(path)), jconfig.cfgParser(str(path))
    n = config.nr_classes_from_cfg(p)
    assert n == jconfig.nr_classes_from_cfg(jp) == 26
    mc = config.model_config_from_cfg(p, n)
    assert dataclasses.asdict(mc) == dataclasses.asdict(
        jconfig.model_config_from_cfg(jp, n))
    assert (dataclasses.asdict(config.runtime_config_from_cfg(p))
            == dataclasses.asdict(jconfig.runtime_config_from_cfg(jp)))
    assert p.get_loader_vars() == jp.get_loader_vars()
    assert mc.sequence_learning == (variant != "static")
    assert p.get_loader_vars()["accumulate_clouds"] == (variant == "accum")


@pytest.mark.parametrize("case", ["temporal", "static", "accum",
                                  "generalization"])
def test_variant_windows_match_jax(jtl, tmp_path, case):
    """Each variant's train and valid windows on the JAX script's worlds,
    through the port's loader and the JAX package's with the cfg's loader
    variables (augmentation from one seed): bit-equal."""
    data = tmp_path / "data"
    beams, n_az = jtl.SCALES["smoke"][:2]
    for seq in ("00", "08"):
        jtl.write_moving_world(str(data), seq, 5, beams, n_az, True,
                               seed=1000 + int(seq))
    kw = dict(CFG_CASES[case], scale="smoke", ckpt=str(tmp_path / "ckpt"),
              preds=str(tmp_path / "preds"), data=str(data))
    path = tmp_path / "cfg.cfg"
    path.write_text(train_lidar.format_cfg(kw.pop("variant"), **kw))
    p = config.cfgParser(str(path))
    mc = config.model_config_from_cfg(p, config.nr_classes_from_cfg(p))
    rt = config.runtime_config_from_cfg(p)
    for split in ("train", "valid"):
        args = (split, p.get_loader_vars(), p.get_model_vars(),
                mc.sequence_learning)
        got = TKittiDataset(*args, max_points=rt.max_points, seed=3)
        want = JKittiDataset(*args, max_points=rt.max_points, seed=3)
        assert len(got) == len(want) == 5
        for i in range(len(want)):
            g, w = got[i], want[i]
            frames = 1 if case in ("static", "accum") else 4
            assert len(g) == len(w) == frames
            for gf, wf in zip(g, w):
                for f in ("positions", "values", "labels", "mask"):
                    np.testing.assert_array_equal(getattr(gf, f),
                                                  getattr(wf, f), f)
                assert (gf.n_points, gf.last_n, gf.path) == (
                    wf.n_points, wf.last_n, wf.path)


def test_newest_epoch_checkpoint(tmp_path):
    assert train_lidar.newest_epoch_checkpoint(str(tmp_path)) is None
    for name in ("a_epoch2.ckpt", "b_epoch10.ckpt", "c_epoch9.ckpt",
                 "latest.ckpt", "d_epoch11.csv"):
        (tmp_path / name).write_text("")
    assert train_lidar.newest_epoch_checkpoint(str(tmp_path)) == (
        10, "b_epoch10.ckpt")


def _moving_results(variant, seed):
    rng = np.random.default_rng(seed)
    ious = {c: float(rng.random()) for c in moving_table.CLASSES}
    if variant == "static":
        del ious["moving-person"]      # a class absent from the split
    return {"variant": variant, "worlds": 10, "train_windows_per_epoch": 100,
            "epochs": 16, "miou_valid": float(rng.random()),
            "miou_train": float(rng.random()), "iou_valid": ious}


@pytest.mark.parametrize("variants", [("temporal", "accum", "static"),
                                      ("static", "temporal")])
def test_moving_table_matches_jax(tmp_path, monkeypatch, capsys, variants):
    jdir, pdir = tmp_path / "jax" / "artifacts", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir(parents=True)
        for i, v in enumerate(variants):
            (d / f"moving_{v}_full.json").write_text(
                json.dumps(_moving_results(v, i)))
    jm = _script("moving_table")
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["moving_table.py", "full"])
    jm.main()
    want_out = capsys.readouterr().out
    got = moving_table.main(["full", "--dir", str(pdir)])
    assert capsys.readouterr().out == want_out.replace(
        "artifacts/", str(pdir) + "/")
    want = (jdir / "moving_comparison_full.md").read_text()
    assert (pdir / "moving_comparison_full.md").read_text() == want == got


@pytest.fixture(scope="module")
def j_counts():
    """The JAX package's per-level, per-frame union counts (jitted; one
    compile for the (4, 4096) windows and probe capacities of the tests
    below)."""
    rt = JRuntimeConfig(max_points=4096, capacity_level0=PROBE_CAP0,
                        capacity_decay=0.5, min_capacity=PROBE_MIN_CAP,
                        sigma=0.6)
    caps = rt.capacities(2)
    build = jax.jit(lambda p, m: tuple(
        lvl.counts for lvl in
        jsl.build_sequence_lattice(p, m, rt.sigma, caps, 2).levels))
    return lambda p, m: [np.asarray(c).tolist() for c in
                         build(jnp.asarray(p), jnp.asarray(m))]


def test_occupancy_worlds_matches_jax(j_counts, tmp_path, capsys):
    """The probe's every window and worst counts against the JAX package's
    loader and lattice build on the JAX script's worlds."""
    jtl = _script("train_lidar")
    beams, n_az, max_points = jtl.SCALES["smoke"][:3]
    for w in range(2):
        jtl.write_moving_world(str(tmp_path), f"{w:02d}", 5, beams, n_az,
                               True, seed=1000 + w)
    lc = dict(dataset_path=str(tmp_path), include_moving_classes=True,
              frames_per_seq=4, cloud_scope=1, do_pose=True,
              shuffle_points=False, measure_sequence_lengths=True,
              transformer={})
    ds = JKittiDataset("train", lc, {}, sequence_learning=True,
                       max_points=max_points)
    want = []
    for i in range(0, len(ds), 3):
        frames = ds[i]
        counts = j_counts(np.stack([f.positions for f in frames]),
                          np.stack([f.mask for f in frames]))
        want.append([c[-1] for c in counts])
    got = occupancy_worlds.main(
        ["--scale", "smoke", "--moving", "1", "--worlds", "2", "--scans",
         "5", "--stride", "3", "--cap0", str(PROBE_CAP0), "--min-cap",
         str(PROBE_MIN_CAP), "--cpu"])
    assert len(want) == 4
    assert got["windows"] == want
    assert got["worst"] == [max(c) for c in zip(*want)]
    assert got["caps"] == [PROBE_CAP0, PROBE_CAP0 // 2, PROBE_MIN_CAP]
    assert all(w < c for w, c in zip(got["worst"], got["caps"]))
    assert "worst-case union counts:" in capsys.readouterr().out


def test_occupancy_measure_matches_jax(j_counts, capsys):
    """Both generators' per-frame counts at every level, at 4,096 points
    a frame (the probe's own 131,072 would be slow on the CPU)."""
    caps = (PROBE_CAP0, PROBE_CAP0 // 2, PROBE_MIN_CAP)
    for gen, jgen in (
            (lambda r: synthetic_sequence(r, 4, 3000, 4096),
             lambda r: j_synthetic_sequence(r, 4, 3000, 4096)),
            (lambda r: lidar_sequence(r, 4, 4096),
             lambda r: j_lidar_sequence(r, 4, 4096))):
        p, _, _, m = gen(np.random.default_rng(0))
        got = occupancy.measure("probe", p, m, caps, 0.6, 2,
                                torch.device("cpu"))
        p, _, _, m = jgen(np.random.default_rng(0))
        assert got == j_counts(p, m)
        assert len(got) == 3 and all(len(c) == 4 for c in got)
    assert "level 2: per-frame counts" in capsys.readouterr().out


def test_train_lidar_end_to_end_cpu(jtl, tmp_path):
    """Worlds, cfg, one epoch of training and both evaluations at the smoke
    scale: the results JSON carries the JAX script's keys."""
    out = tmp_path / "results.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = train_lidar.main(
            ["--variant", "temporal", "--scale", "smoke", "--worlds", "1",
             "--scans", "4", "--epochs", "1", "--cpu", "--root",
             str(tmp_path / "run"), "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    saved = json.loads(out.read_text())
    assert set(saved) == RESULTS_KEYS
    assert saved == json.loads(json.dumps(res))
    assert saved["train_windows_per_epoch"] == 4
    for split in ("train", "valid"):
        assert 0.0 <= saved[f"miou_{split}"] <= 1.0
        assert saved[f"iou_{split}"]
        assert all(0.0 <= v <= 1.0 for v in saved[f"iou_{split}"].values())
        assert set(saved[f"iou_{split}"]) <= set(jtl.CLASS_NAMES.values())
    assert saved["checkpoint"].endswith("_epoch0.ckpt")
    assert os.path.exists(saved["checkpoint"])
    stamp = json.loads((tmp_path / "run" / "data" / "GENERATED.json")
                       .read_text())
    assert stamp == {"worlds": 1, "scans": 4, "beams": 16, "n_az": 256,
                     "moving": 1, "refl": "material-v2",
                     "geom": "actor-only-cars-v3"}
    cfg = (tmp_path / "run" / "cfg_temporal.cfg").read_text()
    root = str(tmp_path / "run")
    assert cfg == _jax_cfg(jtl, "temporal", 1, "smoke", 1, 0, 4, "", "full",
                           os.path.join(root, "ckpt_temporal"),
                           os.path.join(root, "preds"),
                           os.path.join(root, "data"))
