"""The PyTorch port's training and evaluation loop on the CPU, on the
on-disk mini dataset and config of ``tests/test_loop.py`` (``tiny_world``):
train and eval with checkpoints and devkit predictions, resume from an
epoch checkpoint, accumulated clouds and the eval trimmed to the last scan,
the submission report, Paris-Lille, the CLIs, and what raises.

One cross-check runs both packages' loops in float32 from the same ``.pt``
on the same seeded datasets (augmentation on) for two training steps and
the valid sequence after them: the first step's loss within 1e-4 (the
forward alone), the second's within 1e-3 (after one AdamW step, whose
normalised update magnifies float32 differences in small gradients), the
valid mIoU equal and the predictions equal except where the port's top two
log-probabilities lie within 1e-4.  Measured: 2.4e-7 and 7.2e-7, the valid
loss 2.0e-6 apart, no prediction differs.  A second runs both for three
whole epochs (9 shuffled steps through the cosine schedule, 9 valid
sequences): every loss within 1e-3, the float32 reordering grown over 9
AdamW steps.  Measured: the training losses 0 to 1.6e-4 apart (2.4e-5 at
step 7, 1.6e-4 at step 9), the valid losses 2.4e-6 to 4.1e-4, no
prediction differs, both valid mIoUs 0.14882444205752476.  Nearly all of
their time is the JAX loop's compile of its train and eval steps (the
second reads the first's from the compile cache)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu import config as jconfig
from temporal_latticenet_tpu.data import kitti as jkitti
from temporal_latticenet_tpu.train import checkpoint as jckpt
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu.train import loop as jloop
from temporal_latticenet_tpu.train import torch_convert as tc
from temporal_latticenet_tpu_torch import config, test_ln, train_ln
from temporal_latticenet_tpu_torch.data import kitti
from temporal_latticenet_tpu_torch.data.kitti_meta import LEARNING_MAP_26
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train import loop as tloop
from temporal_latticenet_tpu_torch.train.callbacks import Callback
from tests.test_loop import _patch_lengths, tiny_world  # noqa: F401
from tests.test_parislille import PL_CFG, _write_pl_cloud
from tests.test_torch_configs import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP1_ATOL = 1e-4
STEP2_ATOL = 1e-3
EPOCHS_ATOL = 1e-3
TIE = 1e-4


def _configs(cfg_path):
    parser = config.cfgParser(cfg_path)
    cfg = config.model_config_from_cfg(parser,
                                       config.nr_classes_from_cfg(parser))
    return parser, cfg, config.runtime_config_from_cfg(parser)


def _datasets(cfg_path, splits=("train", "valid")):
    parser, cfg, rt = _configs(cfg_path)
    return _patch_lengths(tloop.make_datasets(parser, cfg, rt, splits))


def _edit(tmp_path, cfg_path, name, *pairs):
    text = open(cfg_path).read()
    for a, b in pairs:
        assert a in text, a
        text = text.replace(a, b)
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_run_training_and_eval(tiny_world):  # noqa: F811
    """Training writes an epoch checkpoint and the valid IoU CSV; eval
    writes one devkit .label per sequence with every point of its last
    scan."""
    tmp_path, cfg_path = tiny_world
    model, state = tloop.run_training(cfg_path, max_steps=4,
                                      datasets=_datasets(cfg_path),
                                      device="cpu")
    assert state.step == 3 and model.device.type == "cpu"
    ckpts = os.listdir(tmp_path / "ckpts")
    assert any(c.endswith("_epoch0.ckpt") for c in ckpts)
    assert any(c.endswith("_epoch0.csv") for c in ckpts)

    miou, phase = tloop.run_eval(cfg_path, split="valid", max_seqs=2,
                                 datasets=_datasets(cfg_path, ("valid",)),
                                 device="cpu")
    assert 0.0 <= miou <= 1.0 and phase.iter_nr == 2
    label_files = sorted((tmp_path / "preds" / "sequences" / "08"
                          / "predictions").glob("*.label"))
    assert [f.name for f in label_files] == ["000000.label", "000001.label"]
    for f in label_files:
        raw = np.fromfile(f, dtype=np.uint32)
        assert raw.shape == (40,) and raw.max() < 26


def test_run_training_and_eval_with_an_experiment(tiny_world):  # noqa: F811
    """A cfg with ``experiment: attention_pool`` and ``dropout_last_layer:
    0.2`` (behind the early fusion "none", which the reduced width needs)
    trains, saves, and evaluates from its epoch checkpoint."""
    tmp_path, cfg_path = tiny_world
    xcfg = _edit(tmp_path, cfg_path, "attention.cfg",
                 ('experiment: "none"', 'experiment: "attention_pool"'),
                 ("dropout_last_layer: 0.0", "dropout_last_layer: 0.2"),
                 ('rnn_modules: ["gru", "none", "none", "gru"]',
                  'rnn_modules: ["none", "gru", "none", "gru"]'))
    model, state = tloop.run_training(xcfg, max_steps=4,
                                      datasets=_datasets(xcfg), device="cpu")
    assert state.step == 3
    assert model.cfg.experiment == "attention_pool"
    assert model.cfg.dropout_last_layer == 0.2
    assert "point_net_seq.gamma" in model.state_dict()
    epoch0 = [c for c in os.listdir(tmp_path / "ckpts")
              if c.endswith("_epoch0.ckpt")]
    assert len(epoch0) == 1
    ecfg = _edit(tmp_path, xcfg, "attention_eval.cfg",
                 ('load_checkpoint_model: ""\n    do_write_predictions',
                  f'load_checkpoint_model: "{epoch0[0]}"\n'
                  "    do_write_predictions"))
    miou, phase = tloop.run_eval(ecfg, split="valid", max_seqs=2,
                                 datasets=_datasets(ecfg, ("valid",)),
                                 device="cpu")
    assert 0.0 <= miou <= 1.0 and phase.iter_nr == 2


def test_resume_from_epoch_checkpoint(tiny_world):  # noqa: F811
    """train.start_epoch with load_checkpoint resumes a run: the epoch
    numbering (file names, schedule) continues, the step count carries
    over, and the restored weights and AdamW state are the saved ones."""
    tmp_path, cfg_path = tiny_world
    model0, state0 = tloop.run_training(cfg_path, datasets=_datasets(cfg_path),
                                        device="cpu")
    epoch0 = [c for c in os.listdir(tmp_path / "ckpts")
              if c.endswith("_epoch0.ckpt")]
    assert len(epoch0) == 1
    resume = _edit(tmp_path, cfg_path, "resume.cfg",
                   ("training_epochs: 1", "training_epochs: 2"),
                   ("load_checkpoint: false", "load_checkpoint: true"),
                   ('load_checkpoint_model: ""\n}',
                    f'load_checkpoint_model: "{epoch0[0]}"\n'
                    "    start_epoch: 1\n}"))
    model1, state1 = tloop.run_training(resume, max_steps=0,
                                        datasets=_datasets(cfg_path),
                                        device="cpu")
    # max_steps=0 stops after the first sequence: one more train step
    assert state1.step == state0.step + 1
    model2, state2 = tloop.run_training(resume, datasets=_datasets(cfg_path),
                                        device="cpu")
    names = os.listdir(tmp_path / "ckpts")
    assert any(c.endswith("_epoch1.ckpt") for c in names), names
    assert state2.step == 2 * state0.step
    # a resumed run starts from the saved weights: reloading the epoch-0
    # file into a fresh model restores model0 exactly
    from temporal_latticenet_tpu_torch.train import checkpoint as ckpt
    parser, cfg, rt = _configs(cfg_path)
    fresh, fstate = engine.create_train_state(cfg, rt, 1e-3, 1e-3, seed=5,
                                              device="cpu")
    assert ckpt.load(str(tmp_path / "ckpts" / epoch0[0]), fresh,
                     fstate.optimizer) == state0.step
    for a, b in zip(model0.state_dict().values(), fresh.state_dict().values()):
        assert torch.equal(a, b)


def test_run_training_seed(tiny_world, monkeypatch):  # noqa: F811
    """``run_training`` without a seed is ``seed=0`` bit for bit (the JAX
    loop's fixed draw of weights and shuffle); another seed draws other
    initial weights and another epoch order."""
    tmp_path, cfg_path = tiny_world
    sh = _edit(tmp_path, cfg_path, "shuffle.cfg",
               ("shuffle: false", "shuffle: true"),
               ("training_epochs: 1", "training_epochs: 2"))
    seen = []

    class Rec(tloop.StateCallback):
        def after_forward_pass(self, *, phase=None, **kw):
            if phase.grad:
                seen[-1].append((float(kw["loss"]), kw["target"].tobytes()))
            super().after_forward_pass(phase=phase, **kw)

    monkeypatch.setattr(tloop, "StateCallback", Rec)
    seeds, create = [], engine.create_train_state

    def creating(*a, **kw):
        seeds.append(kw["seed"])
        return create(*a, **kw)

    monkeypatch.setattr(engine, "create_train_state", creating)
    runs = {}
    for name, kw in (("default", {}), ("zero", {"seed": 0}),
                     ("one", {"seed": 1})):
        seen.append([])
        model, state = tloop.run_training(sh, datasets=_datasets(sh),
                                          device="cpu", **kw)
        runs[name] = (seen[-1], model.state_dict())
    (steps_d, sd_d), (steps_0, sd_0), (steps_1, sd_1) = runs.values()
    assert seeds == [0, 0, 1]
    assert len(steps_d) == 6 and steps_d == steps_0
    assert all(torch.equal(sd_d[k], sd_0[k]) for k in sd_d)
    assert [t for _, t in steps_1] != [t for _, t in steps_0]   # the order
    assert not all(torch.equal(sd_1[k], sd_0[k]) for k in sd_0)


def test_run_training_accumulate_clouds(tiny_world):  # noqa: F811
    """accumulate_clouds: the window concatenates into one cloud and trains
    as a single-frame sequence (BASELINE config 2)."""
    tmp_path, cfg_path = tiny_world
    acc = _edit(tmp_path, cfg_path, "accum.cfg",
                ("accumulate_clouds: false", "accumulate_clouds: true"),
                ("max_points: 64", "max_points: 128"))
    datasets = _datasets(acc)
    frames = datasets["train"][1]
    assert len(frames) == 1 and frames[0].n_points == 80
    model, state = tloop.run_training(acc, max_steps=2, datasets=datasets,
                                      device="cpu")
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_accumulate_eval_trims_to_last_scan(tiny_world):  # noqa: F811
    """In ACCUM mode the .label holds exactly the LAST scan's points, which
    survive a max_points overflow (the oldest points go first)."""
    tmp_path, cfg_path = tiny_world
    acc = _edit(tmp_path, cfg_path, "accum.cfg",
                ("accumulate_clouds: false", "accumulate_clouds: true"))
    eval_sets = _datasets(acc, ("valid",))
    fb = eval_sets["valid"][0][0]
    assert fb.n_points == 64 and fb.last_n == 40
    raw = np.fromfile(fb.path.replace("velodyne", "labels")
                      .replace(".bin", ".label"), dtype=np.uint32)
    mapped = np.asarray([LEARNING_MAP_26[v] for v in (raw & 0xFFFF)])
    np.testing.assert_array_equal(fb.labels[64 - 40:64], mapped)
    tloop.run_eval(acc, split="valid", max_seqs=1, datasets=eval_sets,
                   device="cpu")
    label_files = list((tmp_path / "preds" / "sequences").rglob("*.label"))
    assert len(label_files) == 1
    assert np.fromfile(label_files[0], dtype=np.uint32).shape == (40,)


def test_run_eval_reports_submission_validation(tiny_world, capsys):  # noqa: F811
    """A full split with prediction writing runs this package's submission
    check and prints its report (informative, never fatal): the three
    scans without a window here are reported missing."""
    tmp_path, cfg_path = tiny_world
    tloop.run_eval(cfg_path, split="valid",
                   datasets=_datasets(cfg_path, ("valid",)), device="cpu")
    out = capsys.readouterr().out
    assert "VALIDATION FAILED: 3 missing" in out
    assert "08/predictions/000005.label" in out


def test_parislille_train_and_eval(tmp_path):
    """Paris-Lille from its cfg (BASELINE config 6): train on Lille1,
    validate and evaluate on Lille2, with the cfg's own datasets."""
    data = tmp_path / "pl"
    data.mkdir()
    _write_pl_cloud(data / "Lille1.ply", 1)
    _write_pl_cloud(data / "Lille2.ply", 2)
    cfg_path = tmp_path / "pl.cfg"
    cfg_path.write_text(PL_CFG.format(data=str(data), ckpt=str(tmp_path)))
    model, state = tloop.run_training(str(cfg_path), max_steps=2,
                                      device="cpu")
    assert state.step == 2 and model.cfg.nr_classes == 10
    miou, phase = tloop.run_eval(str(cfg_path), split="valid", max_seqs=2,
                                 device="cpu")
    assert np.isfinite(miou) and len(phase.scores.iou_per_class()) > 0


def test_with_wandb_watches_gradients(tiny_world, monkeypatch):  # noqa: F811
    """train.with_wandb turns on the step's per-parameter gradient norms
    (wandb.watch's analog), handed to the callbacks as floats whose root
    sum of squares is the global norm.  The wandb callback itself is
    stubbed: the test never logs anywhere."""
    tmp_path, cfg_path = tiny_world
    wb = _edit(tmp_path, cfg_path, "wandb.cfg",
               ("with_wandb: false", "with_wandb: true"))
    seen = []

    class Rec(tloop.StateCallback):
        def after_forward_pass(self, *, phase=None, **kw):
            if phase.grad:
                seen.append((kw["grad_norm"], kw["grad_norms"]))
            super().after_forward_pass(phase=phase, **kw)

    monkeypatch.setattr(tloop, "StateCallback", Rec)
    monkeypatch.setattr(tloop, "WandBCallback", lambda *a, **k: Callback())
    model, _ = tloop.run_training(wb, max_steps=1,
                                  datasets=_datasets(cfg_path), device="cpu")
    (norm, norms), = seen
    assert sorted(norms) == sorted(n for n, _ in model.named_parameters())
    assert all(isinstance(v, float) for v in norms.values())
    assert np.isclose(np.sqrt(sum(v * v for v in norms.values())), norm,
                      rtol=1e-5)


def test_prefetch_stops_its_thread_when_closed():
    """A caller that stops early (``max_steps``, ``max_seqs``) closes the
    generator: its worker, blocked on a full queue, ends and is joined.  A
    loader exception is raised in the caller, and the worker ends too."""
    import threading
    before = threading.active_count()
    loaded = []

    def windows():
        for i in range(100):
            loaded.append(i)
            yield i

    it = tloop._prefetch(windows(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert threading.active_count() == before
    assert len(loaded) <= 3 + 2 + 1    # taken, queued, one in hand

    def failing():
        yield 0
        raise OSError("unreadable scan")

    it = tloop._prefetch(failing())
    assert next(it) == 0
    with pytest.raises(OSError, match="unreadable scan"):
        next(it)
    assert threading.active_count() == before


def test_batch_size_above_one_raises(tiny_world):  # noqa: F811
    """``batch_size: 2`` runs on one device: one step of two of the three
    train sequences (the remainder is dropped, as in the JAX loop).  A
    batch larger than the train split raises the JAX loop's ValueError.
    The same cfg over two ranks is tests/test_torch_parallel.py's."""
    tmp_path, cfg_path = tiny_world
    bp = _edit(tmp_path, cfg_path, "dp.cfg", ("batch_size: 1", "batch_size: 2"))
    model, state = tloop.run_training(bp, datasets=_datasets(cfg_path),
                                      device="cpu")
    assert state.step == 1
    assert any(c.endswith("_epoch0.ckpt")
               for c in os.listdir(tmp_path / "ckpts"))
    big = _edit(tmp_path, cfg_path, "big.cfg",
                ("batch_size: 1", "batch_size: 4"))
    with pytest.raises(ValueError, match="batch_size=4"):
        tloop.run_training(big, datasets=_datasets(cfg_path), device="cpu")


def test_clis_on_cpu(tiny_world, capsys):  # noqa: F811
    """Both CLIs with --device cpu on the cfg's own datasets (the official
    scan counts place every index of the tiny split in its first
    sequence), and train_ln once as ``python -m``."""
    tmp_path, cfg_path = tiny_world
    train_ln.main(["--config", cfg_path, "--device", "cpu"])
    assert any(c.endswith("_epoch0.ckpt")
               for c in os.listdir(tmp_path / "ckpts"))
    test_ln.main(["--config", cfg_path, "--split", "valid", "--device",
                  "cpu"])
    out = capsys.readouterr().out
    assert "mean IoU:" in out and "validation" in out.lower()
    assert len(list((tmp_path / "preds").rglob("*.label"))) == 3
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "temporal_latticenet_tpu_torch.train_ln",
         "--dataset", "semantickitti", "--config", cfg_path, "--device",
         "cpu"], capture_output=True, text=True, env=env, timeout=300,
        cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-2000:]
    assert "saved checkpoint:" in run.stdout


def test_default_device_raises_without_cuda(tiny_world, monkeypatch):  # noqa: F811
    """With no device given and no CUDA, the loop and both CLIs raise
    instead of running on the CPU."""
    tmp_path, cfg_path = tiny_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tloop.run_training(cfg_path),
                 lambda: tloop.run_eval(cfg_path, split="valid"),
                 lambda: train_ln.main(["--config", cfg_path]),
                 lambda: test_ln.main(["--config", cfg_path])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "ckpts").exists()
    with pytest.raises(SystemExit):
        train_ln.main(["--dataset", "kitti"])


# ---------------------------------------------------------------------------
# the cross-check against the JAX package's loop
# ---------------------------------------------------------------------------

class _Recorder:
    """Wraps a package's StateCallback: each phase's (loss, predictions)
    per sequence and its mean IoU at the epoch's end."""

    def __init__(self, base):
        rec = self
        self.seqs, self.miou = [], {}

        class Recording(base):
            def after_forward_pass(self, *, phase=None, **kw):
                rec.seqs.append((phase.name, float(kw["loss"]),
                                 np.array(kw["pred_labels"])))
                super().after_forward_pass(phase=phase, **kw)

            def epoch_ended(self, *, phase=None, **kw):
                rec.miou[phase.name] = phase.scores.avg_class_iou()
                super().epoch_ended(phase=phase, **kw)

        self.cls = Recording

    def losses(self, name):
        return [loss for n, loss, _ in self.seqs if n == name]

    def preds(self, name):
        return [p for n, _, p in self.seqs if n == name]


def _seeded_datasets(mod, cfg_path, seed=7):
    parser = config.cfgParser(cfg_path)
    lc, mc = parser.get_loader_vars(), parser.get_model_vars()
    return _patch_lengths({s: mod.SemanticKittiDataset(
        s, lc, mc, True, max_points=64, seed=seed)
        for s in ("train", "valid")})


def _cross_check_cfgs(tmp_path, cfg_path, *edits):
    """The port's and the JAX loop's float32 cfgs (augmentation on, point
    shuffle on, ``edits`` on top), loading the same weights: the JAX
    model's seed-0 init as a reference-schema ``.pt`` for the port and the
    same file carried into a JAX ``.ckpt`` (the JAX loop's ``run_training``
    hands the converter the wrong template for a ``.pt``)."""
    tf = ("transformer: { random_translation_xz_magnitude: 2.0 "
          "rotation_y_max_angle: 10.0 random_mirror_x: true "
          "random_mirror_z: true random_rotation_90_degrees_y: true }")
    common = (("min_capacity: 256", 'min_capacity: 256\n    compute_dtype: '
               '"float32"'), ("shuffle_points: false", "shuffle_points: true"),
              ("transformer: { }", tf),
              ("load_checkpoint: false", "load_checkpoint: true")) + edits
    paths = {}
    for side, model_file in (("port", "init.pt"), ("jax", "init.ckpt")):
        paths[side] = _edit(
            tmp_path, cfg_path, f"{side}.cfg", *common,
            ('load_checkpoint_model: ""\n}',
             f'load_checkpoint_model: "{model_file}"\n}}'),
            (str(tmp_path / "ckpts"), str(tmp_path / side)))

    jp = jconfig.cfgParser(paths["jax"])
    jcfg = jconfig.model_config_from_cfg(jp, jconfig.nr_classes_from_cfg(jp))
    jrt = jconfig.runtime_config_from_cfg(jp)
    assert jcfg.compute_dtype == "float32"
    _, jstate, _ = jengine.create_train_state(jcfg, jrt, 1e-3, 1e-3)
    inner = jax.tree_util.tree_map(np.asarray, jstate.params["params"])
    sd = tc.export_state_dict(inner, jcfg)
    os.makedirs(tmp_path / "port")
    torch.save({k: torch.tensor(v) for k, v in sd.items()},
               str(tmp_path / "port" / "init.pt"))
    params = tc.load_pt_checkpoint(str(tmp_path / "port" / "init.pt"), jcfg,
                                   inner)
    jckpt.save(str(tmp_path / "jax" / "init.ckpt"), {"params": params},
               jstate.opt_state, 0)
    return paths


def _both_loops(paths, monkeypatch, max_steps=None):
    """Both loops on the same seeded datasets; their recorders and the
    port's model."""
    rec, jrec = _Recorder(tloop.StateCallback), _Recorder(jloop.StateCallback)
    monkeypatch.setattr(tloop, "StateCallback", rec.cls)
    monkeypatch.setattr(jloop, "StateCallback", jrec.cls)
    model, _ = tloop.run_training(paths["port"], max_steps=max_steps,
                                  datasets=_seeded_datasets(kitti,
                                                            paths["port"]),
                                  device="cpu")
    jloop.run_training(paths["jax"], max_steps=max_steps,
                       datasets=_seeded_datasets(jkitti, paths["jax"]))
    return rec, jrec, model


def _top_two_gap(model, cfg_path, frames):
    """The port's top-two log-probability gap at each point of the last
    frame."""
    parser, cfg, rt = _configs(cfg_path)
    _, eval_step = engine.make_train_step(model, cfg, rt)
    logp, _ = eval_step(engine.SeqBatch.stack([frames], "cpu"))
    top2 = torch.topk(logp[0][torch.as_tensor(frames[-1].mask)], 2).values
    return (top2[:, 0] - top2[:, 1]).numpy()


def test_loop_matches_jax_float32(tiny_world, monkeypatch):  # noqa: F811
    """Both loops from the same ``.pt`` on the same seeded data, two steps
    and the valid sequence: losses, valid mIoU and predictions agree."""
    tmp_path, cfg_path = tiny_world
    paths = _cross_check_cfgs(tmp_path, cfg_path)
    rec, jrec, model = _both_loops(paths, monkeypatch, max_steps=2)

    (l1, l2), (j1, j2) = rec.losses("train"), jrec.losses("train")
    assert abs(l1 - j1) <= STEP1_ATOL, (l1, j1)
    assert abs(l2 - j2) <= STEP2_ATOL, (l2, j2)
    (pred,), (jpred,) = rec.preds("valid"), jrec.preds("valid")
    differ = pred != jpred
    if differ.any():
        frames = _seeded_datasets(kitti, paths["port"])["valid"][0]
        gap = _top_two_gap(model, paths["port"], frames)
        assert (gap[differ] <= TIE).all(), gap[differ]
    else:
        assert rec.miou["valid"] == jrec.miou["valid"]
    assert abs(rec.losses("valid")[0] - jrec.losses("valid")[0]) <= STEP2_ATOL


def test_loop_matches_jax_float32_over_epochs(tiny_world, monkeypatch):  # noqa: F811
    """Both loops from the same ``.pt`` for three whole epochs (9 steps
    over the shuffled train windows, the cosine schedule moving, and each
    epoch's valid phase of 3 sequences): every training step's loss, every
    valid sequence's loss and the last valid phase's predictions."""
    tmp_path, cfg_path = tiny_world
    paths = _cross_check_cfgs(tmp_path, cfg_path,
                              ("training_epochs: 1", "training_epochs: 3"),
                              ("shuffle: false", "shuffle: true"))
    rec, jrec, model = _both_loops(paths, monkeypatch)

    losses, jlosses = rec.losses("train"), jrec.losses("train")
    assert len(losses) == len(jlosses) == 9
    diffs = np.abs(np.subtract(losses, jlosses))
    assert (diffs <= EPOCHS_ATOL).all(), diffs
    valid, jvalid = rec.losses("valid"), jrec.losses("valid")
    assert len(valid) == len(jvalid) == 9
    assert (np.abs(np.subtract(valid, jvalid)) <= EPOCHS_ATOL).all()
    # the last valid phase's windows: the seeded loader's third draw of
    # each (its generator moves with every item: the point shuffle)
    ds = _seeded_datasets(kitti, paths["port"])["valid"]
    last = [[ds[i] for i in range(3)] for _ in range(3)][-1]
    for frames, pred, jpred in zip(last, rec.preds("valid")[-3:],
                                   jrec.preds("valid")[-3:]):
        differ = pred != jpred
        if differ.any():
            gap = _top_two_gap(model, paths["port"], frames)
            assert (gap[differ] <= TIE).all(), gap[differ]
