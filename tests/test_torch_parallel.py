"""Batches of several sequences and data parallelism in the PyTorch port,
on the CPU at the tiny configuration of ``tests/test_train.py:99-103``
(gru/none/none/none, 2 frames, 64 points).

* B = 2 ``grad_step`` against the JAX package's b = 2 (its vmapped mean),
  from the same numpy batch and JAX weights, within the tolerances of
  ``tests/test_torch_train.py`` (loss 1e-2, every gradient's cosine 0.99,
  global norm 2 %).
* B = 2 against the port's own two B = 1 steps in float32: bit for bit,
  since the per-sequence backward of ``loss / 2`` scales every cotangent
  by a power of two.
* Two ``gloo`` ranks on the CPU (children spawned by
  ``parallel.mesh.spawn``, a file store, one thread each) against one
  process with the whole batch: losses within 1e-6 relative, gradients
  within 1e-6 of each parameter's largest magnitude, weights after one
  AdamW step equal across ranks and within 5e-5 of the one process's
  (JAX's own bound, ``tests/test_train.py:146-148``); dropout 0.2 draws
  the masks of the sequences' global indices; the streams over the ranks
  equal the single process's batched streams bit for bit.  Measured: every
  one of these bit-equal.
* ``run_training`` with ``batch_size: 2`` in one process and over two
  ranks: the same losses, and only rank 0 writes.

Every child join is bounded (``spawn``'s timeout), and a hung collective
fails within ``mesh.COLLECTIVE_TIMEOUT``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.train import engine as jengine
from temporal_latticenet_tpu_torch.config import ModelConfig
from temporal_latticenet_tpu_torch.parallel import mesh as pmesh
from temporal_latticenet_tpu_torch.train import engine
from temporal_latticenet_tpu_torch.train.convert import params_from_jax
from tests import torch_parallel_workers as w
from tests.test_loop import tiny_world  # noqa: F401  (fixture)

LOSS_ATOL, GRAD_COSINE, NORM_RTOL = 1e-2, 0.99, 0.02   # test_torch_train.py
DP_LOSS_RTOL = 1e-6
DP_GRAD_REL = 1e-6
DP_WEIGHT_ATOL = 5e-5
SPAWN_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as in the ranks: the same adds in the same
    order on both sides."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    return float(a @ b / (na * nb))


def _close_grads(got, want):
    for name, g in want.items():
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-12)
        diff = np.abs(np.asarray(got[name]) - g).max()
        assert diff <= DP_GRAD_REL * scale, name


def test_b2_grad_step_matches_jax():
    batch = w.tiny_batch(2)
    jcfg = JModelConfig(**w.TINY_CFG)
    jrt = JRuntimeConfig(**w.TINY_RT)
    jmodel, jstate, tx = jengine.create_train_state(jcfg, jrt, 1e-3, 1e-3)
    jstep, _ = jengine.make_train_step(jmodel, jcfg, jrt, tx)
    jloss, jgrads = jstep.grad_step(
        jstate.params, jengine.SeqBatch(*(jnp.asarray(a) for a in batch)),
        jstate.step)
    jparams = jax.tree_util.tree_map(np.asarray, jstate.params["params"])
    cfg = ModelConfig(**w.TINY_CFG)
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jgrads["params"]), cfg)

    model, _, train_step, _ = w.trainer()
    model.load_state_dict(params_from_jax(jparams, cfg), strict=True)
    loss, grads = train_step.grad_step(engine.SeqBatch(*batch))
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert _cosine(g.numpy(), want[name].numpy()) >= GRAD_COSINE, name
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    jnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want.values()))
    assert abs(norm - jnorm) <= NORM_RTOL * jnorm


def test_b2_equals_the_mean_of_two_b1_steps_float32():
    """Loss, gradients and metrics of a batch of two against each sequence
    alone; eval and train steps return (2, P, K) log-probabilities."""
    batch = w.tiny_batch(2)
    _, state, train_step, eval_step = w.trainer(compute_dtype="float32")
    loss2, g2 = train_step.grad_step(engine.SeqBatch(*batch))
    g2 = {k: v.clone() for k, v in g2.items()}
    ones, evals = [], []
    for i in range(2):
        one = engine.SeqBatch(*(a[i:i + 1] for a in batch))
        loss, g = train_step.grad_step(one)
        ones.append((float(loss), {k: v.clone() for k, v in g.items()}))
        evals.append(eval_step(one))
    assert float(loss2) == np.float32(ones[0][0] + ones[1][0]) / 2
    for k in g2:
        assert torch.equal(g2[k], ones[0][1][k] / 2 + ones[1][1][k] / 2), k
    logp, m = eval_step(engine.SeqBatch(*batch))
    assert logp.shape == (2, 64, 5)
    assert torch.equal(logp, torch.cat([e[0] for e in evals]))
    assert int(m["nr_vertices"]) == max(int(e[1]["nr_vertices"])
                                        for e in evals)
    state, logp, m = train_step(state, engine.SeqBatch(*batch), 1.0)
    assert logp.shape == (2, 64, 5) and state.step == 1
    assert float(m["loss"]) == float(loss2)
    assert sorted(m) == ["grad_norm", "loss", "lovasz", "nll", "nr_vertices",
                         "vertex_overflow"]


def test_dropout_generators_by_global_index():
    """Index 0 draws the mask a batch of one drew before batches existed;
    other indices draw other masks, and the same ones in every call."""
    draw = [torch.rand(64, generator=engine.dropout_generator("cpu", 5, i))
            for i in (0, 1, 1)]
    old = torch.Generator().manual_seed((engine.DROPOUT_SEED << 32) + 5)
    assert torch.equal(draw[0], torch.rand(64, generator=old))
    assert torch.equal(draw[1], draw[2])
    assert not torch.equal(draw[0], draw[1])


def test_shard_batch_and_mesh_types():
    mesh = pmesh.Mesh(rank=1, world_size=2, device=torch.device("cpu"),
                      group=None)
    batch = engine.SeqBatch(*w.tiny_batch(4))
    part = pmesh.shard_batch(mesh, batch)
    assert isinstance(part, engine.SeqBatch)
    for a, b in zip(part, batch):
        np.testing.assert_array_equal(a.numpy(), b[2:4])
    with pytest.raises(ValueError, match="3 sequences"):
        pmesh.shard_batch(mesh, engine.SeqBatch(*w.tiny_batch(3)))
    model, _, _, _ = w.trainer()
    with pytest.raises(TypeError):
        engine.make_train_step(model, model.cfg, model.rt, mesh=object())
    with pytest.raises(TypeError):
        engine.make_streaming_inference_batched(model, model.cfg, model.rt,
                                                mesh=object())


def test_make_mesh_never_falls_back(monkeypatch):
    """Ranks on the CPU need gloo by name; CUDA asked for and absent
    raises: nothing is moved to the CPU or to gloo on its own."""
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="gloo"):
            pmesh.make_mesh(world_size=2, rank=0, backend=backend,
                            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(world_size=2, rank=0)


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------

def _stream_frames():
    pos, val, _, msk = w.tiny_batch(4, seed=1)
    return tuple(np.ascontiguousarray(a.swapaxes(0, 1))
                 for a in (pos, val, msk))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    batch, frames = w.tiny_batch(2), _stream_frames()
    store = tmp_path_factory.mktemp("dp") / "store"
    ranks = pmesh.spawn(w.dp_rank, 2, (str(store), batch, frames),
                        timeout=SPAWN_TIMEOUT)

    _, state, train_step, _ = w.trainer()
    whole = engine.SeqBatch(*batch)
    loss, grads = train_step.grad_step(whole)
    one = dict(loss=float(loss), grads=w.host(grads))
    model, state, train_step, _ = w.trainer()
    state, logp, metrics = train_step(state, whole, 1.0)
    one["metrics"] = {k: float(v) for k, v in metrics.items()}
    one["logp"] = w.host(logp)
    one["weights"] = w.host(dict(model.named_parameters()))
    _, _, d_step, _ = w.trainer(dropout_last_layer=w.DROPOUT)
    loss, grads = d_step.grad_step(whole, w.DROPOUT_STEP)
    one["dropout_loss"], one["dropout_grads"] = float(loss), w.host(grads)
    fresh = w.trainer()[0]
    one["streams"] = {inc: w.run_streams(fresh, None, frames, inc)
                      for inc in (False, True)}
    return ranks, one


def test_two_ranks_grad_step_matches_one_process(two_ranks):
    ranks, one = two_ranks
    for r in ranks:
        assert r["group_is_world"]
        assert r["loss"] == pytest.approx(one["loss"], rel=DP_LOSS_RTOL)
        _close_grads(r["grads"], one["grads"])


def test_two_ranks_train_step_matches_one_process(two_ranks):
    """Metrics reduced to the global batch, the rank's own log-probabilities,
    and weights equal across the ranks after the AdamW step."""
    ranks, one = two_ranks
    for key in ("loss", "lovasz", "nll", "grad_norm"):
        for r in ranks:
            assert r["metrics"][key] == pytest.approx(one["metrics"][key],
                                                      rel=DP_LOSS_RTOL), key
    for key in ("nr_vertices", "vertex_overflow"):
        assert [r["metrics"][key] for r in ranks] == [one["metrics"][key]] * 2
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["logp"], one["logp"][i:i + 1])
    for name, v in one["weights"].items():
        np.testing.assert_array_equal(ranks[0]["weights"][name],
                                      ranks[1]["weights"][name])
        np.testing.assert_allclose(ranks[0]["weights"][name], v, rtol=0,
                                   atol=DP_WEIGHT_ATOL, err_msg=name)


def test_two_ranks_dropout_matches_one_process(two_ranks):
    """Dropout 0.2: each rank's sequence draws the mask of its global index,
    so the gradients are the one process's."""
    ranks, one = two_ranks
    for r in ranks:
        assert r["dropout_loss"] == pytest.approx(one["dropout_loss"],
                                                  rel=DP_LOSS_RTOL)
        _close_grads(r["dropout_grads"], one["dropout_grads"])
    assert one["dropout_loss"] != one["loss"]


@pytest.mark.parametrize("incremental", [False, True])
def test_streams_over_two_ranks_match_one_process(two_ranks, incremental):
    """4 streams, 2 a rank: every rank gathers all 4 streams' final frames,
    bit-equal to one process stepping all 4."""
    ranks, one = two_ranks
    logp, sv, aux = one["streams"][incremental]
    assert logp.shape == (4, 64, 5)
    for r in ranks:
        got = r["streams"][incremental]
        np.testing.assert_array_equal(got[0], logp)
        np.testing.assert_array_equal(got[1], sv)
        assert sorted(got[2]) == sorted(aux)
        for k, v in aux.items():
            assert got[2][k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[2][k], v, err_msg=k)


def test_run_training_batch_size_two_over_ranks(tiny_world,  # noqa: F811
                                                 tmp_path):
    """``batch_size: 2`` over 2 epochs with the shuffle on: one process
    with both sequences of a step against two ranks with one each.  The
    steps' losses and the valid losses are the same, the weights equal,
    and only rank 0 writes checkpoints and the IoU CSV."""
    world, cfg_path = tiny_world
    text = open(cfg_path).read()
    for a, b in (("batch_size: 1", "batch_size: 2"),
                 ("training_epochs: 1", "training_epochs: 2"),
                 ("shuffle: false", "shuffle: true")):
        assert a in text
        text = text.replace(a, b)
    paths = []
    for name in ("one", "rank0", "rank1"):
        p = tmp_path / f"{name}.cfg"
        p.write_text(text.replace(str(world / "ckpts"), str(tmp_path / name)))
        paths.append(str(p))
    one = w.record_training(paths[0])
    ranks = pmesh.spawn(w.loop_rank, 2, (str(tmp_path / "store"), paths[1:]),
                        timeout=SPAWN_TIMEOUT)
    assert one["step"] == 2 and [r["step"] for r in ranks] == [2, 2]

    def per_step(seen, phase, group):
        losses = [loss for name, loss in seen if name == phase]
        return losses[::group]
    assert per_step(one["seen"], "train", 2) == pytest.approx(
        per_step(ranks[0]["seen"], "train", 1), rel=DP_LOSS_RTOL)
    assert len(per_step(one["seen"], "train", 2)) == 2
    for r in ranks:
        assert per_step(r["seen"], "valid", 1) == pytest.approx(
            per_step(one["seen"], "valid", 1), rel=DP_LOSS_RTOL)
    for name, v in one["weights"].items():
        np.testing.assert_array_equal(ranks[0]["weights"][name],
                                      ranks[1]["weights"][name])
        np.testing.assert_allclose(ranks[0]["weights"][name], v, rtol=0,
                                   atol=DP_WEIGHT_ATOL, err_msg=name)
    def files(d):
        """The names written, without the checkpoint names' date and time
        (``train/checkpoint.checkpoint_name``'s first two fields)."""
        return sorted(p.name.split("_", 2)[2] for p in d.iterdir())
    written = files(tmp_path / "rank0")
    assert files(tmp_path / "one") == written
    assert any(n.endswith("_epoch1.ckpt") for n in written)
    assert any(n.endswith("_epoch1.csv") for n in written)
    assert not (tmp_path / "rank1").exists()



def test_train_ln_under_torchrun(tiny_world):  # noqa: F811
    """The CLI as a user runs it: ``torchrun`` with two ranks on the CPU
    (``--dist-backend gloo``) makes the mesh from its environment; rank 0
    alone saves the epoch checkpoint."""
    import os
    import subprocess
    import sys

    world, cfg_path = tiny_world
    text = open(cfg_path).read().replace("batch_size: 1", "batch_size: 2")
    cfg = world / "torchrun.cfg"
    cfg.write_text(text)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "temporal_latticenet_tpu_torch.train_ln",
         "--config", str(cfg), "--device", "cpu", "--dist-backend", "gloo"],
        capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT,
        cwd=str(world))
    assert run.returncode == 0, run.stderr[-3000:]
    assert "data parallel: 2 sequences/step over 2 ranks" in run.stdout
    assert run.stdout.count("saved checkpoint:") == 1
    assert any(c.endswith("_epoch0.ckpt") for c in os.listdir(world / "ckpts"))


def test_bench_streaming_streams_over_torchrun_ranks():
    """``bench_streaming`` under ``torchrun`` with two ranks on the CPU
    splits its two streams over them (``mesh_devices`` 2) and prints its
    line once, from rank 0."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2",
         os.path.join(repo, "tests", "torch_parallel_workers.py")],
        capture_output=True, text=True, env=env, timeout=SPAWN_TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = [json.loads(s) for s in run.stdout.splitlines()
             if s.startswith("{")]
    assert len(lines) == 1, run.stdout
    assert lines[0]["streams"] == 2 and lines[0]["mesh_devices"] == 2
    assert lines[0]["streams_final_frame_ms"] > 0
