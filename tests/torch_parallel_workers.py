"""Rank bodies for ``tests/test_torch_parallel.py``, run by
``parallel.mesh.spawn`` in child processes (spawned children import this
module by name; it imports nothing of JAX, so they start quickly).

Each rank joins a ``gloo`` group on the CPU through a file store, runs on
one intra-op thread (the parent does too, so both sides add in the same
order), and returns numpy data."""

from __future__ import annotations

import numpy as np
import torch

from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig
from temporal_latticenet_tpu_torch.parallel import mesh as pmesh
from temporal_latticenet_tpu_torch.train import engine

# the tiny configuration of tests/test_train.py:99-103
TINY_CFG = dict(nr_classes=5, pointnet_layers=(8, 16),
                pointnet_start_nr_channels=16, nr_downsamples=2,
                nr_blocks_down_stage=(1, 1, 1), nr_blocks_bottleneck=1,
                nr_blocks_up_stage=(1, 1, 1),
                rnn_modules=("gru", "none", "none", "none"), frames_per_seq=2)
TINY_RT = dict(max_points=64, capacity_level0=512, capacity_decay=1.0,
               min_capacity=256, sigma=0.6)
DROPOUT = 0.2
DROPOUT_STEP = 3


def tiny_batch(b: int, seed: int = 0, t: int = 2, n: int = 40, p: int = 64):
    """``tests/test_train.py:_batch`` as numpy: b sequences of t frames of n
    points (padded to p) whose labels depend on the position's octant."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((b, t, p, 3), np.float32)
    val = np.zeros((b, t, p, 1), np.float32)
    lab = np.zeros((b, t, p), np.int32)
    msk = np.zeros((b, t, p), bool)
    for bi in range(b):
        base = rng.normal(size=(n, 3)).astype(np.float32) * 4
        labels = 1 + (base[:, 0] > 0).astype(np.int32) \
            + 2 * (base[:, 1] > 0).astype(np.int32)
        for ti in range(t):
            pos[bi, ti, :n] = base + ti * 0.2
            val[bi, ti, :n] = rng.random((n, 1))
            lab[bi, ti, :n] = labels
            msk[bi, ti, :n] = True
    return pos, val, lab, msk


def trainer(device="cpu", mesh=None, **cfg_kw):
    """The tiny model (seed 0) with its train state and steps."""
    cfg = ModelConfig(**dict(TINY_CFG, **cfg_kw))
    rt = RuntimeConfig(**TINY_RT)
    model, state = engine.create_train_state(cfg, rt, 1e-3, 1e-3,
                                             device=device)
    if mesh is not None:
        pmesh.replicate(mesh, model)
    train_step, eval_step = engine.make_train_step(model, cfg, rt, mesh=mesh)
    return model, state, train_step, eval_step


def host(x):
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def run_streams(model, mesh, frames, incremental: bool):
    """The batched streams over ``frames`` ((T, B, ...) arrays), split over
    ``mesh`` when one is given: the final frame's (logp, logits, aux)."""
    fns = engine.make_streaming_inference_batched(
        model, model.cfg, model.rt, mesh=mesh, incremental=incremental,
        max_new=512)
    if incremental:
        new_fn, step_full, step_fn, final_fn = fns
    else:
        new_fn, step_fn, final_fn = fns
        step_full = step_fn
    pos, val, msk = frames
    carry = new_fn(pos.shape[1])
    for t in range(pos.shape[0] - 1):
        carry = (step_full if t == 0 else step_fn)(pos[t], val[t], msk[t],
                                                   carry)
    logp, sv, _, aux = final_fn(pos[-1], val[-1], msk[-1], carry)
    return host((logp, sv, aux))


def dp_rank(rank: int, world: int, store: str, batch, frames) -> dict:
    """One rank of the data-parallel checks on the tiny model: ``grad_step``
    and one ``train_step`` (the weights after it) on the rank's share of
    ``batch``, ``grad_step`` with dropout, and a fresh model's streams of
    ``frames`` over the ranks on both paths."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(world_size=world, rank=rank, backend="gloo",
                           device="cpu", init_method=f"file://{store}")
    try:
        out = {"group_is_world": mesh.group is torch.distributed.group.WORLD}
        local = pmesh.shard_batch(mesh, engine.SeqBatch(*batch))
        model, state, train_step, _ = trainer(mesh=mesh)
        loss, grads = train_step.grad_step(local)
        out["loss"], out["grads"] = float(loss), host(grads)
        state, logp, metrics = train_step(state, local, 1.0)
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["logp"] = host(logp)
        out["weights"] = host(dict(model.named_parameters()))

        _, _, d_step, _ = trainer(mesh=mesh, dropout_last_layer=DROPOUT)
        loss, grads = d_step.grad_step(local, DROPOUT_STEP)
        out["dropout_loss"], out["dropout_grads"] = float(loss), host(grads)

        fresh = trainer()[0]
        out["streams"] = {inc: run_streams(fresh, mesh, frames, inc)
                          for inc in (False, True)}
        return out
    finally:
        pmesh.close(mesh)


def record_training(cfg_path: str, mesh=None) -> dict:
    """``run_training`` on ``cfg_path`` (on the CPU, or over ``mesh``) with
    the tiny world's datasets cut as ``tests/test_loop.py:_patch_lengths``
    cuts them: the (phase, loss) of every sequence the process saw, the
    step count, and the weights."""
    from temporal_latticenet_tpu_torch import config
    from temporal_latticenet_tpu_torch.train import loop

    seen = []
    base = loop.StateCallback

    class Recording(base):
        def after_forward_pass(self, *, phase=None, **kw):
            seen.append((phase.name, float(kw["loss"])))
            super().after_forward_pass(phase=phase, **kw)

    parser = config.cfgParser(cfg_path)
    cfg = config.model_config_from_cfg(parser,
                                       config.nr_classes_from_cfg(parser))
    datasets = loop.make_datasets(parser, cfg,
                                  config.runtime_config_from_cfg(parser))
    for ds in datasets.values():
        ds.dataset_lengths = [6]
        ds.dataset_size = min(ds.dataset_size, 3)
    loop.StateCallback = Recording
    try:
        model, state = loop.run_training(
            cfg_path, datasets=datasets, mesh=mesh,
            device="cpu" if mesh is None else None)
    finally:
        loop.StateCallback = base
    return dict(seen=seen, step=state.step,
                weights=host(dict(model.named_parameters())))


def loop_rank(rank: int, world: int, store: str, cfg_paths) -> dict:
    """:func:`record_training` over the ranks, rank r on ``cfg_paths[r]``
    (cfgs that differ only in their checkpoint path, so that what each
    rank writes shows)."""
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(world_size=world, rank=rank, backend="gloo",
                           device="cpu", init_method=f"file://{store}")
    try:
        return record_training(cfg_paths[rank], mesh)
    finally:
        pmesh.close(mesh)


def bench_streaming_tiny() -> None:
    """``bench_streaming.run`` at the tiny sizes with two streams, for
    ``torchrun``: with a world of two ranks the streams go over them."""
    from temporal_latticenet_tpu_torch import bench_streaming

    torch.set_num_threads(1)
    cfg = ModelConfig(**dict(TINY_CFG, frames_per_seq=4))
    bench_streaming.run(RuntimeConfig(**TINY_RT), cfg, iters=1, streams=2,
                        device="cpu")


if __name__ == "__main__":
    bench_streaming_tiny()
