"""Data parallelism over ``torch.distributed`` (the PyTorch counterpart of
the JAX package's ``parallel/mesh.py``).

The JAX package shards whole sequences over a 1-D ``dp`` mesh of the
devices of one process.  Here each rank is a process with one device:
whole sequences are split over the ranks (``shard_batch``), parameters
are copied from rank 0 (``replicate``), and the training step sums the
ranks' gradients in one all-reduce over a single flat buffer
(``all_reduce_mean``) before every rank takes the same AdamW step, so the
weights stay equal across ranks.

``make_mesh`` reads ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) or its arguments.  Ranks run on
CUDA, one card each over NCCL, unless the caller asks for ``gloo`` (ranks
on the CPU, or ranks that share a card, which NCCL refuses); more ranks
than cards without ``gloo`` raise, and nothing falls back on its own.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from ..device import resolve_device

# every collective fails after this long, so that a rank that died or hung
# stops the others (NCCL's own default is ten minutes)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device
    group: Any          # the process group ``make_mesh`` initialised


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def make_mesh(world_size: int | None = None, rank: int | None = None,
              backend: str | None = None, device=None,
              init_method: str | None = None) -> Mesh:
    """Initialise the process group and return this rank's ``Mesh``.

    ``world_size`` and ``rank`` default to ``torchrun``'s ``WORLD_SIZE`` and
    ``RANK``; ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``).  The device is ``cuda:{LOCAL_RANK % device_count}``
    unless ``device`` is ``"cpu"``.  ``backend`` defaults to ``nccl``, which
    needs a card per rank on this host; ``gloo`` must be asked for by name
    (ranks on the CPU, or ranks that share a card)."""
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else int(world_size)
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", _env_int("LOCAL_RANK", rank) % cards)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
        local = _env_int("LOCAL_WORLD_SIZE", world_size)
        if backend == "nccl" and local > cards:
            raise RuntimeError(
                f"{local} ranks on {cards} card(s): NCCL refuses two ranks "
                f"on one card; pass backend='gloo' for ranks that share one")
    elif backend != "gloo":
        raise ValueError(f"ranks on the {dev.type} need backend='gloo', got "
                         f"{backend!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=COLLECTIVE_TIMEOUT)
    return Mesh(rank=rank, world_size=world_size, device=dev,
                group=dist.group.WORLD)


def close(mesh: Mesh) -> None:
    """Leave the process group."""
    dist.destroy_process_group(mesh.group)


def shard_batch(mesh: Mesh, batch):
    """The rank's contiguous ``B / world_size`` whole sequences of a batch
    (a ``SeqBatch`` or any tuple of (B, ...) arrays), on its device.  B
    must be a multiple of the world size, as the JAX package's
    ``NamedSharding(P("dp"))`` requires."""
    b = batch[0].shape[0]
    if b % mesh.world_size:
        raise ValueError(f"a batch of {b} sequences does not split over "
                         f"{mesh.world_size} ranks")
    per = b // mesh.world_size
    lo = mesh.rank * per
    return type(batch)(*(torch.as_tensor(a[lo:lo + per], device=mesh.device)
                         for a in batch))


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Copy rank 0's parameters and buffers to every rank, in place."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=mesh.group)
    return module


def all_reduce_mean(mesh: Mesh, tensors) -> None:
    """Replace each tensor by its mean over the ranks, in place, with one
    all-reduce (SUM, then a division by the world size) over a single flat
    buffer of them all."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world_size
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_reduce_max(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks (booleans as any)."""
    x = tensor.to(torch.int64) if tensor.dtype == torch.bool \
        else tensor.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x.bool() if tensor.dtype == torch.bool else x


def all_gather(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """The ranks' tensors of one shape, concatenated along the first axis
    in rank order."""
    x = tensor.to(torch.uint8) if tensor.dtype == torch.bool \
        else tensor.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts)
    return out.bool() if tensor.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# ranks as child processes of one parent
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, args, results):
    try:
        results.put((rank, True, fn(rank, world_size, *args)))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, args=(), timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` child processes
    (start method ``spawn``) and return their results in rank order.  ``fn``
    must be importable by name and return picklable host data.

    A rank that raises, or a run that outlasts ``timeout`` seconds (a hung
    collective), terminates every child and raises in the caller."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, error = {}, None
    try:
        while len(out) < world_size and error is None:
            left = deadline - time.monotonic()
            try:
                rank, ok, value = results.get(timeout=max(left, 0.0))
            except queue.Empty:
                error = f"ranks {sorted(set(range(world_size)) - set(out))} "\
                        f"gave no result within {timeout} s"
                break
            if ok:
                out[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0)
                   if error is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    return [out[r] for r in range(world_size)]
