"""Run-to-run determinism of the PyTorch port's float32 sums on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_cpu_determinism.py [threads ...]

Prints, for each torch thread count given (default 8 1 2 4 8 1):

* whether ``index_add_`` and ``index_put_(accumulate=True)`` on random
  float32 rows equal the sequential left fold in row order, and whether
  five ``index_put_`` calls give the same bits;
* the smallest cosine between the flagship training step's gradients with
  full and with no rematerialisation, and between full remat's gradients
  and those of the first thread count's run (the inputs and JAX weights of
  ``tests/test_torch_train.py``).
"""

import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

jax.config.update("jax_platforms", "cpu")

from temporal_latticenet_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig  # noqa: E402
from temporal_latticenet_tpu.data.lidar_like import lidar_sequence  # noqa: E402
from temporal_latticenet_tpu.models import LNNSeq as JLNNSeq  # noqa: E402
from temporal_latticenet_tpu.models import init_state as j_init_state  # noqa: E402
from temporal_latticenet_tpu_torch.train import engine  # noqa: E402
from tests.test_torch_train import P, _cosine, _port  # noqa: E402


def sums(threads: int) -> str:
    torch.set_num_threads(threads)
    g = torch.Generator().manual_seed(0)
    n, s, c = 200_000, 50, 4
    idx = torch.randint(0, s, (n,), generator=g)
    x = torch.randn(n, c, generator=g) * torch.exp(
        torch.randn(n, 1, generator=g) * 3)
    fold = np.zeros((s, c), np.float32)
    for i, row in zip(idx.numpy(), x.numpy()):
        fold[i] += row
    add = torch.zeros(s, c).index_add_(0, idx, x)
    put = [torch.zeros(s, c).index_put_((idx,), x, accumulate=True)
           for _ in range(5)]
    return (f"index_add_ == fold {np.array_equal(add.numpy(), fold)}, "
            f"index_put_ == fold {np.array_equal(put[0].numpy(), fold)}, "
            f"index_put_ repeats {all(torch.equal(put[0], p) for p in put)}")


def jax_params():
    cfg = JModelConfig()
    tiny = JRuntimeConfig(max_points=64, capacity_level0=256,
                          capacity_decay=0.5, min_capacity=64, sigma=0.6)
    p = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    var = jax.jit(lambda k, p_, v_, m_, s: JLNNSeq(cfg, tiny).init(
        k, p_, v_, m_, s, final=True))(
        jax.random.PRNGKey(0), jnp.asarray(p * 5), jnp.ones((64, 1)),
        jnp.ones((64,), bool), j_init_state(cfg, tiny))
    return jax.tree_util.tree_map(np.asarray, var["params"])


def main(argv):
    counts = [int(a) for a in argv] or [8, 1, 2, 4, 8, 1]
    jparams = jax_params()
    pos, val, lab, mask = lidar_sequence(np.random.default_rng(0), frames=4,
                                         max_points=P, n_az=P // 64)
    batch = engine.SeqBatch(*(a[None] for a in (pos, val, lab, mask)))
    first = None
    for n in counts:
        t0 = time.perf_counter()
        line = sums(n)
        _, _, full, _ = _port(jparams, "full")
        _, _, none, _ = _port(jparams, "none")
        _, g_full = full.grad_step(batch)
        _, g_none = none.grad_step(batch)
        first = first or g_full
        cos = min(_cosine(g_full[k].numpy(), g_none[k].numpy())
                  for k in g_full)
        rep = min(_cosine(g_full[k].numpy(), first[k].numpy())
                  for k in g_full)
        print(f"threads {n}: {line}; min cosine none vs full {cos:.9f}, "
              f"full vs the first run {rep:.9f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
