"""The benchmark of temporal_latticenet_tpu_torch (the PyTorch/CUDA port) on
one NVIDIA H100:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell, its
configuration and traffic mix; ``benchmark/harness/core.py`` says which
file holds each part.  Prints one JSON line last (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checked``: each number compared beside its limit,
also the last lines of standard error).  Without a card, or when a module
of JAX or of the JAX package is loaded, it exits non-zero with no result.
Builds and caches go under ``build/`` in the checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
