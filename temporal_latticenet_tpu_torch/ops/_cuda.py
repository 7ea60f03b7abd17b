"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and bound with ``ctypes``
(pointers from ``data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``).  Libraries are built on first
use into ``build/kernels/`` at the repository root, named by a hash of the
sources and flags, one ``nvcc`` per source, all started together.

``LAUNCHES`` counts, per kernel wrapper, the calls that launched the CUDA
kernel (never the plain PyTorch path).  A call under CUDA-graph capture
records the kernel into the graph and launches nothing, so it is not
counted; a graph's replay launches the kernel without calling the wrapper,
and is not counted either (a profiler trace names the replayed kernels).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# library -> (source file, extra nvcc flags)
SOURCES = {
    # K1 must stay bit-exact with the float32 reference: no FMA contraction
    "fused_simplex": ("fused_simplex.cu", ("--fmad=false",)),
    "seg_scan": ("seg_scan.cu", ()),
    "seg_sum_tails": ("seg_sum_tails.cu", ()),
    "seg_max": ("seg_max.cu", ()),
    "seg_max_window": ("seg_max_window.cu", ()),
    "lattice_conv": ("lattice_conv.cu", ()),
    "lattice_conv_bwd": ("lattice_conv_bwd.cu", ()),
    "masked_gn": ("masked_gn.cu", ()),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"fused_simplex_pack": 0, "sorted_segment_scan": 0,
            "seg_sum_tails": 0, "sorted_segment_max_u32": 0,
            "sorted_segment_max_window": 0, "lattice_conv": 0,
            "masked_gn_relu": 0, "masked_gn_relu_backward": 0,
            "lattice_conv_dx": 0, "lattice_conv_dw": 0}

_libs: dict = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def count_launch(name: str) -> None:
    """Count one launch of wrapper ``name``, unless the current stream is
    capturing a CUDA graph (the call launched nothing)."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    src, flags = SOURCES[name]
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build() -> dict:
    """Compile every library that is not built yet, one ``nvcc`` process
    per source, all running at once.  Returns the wall seconds of the build
    and the names built."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        src, flags = SOURCES[n]
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "built": todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``; builds every missing library on first
    use (together, so one wait covers all kernels)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build()
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.tln_error_string.restype = ctypes.c_char_p
            lib.tln_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def function(lib_name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    lib = library(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaGetLastError()``."""
    if err != 0:
        msg = library(lib_name).tln_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {what} failed: {msg} ({err})")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a card, which grids are sized by."""
    return torch.cuda.get_device_properties(device).multi_processor_count


P = ctypes.c_void_p
I64 = ctypes.c_int64
I32 = ctypes.c_int
F32 = ctypes.c_float
