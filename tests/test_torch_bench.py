"""The port's three benchmark drivers (``temporal_latticenet_tpu_torch.bench``,
``train_bench``, ``bench_streaming``) on the CPU at a tiny geometry: each
result line carries exactly the keys of its JAX script (read from the
script's source, which is not run), ``bench``'s details hold what
``bench.py`` derives for the same flags, its budget guard ends the process
by itself, and without CUDA and ``--cpu`` every driver raises.

Torch runs on one intra-op thread; nothing of JAX is compiled.
"""

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from temporal_latticenet_tpu.config import RuntimeConfig as JRuntimeConfig
from temporal_latticenet_tpu.data.lidar_like import \
    lidar_sequence as j_lidar_sequence
from temporal_latticenet_tpu_torch import bench, bench_streaming, train_bench
from temporal_latticenet_tpu_torch.config import ModelConfig, RuntimeConfig

ROOT = Path(__file__).resolve().parents[1]
# tests/test_bench_smoke.py's tiny flags
TINY_ARGV = ["--points", "200", "--max-points", "256", "--capacity", "2048",
             "--frames", "2", "--iters", "1"]
TINY_CFG = dict(nr_classes=26, pointnet_layers=(8, 16),
                pointnet_start_nr_channels=16, nr_blocks_down_stage=(1, 1, 1),
                nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1, 1))
TINY_RT = dict(max_points=256, capacity_level0=4096, capacity_decay=0.5,
               min_capacity=2048, sigma=0.6)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dict_keys(script: str, marker: str) -> set:
    """The string keys of the dict literal in ``script`` that has the key
    ``marker``."""
    tree = ast.parse((ROOT / script).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys
                    if isinstance(k, ast.Constant)}
            if marker in keys:
                return keys
    raise AssertionError(f"no dict with {marker!r} in {script}")


def _json_lines(out: str):
    return [json.loads(s) for s in out.strip().splitlines()
            if s.startswith("{")]


def test_bench_main_tiny(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    bench.main(TINY_ARGV + ["--cpu"])
    result = _json_lines(capsys.readouterr().out)[-1]
    assert set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert set(result) == _dict_keys("bench.py", "vs_baseline")
    assert result["metric"] == "semantickitti_4frame_seq_inference"
    assert result["unit"] == "points/sec/chip"
    assert result["value"] > 0
    details = json.loads((tmp_path / bench.DETAILS_FILE).read_text())
    assert not (tmp_path / "bench_details.json").exists()

    # what bench.py derives for the same flags
    jrt = JRuntimeConfig(max_points=256, capacity_level0=2048,
                         capacity_decay=0.5, min_capacity=8192, sigma=0.6,
                         trim_capacity_level0=36864,
                         final_capacity_level0=40960)
    *_, m = j_lidar_sequence(np.random.default_rng(0), frames=2,
                             max_points=256, n_az=max(256, 200 // 64))
    assert details["capacities"] == list(jrt.capacities(2))
    assert details["trim_capacities"] == list(jrt.trim_capacities(2))
    assert details["final_capacities"] == list(jrt.final_capacities(2))
    assert details["points_per_frame"] == int(m.sum(1).mean())
    assert details["frames"] == 2
    assert details["reps"] == 3 and details["iters"] == 1
    reps = details["seconds_per_sequence_reps"]
    assert details["seconds_per_sequence_min"] == min(reps)
    assert details["seconds_per_sequence_max"] == max(reps)
    assert details["seconds_per_sequence"] == float(np.median(reps))
    assert result["value"] == round(
        2 * details["points_per_frame"] / details["seconds_per_sequence"], 1)
    assert not details["saturated"] and not details["trim_overflowed"]
    assert details["backend"] == "cpu" and details["card"] is None
    assert details["torch"] == torch.__version__


def test_bench_budget_guard_never_hangs(tmp_path):
    """With a budget of 1 s the process ends by itself: rc 0 with a
    headline line, or rc 3 when nothing was measured yet."""
    env = dict(os.environ, TLN_BENCH_BUDGET_S="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "temporal_latticenet_tpu_torch.bench",
         "--cpu"] + TINY_ARGV,
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=240)
    took = time.time() - t0
    assert proc.returncode in (0, 3), (proc.returncode, proc.stderr[-500:])
    if proc.returncode == 0:
        result = _json_lines(proc.stdout)[-1]
        assert result["unit"] == "points/sec/chip"
    assert took < 200, took


@pytest.mark.parametrize("remat,packed", [("selective", False),
                                          ("none", True)])
def test_train_bench_run_tiny(remat, packed, monkeypatch, capsys):
    if packed:
        monkeypatch.setenv("TLN_MAXSCAN_PACKED", "1")
    else:
        monkeypatch.delenv("TLN_MAXSCAN_PACKED", raising=False)
    rt = RuntimeConfig(**TINY_RT, remat_mode=remat)
    cfg = ModelConfig(**TINY_CFG, frames_per_seq=2)
    train_bench.run(rt, cfg, points=200, iters=1, device="cpu")
    *_, details, result = _json_lines(capsys.readouterr().out)
    assert set(result) == _dict_keys("scripts/train_bench.py",
                                     "seconds_per_step_synced")
    assert result["metric"] == "semantickitti_2frame_train_step"
    assert result["remat"] == remat
    assert result["value"] == round(2 * 200 / result["seconds_per_step"], 1)
    assert not result["vertex_overflow"]
    details = details["details"]
    assert details["pointnet_max_route"].startswith("K5" if packed else "K4")
    assert set(details["launches_per_step"]) == set(
        bench._cuda.LAUNCHES)


def test_bench_streaming_run_two_streams(capsys):
    rt = RuntimeConfig(**TINY_RT)
    cfg = ModelConfig(**TINY_CFG, frames_per_seq=4)
    bench_streaming.run(rt, cfg, iters=1, streams=2, device="cpu")
    result = _json_lines(capsys.readouterr().out)[-1]
    want = (_dict_keys("scripts/bench_streaming.py", "note")
            | _dict_keys("scripts/bench_streaming.py", "mesh_devices"))
    assert set(result) == want
    assert result["streams"] == 2 and result["mesh_devices"] == 1
    assert all(result[k] > 0 for k in want if k.endswith("_ms"))


@pytest.mark.parametrize("driver,argv", [
    (bench, TINY_ARGV),
    (train_bench, ["--iters", "1"]),
    (bench_streaming, ["--iters", "1"]),
])
def test_drivers_need_cuda_unless_cpu(driver, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        driver.main(argv)


def test_chip_smoke_holds_the_jax_scripts_keys():
    """``chip_smoke.py`` phase 20 checks the drivers' lines against key
    lists of its own (it reads nothing of the JAX side): they are the JAX
    scripts' keys."""
    import chip_smoke

    assert set(chip_smoke.BENCH_KEYS) == _dict_keys("bench.py",
                                                    "vs_baseline")
    assert set(chip_smoke.TRAIN_BENCH_KEYS) == _dict_keys(
        "scripts/train_bench.py", "seconds_per_step_synced")
    assert set(chip_smoke.STREAMING_KEYS) == _dict_keys(
        "scripts/bench_streaming.py", "note")
    assert set(chip_smoke.STREAMS_KEYS) == _dict_keys(
        "scripts/bench_streaming.py", "mesh_devices")
