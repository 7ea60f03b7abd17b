"""The yardstick's arithmetic on the CPU: the FLOP count against
``torch.utils.flop_counter.FlopCounterMode`` on the reference, the frozen
scan generator against the port's, and the saturation check."""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import lidar_like as frozen
from harness.core import Context, RunError, level_rows
from harness.traffic import make_pool
from metrics.flops import sequence_flops
from reference import engine as ref
from reference.config import ModelConfig, RuntimeConfig


@pytest.mark.parametrize("config", ["kitti_gru_aflow_f4", "kitti_gru4_f3"])
def test_flops_match_flop_counter(config):
    with open(os.path.join(tiny.BENCH, "configs", f"{config}.json")) as f:
        m = dict(json.load(f)["model"], compute_dtype="float32")
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in m.items()})
    rt = RuntimeConfig(max_points=1024, capacity_level0=8192,
                       capacity_decay=0.5, min_capacity=2048, sigma=0.6)
    t = cfg.frames_per_seq
    p, v, _, mk = frozen.lidar_sequence(np.random.default_rng(1), frames=t,
                                        max_points=1024, n_beams=32, n_az=32)
    model = ref.build_model(cfg, rt, ref.LNNSeq(cfg, rt).state_dict(), "cpu")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        ref.forward(model, cfg, rt, *(torch.as_tensor(a) for a in (p, v, mk)))
    # the products run over every padded row: capacities and 1,024 points
    assert sequence_flops(m, [rt.capacities(2)] * t, [1024] * t) \
        == fc.get_total_flops()


def test_frozen_generator_is_the_ports():
    from temporal_latticenet_tpu_torch.data import lidar_like as port
    for kw in ({}, {"moving_cars": 3, "moving_peds": 2}):
        a = frozen.lidar_sequence(np.random.default_rng(9), frames=3,
                                  max_points=2048, n_beams=16, n_az=128, **kw)
        b = port.lidar_sequence(np.random.default_rng(9), frames=3,
                                max_points=2048, n_beams=16, n_az=128, **kw)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_pool_fixes_the_work_and_follows_the_world_seed():
    gen = {"n_beams": 16, "n_az": 64, "points_per_frame": 800,
           "scan_motion_m": 0.9, "world_seed": 2**31 + 17}
    a = make_pool(gen, 2, 3, 1024, 3)
    b = make_pool(gen, 2, 3, 1024, 3)
    c = make_pool(dict(gen, world_seed=2**31 + 18), 2, 3, 1024, 3)
    d = make_pool(gen, 2, 3, 1024, 1)
    assert (a[3].sum(axis=2) == 800).all()
    assert all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
    assert a[0].tobytes() != c[0].tobytes()
    # frames cloud_scope scans apart: the sensor moves 3 x 0.9 m a frame
    assert a[0].tobytes() != d[0].tobytes()


def test_run_seed_orders_the_same_pool():
    _, config, traffic, _ = tiny.cell("flagship.offline")
    ctxs = [Context(tiny.BENCH, "flagship.offline", config, traffic, s,
                    torch.device("cpu")) for s in (2**31 + 5, 2**31 + 6)]
    for ctx in ctxs:
        ctx.make_inputs()
    assert torch.equal(ctxs[0].pos, ctxs[1].pos)
    assert sorted(ctxs[0].order) == sorted(ctxs[1].order)


def test_saturated_table_fails_the_run():
    _, config, traffic, _ = tiny.cell("flagship.offline")
    config["runtime"].update(capacity_level0=2048, min_capacity=512)
    ctx = Context(tiny.BENCH, "flagship.offline", config, traffic, 3,
                  torch.device("cpu"))
    ctx.make_inputs()
    with pytest.raises(RunError, match="saturates"):
        level_rows(ctx)
