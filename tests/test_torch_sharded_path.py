"""chip_smoke.py's main path 7 (the sharded routes of
``grace_tpu_torch.parallel`` on one rank: the rays-sharded bitmask and
quarter traces, the particle ring with its hoisted masks, the row-sharded
splat, the data-parallel splat step through ``allreduce_sum``, and at
dryrun_multichip's sizes the replicated render, the ring training step and
an undersized capacity) run on the CPU with one gloo rank at a small size,
every gate included: the kernels' plain versions stand in for the CUDA
kernels, so no launch is counted here. On the card the path runs on the
bench scene with one NCCL rank."""

import numpy as np
import torch
import torch.distributed as dist

import chip_smoke
from tests.helper.torch_parity import one_torch_thread  # noqa: F401


def test_sharded_path_small_on_the_cpu():
    particles = chip_smoke.make_clustered_particles(np.random.default_rng(2026), 3000)
    dev = torch.device("cpu")
    scene = chip_smoke.bench_scene(torch.from_numpy(particles).to(dev), 128)
    out = chip_smoke.sharded_path(dev, scene)
    assert out["launches"] == dict.fromkeys(
        ("splat", "trace_quarter", "trace_bitmask", "splat_sortfree_fwd", "splat_sortfree_bwd"), 0)
    assert "times" not in out and not dist.is_initialized()
    text = "\n".join(out["lines"])
    for expected in ("on 16384 rays and 3000 particles: bit-equal to the calls without the mesh",
                     "loss and gradients bit-equal to make_splat_trainer's",
                     "dryrun size (64 particles, 16 rays)", "check_overflow raises"):
        assert expected in text, expected


def test_path7_line_reports_each_route_and_its_collectives():
    times = {"sharded_pallas_render bitmask": (2.0, 1.5, 0.5),
             "sharded_splat_render": (1.0, 1.0, 0.0)}
    line = chip_smoke.path7_line(times, {"splat": 1}, 3.25)
    assert "sharded_pallas_render bitmask 2.000 ms (single-device 1.500 ms; collectives " \
           "0.500 ms, 25.0%)" in line
    assert "collectives 0.000 ms, 0.0%" in line and "3.25 s wall" in line
    assert "launches {'splat': 1}" in line
