"""chip_smoke.py's main path 8 (the generic engine's walk through the
facades: the driver entry's forward, trace_hitcounts_sph,
trace_cumulative_sph and trace_sph(engine="xla") on path 1's scene, and
render_triangles(engine="xla") on the torus) run on the CPU at a small
size, every gate included: on CPU tensors the facades run the plain walk
(engine.trace), so no launch is counted and the plain walk's call count
moves. On the card the path runs on the bench scene and the 262,144-
triangle torus, where the walk is csrc/bvh_walk.cu and engine.trace is
never entered."""

import numpy as np
import torch

import chip_smoke
from tests.helper.torch_parity import one_torch_thread  # noqa: F401


def test_engine_path_small_on_the_cpu():
    dev = torch.device("cpu")
    particles = chip_smoke.make_clustered_particles(np.random.default_rng(2026), 3000)
    scene = chip_smoke.bench_scene(torch.from_numpy(particles), 128)
    tris = torch.from_numpy(chip_smoke.torus_mesh(24, 12))
    out = chip_smoke.engine_path(dev, scene, tris, chip_smoke.entry_inputs(dev), 32)
    assert out["launches"] == {"bvh_walk_sph": 0, "bvh_walk_tri": 0}
    assert out["plain_calls"] >= 6
    text = "\n".join(out["lines"])
    for expected in ("driver entry vs the plain walk: 1024 rays", "bench scene: 16384 rays",
                     "the same particles as B16's sorted rows", "256 rays (every 64th)",
                     "torus (576 triangles, 32x32): closest ids equal"):
        assert expected in text, expected
