"""Inputs of the multi-process parity cases, from numpy seeds only, so that
the worker processes (tests/helper/parallel_worker.py, no JAX) and the
tests that run ``grace_tpu`` on the same inputs draw the same arrays.

Each case mirrors a test of ``tests/integration/test_sharding.py`` (its
line in the comment), ``tests/integration/test_multihost.py`` or
``__graft_entry__.dryrun_multichip``.
"""

import numpy as np

SEED = 1234


def mesh_shape(world: int):
    """The ("rays", "space") mesh of a world: (1, 2) for 2 ranks, (2, 2)
    for 4."""
    return (world // 2, 2)


def setup(rng, n=256, r=64):
    """test_sharding.py's ``setup`` (:21): (spheres f32[n, 4], origins,
    directions, lengths)."""
    xyz = (rng.random((n, 3)) * 1.2 - 0.6).astype(np.float32)
    h = (0.1 + 0.1 * rng.random(n)).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.random((r, 3)) * 0.2 - 0.7).astype(np.float32)
    return (np.concatenate([xyz, h[:, None]], axis=1), o, d, np.full((r,), 4.0, np.float32))


def replicated():        # test_sharding.py:38
    return setup(np.random.default_rng(SEED))


def train():             # :51 and :64
    return setup(np.random.default_rng(SEED + 1), n=128, r=64)


def undersized():        # :81: every ray through the cloud
    rng = np.random.default_rng(SEED + 2)
    xyz = (rng.random((128, 3)) * 0.2 - 0.1).astype(np.float32)
    spheres = np.concatenate([xyz, np.full((128, 1), 0.3, np.float32)], axis=1)
    o = np.tile([[0.0, 0.0, -2.0]], (64, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (64, 1)).astype(np.float32)
    return spheres, o, d, np.full((64,), 6.0, np.float32)


def fast_paths():        # :105, and the splat cases :133, :148
    return setup(np.random.default_rng(SEED + 3), n=256, r=64)


SPLAT_CAMERA = ((0.0, 0.0, -2.0), (0.0, 0.0, 0.0), (0, 1, 0), 2.6, 6.0)


def dryrun(world: int):
    """``dryrun_multichip``'s draws on a (world / 2, 2) mesh: 64 particles
    a space shard, 16 rays a rank, then the splat step's target and
    weights."""
    n_space = mesh_shape(world)[1]
    rng = np.random.default_rng(1)
    n_total, r_total = 64 * n_space, 16 * world
    spheres = np.concatenate([rng.random((n_total, 3)), 0.1 + 0.1 * rng.random((n_total, 1))],
                             axis=1).astype(np.float32)
    d = rng.standard_normal((r_total, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.random((r_total, 3)).astype(np.float32) * 0.2 - 0.6
    lengths = np.full((r_total,), 4.0, np.float32)
    targets = rng.random(r_total).astype(np.float32)
    tgt = rng.random((16, 128)).astype(np.float32)
    wts = (0.5 + rng.random(n_total)).astype(np.float32)
    return dict(spheres=spheres, origins=o, directions=d, lengths=lengths, targets=targets,
                splat_target=tgt, weights=wts)


def multihost():         # test_multihost.py:94
    rng = np.random.default_rng(99)
    n, r = 128, 64
    spheres = np.concatenate([(rng.random((n, 3)) * 1.2 - 0.6),
                              0.15 + 0.1 * rng.random((n, 1))], axis=1).astype(np.float32)
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.random((r, 3)) * 0.2 - 0.7).astype(np.float32)
    return spheres, o, d, np.full((r,), 4.0, np.float32)
