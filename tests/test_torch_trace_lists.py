"""grace_tpu_torch's list trace routes against grace_tpu's.

The list routes of ``pallas_trace_sph``: 'qlist' (quarter lists), 'list'
and 'pallas' (segment lists by dense culling + set-bit compaction), 'xla'
(segment lists from the BVH tile walk, with a small stack), and
subtiles > 1, in both modes, resident and ``vmem_resident_limit=0``, with
and without list overflow, on the scene of test_torch_trace_routes.py. On
the CPU the port runs the list kernel's plain PyTorch version; grace_tpu's
Pallas kernels run in interpret mode. Overflow flags and hit counts are
exact (overflowed tiles included: both packages trace the same truncated
lists); column densities within rtol 1e-5, atol 1e-6 x max.
"""

import numpy as np
import pytest
import torch

import grace_tpu.trace.pallas_kernel as jpk
import grace_tpu_torch.trace.pallas_kernel as tpk
from tests.helper.torch_parity import (  # noqa: F401 (autouse fixture)
    assert_trace_match, clustered_scene, one_torch_thread)


@pytest.fixture(scope="module")
def scene():
    return clustered_scene(2500, 11, 25, 25, 1.6)


# (broadphase, mode, integral_deg, tile, extra kwargs). grace_tpu's
# streaming list kernel (vmem_resident_limit=0) ignores integral_deg
# (ROADMAP C1), so those cases use the default degree. 625 rays make 40
# tiles of 16 and 20 of 32: whole groups of 4 and of 2 subtiles.
CASES = [
    ("qlist", "hitcount", 14, 64, dict(max_chunks=64)),
    ("qlist", "cumulative", 8, 32, dict(max_chunks=64)),
    ("qlist", "cumulative", -12, 64, dict(max_chunks=12)),       # overflows
    ("qlist", "hitcount", 14, 32, dict(max_chunks=8)),           # overflows
    ("list", "hitcount", 14, 64, dict(max_chunks=32)),
    ("pallas", "cumulative", -10, 32, dict(max_chunks=32)),
    ("list", "cumulative", 14, 64, dict(max_chunks=6)),          # overflows
    ("list", "hitcount", 14, 32, dict(vmem_resident_limit=0, max_chunks=4)),
    ("list", "cumulative", 14, 64, dict(vmem_resident_limit=0)),
    ("xla", "hitcount", 14, 64, dict(max_chunks=64)),
    ("xla", "cumulative", 8, 32, dict(max_chunks=64, stack_size=10)),
    ("xla", "hitcount", 14, 64, dict(max_chunks=8, stack_size=10)),  # overflows
    ("dense", "hitcount", 14, 16, dict(subtiles=4, max_chunks=32)),
    ("dense", "cumulative", -12, 16, dict(subtiles=4, max_chunks=8)),
    ("xla", "cumulative", 14, 32, dict(subtiles=2, max_chunks=64)),
]


@pytest.mark.parametrize("bp,mode,deg,tile,kw", CASES)
def test_list_route_matches_grace_tpu(scene, bp, mode, deg, tile, kw):
    (ss, tree, rays), (ss_t, tree_t, rays_t) = scene
    vj, oj = jpk.pallas_trace_sph(rays, ss, tree, broadphase=bp, mode=mode,
                                  integral_deg=deg, tile=tile, interpret=True, **kw)
    vt, ot = tpk.pallas_trace_sph(rays_t, ss_t, tree_t, broadphase=bp, mode=mode,
                                  integral_deg=deg, tile=tile, **kw)
    oj = np.asarray(oj)
    assert ot.dtype == torch.bool and np.array_equal(oj, ot.numpy())
    if kw.get("max_chunks", 2048) <= 12:
        assert oj.any(), "the small list capacity must overflow on this scene"
    assert_trace_match(vj, vt, mode)


def test_subtiles_equal_plain_list_route(scene):
    """One CUDA block per fine tile: subtiles=4 is the list route at the
    same tile."""
    _, (ss_t, tree_t, rays_t) = scene
    a = tpk.pallas_trace_sph(rays_t, ss_t, tile=16, subtiles=4, max_chunks=16)
    b = tpk.pallas_trace_sph(rays_t, ss_t, tile=16, broadphase="list", max_chunks=16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
