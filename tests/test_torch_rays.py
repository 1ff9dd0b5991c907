"""grace_tpu_torch ray generation and spatial sort against grace_tpu.

Generators are compared with the reference as ``bench.py`` calls them
(eagerly, op by op): orthographic and pinhole rays are bit-exact, for
axis-aligned and oblique cameras. The sort (compiled in the reference, as
the bench runs it) gives exactly the same order and inverse on identical
input rays.
"""

import jax
import numpy as np
import pytest
import torch

import grace_tpu.rays.gen as jg
from grace_tpu.core.types import Rays as JRays
import grace_tpu_torch.rays.gen as tg
from grace_tpu_torch import convert
import grace_tpu_torch.core.types as tt

CAM = (0.5, 0.5, -2.0)
LOOK = (0.5, 0.5, 0.5)
UP = (0.0, 1.0, 0.0)


def _rays_np(r):
    return [np.asarray(x) for x in (r.origins, r.directions, r.lengths)]


@pytest.mark.parametrize("res", [(64, 64), (96, 40)])
@pytest.mark.parametrize("camera", [(CAM, LOOK, UP), ((0.1, -0.3, 2.2), (0.6, 0.4, 0.5), (0.2, 1.0, 0.1))])
def test_orthographic_rays(res, camera):
    j = jg.orthographic_projection_rays(*res, *camera, 1.2, 6.0)
    t = tg.orthographic_projection_rays(*res, *camera, 1.2, 6.0, device="cpu")
    for a, b in zip(_rays_np(j), (t.origins, t.directions, t.lengths)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("camera", [(CAM, LOOK, UP), ((0.1, -0.3, 2.2), LOOK, UP),
                                    ((3.0, 1.0, -2.0), (0.2, 0.7, 0.4), (0.3, 1.0, 0.2))])
def test_pinhole_rays(camera):
    args = (48, 32, *camera, 0.9, 5.0)
    j = jg.pinhole_camera_rays(*args)
    t = tg.pinhole_camera_rays(*args, device="cpu")
    for a, b in zip(_rays_np(j), (t.origins, t.directions, t.lengths)):
        assert np.array_equal(a, b.numpy())


def _random_rays(rng, n):
    o = rng.random((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ln = (0.2 + rng.random(n)).astype(np.float32)
    o[:50] = o[50]                     # ties keep their input order
    d[:50] = d[50]
    ln[:50] = ln[50]
    return o, d, ln


@pytest.mark.parametrize("kind", ["ortho", "random"])
def test_spatial_sort_exact(kind):
    if kind == "ortho":
        arrs = _rays_np(jg.orthographic_projection_rays(64, 48, CAM, LOOK, UP, 1.2, 6.0))
    else:
        arrs = _random_rays(np.random.default_rng(5), 3000)
    rj, oj, ij = jax.jit(jg.spatial_sort_rays)(JRays.from_arrays(*arrs))
    rt, ot, it = tg.spatial_sort_rays(convert.rays_from_numpy(*arrs, device="cpu"))
    assert np.array_equal(np.asarray(oj), ot.numpy())
    assert np.array_equal(np.asarray(ij), it.numpy())
    for a, b in zip(_rays_np(rj), (rt.origins, rt.directions, rt.lengths)):
        assert np.array_equal(a, b.numpy())


def test_ray_dir_morton_keys_exact():
    _, d, _ = _random_rays(np.random.default_rng(6), 4000)
    j = jax.jit(jg.ray_dir_morton_keys)(d)
    t = tg.ray_dir_morton_keys(torch.from_numpy(d))
    assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_creators_default_to_the_card():
    """Called without ``device``, every creator makes CUDA tensors; with no
    card it raises instead of giving CPU tensors."""
    xyz = np.zeros((4, 3), np.float32)
    h = np.ones(4, np.float32)
    calls = [
        lambda: tg.orthographic_projection_rays(8, 8, CAM, LOOK, UP, 1.2, 6.0).origins,
        lambda: tg.pinhole_camera_rays(8, 8, CAM, LOOK, UP, 0.9, 5.0).directions,
        lambda: tt.make_spheres(xyz, h),
        lambda: tt.Rays.from_arrays(xyz, xyz, h).lengths,
        lambda: convert.spheres_from_numpy(np.zeros((4, 4), np.float32)),
        lambda: convert.rays_from_numpy(xyz, xyz, h).origins,
        lambda: convert.trainer_params_from_numpy(np.zeros((4, 4), np.float32), h)[1],
    ]
    for make in calls:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    # Tensors keep their device; device="cpu" gives CPU tensors.
    assert tt.make_spheres(torch.zeros(4, 3), torch.ones(4)).device.type == "cpu"
    assert tg.orthographic_projection_rays(8, 8, CAM, LOOK, UP, 1.2, 6.0,
                                           device="cpu").origins.device.type == "cpu"
