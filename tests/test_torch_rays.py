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


@pytest.mark.parametrize("kind", ["ortho", "random", "given box", "tied keys"])
def test_spatial_sort_exact(kind):
    """The order, its inverse (a scatter) and the sorted rays bit-equal to
    grace_tpu's; also at a given box and where most keys tie (zero-length rays at a
    few points: runs of equal keys keep their input order)."""
    box = ()
    if kind == "ortho":
        arrs = _rays_np(jg.orthographic_projection_rays(64, 48, CAM, LOOK, UP, 1.2, 6.0))
    else:
        arrs = _random_rays(np.random.default_rng(5), 3000)
    if kind == "given box":
        box = (np.float32([-0.5, 0.0, -0.25]), np.float32([1.5, 1.25, 1.0]))
    elif kind == "tied keys":
        arrs[0][:] = arrs[0][400 * np.random.default_rng(6).integers(0, 7, 3000)]
        arrs[2][:] = 0.0
    rj, oj, ij = jax.jit(jg.spatial_sort_rays)(JRays.from_arrays(*arrs), *box)
    rt, ot, it = tg.spatial_sort_rays(convert.rays_from_numpy(*arrs, device="cpu"),
                                      *(torch.from_numpy(b) for b in box))
    if kind == "tied keys":
        keys = tg._midpoint_keys(convert.rays_from_numpy(*arrs, device="cpu"), None, None)
        assert len(torch.unique(keys)) == 7
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


# ---- the rays' keys in one launch (csrc/build.cu's grace_morton_keys) -------

from chip_smoke import KEY_CASES, key_outputs, key_scene  # noqa: E402
from tests.helper.morton_model import ROUTES, model_launch  # noqa: E402,F401 (fixture)

RAY_CASES = [t for t, c in KEY_CASES.items() if c[0] == "rays"]


@pytest.mark.parametrize("tag", RAY_CASES)
def test_ray_key_cases_model_match_grace_tpu(tag, model_launch):
    """spatial_sort_rays on the kernel route (the numpy model of
    grace_morton_keys reading the rays themselves: the midpoint formed in
    the launch as vecmath.fma forms it, the box folded in it or given;
    the device test made to say "not the CPU") at chip_smoke's ray cases:
    runs of equal rays, a grid capped at 3 blocks, a given box, a NaN
    origin, zero lengths with -0 and +0 directions, one ray. One launch
    a call; keys, order, inverse and sorted rays bit-equal to the
    plain chain, and order, inverse and sorted rays to grace_tpu's."""
    box = KEY_CASES[tag][3]
    got = key_outputs(tag, torch.device("cpu"), plain=False)
    assert model_launch == ["grace_morton_keys"] * 2   # the keys alone, then the sort's
    assert ROUTES[-1] == ("rays", "fold" if box is None else "given")
    want = key_outputs(tag, torch.device("cpu"), plain=True)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.dtype == w.numpy().dtype and np.array_equal(
            g.view(np.int32) if g.dtype == np.float32 else g,
            w.numpy().view(np.int32) if g.dtype == np.float32 else w.numpy()), name
    a = key_scene(tag)
    args = () if a["box"] is None else a["box"]
    rj, oj, ij = jax.jit(jg.spatial_sort_rays)(
        JRays.from_arrays(a["origins"], a["directions"], a["lengths"]), *args)
    assert np.array_equal(np.asarray(oj), got["order"].numpy())
    assert np.array_equal(np.asarray(ij), got["inverse"].numpy())
    for j, name in zip(_rays_np(rj), ("origins", "directions", "lengths")):
        assert np.array_equal(j.view(np.int32), got[f"sorted {name}"].numpy().view(np.int32))
