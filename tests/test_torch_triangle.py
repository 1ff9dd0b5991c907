"""Triangle meshes in grace_tpu_torch against grace_tpu on the CPU.

Moller-Trumbore semantics, the triangle LBVH build, the engine's closest
and any hit, ``clip_rays_to_aabb``, the front-to-back segment lists, the
triangle kernel's plain version (grace_tpu's kernel in interpret mode) and
``render_triangles`` on both engines. Same inputs from a numpy seed.

Tolerances: builds, lists, hit decisions and ids exact; t within rtol 1e-6
(measured: equal, the port mirrors each path's compiled rounding);
images within atol 1e-5 (measured: equal).
"""

import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grace_tpu.core.types import Rays as JRays
from grace_tpu.models import triangle as jt
from grace_tpu.rays.gen import pinhole_camera_rays as j_pinhole
from grace_tpu.trace import pallas_tri as jp
from grace_tpu_torch import convert
from grace_tpu_torch.models import triangle as tt
from grace_tpu_torch.ops.vecmath import tan_f32
from grace_tpu_torch.rays.gen import pinhole_camera_rays
from grace_tpu_torch.trace import pallas_tri as tp
from grace_tpu_torch.trace.pallas_kernel import _pad_rays

from tests.helper.torch_parity import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


def random_mesh(rng, n):
    c = rng.random((n, 1, 3)).astype(np.float32)
    return c + 0.08 * rng.standard_normal((n, 3, 3)).astype(np.float32)


def _rays(rng, r, lo=0.3, span=0.4, length=5.0):
    d = rng.standard_normal((r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (rng.random((r, 3)) * span + lo).astype(np.float32)
    ln = np.full(r, length, np.float32)
    return (JRays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(ln)),
            convert.rays_from_numpy(o, d, ln, device="cpu"))


@pytest.fixture(scope="module")
def mesh():
    """800 random triangles (about half face away from any ray), sorted by
    grace_tpu's build, and 768 rays from inside the mesh's box."""
    rng = np.random.default_rng(5)
    tris = random_mesh(rng, 800)
    st, tree, _ = jt.build_triangle_tree(jnp.asarray(tris), max_per_leaf=8)
    tree_t = convert.tree_from_numpy(
        *(np.asarray(x) for x in (tree.children, tree.child_aabbs, tree.leaves, tree.root,
                                  tree.n_nodes, tree.n_leaves)), tree.max_per_leaf, device="cpu")
    jr, tr = _rays(rng, 768)
    return (st, tree, jr), (convert.triangles_from_numpy(st, device="cpu"), tree_t, tr)


def test_moller_trumbore_semantics():
    tri_front = torch.tensor([[[0, 0, 1], [0, 1, 1], [1, 0, 1]]], dtype=torch.float32)
    o = torch.tensor([[0.2, 0.2, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    ln = torch.tensor([10.0])
    hit, t = tt.intersect_triangle(o, d, ln, tri_front)
    assert bool(hit[0]) and abs(float(t[0]) - 1.0) < 1e-6
    hit, _ = tt.intersect_triangle(o, d, ln, tri_front[:, [0, 2, 1], :])   # back face
    assert not bool(hit[0])
    hit, _ = tt.intersect_triangle(torch.tensor([[0.9, 0.9, 0.0]]), d, ln, tri_front)
    assert not bool(hit[0])
    hit, _ = tt.intersect_triangle(o, d, torch.tensor([0.5]), tri_front)  # too short
    assert not bool(hit[0])


def test_intersect_triangle_matches_grace_tpu():
    rng = np.random.default_rng(6)
    tris = random_mesh(rng, 300)
    jr, tr = _rays(rng, 96)
    want = jax.jit(jt.intersect_triangle)(jr.origins[:, None, :], jr.directions[:, None, :],
                                          jr.lengths[:, None], jnp.asarray(tris)[None])
    got = tt.intersect_triangle(tr.origins[:, None, :], tr.directions[:, None, :],
                                tr.lengths[:, None], torch.from_numpy(tris)[None])
    assert int(got[0].sum()) > 20
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("max_per_leaf", [4, 8])
def test_build_triangle_tree_exact(max_per_leaf):
    tris = random_mesh(np.random.default_rng(7), 700)
    sj, treej, pj = jt.build_triangle_tree(jnp.asarray(tris), max_per_leaf=max_per_leaf)
    st, treet, pt_ = tt.build_triangle_tree(torch.from_numpy(tris), max_per_leaf=max_per_leaf)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert pt_.dtype == torch.int32 and np.array_equal(pt_.numpy(), np.asarray(pj))
    for f in ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves"):
        assert np.array_equal(getattr(treet, f).numpy(), np.asarray(getattr(treej, f))), f


def test_engine_closest_and_any_hit_match_grace_tpu(mesh):
    (st, tree, jr), (stt, tree_t, tr) = mesh
    want = jt.trace_closest_hit(jr, st, tree)
    got = tt.trace_closest_hit(tr, stt, tree_t)
    assert int((got.tri >= 0).sum()) > 300
    assert np.array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    assert np.array_equal(tt.trace_any_hit(tr, stt, tree_t).numpy(),
                          np.asarray(jt.trace_any_hit(jr, st, tree)))


def test_clip_rays_to_aabb_edges():
    """grace_tpu's edge rays: through the box, from inside it, pointing
    away, passing above it, shorter than the exit."""
    o = np.array([[0.5, 0.5, -1.0], [0.5, 0.5, 0.5], [2.0, 0.5, 0.5], [0.5, 2.0, -1.0],
                  [0.5, 0.5, -1.0]], np.float32)
    d = np.array([[0, 0, 1], [0, 0, 1], [1, 0, 0], [0, 0, 1], [0, 0, 1]], np.float32)
    ln = np.array([10.0, 10.0, 10.0, 10.0, 1.5], np.float32)
    got = tp.clip_rays_to_aabb(convert.rays_from_numpy(o, d, ln, device="cpu"),
                               torch.zeros(3), torch.ones(3))
    np.testing.assert_allclose(got.lengths.numpy(), [2.0, 0.5, 0.0, 0.0, 1.5], atol=1e-6)
    rng = np.random.default_rng(8)
    jr, tr = _rays(rng, 300, lo=-1.0, span=3.0)
    bmin, bmax = np.float32([0.1, 0.2, 0.0]), np.float32([0.9, 0.7, 1.1])
    want = jax.jit(jp.clip_rays_to_aabb)(jr, jnp.asarray(bmin), jnp.asarray(bmax))
    got = tp.clip_rays_to_aabb(tr, torch.from_numpy(bmin), torch.from_numpy(bmax))
    assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))


def _segments(tile, max_chunks):
    def f(rays, tris):
        n = rays.n_rays
        pad = (-n) % tile
        rays = JRays(jnp.concatenate([rays.origins, jnp.broadcast_to(rays.origins[-1:], (pad, 3))]),
                     jnp.concatenate([rays.directions,
                                      jnp.broadcast_to(rays.directions[-1:], (pad, 3))]),
                     jnp.concatenate([rays.lengths, jnp.full((pad,), -1.0, jnp.float32)]))
        rays = jp.clip_rays_to_aabb(rays, jnp.min(tris, axis=(0, 1)), jnp.max(tris, axis=(0, 1)))
        return jp._dense_tile_segments_tri(rays, tris, tile, max_chunks)
    return jax.jit(f)


@pytest.mark.parametrize("tile,max_chunks", [(32, 2048), (64, 3), (48, 16)])
def test_dense_tile_segments_tri_exact(mesh, tile, max_chunks, monkeypatch):
    """Ids, entry distances, counts and overflow bit for bit; lists cut at
    3 overflow; the overlap tensor goes in blocks of 5 tiles."""
    monkeypatch.setattr(tp, "CULL_BLOCK_ELEMENTS", 5 * tp.N_CULL_INTERVALS * 7)
    (st, _, jr), (stt, _, tr) = mesh
    want = _segments(tile, max_chunks)(jr, st)
    rays = _pad_rays(tr, tile)
    flat = stt.reshape(-1, 3)
    rays = tp.clip_rays_to_aabb(rays, flat.amin(dim=0), flat.amax(dim=0))
    got = tp._dense_tile_segments_tri(rays, stt, tile, max_chunks)
    assert bool(got[3].any()) == (max_chunks == 3)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("tile,max_chunks", [(32, 2048), (64, 16), (40, 3)])
def test_pallas_trace_tri_matches_grace_tpu(mesh, tile, max_chunks, monkeypatch):
    """Ids exact, t within rtol 1e-6, both modes; the plain kernel's tiles
    go in lockstep blocks of 3."""
    monkeypatch.setattr(tp, "PLAIN_BLOCK_TILES", 3)
    (st, _, jr), (stt, _, tr) = mesh
    n = 700                                     # no multiple of any tile
    jr = JRays(jr.origins[:n], jr.directions[:n], jr.lengths[:n])
    tr = tr[:n]
    t_w, id_w, ovf_w = jp.pallas_trace_tri(jr, st, tile=tile, max_chunks=max_chunks,
                                           interpret=True)
    t_g, id_g, ovf_g = tp.pallas_trace_tri(tr, stt, tile=tile, max_chunks=max_chunks)
    assert int((id_g >= 0).sum()) > 200 and bool(ovf_g.any()) == (max_chunks == 3)
    assert np.array_equal(id_g.numpy(), np.asarray(id_w))
    assert np.array_equal(ovf_g.numpy(), np.asarray(ovf_w))
    np.testing.assert_allclose(t_g.numpy(), np.asarray(t_w), rtol=1e-6)
    occ_w, _, _ = jp.pallas_trace_tri(jr, st, tile=tile, max_chunks=max_chunks, mode="any",
                                      interpret=True)
    occ_g, ids_any, _ = tp.pallas_trace_tri(tr, stt, tile=tile, max_chunks=max_chunks,
                                            mode="any")
    assert np.array_equal(occ_g.numpy(), np.asarray(occ_w))
    assert bool((ids_any == -1).all())


def test_plain_kernel_stops_front_to_back():
    """The plain version's chunked stop: with the real entry bounds it finds
    the hits of a walk of every chunk; a tile stops before the first chunk
    whose entry bound no open ray reaches (bounds of 1e6 past the first
    chunk: one chunk a tile)."""
    import chip_smoke

    stt, _, _ = tt.build_triangle_tree(torch.from_numpy(chip_smoke.torus_mesh(64, 32)))
    cam, look, length = tt.auto_camera(stt, 32)
    tr = pinhole_camera_rays(32, 32, cam.tolist(), look.tolist(), (0.0, 1.0, 0.0), math.pi / 3,
                             float(length), device="cpu")
    rays = _pad_rays(tr, 32)
    flat = stt.reshape(-1, 3)
    rays = tp.clip_rays_to_aabb(rays, flat.amin(dim=0), flat.amax(dim=0))
    ids, dist, n, _ = tp._dense_tile_segments_tri(rays, stt, 32, 2048)
    from grace_tpu_torch.trace.pallas_kernel import _pack_rays

    args = (_pack_rays(rays, 32)[0], tp._pack_tris(stt)[0])
    for mode in ("closest", "any"):
        t, hit_ids, _ = tp._tri_plain(n, ids, dist, *args, mode)
        t_all, ids_all, v_all = tp._tri_plain(n, ids, torch.zeros_like(dist), *args, mode)
        assert torch.equal(hit_ids, ids_all) and torch.equal(t, t_all)
        assert torch.equal(v_all, (n + tp.CHUNK - 1) // tp.CHUNK) and int(n.max()) > tp.CHUNK
        far = dist.clone()
        far[:, tp.CHUNK:] = 1e6
        _, _, v_far = tp._tri_plain(n, ids, far, *args, mode)
        assert torch.equal(v_far, (n > 0).to(torch.int32))


def test_auto_camera_and_pinhole_match_grace_tpu():
    """The camera's tangent is the C library's tanf, as compiled XLA's is
    (PyTorch's tan differs at pi/6)."""
    assert np.float32(tan_f32(math.pi / 6)) == np.float32(jnp.tan(math.pi / 6))
    tris = random_mesh(np.random.default_rng(9), 200)
    cj, lj, len_j = jt.auto_camera(jnp.asarray(tris), 64)
    ct, lt, len_t = tt.auto_camera(torch.from_numpy(tris), 64)
    assert np.array_equal(ct.numpy(), np.asarray(cj)) and np.array_equal(lt.numpy(), np.asarray(lj))
    assert float(len_t) == float(len_j)
    want = j_pinhole(64, 64, cj, lj, (0.0, 1.0, 0.0), jnp.pi / 3, len_j)
    got = pinhole_camera_rays(64, 64, ct.tolist(), lt.tolist(), (0.0, 1.0, 0.0), math.pi / 3,
                              float(len_t), device="cpu")
    for f in ("origins", "directions", "lengths"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_render_triangles_matches_grace_tpu(engine):
    tris = random_mesh(np.random.default_rng(10), 150)
    want = np.asarray(jt.render_triangles(tris, resolution=40, engine=engine, interpret=True))
    got = tt.render_triangles(torch.from_numpy(tris), resolution=40, engine=engine)
    assert got.shape == (40, 40) and got.device.type == "cpu"
    assert (want > 0).sum() > 50 and len(np.unique(np.round(want, 3))) > 10
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_render_triangles_devices_and_errors():
    tris = random_mesh(np.random.default_rng(11), 20)
    img = tt.render_triangles(tris, resolution=8, device="cpu")      # numpy in, CPU out
    assert img.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tt.render_triangles(tris, resolution=8)                   # defaults to the card
    with pytest.raises(ValueError, match="engine"):
        tt.render_triangles(tris, resolution=8, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        tp.pallas_trace_tri(convert.rays_from_numpy(np.zeros((4, 3), np.float32),
                                                    np.ones((4, 3), np.float32),
                                                    np.ones(4, np.float32), device="cpu"),
                            torch.from_numpy(tris), mode="nearest")
    t = convert.triangles_from_numpy(tris, device="cpu")
    assert t.dtype == torch.float32 and t.shape == (20, 3, 3)


def test_chip_smoke_torus_equals_example():
    """chip_smoke.py keeps its own copy of the example's torus mesh."""
    import chip_smoke

    spec = importlib.util.spec_from_file_location("render_triangle_example",
                                                  REPO / "examples" / "render_triangle.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for kw in (dict(), dict(n_u=24, n_v=10, R=2.0, r=0.5)):
        want = example.torus_mesh(**kw)
        got = chip_smoke.torus_mesh(**kw)
        assert got.dtype == want.dtype and np.array_equal(got, want)
