"""grace_tpu_torch IO against grace_tpu: Gadget-2 snapshots (native and
numpy readers and writers, sharded reads), PLY meshes, BMP images, the
native library's build, and scene checkpoints, each across the two
packages: a file either package writes, the other reads to the same bits.
Then the reference's Gadget physics gate (``tests/integration/
test_gadget_integrate.py``): a snapshot read back, built and traced by the
port's plane-parallel rays integrates to N within 5e-4.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch

from grace_tpu.build.sph import build_sph_tree as j_build
from grace_tpu.core.types import make_spheres as j_make_spheres
from grace_tpu.io import checkpoint as jckpt
from grace_tpu.io import gadget as jgadget
from grace_tpu.io import images as jimages
from grace_tpu.io import ply as jply
from grace_tpu_torch import convert
from grace_tpu_torch.build.sph import build_sph_tree
from grace_tpu_torch.io import checkpoint as tckpt
from grace_tpu_torch.io import gadget as tgadget
from grace_tpu_torch.io import images as timages
from grace_tpu_torch.io import native
from grace_tpu_torch.io import ply as tply
from grace_tpu_torch.rays.gen import plane_parallel_random_rays
from grace_tpu_torch.trace.sph import trace_cumulative_sph, trace_hitcounts_sph
from tests.helper.torch_parity import one_torch_thread  # noqa: F401

TOL = 5e-4  # the reference's integral normalization gate


def _xyzh(rng, n):
    return np.concatenate([rng.random((n, 3)), 0.01 + 0.1 * rng.random((n, 1))],
                          axis=1).astype(np.float32)


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's IO modules without the native library."""
    monkeypatch.setattr(native, "load", lambda: None)


def test_native_library_builds_into_the_port():
    lib = native.load()
    assert lib is not None, native.build_error
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_kernels_build" and path.parent.parent.name == "grace_tpu_torch"
    assert path.name.startswith("libgrace_io-") and len(path.stem) == len("libgrace_io-") + 16
    assert native.SRC == pathlib.Path(__file__).resolve().parents[1] / "src/native/grace_io.cpp"


@pytest.mark.parametrize("n", [1000, 1003])
def test_gadget_roundtrip_across_packages(tmp_path, rng, n):
    xyzh = _xyzh(rng, n)
    mine, theirs = str(tmp_path / "port.gdt"), str(tmp_path / "ref.gdt")
    tgadget.write_gadget_gas(mine, torch.from_numpy(xyzh))
    jgadget.write_gadget_gas(theirs, xyzh)
    assert pathlib.Path(mine).read_bytes() == pathlib.Path(theirs).read_bytes()
    for path in (mine, theirs):
        for got in (tgadget.read_gadget_gas(path), tgadget._np_read(path),
                    jgadget.read_gadget_gas(path),
                    np.concatenate([tgadget.read_gadget_gas_shard(path, s, 4)
                                    for s in range(4)])):
            assert got.dtype == np.float32 and np.array_equal(_bits(got), _bits(xyzh))


def test_gadget_numpy_writer_and_reader(tmp_path, rng, numpy_only):
    xyzh = _xyzh(rng, 777)
    path = str(tmp_path / "np.gdt")
    tgadget.write_gadget_gas(path, xyzh)
    theirs = str(tmp_path / "ref.gdt")
    jgadget.write_gadget_gas(theirs, xyzh)
    assert pathlib.Path(path).read_bytes() == pathlib.Path(theirs).read_bytes()
    assert np.array_equal(_bits(tgadget.read_gadget_gas(path)), _bits(xyzh))
    tgadget.write_gadget_gas(path, np.zeros((0, 4), np.float32))
    with pytest.raises(ValueError, match="no gas"):
        tgadget.read_gadget_gas(path)


PLY_ASCII = """ply
format ascii 1.0
element vertex 5
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
0.5 0.5 1.25
4 0 1 2 3
3 0 1 4
"""


def _ply_binary(path):
    header = (b"ply\nformat binary_little_endian 1.0\n"
              b"element vertex 4\nproperty float x\nproperty float y\n"
              b"property float z\nelement face 2\n"
              b"property list uchar int vertex_indices\nend_header\n")
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0.25, 0.5, -2]], np.float32)
    with open(path, "wb") as f:
        f.write(header)
        f.write(verts.tobytes())
        f.write(np.uint8(3).tobytes())
        f.write(np.array([0, 1, 2], np.int32).tobytes())
        f.write(np.uint8(4).tobytes())
        f.write(np.array([0, 1, 3, 2], np.int32).tobytes())
    return verts


@pytest.mark.parametrize("kind", ["ascii", "binary"])
def test_ply_matches_grace_tpu(tmp_path, kind):
    path = str(tmp_path / f"{kind}.ply")
    if kind == "ascii":
        pathlib.Path(path).write_text(PLY_ASCII)
        quad_first = [[0, 1, 2], [0, 2, 3], [0, 1, 4]]
    else:
        _ply_binary(path)
        quad_first = [[0, 1, 2], [0, 1, 3], [0, 3, 2]]
    want_v, want_t = jply.read_ply(path)
    np.testing.assert_array_equal(want_t, quad_first)        # quads are fan-split
    for v, t in (tply.read_ply(path), tply._py_read(path), jply._py_read(path)):
        assert v.dtype == np.float32 and t.dtype == np.int32
        assert np.array_equal(_bits(v), _bits(want_v)) and np.array_equal(t, want_t)


@pytest.mark.parametrize("log_scale", [False, True])
@pytest.mark.parametrize("shape", [(17, 23), (64, 64)])
def test_bmp_bytes_match_grace_tpu(tmp_path, rng, monkeypatch, log_scale, shape):
    img = (rng.random(shape) * 5).astype(np.float32)
    img[0, :3] = 0.0
    rgb = jimages.to_colormap(img, log_scale=log_scale)
    got = timages.to_colormap(torch.from_numpy(img), log_scale=log_scale)
    assert got.dtype == np.uint8 and np.array_equal(got, rgb)
    want_path, mine = tmp_path / "ref.bmp", tmp_path / "port.bmp"
    jimages.write_bmp(str(want_path), rgb)
    timages.write_bmp(str(mine), torch.from_numpy(rgb))
    raw = want_path.read_bytes()
    assert mine.read_bytes() == raw
    assert raw[:2] == b"BM" and int.from_bytes(raw[2:6], "little") == len(raw)
    assert (int.from_bytes(raw[18:22], "little"), int.from_bytes(raw[22:26], "little")) \
        == (shape[1], shape[0])
    monkeypatch.setattr(native, "load", lambda: None)
    timages.write_bmp(str(mine), rgb)
    assert mine.read_bytes() == raw


def _j_scene(rng, n=2000):
    spheres = j_make_spheres(rng.random((n, 3)).astype(np.float32),
                             (0.02 + 0.03 * rng.random(n)).astype(np.float32))
    ss, tree, _ = jax.jit(j_build, static_argnums=1)(spheres, 16)
    return ss, tree, rng.random(n).astype(np.float32)


def _tree_fields(tree):
    return [np.asarray(getattr(tree, f)) if not isinstance(getattr(tree, f), torch.Tensor)
            else getattr(tree, f).numpy()
            for f in ("children", "child_aabbs", "leaves", "root", "n_nodes", "n_leaves")]


@pytest.mark.parametrize("with_weights", [True, False])
def test_checkpoints_load_across_packages(tmp_path, rng, with_weights):
    ss, tree, w = _j_scene(rng)
    fields = _tree_fields(tree)
    weights = w if with_weights else None
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jckpt.save_scene(ref_path, ss, tree, weights=weights)
    t_ss = convert.spheres_from_numpy(ss, device="cpu")
    t_tree = convert.tree_from_numpy(*fields, tree.max_per_leaf, device="cpu")
    tckpt.save_scene(port_path, t_ss, t_tree,
                     weights=None if weights is None else torch.from_numpy(w))
    ref, port = np.load(ref_path), np.load(port_path)
    assert sorted(ref.files) == sorted(port.files)
    for k in ref.files:
        assert ref[k].dtype == port[k].dtype and ref[k].shape == port[k].shape, k
        assert np.array_equal(ref[k], port[k]), k
    # grace_tpu's file in the port, the port's file in grace_tpu
    for path in (ref_path, port_path):
        ss2, tree2, w2 = tckpt.load_scene(path, device="cpu")
        assert ss2.device.type == "cpu" and np.array_equal(_bits(ss2.numpy()), _bits(ss))
        assert tree2.max_per_leaf == tree.max_per_leaf
        for a, b in zip(_tree_fields(tree2), fields):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert (w2 is None) == (weights is None)
        if weights is not None:
            assert w2.dtype == torch.float32 and np.array_equal(w2.numpy(), w)
        jss, jtree, jw = jckpt.load_scene(path)
        assert np.array_equal(_bits(jss), _bits(ss))
        for a, b in zip(_tree_fields(jtree), fields):
            assert np.array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.load_scene(ref_path)                    # the card by default


def test_restored_scene_traces_identically(tmp_path, rng):
    sp = torch.from_numpy(np.concatenate(
        [rng.random((2000, 3)), 0.02 + 0.03 * rng.random((2000, 1))], axis=1).astype(np.float32))
    ss, tree, _ = build_sph_tree(sp, 16)
    path = str(tmp_path / "scene.npz")
    tckpt.save_scene(path, ss, tree)
    ss2, tree2, _ = tckpt.load_scene(path, device="cpu")
    d = torch.nn.functional.normalize(torch.randn(128, 3, generator=torch.Generator()
                                                  .manual_seed(0)), dim=1)
    rays = convert.rays_from_numpy(np.full((128, 3), 0.5, np.float32), d.numpy(),
                                   np.full(128, 2.0, np.float32), device="cpu")
    assert torch.equal(trace_hitcounts_sph(rays, ss, tree), trace_hitcounts_sph(rays, ss2, tree2))


def test_gadget_to_integral_normalization(tmp_path, rng):
    """test_gadget_integrate.py's flow on the port: fabricate a snapshot,
    read it back (both readers give the same bits), build, trace 1024^2
    jittered plane-parallel rays through the engine; the column densities
    integrate to N within 5e-4."""
    n = 40
    pos = (rng.random((n, 3)) * 1.2 - 0.6).astype(np.float32)
    h = (0.1 + 0.1 * rng.random(n)).astype(np.float32)
    xyzh = np.concatenate([pos, h[:, None]], axis=1).astype(np.float32)
    path = str(tmp_path / "snap_000")
    tgadget.write_gadget_gas(path, xyzh)
    got = tgadget.read_gadget_gas(path)
    assert np.array_equal(_bits(got), _bits(xyzh))
    assert np.array_equal(_bits(tgadget._np_read(path)), _bits(xyzh))
    ss, tree, _ = build_sph_tree(torch.from_numpy(got), 4)
    side, res = 2.0, 1024
    rays = plane_parallel_random_rays(torch.Generator().manual_seed(11), res, res,
                                      (-1.0, -1.0, -5.0), (side, 0, 0), (0, side, 0),
                                      length=20.0, device="cpu")
    integrals = trace_cumulative_sph(rays, ss, tree)
    total = float(integrals.double().sum()) * (side / res) ** 2
    assert abs(total / n - 1.0) < TOL, total
