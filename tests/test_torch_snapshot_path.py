"""chip_smoke.py's main path 6 (Gadget snapshot -> build and checkpoint ->
plane-parallel, isotropic and HEALPix rays through both trace routes ->
ray statistics) run on the CPU at a small size, every gate included: the
trace kernels' plain versions stand in for the CUDA kernels, so no launch
is counted here. On the card the path runs at SNAPSHOT_SIZES on the bench
particles."""

import numpy as np
import torch

import chip_smoke
from tests.helper.torch_parity import one_torch_thread  # noqa: F401

SIZES = dict(proj_side=48, integral_side=256, iso_rays=4096, engine_rays=128, nside=4,
             stats_dirs=2048, stats_subset=512, band_dirs=128, band_samples=60)


def test_snapshot_path_small_on_the_cpu():
    particles = chip_smoke.make_clustered_particles(np.random.default_rng(2026), 4000)
    particles[:, 3] *= 4.0       # h 0.02-0.06: 5 to 14 cells of the 256^2 integral field
    out = chip_smoke.snapshot_path(torch.device("cpu"), particles, SIZES)
    assert out["launches"] == {"trace_bitmask": 0, "trace_quarter": 0}
    assert set(out["ray_sets"]) == {"projection", "integral", "isotropic", "HEALPix"}
    assert out["ray_sets"]["HEALPix"].n_rays == 12 * 4 * 4
    assert out["iso_dirs"].shape == (2048, 3)
    text = "\n".join(out["lines"])
    for expected in ("bit-equal to the written array", "bit-equal after the round trip",
                     "density.bmp: 6966 bytes", "integral normalization", "engine subset: 128",
                     "one octant (2048)", "Ripley band (60 samples of 128)"):
        assert expected in text, expected


def test_path6_check_subsets_keep_each_tiles_result():
    """The tile subsets that chip_smoke.py holds B6 and B3 to their plain
    versions on: the heaviest tile is in, and each kernel's plain version on
    the subset gives exactly its rows of the whole run."""
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.rays.gen import uniform_random_rays
    from grace_tpu_torch.trace import pallas_kernel as pk

    particles = chip_smoke.make_clustered_particles(np.random.default_rng(7), 3000)
    ss, tree, _ = build_sph_tree(torch.from_numpy(particles), 16)
    rays = uniform_random_rays(torch.Generator().manual_seed(1), 128 * 12, (0.5, 0.5, 0.5), 2.0,
                               device="cpu")
    inputs = chip_smoke.snapshot_inputs({"isotropic": rays}, ss, tree)["isotropic"]
    for kname, plain in (("trace_bitmask", pk._trace_bitmask_plain),
                         ("trace_quarter", pk._trace_quarter_plain)):
        args = inputs[kname]
        words = args[0] if kname == "trace_bitmask" else args[1]
        tiles = chip_smoke.heavy_tiles(words, n_heavy=2, n_spread=3)
        listed = chip_smoke._popcount_rows(words)
        assert int(listed[tiles].max()) == int(listed.max())
        assert tiles.tolist() == sorted(set(tiles.tolist())) and 3 <= tiles.numel() <= 5
        assert {0, words.shape[0] - 1} <= set(tiles.tolist())
        rows = (tiles[:, None] * chip_smoke.TRACE_TILE + torch.arange(chip_smoke.TRACE_TILE))
        for mode in ("cumulative", "hitcount"):
            whole = plain(*args, 14, mode)
            sub = plain(*chip_smoke.tile_subset(args, tiles), 14, mode)
            assert torch.equal(sub, whole[rows.flatten()]), (kname, mode)
            assert float(sub.sum()) > 0.0
