"""Column-density projection of a Gadget-2 snapshot to a BMP image: read
the gas particles, build the tree, trace a plane-parallel jittered ray
field through the box, write the log-scaled column density as
density.bmp.

Usage:
    python -m grace_tpu_torch.examples.project_gadget [snapshot] [resolution] [--device cuda|cpu]

Without a snapshot argument a synthetic clustered snapshot is written by
the Gadget writer into a temporary directory.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from grace_tpu_torch.examples import split_device


def synthetic_snapshot(path, n=200_000, seed=0):
    from grace_tpu_torch.io.gadget import write_gadget_gas

    rng = np.random.default_rng(seed)
    n_clumps = 64
    centers = rng.random((n_clumps, 3)).astype(np.float32)
    assign = rng.integers(0, n_clumps, n)
    scale = 0.02 + 0.05 * rng.random((n_clumps, 1)).astype(np.float32)
    pos = np.clip(
        centers[assign] + rng.standard_normal((n, 3)).astype(np.float32) * scale[assign],
        0.0, 1.0,
    )
    h = (0.004 + 0.01 * rng.random(n)).astype(np.float32)
    write_gadget_gas(path, np.concatenate([pos, h[:, None]], axis=1))
    return path


def main(argv=None):
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as tmp:
        snapshot = argv[0] if argv else synthetic_snapshot(os.path.join(tmp, "synth.gdt"))
        res = int(argv[1]) if len(argv) > 1 else 512
        return _project(snapshot, res, device)


def _project(snapshot, res, device):
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.io.gadget import read_gadget_gas
    from grace_tpu_torch.io.images import to_colormap, write_bmp
    from grace_tpu_torch.ops.extrema import min_max
    from grace_tpu_torch.rays.gen import plane_parallel_random_rays
    from grace_tpu_torch.trace.sph import trace_cumulative_sph

    spheres = torch.from_numpy(read_gadget_gas(snapshot)).to(device)
    print(f"{spheres.shape[0]} gas particles from {snapshot}")
    mins, maxs = (v.cpu().numpy() for v in min_max(spheres[:, :3]))
    side = float((maxs - mins).max())

    sorted_spheres, tree, _ = build_sph_tree(spheres, 32)
    rays = plane_parallel_random_rays(
        torch.Generator(device).manual_seed(0), res, res,
        base=(mins[0], mins[1], mins[2] - side),
        w=(side, 0, 0), h=(0, side, 0), length=3 * side, device=device,
    )
    img = trace_cumulative_sph(rays, sorted_spheres, tree).reshape(res, res).cpu().numpy()
    write_bmp("density.bmp", to_colormap(img, log_scale=True))
    print(f"wrote density.bmp ({res}x{res}); column density range "
          f"[{img.min():.4g}, {img.max():.4g}]")
    return img


if __name__ == "__main__":
    main()
