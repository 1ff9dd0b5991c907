"""Hit-count statistics dump: random spheres in the unit box, isotropic rays
from the box centre, BVH build and hit-count trace, then the total, max and
min hit counts and an optional text dump of spheres, rays and per-ray
counts.

Usage:
    python -m grace_tpu_torch.examples.hitcount_stats [N] [N_rays/32] [max_per_leaf] [save] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from grace_tpu_torch.examples import split_device


def main(argv=None):
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    n = int(argv[0]) if len(argv) > 0 else 100_000
    n_rays = 32 * (int(argv[1]) if len(argv) > 1 else 3125 // 8)
    max_per_leaf = int(argv[2]) if len(argv) > 2 else 32
    save = len(argv) > 3 and argv[3] == "save"

    print(f"Number of rays:         {n_rays}")
    print(f"Number of particles:    {n}")
    print(f"Max particles per leaf: {max_per_leaf}\n")

    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.core.types import make_spheres
    from grace_tpu_torch.rays.gen import uniform_random_rays
    from grace_tpu_torch.trace.sph import trace_hitcounts_sph

    # Random spheres in [0, 1), radii in [0, 0.1).
    rng = np.random.default_rng(0)
    spheres = make_spheres(rng.random((n, 3)).astype(np.float32),
                           (0.1 * rng.random(n)).astype(np.float32), device=device)
    # Rays from the box centre, length 2.
    rays = uniform_random_rays(torch.Generator(device).manual_seed(0), n_rays,
                               (0.5, 0.5, 0.5), 2.0, device=device)

    sorted_spheres, tree, _ = build_sph_tree(spheres, max_per_leaf)
    counts = trace_hitcounts_sph(rays, sorted_spheres, tree).cpu().numpy()

    print(f"Total hits: {counts.sum()}")
    print(f"Max hits:   {counts.max()}")
    print(f"Min hits:   {counts.min()}")

    if save:
        np.savetxt("outdata_spheres.txt", sorted_spheres.cpu().numpy(), fmt="%.8f")
        rays_np = torch.cat([rays.origins, rays.directions, rays.lengths[:, None]],
                            dim=1).cpu().numpy()
        np.savetxt("outdata_rays.txt", rays_np, fmt="%.8f")
        np.savetxt("outdata_hitcounts.txt", counts, fmt="%d")
        print("Saved outdata_{spheres,rays,hitcounts}.txt")
    return counts


if __name__ == "__main__":
    main()
