"""Differentiable splat training: fit particles to a target image.

A randomly initialized particle cloud is optimized (positions, smoothing
lengths, weights) by Adam to reproduce a target column-density image
rendered from a hidden scene; the forward and the backward are the
sort-free splat kernels (``trace.splat_grad``), with no per-step instance
sort and no gradient capacities.

Usage:
    python -m grace_tpu_torch.examples.train_splat [steps] [--device cuda|cpu]

On the card the scene has 65,536 particles at 256x256; on the CPU, where
the kernels run their plain versions, 2,000 particles at 128x32.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from grace_tpu_torch.examples import split_device


def main(argv=None):
    from grace_tpu_torch.build.sph import build_sph_tree
    from grace_tpu_torch.trace.splat_grad import OrthoCamera, make_splat_trainer

    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    argv = [a for a in argv if not a.startswith("--")]
    steps = int(argv[0]) if argv else 60
    small = torch.device(device).type == "cpu"

    n = 2_000 if small else 65_536
    res = (128, 32) if small else (256, 256)
    cam = OrthoCamera((0.5, 0.5, -2.0), (0.5, 0.5, 0.5), (0.0, 1.0, 0.0),
                      1.2, 6.0, res[0], res[1])
    tile_w = 16 if small else 32

    def cloud(seed):
        r = np.random.default_rng(seed)
        pos = (0.25 + 0.5 * r.random((n, 3))).astype(np.float32)
        h = (0.02 + 0.04 * r.random(n)).astype(np.float32)
        return torch.from_numpy(np.concatenate([pos, h[:, None]], axis=1)).to(device)

    render = make_splat_trainer(cam, tile_w=tile_w, tile_h=128)

    # Hidden scene -> target image. Morton-sort both clouds (the sort-free
    # kernels rely on segment locality; see splat_forward_sortfree).
    hidden = build_sph_tree(cloud(7), 32)[0]
    with torch.no_grad():
        target = render(hidden, torch.ones(n, device=device))

    spheres = build_sph_tree(cloud(1), 32)[0].requires_grad_(True)
    weights = torch.ones(n, device=device, requires_grad=True)
    opt = torch.optim.Adam([spheres, weights], lr=3e-3)

    loss0 = None
    for i in range(steps):
        opt.zero_grad()
        loss = torch.mean((render(spheres, weights) - target) ** 2)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if loss0 is None:
            loss0 = float(loss)
        if i % max(1, steps // 10) == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6e}")
    print(f"loss reduced {loss0 / float(loss):.1f}x over {steps} steps")
    assert float(loss) < loss0, "optimization must reduce the loss"
    return loss0, float(loss)


if __name__ == "__main__":
    main()
