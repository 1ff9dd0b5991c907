"""Shaded triangle-mesh render to BMP: a PLY mesh, or a procedural torus.

Usage:
    python -m grace_tpu_torch.examples.render_triangle [mesh.ply] [resolution] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from grace_tpu_torch.examples import split_device


def torus_mesh(n_u=64, n_v=32, R=1.0, r=0.4):
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = (R + r * np.cos(vv)) * np.cos(uu)
    y = (R + r * np.cos(vv)) * np.sin(uu)
    z = r * np.sin(vv)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    def vid(i, j):
        return (i % n_u) * n_v + (j % n_v)

    tris = []
    for i in range(n_u):
        for j in range(n_v):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            tris.append((a, b, c))
            tris.append((a, c, d))
    return verts[np.asarray(tris, np.int32)]


def main(argv=None):
    device, argv = split_device(sys.argv[1:] if argv is None else argv)
    from grace_tpu_torch.io.images import to_colormap, write_bmp
    from grace_tpu_torch.models.triangle import render_triangles

    ply = argv[0] if argv and argv[0].endswith(".ply") else None
    off = 1 if ply else 0
    res = int(argv[off]) if len(argv) > off else 512
    if ply:
        from grace_tpu_torch.io.ply import read_ply

        verts, faces = read_ply(ply)
        tris = verts[faces]
        print(f"{faces.shape[0]} triangles from {ply}")
    else:
        tris = torus_mesh()
        print(f"procedural torus: {tris.shape[0]} triangles")

    img = render_triangles(tris, resolution=res, device=device).cpu().numpy()
    write_bmp("render.bmp", to_colormap(img))
    print(f"wrote render.bmp ({res}x{res})")
    return img


if __name__ == "__main__":
    main()
