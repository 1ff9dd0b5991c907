"""Examples of grace_tpu_torch, each run as ``python -m
grace_tpu_torch.examples.<name> [arguments] [--device cuda|cpu]``:

  hitcount_stats    random spheres, isotropic rays from the box centre,
                    hit-count trace, statistics and a text dump
  project_gadget    a Gadget-2 snapshot's column density to density.bmp
  render_triangle   a shaded PLY mesh (or a torus) to render.bmp
  train_splat       particles fitted to a target image by Adam through
                    the differentiable splat

Each has a ``main(argv)`` (argv without the program name) and runs
nothing on import. ``--device`` defaults to the CUDA card.
"""


def split_device(argv):
    """(device, the other arguments) of ``argv``: ``--device X`` or
    ``--device=X`` anywhere, default ``cuda``."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest
