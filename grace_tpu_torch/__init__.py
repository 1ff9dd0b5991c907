"""grace_tpu_torch — the SPH/BVH ray-tracing framework on PyTorch and CUDA.

The port of ``grace_tpu`` to an NVIDIA H100: the same subpackages and
public names, PyTorch tensors in place of JAX arrays, and hand-written CUDA
kernels (``csrc/``, built with nvcc at first use) in place of the Pallas
kernels. It imports neither JAX nor ``grace_tpu``. Ported so far: the
column-density render (LBVH build, orthographic rays and spatial sort,
splat bucketing, splat image), the fused trace on every broadphase route,
the generic BVH engine with its SPH hit-count and column-density facades,
the training path (the record-based differentiable render, the
sort-free splat trainer and the fused differentiable renderer), per-hit
records (``trace_sph``, ``pallas_trace_sph_records``), triangle meshes
(``models.triangle.render_triangles``, ``trace.pallas_tri``), random and
HEALPix rays with their uniformity statistics and hypothesis tests,
snapshot, mesh, image and checkpoint IO (``io``), timers and profiling
(``utils``), and the examples (``grace_tpu_torch.examples``).
"""

from grace_tpu_torch.core.types import Octants, Rays, RaySortType, make_spheres
from grace_tpu_torch.core.tree import Tree
from grace_tpu_torch.build.sph import (
    albvh_sph,
    build_primitive_tree,
    build_sph_tree,
    euclidean_deltas_sph,
    morton_keys_sph,
    sort_by_morton,
    surface_area_deltas_sph,
    xor_deltas_sph,
)
from grace_tpu_torch.rays import gen as ray_gen
from grace_tpu_torch.rays import statistics as ray_statistics
from grace_tpu_torch.rays import hypothesis as ray_hypothesis
from grace_tpu_torch.trace.pallas_kernel import pallas_trace_sph
from grace_tpu_torch.trace.pallas_records import (
    RecordTraceResult,
    pallas_trace_sph_records,
    sort_records_by_distance,
)
from grace_tpu_torch.trace.pallas_render import make_fused_renderer
from grace_tpu_torch.trace.render import render_column_density
from grace_tpu_torch.trace.sph import (
    SphTraceResult,
    trace_cumulative_sph,
    trace_hitcounts_sph,
    trace_sph,
    trace_with_sentinels_sph,
)
from grace_tpu_torch.trace.splat import bucket_prims_ortho, render_ortho_splat, splat_image
from grace_tpu_torch.trace.splat_grad import (
    OrthoCamera,
    make_splat_trainer,
    splat_backward_sortfree,
    splat_forward_sortfree,
)
from grace_tpu_torch.io.checkpoint import load_scene, save_scene

__version__ = "0.1.0"
