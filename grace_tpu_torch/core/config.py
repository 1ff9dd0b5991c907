"""Launch and traversal constants (same values as ``grace_tpu.core.config``)."""

# Rays traced together by one traversal tile.
TRACE_TILE_RAYS = 256

# Depth of the shared per-tile traversal stack (node indices).
TRACE_STACK_SIZE = 512

# Default maximum primitives per leaf.
DEFAULT_MAX_PER_LEAF = 32

# Default per-ray traversal stack depth for the vectorized engine.
VECTOR_STACK_SIZE = 64
