"""Multi-card and multi-process distribution on ``torch.distributed``
(PyTorch counterpart of ``grace_tpu.parallel``): the rays-sharded and
particle-ring renders, the row-sharded splat, the differentiable ring
training step, and the multi-process bring-up. See ``sharding`` for the
SPMD contract (every rank passes its own block)."""

from grace_tpu_torch.parallel.multihost import (
    P,
    global_mesh,
    global_to_host_local,
    host_local_to_global,
    initialize,
    load_gadget_shard_for_process,
    process_allgather,
)
from grace_tpu_torch.parallel.sharding import (
    RingShift,
    allreduce_sum,
    make_mesh,
    replicated_sharded_render,
    ring_pallas_render,
    ring_render_and_loss,
    sharded_pallas_render,
    sharded_splat_render,
    sharded_train_step,
)
