"""The parallel paths on ``torch.distributed`` (port of
``stgcn_tpu/parallel``): a ``(data, time, model)`` mesh of processes, one
a GPU, with every collective explicit.  NCCL on CUDA, gloo on the CPU."""

from stgcn_tpu_torch.parallel.launcher import (
    heartbeat,
    initialize_distributed,
    is_primary,
)
from stgcn_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_TIME,
    batch_spec,
    make_mesh,
    param_partition_specs,
    validate_time_sharding,
)
from stgcn_tpu_torch.parallel.train import (
    create_sharded_train_state,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
)
