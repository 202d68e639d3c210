"""Training and scoring over several devices, one process each
(counterpart: asv_subtools_tpu/parallel)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Placement,
    classifier_partition_rules,
    host_local_slice,
    initialize_multihost,
    make_fsdp_rules,
    make_mesh,
    opt_state_shardings,
    partition_params,
    replicate,
    shard_batch,
)
