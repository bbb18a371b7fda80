"""Multi-rank execution: the (data, model) mesh, placements and collectives
(port of ``segmantic_tpu/parallel``)."""

from .mesh import (
    Mesh,
    TensorParallel,
    gather_params,
    initialize_distributed,
    is_main,
    make_mesh,
    put_batch,
    replicate,
    shard_batch,
    shard_opt_state,
    shard_params,
    splits_batch,
    unshard_params,
    zero_placement,
)

__all__ = [
    "Mesh",
    "TensorParallel",
    "gather_params",
    "initialize_distributed",
    "is_main",
    "make_mesh",
    "put_batch",
    "replicate",
    "shard_batch",
    "shard_opt_state",
    "shard_params",
    "splits_batch",
    "unshard_params",
    "zero_placement",
]
