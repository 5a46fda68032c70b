"""Parallelism over ``torch.distributed`` (counterpart of
``aihab_clip_tpu/parallel``): data, tensor and FSDP sharding over a
(data, model) mesh of ranks (``mesh``), the GPipe pipeline over a
(data, stage) mesh (``pipeline``), the collectives and their autograd
(``comm``), the tensor-parallel block forward (``tensor``) and the
multi-process plumbing (``distributed``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    param_pspec,
    param_shardings,
    replicated,
    shard_batch,
    shard_params,
)
from .pipeline import (
    STAGE_AXIS,
    make_pipeline_mesh,
    pipeline_blocks,
    pipeline_encode,
    place_stage_params,
    stack_stage_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "STAGE_AXIS",
    "Sharding",
    "batch_sharding",
    "make_mesh",
    "make_pipeline_mesh",
    "param_pspec",
    "param_shardings",
    "pipeline_blocks",
    "pipeline_encode",
    "place_stage_params",
    "replicated",
    "shard_batch",
    "shard_params",
    "stack_stage_params",
]
