"""Parallel modes of the port (``fmc_uia_tpu/parallel/`` on
``torch.distributed``): meshes, data parallel, ZeRO-1, tensor parallel,
pipeline and ragged expert parallel, and a local launcher. Imports torch
only."""

from fmc_uia_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from fmc_uia_tpu_torch.parallel.sharding import (
    apply_param_sharding,
    make_param_specs,
    tp_spec_for_path,
)
from fmc_uia_tpu_torch.parallel.distributed import (
    init_distributed,
    make_hybrid_mesh,
    mesh_from_config,
)
from fmc_uia_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_loss_fn,
    pipeline_swin_stage,
    shard_stage_params,
    stack_stage_params,
)
from fmc_uia_tpu_torch.parallel.expert import (
    default_capacity,
    dense_moe_reference,
    ragged_moe_apply,
)
from fmc_uia_tpu_torch.parallel.zero import (
    shard_opt_state,
    zero_sharded_fraction,
    zero_spec_for_leaf,
)
from fmc_uia_tpu_torch.parallel.activation import (
    activation_mesh,
    activation_mesh_scope,
    set_activation_mesh,
    shard_activation,
    shard_batch_activation,
)
from fmc_uia_tpu_torch.parallel.launch import run_local

__all__ = [
    "activation_mesh",
    "activation_mesh_scope",
    "set_activation_mesh",
    "shard_activation",
    "shard_batch_activation",
    "pipeline_apply",
    "pipeline_loss_fn",
    "pipeline_swin_stage",
    "shard_stage_params",
    "stack_stage_params",
    "default_capacity",
    "dense_moe_reference",
    "ragged_moe_apply",
    "make_mesh",
    "replicate",
    "shard_batch",
    "batch_sharding",
    "replicated_sharding",
    "apply_param_sharding",
    "make_param_specs",
    "tp_spec_for_path",
    "init_distributed",
    "make_hybrid_mesh",
    "mesh_from_config",
    "shard_opt_state",
    "zero_sharded_fraction",
    "zero_spec_for_leaf",
    "run_local",
]
