"""The parallel layer on torch.distributed (counterpart:
physics_llm_inference_tpu/parallel): one process per rank, a mesh of
process groups with the JAX package's axis names, Megatron tensor
parallelism through the models' TP hooks, expert parallelism, ring
attention and the lockstep serving group.
"""
from .mesh import make_mesh, local_mesh_shape
from .tp import (
    tp_param_specs,
    tp_param_spec_tree,
    tp_shard_params,
    tp_prepare_params,
    tp_local_config,
    tp_kv_spec,
    column_parallel_linear,
    row_parallel_linear,
    tp_mlp,
    tp_mlp_shardmap,
    compute_tp_memory_savings,
)
from .ep import moe_layer_ep
from .multihost import (
    initialize_multihost,
    pod_mesh,
    is_leader,
    broadcast_bytes,
    DPServingGroup,
)

__all__ = [
    "make_mesh", "local_mesh_shape",
    "tp_param_specs", "tp_param_spec_tree", "tp_prepare_params",
    "tp_shard_params", "tp_local_config", "tp_kv_spec",
    "column_parallel_linear", "row_parallel_linear",
    "tp_mlp_shardmap", "tp_mlp", "compute_tp_memory_savings",
    "moe_layer_ep",
    "initialize_multihost", "pod_mesh", "is_leader", "broadcast_bytes",
    "DPServingGroup",
]
