"""horovod_tpu_torch.parallel — the hybrid-parallelism layer (dp/tp/pp/
sp/ep).

Counterpart of ``horovod_tpu/parallel``: mesh layouts over the world's
ranks, Megatron-style tensor parallelism, the GPipe pipeline, ring and
Ulysses sequence parallelism and Switch-style expert parallelism, as
eager functions on tensors whose collectives run over the axes of a
``DeviceMesh`` (``mesh=``, ``MeshLayout.mesh``) and carry their
gradients (``_collectives.py``).
"""

from .mesh import LOGICAL_AXES, MeshLayout, auto_layout, make_layout
from .moe import expert_parallel_moe, switch_route
from .pipeline import bubble_fraction, pipeline_apply
from .ring import ring_attention
from .tp import column_parallel, row_parallel, tp_shard_dim
from .ulysses import heads_to_seq, seq_to_heads, ulysses_attention

__all__ = [
    "LOGICAL_AXES",
    "MeshLayout",
    "auto_layout",
    "make_layout",
    "ring_attention",
    "ulysses_attention",
    "seq_to_heads",
    "heads_to_seq",
    "column_parallel",
    "row_parallel",
    "tp_shard_dim",
    "pipeline_apply",
    "bubble_fraction",
    "expert_parallel_moe",
    "switch_route",
]
