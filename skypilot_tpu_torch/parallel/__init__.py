"""The port's parallelism layer (counterpart of ``skypilot_tpu/parallel``).

A named-axis mesh over the ranks of a process group (``MeshSpec``,
``make_mesh``), logical-axis sharding rules (``LogicalRules``), and the
explicit collectives that stand in for GSPMD (``parallel/sharding.py``),
ring attention (``parallel/ring_attention.py``) and GPipe stages
(``parallel/pipeline.py``). Axes: ``dp`` data parallel, ``fsdp``
fully-sharded data parallel, ``tp`` tensor parallel, ``dcn`` cross-slice
data parallel, ``sp`` sequence parallel (ring attention), ``pp``
pipeline stages, ``ep`` expert parallel (an MoE layer's experts; its
routing spans the global batch, ``ops/moe.py``).
"""
from skypilot_tpu_torch.parallel.mesh import (MESH_AXES, MESH_AXIS_DIVISORS,
                                              Mesh, MeshSpec, make_mesh)
from skypilot_tpu_torch.parallel.pipeline import pipeline, split_stages
from skypilot_tpu_torch.parallel.ring_attention import ring_attention
from skypilot_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                  LogicalRules, local_shard,
                                                  multislice_rules, ppermute,
                                                  tree_specs)

__all__ = [
    'MESH_AXES',
    'MESH_AXIS_DIVISORS',
    'Mesh',
    'MeshSpec',
    'make_mesh',
    'DEFAULT_RULES',
    'LogicalRules',
    'local_shard',
    'multislice_rules',
    'pipeline',
    'ppermute',
    'ring_attention',
    'split_stages',
    'tree_specs',
]
