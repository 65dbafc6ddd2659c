"""The port's counterpart of ``ray_tpu/dag/``: DAGs of actor-method and
function calls over the port's own processes, run eagerly or compiled
into shared-memory channels and persistent loops."""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    DAGNode,
    FunctionNode,
    InputNode,
    MultiOutputNode,
)
from ray_tpu_torch.dag.compiled_dag import CompiledDAG

__all__ = [
    "ClassMethodNode",
    "CompiledDAG",
    "DAGNode",
    "FunctionNode",
    "InputNode",
    "MultiOutputNode",
]
