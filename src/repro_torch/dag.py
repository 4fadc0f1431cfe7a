"""Top-level alias for the compiled task-graph API: ``repro_torch.dag``.

    from repro_torch import core, dag

    node = my_fn.bind(dag.input(0))
    cg = dag.compile(node)
    ref = cg.execute(x)

See ``repro_torch.core.dag`` for the implementation and ``repro_torch.core.api``'s
"Compiled graphs" section for the programming model.
"""
from repro_torch.core.dag import (CompiledGraph, GraphNode,  # noqa: F401
                            GraphOutput, InputNode, compile, input)
