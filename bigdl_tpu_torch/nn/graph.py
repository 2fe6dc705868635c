"""Graph — the functional DAG API (``bigdl_tpu/nn/graph.py``):
``ModuleNode``, ``Input`` (``:33``) and ``Graph`` (``:52``).

``module.inputs(n1, n2, ...)`` builds the edges and ``Graph(input,
output)`` sorts the nodes topologically. The graph's children are its
DISTINCT modules in topological order, registered as ``"{i}:{name}"``
exactly as the JAX graph keys its params and state trees
(``_rebuild_keys`` ``:66``), so :mod:`bigdl_tpu_torch.utils.params_tree`
matches the two trees child by child. A module used at several nodes is
one child and shares its parameters. ``forward`` walks the nodes in that
order (``apply`` ``:127``); a node with several inputs hands its module
the list of their values.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

from bigdl_tpu_torch.nn.containers import Container
from bigdl_tpu_torch.nn.module import AbstractModule, Identity


class ModuleNode:
    """A DAG node: a module plus its predecessor nodes."""

    def __init__(self, module: AbstractModule,
                 prev: Sequence["ModuleNode"] = ()) -> None:
        self.module = module
        self.prev: List[ModuleNode] = list(prev)

    def __repr__(self) -> str:
        return f"Node({self.module.name})"


def Input() -> ModuleNode:
    """Placeholder input node (reference ``Input()``)."""
    return ModuleNode(Identity(), ())


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Graph(Container):
    def __init__(self, input: Union[ModuleNode, Sequence[ModuleNode]],
                 output: Union[ModuleNode, Sequence[ModuleNode]]) -> None:
        super().__init__()
        self.input_nodes = _as_list(input)
        self.output_nodes = _as_list(output)
        self._single_input = not isinstance(input, (list, tuple))
        self._single_output = not isinstance(output, (list, tuple))
        self.topo: List[ModuleNode] = self._topo_sort()
        seen: Dict[int, AbstractModule] = {}
        for node in self.topo:
            if id(node.module) not in seen:
                seen[id(node.module)] = node.module
                self.add(node.module)

    def _topo_sort(self) -> List[ModuleNode]:
        order: List[ModuleNode] = []
        state: Dict[int, int] = {}  # 0 = visiting, 1 = done

        def visit(n: ModuleNode) -> None:
            if state.get(id(n)) == 1:
                return
            if state.get(id(n)) == 0:
                raise ValueError("Graph contains a cycle")
            state[id(n)] = 0
            for p in n.prev:
                visit(p)
            state[id(n)] = 1
            order.append(n)

        for out in self.output_nodes:
            visit(out)
        for inp in self.input_nodes:
            if id(inp) not in state:
                raise ValueError(
                    f"input node {inp} is not connected to any output")
        return order

    def __getstate__(self):
        """The DAG as a flat table, ``(module, [indices of prev])`` in
        topological order: a deep copy, a pickle or ``save_module`` of a
        deep graph would otherwise recurse once per node along ``prev``
        (ResNet-50's Keras graph passes Python's recursion limit)."""
        d = super().__getstate__()
        index = {id(n): i for i, n in enumerate(self.topo)}
        d["topo"] = [(n.module, [index[id(p)] for p in n.prev])
                     for n in self.topo]
        d["input_nodes"] = [index[id(n)] for n in self.input_nodes]
        d["output_nodes"] = [index[id(n)] for n in self.output_nodes]
        return d

    def __setstate__(self, state) -> None:
        super().__setstate__(state)
        if self.topo and isinstance(self.topo[0], ModuleNode):
            return                               # a snapshot of old
        nodes: List[ModuleNode] = []
        for module, prev in self.topo:
            nodes.append(ModuleNode(module, [nodes[i] for i in prev]))
        self.topo = nodes
        self.input_nodes = [nodes[i] for i in self.input_nodes]
        self.output_nodes = [nodes[i] for i in self.output_nodes]

    def forward(self, x):
        inputs = [x] if self._single_input else _as_list(x)
        if len(inputs) != len(self.input_nodes):
            raise ValueError(f"graph expects {len(self.input_nodes)} inputs, "
                             f"got {len(inputs)}")
        values = {id(n): v for n, v in zip(self.input_nodes, inputs)}
        for node in self.topo:
            if id(node) in values:
                continue
            args = [values[id(p)] for p in node.prev]
            values[id(node)] = node.module(args[0] if len(args) == 1
                                           else args)
        outs = [values[id(n)] for n in self.output_nodes]
        return outs[0] if self._single_output else outs


#: the reference's name for a graph whose structure is fixed when it is built
StaticGraph = Graph
