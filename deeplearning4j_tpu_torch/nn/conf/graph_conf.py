"""ComputationGraph configuration — string-keyed DAG wiring (JAX
counterpart deeplearning4j_tpu/nn/conf/graph_conf.py; reference
nn/conf/ComputationGraphConfiguration.java GraphBuilder:446).

The DAG is declared as {name: (vertex_conf, [input names])}; the
ComputationGraph container walks it in topological order. The port
carries the vertices the Transformer LM and ResNet-20 use: layer and
elementwise; the other vertex kinds come with later slices. With input
types set, `build()` infers each layer's n_in and inserts the shape
adapters, CNN ones included (`_infer_graph_shapes`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    BackpropType,
    NeuralNetConfiguration,
    _adapter,
    _expected_kind,
)
from deeplearning4j_tpu_torch.nn.conf.preprocessors import InputPreProcessor


@serde.register_config
@dataclasses.dataclass
class GraphVertexConf:
    """Base vertex config (reference nn/conf/graph/GraphVertex.java)."""

    def get_output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]


@serde.register_config
@dataclasses.dataclass
class LayerVertexConf(GraphVertexConf):
    """Wraps any Layer config (reference graph/vertex/impl/LayerVertex.java)."""

    layer: Optional[Layer] = None
    preprocessor: Optional[InputPreProcessor] = None

    def get_output_type(self, *input_types: InputType) -> InputType:
        t = input_types[0]
        if self.preprocessor is not None:
            t = self.preprocessor.get_output_type(t)
        return self.layer.get_output_type(t)


@serde.register_config
@dataclasses.dataclass
class ElementWiseVertexConf(GraphVertexConf):
    """Elementwise Add/Subtract/Product/Average/Max (reference ElementWiseVertex)."""

    op: str = "add"  # add | subtract | product | average | max


@serde.register_config
@dataclasses.dataclass
class ComputationGraphConfiguration:
    """The DAG config (reference nn/conf/ComputationGraphConfiguration.java)."""

    conf: NeuralNetConfiguration = dataclasses.field(default_factory=NeuralNetConfiguration)
    network_inputs: list = dataclasses.field(default_factory=list)
    network_outputs: list = dataclasses.field(default_factory=list)
    vertices: dict = dataclasses.field(default_factory=dict)  # {name: vertex conf}
    vertex_inputs: dict = dataclasses.field(default_factory=dict)  # {name: [input names]}
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20
    input_types: dict = dataclasses.field(default_factory=dict)  # {input name: InputType}

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return serde.from_json(s)

    def topological_order(self) -> list:
        """Kahn topo sort over vertices (reference ComputationGraph.java:458-483)."""
        indeg = {}
        children = {name: [] for name in list(self.vertices) + list(self.network_inputs)}
        for name in self.vertices:
            ins = list(self.vertex_inputs.get(name, []))
            indeg[name] = len(ins)
            for i in ins:
                children.setdefault(i, []).append(name)
        order = []
        frontier = sorted(self.network_inputs)
        while frontier:
            n = frontier.pop()
            order.append(n)
            for c in children.get(n, []):
                indeg[c] -= 1
                if indeg[c] == 0:
                    frontier.append(c)
        if len(order) != len(self.vertices) + len(self.network_inputs):
            raise ValueError("Graph has a cycle or disconnected vertex inputs")
        return order


class GraphBuilder:
    """Reference ComputationGraphConfiguration.GraphBuilder:446."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._g = ComputationGraphConfiguration(conf=conf)

    def add_inputs(self, *names) -> "GraphBuilder":
        self._g.network_inputs.extend(_flatten(names))
        return self

    def add_layer(self, name: str, layer: Layer, *inputs, preprocessor=None) -> "GraphBuilder":
        layer = self._g.conf.resolve_layer(layer)
        if layer.name is None:
            layer.name = name
        self._g.vertices[name] = LayerVertexConf(layer=layer, preprocessor=preprocessor)
        self._g.vertex_inputs[name] = list(_flatten(inputs))
        return self

    def add_vertex(self, name: str, vertex: GraphVertexConf, *inputs) -> "GraphBuilder":
        self._g.vertices[name] = vertex
        self._g.vertex_inputs[name] = list(_flatten(inputs))
        return self

    def set_outputs(self, *names) -> "GraphBuilder":
        self._g.network_outputs = list(_flatten(names))
        return self

    def backprop(self, flag: bool) -> "GraphBuilder":
        self._g.backprop = flag
        return self

    def pretrain(self, flag: bool) -> "GraphBuilder":
        self._g.pretrain = flag
        return self

    def backprop_type(self, t) -> "GraphBuilder":
        self._g.backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._g.tbptt_fwd_length = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._g.tbptt_back_length = n
        return self

    def set_input_types(self, **types) -> "GraphBuilder":
        self._g.input_types.update(types)
        return self

    def build(self) -> ComputationGraphConfiguration:
        g = copy.deepcopy(self._g)
        if not g.network_inputs:
            raise ValueError("Graph needs addInputs(...)")
        if not g.network_outputs:
            raise ValueError("Graph needs setOutputs(...)")
        if g.input_types:
            _infer_graph_shapes(g)
        return g


def _infer_graph_shapes(g: ComputationGraphConfiguration):
    """Propagate InputTypes through topo order: set n_in, insert adapters."""
    types: dict[str, InputType] = dict(g.input_types)
    for name in g.topological_order():
        if name in g.network_inputs:
            if name not in types:
                raise ValueError(f"set_input_types missing for input '{name}'")
            continue
        v = g.vertices[name]
        in_types = [types[i] for i in g.vertex_inputs[name]]
        if isinstance(v, LayerVertexConf):
            t = in_types[0]
            if v.preprocessor is None:
                v.preprocessor = _adapter(t, _expected_kind(v.layer))
            if v.preprocessor is not None:
                t = v.preprocessor.get_output_type(t)
            v.layer.set_n_in(t)
            types[name] = v.layer.get_output_type(t)
        else:
            types[name] = v.get_output_type(*in_types)


def _flatten(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from x
        else:
            yield x
