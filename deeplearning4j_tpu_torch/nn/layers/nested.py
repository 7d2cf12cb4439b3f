"""Networks as layers (JAX counterpart deeplearning4j_tpu/nn/layers/nested.py;
reference MultiLayerNetwork.java:78 `implements Layer`).

A `NetworkLayer` config wraps an inner MultiLayerConfiguration or
ComputationGraphConfiguration: `init` builds the inner network's params
and state as this layer's subtree of the outer network's, and `apply`
runs the inner forward on them, so autograd differentiates straight
through the nested network and its params train with the outer
optimizer.

- The inner net's output layer contributes its activation (softmax
  etc.), not its loss, as the reference's activate() of a nested net.
- The inner layers' l1/l2 penalties are not applied by the outer
  container (set them on the outer NetworkLayer if needed).
- An inner graph must have one input and one output.
- The inner params come from the inner configuration's own seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.conf.serde import register_config
from deeplearning4j_tpu_torch.nn.layers.base import LayerImpl, register_impl


@register_config
@dataclasses.dataclass
class NetworkLayer(Layer):
    """A whole network used as one layer."""

    conf: Optional[Any] = None  # MultiLayerConfiguration | ComputationGraphConfiguration

    def _inner(self, device):
        """The inner container on `device` (built once and cached):
        structure only, its params and state live in the outer
        network's trees."""
        net = getattr(self, "_inner_cache", None)
        if net is None:
            from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
                ComputationGraphConfiguration,
            )
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )

            if self.conf is None:
                raise ValueError("NetworkLayer needs conf=<inner network "
                                 "configuration>")
            if isinstance(self.conf, ComputationGraphConfiguration):
                if (len(self.conf.network_inputs) != 1
                        or len(self.conf.network_outputs) != 1):
                    raise ValueError(
                        "a nested graph must have exactly one input and "
                        "one output to act as a layer")
                net = ComputationGraph(self.conf, device=device)
            else:
                net = MultiLayerNetwork(self.conf, device=device)
            object.__setattr__(self, "_inner_cache", net)
        net.device = device
        return net

    def get_output_type(self, input_type: InputType) -> InputType:
        """The outer shape inference carried through the nested network,
        preprocessors included."""
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
            ComputationGraphConfiguration,
            LayerVertexConf,
        )

        if isinstance(self.conf, ComputationGraphConfiguration):
            g = self.conf
            types = {g.network_inputs[0]: input_type}
            for name in g.topological_order():
                if name in g.network_inputs:
                    continue
                v = g.vertices[name]
                in_types = [types[i] for i in g.vertex_inputs[name]]
                if isinstance(v, LayerVertexConf):
                    t = in_types[0]
                    if v.preprocessor is not None:
                        t = v.preprocessor.get_output_type(t)
                    types[name] = v.layer.get_output_type(t)
                else:
                    types[name] = v.get_output_type(*in_types)
            return types[g.network_outputs[0]]
        t = input_type
        for i, lc in enumerate(self.conf.layers):
            proc = self.conf.get_preprocessor(i)
            if proc is not None:
                t = proc.get_output_type(t)
            t = lc.get_output_type(t)
        return t


@register_impl(NetworkLayer)
class NetworkLayerImpl(LayerImpl):
    def init(self, conf, gen, dtype):
        # the inner configuration's own seed drives its init; the outer
        # container moves the tensors to its device
        net = conf._inner("cpu")
        net.init()
        params, state = net.params, net.state
        net.params = net.state = net.opt_state = None
        return params, state

    def apply(self, conf, params, state, x, *, train=False, generator=None,
              mask=None):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        net = conf._inner(x.device)
        if isinstance(net, ComputationGraph):
            inp = net.conf.network_inputs[0]
            masks = {inp: mask} if mask is not None else None
            acts, new_state, _ = net._walk(params, state, {inp: x}, masks,
                                           train=train, generator=generator)
            return acts[net.conf.network_outputs[0]], new_state
        y, new_state, _ = net._walk(params, state, x, train=train,
                                    generator=generator, mask=mask)
        return y, new_state
