"""ComputationGraph — the DAG container, inference parts (JAX counterpart
deeplearning4j_tpu/nn/graph.py; reference nn/graph/ComputationGraph.java).

The forward walks the configuration's topological order eagerly on the
net's device. Parameters are a plain dict {layer: {name: tensor}} in the
configuration's `param_dtype`, each layer's cast to the compute `dtype`
as it runs — the JAX package's dtype policy. Training (`fit`, the
optimizer, meshes) comes with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    ElementWiseVertexConf,
    LayerVertexConf,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import validate_layer_names
from deeplearning4j_tpu_torch.nn.layers import get_impl

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def cast_params(p: dict, dtype) -> dict:
    """A layer's params with every floating tensor cast to `dtype`."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in p.items()}


def vertex_forward(vconf, inputs):
    """Non-layer vertex semantics (reference graph/vertex/impl/*): the
    elementwise vertex the Transformer LM's residual adds use."""
    if isinstance(vconf, ElementWiseVertexConf):
        op = vconf.op
        out = inputs[0]
        for x in inputs[1:]:
            if op in ("add", "average"):
                out = out + x
            elif op == "subtract":
                out = out - x
            elif op == "product":
                out = out * x
            elif op == "max":
                out = torch.maximum(out, x)
            else:
                raise ValueError(f"elementwise op {op}")
        if op == "average":
            out = out / len(inputs)
        return out
    raise ValueError(f"unhandled vertex {type(vconf).__name__} in this "
                     "port")


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.topo = conf.topological_order()
        self.layer_vertices = {
            name: v for name, v in conf.vertices.items()
            if isinstance(v, LayerVertexConf)}
        self.impls = {name: get_impl(v.layer)
                      for name, v in self.layer_vertices.items()}
        self.params = None
        self.state = None

    @property
    def compute_dtype(self):
        return DTYPES[self.conf.conf.dtype]

    @property
    def param_dtype(self):
        return DTYPES[self.conf.conf.param_dtype]

    def init(self, seed: Optional[int] = None):
        """Sample every layer's params from one `torch.Generator` seeded
        with `seed` (default: the configuration's), in sorted layer
        order, and place them on the net's device."""
        g = self.conf.conf
        gen = torch.Generator().manual_seed(g.seed if seed is None else seed)
        params, state = {}, {}
        for name in sorted(self.layer_vertices):
            v = self.layer_vertices[name]
            validate_layer_names(v.layer)
            p, s = self.impls[name].init(v.layer, gen, self.param_dtype)
            params[name] = {k: t.to(self.device) for k, t in p.items()}
            state[name] = s
        self.params = params
        self.state = state
        return self

    # --------------------------------------------------------------- forward
    def _time_preserving(self, vconf, T):
        """Whether a vertex maps [B, T, f] -> [B, T, f'] keeping the time
        axis, so a time mask carries through it."""
        if isinstance(vconf, ElementWiseVertexConf):
            return True
        if isinstance(vconf, LayerVertexConf):
            lc = vconf.layer
            ot = lc.get_output_type(
                InputType.recurrent(getattr(lc, "n_in", 0) or 0, T))
            return ot.kind == "recurrent" and ot.timeseries_length == T
        return False

    def _forward(self, params, state, input_dict, masks=None):
        """Inference forward over the topological order. Returns the list
        of network outputs."""
        masks = dict(masks) if masks else {}
        cdtype = self.compute_dtype
        acts = {}
        for k, v in input_dict.items():
            v = torch.as_tensor(v, device=self.device)
            acts[k] = v.to(cdtype) if v.is_floating_point() else v
        for name in self.topo:
            if name in self.conf.network_inputs:
                continue
            vconf = self.conf.vertices[name]
            inputs = [acts[i] for i in self.conf.vertex_inputs[name]]
            if isinstance(vconf, LayerVertexConf):
                x = inputs[0]
                if vconf.preprocessor is not None:
                    x = vconf.preprocessor.pre_process(x)
                p = params.get(name, {})
                if cdtype != self.param_dtype:
                    p = cast_params(p, cdtype)
                in_mask = masks.get(self.conf.vertex_inputs[name][0])
                acts[name], _ = self.impls[name].apply(
                    vconf.layer, p, state.get(name, {}), x, mask=in_mask)
            else:
                acts[name] = vertex_forward(vconf, inputs)
            m = masks.get(self.conf.vertex_inputs[name][0])
            y = acts[name]
            if (m is not None and y.ndim == 3
                    and tuple(y.shape[:2]) == tuple(m.shape)
                    and self._time_preserving(vconf, m.shape[1])):
                masks[name] = m
        return [acts[o] for o in self.conf.network_outputs]

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def output(self, *inputs):
        """Outputs for the given inputs (reference output), as tensors on
        the net's device: a list (one per network output), or the single
        tensor if there is one output."""
        ys = self._forward(self.params, self.state,
                           dict(zip(self.conf.network_inputs, inputs)))
        return ys[0] if len(ys) == 1 else ys

    def inference_fn(self):
        """A ``(params, state, x, mask=None) -> y`` inference forward for
        an external owner (a serving engine). Single input and output
        only: serving dispatches one padded input/output pair."""
        ins = self.conf.network_inputs
        outs = self.conf.network_outputs
        if len(ins) != 1 or len(outs) != 1:
            raise ValueError(
                f"serving needs a single-input/single-output graph; this "
                f"one has inputs {list(ins)} and outputs {list(outs)}")
        name = ins[0]

        @torch.no_grad()
        def fwd(params, state, x, mask=None):
            masks = {} if mask is None else {
                name: torch.as_tensor(mask, device=self.device)}
            return self._forward(params, state, {name: x}, masks)[0]
        return fwd

    def incremental_decode_fn(self):
        """The decode step ``(params, state, cache, token, pos) -> (probs,
        cache)`` over the KV cache (nn/decode.make_decode_fn)."""
        from deeplearning4j_tpu_torch.nn.decode import make_decode_fn

        return make_decode_fn(self)

    def prefill_fn(self):
        """The chunked-prefill step ``(params, state, cache, tokens, kmask,
        rows, start, last_idx) -> (probs_last, cache)``
        (nn/decode.make_prefill_fn)."""
        from deeplearning4j_tpu_torch.nn.decode import make_prefill_fn

        return make_prefill_fn(self)

    def init_kv_cache(self, batch: int, capacity: int):
        """Zeroed decode cache for `batch` rows of `capacity` key slots
        (nn/decode.init_cache)."""
        from deeplearning4j_tpu_torch.nn.decode import init_cache

        return init_cache(self, batch, capacity)

