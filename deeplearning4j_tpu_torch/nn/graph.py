"""ComputationGraph — the DAG container (JAX counterpart
deeplearning4j_tpu/nn/graph.py; reference nn/graph/ComputationGraph.java
init:219-231, fit:545-672, forward over topo order:886).

The forward walks the configuration's topological order eagerly on the
net's device. Parameters are a plain dict {layer: {name: tensor}} in the
configuration's `param_dtype`, each layer's cast to the compute `dtype`
as it runs — the JAX package's dtype policy — and the optimizer state
sits beside them in the same dtype. Training is SGD-family: `fit`,
`fit_scanned`, `score` and `score_examples`, the backward by autograd
through the layers (nn/training.py); `evaluate` scores the first output.
Randomness (dropout) comes from one `torch.Generator` on the net's
device, seeded from the configuration's seed, where the JAX package
splits a PRNG key per step (`_next_rng`).

Not carried by this slice, and raising NotImplementedError: layerwise
pretraining, truncated BPTT, the non-SGD optimization algorithms (the
Solver path) and `remat`, which come with the rest of `nn/` (ROADMAP
Queue A item A6, `nn/training.check_trainable`); meshes (`set_mesh`)
with the parallel slice (item 7). `resume_from` reads the port's own
checkpoint format (util/checkpoint.py); `inference_fn` is the forward the
predict engine's replicas call (serving/engine.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    ElementWiseVertexConf,
    LayerVertexConf,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer,
    validate_layer_names,
)
from deeplearning4j_tpu_torch.nn.layers import (
    get_impl,
    l1_l2_penalty,
    pop_aux_losses,
)
from deeplearning4j_tpu_torch.nn.training import (
    LazyScore,
    check_trainable,
    make_train_step,
)
from deeplearning4j_tpu_torch.nn.updater import (
    build_optimizer,
    named_layer_confs,
)

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


class ComputationGraph(LazyScore):
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
        self.opt_state = None
        self.tx = None
        self.listeners = []
        self.iteration_count = 0
        self.score_value = float("nan")
        self._train_step = None
        self._generator = None

    @property
    def compute_dtype(self):
        return DTYPES[self.conf.conf.dtype]

    @property
    def param_dtype(self):
        return DTYPES[self.conf.conf.param_dtype]

    def init(self, seed: Optional[int] = None):
        """Sample every layer's params from one `torch.Generator` seeded
        with `seed` (default: the configuration's), in sorted layer
        order, and place them and the layers' state (batch norm's running
        statistics) on the net's device; build the optimizer
        and its state, and the device generator that dropout draws
        from."""
        g = self.conf.conf
        seed = g.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        params, state = {}, {}
        for name in sorted(self.layer_vertices):
            v = self.layer_vertices[name]
            validate_layer_names(v.layer)
            p, s = self.impls[name].init(v.layer, gen, self.param_dtype)
            params[name] = {k: t.to(self.device) for k, t in p.items()}
            state[name] = {k: t.to(self.device) for k, t in s.items()}
        self.params = params
        self.state = state
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.tx = build_optimizer(g, named_layer_confs(self))
        self.opt_state = self.tx.init(params)
        self._train_step = None
        return self

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

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

    def _forward(self, params, state, input_dict, masks=None, *,
                 train=False, generator=None, collect=False):
        """Forward over the topological order. Returns the list of
        network outputs, or (acts {vertex: activation}, new_state) when
        `collect`. `train` turns dropout on, drawing from `generator`."""
        masks = dict(masks) if masks else {}
        cdtype = self.compute_dtype
        acts = {}
        for k, v in input_dict.items():
            v = torch.as_tensor(v, device=self.device)
            acts[k] = v.to(cdtype) if v.is_floating_point() else v
        new_state = {}
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
                acts[name], new_state[name] = self.impls[name].apply(
                    vconf.layer, p, state.get(name, {}), x, train=train,
                    generator=generator, mask=in_mask)
            else:
                acts[name] = vertex_forward(vconf, inputs)
            m = masks.get(self.conf.vertex_inputs[name][0])
            y = acts[name]
            if (m is not None and y.ndim == 3
                    and tuple(y.shape[:2]) == tuple(m.shape)
                    and self._time_preserving(vconf, m.shape[1])):
                masks[name] = m
        if collect:
            for n in self.layer_vertices:
                new_state.setdefault(n, state.get(n, {}))
            return acts, new_state
        return [acts[o] for o in self.conf.network_outputs]

    def _output_losses(self, params, acts, batch, *, train, generator,
                       per_example=False):
        """Sum over the output layers of their losses on `acts`, each
        output layer's params cast to the compute dtype as the forward
        casts every other layer's."""
        total = 0.0
        labels_list = batch["labels"]
        lmasks = batch.get("labels_masks") or [None] * len(labels_list)
        cdtype = self.compute_dtype
        for out_name, labels, lmask in zip(self.conf.network_outputs,
                                           labels_list, lmasks):
            vconf = self.conf.vertices[out_name]
            if not isinstance(vconf, LayerVertexConf) or not isinstance(
                    vconf.layer, BaseOutputLayer):
                raise ValueError(f"Output '{out_name}' is not an output "
                                 "layer")
            x = acts[self.conf.vertex_inputs[out_name][0]]
            if vconf.preprocessor is not None:
                x = vconf.preprocessor.pre_process(x)
            p_out = params[out_name]
            if cdtype != self.param_dtype:
                p_out = cast_params(p_out, cdtype)
            total = total + self.impls[out_name].loss(
                vconf.layer, p_out, x, labels, train=train,
                generator=generator, mask=lmask, per_example=per_example)
        return total

    def _input_masks(self, batch):
        if batch.get("features_masks") is None:
            return {}
        return {k: m for k, m in zip(self.conf.network_inputs,
                                     batch["features_masks"])
                if m is not None}

    def _penalty(self, params):
        pen = 0.0
        for name, v in self.layer_vertices.items():
            pen = pen + l1_l2_penalty(v.layer, params[name])
        return pen

    def _loss(self, params, state, generator, batch, train=True):
        """Sum of output-layer losses + L1/L2 (reference
        computeGradientAndScore:816). Returns (loss, (new_state, {}))."""
        acts, new_state = self._forward(
            params, state, dict(zip(self.conf.network_inputs,
                                    batch["features"])),
            self._input_masks(batch), train=train, generator=generator,
            collect=True)
        loss = self._output_losses(params, acts, batch, train=train,
                                   generator=generator)
        loss = loss + self._penalty(params)
        aux, new_state = pop_aux_losses(new_state)
        if train:
            loss = loss + aux
        return loss, (new_state, {})

    # ------------------------------------------------------------------- fit
    @staticmethod
    def _to_mds(ds):
        if isinstance(ds, MultiDataSet):
            return ds
        return MultiDataSet(
            [ds.features], [ds.labels],
            None if ds.features_mask is None else [ds.features_mask],
            None if ds.labels_mask is None else [ds.labels_mask])

    def _batch_dict(self, mds: MultiDataSet):
        """A MultiDataSet's arrays as tensors on the net's device."""
        def dev(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a), device=self.device)

        b = {"features": tuple(dev(f) for f in mds.features),
             "labels": tuple(dev(lab) for lab in mds.labels)}
        if mds.features_masks is not None:
            b["features_masks"] = tuple(dev(m) for m in mds.features_masks)
        if mds.labels_masks is not None:
            b["labels_masks"] = tuple(dev(m) for m in mds.labels_masks)
        return b

    def resume_from(self, checkpoint_dir: str, step=None):
        """Restore the latest (or given) checkpoint (util/checkpoint.py)
        into this graph, as `MultiLayerNetwork.resume_from`: returns the
        restored step, 0 when the directory holds no checkpoint yet."""
        from deeplearning4j_tpu_torch.util.checkpoint import resume

        return resume(self, checkpoint_dir, step)

    def set_mesh(self, mesh, **kwargs):
        """Meshes (data, tensor, pipeline, expert and sequence
        parallelism) come with the parallel slice of the port."""
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP Queue A item 7, parallel "
            "and distributed)")

    def _get_train_step(self):
        if self._train_step is None:
            self._train_step = make_train_step(self._loss, self.tx,
                                               named_layer_confs(self))
        return self._train_step

    def fit(self, data, labels=None, epochs: int = 1):
        """Train (reference ComputationGraph.fit:545-672): one optimizer
        pass per batch (times the config's `iterations`) over a DataSet,
        a MultiDataSet or an iterator of them, `epochs` times."""
        if self.params is None:
            self.init()
        if labels is not None:
            data = DataSet(data, labels)
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        check_trainable(self.conf)
        if not self.conf.backprop:
            return self
        step = self._get_train_step()
        g = self.conf.conf
        for _ in range(epochs):
            data.reset()
            for ds in data:
                batch = self._batch_dict(self._to_mds(ds))
                for _i in range(max(1, g.iterations)):
                    self.params, self.opt_state, self.state, loss, _ = step(
                        self.params, self.opt_state, self.state,
                        self._generator, batch)
                    self.score_value = loss
                    self.iteration_count += 1
                    for lst in self.listeners:
                        lst.iteration_done(self, self.iteration_count)
        return self

    def fit_scanned(self, data, labels=None, epochs: int = 1):
        """Whole-epoch training over a list of uniform batches (the JAX
        package scans them in one dispatch; here a loop that reads no
        loss back until the end — nn/training.fused_fit)."""
        from deeplearning4j_tpu_torch.nn.training import fused_fit

        if self.params is None:
            self.init()
        if labels is not None:
            data = DataSet(data, labels)
        if isinstance(data, (DataSet, MultiDataSet)):
            data = ListDataSetIterator([data])
        batches = [self._batch_dict(self._to_mds(ds)) for ds in data]
        return fused_fit(self, batches, epochs)

    @torch.no_grad()
    def score(self, ds=None, training: bool = False):
        """The loss of a DataSet (no update), or the last training score
        when `ds` is None."""
        if ds is None:
            return self.score_value
        loss, _ = self._loss(self.params, self.state, None,
                             self._batch_dict(self._to_mds(ds)),
                             train=training)
        return float(loss)

    @torch.no_grad()
    def score_examples(self, ds, add_regularization: bool = False):
        """One score PER EXAMPLE [batch], summed across all output layers
        (reference ScoreExamplesFunction); inference-mode forward.
        `add_regularization` adds the network L1/L2 penalty to each."""
        batch = self._batch_dict(self._to_mds(ds))
        acts, _ = self._forward(
            self.params, self.state,
            dict(zip(self.conf.network_inputs, batch["features"])),
            self._input_masks(batch), collect=True)
        per = self._output_losses(self.params, acts, batch, train=False,
                                  generator=None, per_example=True)
        if add_regularization:
            per = per + self._penalty(self.params)
        return per.float().cpu().numpy()

    def evaluate(self, it, top_n: int = 1):
        """Classification evaluation of the first output against the
        first labels over a DataSet, a MultiDataSet or an iterator of
        them; top_n > 1 also tracks top-N accuracy."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        ev = Evaluation(top_n=top_n)
        if isinstance(it, (DataSet, MultiDataSet)):
            it = ListDataSetIterator([it])
        it.reset()
        while it.has_next():
            mds = self._to_mds(it.next())
            out = self.output(*mds.features)
            outs = out if isinstance(out, list) else [out]
            ev.eval(mds.labels[0], outs[0].float().cpu().numpy(),
                    mask=None if mds.labels_masks is None
                    else mds.labels_masks[0])
        return ev

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

    def incremental_decode_fn(self, kv_dtype: str = "f32",
                              page_size: int = 16):
        """The decode step ``(params, state, cache, token, pos) -> (probs,
        cache)`` over the KV cache (nn/decode.make_decode_fn);
        kv_dtype="int8" reads and writes the quantized paged cache."""
        from deeplearning4j_tpu_torch.nn.decode import make_decode_fn

        return make_decode_fn(self, kv_dtype, page_size)

    def prefill_fn(self, kv_dtype: str = "f32", page_size: int = 16):
        """The chunked-prefill step ``(params, state, cache, tokens, kmask,
        rows, start, last_idx) -> (probs_last, cache)``
        (nn/decode.make_prefill_fn)."""
        from deeplearning4j_tpu_torch.nn.decode import make_prefill_fn

        return make_prefill_fn(self, kv_dtype, page_size)

    def verify_decode_fn(self, kv_dtype: str = "f32", page_size: int = 16):
        """The speculative verification step ``(params, state, cache,
        tokens [B, K], pos) -> (probs [B, K, V], cache)``: K candidate
        tokens per row checked in one fixed-shape call
        (nn/decode.make_verify_fn)."""
        from deeplearning4j_tpu_torch.nn.decode import make_verify_fn

        return make_verify_fn(self, kv_dtype, page_size)

    def init_kv_cache(self, batch: int, capacity: int,
                      kv_dtype: str = "f32", page_size: int = 16):
        """Zeroed decode cache for `batch` rows of `capacity` key slots
        (nn/decode.init_cache)."""
        from deeplearning4j_tpu_torch.nn.decode import init_cache

        return init_cache(self, batch, capacity, kv_dtype, page_size)
