"""ComputationGraph — the DAG container (JAX counterpart
deeplearning4j_tpu/nn/graph.py; reference nn/graph/ComputationGraph.java
init:219-231, fit:545-672, forward over topo order:886).

The forward walks the configuration's topological order eagerly on the
net's device. Parameters are a plain dict {layer: {name: tensor}} in the
configuration's `param_dtype`, each layer's cast to the compute `dtype`
as it runs — the JAX package's dtype policy — and the optimizer state
sits beside them in the same dtype. `fit`, `fit_scanned`, `score` and
`score_examples` train and score, the backward by autograd through the
layers (nn/training.py); `evaluate` scores the first output. Randomness
(dropout) comes from one `torch.Generator` on the net's device, seeded
from the configuration's seed, where the JAX package splits a PRNG key
per step (`_next_rng`).

As in the JAX package, `fit` pretrains the AutoEncoder and RBM vertices
first when the configuration asks for it, takes the Solver path for a
non-SGD optimization algorithm and truncated BPTT for sequences longer
than the window; `remat` recomputes each layer vertex's activations in
the backward; `rnn_time_step` streams through the recurrent vertices.
`fit` rides the pipelined input loader (data/pipeline.iter_prefetched):
the next batch's conversion runs on a producer thread while the step
computes. `set_mesh` (parallel/placement.py) takes the "data", "seq",
"model", "expert" and "pipe" roles and ZeRO-1: each rank then steps on
its rows (and time block) of the global batch with its shares of the
split layers, a pipelined net through the GPipe step of its stage
(parallel/pipeline.py); `output`, `score` and `evaluate` run on the
params with the other stages gathered, and shard the batch over the
data axis.
`resume_from` reads the port's own checkpoint format
(util/checkpoint.py); `inference_fn` is the forward the predict engine's
replicas call (serving/engine.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.data.pipeline import iter_prefetched
from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertexConf,
    ElementWiseVertexConf,
    LastTimeStepVertexConf,
    LayerVertexConf,
    MergeVertexConf,
    PreprocessorVertexConf,
    ScaleVertexConf,
    StackVertexConf,
    SubsetVertexConf,
    UnstackVertexConf,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.enums import (  # noqa: F401
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer,
    BaseRecurrentLayer,  # noqa: F401
    validate_layer_names,
)
from deeplearning4j_tpu_torch.nn.layers import (
    get_impl,
    l1_l2_penalty,
    pop_aux_losses,
)
from deeplearning4j_tpu_torch.nn.training import (
    LazyScore,
    batch_shape,
    detach_carries,
    fit_telemetry,
    is_sgd,
    is_tbptt,
    make_train_step,
    pretrain_layer,
    refuse_unstreamable,
    remat_apply,
    streams,
    tree_cast,
)
from deeplearning4j_tpu_torch.nn.updater import (
    build_optimizer,
    named_layer_confs,
)
from deeplearning4j_tpu_torch.parallel.placement import (
    canonical_opt_state,
    canonical_params,
    configure_mesh,
    inference_params,
    num_params as placement_num_params,
    set_canonical_params,
    local_dataset,
    mesh_axis,
    sharded_forward,
)
from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
    make_sp_train_step,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


# a layer's params (a nest of dicts), every floating tensor cast
cast_params = tree_cast


def pre_process(proc, x, train=False, generator=None):
    """A preprocessor's forward: its training forward (which may draw
    from `generator`) while training, its inference forward otherwise."""
    if train:
        return proc.pre_process_train(x, generator)
    return proc.pre_process(x)


def vertex_forward(vconf, inputs, masks=None, acts=None, *, train=False,
                   generator=None):
    """Non-layer vertex semantics (reference graph/vertex/impl/*; the
    JAX package's `_vertex_forward`). `masks` ({vertex or input: [B, T]
    mask}) gives LastTimeStep the mask of its `mask_input`; `acts`
    ({vertex: activation}) gives DuplicateToTimeSeries the time length
    of its `reference_input`."""
    if isinstance(vconf, MergeVertexConf):
        return torch.cat(inputs, dim=-1)
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
    if isinstance(vconf, SubsetVertexConf):
        return inputs[0][..., vconf.from_idx:vconf.to_idx + 1]
    if isinstance(vconf, PreprocessorVertexConf):
        return pre_process(vconf.preprocessor, inputs[0], train, generator)
    if isinstance(vconf, ScaleVertexConf):
        return inputs[0] * vconf.scale
    if isinstance(vconf, LastTimeStepVertexConf):
        x = inputs[0]                                      # [B, T, f]
        mask = (masks or {}).get(vconf.mask_input) if vconf.mask_input \
            else None
        if mask is None:
            return x[:, -1, :]
        idx = (mask.to(torch.int32).sum(dim=1) - 1).clamp_min(0)
        return x[torch.arange(x.shape[0], device=x.device), idx.long(), :]
    if isinstance(vconf, DuplicateToTimeSeriesVertexConf):
        T = acts[vconf.reference_input].shape[1]
        x = inputs[0]
        return x[:, None, :].expand(x.shape[0], T, x.shape[1])
    if isinstance(vconf, StackVertexConf):
        return torch.cat(inputs, dim=0)
    if isinstance(vconf, UnstackVertexConf):
        return inputs[0].chunk(vconf.stack_size, dim=0)[vconf.from_idx]
    raise ValueError(f"unhandled vertex type {type(vconf).__name__}")


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
        # output layers no vertex reads: the training loss takes their
        # input, so the loss's forward skips their activation (XLA drops
        # it from the JAX package's jitted step as dead code)
        read = {i for ins in conf.vertex_inputs.values() for i in ins}
        self._loss_only = {
            o for o in conf.network_outputs
            if o in self.layer_vertices and o not in read
            and isinstance(self.layer_vertices[o].layer, BaseOutputLayer)}
        self.params = None
        self.state = None
        self.opt_state = None
        self.tx = None
        self.listeners = []
        self.iteration_count = 0
        self.score_value = float("nan")
        self._train_step = None
        self._generator = None
        self._rnn_carries = None  # rnn_time_step's state between calls
        self._mesh = None
        self._mesh_axes = None
        self._overlap_plan = None
        self._split_plan = None  # the "model" / "expert" placement
        self._zero1 = None
        self._pipe = None  # the "pipe" placement (parallel/pipeline.py)
        self._pipe_mesh = None
        self._canonical_like = None

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
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        for name in sorted(self.layer_vertices):
            v = self.layer_vertices[name]
            validate_layer_names(v.layer)
            p, s = self.impls[name].init(v.layer, gen, self.param_dtype)
            params[name] = tree.tree_map(to_dev, p)
            state[name] = tree.tree_map(to_dev, s)
        self.params = params
        self.state = state
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.tx = build_optimizer(g, named_layer_confs(self))
        self.opt_state = self.tx.init(params)
        self._train_step = None
        self._rnn_carries = None
        return self

    def set_optimizer(self, tx):
        """Custom updater hook (reference Updater.CUSTOM): train with
        `tx`, any object with the port's optimizer protocol
        (nn/updater.py `Optimizer`: `init`, `update`), from a fresh
        optimizer state (nn/updater.set_optimizer)."""
        from deeplearning4j_tpu_torch.nn.updater import set_optimizer

        set_optimizer(self, tx)

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    # --------------------------------------------------------------- forward
    def _time_preserving(self, vconf, T):
        """Whether a vertex maps [B, T, f] -> [B, T, f'] keeping the time
        axis, so a time mask carries through it: elementwise, merge and
        scale vertices by construction, layer vertices by their declared
        output type."""
        if isinstance(vconf, (ElementWiseVertexConf, MergeVertexConf,
                              ScaleVertexConf)):
            return True
        if isinstance(vconf, LayerVertexConf):
            lc = vconf.layer
            ot = lc.get_output_type(
                InputType.recurrent(getattr(lc, "n_in", 0) or 0, T))
            return ot.kind == "recurrent" and ot.timeseries_length == T
        return False

    def _walk(self, params, state, input_dict, masks=None, *,
              train=False, generator=None, carries=None, skip=()):
        """Forward over the topological order, the vertices in `skip`
        left out: (acts {vertex: activation}, new_state, new_carries).
        `train` turns dropout on, drawing from `generator`; with
        `carries` ({vertex: carry}), each recurrent vertex that can
        stream starts from its carry (zeros where it has none) and
        returns its last."""
        masks = dict(masks) if masks else {}
        cdtype = self.compute_dtype
        acts = {}
        for k, v in input_dict.items():
            v = torch.as_tensor(v, device=self.device)
            acts[k] = v.to(cdtype) if v.is_floating_point() else v
        new_state, new_carries = {}, {}
        names = [n for n in self.topo
                 if n not in self.conf.network_inputs and n not in skip]
        self._run_vertices(names, params, state, acts, masks, new_state,
                           train=train, generator=generator, carries=carries,
                           new_carries=new_carries)
        for n in self.layer_vertices:
            new_state.setdefault(n, state.get(n, {}))
        return acts, new_state, new_carries

    def _run_vertices(self, names, params, state, acts, masks, new_state, *,
                      train=False, generator=None, carries=None,
                      new_carries=None):
        """Run the vertices `names` (in topological order) on `acts`
        ({vertex: activation}, which must hold their inputs), adding
        their activations to `acts`, their layer state to `new_state`
        and the masks that carry through them to `masks`: the body of
        `_walk`, which a pipeline stage runs over its own region
        (parallel/pipeline.py)."""
        cdtype = self.compute_dtype
        remat = self.conf.conf.remat and torch.is_grad_enabled()
        for name in names:
            vconf = self.conf.vertices[name]
            inputs = [acts[i] for i in self.conf.vertex_inputs[name]]
            if isinstance(vconf, LayerVertexConf):
                x = inputs[0]
                if vconf.preprocessor is not None:
                    x = pre_process(vconf.preprocessor, x, train, generator)
                p = params.get(name, {})
                if cdtype != self.param_dtype:
                    p = cast_params(p, cdtype)
                impl = self.impls[name]
                kw = {}
                if carries is not None and streams(vconf.layer, impl):
                    kw = {"initial_carry": carries.get(name),
                          "return_carry": True}

                def run(gen, _impl=impl, _lc=vconf.layer, _p=p,
                        _s=state.get(name, {}), _x=x,
                        _m=masks.get(self.conf.vertex_inputs[name][0]),
                        _kw=kw):
                    return _impl.apply(_lc, _p, _s, _x, train=train,
                                       generator=gen, mask=_m, **_kw)

                out = remat_apply(run, generator) if remat else run(
                    generator)
                if kw:
                    acts[name], new_state[name], new_carries[name] = out
                else:
                    acts[name], new_state[name] = out
            else:
                acts[name] = vertex_forward(vconf, inputs, masks, acts,
                                            train=train, generator=generator)
            m = masks.get(self.conf.vertex_inputs[name][0])
            y = acts[name]
            if (m is not None and y.ndim == 3
                    and tuple(y.shape[:2]) == tuple(m.shape)
                    and self._time_preserving(vconf, m.shape[1])):
                masks[name] = m

    def _forward(self, params, state, input_dict, masks=None, *,
                 train=False, generator=None, collect=False):
        """`_walk` without carries: the list of network outputs, or
        (acts, new_state) when `collect`."""
        acts, new_state, _ = self._walk(params, state, input_dict, masks,
                                        train=train, generator=generator)
        if collect:
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
                x = pre_process(vconf.preprocessor, x, train, generator)
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
        computeGradientAndScore:816). Returns (loss, (new_state,
        extras)); extras holds the RNN carries when the batch brings
        `carries` (TBPTT)."""
        acts, new_state, new_carries = self._walk(
            params, state, dict(zip(self.conf.network_inputs,
                                    batch["features"])),
            self._input_masks(batch), train=train, generator=generator,
            carries=batch.get("carries"), skip=self._loss_only)
        loss = self._output_losses(params, acts, batch, train=train,
                                   generator=generator)
        loss = loss + self._penalty(params)
        aux, new_state = pop_aux_losses(new_state)
        if train:
            loss = loss + aux
        extras = {"carries": new_carries} if "carries" in batch else {}
        return loss, (new_state, extras)

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

    def resume_from(self, checkpoint_dir: str, step=None, *,
                    target_mesh=None, target_axes=None):
        """Restore the latest (or given) checkpoint (util/checkpoint.py)
        into this graph, as `MultiLayerNetwork.resume_from`: returns the
        restored step, 0 when the directory holds no checkpoint yet;
        `target_mesh` / `target_axes` restore into that placement."""
        from deeplearning4j_tpu_torch.util.checkpoint import resume

        return resume(self, checkpoint_dir, step, target_mesh=target_mesh,
                      target_axes=target_axes)

    def set_mesh(self, mesh, zero1: bool = False, axes=None,
                 n_microbatches=None, tp_rules=None, overlap=None):
        """Map parallelism roles ("data", "seq", "model", "expert") to
        mesh axis names (parallel/placement.configure_mesh); `zero1`
        splits the optimizer state over "data"; `tp_rules` are placement
        rules that come before the roles' own; `overlap` (True / bucket
        bytes / a BucketPlan) reduces the data-parallel gradients bucket
        by bucket during the backward. set_mesh(None) clears the mesh.
        Returns the net."""
        return configure_mesh(self, mesh, zero1=zero1, axes=axes,
                              n_microbatches=n_microbatches,
                              tp_rules=tp_rules, overlap=overlap)

    def _get_train_step(self):
        if self._train_step is None:
            if self._pipe is not None:
                from deeplearning4j_tpu_torch.parallel.pipeline import (
                    make_pp_train_step,
                )

                self._train_step = make_pp_train_step(self, self._pipe)
            elif mesh_axis(self, "seq") is not None:
                self._train_step = make_sp_train_step(
                    self, self._mesh, seq_axis=mesh_axis(self, "seq"),
                    data_axis=mesh_axis(self, "data"),
                    model_axis=mesh_axis(self, "model"))
            else:
                self._train_step = make_train_step(
                    self._loss, self.tx, named_layer_confs(self),
                    mesh=self._mesh, data_axis=mesh_axis(self, "data"),
                    overlap=self._overlap_plan, zero1=self._zero1)
        return self._train_step

    def fit(self, data, labels=None, epochs: int = 1):
        """Train (reference ComputationGraph.fit:545-672) over a DataSet,
        a MultiDataSet or an iterator of them, `epochs` times:
        layerwise pretraining first when the configuration asks for it;
        then, with backprop on, one optimizer pass per batch (times the
        config's `iterations`), the Solver path for a non-SGD
        optimization algorithm, or truncated BPTT for 3-D sequences
        longer than `tbptt_fwd_length`."""
        if self.params is None:
            self.init()
        if labels is not None:
            data = DataSet(data, labels)
        single_batch = isinstance(data, (DataSet, MultiDataSet))
        if single_batch:
            # one batch: the pipeline's synchronous path skips the
            # producer thread
            data = ListDataSetIterator([data])
        if self.conf.pretrain:
            self.pretrain(data)
        if not self.conf.backprop:
            return self
        if not is_sgd(self.conf):
            return self._fit_with_solver(data, epochs)
        step = self._get_train_step()
        tbptt = is_tbptt(self.conf)
        g = self.conf.conf
        local = getattr(data, "process_local", False)

        def convert(ds):
            # producer-thread work: this rank's rows, the MultiDataSet
            # coercion, the tensors on the device; batch None = a TBPTT
            # sequence (its windows convert on the step thread)
            mds = self._to_mds(local_dataset(self, ds, local))
            if tbptt and self._needs_tbptt(mds):
                return mds, None
            return mds, self._batch_dict(mds)

        # the first step of each batch shape is counted (cost book); the
        # memory sampler runs at the DL4J_TPU_MEM_EVERY cadence
        book, mem = fit_telemetry(self)
        for _ in range(epochs):
            data.reset()
            for _ds, (mds, batch) in iter_prefetched(
                    data, convert, depth=0 if single_batch else None):
                if batch is None:
                    self._fit_tbptt(mds, step)
                    continue
                for _i in range(max(1, g.iterations)):
                    with book.count("fit", batch_shape(batch),
                                    device=self.device, args=(batch,)):
                        self.params, self.opt_state, self.state, loss, _ = \
                            step(self.params, self.opt_state, self.state,
                                 self._generator, batch)
                    self._after_step(loss)
                    mem.on_step(self.iteration_count)
        return self

    def _fit_with_solver(self, it, epochs: int):
        """The line-search and second-order path (reference Solver
        dispatch): each minibatch is optimized by the configured solver
        over the flat parameter vector."""
        from deeplearning4j_tpu_torch.optimize.solvers import Solver

        if is_tbptt(self.conf):
            raise ValueError(
                "TRUNCATED_BPTT requires STOCHASTIC_GRADIENT_DESCENT; "
                "second-order solvers would differentiate the full sequence")
        solver = Solver(self)
        local = getattr(it, "process_local", False)
        for _ in range(epochs):
            it.reset()
            # on a mesh this rank's part of the batch (Solver: the solve
            # runs over the mesh)
            for _ds, batch in iter_prefetched(
                    it, lambda ds: self._batch_dict(self._to_mds(
                        local_dataset(self, ds, local)))):
                solver.optimize(batch, generator=self._generator)
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration_count)
        return self

    def _needs_tbptt(self, mds) -> bool:
        L = self.conf.tbptt_fwd_length
        return any(np.asarray(f).ndim == 3 and f.shape[1] > L
                   for f in mds.features)

    def _initial_carries(self, batch_size):
        """Zero carries for every recurrent layer vertex that can
        stream."""
        return {name: self.impls[name].initial_carry(
                    v.layer, batch_size, self.compute_dtype, self.device)
                for name, v in self.layer_vertices.items()
                if streams(v.layer, self.impls[name])}

    def _fit_tbptt(self, mds: MultiDataSet, step):
        """Truncated BPTT over the DAG: a `tbptt_fwd_length` window
        slides over time, one optimizer step a window; the recurrent
        vertices' carries flow between windows, the gradients stop at
        their boundaries. 2-D inputs go to every window whole."""
        for lab in mds.labels:
            if np.asarray(lab).ndim != 3:
                raise ValueError(
                    "TRUNCATED_BPTT needs time-distributed labels "
                    f"[batch, time, n_out]; got shape "
                    f"{np.asarray(lab).shape}. A per-sequence label would "
                    "be counted once per segment against mid-sequence "
                    "activations — train with standard BPTT (or a "
                    "LastTimeStep head on full sequences) instead")
        T = max(f.shape[1] for f in mds.features if np.asarray(f).ndim == 3)
        L = self.conf.tbptt_fwd_length
        carries = self._initial_carries(mds.features[0].shape[0])

        def window(arrs, t0, min_ndim):
            if arrs is None:
                return None
            return [None if a is None else
                    a[:, t0:t0 + L] if (np.asarray(a).ndim >= min_ndim
                                        and a.shape[1] == T) else a
                    for a in arrs]

        for t0 in range(0, T, L):
            batch = self._batch_dict(MultiDataSet(
                window(mds.features, t0, 3), window(mds.labels, t0, 3),
                window(mds.features_masks, t0, 2),
                window(mds.labels_masks, t0, 2)))
            batch["carries"] = carries
            self.params, self.opt_state, self.state, loss, extras = step(
                self.params, self.opt_state, self.state, self._generator,
                batch)
            carries = detach_carries(extras["carries"])
            self._after_step(loss)

    def pretrain(self, it, epochs: int = 1):
        """Greedy layer-wise pretraining over the DAG (reference
        ComputationGraph.pretrain): each pretrain vertex (AutoEncoder,
        RBM) in topological order is trained on its own loss over the
        activations feeding it."""
        if self.params is None:
            self.init()
        if isinstance(it, (DataSet, MultiDataSet)):
            it = ListDataSetIterator([it])
        for name in self.topo:
            v = self.conf.vertices.get(name)
            if not (isinstance(v, LayerVertexConf)
                    and v.layer.is_pretrain_layer()):
                continue
            src = self.conf.vertex_inputs[name][0]

            def featurize(ds, _src=src, _v=v):
                acts, _ = self._forward(
                    self.params, self.state,
                    dict(zip(self.conf.network_inputs,
                             self._to_mds(ds).features)), collect=True)
                x = acts[_src]
                if _v.preprocessor is not None:
                    x = _v.preprocessor.pre_process(x)
                return x

            pretrain_layer(self, it, epochs, name, v.layer,
                           self.impls[name], featurize)
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
        local = getattr(data, "process_local", False)
        batches = [self._batch_dict(self._to_mds(local_dataset(self, ds,
                                                               local)))
                   for ds in data]
        return fused_fit(self, batches, epochs)

    # ------------------------------------------------- streaming RNN inference
    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    def _stream_inputs(self, inputs, rank3_only=False):
        cdtype = self.compute_dtype
        arrs = []
        for x in inputs:
            x = torch.as_tensor(x, device=self.device)
            arrs.append(x.to(cdtype) if x.is_floating_point() else x)
        ranks = {a.ndim for a in arrs}
        if rank3_only and ranks != {3}:
            raise ValueError("rnn_activate_using_stored_state expects "
                             f"[batch, time, n_in] inputs; got ranks "
                             f"{sorted(ranks)}")
        if len(ranks) > 1:
            raise ValueError(
                f"rnn_time_step: mixed input ranks {sorted(ranks)} — pass all "
                "inputs as [batch, n_in] or all as [batch, time, n_in]")
        carries = self._rnn_carries
        if carries is None:
            carries = self._initial_carries(arrs[0].shape[0])
        return arrs, ranks == {2}, carries

    @torch.no_grad()
    def rnn_time_step(self, *inputs):
        """Stateful inference a step or a chunk at a time over the DAG
        (reference ComputationGraph.rnnTimeStep): each input [batch,
        n_in] (one step) or [batch, time, n_in], one rank for all; the
        recurrent vertices' carries persist between calls until
        `rnn_clear_previous_state`. Raises for a layer that cannot stream
        causally (the bidirectional LSTM, self-attention)."""
        refuse_unstreamable((n, v.layer, self.impls[n])
                             for n, v in self.layer_vertices.items())
        arrs, single, carries = self._stream_inputs(inputs)
        if single:
            arrs = [a[:, None, :] for a in arrs]
        acts, _, new_carries = self._walk(
            self.params, self.state, dict(zip(self.conf.network_inputs,
                                              arrs)), carries=carries)
        self._rnn_carries = {**carries, **new_carries}
        outs = [acts[o] for o in self.conf.network_outputs]
        outs = [y[:, -1, :] if single and y.ndim == 3 else y for y in outs]
        return outs[0] if len(outs) == 1 else outs

    @torch.no_grad()
    def rnn_activate_using_stored_state(self, *inputs,
                                        training: bool = False,
                                        store_last_for_tbptt: bool = False):
        """The acts {vertex: activation} over full sequences from the
        stored streaming state; the state moves on only with
        `store_last_for_tbptt`."""
        arrs, _, carries = self._stream_inputs(inputs, rank3_only=True)
        acts, _, new_carries = self._walk(
            self.params, self.state, dict(zip(self.conf.network_inputs,
                                              arrs)),
            train=training, generator=self._generator if training else None,
            carries=carries)
        if store_last_for_tbptt:
            self._rnn_carries = {**carries, **new_carries}
        return acts

    # -------------------------------------------------------- params plumbing
    def num_params(self) -> int:
        return placement_num_params(self)

    def canonical_params(self):
        """The params whole in the JAX layout, under a "model" / "expert"
        placement too (parallel/placement.canonical_params; every rank
        calls it)."""
        return canonical_params(self)

    def canonical_opt_state(self):
        """The optimizer state whole (placement.canonical_opt_state)."""
        return canonical_opt_state(self)

    def params_flat(self) -> np.ndarray:
        """The flat parameter vector in the JAX package's order (keys
        sorted at every level), f32 (bf16 widens exactly) or f64; whole
        under a placement."""
        return tree.params_flat(self.canonical_params())

    def set_params_flat(self, flat):
        set_canonical_params(
            self, tree.set_params_flat(self.canonical_params(), flat))

    @torch.no_grad()
    def score(self, ds=None, training: bool = False):
        """The loss of a DataSet (no update), or the last training score
        when `ds` is None."""
        if ds is None:
            return self.score_value
        loss, _ = self._loss(inference_params(self), self.state, None,
                             self._batch_dict(self._to_mds(ds)),
                             train=training)
        return float(loss)

    @torch.no_grad()
    def score_examples(self, ds, add_regularization: bool = False):
        """One score PER EXAMPLE [batch], summed across all output layers
        (reference ScoreExamplesFunction); inference-mode forward.
        `add_regularization` adds the network L1/L2 penalty to each."""
        batch = self._batch_dict(self._to_mds(ds))
        params = inference_params(self)
        acts, _ = self._forward(
            params, self.state,
            dict(zip(self.conf.network_inputs, batch["features"])),
            self._input_masks(batch), collect=True)
        per = self._output_losses(params, acts, batch, train=False,
                                  generator=None, per_example=True)
        if add_regularization:
            per = per + self._penalty(params)
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
        from deeplearning4j_tpu_torch.telemetry import get_default

        get_default().eval(ev, top_n=top_n)  # a no-op unless telemetry is on
        return ev

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def output(self, *inputs):
        """Outputs for the given inputs (reference output), as tensors on
        the net's device: a list (one per network output), or the single
        tensor if there is one output. Under a data mesh each rank runs
        its rows and the outputs are all-gathered
        (parallel/placement.sharded_forward)."""
        params = inference_params(self)
        ys = sharded_forward(self, inputs, lambda *xs: self._forward(
            params, self.state, dict(zip(self.conf.network_inputs, xs))))
        return ys[0] if len(ys) == 1 else ys

    def predict(self, *inputs):
        """The argmax over the last axis of `output`, as numpy: an array,
        or a list of them for several outputs (the JAX package's
        `predict`)."""
        out = self.output(*inputs)
        if isinstance(out, list):
            return [o.argmax(dim=-1).cpu().numpy() for o in out]
        return out.argmax(dim=-1).cpu().numpy()

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

