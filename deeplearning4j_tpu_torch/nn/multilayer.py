"""MultiLayerNetwork — the sequential-stack container (JAX counterpart
deeplearning4j_tpu/nn/multilayer.py; reference
nn/multilayer/MultiLayerNetwork.java init:349, fit:1011,
feedForward:614, computeGradientAndScore:1781, output:1500-1582,
evaluate:2311).

It follows the port's ComputationGraph (nn/graph.py) in idiom: the
forward walks the layer list eagerly on the net's device; parameters are
a plain dict {layer name: {param: tensor}} in the configuration's
`param_dtype`, each layer's cast to the compute `dtype` as it runs, and
batch norm's running statistics sit beside them in `state`, in f32.
Training is SGD-family, `fit` and `fit_scanned`, the backward by
autograd through the layers (nn/training.py). Randomness (dropout) comes
from one `torch.Generator` on the net's device, seeded from the
configuration's seed, where the JAX package splits a PRNG key per step.
Layer names are the JAX package's ("layer_i" unless a layer names
itself), so a JAX net's params copy across by name (weights_io.py).

`fit` also takes the other paths of the JAX package's: layerwise
pretraining of the AutoEncoder and RBM layers first when the
configuration asks for it (`pretrain`), the Solver path for the non-SGD
optimization algorithms (optimize/solvers.py), and truncated BPTT for
sequences longer than the window (`_fit_tbptt`: the recurrent layers'
carries flow from segment to segment, the gradients stop at the
boundary). `remat` recomputes each layer's activations in the backward
(nn/training.remat_apply). `rnn_time_step` streams a sequence through
the recurrent layers with carries kept between calls. `fit` rides the
pipelined input loader (data/pipeline.iter_prefetched). `set_mesh`
(parallel/placement.py) takes the "data" role — each rank steps on its
rows of the global batch, and `output` / `evaluate` shard the batch
over the data axis — ZeRO-1, and the "model" and "expert" roles where
the placement rules name its layers ("seq" and "pipe" need the graph
container and raise the JAX package's ValueError). A transformer stack
decodes
incrementally (`incremental_decode_fn`, `prefill_fn`, `verify_decode_fn`,
`init_kv_cache`; nn/decode.py), so `GenerationEngine` serves it.
`resume_from` reads the port's own checkpoint format
(util/checkpoint.py); `inference_fn` is the forward the predict engine's
replicas call (serving/engine.py).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.data.pipeline import iter_prefetched
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn import tree
from deeplearning4j_tpu_torch.nn.conf.enums import (  # noqa: F401
    BackpropType,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer,
    BaseRecurrentLayer,  # noqa: F401
    RnnOutputLayer,
    validate_layer_names,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import DTYPES, cast_params, pre_process
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
    tree_cast,  # noqa: F401
)
from deeplearning4j_tpu_torch.nn.updater import build_optimizer
from deeplearning4j_tpu_torch.parallel.placement import (
    canonical_opt_state,
    canonical_params,
    configure_mesh,
    num_params as placement_num_params,
    set_canonical_params,
    local_dataset,
    mesh_axis,
    sharded_forward,
)


class MultiLayerNetwork(LazyScore):
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self.layer_confs = list(conf.layers)
        self.layer_names = [lc.name if lc.name else f"layer_{i}"
                            for i, lc in enumerate(self.layer_confs)]
        self.impls = [get_impl(lc) for lc in self.layer_confs]
        self.params = None
        self.state = None
        self.opt_state = None
        self.tx = None
        self.listeners = []
        self.iteration_count = 0
        self.epoch_count = 0
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

    def _layer_confs_by_name(self):
        return dict(zip(self.layer_names, self.layer_confs))

    def init(self, seed: Optional[int] = None):
        """Sample every layer's params from one `torch.Generator` seeded
        with `seed` (default: the configuration's), in layer order, and
        place them and the layers' state on the net's device; build the
        optimizer and its state, and the device generator that dropout
        draws from (reference init:349)."""
        g = self.conf.conf
        seed = g.seed if seed is None else seed
        gen = torch.Generator().manual_seed(seed)
        for lc in self.layer_confs:
            validate_layer_names(lc)
        params, state = {}, {}
        to_dev = lambda t: t.to(self.device)  # noqa: E731
        for name, lc, impl in zip(self.layer_names, self.layer_confs,
                                  self.impls):
            p, s = impl.init(lc, gen, self.param_dtype)
            params[name] = tree.tree_map(to_dev, p)
            state[name] = tree.tree_map(to_dev, s)
        self.params = params
        self.state = state
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.tx = build_optimizer(g, self._layer_confs_by_name())
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
    def _as_input(self, x):
        x = torch.as_tensor(x, device=self.device)
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def _walk(self, params, state, x, *, train=False, generator=None,
              mask=None, carries=None, collect=False, to_layer=None):
        """Walk the stack (reference feedForwardToLayer:637) up to
        `to_layer` (default: all). Returns (the activations of every
        layer if `collect` else the last one, new_state, new_carries);
        layers past `to_layer` keep their state. With `carries` ({layer:
        carry}), each recurrent layer that can stream starts from its
        carry (zeros where it has none) and returns its last."""
        x = self._as_input(x)
        cdtype = self.compute_dtype
        remat = self.conf.conf.remat and torch.is_grad_enabled()
        n = len(self.layer_confs) if to_layer is None else to_layer
        acts, new_state, new_carries = [], {}, {}
        for i in range(n):
            name, lc, impl = (self.layer_names[i], self.layer_confs[i],
                              self.impls[i])
            proc = self.conf.get_preprocessor(i)
            if proc is not None:
                x = pre_process(proc, x, train, generator)
            p = params.get(name, {})
            if cdtype != self.param_dtype:
                p = cast_params(p, cdtype)
            kw = {}
            if carries is not None and streams(lc, impl):
                kw = {"initial_carry": carries.get(name),
                      "return_carry": True}

            def run(gen, _impl=impl, _lc=lc, _p=p, _s=state.get(name, {}),
                    _x=x, _kw=kw):
                return _impl.apply(_lc, _p, _s, _x, train=train,
                                   generator=gen, mask=mask, **_kw)

            out = remat_apply(run, generator) if remat else run(generator)
            if kw:
                x, new_state[name], new_carries[name] = out
            else:
                x, new_state[name] = out
            if collect:
                acts.append(x)
        for name in self.layer_names[n:]:
            new_state[name] = state.get(name, {})
        return (acts if collect else x), new_state, new_carries

    def _forward(self, params, state, x, *, train=False, generator=None,
                 mask=None, collect=False, to_layer=None):
        """`_walk` without carries: (output or activations, new_state)."""
        out, new_state, _ = self._walk(
            params, state, x, train=train, generator=generator, mask=mask,
            collect=collect, to_layer=to_layer)
        return out, new_state

    def _head(self, params, state, batch, *, train, generator,
              per_example=False):
        """The output layer's loss on the stack below it: (loss, or one
        score per example, new_state, new_carries)."""
        out_conf = self.layer_confs[-1]
        if not isinstance(out_conf, BaseOutputLayer):
            raise ValueError("Last layer must be an OutputLayer to compute "
                             "a score")
        n = len(self.layer_confs)
        fmask = batch.get("features_mask")
        lmask = batch.get("labels_mask")
        h, new_state, new_carries = self._walk(
            params, state, batch["features"], train=train,
            generator=generator, mask=fmask, carries=batch.get("carries"),
            to_layer=n - 1)
        proc = self.conf.get_preprocessor(n - 1)
        if proc is not None:
            h = pre_process(proc, h, train, generator)
        mask = lmask if lmask is not None else (
            fmask if isinstance(out_conf, RnnOutputLayer) else None)
        out_name = self.layer_names[-1]
        p_out = params[out_name]
        if self.compute_dtype != self.param_dtype:
            p_out = cast_params(p_out, self.compute_dtype)
        loss = self.impls[-1].loss(out_conf, p_out, h, batch["labels"],
                                   train=train, generator=generator,
                                   mask=mask, per_example=per_example)
        new_state[out_name] = state.get(out_name, {})
        return loss, new_state, new_carries

    def _penalty(self, params):
        pen = 0.0
        for name, lc in zip(self.layer_names, self.layer_confs):
            pen = pen + l1_l2_penalty(lc, params[name])
        return pen

    def _loss(self, params, state, generator, batch, train=True):
        """The output layer's loss + L1/L2 (reference
        computeGradientAndScore:1781). Returns (loss, (new_state,
        extras)); extras holds the RNN carries when the batch brings
        `carries` (TBPTT)."""
        loss, new_state, new_carries = self._head(
            params, state, batch, train=train, generator=generator)
        loss = loss + self._penalty(params)
        aux, new_state = pop_aux_losses(new_state)
        if train:
            loss = loss + aux
        extras = {"carries": new_carries} if "carries" in batch else {}
        return loss, (new_state, extras)

    # ------------------------------------------------------------------- fit
    def _batch_dict(self, ds: DataSet):
        """A DataSet's arrays as tensors on the net's device."""
        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device)

        b = {"features": dev(ds.features), "labels": dev(ds.labels)}
        if ds.features_mask is not None:
            b["features_mask"] = dev(ds.features_mask)
        if ds.labels_mask is not None:
            b["labels_mask"] = dev(ds.labels_mask)
        return b

    def _get_train_step(self):
        if self._train_step is None:
            self._train_step = make_train_step(
                self._loss, self.tx, self._layer_confs_by_name(),
                mesh=self._mesh, data_axis=mesh_axis(self, "data"),
                overlap=self._overlap_plan, zero1=self._zero1)
        return self._train_step

    @staticmethod
    def _iterator(data, labels):
        if labels is not None:
            data = DataSet(data, labels)
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        return data

    def fit(self, data, labels=None, epochs: int = 1):
        """Train (reference fit(DataSetIterator):1011) over a DataSet,
        (features, labels) arrays or a DataSetIterator, `epochs` times:
        layerwise pretraining first when the configuration asks for it;
        then, with backprop on, one optimizer pass per batch (times the
        config's `iterations`), the Solver path for a non-SGD
        optimization algorithm, or truncated BPTT for a 3-D sequence
        longer than `tbptt_fwd_length`."""
        if self.params is None:
            self.init()
        single_batch = labels is not None or isinstance(data, DataSet)
        it = self._iterator(data, labels)
        if self.conf.pretrain:
            self.pretrain(it)
        if not self.conf.backprop:
            return self
        if not is_sgd(self.conf):
            return self._fit_with_solver(it, epochs)
        step = self._get_train_step()
        tbptt = is_tbptt(self.conf)
        g = self.conf.conf
        local = getattr(it, "process_local", False)

        def convert(ds):
            # producer-thread work: this rank's rows, the tensors on the
            # device; batch None = a TBPTT sequence (its windows convert
            # on the step thread)
            ds = local_dataset(self, ds, local)
            if tbptt and self._needs_tbptt(ds):
                return ds, None
            return ds, self._batch_dict(ds)

        # the first step of each batch shape is counted (cost book); the
        # memory sampler runs at the DL4J_TPU_MEM_EVERY cadence
        book, mem = fit_telemetry(self)
        for _ in range(epochs):
            it.reset()
            for _ds, (ds, batch) in iter_prefetched(
                    it, convert, depth=0 if single_batch else None):
                if batch is None:
                    self._fit_tbptt(ds, step)
                    continue
                for _i in range(max(1, g.iterations)):
                    with book.count("fit", batch_shape(batch),
                                    device=self.device, args=(batch,)):
                        self.params, self.opt_state, self.state, loss, _ = \
                            step(self.params, self.opt_state, self.state,
                                 self._generator, batch)
                    self._after_step(loss)
                    mem.on_step(self.iteration_count)
            self.epoch_count += 1
        return self

    def fit_scanned(self, data, labels=None, epochs: int = 1):
        """Whole-epoch training over a list of uniform batches staged on
        the device (the JAX package scans them in one dispatch; here a
        loop that reads no loss back until the end —
        nn/training.fused_fit). Listeners fire once per epoch with the
        epoch's mean score."""
        from deeplearning4j_tpu_torch.nn.training import fused_fit

        if self.params is None:
            self.init()
        it = self._iterator(data, labels)
        local = getattr(it, "process_local", False)
        batches = [self._batch_dict(local_dataset(self, ds, local))
                   for ds in it]
        fused_fit(self, batches, epochs)
        self.epoch_count += epochs
        return self

    def _needs_tbptt(self, ds) -> bool:
        f = np.asarray(ds.features)
        return f.ndim == 3 and f.shape[1] > self.conf.tbptt_fwd_length

    def _fit_with_solver(self, it, epochs: int):
        """The line-search and second-order path (reference Solver.java
        dispatch on OptimizationAlgorithm): each minibatch is optimized
        by the configured solver over the flat parameter vector."""
        from deeplearning4j_tpu_torch.optimize.solvers import Solver

        local = getattr(it, "process_local", False)

        def convert(ds):
            if is_tbptt(self.conf) and self._needs_tbptt(ds):
                raise ValueError(
                    "TRUNCATED_BPTT requires "
                    "STOCHASTIC_GRADIENT_DESCENT; second-order solvers "
                    "would differentiate the full sequence")
            # on a mesh this rank's part of the batch (Solver: the solve
            # runs over the mesh)
            return self._batch_dict(local_dataset(self, ds, local))

        solver = Solver(self)
        for _ in range(epochs):
            it.reset()
            for _ds, batch in iter_prefetched(it, convert):
                solver.optimize(batch, generator=self._generator)
                for lst in self.listeners:
                    lst.iteration_done(self, self.iteration_count)
            self.epoch_count += 1
        return self

    def _initial_carries(self, batch_size):
        """Zero carries for every recurrent layer that can stream."""
        return {name: impl.initial_carry(lc, batch_size, self.compute_dtype,
                                         self.device)
                for name, lc, impl in zip(self.layer_names, self.layer_confs,
                                          self.impls)
                if streams(lc, impl)}

    def _fit_tbptt(self, ds: DataSet, step):
        """Truncated BPTT (reference doTruncatedBPTT): a window of
        `tbptt_fwd_length` steps slides over time, one optimizer step a
        window. The recurrent carries flow from window to window; the
        gradients do not (the reference's default of equal forward and
        backward lengths)."""
        labels = np.asarray(ds.labels)
        if labels.ndim != 3:
            raise ValueError(
                "TRUNCATED_BPTT needs time-distributed labels "
                f"[batch, time, n_out]; got shape {labels.shape}. "
                "A per-sequence label would be counted once per segment "
                "against mid-sequence activations — train with standard "
                "BPTT instead")
        T = ds.features.shape[1]
        L = self.conf.tbptt_fwd_length
        carries = self._initial_carries(ds.features.shape[0])

        def window(a, t0):
            return None if a is None else a[:, t0:t0 + L]

        for t0 in range(0, T, L):
            batch = self._batch_dict(DataSet(
                window(ds.features, t0), window(ds.labels, t0),
                window(ds.features_mask, t0), window(ds.labels_mask, t0)))
            batch["carries"] = carries
            self.params, self.opt_state, self.state, loss, extras = step(
                self.params, self.opt_state, self.state, self._generator,
                batch)
            carries = detach_carries(extras["carries"])
            self._after_step(loss)

    # -------------------------------------------------------------- pretrain
    def pretrain(self, it, epochs: int = 1):
        """Greedy layer-wise pretraining (reference pretrain:165): each
        pretrain layer (AutoEncoder, RBM) in turn is trained on its own
        loss over the activations of the stack below it, with an
        optimizer of its own."""
        if self.params is None:
            self.init()
        if isinstance(it, DataSet):
            it = ListDataSetIterator([it])
        for i, (name, lc, impl) in enumerate(
                zip(self.layer_names, self.layer_confs, self.impls)):
            if not lc.is_pretrain_layer():
                continue
            pretrain_layer(self, it, epochs, name, lc, impl,
                           lambda ds, _i=i: self._forward(
                               self.params, self.state, ds.features,
                               to_layer=_i)[0])
        return self

    def set_mesh(self, mesh, zero1: bool = False, axes=None,
                 n_microbatches=None, tp_rules=None, overlap=None):
        """Map parallelism roles to mesh axis names
        (parallel/placement.configure_mesh): "data", "model" and
        "expert" here ("seq" needs the graph container); `zero1` splits
        the optimizer state over "data"; `overlap` (True / bucket bytes
        / a BucketPlan) reduces the gradients bucket by bucket during
        the backward. set_mesh(None) clears the mesh. Returns the
        net."""
        return configure_mesh(self, mesh, zero1=zero1, axes=axes,
                              n_microbatches=n_microbatches,
                              tp_rules=tp_rules, overlap=overlap)

    def resume_from(self, checkpoint_dir: str, step=None, *,
                    target_mesh=None, target_axes=None):
        """Restore params, layer state, optimizer state and the step
        counter from a checkpoint directory (util/checkpoint.py
        `Checkpointer` layout) into this net. Returns the restored step:
        0 when the directory has no checkpoint yet (a cold start, not an
        error); a named step that is missing raises FileNotFoundError.
        `target_mesh` / `target_axes`: restore through the resharding
        engine into that placement, each rank reading only its part
        (util/checkpoint.resume); the net is left placed on it."""
        from deeplearning4j_tpu_torch.util.checkpoint import resume

        return resume(self, checkpoint_dir, step, target_mesh=target_mesh,
                      target_axes=target_axes)

    # ------------------------------------------------------------- inference
    @torch.no_grad()
    def feed_forward(self, x, train: bool = False):
        """Every layer's activation, as tensors on the net's device
        (reference feedForward:614)."""
        acts, _ = self._forward(self.params, self.state, x, train=train,
                                generator=self._generator if train else None,
                                collect=True)
        return acts

    @torch.no_grad()
    def output(self, x, train: bool = False, mask=None):
        """The network's output for x, a tensor on the net's device
        (reference output:1500-1582). Inference mode (batch norm's
        running statistics, no dropout) unless `train`."""
        def fwd(x, mask=None):
            if mask is not None:
                mask = torch.as_tensor(mask, device=self.device)
            y, _ = self._forward(self.params, self.state, x, train=train,
                                 generator=self._generator if train
                                 else None, mask=mask)
            return [y]

        if train:  # a training-mode forward draws: one rank, whole batch
            return fwd(x, mask)[0]
        return sharded_forward(self, [x] if mask is None else [x, mask],
                               fwd)[0]

    def predict(self, x):
        """Class indices (reference predict), a numpy array."""
        return self.output(x).argmax(-1).cpu().numpy()

    def inference_fn(self):
        """A ``(params, state, x, mask=None) -> y`` inference-mode
        forward for an external owner: the predict engine's replicas
        (serving/engine.py) call it with their published params once per
        padded batch. No generator, no state update: inference forwards
        are row-independent, which the serving padding relies on. Grad
        mode is per thread, so the function enters no_grad itself."""
        @torch.no_grad()
        def fwd(params, state, x, mask=None):
            if mask is not None:
                mask = torch.as_tensor(mask, device=self.device)
            y, _ = self._forward(params, state, x, train=False, mask=mask)
            return y
        return fwd

    def incremental_decode_fn(self, kv_dtype: str = "f32",
                              page_size: int = 16):
        """The decode step ``(params, state, cache, token, pos) -> (probs,
        cache)`` over the KV cache of a transformer stack
        (nn/decode.make_decode_fn; the same contract as
        ComputationGraph.incremental_decode_fn): what `rnn_time_step`
        refuses for attention layers. kv_dtype="int8" reads and writes
        the quantized paged cache."""
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
        tokens [B, K], pos) -> (probs [B, K, V], cache)``
        (nn/decode.make_verify_fn)."""
        from deeplearning4j_tpu_torch.nn.decode import make_verify_fn

        return make_verify_fn(self, kv_dtype, page_size)

    def init_kv_cache(self, batch: int, capacity: int,
                      kv_dtype: str = "f32", page_size: int = 16):
        """Zeroed decode cache for `batch` rows of `capacity` key slots
        (nn/decode.init_cache)."""
        from deeplearning4j_tpu_torch.nn.decode import init_cache

        return init_cache(self, batch, capacity, kv_dtype, page_size)

    @torch.no_grad()
    def score(self, dataset: DataSet = None, training: bool = False):
        """The loss on a DataSet (no update), or the last training score
        when `dataset` is None. training=False uses the inference-mode
        forward (batch norm's running statistics, no dropout)."""
        if dataset is None:
            return self.score_value
        loss, _ = self._loss(self.params, self.state, None,
                             self._batch_dict(dataset), train=training)
        return float(loss)

    @torch.no_grad()
    def score_examples(self, dataset, add_regularization: bool = False):
        """One score PER EXAMPLE [batch] (reference scoreExamples:1969),
        inference-mode forward, a numpy array; `add_regularization` adds
        the network's L1/L2 penalty to each."""
        per, _, _ = self._head(self.params, self.state,
                               self._batch_dict(dataset), train=False,
                               generator=None, per_example=True)
        if add_regularization:
            per = per + self._penalty(self.params)
        return per.float().cpu().numpy()

    def evaluate(self, it, top_n: int = 1):
        """Classification evaluation (reference evaluate:2311) over a
        DataSet or an iterator; top_n > 1 also tracks top-N accuracy."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        ev = Evaluation(top_n=top_n)
        if isinstance(it, DataSet):
            it = ListDataSetIterator([it])
        it.reset()
        while it.has_next():
            ds = it.next()
            out = self.output(ds.features)
            ev.eval(ds.labels, out.float().cpu().numpy(),
                    mask=ds.labels_mask)
        from deeplearning4j_tpu_torch.telemetry import get_default

        get_default().eval(ev, top_n=top_n)  # a no-op unless telemetry is on
        return ev

    # ------------------------------------------------- streaming RNN inference
    def rnn_clear_previous_state(self):
        self._rnn_carries = None

    @torch.no_grad()
    def rnn_time_step(self, x):
        """Stateful inference a step or a chunk at a time (reference
        rnnTimeStep:2147): x [batch, n_in] (one step, output [batch,
        n_out]) or [batch, time, n_in]; the recurrent layers' carries
        persist between calls until `rnn_clear_previous_state`. Raises
        for a layer that cannot stream causally (the bidirectional LSTM;
        the reference throws UnsupportedOperationException)."""
        refuse_unstreamable(zip(self.layer_names, self.layer_confs,
                                 self.impls))
        x = self._as_input(x)
        single = x.ndim == 2
        if single:
            x = x[:, None, :]
        carries = self._rnn_carries
        if carries is None:
            carries = self._initial_carries(x.shape[0])
        y, _, new_carries = self._walk(self.params, self.state, x,
                                       carries=carries)
        self._rnn_carries = {**carries, **new_carries}
        return y[:, -1, :] if single and y.ndim == 3 else y

    @torch.no_grad()
    def rnn_activate_using_stored_state(self, x, *, training: bool = False,
                                        store_last_for_tbptt: bool = False):
        """Every layer's activation over a [batch, time, n_in] sequence,
        the recurrent layers starting from the stored streaming state
        (reference rnnActivateUsingStoredState,
        MultiLayerNetwork.java:2203); the stored state moves on only
        with `store_last_for_tbptt`."""
        x = self._as_input(x)
        if x.ndim != 3:
            raise ValueError("rnn_activate_using_stored_state expects "
                             f"[batch, time, n_in]; got {tuple(x.shape)}")
        carries = self._rnn_carries
        if carries is None:
            carries = self._initial_carries(x.shape[0])
        acts, _, new_carries = self._walk(
            self.params, self.state, x, train=training,
            generator=self._generator if training else None,
            carries=carries, collect=True)
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
        """The flat parameter vector (reference params()), in the JAX
        package's order (keys sorted at every level), as f32 (bf16
        widens exactly) or f64 numpy; whole under a placement."""
        return tree.params_flat(self.canonical_params())

    def set_params_flat(self, flat):
        """Set every param from a flat vector in `params_flat`'s order,
        each in its own dtype."""
        set_canonical_params(
            self, tree.set_params_flat(self.canonical_params(), flat))

    def clone(self) -> "MultiLayerNetwork":
        """A new net of a copy of this configuration with copies of its
        params, state and optimizer state."""
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device)
        net.init()
        if self.params is not None:
            net.params = tree.clone(self.canonical_params())
            net.state = tree.clone(self.state)
            net.opt_state = copy.deepcopy(self.canonical_opt_state())
        return net

