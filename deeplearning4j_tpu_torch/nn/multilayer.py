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

Not carried by this slice, and raising NotImplementedError: layerwise
pretraining, truncated BPTT, the non-SGD optimization algorithms (the
Solver path), `rnn_time_step` and `remat` (ROADMAP Queue A item A6);
meshes (`set_mesh`, A7); resuming from a checkpoint (`resume_from`, A5).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer,
    RnnOutputLayer,
    validate_layer_names,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.graph import DTYPES, cast_params
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
from deeplearning4j_tpu_torch.nn.updater import build_optimizer


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
        for name, lc, impl in zip(self.layer_names, self.layer_confs,
                                  self.impls):
            p, s = impl.init(lc, gen, self.param_dtype)
            params[name] = {k: t.to(self.device) for k, t in p.items()}
            state[name] = {k: t.to(self.device) for k, t in s.items()}
        self.params = params
        self.state = state
        self._generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.tx = build_optimizer(g, self._layer_confs_by_name())
        self.opt_state = self.tx.init(params)
        self._train_step = None
        return self

    def set_listeners(self, *listeners):
        self.listeners = list(listeners)

    # --------------------------------------------------------------- forward
    def _forward(self, params, state, x, *, train=False, generator=None,
                 mask=None, collect=False, to_layer=None):
        """Walk the stack (reference feedForwardToLayer:637) up to
        `to_layer` (default: all). Returns (the activations of every
        layer if `collect` else the last one, new_state); layers past
        `to_layer` keep their state."""
        x = torch.as_tensor(x, device=self.device)
        cdtype = self.compute_dtype
        if x.is_floating_point():
            x = x.to(cdtype)
        n = len(self.layer_confs) if to_layer is None else to_layer
        acts, new_state = [], {}
        for i in range(n):
            name, lc, impl = (self.layer_names[i], self.layer_confs[i],
                              self.impls[i])
            proc = self.conf.get_preprocessor(i)
            if proc is not None:
                x = proc.pre_process(x)
            p = params.get(name, {})
            if cdtype != self.param_dtype:
                p = cast_params(p, cdtype)
            x, new_state[name] = impl.apply(
                lc, p, state.get(name, {}), x, train=train,
                generator=generator, mask=mask)
            if collect:
                acts.append(x)
        for name in self.layer_names[n:]:
            new_state[name] = state.get(name, {})
        return (acts if collect else x), new_state

    def _head(self, params, state, batch, *, train, generator,
              per_example=False):
        """The output layer's loss on the stack below it: (loss, or one
        score per example, new_state)."""
        out_conf = self.layer_confs[-1]
        if not isinstance(out_conf, BaseOutputLayer):
            raise ValueError("Last layer must be an OutputLayer to compute "
                             "a score")
        n = len(self.layer_confs)
        fmask = batch.get("features_mask")
        lmask = batch.get("labels_mask")
        h, new_state = self._forward(params, state, batch["features"],
                                     train=train, generator=generator,
                                     mask=fmask, to_layer=n - 1)
        proc = self.conf.get_preprocessor(n - 1)
        if proc is not None:
            h = proc.pre_process(h)
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
        return loss, new_state

    def _penalty(self, params):
        pen = 0.0
        for name, lc in zip(self.layer_names, self.layer_confs):
            pen = pen + l1_l2_penalty(lc, params[name])
        return pen

    def _loss(self, params, state, generator, batch, train=True):
        """The output layer's loss + L1/L2 (reference
        computeGradientAndScore:1781). Returns (loss, (new_state, {}))."""
        loss, new_state = self._head(params, state, batch, train=train,
                                     generator=generator)
        loss = loss + self._penalty(params)
        aux, new_state = pop_aux_losses(new_state)
        if train:
            loss = loss + aux
        return loss, (new_state, {})

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
            self._train_step = make_train_step(self._loss, self.tx,
                                               self._layer_confs_by_name())
        return self._train_step

    @staticmethod
    def _iterator(data, labels):
        if labels is not None:
            data = DataSet(data, labels)
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        return data

    def fit(self, data, labels=None, epochs: int = 1):
        """Train (reference fit(DataSetIterator):1011): one optimizer
        pass per batch (times the config's `iterations`) over a DataSet,
        (features, labels) arrays or a DataSetIterator, `epochs` times."""
        if self.params is None:
            self.init()
        it = self._iterator(data, labels)
        check_trainable(self.conf)
        if not self.conf.backprop:
            return self
        step = self._get_train_step()
        g = self.conf.conf
        for _ in range(epochs):
            it.reset()
            for ds in it:
                batch = self._batch_dict(ds)
                for _i in range(max(1, g.iterations)):
                    self.params, self.opt_state, self.state, loss, _ = step(
                        self.params, self.opt_state, self.state,
                        self._generator, batch)
                    self.score_value = loss
                    self.iteration_count += 1
                    for lst in self.listeners:
                        lst.iteration_done(self, self.iteration_count)
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
        batches = [self._batch_dict(ds)
                   for ds in self._iterator(data, labels)]
        fused_fit(self, batches, epochs)
        self.epoch_count += epochs
        return self

    def pretrain(self, it, epochs: int = 1):
        """Greedy layer-wise pretraining (reference pretrain:165)."""
        raise NotImplementedError(
            "layerwise pretraining is not ported yet (ROADMAP Queue A item "
            "A6, with the pretrain layers)")

    def set_mesh(self, mesh, **kwargs):
        """Meshes come with the parallel slice of the port."""
        raise NotImplementedError(
            "meshes are not ported yet (ROADMAP Queue A item A7, parallel "
            "and distributed)")

    def resume_from(self, checkpoint_dir: str, step=None, **kwargs):
        """Resuming from a checkpoint needs the port's own checkpoint
        format."""
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP Queue A item A5, the "
            "port's own checkpoint format)")

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
        y, _ = self._forward(self.params, self.state, x, train=train,
                             generator=self._generator if train else None,
                             mask=mask)
        return y

    def predict(self, x):
        """Class indices (reference predict), a numpy array."""
        return self.output(x).argmax(-1).cpu().numpy()

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
        per, _ = self._head(self.params, self.state,
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
        return ev

    def rnn_time_step(self, x):
        """Streaming RNN inference comes with the recurrent layers."""
        raise NotImplementedError(
            "rnn_time_step is not ported yet (ROADMAP Queue A item A6, with "
            "the recurrent layers)")

    # -------------------------------------------------------- params plumbing
    def _leaves(self):
        """(layer, param) keys in the JAX package's flattening order:
        sorted layer names, then sorted param names."""
        return [(layer, name) for layer in sorted(self.params)
                for name in sorted(self.params[layer])]

    def num_params(self) -> int:
        return sum(t.numel() for p in self.params.values()
                   for t in p.values())

    def params_flat(self) -> np.ndarray:
        """The flat parameter vector (reference params()), in the JAX
        package's order, as f32 (bf16 widens exactly) or f64 numpy."""
        leaves = [self.params[layer][name].detach().reshape(-1)
                  for layer, name in self._leaves()]
        if not leaves:
            return np.zeros(0, np.float32)
        flat = torch.cat([t if t.dtype != torch.bfloat16 else t.float()
                          for t in leaves])
        return flat.cpu().numpy()

    def set_params_flat(self, flat):
        """Set every param from a flat vector in `params_flat`'s order,
        each in its own dtype."""
        flat = torch.as_tensor(np.asarray(flat))
        off = 0
        for layer, name in self._leaves():
            t = self.params[layer][name]
            n = t.numel()
            self.params[layer][name] = flat[off:off + n].reshape(
                t.shape).to(device=t.device, dtype=t.dtype)
            off += n

    def clone(self) -> "MultiLayerNetwork":
        """A new net of a copy of this configuration with copies of its
        params, state and optimizer state."""
        net = MultiLayerNetwork(copy.deepcopy(self.conf), device=self.device)
        net.init()
        if self.params is not None:
            net.params = {k: {n: t.clone() for n, t in p.items()}
                          for k, p in self.params.items()}
            net.state = {k: {n: t.clone() for n, t in s.items()}
                         for k, s in self.state.items()}
            net.opt_state = copy.deepcopy(self.opt_state)
        return net
