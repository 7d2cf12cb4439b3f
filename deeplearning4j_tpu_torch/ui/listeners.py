"""UI iteration listeners over the port's nets (JAX counterpart
deeplearning4j_tpu/ui/listeners.py; reference ui/weights/
HistogramIterationListener.java, which posts ModelAndGradient JSON :206;
ui/flow/FlowIterationListener.java, the ModelInfo/LayerInfo topology
beans; activation/UpdateActivationIterationListener).

Each listener builds the JAX package's JSON snapshot per iteration and
either POSTs it to a running UiServer (`url=...`) or writes it into a
storage object (`storage=...`) for in-process use. The params live on
the net's device: a snapshot reads them to the host in one copy (one
flat tensor of every leaf), and the activation probe runs its forward on
the net's device and reads the means back in one copy.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.storage import SessionStorage

log = logging.getLogger(__name__)


def _post(url: str, payload: dict) -> None:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10):
        pass


class _BaseUiListener(IterationListener):
    kind = ""
    # consecutive POST failures before the listener stops trying:
    # monitoring must never take down training (the reference's listener
    # catches and logs its HTTP errors for the same reason)
    MAX_POST_FAILURES = 5

    def __init__(self, url: Optional[str] = None,
                 storage: Optional[SessionStorage] = None,
                 session_id: str = "default", frequency: int = 1):
        if url is None and storage is None:
            raise ValueError("need url= (HTTP mode) or storage= (embedded)")
        self.url = url.rstrip("/") if url else None
        self.storage = storage
        self.session_id = session_id
        self.frequency = max(1, frequency)
        self._post_failures = 0

    def _emit(self, payload: dict) -> None:
        if self.storage is not None:
            self.storage.put(self.session_id, self.kind, payload)
        if self.url is not None \
                and self._post_failures < self.MAX_POST_FAILURES:
            try:
                _post(f"{self.url}/{self.kind}/update?sid={self.session_id}",
                      payload)
                self._post_failures = 0
            except Exception as e:  # noqa: BLE001 — any transport failure
                self._post_failures += 1
                log.warning("UI POST to %s failed (%s)%s", self.url, e,
                            "; disabling further posts"
                            if self._post_failures >= self.MAX_POST_FAILURES
                            else "")

    def iteration_done(self, model, iteration):
        if iteration % self.frequency:
            return
        self._emit(self.snapshot(model, iteration))

    def snapshot(self, model, iteration) -> dict:
        raise NotImplementedError


def _named_leaves(tree, prefix):
    """[(name, tensor)] of a layer's params in insertion order, a nested
    dict's keys joined by "_" (a flat layer's names are the JAX
    listener's `{layer}_{param}`)."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}_{k}"
        if isinstance(v, torch.Tensor):
            out.append((name, v))
        else:
            out.extend(_named_leaves(v, name))
    return out


def host_params(model) -> list:
    """[(name, numpy array)] of every param of the net, read from its
    device in one copy (f32, or f64 where a leaf is f64)."""
    named = []
    for lname, layer in (model.params or {}).items():
        named.extend(_named_leaves(layer, lname))
    if not named:
        return []
    wide = any(t.dtype == torch.float64 for _, t in named)
    dtype = torch.float64 if wide else torch.float32
    flat = torch.cat([t.detach().reshape(-1).to(dtype)
                      for _, t in named]).cpu().numpy()
    out, at = [], 0
    for name, t in named:
        out.append((name, flat[at:at + t.numel()].reshape(tuple(t.shape))))
        at += t.numel()
    return out


def _histogram(arr: np.ndarray, bins: int = 20) -> dict:
    counts, edges = np.histogram(arr.ravel(), bins=bins)
    return {"bins": edges.tolist(), "counts": counts.tolist()}


class HistogramIterationListener(_BaseUiListener):
    """Param histograms and the score curve (weights/
    HistogramIterationListener.java; bean weights/ModelAndGradient.java)."""

    kind = "weights"

    def snapshot(self, model, iteration) -> dict:
        return {
            "iteration": iteration,
            "score": float(model.score_value),
            "parameters": {name: _histogram(arr)
                           for name, arr in host_params(model)},
        }


class FlowIterationListener(_BaseUiListener):
    """Network topology and per-layer meta (flow/FlowIterationListener
    .java, beans/{ModelInfo, LayerInfo})."""

    kind = "flow"

    def snapshot(self, model, iteration) -> dict:
        layers = []
        # MultiLayerNetwork: ordered layer_names; ComputationGraph: topo
        names = getattr(model, "layer_names", None)
        if names is None and hasattr(model, "topo"):
            names = [n for n in model.topo if n in (model.params or {})]
        for i, name in enumerate(names or []):
            layer_params = (model.params or {}).get(name, {})
            n_params = int(sum(t.numel() for _, t in
                               _named_leaves(layer_params, "")))
            layers.append({
                "name": str(name),
                "index": i,
                "num_params": n_params,
                "param_names": sorted(layer_params),
            })
        return {
            "iteration": iteration,
            "score": float(model.score_value),
            "layers": layers,
        }


class ActivationMeanIterationListener(_BaseUiListener):
    """Mean |activation| per layer on a probe batch
    (plot/iterationlistener/ActivationMeanIterationListener and the
    ui/activation view).

    The training step does not expose intermediate activations, so this
    listener runs its own forward of a fixed probe input every
    `frequency` iterations (feedForwardToLayer collect mode) on the net's
    device, and reads the means back in one copy. A MultiLayerNetwork's
    activations are its `feed_forward`'s; a ComputationGraph, which has
    no `feed_forward` in either package (the JAX listener raises on one),
    gives the floating-point activation of each vertex in topological
    order, from one inference-mode forward that collects them."""

    kind = "activations"

    def __init__(self, probe_input, **kw):
        super().__init__(**kw)
        self.probe_input = probe_input
        self._probe = None

    def _probe_on(self, device):
        """The probe input on `device`, copied there once."""
        if self._probe is None or self._probe.device != device:
            self._probe = torch.as_tensor(self.probe_input).to(device)
        return self._probe

    def snapshot(self, model, iteration) -> dict:
        probe = self._probe_on(model.device)
        if hasattr(model, "feed_forward"):
            acts = model.feed_forward(probe)
        else:
            with torch.no_grad():
                by_vertex, _ = model._forward(
                    model.params, model.state,
                    {model.conf.network_inputs[0]: probe}, collect=True)
            acts = [by_vertex[n] for n in model.topo
                    if n in by_vertex and by_vertex[n].is_floating_point()]
        means = torch.stack([a.detach().abs().float().mean()
                             for a in acts]).cpu().tolist()
        return {"iteration": iteration,
                "activation_means": {f"layer_{i}": float(m)
                                     for i, m in enumerate(means)}}
