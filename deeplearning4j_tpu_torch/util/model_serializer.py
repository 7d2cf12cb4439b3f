"""ModelSerializer: the zip model format (JAX counterpart
deeplearning4j_tpu/util/model_serializer.py; reference
util/ModelSerializer.java:37-78).

The zip holds, as the JAX package's does:

- `configuration.json`  the network configuration (nn/conf/serde.py;
                        both packages write the same JSON)
- `params.npz`          the params as `arr_0`, `arr_1`, ... in the JAX
                        flatten order (dict keys sorted, nested as the
                        layer keeps them: the canonical per-layer tree)
- `state.npz`           the layer state (batch norm's running
                        statistics) in the same order
- `meta.json`           `format_version`, `kind`, `iteration`, `epoch`

so a zip of either package restores in the other with the same outputs.
A bf16 leaf is written widened to f32 (exact; numpy has no bf16) and
cast back to the network's dtype on restore, as the JAX reader casts.

The updater. The port's optimizer state goes under `port_updater.pt`
(`torch.save` of the state tree: dicts, lists, counts, tensors), an
entry the JAX reader does not read: a port zip restores in the JAX
package with a fresh optax state, as a zip written with
`save_updater=False` does, and in the port it resumes training bit for
bit. A JAX zip's `updater.npz` (optax's leaves, per-leaf trees or the
flat view, `flat_layout` 1 or 2) is mapped into the port's optimizer
state from the configuration (`weights_io.opt_state_from_jax`), so a
JAX zip resumes training in the port with its moments; leaves that match
no layout raise `weights_io.UpdaterMappingError`. `updater_restored` on
the returned network says whether an updater state was read (False
only for a zip written without one).
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf import serde

_FORMAT_VERSION = 1
PORT_UPDATER = "port_updater.pt"


def _leaves(tree) -> list:
    from deeplearning4j_tpu_torch.util.checkpoint import tensor_leaves

    return [t for _, t in tensor_leaves(tree, "")]


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _save_tree(zf: zipfile.ZipFile, name: str, tree) -> None:
    buf = io.BytesIO()
    np.savez(buf, *[_numpy(t) for t in _leaves(tree)])
    zf.writestr(name, buf.getvalue())


def _load_leaves(zf: zipfile.ZipFile, name: str) -> list:
    npz = np.load(io.BytesIO(zf.read(name)), allow_pickle=False)
    # np.savez names leaves arr_0 .. arr_{n-1}; order by index
    return [npz[k] for k in sorted(npz.files, key=lambda k: int(k[4:]))]


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # a stored bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=like.device, dtype=like.dtype)


def _restore_tree(template, arrays: list):
    """`template` with its tensor leaves replaced, in order, by `arrays`
    cast to each leaf's dtype and device."""
    leaves = _leaves(template)
    if len(leaves) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} arrays but model "
                         f"expects {len(leaves)}")
    it = iter(arrays)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return _tensor(next(it), node)
        if isinstance(node, dict):  # filled in sorted order, kept in its own
            filled = {k: walk(node[k]) for k in sorted(node, key=str)}
            return {k: filled[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(template)


def _kind(net) -> str:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return ("ComputationGraph" if isinstance(net, ComputationGraph)
            else "MultiLayerNetwork")


class ModelSerializer:
    @staticmethod
    def write_model(net, path, save_updater: bool = True):
        """Write a MultiLayerNetwork or ComputationGraph to a zip. A net
        placed on a mesh of more than one rank writes its canonical
        (whole) trees: every rank of the mesh calls this (the gather is a
        collective) and rank 0 alone writes."""
        import torch.distributed as dist

        from deeplearning4j_tpu_torch.util.checkpoint import _canonical_trees

        if net.params is None:
            net.init()
        trees = _canonical_trees(net)
        mesh = getattr(net, "_mesh", None)
        if mesh is not None and mesh.size > 1 and dist.get_rank() != 0:
            return
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("configuration.json", serde.to_json(net.conf))
            _save_tree(zf, "params.npz", trees["params"])
            _save_tree(zf, "state.npz", trees["state"])
            if save_updater and trees["opt_state"] is not None:
                buf = io.BytesIO()
                torch.save(trees["opt_state"], buf)
                zf.writestr(PORT_UPDATER, buf.getvalue())
            zf.writestr("meta.json", json.dumps({
                "format_version": _FORMAT_VERSION,
                "kind": _kind(net),
                "iteration": int(net.iteration_count),
                "epoch": int(getattr(net, "epoch_count", 0)),
            }))

    @staticmethod
    def restore(path, expected_kind=None, device=None):
        """Restore either network kind (the stored `kind` picks it) on
        `device` (CUDA unless the caller names another);
        `expected_kind` rejects the other kind with a ValueError."""
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("meta.json"))
            if expected_kind is not None and meta["kind"] != expected_kind:
                raise ValueError(
                    f"{path} holds a {meta['kind']}, not a {expected_kind} "
                    f"(reference restore{expected_kind} rejects the wrong "
                    f"model kind)")
            conf = serde.from_json(zf.read("configuration.json").decode())
            cls = (ComputationGraph if meta["kind"] == "ComputationGraph"
                   else MultiLayerNetwork)
            net = cls(conf, device=device).init()
            net.params = _restore_tree(net.params,
                                       _load_leaves(zf, "params.npz"))
            net.state = _restore_tree(net.state,
                                      _load_leaves(zf, "state.npz"))
            names = zf.namelist()
            net.updater_restored = True
            if PORT_UPDATER in names:
                net.opt_state = torch.load(
                    io.BytesIO(zf.read(PORT_UPDATER)), weights_only=True,
                    map_location=net.device)
            elif "updater.npz" in names:
                from deeplearning4j_tpu_torch.weights_io import (
                    opt_state_from_jax,
                )

                net.opt_state = opt_state_from_jax(
                    net, _load_leaves(zf, "updater.npz"),
                    flat_layout=meta.get("flat_layout", 1),
                    iteration=meta.get("iteration", 0))
            else:
                net.opt_state = net.tx.init(net.params)
                net.updater_restored = False
            net.iteration_count = meta.get("iteration", 0)
            if hasattr(net, "epoch_count"):
                net.epoch_count = meta.get("epoch", 0)
        return net

    @staticmethod
    def restore_multi_layer_network(path, device=None):
        return ModelSerializer.restore(path, "MultiLayerNetwork", device)

    @staticmethod
    def restore_computation_graph(path, device=None):
        return ModelSerializer.restore(path, "ComputationGraph", device)
