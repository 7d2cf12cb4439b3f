"""The port's checkpoint format (in place of the JAX package's
deeplearning4j_tpu/util/orbax_checkpoint.py `ShardedCheckpointer`).

Layout, as in the JAX package:

    <dir>/step_<N>/model.pt     params, state and opt_state (torch.save)
    <dir>/step_<N>/config.json  the network configuration (nn/conf/serde)
    <dir>/step_<N>/meta.json    iteration, epoch, kind, and the manifest

The commit rule is the JAX package's too: `meta.json` is written last,
through a rename, so a step without it — a save cut off midway — is
invisible to `steps()`, `latest_step` and `restore`. `keep` prunes all
but the newest steps after each commit.

The manifest in `meta.json` records every tensor leaf of the three trees
by path (`params/<layer>/<name>`, `opt_state/<label>/mu/3`, ...), with
its shape and dtype, and the byte size of `model.pt`. The serving fleet's
pre-restore gate (serving/fleet.py `validate_checkpoint_shapes`) reads
the manifest and no array data, so a checkpoint of another architecture,
or one whose model file is cut short, is rejected before any read.

Arrays load with `torch.load(weights_only=True, map_location=
net.device)`: tensors, dicts, lists, tuples, strings and numbers only,
straight onto the net's device. A net placed on a mesh ("model" /
"expert" splits, ZeRO-1, "pipe" stages) saves its canonical trees —
gathered whole, so the file is the meshless net's — and every rank of
the mesh calls `save`. Under a mesh of more than one rank, when every
rank names the same directory, rank 0 alone writes and commits and a
barrier of every rank follows: a rank killed mid-save never leaves a
second writer or a half-committed step. Ranks that name directories of
their own each write their own. Restoring into a placed net (every rank
calls `restore`) reads the file memory-mapped and keeps each rank's part of
every leaf, as `reshard/executor.checkpoint_template` plans it, with the
plan on the record; a checkpoint of any placement restores into any
other, the meshless net's included.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

MODEL_FILE = "model.pt"
FORMAT = 1
TREES = ("params", "state", "opt_state")


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def tensor_leaves(tree, prefix: str) -> list:
    """[(path, tensor)] of every tensor in a nest of dicts, lists and
    tuples, in a fixed order (dict keys sorted, sequences by index)."""
    out = []
    if isinstance(tree, torch.Tensor):
        out.append((prefix, tree))
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.extend(tensor_leaves(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(tensor_leaves(v, f"{prefix}/{i}"))
    return out


def manifest(tree, prefix: str) -> list:
    """The manifest rows of one tree: path, shape and dtype per leaf."""
    return [{"path": path, "shape": list(t.shape),
             "dtype": _dtype_name(t.dtype)}
            for path, t in tensor_leaves(tree, prefix)]


class Checkpointer:
    """Save and restore a network's params, layer state and optimizer
    state under `directory` (see the module docstring for the layout)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)

    # ------------------------------------------------------------- listing
    def steps(self) -> list:
        """The committed steps (those with a meta.json), ascending."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for d in entries:
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "meta.json")):
                try:
                    out.append(int(d.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def read_meta(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), "meta.json")) as f:
            return json.load(f)

    # ---------------------------------------------------------------- save
    def save(self, net, step: Optional[int] = None) -> str:
        """Write step `step` (default: the net's iteration count) and
        commit it by renaming its meta.json into place; then prune to the
        newest `keep` steps. Returns the step directory."""
        from deeplearning4j_tpu_torch.nn.conf import serde

        step = net.iteration_count if step is None else int(step)
        d = self.step_dir(step)
        # every rank builds the canonical trees: under a placement they
        # gather
        trees = _canonical_trees(net)
        shared = self._shared_directory(net)
        if shared and dist.get_rank() != 0:
            dist.barrier()
            return d
        os.makedirs(d, exist_ok=True)
        meta_path = os.path.join(d, "meta.json")
        if os.path.exists(meta_path):
            os.remove(meta_path)  # uncommit before overwriting the arrays
        model_path = os.path.join(d, MODEL_FILE)
        torch.save(trees, model_path)
        with open(os.path.join(d, "config.json"), "w") as f:
            f.write(serde.to_json(net.conf))
        from deeplearning4j_tpu_torch.reshard.executor import net_placement

        meta = {
            "format": FORMAT,
            "placement": net_placement(net).to_json(),
            "iteration": int(net.iteration_count),
            "epoch": int(getattr(net, "epoch_count", 0)),
            "kind": type(net).__name__,
            "model_bytes": os.path.getsize(model_path),
            "leaves": {name: manifest(trees[name], name) for name in TREES},
        }
        tmp = os.path.join(d, ".meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, meta_path)
        for old in self.steps()[:-self.keep or None]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)
        if shared:
            dist.barrier()
        return d

    def _shared_directory(self, net) -> bool:
        """The writer rule of `save`: True when the net is on a mesh of
        more than one rank and every rank names this directory (rank 0
        then writes for all); False without such a mesh or when the
        ranks name directories of their own. A collective under a mesh:
        every rank of it calls `save`."""
        mesh = getattr(net, "_mesh", None)
        if mesh is None or mesh.size < 2:
            return False
        dirs = [None] * dist.get_world_size()
        dist.all_gather_object(dirs, self.directory)
        return len(set(dirs)) == 1

    # ------------------------------------------------------------- restore
    def restore(self, net, step: Optional[int] = None):
        """Load the latest (or the given) committed step INTO `net`,
        whose configuration must match: every params and state leaf is
        checked against the manifest before the arrays are read. Raises
        FileNotFoundError when there is no such step and ValueError on a
        mismatch."""
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        if step is None:
            step = steps[-1]
        elif step not in steps:
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.directory} "
                f"(have {steps})")
        if net.params is None:
            net.init()
        from deeplearning4j_tpu_torch.parallel.placement import (
            _placed,
            canonical_template,
        )

        placed = _placed(net)
        meta = self.read_meta(step)
        for name in ("params", "state"):
            tree_ = canonical_template(net) if name == "params" else net.state
            want = manifest(tree_, name)
            have = meta["leaves"][name]
            if want != have:
                raise ValueError(
                    f"checkpoint step {step} {name} do not match this "
                    f"network: {first_difference(want, have)}")
        path = os.path.join(self.step_dir(step), MODEL_FILE)
        if placed:
            _restore_placed(net, torch.load(path, weights_only=True,
                                            mmap=True, map_location="cpu"),
                            meta)
        else:
            if "placement" in meta:
                _record_plan(net, meta)
            trees = torch.load(path, weights_only=True,
                               map_location=net.device)
            net.params = trees["params"]
            net.state = trees["state"]
            net.opt_state = trees["opt_state"]
        net.iteration_count = meta.get("iteration", 0)
        if hasattr(net, "epoch_count"):
            net.epoch_count = meta.get("epoch", 0)
        return net


def _record_plan(net, meta):
    """The `reshard_plan` event of a restore into an unplaced net: every
    rank reads every leaf whole from the checkpoint."""
    from deeplearning4j_tpu_torch.parallel.placement import current_layout
    from deeplearning4j_tpu_torch.reshard.executor import (
        checkpoint_template,
        net_placement,
    )
    from deeplearning4j_tpu_torch.reshard.planner import Placement
    from deeplearning4j_tpu_torch.telemetry import get_default

    plan = checkpoint_template(net, current_layout(net)).plan.plan(
        Placement.from_json(meta["placement"]), net_placement(net))
    get_default().event("reshard_plan", path="checkpoint", **plan.summary())


def _restore_placed(net, trees, meta):
    """A checkpoint's canonical trees (memory-mapped) into a placed net:
    each rank copies out its part of every leaf
    (reshard/executor.restore_placed); the layer state whole."""
    from deeplearning4j_tpu_torch.nn import tree
    from deeplearning4j_tpu_torch.parallel.placement import current_layout
    from deeplearning4j_tpu_torch.reshard.executor import (
        net_placement,
        restore_placed,
    )
    from deeplearning4j_tpu_torch.reshard.planner import Placement

    src = (Placement.from_json(meta["placement"]) if "placement" in meta
           else Placement.solo())
    net.params, opt = restore_placed(net, trees, src, current_layout(net),
                                     net_placement(net))
    if net.opt_state is not None:
        net.opt_state = opt
    net.state = tree.tree_map(lambda t: t.to(net.device, copy=True),
                              trees["state"])


def _canonical_trees(net) -> dict:
    """The three trees a checkpoint holds, whole: a placed net's params
    and optimizer state gathered (parallel/placement.py)."""
    trees = {name: getattr(net, name) for name in TREES}
    if hasattr(net, "canonical_params"):
        trees["params"] = net.canonical_params()
        trees["opt_state"] = net.canonical_opt_state()
    return trees


def network_of(checkpoint_dir: str, step=None, device=None):
    """(a new, unrestored network of the configuration the latest (or
    given) step holds, on `device`; that step)."""
    from deeplearning4j_tpu_torch.nn.conf import serde
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    ck = Checkpointer(checkpoint_dir)
    steps = ck.steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ck.directory}")
    step = steps[-1] if step is None else step
    kind = ck.read_meta(step)["kind"]
    with open(os.path.join(ck.step_dir(step), "config.json")) as f:
        conf = serde.from_json(f.read())
    cls = {"MultiLayerNetwork": MultiLayerNetwork,
           "ComputationGraph": ComputationGraph}[kind]
    return cls(conf, device=device), step


def load_network(checkpoint_dir: str, step=None, device=None):
    """A new network (MultiLayerNetwork or ComputationGraph, as saved) of
    the checkpoint's own configuration on `device`, restored from the
    latest (or given) step."""
    net, step = network_of(checkpoint_dir, step, device)
    return Checkpointer(checkpoint_dir).restore(net, step=step)


def first_difference(want: list, have: list) -> str:
    """The first manifest row where a network (`want`) and a checkpoint
    (`have`) part, in words."""
    for w, h in zip(want, have):
        if w != h:
            return (f"network {w['path']} {w['shape']}/{w['dtype']} vs "
                    f"checkpoint {h['path']} {h['shape']}/{h['dtype']}")
    return f"network has {len(want)} leaves, checkpoint {len(have)}"


def resume(net, checkpoint_dir: str, step=None, *, target_mesh=None,
           target_axes=None) -> int:
    """`resume_from` of both containers: restore the latest (or given)
    step into `net` and return its iteration count; 0 when the directory
    holds no checkpoint (a cold start). A named step that is missing
    raises FileNotFoundError.

    `target_mesh` (a Mesh or a `reshard.Placement`, as `set_mesh` takes)
    and `target_axes` (its roles): the restore goes through the
    resharding engine into that placement. The net is placed first
    (`set_mesh(target_mesh, axes=target_axes)`, on its own device; every
    rank of the mesh calls it), then each rank reads from the
    memory-mapped checkpoint only the part of every leaf its placement
    keeps (`restore_placed`, the plan and the bytes on the record). The
    checkpoint may come from any placement; the result is that of a
    whole restore followed by the same `set_mesh`. A cold start leaves
    the net placed on the target."""
    if target_mesh is not None:
        ck = Checkpointer(checkpoint_dir)
        if step is not None and step not in ck.steps():
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {ck.directory} "
                f"(have {ck.steps()})")
        net.set_mesh(target_mesh, axes=target_axes)
    try:
        Checkpointer(checkpoint_dir).restore(net, step=step)
    except FileNotFoundError:
        if step is not None:
            raise
        return 0
    return net.iteration_count
