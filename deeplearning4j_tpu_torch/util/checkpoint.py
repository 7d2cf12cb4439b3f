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
straight onto the net's device. There is no mesh and no resharding here:
that comes with the parallel slice (ROADMAP Queue A item A7).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

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
        os.makedirs(d, exist_ok=True)
        meta_path = os.path.join(d, "meta.json")
        if os.path.exists(meta_path):
            os.remove(meta_path)  # uncommit before overwriting the arrays
        trees = {name: getattr(net, name) for name in TREES}
        model_path = os.path.join(d, MODEL_FILE)
        torch.save(trees, model_path)
        with open(os.path.join(d, "config.json"), "w") as f:
            f.write(serde.to_json(net.conf))
        meta = {
            "format": FORMAT,
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
        return d

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
        meta = self.read_meta(step)
        for name in ("params", "state"):
            want = manifest(getattr(net, name), name)
            have = meta["leaves"][name]
            if want != have:
                raise ValueError(
                    f"checkpoint step {step} {name} do not match this "
                    f"network: {first_difference(want, have)}")
        trees = torch.load(os.path.join(self.step_dir(step), MODEL_FILE),
                           weights_only=True, map_location=net.device)
        net.params = trees["params"]
        net.state = trees["state"]
        net.opt_state = trees["opt_state"]
        net.iteration_count = meta.get("iteration", 0)
        if hasattr(net, "epoch_count"):
            net.epoch_count = meta.get("epoch", 0)
        return net


def load_network(checkpoint_dir: str, step=None, device=None):
    """A new network (MultiLayerNetwork or ComputationGraph, as saved) of
    the checkpoint's own configuration on `device`, restored from the
    latest (or given) step."""
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
    return ck.restore(cls(conf, device=device), step=step)


def first_difference(want: list, have: list) -> str:
    """The first manifest row where a network (`want`) and a checkpoint
    (`have`) part, in words."""
    for w, h in zip(want, have):
        if w != h:
            return (f"network {w['path']} {w['shape']}/{w['dtype']} vs "
                    f"checkpoint {h['path']} {h['shape']}/{h['dtype']}")
    return f"network has {len(want)} leaves, checkpoint {len(have)}"


def resume(net, checkpoint_dir: str, step=None) -> int:
    """`resume_from` of both containers: restore the latest (or given)
    step into `net` and return its iteration count; 0 when the directory
    holds no checkpoint (a cold start). A named step that is missing
    raises FileNotFoundError."""
    try:
        Checkpointer(checkpoint_dir).restore(net, step=step)
    except FileNotFoundError:
        if step is not None:
            raise
        return 0
    return net.iteration_count
