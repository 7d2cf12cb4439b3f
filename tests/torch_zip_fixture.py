"""The JAX zip fixture of the port's updater mapping (tests/fixtures/
torch_port/), made by the JAX package on the CPU.

    python tests/torch_zip_fixture.py          # (re)write the fixture

It writes

* `jax_lm.zip`: a 2-layer transformer LM (`LM`: vocab 64, d_model 32,
  one head of 32, d_ff 64, T 512) trained 3 Adam steps by the JAX
  package on the batches of seeds 0-2, written by its `ModelSerializer`
  (optax's per-leaf tree layout: the LM is far under the flat view's
  2^20 params);
* `jax_lm_next.npz`: the JAX net's params after 3 further steps on the
  batches of seeds 3-5 (`params/<layer>/<name>`), with those batches
  (`x3`, `y3`, ...).

The port restores the zip with its updater state and takes the same 3
steps: tests/test_torch_updater_map.py on the CPU, chip_smoke.py phase
27c on the card (which reads the files with numpy and the port alone).
At T 512 and head dim 32 the port's attention takes the flat flash
kernels there (K1 forward, K4 backward). The packed-QKV kernels (K2/K6)
need a head dim of 128, or 64 with an even head count, so d_model 128:
99,840 params at one layer, whose zip (params and Adam's two moments in
f32) alone passes 1 MB.

The learning rate is 1e-3, so 3 steps move the params by some 3e-3,
well past the 2e-4 the port's Adam parity allows: a net resumed with a
fresh updater state, or not stepped at all, ends outside it. The key
slice of the attention bias is left out of that comparison
(chip_smoke.py `fixture_differences`): its gradient is zero but for
rounding (softmax ignores a shift shared by every key), and Adam scales
that noise up to a step of about lr in a direction rounding picks. The
test regenerates the arrays here and compares them with the committed
ones, so the fixture cannot rot.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FIXTURE_DIR = ROOT / "tests" / "fixtures" / "torch_port"
ZIP = "jax_lm.zip"
NEXT = "jax_lm_next.npz"
LM = dict(vocab_size=64, d_model=32, n_heads=1, n_layers=2, d_ff=64,
          max_length=512, learning_rate=1e-3)
BATCH = 4


def batch(seed):
    """The tokens and next-token labels of step `seed` ([BATCH, T])."""
    rng = np.random.default_rng(1000 + seed)
    x = rng.integers(0, LM["vocab_size"],
                     (BATCH, LM["max_length"])).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


def flat_params(params, prefix="params"):
    """{"params/<layer>/<name>": array} of a nest of dicts of arrays."""
    out = {}
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def make(out_dir):
    """Train and write the fixture's two files into `out_dir`; returns
    their paths."""
    import jax

    from deeplearning4j_tpu.datasets.api import DataSet
    from deeplearning4j_tpu.models.transformer import transformer_lm
    from deeplearning4j_tpu.util.model_serializer import ModelSerializer

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    net = transformer_lm(**LM).init()
    for seed in range(3):
        net.fit(DataSet(*batch(seed)))
    zip_path = out_dir / ZIP
    ModelSerializer.write_model(net, str(zip_path))
    arrays = {}
    for seed in range(3, 6):
        x, y = batch(seed)
        net.fit(DataSet(x, y))
        arrays[f"x{seed}"], arrays[f"y{seed}"] = x, y
    arrays.update(flat_params(jax.tree.map(np.asarray, net.params)))
    next_path = out_dir / NEXT
    np.savez_compressed(next_path, **arrays)
    return zip_path, next_path


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    for p in make(FIXTURE_DIR):
        print(f"{p} ({p.stat().st_size} bytes)")
