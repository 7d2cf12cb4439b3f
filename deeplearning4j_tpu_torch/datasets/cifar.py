"""CIFAR-10 pipeline (JAX counterpart deeplearning4j_tpu/datasets/cifar.py;
reference iterator/impl/CifarDataSetIterator.java).

Reads the standard python batch files (cifar-10-batches-py, or the
tar.gz that holds them) when they are in `data_dir`; otherwise it uses
the JAX package's deterministic synthetic set, the same arrays bit for
bit for the same seed and size. Images are [N, 32, 32, 3] NHWC float32
in [0, 1]; labels one-hot [N, 10] float32.
"""

from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator

_DEFAULT_DIR = os.path.expanduser("~/.deeplearning4j_tpu/cifar10")


def _load_local(data_dir: str, train: bool):
    """The cifar-10-batches-py pickle format (or the tar.gz containing
    it), or None when neither is in `data_dir`."""
    batch_dir = os.path.join(data_dir, "cifar-10-batches-py")
    tar = os.path.join(data_dir, "cifar-10-python.tar.gz")
    if not os.path.isdir(batch_dir) and os.path.exists(tar):
        with tarfile.open(tar) as tf:
            tf.extractall(data_dir, filter="data")
    if not os.path.isdir(batch_dir):
        return None
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for n in names:
        with open(os.path.join(batch_dir, n), "rb") as f:
            d = pickle.load(f, encoding="bytes")  # noqa: S301 (local files)
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.asarray(ys, np.int64)


def _synthetic_cifar(n: int, seed: int, train: bool):
    """Deterministic class templates plus noise (the JAX package's
    generator, draw for draw)."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    yy, xx = np.mgrid[0:32, 0:32] / 31.0
    templates = np.stack([
        np.stack([
            np.sin((c + 1) * np.pi * xx + ch),
            np.cos((c % 5 + 1) * np.pi * yy + ch),
            np.sin((c % 3 + 1) * 2 * np.pi * (xx * yy) + ch),
        ], axis=-1)
        for c in range(10) for ch in [0.0]
    ])
    templates = (templates - templates.min()) / (np.ptp(templates) + 1e-9)
    labels = rng.integers(0, 10, size=n)
    imgs = templates[labels] + rng.normal(0, 0.2, size=(n, 32, 32, 3))
    return np.clip(imgs, 0, 1).astype(np.float32), labels


class CifarDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int, num_examples: int | None = None,
                 train: bool = True, data_dir: str | None = None,
                 seed: int = 123, shuffle: bool = False):
        loaded = _load_local(data_dir or _DEFAULT_DIR, train)
        if loaded is not None:
            x, y = loaded
            self.synthetic = False
        else:
            n = num_examples or (50000 if train else 10000)
            x, y = _synthetic_cifar(n, seed, train)
            self.synthetic = True
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        if shuffle:
            p = np.random.default_rng(seed).permutation(len(x))
            x, y = x[p], y[p]
        super().__init__(x, np.eye(10, dtype=np.float32)[y], batch_size,
                         n_outcomes=10)
