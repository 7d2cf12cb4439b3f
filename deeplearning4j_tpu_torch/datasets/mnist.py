"""MNIST pipeline (JAX counterpart deeplearning4j_tpu/datasets/mnist.py;
reference fetchers/MnistDataFetcher.java:43-125,
iterator/impl/MnistDataSetIterator.java:30).

Parses the standard idx files (gzipped or not) when they are in
`data_dir`; otherwise it uses the JAX package's deterministic synthetic
digit set, the same arrays bit for bit for the same seed and size. The
port makes no download attempt (the JAX package tries one first).

Images are [N, 784] float32 in [0, 1] (optionally binarized), or
[N, 28, 28, 1] NHWC with `reshape_images=True` for CNN input; labels are
one-hot [N, 10] float32.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator

_FILES = {
    "train_images": "train-images-idx3-ubyte.gz",
    "train_labels": "train-labels-idx1-ubyte.gz",
    "test_images": "t10k-images-idx3-ubyte.gz",
    "test_labels": "t10k-labels-idx1-ubyte.gz",
}
_DEFAULT_DIR = os.path.expanduser("~/.deeplearning4j_tpu/mnist")


def _parse_idx(data: bytes) -> np.ndarray:
    """Parse the idx format (reference MnistDbFile reads the same
    headers)."""
    magic = struct.unpack(">I", data[:4])[0]
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def _load_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".gz") or raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return _parse_idx(raw)


def _synthetic_mnist(n: int, seed: int, train: bool
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like images: each class a fixed low-frequency
    template plus noise (the JAX package's generator, draw for draw)."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    templates = np.stack([
        np.sin((c + 1) * np.pi * xx) * np.cos((c % 3 + 1) * np.pi * yy)
        + 0.5 * np.sin((c % 4 + 1) * 2 * np.pi * (xx + yy))
        for c in range(10)
    ])  # [10, 28, 28]
    templates = (templates - templates.min()) / (np.ptp(templates) + 1e-9)
    labels = rng.integers(0, 10, size=n)
    imgs = templates[labels] + rng.normal(0, 0.25, size=(n, 28, 28))
    imgs = np.clip(imgs, 0, 1).astype(np.float32)
    return imgs.reshape(n, 784), labels.astype(np.int64)


class MnistDataFetcher:
    """Loads (or synthesizes) the full split into memory once."""

    NUM_EXAMPLES = 60000
    NUM_EXAMPLES_TEST = 10000

    def __init__(self, train: bool = True, binarize: bool = False,
                 data_dir: str | None = None, allow_synthetic: bool = True,
                 num_examples: int | None = None, seed: int = 123):
        self.train = train
        data_dir = data_dir or _DEFAULT_DIR
        split = "train" if train else "test"
        img_path = os.path.join(data_dir, _FILES[f"{split}_images"])
        lbl_path = os.path.join(data_dir, _FILES[f"{split}_labels"])
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            images = _load_file(img_path).astype(np.float32) / 255.0
            self.images = images.reshape(images.shape[0], -1)
            self.labels = _load_file(lbl_path).astype(np.int64)
            self.synthetic = False
        elif allow_synthetic:
            n = num_examples or (self.NUM_EXAMPLES if train
                                 else self.NUM_EXAMPLES_TEST)
            self.images, self.labels = _synthetic_mnist(n, seed, train)
            self.synthetic = True
        else:
            raise OSError(
                f"MNIST files not found in {data_dir}; pass "
                "allow_synthetic=True or provide the idx files")
        if binarize:
            self.images = (self.images > 0.5).astype(np.float32)
        if num_examples is not None:
            self.images = self.images[:num_examples]
            self.labels = self.labels[:num_examples]


class MnistDataSetIterator(ArrayDataSetIterator):
    """Reference iterator/impl/MnistDataSetIterator.java:30."""

    def __init__(self, batch_size: int, num_examples: int | None = None,
                 train: bool = True, binarize: bool = False,
                 shuffle: bool = False, seed: int = 123,
                 reshape_images: bool = False, data_dir: str | None = None):
        f = MnistDataFetcher(train=train, binarize=binarize,
                             data_dir=data_dir, num_examples=num_examples,
                             seed=seed)
        images, labels_idx = f.images, f.labels
        self.synthetic = f.synthetic
        if shuffle:
            p = np.random.default_rng(seed).permutation(len(images))
            images, labels_idx = images[p], labels_idx[p]
        labels = np.eye(10, dtype=np.float32)[labels_idx]
        if reshape_images:
            images = images.reshape(-1, 28, 28, 1)
        super().__init__(images, labels, batch_size, n_outcomes=10)
