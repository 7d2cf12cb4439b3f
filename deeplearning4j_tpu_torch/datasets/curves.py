"""Curves dataset fetcher (JAX counterpart deeplearning4j_tpu/datasets/curves.py,
the port's own copy: the same numpy calls, so the same seed gives the
same pixels; reference `fetchers/CurvesDataFetcher.java`).

The reference downloads a serialized `curves.ser` blob of 28x28 synthetic
curve images (the deep-autoencoder pretraining benchmark from
Hinton/Salakhutdinov). Zero-egress here: the same kind of data — smooth
random curves rasterized onto a 28x28 grid — is synthesized
deterministically. The fetcher API matches MnistDataFetcher (features as
flat rows in [0,1]; curves have no labels, the dataset is its own target,
matching the reference where fetch() sets labels = features for the
autoencoder use case).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator

IMAGE_SIZE = 28


def _rasterize_curve(rng: np.random.Generator, size: int) -> np.ndarray:
    """Draw one smooth random curve (cubic Bezier) with soft strokes."""
    p = rng.random((4, 2)) * (size - 1)
    t = np.linspace(0.0, 1.0, 6 * size)[:, None]
    b = ((1 - t) ** 3 * p[0] + 3 * (1 - t) ** 2 * t * p[1]
         + 3 * (1 - t) * t ** 2 * p[2] + t ** 3 * p[3])
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    # soft gaussian stroke around sampled curve points (vectorized)
    d2 = ((yy[None] - b[:, 1, None, None]) ** 2
          + (xx[None] - b[:, 0, None, None]) ** 2)
    img = np.exp(-d2 / 1.2).max(axis=0)
    return img


class CurvesDataFetcher:
    """Synthesizes the full curves split into memory once."""

    def __init__(self, num_examples: int = 2000, seed: int = 123):
        rng = np.random.default_rng(seed)
        imgs = np.stack([_rasterize_curve(rng, IMAGE_SIZE)
                         for _ in range(num_examples)])
        self.features = imgs.reshape(num_examples, -1).astype(np.float32)

    def fetch(self, num: int) -> DataSet:
        """Reference fetch(): labels == features (autoencoder target)."""
        x = self.features[:num]
        return DataSet(x, x.copy())


class CurvesDataSetIterator(ArrayDataSetIterator):
    """Batched iterator over the curves set (features double as labels)."""

    def __init__(self, batch_size: int, num_examples: int = 2000,
                 seed: int = 123):
        f = CurvesDataFetcher(num_examples=num_examples, seed=seed)
        super().__init__(f.features, f.features.copy(), batch_size)
