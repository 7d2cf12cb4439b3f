"""Iris pipeline (JAX counterpart deeplearning4j_tpu/datasets/iris.py;
reference fetchers/IrisDataFetcher.java + base/IrisUtils.java +
iterator/impl/IrisDataSetIterator.java).

Loads the classic 150x4 set from the port's own copy, `iris.csv` beside
this file (scikit-learn's bundled file, copied verbatim: a header line
"150,4,<class names>", then four features and the class index a row).
Read as float64 and cast to float32, the features equal the JAX
package's `load_iris().data.astype(np.float32)` bit for bit; the port
needs no scikit-learn. Normalization matches the reference's fetcher
(feature-wise standardization optional).
"""

from __future__ import annotations

import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator

IRIS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "iris.csv")


def _read_iris():
    """(features [150, 4] float64, targets [150] int) from `IRIS_CSV`."""
    raw = np.loadtxt(IRIS_CSV, delimiter=",", skiprows=1, dtype=np.float64)
    return raw[:, :4], raw[:, 4].astype(np.int64)


def load_iris_dataset(normalize: bool = True, shuffle: bool = True,
                      seed: int = 123):
    data, target = _read_iris()
    x = data.astype(np.float32)
    y = np.eye(3, dtype=np.float32)[target]
    if normalize:
        x = (x - x.mean(axis=0)) / (x.std(axis=0) + 1e-8)
    if shuffle:
        rng = np.random.default_rng(seed)
        p = rng.permutation(len(x))
        x, y = x[p], y[p]
    return DataSet(x, y)


class IrisDataSetIterator(ArrayDataSetIterator):
    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 normalize: bool = True, seed: int = 123):
        ds = load_iris_dataset(normalize=normalize, seed=seed)
        super().__init__(ds.features[:num_examples], ds.labels[:num_examples],
                         batch_size, n_outcomes=3)
