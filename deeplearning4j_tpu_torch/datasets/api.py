"""DataSet containers (JAX counterpart deeplearning4j_tpu/datasets/api.py;
reference: external ND4J DataSet/MultiDataSet).

The port's own copy of the JAX package's numpy-only module. A DataSet
is host-side numpy (features, labels, optional masks); the network
moves each batch to its device when it trains on it. Masks follow the
reference's variable-length time-series semantics ([batch, time] of
0/1).
"""

from __future__ import annotations

import numpy as np


class DataSet:
    def __init__(self, features, labels=None, features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def split_test_and_train(self, n_train: int):
        tr = DataSet(self.features[:n_train], self.labels[:n_train],
                     None if self.features_mask is None else self.features_mask[:n_train],
                     None if self.labels_mask is None else self.labels_mask[:n_train])
        te = DataSet(self.features[n_train:], self.labels[n_train:],
                     None if self.features_mask is None else self.features_mask[n_train:],
                     None if self.labels_mask is None else self.labels_mask[n_train:])
        return tr, te

    def shuffle(self, seed=None):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        self.features = self.features[idx]
        if self.labels is not None:
            self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, n: int):
        out = []
        for i in range(0, self.num_examples(), n):
            out.append(DataSet(
                self.features[i:i + n],
                None if self.labels is None else self.labels[i:i + n],
                None if self.features_mask is None else self.features_mask[i:i + n],
                None if self.labels_mask is None else self.labels_mask[i:i + n],
            ))
        return out

    @staticmethod
    def merge(datasets):
        f = np.concatenate([d.features for d in datasets])
        l = (np.concatenate([d.labels for d in datasets])
             if datasets[0].labels is not None else None)
        return DataSet(f, l)

    def scale_min_max(self, lo=0.0, hi=1.0):
        mn, mx = self.features.min(), self.features.max()
        self.features = (self.features - mn) / max(mx - mn, 1e-12) * (hi - lo) + lo

    def normalize_zero_mean_unit_variance(self):
        mu = self.features.mean(axis=0)
        sd = self.features.std(axis=0) + 1e-12
        self.features = (self.features - mu) / sd


class MultiDataSet:
    """Multiple-input/output container (reference MultiDataSet for
    ComputationGraph)."""

    def __init__(self, features, labels, features_masks=None, labels_masks=None):
        self.features = [np.asarray(f) for f in features]
        self.labels = [np.asarray(l) for l in labels]
        self.features_masks = features_masks
        self.labels_masks = labels_masks

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])
