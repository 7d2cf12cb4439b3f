"""Image record reading — the Canova image bridge equivalent (JAX
counterpart deeplearning4j_tpu/datasets/image_records.py).

Reference: canova's ImageRecordReader walked a directory tree whose
subdirectory names are labels and emitted (flattened image, label index)
records consumed by RecordReaderDataSetIterator
(`deeplearning4j-core/.../datasets/canova/RecordReaderDataSetIterator.java`).
Here ImageRecordReader yields `(features [H,W,C] float32, label_index)`
tuples and ImageRecordReaderDataSetIterator batches them into NHWC
DataSets — the layout the port's conv layers take, no flattening
round-trip.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator
from deeplearning4j_tpu_torch.datasets.records import RecordReader
from deeplearning4j_tpu_torch.util.image_loader import ImageLoader

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm", ".pgm")


class ImageRecordReader(RecordReader):
    """Walks `root/<label>/<image>` and yields (array, label_idx) records.

    labels: optional explicit label order; otherwise sorted subdirectory
    names (reference parentPathLabelGenerator semantics).
    """

    def __init__(self, root: str, height: int, width: int, channels: int = 3,
                 labels: Optional[Sequence[str]] = None):
        self.root = root
        self.loader = ImageLoader(height, width, channels)
        if labels is None:
            labels = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
        self.labels: List[str] = list(labels)
        self._index = {l: i for i, l in enumerate(self.labels)}
        self._files: List[tuple] = []
        for label in self.labels:
            d = os.path.join(root, label)
            for fn in sorted(os.listdir(d)):
                if fn.lower().endswith(_IMAGE_EXTS):
                    self._files.append((os.path.join(d, fn),
                                       self._index[label]))
        if not self._files:
            raise IOError(f"no image files under {root}")

    def num_examples(self) -> int:
        return len(self._files)

    def __iter__(self):
        for path, label in self._files:
            yield self.loader.as_array(path), label


class ImageRecordReaderDataSetIterator(DataSetIterator):
    """Batches an ImageRecordReader into NHWC DataSets with one-hot labels
    (the RecordReaderDataSetIterator image specialization)."""

    def __init__(self, reader: ImageRecordReader, batch_size: int,
                 shuffle: bool = False, seed: int = 123):
        super().__init__()
        self.reader = reader
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._records = None
        self._order = None
        self._pos = 0

    def _materialize(self):
        if self._records is None:
            feats, labels = [], []
            for arr, label in self.reader:
                feats.append(arr)
                labels.append(label)
            self._records = (np.stack(feats),
                             np.asarray(labels, np.int64))
        self._order = np.arange(len(self._records[1]))
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def reset(self):
        self._materialize()

    def has_next(self) -> bool:
        if self._records is None:
            self._materialize()
        return self._pos < len(self._order)

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        sel = self._order[self._pos:self._pos + self.batch_size]
        self._pos += len(sel)
        x, y = self._records
        n_classes = len(self.reader.labels)
        onehot = np.eye(n_classes, dtype=np.float32)[y[sel]]
        return self._apply_pre(DataSet(x[sel], onehot))

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return self.reader.num_examples()

    def total_outcomes(self) -> int:
        return len(self.reader.labels)

    def get_labels(self) -> List[str]:
        return list(self.reader.labels)

    def async_supported(self) -> bool:
        return True
