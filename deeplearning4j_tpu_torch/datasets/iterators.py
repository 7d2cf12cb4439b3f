"""DataSetIterator protocol + generic iterators (JAX counterpart
deeplearning4j_tpu/datasets/iterators.py; the port's own copy of that
numpy-only module).

Reference: datasets/iterator/DataSetIterator.java (next(n)/batch/
totalExamples/inputColumns/reset/setPreProcessor), ListDataSetIterator.
MultipleEpochsIterator and SamplingDataSetIterator come with a later
slice.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet


class DataSetIterator:
    """Iterator over minibatch DataSets. Python-iterable; also supports the
    reference's explicit hasNext/next protocol."""

    def __init__(self):
        self._preprocessor = None

    # -- reference protocol --
    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self, num: int | None = None) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def total_examples(self) -> int:
        return -1

    def input_columns(self) -> int:
        return -1

    def total_outcomes(self) -> int:
        return -1

    def async_supported(self) -> bool:
        return True

    def set_pre_processor(self, fn) -> None:
        """fn(DataSet) -> None, applied in-place to each batch (reference
        DataSetPreProcessor)."""
        self._preprocessor = fn

    def _apply_pre(self, ds: DataSet) -> DataSet:
        if self._preprocessor is not None:
            self._preprocessor(ds)
        return ds

    # -- pythonic protocol --
    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()


class ArrayDataSetIterator(DataSetIterator):
    """In-memory array slicing iterator — the shared engine behind the
    MNIST/CIFAR/Iris iterators (one copy of the batching contract)."""

    def __init__(self, features, labels, batch_size: int, n_outcomes: int = -1):
        super().__init__()
        self._x = features
        self._y = labels
        self._batch = batch_size
        self._outcomes = n_outcomes
        self._i = 0

    def has_next(self):
        return self._i < len(self._x)

    def next(self, num=None):
        n = num or self._batch
        sl = slice(self._i, self._i + n)
        self._i += n
        return self._apply_pre(DataSet(self._x[sl], self._y[sl]))

    def reset(self):
        self._i = 0

    def batch(self):
        return self._batch

    def total_examples(self):
        return len(self._x)

    def input_columns(self):
        return int(np.prod(self._x.shape[1:]))

    def total_outcomes(self):
        if self._outcomes > 0:
            return self._outcomes
        return int(self._y.shape[-1]) if self._y is not None else -1


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-batched or single DataSet list (reference
    ListDataSetIterator)."""

    def __init__(self, data, batch_size: int | None = None):
        super().__init__()
        if isinstance(data, DataSet):
            data = data.batch_by(batch_size) if batch_size else [data]
        elif batch_size is not None and len(data) == 1:
            data = data[0].batch_by(batch_size)
        self._data = list(data)
        self._i = 0
        self._batch = batch_size or (self._data[0].num_examples() if self._data else 0)

    def has_next(self):
        return self._i < len(self._data)

    def next(self, num=None):
        ds = self._data[self._i]
        self._i += 1
        return self._apply_pre(ds)

    def reset(self):
        self._i = 0

    def batch(self):
        return self._batch

    def total_examples(self):
        return sum(d.num_examples() for d in self._data)

    def input_columns(self):
        f = self._data[0].features
        return int(np.prod(f.shape[1:]))

    def total_outcomes(self):
        l = self._data[0].labels
        return int(l.shape[-1]) if l is not None else -1


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any python iterable of DataSets."""

    def __init__(self, iterable_factory):
        super().__init__()
        if callable(iterable_factory):
            self._factory = iterable_factory
        else:
            items = list(iterable_factory)
            self._factory = lambda: iter(items)
        self._it = self._factory()
        self._peek = None

    def has_next(self):
        if self._peek is None:
            try:
                self._peek = next(self._it)
            except StopIteration:
                return False
        return True

    def next(self, num=None):
        if not self.has_next():
            raise StopIteration
        ds, self._peek = self._peek, None
        return self._apply_pre(ds)

    def reset(self):
        self._it = self._factory()
        self._peek = None

    def batch(self):
        return -1
