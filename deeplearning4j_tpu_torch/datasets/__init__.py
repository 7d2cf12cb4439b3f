"""Data containers and iterators (JAX counterpart
deeplearning4j_tpu/datasets). The dataset loaders (MNIST, CIFAR, Iris,
...), the async, multiple-epoch and sampling iterators come with later
slices."""

from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    ArrayDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
)
