"""Data containers, iterators, the MNIST and CIFAR-10 loaders, the record
readers (`records.py`: CSV, SVMLight, string lists, sequences, multi-
reader MultiDataSets) and cloud paths (`cloud.py`: local directories as
buckets) (JAX counterpart deeplearning4j_tpu/datasets). The other
loaders (Iris, ...), the async, multiple-epoch and sampling iterators
come with later slices."""

from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    ArrayDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.cifar import CifarDataSetIterator  # noqa: F401
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataFetcher,
    MnistDataSetIterator,
)
