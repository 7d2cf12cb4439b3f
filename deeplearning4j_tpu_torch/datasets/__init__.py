"""Data containers, iterators (array, list, existing, multiple-epoch,
sampling and the async prefetch iterator), the MNIST, CIFAR-10, Iris,
Curves and LFW loaders, image records (`image_records.py`: a directory
of labelled images as NHWC batches), the record readers (`records.py`:
CSV, SVMLight, string lists, sequences, multi-reader MultiDataSets),
cloud paths (`cloud.py`: local directories as buckets), the vectorizers
(`vectorizer.py`) and the train/test formatter (`rearrange.py`) (JAX
counterpart deeplearning4j_tpu/datasets). Everything here is host
numpy; the networks move batches to their device."""

from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    ArrayDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    SamplingDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.async_iterator import AsyncDataSetIterator  # noqa: F401
from deeplearning4j_tpu_torch.datasets.cifar import CifarDataSetIterator  # noqa: F401
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataFetcher,
    MnistDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.iris import IrisDataSetIterator  # noqa: F401
from deeplearning4j_tpu_torch.datasets.lfw import LFWDataSetIterator  # noqa: F401
from deeplearning4j_tpu_torch.datasets.curves import (  # noqa: F401
    CurvesDataFetcher,
    CurvesDataSetIterator,
)
from deeplearning4j_tpu_torch.datasets.image_records import (  # noqa: F401
    ImageRecordReader,
    ImageRecordReaderDataSetIterator,
)
