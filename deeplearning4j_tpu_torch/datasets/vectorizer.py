"""Vectorizers: raw input -> DataSet (JAX counterpart
deeplearning4j_tpu/datasets/vectorizer.py; reference
datasets/vectorizer/{Vectorizer,ImageVectorizer}.java).

ImageVectorizer turns one image file into a single-example DataSet with a
one-hot label, with the reference's builder-style binarize/normalize
switches (ImageVectorizer.java:75-99: binarize thresholds at 30 for
brightness-agnostic input, normalize divides by 255)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.util.image_loader import ImageLoader


class Vectorizer:
    """Anything that can produce a DataSet (reference Vectorizer.java)."""

    def vectorize(self) -> DataSet:
        raise NotImplementedError


class ImageVectorizer(Vectorizer):
    def __init__(self, image: str, num_labels: int, label: int,
                 size: Optional[tuple] = None):
        self.image = image
        self.num_labels = num_labels
        self.label = label
        self.size = size
        self._binarize = False
        self._threshold = 30
        self._normalize = False

    def binarize(self, threshold: int = 30) -> "ImageVectorizer":
        """Pixel > threshold -> 1 else 0 (brightness agnostic)."""
        self._binarize = True
        self._threshold = threshold
        self._normalize = False
        return self

    def normalize(self) -> "ImageVectorizer":
        """Scale pixel values to [0, 1]."""
        self._normalize = True
        self._binarize = False
        return self

    def vectorize(self) -> DataSet:
        # ImageLoader yields HWC float32 in [0, 1]
        h, w = self.size if self.size else (None, None)
        arr = ImageLoader(height=h, width=w).as_array(self.image)
        if self._binarize:
            arr = (arr * 255.0 > self._threshold).astype(np.float32)
        elif not self._normalize:
            arr = arr * 255.0  # raw pixel values, matching the reference
        x = arr[None, ...]  # single-example NHWC batch
        y = np.zeros((1, self.num_labels), np.float32)
        y[0, self.label] = 1.0
        return DataSet(x, y)
