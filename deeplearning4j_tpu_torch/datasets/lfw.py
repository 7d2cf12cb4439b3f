"""LFW (Labeled Faces in the Wild) dataset iterator (JAX counterpart
deeplearning4j_tpu/datasets/lfw.py).

Reference: `datasets/iterator/impl/LFWDataSetIterator.java` +
`fetchers/LFWDataFetcher.java` — downloads the LFW tarball, walks
`lfw/<person>/<image>.jpg`, and feeds face crops through the image
pipeline. The port makes no download attempt, so when no local LFW
copy exists a deterministic synthetic face corpus is generated ONCE into
the same `<person>/<image>.png` directory layout and then read back
through the real `ImageRecordReader` file pipeline — the loader/reader
path is identical to the real-data path; only the pixels are synthetic.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.image_records import (
    ImageRecordReader,
    ImageRecordReaderDataSetIterator,
)
from deeplearning4j_tpu_torch.util.image_loader import ImageLoader

# the port's own root: a corpus one package wrote with Pillow (PNG)
# is never read by the other without it (PNM bytes under .png names)
_DEFAULT_DIR = os.path.expanduser("~/.deeplearning4j_tpu_torch/lfw")


def _synthesize_person(rng: np.random.Generator, size: int) -> np.ndarray:
    """A per-person base 'face': smooth low-frequency blob structure."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.zeros((size, size, 3), np.float32)
    for _ in range(4):
        cx, cy = rng.random(2)
        sx, sy = 0.08 + 0.25 * rng.random(2)
        amp = rng.random(3)
        blob = np.exp(-(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2))
        base += blob[..., None] * amp
    return base / max(base.max(), 1e-6)


def generate_synthetic_lfw(root: str, n_people: int = 10,
                           images_per_person: int = 8, size: int = 32,
                           seed: int = 123) -> None:
    """Write `<root>/<person>/<img>.png` once (idempotent)."""
    marker = os.path.join(root, ".synthetic_complete")
    if os.path.exists(marker):
        return
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for p in range(n_people):
        person = f"person_{p:03d}"
        d = os.path.join(root, person)
        os.makedirs(d, exist_ok=True)
        base = _synthesize_person(rng, size)
        for i in range(images_per_person):
            img = np.clip(base + 0.08 * rng.standard_normal(base.shape), 0, 1)
            ImageLoader.save(img, os.path.join(d, f"{person}_{i:04d}.png"))
    with open(marker, "w") as f:
        f.write("ok")


def _has_real_lfw(root: str) -> bool:
    if not os.path.isdir(root):
        return False
    if os.path.exists(os.path.join(root, ".synthetic_complete")):
        return True  # synthetic corpus already materialized
    subdirs = [d for d in os.listdir(root)
               if os.path.isdir(os.path.join(root, d))]
    return len(subdirs) > 0


class LFWDataSetIterator(ImageRecordReaderDataSetIterator):
    """Reference LFWDataSetIterator: batches of face images + one-hot
    person labels. Points `data_dir` at a real LFW extraction to use the
    actual dataset; otherwise a synthetic corpus in the same layout is
    generated and used."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 image_size: int = 32, channels: int = 3,
                 data_dir: Optional[str] = None, shuffle: bool = False,
                 seed: int = 123, n_people: int = 10,
                 images_per_person: int = 8):
        root = data_dir or _DEFAULT_DIR
        if not _has_real_lfw(root):
            generate_synthetic_lfw(root, n_people=n_people,
                                   images_per_person=images_per_person,
                                   size=image_size, seed=seed)
        reader = ImageRecordReader(root, image_size, image_size, channels)
        if num_examples is not None:
            reader._files = reader._files[:num_examples]
        super().__init__(reader, batch_size, shuffle=shuffle, seed=seed)
