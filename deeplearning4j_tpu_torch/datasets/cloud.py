"""Cloud-storage data I/O — the reference's S3 module mapped to GCS
(JAX counterpart deeplearning4j_tpu/datasets/cloud.py).

Reference: `deeplearning4j-aws/.../s3/{S3Downloader,S3Uploader,
BaseS3DataSetIterator}` (stream datasets from buckets into the training
loop). TPU-side storage is GCS; this module shells out to `gcloud storage`
(falling back to `gsutil`) for transfers, keeps a local cache directory,
and iterates serialized DataSets (.npz) from a bucket prefix. Every code
path also accepts plain local directories, so the pipeline is fully
testable offline (zero egress) and local paths double as a filesystem
"bucket" for development. Where neither `gcloud` nor `gsutil` is on the
PATH, a `gs://` URL raises `CloudToolMissing` (a RuntimeError) before
anything is attempted.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator

_CACHE = os.path.expanduser("~/.cache/deeplearning4j_tpu/gcs")


class CloudToolMissing(RuntimeError):
    """A `gs://` URL where no `gcloud` / `gsutil` is on the PATH."""


def _is_remote(path: str) -> bool:
    return path.startswith("gs://")


def _cli() -> Optional[List[str]]:
    if shutil.which("gcloud"):
        return ["gcloud", "storage"]
    if shutil.which("gsutil"):
        return ["gsutil"]
    return None


class GcsDownloader:
    """S3Downloader equivalent: fetch objects to a local cache."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or _CACHE

    def download(self, uri: str, dest: Optional[str] = None) -> str:
        if not _is_remote(uri):
            return uri  # local path passthrough
        # preserve the object path hierarchy: flattening '/' would collide
        # distinct objects onto one cache file
        dest = dest or os.path.join(self.cache_dir, uri[len("gs://"):])
        if os.path.exists(dest):
            return dest
        cli = _cli()
        if cli is None:
            raise CloudToolMissing(
                f"{uri}: no gcloud/gsutil on PATH — install the Cloud SDK "
                "or pass a local path")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        # download to a temp name and rename: a transfer killed mid-way
        # must not leave a truncated file that reads as a cache hit forever
        tmp = dest + f".tmp{os.getpid()}"
        try:
            subprocess.run(cli + ["cp", uri, tmp], check=True,
                           capture_output=True)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return dest

    def list(self, prefix: str) -> List[str]:
        if not _is_remote(prefix):
            return sorted(
                os.path.join(prefix, f) for f in os.listdir(prefix)
                if os.path.isfile(os.path.join(prefix, f)))
        cli = _cli()
        if cli is None:
            raise CloudToolMissing(f"{prefix}: no gcloud/gsutil on PATH")
        out = subprocess.run(cli + ["ls", prefix], check=True,
                             capture_output=True, text=True)
        return [l.strip() for l in out.stdout.splitlines() if l.strip()]


class GcsUploader:
    """S3Uploader equivalent."""

    def upload(self, local_path: str, uri: str) -> None:
        if not _is_remote(uri):
            os.makedirs(os.path.dirname(uri) or ".", exist_ok=True)
            shutil.copyfile(local_path, uri)
            return
        cli = _cli()
        if cli is None:
            raise CloudToolMissing(f"{uri}: no gcloud/gsutil on PATH")
        subprocess.run(cli + ["cp", local_path, uri], check=True,
                       capture_output=True)


def save_dataset(ds: DataSet, path: str) -> None:
    """Serialize one DataSet as .npz (the S3 object format here)."""
    arrs = {"features": ds.features, "labels": ds.labels}
    if ds.features_mask is not None:
        arrs["features_mask"] = ds.features_mask
    if ds.labels_mask is not None:
        arrs["labels_mask"] = ds.labels_mask
    np.savez_compressed(path, **arrs)


def load_dataset(path: str) -> DataSet:
    with np.load(path) as z:
        return DataSet(z["features"], z["labels"],
                       z["features_mask"] if "features_mask" in z else None,
                       z["labels_mask"] if "labels_mask" in z else None)


class GcsDataSetIterator(DataSetIterator):
    """BaseS3DataSetIterator equivalent: iterate .npz DataSets under a
    bucket prefix (or local directory), downloading through the cache."""

    def __init__(self, prefix: str, cache_dir: Optional[str] = None):
        super().__init__()
        self.downloader = GcsDownloader(cache_dir)
        self.uris = [u for u in self.downloader.list(prefix)
                     if u.endswith(".npz")]
        if not self.uris:
            raise IOError(f"no .npz datasets under {prefix}")
        self._i = 0

    def has_next(self) -> bool:
        return self._i < len(self.uris)

    def next(self, num=None) -> DataSet:
        if not self.has_next():
            raise StopIteration
        uri = self.uris[self._i]
        self._i += 1
        return self._apply_pre(load_dataset(self.downloader.download(uri)))

    def reset(self) -> None:
        self._i = 0

    def batch(self) -> int:
        return -1

    def total_examples(self) -> int:
        return -1
