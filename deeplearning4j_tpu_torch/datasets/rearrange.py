"""Unstructured-data train/test splitter (JAX counterpart
deeplearning4j_tpu/datasets/rearrange.py, the port's own copy; reference
datasets/rearrange/LocalUnstructuredDataFormatter.java).

Takes a directory tree of raw example files and rearranges it into

    <dest>/split/train/<label>/<file>
    <dest>/split/test/<label>/<file>

with the label taken either from each file's parent directory name
(LabelingType.DIRECTORY) or parsed out of the file name's trailing
"-<label>.<ext>" segment (LabelingType.NAME — reference getNameLabel
scans back from the extension to the last dash). Files are shuffled
before the split so train/test are random samples.
"""

from __future__ import annotations

import enum
import os
import random
import shutil
from typing import List, Optional


class LabelingType(enum.Enum):
    NAME = "name"
    DIRECTORY = "directory"


class LocalUnstructuredDataFormatter:
    def __init__(self, destination_root_dir: str, root_dir: str,
                 labeling_type: LabelingType = LabelingType.DIRECTORY,
                 percent_train: float = 0.8,
                 seed: Optional[int] = None):
        self.root_dir = root_dir
        self.split_root = os.path.join(destination_root_dir, "split")
        if os.path.exists(self.split_root):
            raise FileExistsError("Train/test split already exists")
        self.train_dir = os.path.join(self.split_root, "train")
        self.test_dir = os.path.join(self.split_root, "test")
        os.makedirs(self.train_dir)
        os.makedirs(self.test_dir)
        self.labeling_type = labeling_type
        self.percent_train = percent_train
        self.seed = seed
        self.num_examples_total = -1
        self.num_examples_to_train_on = -1
        self.num_test_examples = -1

    def rearrange(self) -> None:
        all_files: List[str] = []
        for base, _dirs, names in os.walk(self.root_dir):
            for n in names:
                all_files.append(os.path.join(base, n))
        self.num_examples_total = len(all_files)
        n_train = int(self.percent_train * self.num_examples_total)
        self.num_examples_to_train_on = n_train
        self.num_test_examples = self.num_examples_total - n_train
        random.Random(self.seed).shuffle(all_files)
        ok = False
        try:
            # validate every label BEFORE copying so a bad file name can't
            # leave a partial split behind (which would then block reruns
            # with FileExistsError)
            dests = [self.get_new_destination(p, train=i < n_train)
                     for i, p in enumerate(all_files)]
            for i, (path, dest) in enumerate(zip(all_files, dests)):
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                if os.path.exists(dest):
                    # same basename under the same label from different
                    # source dirs: disambiguate, don't silently overwrite
                    d, name = os.path.split(dest)
                    dest = os.path.join(d, f"{i}-{name}")
                shutil.copy(path, dest)
            ok = True
        finally:
            # finally (not except) so Ctrl-C mid-copy also cleans up
            if not ok:
                shutil.rmtree(self.split_root, ignore_errors=True)

    def get_new_destination(self, path: str, train: bool) -> str:
        base = self.train_dir if train else self.test_dir
        if self.labeling_type is LabelingType.DIRECTORY:
            label = self.get_path_label(path)
        else:
            label = self.get_name_label(path)
        return os.path.join(base, label, os.path.basename(path))

    @staticmethod
    def get_path_label(path: str) -> str:
        return os.path.basename(os.path.dirname(path))

    @staticmethod
    def get_name_label(path: str) -> str:
        """Label embedded in the file name as ...-<label>.<ext>."""
        name = os.path.basename(path)
        stem, dot, _ext = name.rpartition(".")
        if not dot:
            raise ValueError(f"Illegal path; no format found: {path}")
        _prefix, dash, label = stem.rpartition("-")
        if not dash:
            raise ValueError(
                f"Illegal path; no dash found (a dash marks the label): "
                f"{path}")
        return label

    # ----------------------------------------------------------- accessors
    def get_train(self) -> str:
        return self.train_dir

    def get_test(self) -> str:
        return self.test_dir
