"""Record readers — the host-side data-loading library replacing Canova
(JAX counterpart deeplearning4j_tpu/datasets/records.py).

Reference: external canova-api record readers (CSV, SVMLight, image) bridged
by datasets/canova/RecordReaderDataSetIterator.java:47,
SequenceRecordReaderDataSetIterator and RecordReaderMultiDataSetIterator.

Host-side parsing; the batches are numpy arrays, which the networks
move to their device. A CSV or SVMLight reader also reads its whole file
at once through the port's native IO core (`to_matrix` / `to_arrays`,
deeplearning4j_tpu_torch/native), and `RecordReaderDataSetIterator`
takes that path where it applies, as the JAX package's does; otherwise
(no core, a non-numeric cell) it iterates the records, which gives the
same batches.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from deeplearning4j_tpu_torch.datasets.api import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


class RecordReader:
    """Iterates records (lists of values) from a source."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self):
        pass


class CSVRecordReader(RecordReader):
    """CSV lines → float records (reference canova CSVRecordReader)."""

    def __init__(self, path: str, skip_lines: int = 0, delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def to_matrix(self):
        """The whole file as a float32 matrix via the native IO core
        (deeplearning4j_tpu_torch/native), or None when the file has a
        non-numeric cell or the core is unavailable: callers then
        iterate the records."""
        from deeplearning4j_tpu_torch import native

        return native.load_csv(self.path, self.skip_lines, self.delimiter)

    def __iter__(self):
        with open(self.path, newline="") as f:
            r = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(r):
                if i < self.skip_lines or not row:
                    continue
                yield [v.strip() for v in row]


class SVMLightRecordReader(RecordReader):
    """SVMLight/LibSVM sparse format: `label idx:val idx:val ...`
    (reference canova SVMLightRecordReader; dl4j-test-resources/svmLight)."""

    def __init__(self, path: str, num_features: int):
        self.path = path
        self.num_features = num_features

    def to_arrays(self):
        """(labels, dense features) via the native IO core, or None."""
        from deeplearning4j_tpu_torch import native

        return native.load_svmlight(self.path, self.num_features)

    def __iter__(self):
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                label = float(parts[0])
                feats = np.zeros(self.num_features, np.float32)
                for tok in parts[1:]:
                    if ":" in tok:
                        i, v = tok.split(":")
                        feats[int(i) - 1] = float(v)
                yield label, feats


class ListStringRecordReader(RecordReader):
    def __init__(self, rows):
        self.rows = rows

    def __iter__(self):
        return iter(self.rows)


class RecordReaderDataSetIterator(DataSetIterator):
    """records → minibatched DataSets (reference
    datasets/canova/RecordReaderDataSetIterator.java:47). label_index
    selects the class column; num_classes one-hot encodes it; regression
    keeps the raw value."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: int = -1,
                 regression: bool = False):
        super().__init__()
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self._it = None
        self._done = False
        self._pending = None
        self.reset()

    def reset(self):
        self.reader.reset()
        self._matrix = self._try_native()
        self._mat_pos = 0
        self._it = iter(self.reader) if self._matrix is None else None
        self._done = False
        self._pending = None

    def _try_native(self):
        """The whole-file path (native IO core) when the reader has one;
        None leaves the per-record iteration."""
        if hasattr(self.reader, "to_matrix"):
            m = self.reader.to_matrix()
            if m is not None:
                li = self.label_index if self.label_index >= 0 else m.shape[1] - 1
                feats = np.delete(m, li, axis=1)
                return feats, m[:, li]
        if hasattr(self.reader, "to_arrays"):
            arrs = self.reader.to_arrays()
            if arrs is not None:
                labels, feats = arrs
                return feats, labels
        return None

    def _native_batch(self):
        feats, labels = self._matrix
        if self._mat_pos >= len(feats):
            self._done = True
            return None
        sl = slice(self._mat_pos, self._mat_pos + self.batch_size)
        self._mat_pos += self.batch_size
        x, l = feats[sl], labels[sl]
        if self.regression:
            y = np.asarray(l, np.float32)[:, None]
        elif self.num_classes > 0:
            y = np.eye(self.num_classes, dtype=np.float32)[
                np.asarray(l, np.int64)]
        else:
            y = np.asarray(l, np.float32)[:, None]
        return DataSet(np.ascontiguousarray(x), y)

    def _read_batch(self):
        if self._matrix is not None:
            return self._native_batch()
        feats, labels = [], []
        while len(feats) < self.batch_size:
            try:
                rec = next(self._it)
            except StopIteration:
                self._done = True
                break
            if isinstance(rec, tuple) and len(rec) == 2 and isinstance(
                    rec[1], np.ndarray):  # svmlight (label, features)
                label, f = rec
                feats.append(f)
                labels.append(label)
            else:
                vals = list(rec)
                li = self.label_index if self.label_index >= 0 else len(vals) - 1
                label = vals[li]
                f = [float(v) for j, v in enumerate(vals) if j != li]
                feats.append(np.asarray(f, np.float32))
                labels.append(label)
        if not feats:
            return None
        x = np.stack(feats)
        if self.regression:
            y = np.asarray([float(l) for l in labels], np.float32)[:, None]
        elif self.num_classes > 0:
            idx = np.asarray([int(float(l)) for l in labels])
            y = np.eye(self.num_classes, dtype=np.float32)[idx]
        else:
            y = np.asarray([float(l) for l in labels], np.float32)[:, None]
        return DataSet(x, y)

    def has_next(self):
        if self._pending is None and not self._done:
            self._pending = self._read_batch()
        return self._pending is not None

    def next(self, num=None):
        if not self.has_next():
            raise StopIteration
        ds, self._pending = self._pending, None
        return self._apply_pre(ds)

    def batch(self):
        return self.batch_size


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Per-sequence CSV files → padded+masked time-series DataSets
    (reference SequenceRecordReaderDataSetIterator). feature_dir and
    label_dir hold aligned files; variable lengths are padded and masked —
    the reference's variable-length masking path."""

    def __init__(self, sequences, labels, batch_size: int, num_classes: int = -1):
        """sequences: list of [T_i, F] arrays; labels: list of [T_i] int
        arrays (per-step classes) or scalars (per-sequence class)."""
        super().__init__()
        self.sequences = [np.asarray(s, np.float32) for s in sequences]
        self.labels = labels
        self.batch_size = batch_size
        self.num_classes = num_classes
        self._i = 0

    @staticmethod
    def from_csv_dirs(feature_dir, label_dir, batch_size, num_classes):
        seqs, labs = [], []
        for fname in sorted(os.listdir(feature_dir)):
            seqs.append(np.loadtxt(os.path.join(feature_dir, fname),
                                   delimiter=",", ndmin=2))
            labs.append(np.loadtxt(os.path.join(label_dir, fname),
                                   delimiter=",", ndmin=1))
        return SequenceRecordReaderDataSetIterator(seqs, labs, batch_size, num_classes)

    def has_next(self):
        return self._i < len(self.sequences)

    def next(self, num=None):
        n = num or self.batch_size
        seqs = self.sequences[self._i:self._i + n]
        labs = self.labels[self._i:self._i + n]
        self._i += n
        T = max(s.shape[0] for s in seqs)
        F = seqs[0].shape[1]
        B = len(seqs)
        x = np.zeros((B, T, F), np.float32)
        mask = np.zeros((B, T), np.float32)
        per_step = np.ndim(labs[0]) >= 1 and np.size(labs[0]) > 1
        if per_step:
            y = np.zeros((B, T, max(self.num_classes, 1)), np.float32)
        else:
            y = np.zeros((B, max(self.num_classes, 1)), np.float32)
        for b, (s, l) in enumerate(zip(seqs, labs)):
            t = s.shape[0]
            x[b, :t] = s
            mask[b, :t] = 1
            if per_step:
                idx = np.asarray(l, np.int64)[:t]
                y[b, np.arange(t), idx] = 1
            else:
                y[b, int(np.ravel(l)[0])] = 1
        return self._apply_pre(DataSet(x, y, features_mask=mask,
                                       labels_mask=mask if per_step else None))

    def reset(self):
        self._i = 0

    def batch(self):
        return self.batch_size


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Multiple readers → MultiDataSet (reference
    RecordReaderMultiDataSetIterator). Each named reader contributes inputs
    and/or outputs by column spec."""

    def __init__(self, batch_size: int):
        super().__init__()
        self.batch_size = batch_size
        self._inputs = []  # (reader, cols)
        self._outputs = []  # (reader, cols, num_classes)
        self._iters = None
        self._done = False
        self._pending = None

    def add_input(self, reader: RecordReader, cols=None):
        self._inputs.append((reader, cols))
        return self

    def add_output(self, reader: RecordReader, cols=None, num_classes: int = -1):
        self._outputs.append((reader, cols, num_classes))
        return self

    def reset(self):
        for r, *_ in self._inputs + self._outputs:
            r.reset()
        self._iters = ([iter(r) for r, _ in self._inputs],
                       [iter(r) for r, _, _ in self._outputs])
        self._done = False
        self._pending = None

    def _take(self, it, cols):
        rec = [float(v) for v in next(it)]
        if cols is not None:
            rec = [rec[c] for c in cols]
        return rec

    def _read_row(self):
        """Read one aligned row from ALL readers atomically: if any reader is
        exhausted the whole row is discarded (no misaligned partial rows)."""
        row_in, row_out = [], []
        try:
            for it, (_, cols) in zip(self._iters[0], self._inputs):
                row_in.append(self._take(it, cols))
            for it, (_, cols, _nc) in zip(self._iters[1], self._outputs):
                row_out.append(self._take(it, cols))
        except StopIteration:
            return None
        return row_in, row_out

    def _read_batch(self):
        in_rows = [[] for _ in self._inputs]
        out_rows = [[] for _ in self._outputs]
        count = 0
        while count < self.batch_size:
            row = self._read_row()
            if row is None:
                self._done = True
                break
            for j, r in enumerate(row[0]):
                in_rows[j].append(r)
            for j, r in enumerate(row[1]):
                out_rows[j].append(r)
            count += 1
        if count == 0:
            return None
        feats = [np.asarray(r, np.float32) for r in in_rows]
        labels = []
        for rows, (_, _, nc) in zip(out_rows, self._outputs):
            arr = np.asarray(rows, np.float32)
            if nc > 0:
                idx = arr.astype(np.int64).ravel()
                arr = np.eye(nc, dtype=np.float32)[idx]
            labels.append(arr)
        return MultiDataSet(feats, labels)

    def has_next(self):
        if self._iters is None:
            self.reset()
        if self._pending is None and not self._done:
            self._pending = self._read_batch()
        return self._pending is not None

    def next(self, num=None):
        if not self.has_next():
            raise StopIteration
        mds, self._pending = self._pending, None
        return mds

    def batch(self):
        return self.batch_size
