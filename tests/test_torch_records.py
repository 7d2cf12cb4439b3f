"""The port's record readers, cloud I/O and the `--buckets` grammar
(deeplearning4j_tpu_torch/datasets/{records,cloud}.py,
serving/buckets.py `BucketLattice.from_spec`) against the JAX package's
on the CPU.

The readers feed the CLI: every batch (features, one-hot or regression
labels, masks) equals the JAX iterator's exactly, for CSV (label column
last or first, a header skipped, another delimiter), SVMLight, string
lists, per-sequence CSV directories and multi-reader MultiDataSets. The
JAX package may take its native whole-file path; the port's Python
path gives the same batches. Cloud paths: local directories are
buckets; a `gs://` URL without `gcloud`/`gsutil` raises a named error
before anything is attempted.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.datasets import cloud as jcloud
from deeplearning4j_tpu.datasets import records as jrec
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.serving.buckets import BucketLattice as JLattice
from deeplearning4j_tpu_torch.datasets import cloud, records
from deeplearning4j_tpu_torch.datasets.api import DataSet
from deeplearning4j_tpu_torch.serving.buckets import BucketLattice

pytestmark = pytest.mark.port


def _drain(it):
    out = []
    while it.has_next():
        out.append(it.next())
    return out


def _same_batches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
                continue
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.fixture
def csv_file(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(37, 5))
    y = rng.integers(0, 3, 37)
    path = tmp_path / "d.csv"
    with open(path, "w") as f:
        f.write("a,b,c,d,e,label\n")
        for row, label in zip(x, y):
            f.write(",".join(f"{v:.7g}" for v in row) + f",{label}\n")
    return path


@pytest.mark.parametrize("kw", [
    dict(num_classes=3), dict(num_classes=3, label_index=5),
    dict(regression=True), dict(), dict(num_classes=3, batch=37)],
    ids=["one-hot", "label-index", "regression", "raw-label", "one-batch"])
def test_csv_batches_equal_jax(csv_file, kw):
    kw = dict(kw)
    batch = kw.pop("batch", 8)

    def make(mod):
        return mod.RecordReaderDataSetIterator(
            mod.CSVRecordReader(str(csv_file), skip_lines=1), batch, **kw)

    ours, theirs = make(records), make(jrec)
    _same_batches(_drain(ours), _drain(theirs))
    ours.reset()
    theirs.reset()
    _same_batches(_drain(ours), _drain(theirs))  # a second pass after reset


def test_csv_label_first_and_another_delimiter(tmp_path):
    path = tmp_path / "d.tsv"
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for _ in range(10):
            f.write("\t".join([str(int(rng.integers(0, 2)))]
                              + [f"{v:.5f}" for v in rng.random(3)]) + "\n")

    def make(mod):
        return mod.RecordReaderDataSetIterator(
            mod.CSVRecordReader(str(path), delimiter="\t"), 4,
            label_index=0, num_classes=2)

    _same_batches(_drain(make(records)), _drain(make(jrec)))


@pytest.mark.parametrize("num_classes", [2, -1])
def test_svmlight_batches_equal_jax(tmp_path, num_classes):
    rng = np.random.default_rng(2)
    path = tmp_path / "d.svm"
    with open(path, "w") as f:
        f.write("# a comment line\n")
        for _ in range(21):
            idx = sorted(rng.choice(np.arange(1, 9), 3, replace=False))
            feats = " ".join(f"{i}:{rng.normal():.5f}" for i in idx)
            f.write(f"{int(rng.integers(0, 2))} {feats}\n")

    def make(mod):
        return mod.RecordReaderDataSetIterator(
            mod.SVMLightRecordReader(str(path), 8), 5,
            num_classes=num_classes)

    _same_batches(_drain(make(records)), _drain(make(jrec)))


def test_list_string_reader_batches_equal_jax():
    rows = [["0.5", "1.5", "1"], ["2.0", "-1.0", "0"], ["3.25", "0", "1"]]

    def make(mod):
        return mod.RecordReaderDataSetIterator(
            mod.ListStringRecordReader(rows), 2, num_classes=2)

    _same_batches(_drain(make(records)), _drain(make(jrec)))


@pytest.mark.parametrize("per_step", [True, False])
def test_sequence_iterator_from_csv_dirs_equals_jax(tmp_path, per_step):
    rng = np.random.default_rng(3)
    fdir, ldir = tmp_path / "f", tmp_path / "l"
    fdir.mkdir()
    ldir.mkdir()
    for i, t in enumerate((5, 3, 7, 2, 4)):
        np.savetxt(fdir / f"{i}.csv", rng.normal(size=(t, 3)),
                   delimiter=",", fmt="%.6f")
        labels = rng.integers(0, 4, t) if per_step else [rng.integers(0, 4)]
        np.savetxt(ldir / f"{i}.csv", labels, delimiter=",", fmt="%d")

    def make(mod):
        return mod.SequenceRecordReaderDataSetIterator.from_csv_dirs(
            str(fdir), str(ldir), 2, 4)

    _same_batches(_drain(make(records)), _drain(make(jrec)))


def test_multi_reader_iterator_equals_jax():
    a = [["1", "2", "3"], ["4", "5", "6"], ["7", "8", "9"]]
    b = [["0", "0.5"], ["2", "1.5"], ["1", "2.5"]]

    def make(mod):
        return (mod.RecordReaderMultiDataSetIterator(2)
                .add_input(mod.ListStringRecordReader(a), cols=[0, 2])
                .add_input(mod.ListStringRecordReader(b), cols=[1])
                .add_output(mod.ListStringRecordReader(b), cols=[0],
                            num_classes=3))

    ours, theirs = _drain(make(records)), _drain(make(jrec))
    assert len(ours) == len(theirs) == 2
    for m, n in zip(ours, theirs):
        for x, y in zip(m.features + m.labels, n.features + n.labels):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ cloud

def test_local_directories_are_buckets(tmp_path):
    bucket = tmp_path / "bucket"
    bucket.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        x = rng.normal(size=(4, 2)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        jcloud.save_dataset(JDataSet(x, y), str(bucket / f"{i}.npz"))
    (bucket / "notes.txt").write_text("not a dataset")
    ours = cloud.GcsDataSetIterator(str(bucket))
    theirs = jcloud.GcsDataSetIterator(str(bucket))
    assert ours.uris == theirs.uris
    _same_batches(_drain(ours), _drain(theirs))
    assert cloud.GcsDownloader().download(str(bucket)) == str(bucket)
    assert cloud.GcsDownloader().list(str(bucket)) == \
        jcloud.GcsDownloader().list(str(bucket))
    out = tmp_path / "up" / "m.bin"
    cloud.GcsUploader().upload(str(bucket / "notes.txt"), str(out))
    assert out.read_text() == "not a dataset"
    ds = DataSet(np.ones((2, 2), np.float32), np.zeros((2, 1), np.float32))
    cloud.save_dataset(ds, str(tmp_path / "ds.npz"))
    back = jcloud.load_dataset(str(tmp_path / "ds.npz"))
    np.testing.assert_array_equal(back.features, ds.features)
    with pytest.raises(IOError, match="no .npz datasets"):
        cloud.GcsDataSetIterator(str(tmp_path / "up"))


def test_a_remote_url_without_the_cloud_tools_raises_a_named_error(
        tmp_path, monkeypatch):
    monkeypatch.setattr(cloud.shutil, "which", lambda name: None)
    down = cloud.GcsDownloader(cache_dir=str(tmp_path / "cache"))
    with pytest.raises(cloud.CloudToolMissing, match="gs://b/x.csv"):
        down.download("gs://b/x.csv")
    with pytest.raises(cloud.CloudToolMissing):
        down.list("gs://b/")
    with pytest.raises(cloud.CloudToolMissing):
        cloud.GcsUploader().upload(__file__, "gs://b/y")
    assert issubclass(cloud.CloudToolMissing, RuntimeError)
    assert not (tmp_path / "cache").exists()


# ---------------------------------------------------------------- buckets

@pytest.mark.parametrize("spec", ["1,2,4,8", "8, 1,4", "1x64,4x64,4x256",
                                  "2x16"])
def test_bucket_spec_parses_as_jax(spec):
    ours, theirs = BucketLattice.from_spec(spec), JLattice.from_spec(spec)
    assert ours.describe() == theirs.describe()
    assert [b.key() for b in ours.shapes()] == \
        [b.key() for b in theirs.shapes()]


@pytest.mark.parametrize("spec", ["", "1x64,4", "0,2"])
def test_bad_bucket_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as ours:
        BucketLattice.from_spec(spec)
    with pytest.raises(ValueError) as theirs:
        JLattice.from_spec(spec)
    assert str(ours.value) == str(theirs.value)
