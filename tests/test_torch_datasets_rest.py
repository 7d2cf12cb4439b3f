"""The rest of datasets/ in the port (Iris, Curves, LFW, image records,
the async, multiple-epoch and sampling iterators, the vectorizer, the
train/test formatter) against the JAX package's modules on the CPU, an
LFW conv net trained by both packages, and the kerneltune sweep's
telemetry against its table (the check phase 26a of chip_smoke.py
makes on the card).

The loaders are host numpy in both packages, so each array compares bit
for bit. Image corpora are written by each package into a root of its
own and read back by each, once with Pillow and once with `_HAVE_PIL`
set False in both image loaders (the branch that runs wherever Pillow is
missing). The LFW fit starts both nets from the JAX package's params
(`weights_io.params_from_jax`) and holds the port's params after 2
epochs to NET_TOL (1e-4) of the largest entry of each layer's JAX
params, the tolerance of tests/test_torch_image_models.py for f32 nets
after Adam steps.
"""

import importlib.util
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.datasets import async_iterator as jasync
from deeplearning4j_tpu.datasets import curves as jcurves
from deeplearning4j_tpu.datasets import image_records as jrec
from deeplearning4j_tpu.datasets import iris as jiris
from deeplearning4j_tpu.datasets import iterators as jit
from deeplearning4j_tpu.datasets import lfw as jlfw
from deeplearning4j_tpu.datasets import rearrange as jre
from deeplearning4j_tpu.datasets import vectorizer as jvec
from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.util import image_loader as jil
from deeplearning4j_tpu_torch import datasets as tds
from deeplearning4j_tpu_torch.datasets import async_iterator as tasync
from deeplearning4j_tpu_torch.datasets import curves as tcurves
from deeplearning4j_tpu_torch.datasets import image_records as trec
from deeplearning4j_tpu_torch.datasets import iris as tiris
from deeplearning4j_tpu_torch.datasets import iterators as tit
from deeplearning4j_tpu_torch.datasets import lfw as tlfw
from deeplearning4j_tpu_torch.datasets import rearrange as tre
from deeplearning4j_tpu_torch.datasets import vectorizer as tvec
from deeplearning4j_tpu_torch.datasets.api import DataSet as TDataSet
from deeplearning4j_tpu_torch.datasets.records import RecordReader
from deeplearning4j_tpu_torch.util import image_loader as til

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
NET_TOL = 1e-4


@pytest.fixture(params=["pillow", "pnm"])
def codec(request, monkeypatch):
    """Both packages' image loaders with Pillow, then without it."""
    if request.param == "pnm":
        monkeypatch.setattr(jil, "_HAVE_PIL", False)
        monkeypatch.setattr(til, "_HAVE_PIL", False)
    return request.param


def _batches(it):
    out = []
    while it.has_next():
        ds = it.next()
        out.append((ds.features, ds.labels))
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (tx, ty), (jx, jy) in zip(got, want):
        assert tx.dtype == jx.dtype
        np.testing.assert_array_equal(tx, jx)
        if jy is None:
            assert ty is None
        else:
            np.testing.assert_array_equal(ty, jy)


def test_exports_are_the_jax_packages():
    import deeplearning4j_tpu.datasets as jds

    names = {n for n in dir(jds) if n[0].isupper()}
    assert names <= set(dir(tds)), names - set(dir(tds))
    for n in ("AsyncDataSetIterator", "IrisDataSetIterator",
              "LFWDataSetIterator", "CurvesDataFetcher",
              "CurvesDataSetIterator", "ImageRecordReader",
              "ImageRecordReaderDataSetIterator", "MultipleEpochsIterator",
              "SamplingDataSetIterator"):
        assert getattr(tds, n).__module__.startswith(
            "deeplearning4j_tpu_torch."), n


# ------------------------------------------------------------------- Iris

@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_iris_equals_jax_bit_for_bit(normalize, shuffle):
    for seed in (123, 7):
        j = jiris.load_iris_dataset(normalize, shuffle, seed)
        t = tiris.load_iris_dataset(normalize, shuffle, seed)
        assert t.features.dtype == np.float32 and t.features.shape == (150, 4)
        np.testing.assert_array_equal(t.features, j.features)
        np.testing.assert_array_equal(t.labels, j.labels)


def test_the_ports_iris_csv_is_scikit_learns():
    from sklearn.datasets import load_iris

    d = load_iris()
    data, target = tiris._read_iris()
    np.testing.assert_array_equal(data, d.data)
    np.testing.assert_array_equal(target, d.target)
    np.testing.assert_array_equal(data.astype(np.float32),
                                  d.data.astype(np.float32))
    header = Path(tiris.IRIS_CSV).read_text().splitlines()[0].split(",")
    assert header == ["150", "4", *d.target_names]


@pytest.mark.parametrize("batch,n", [(150, 150), (32, 150), (40, 100)])
def test_iris_iterator_equals_jax(batch, n):
    t = tds.IrisDataSetIterator(batch_size=batch, num_examples=n)
    j = jiris.IrisDataSetIterator(batch_size=batch, num_examples=n)
    assert t.total_outcomes() == j.total_outcomes() == 3
    _same_batches(_batches(t), _batches(j))


# ----------------------------------------------------------------- Curves

def test_curves_fetcher_equals_jax_bit_for_bit():
    for n, seed in ((12, 123), (5, 9)):
        t, j = tcurves.CurvesDataFetcher(n, seed), jcurves.CurvesDataFetcher(
            n, seed)
        assert t.features.shape == (n, 784) and t.features.dtype == np.float32
        np.testing.assert_array_equal(t.features, j.features)
        ft, fj = t.fetch(4), j.fetch(4)
        np.testing.assert_array_equal(ft.features, fj.features)
        np.testing.assert_array_equal(ft.labels, ft.features)
    _same_batches(_batches(tds.CurvesDataSetIterator(4, num_examples=12)),
                  _batches(jcurves.CurvesDataSetIterator(4, num_examples=12)))


# -------------------------------------------------------------------- LFW

def _tree_bytes(root):
    out = {}
    for base, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_lfw_corpora_decode_equal(tmp_path, codec):
    """Each package synthesizes the corpus into its own root: the same
    files byte for byte, decoded to equal arrays with equal labels, in
    the same shuffled batch order, read by either package."""
    kw = dict(n_people=3, images_per_person=5, size=16, seed=11)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jlfw.generate_synthetic_lfw(jroot, **kw)
    tlfw.generate_synthetic_lfw(troot, **kw)
    assert _tree_bytes(troot) == _tree_bytes(jroot)
    assert tlfw._has_real_lfw(troot) and jlfw._has_real_lfw(troot)
    assert not tlfw._has_real_lfw(str(tmp_path / "none"))
    args = dict(batch_size=4, image_size=16, shuffle=True, seed=5)
    t = tds.LFWDataSetIterator(data_dir=troot, **args)
    j = jlfw.LFWDataSetIterator(data_dir=jroot, **args)
    assert t.get_labels() == j.get_labels() == [f"person_{p:03d}"
                                                for p in range(3)]
    assert t.total_examples() == j.total_examples() == 15
    tb = _batches(t)
    _same_batches(tb, _batches(j))
    # the port reads the JAX package's corpus as its own
    _same_batches(_batches(tds.LFWDataSetIterator(data_dir=jroot, **args)),
                  tb)
    cut = tds.LFWDataSetIterator(data_dir=troot, num_examples=7, **args)
    _same_batches(_batches(cut), _batches(jlfw.LFWDataSetIterator(
        data_dir=jroot, num_examples=7, **args)))
    assert tlfw._DEFAULT_DIR.endswith(os.path.join(
        ".deeplearning4j_tpu_torch", "lfw"))


def test_lfw_real_layout_is_read_as_it_is(tmp_path):
    """A root that already holds person directories is read, not
    overwritten with a synthetic corpus."""
    rng = np.random.default_rng(12)
    for person in ("ann", "bob"):
        os.makedirs(tmp_path / person)
        for i in range(2):
            til.ImageLoader.save(rng.random((8, 8, 3)),
                                 str(tmp_path / person / f"{i}.png"))
    t = tds.LFWDataSetIterator(batch_size=8, data_dir=str(tmp_path),
                               image_size=8)
    j = jlfw.LFWDataSetIterator(batch_size=8, data_dir=str(tmp_path),
                                image_size=8)
    assert t.get_labels() == ["ann", "bob"]
    assert not (tmp_path / ".synthetic_complete").exists()
    _same_batches(_batches(t), _batches(j))


# ---------------------------------------------------------- image records

def _image_tree(root, labels=("cat", "dog", "emu"), per=4, size=10, seed=13):
    rng = np.random.default_rng(seed)
    for label in labels:
        os.makedirs(os.path.join(root, label))
        for i in range(per):
            ext = (".png", ".ppm", ".pgm", ".png")[i % 4]
            c = 1 if ext == ".pgm" else 3
            til.ImageLoader.save(rng.random((size + i, size, c)),
                                 os.path.join(root, label, f"{i}{ext}"))
        with open(os.path.join(root, label, "notes.txt"), "w") as f:
            f.write("not an image")


def test_image_record_reader_equals_jax(tmp_path, codec):
    _image_tree(str(tmp_path))
    for labels in (None, ["emu", "cat", "dog"]):
        t = trec.ImageRecordReader(str(tmp_path), 10, 10, 3, labels=labels)
        j = jrec.ImageRecordReader(str(tmp_path), 10, 10, 3, labels=labels)
        assert isinstance(t, RecordReader)
        assert t.labels == j.labels and t.num_examples() == 12
        assert t._files == j._files
        for (ta, tl), (ja, jl) in zip(t, j):
            assert tl == jl and ta.shape == (10, 10, 3)
            np.testing.assert_array_equal(ta, ja)
        for shuffle in (False, True):
            ti = tds.ImageRecordReaderDataSetIterator(t, 5, shuffle=shuffle,
                                                      seed=7)
            ji = jrec.ImageRecordReaderDataSetIterator(j, 5, shuffle=shuffle,
                                                       seed=7)
            assert ti.async_supported() and ti.batch() == 5
            assert ti.total_examples() == 12 and ti.total_outcomes() == 3
            assert ti.get_labels() == ji.get_labels()
            first = _batches(ti)
            _same_batches(first, _batches(ji))
            ti.reset()
            ji.reset()
            _same_batches(_batches(ti), _batches(ji))
            assert first[0][0].shape == (5, 10, 10, 3)
            assert first[0][1].shape == (5, 3)


def test_image_record_reader_empty_dir_raises(tmp_path):
    os.makedirs(tmp_path / "empty_label")
    for mod in (jrec, trec):
        with pytest.raises(IOError, match="no image files"):
            mod.ImageRecordReader(str(tmp_path), 8, 8)


# -------------------------------------------------------------- iterators

def _datasets(DataSet, n_batches=6, rows=4, seed=0):
    """test_data_pipeline.py's make_datasets, in either package."""
    rng = np.random.default_rng(seed)
    return [DataSet(rng.random((rows, 3), dtype=np.float32) + i,
                    np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)])
            for i in range(n_batches)]


class _Failing(tit.DataSetIterator):
    """test_data_pipeline.py's FailingIterator: `fail_after` batches, then
    a raise on the next pull."""

    def __init__(self, datasets, fail_after):
        super().__init__()
        self._data, self._fail_after, self._i = datasets, fail_after, 0

    def has_next(self):
        return self._i < len(self._data)

    def next(self, num=None):
        if self._i >= self._fail_after:
            raise RuntimeError(f"record decode failed at batch {self._i}")
        ds = self._data[self._i]
        self._i += 1
        return ds

    def reset(self):
        self._i = 0


def test_async_iterator_underlying_error_propagates():
    it = tds.AsyncDataSetIterator(_Failing(_datasets(TDataSet), 2),
                                  queue_size=2)
    assert it.next() is not None
    assert it.next() is not None
    with pytest.raises(RuntimeError, match="record decode failed"):
        it.has_next()


def test_async_iterator_reset_after_producer_error():
    under = _Failing(_datasets(TDataSet), 3)
    it = tds.AsyncDataSetIterator(under, queue_size=1)
    it.next()
    with pytest.raises(RuntimeError):
        while it.has_next():
            it.next()
    under._fail_after = 99
    it.reset()
    count = 0
    while it.has_next():
        it.next()
        count += 1
    assert count == 6


def test_async_iterator_reset_with_producer_blocked_on_full_queue():
    data = _datasets(TDataSet, 8)
    it = tds.AsyncDataSetIterator(tds.ListDataSetIterator(data), queue_size=1)
    it.next()
    time.sleep(0.05)  # let the producer park on the full channel
    it.reset()
    got = []
    while it.has_next():
        got.append(float(it.next().features[0, 0]))
    assert got == [float(d.features[0, 0]) for d in data]


def test_async_iterator_equals_jax_and_passes_through():
    """The same batches as the JAX adapter over the same data, twice
    (reset between), StopIteration at the end, a preprocessor applied on
    the consumer side, and batch / total_examples / input_columns /
    total_outcomes from the underlying iterator."""
    tdata, jdata = _datasets(TDataSet, 5), _datasets(JDataSet, 5)
    t = tasync.AsyncDataSetIterator(tds.ArrayDataSetIterator(
        np.concatenate([d.features for d in tdata]),
        np.concatenate([d.labels for d in tdata]), 3), queue_size=2)
    j = jasync.AsyncDataSetIterator(jit.ArrayDataSetIterator(
        np.concatenate([d.features for d in jdata]),
        np.concatenate([d.labels for d in jdata]), 3), queue_size=2)
    for _ in range(2):
        _same_batches(_batches(t), _batches(j))
        with pytest.raises(StopIteration):
            t.next()
        t.reset()
        j.reset()
    for name in ("batch", "total_examples", "input_columns",
                 "total_outcomes"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert (t.batch(), t.total_examples(), t.input_columns()) == (3, 20, 3)
    seen = []
    t.set_pre_processor(lambda ds: seen.append(ds.num_examples()))
    assert [ds.num_examples() for ds in t] == [3] * 6 + [2]
    assert seen == [3] * 6 + [2]


def test_multiple_epochs_iterator_equals_jax():
    tdata, jdata = _datasets(TDataSet, 3), _datasets(JDataSet, 3)
    t = tds.MultipleEpochsIterator(3, tds.ListDataSetIterator(tdata))
    j = jit.MultipleEpochsIterator(3, jit.ListDataSetIterator(jdata))
    tb = _batches(t)
    assert len(tb) == 9 and t.batch() == j.batch()
    _same_batches(tb, _batches(j))
    t.reset()
    j.reset()
    _same_batches(_batches(t), _batches(j))
    # over an async iterator, as chip_smoke's phase 28c feeds the flagship
    a = tds.MultipleEpochsIterator(2, tds.AsyncDataSetIterator(
        tds.ListDataSetIterator(tdata), queue_size=2))
    _same_batches(_batches(a), [(d.features, d.labels) for d in tdata] * 2)


def test_sampling_iterator_equals_jax():
    """The same rows for the same seed: over Iris, over a labelless set,
    with `next(num)`, across a reset (which does not reseed)."""
    ti, ji = tiris.load_iris_dataset(), jiris.load_iris_dataset()
    t = tds.SamplingDataSetIterator(ti, 32, 150, seed=4)
    j = jit.SamplingDataSetIterator(ji, 32, 150, seed=4)
    assert t.batch() == 32
    first = _batches(t)
    assert len(first) == 5 and first[0][0].shape == (32, 4)
    _same_batches(first, _batches(j))
    t.reset()
    j.reset()
    _same_batches(_batches(t), _batches(j))
    x = np.random.default_rng(14).random((9, 2)).astype(np.float32)
    t = tds.SamplingDataSetIterator(TDataSet(x, None), 4, 10, seed=1)
    j = jit.SamplingDataSetIterator(JDataSet(x, None), 4, 10, seed=1)
    assert t.next(3).num_examples() == 3
    j.next(3)
    _same_batches(_batches(t), _batches(j))


# ------------------------------------------------- vectorizer, rearrange

@pytest.mark.parametrize("mode", ["raw", "normalize", "binarize"])
def test_image_vectorizer_equals_jax(tmp_path, codec, mode):
    img = np.arange(64, dtype=np.float32).reshape(8, 8, 1) / 63.0
    rgb = np.random.default_rng(15).random((9, 7, 3)).astype(np.float32)
    for name, arr in (("img.pgm", img), ("rgb.png", rgb)):
        p = str(tmp_path / name)
        til.ImageLoader.save(arr, p)
        for size in (None, (4, 5)):
            t = tvec.ImageVectorizer(p, num_labels=3, label=1, size=size)
            j = jvec.ImageVectorizer(p, num_labels=3, label=1, size=size)
            if mode == "normalize":
                t, j = t.normalize(), j.normalize()
            elif mode == "binarize":
                t, j = t.binarize(30), j.binarize(30)
            td, jd = t.vectorize(), j.vectorize()
            assert td.features.shape[0] == 1 and td.features.ndim == 4
            np.testing.assert_array_equal(td.features, jd.features)
            np.testing.assert_array_equal(td.labels, [[0, 1, 0]])
            top = td.features.max()
            assert {"raw": top > 1.0, "normalize": top <= 1.0,
                    "binarize": set(np.unique(td.features)) <= {0.0, 1.0}
                    }[mode]
    with pytest.raises(NotImplementedError):
        tvec.Vectorizer().vectorize()


def _raw_tree(src, subs=("",), labels=("cat", "dog"), n=10):
    for sub in subs:
        for label in labels:
            d = src / sub / label
            d.mkdir(parents=True)
            for i in range(n):
                (d / f"img{i}.txt").write_text(f"{sub}{label}{i}")


def _split_map(fmt):
    out = {}
    for part, base in (("train", fmt.get_train()), ("test", fmt.get_test())):
        for d, _dirs, names in os.walk(base):
            for n in names:
                with open(os.path.join(d, n)) as f:
                    out[f.read()] = (part, os.path.relpath(
                        os.path.join(d, n), base))
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_formatter_splits_as_jax_does(tmp_path, seed):
    """The same file-to-split map for the same seed, the counts, and a
    refusal to overwrite an existing split."""
    src = tmp_path / "raw"
    _raw_tree(src)
    maps = {}
    for tag, mod in (("jax", jre), ("port", tre)):
        fmt = mod.LocalUnstructuredDataFormatter(
            str(tmp_path / tag), str(src), mod.LabelingType.DIRECTORY,
            percent_train=0.8, seed=seed)
        fmt.rearrange()
        assert (fmt.num_examples_total, fmt.num_examples_to_train_on,
                fmt.num_test_examples) == (20, 16, 4)
        maps[tag] = _split_map(fmt)
        with pytest.raises(FileExistsError):
            mod.LocalUnstructuredDataFormatter(
                str(tmp_path / tag), str(src), mod.LabelingType.DIRECTORY)
    assert maps["port"] == maps["jax"] and len(maps["port"]) == 20
    assert sum(p == "train" for p, _ in maps["port"].values()) == 16


def test_formatter_duplicates_and_name_labels_as_jax(tmp_path):
    """Duplicate basenames under one label survive (renamed as JAX
    renames them); NAME labels parse from "-<label>.<ext>"; a bad name
    raises the JAX package's errors before any copy and leaves no split
    behind."""
    src = tmp_path / "raw"
    _raw_tree(src, subs=("part_a", "part_b"), labels=("cat",), n=2)
    named = tmp_path / "named"
    named.mkdir()
    for i, label in enumerate(("cat", "dog", "cat", "emu")):
        (named / f"x{i}-{label}.png").write_text(f"{i}{label}")
    maps = {}
    for tag, mod in (("jax", jre), ("port", tre)):
        fmt = mod.LocalUnstructuredDataFormatter(
            str(tmp_path / f"dup_{tag}"), str(src),
            mod.LabelingType.DIRECTORY, percent_train=1.0, seed=0)
        fmt.rearrange()
        maps[tag] = _split_map(fmt)
        fmt = mod.LocalUnstructuredDataFormatter(
            str(tmp_path / f"name_{tag}"), str(named), mod.LabelingType.NAME,
            percent_train=0.5, seed=1)
        fmt.rearrange()
        maps[tag + "_name"] = _split_map(fmt)
        assert sorted(os.listdir(fmt.get_train()) + os.listdir(
            fmt.get_test())) in (["cat", "dog", "emu"],
                                 ["cat", "cat", "dog", "emu"])
    assert maps["port"] == maps["jax"] and len(maps["port"]) == 4
    assert maps["port_name"] == maps["jax_name"]
    F, J = tre.LocalUnstructuredDataFormatter, jre.LocalUnstructuredDataFormatter
    assert F.get_name_label("/data/img1-cat.png") == "cat"
    for bad in ("/data/nolabel.png", "/data/noext"):
        with pytest.raises(ValueError) as te:
            F.get_name_label(bad)
        with pytest.raises(ValueError) as je:
            J.get_name_label(bad)
        assert str(te.value) == str(je.value)
    (named / "broken.png").write_text("no dash")
    for tag, mod in (("jax", jre), ("port", tre)):
        fmt = mod.LocalUnstructuredDataFormatter(
            str(tmp_path / f"bad_{tag}"), str(named), mod.LabelingType.NAME,
            seed=0)
        with pytest.raises(ValueError, match="no dash"):
            fmt.rearrange()
        assert not os.path.exists(fmt.split_root)


# ------------------------------------------------------------ the LFW fit

def _lfw_conf(conf):
    return (conf.NeuralNetConfiguration.builder().seed(0).learning_rate(0.01)
            .updater("adam").list()
            .layer(conf.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                         convolution_mode="same",
                                         activation="relu"))
            .layer(conf.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(conf.OutputLayer(n_out=3, activation="softmax",
                                    loss_function="mcxent"))
            .set_input_type(conf.InputType.convolutional(16, 16, 3))
            .build())


def test_lfw_trains_a_small_conv_net_as_jax_does(tmp_path):
    """tests/test_datasets.py's LFW example (16 x 16, 3 people, 4 images
    each, batch 8, Adam 0.01, 2 epochs) in both packages, each over its
    own corpus, from the JAX package's initial params: the port's params
    after 2 epochs agree within NET_TOL of each layer's largest JAX
    param."""
    from deeplearning4j_tpu.nn import conf as jconf
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.weights_io import (params_from_jax,
                                                     params_to_numpy)

    kw = dict(batch_size=8, image_size=16, n_people=3, images_per_person=4)
    jnet = JNet(_lfw_conf(jconf)).init()
    tnet = MultiLayerNetwork(_lfw_conf(tconf), device="cpu").init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    start = jax.tree.map(np.asarray, jnet.params)
    jnet.fit(jlfw.LFWDataSetIterator(data_dir=str(tmp_path / "j"), **kw),
             epochs=2)
    tnet.fit(tds.LFWDataSetIterator(data_dir=str(tmp_path / "t"), **kw),
             epochs=2)
    assert np.isfinite(tnet.score_value)
    assert abs(tnet.score_value - jnet.score_value) <= 1e-4 * max(
        1.0, abs(jnet.score_value))
    assert tnet.iteration_count == 4
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    assert jp.keys() == tp.keys()
    for layer in jp:
        scale = max((float(np.abs(a).max()) for a in jp[layer].values()),
                    default=0.0)
        for name, want in jp[layer].items():
            err = float(np.abs(tp[layer][name] - want).max())
            assert err <= NET_TOL * scale, (layer, name, err, scale)
            # 4 Adam steps of 0.01 moved every param far past the limit
            moved = float(np.abs(want - start[layer][name]).max())
            assert moved > 100 * NET_TOL * scale, (layer, name, moved)


# ---------------------------------------------- the sweep's telemetry (C9)

def _kerneltune():
    spec = importlib.util.spec_from_file_location(
        "kerneltune", ROOT / "port_tools" / "kerneltune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Torch:
    """What the sweep asks of torch beside its (stubbed) cases."""

    class cuda:
        @staticmethod
        def empty_cache():
            pass


@pytest.fixture
def fake_sweep(monkeypatch):
    """kerneltune's `sweep` over two of its quick configs with the card's
    parts stubbed: a case of one row, a check that rejects one candidate
    a config, and times in which one candidate beats the default.
    Returns (kerneltune, run) with run(recorder) -> table."""
    kt = _kerneltune()
    configs = [c for c in kt.sweep_configs(quick=True)
               if c["family"] in ("fused_layer_norm", "sample")]

    class Case:
        def __init__(self, torch, cfg):
            self.rows = [{"label": cfg["family"]}]

    def measure(torch, case, params_by_row, repeats):
        p = params_by_row[0] or {}
        if p == cands[case.rows[0]["label"]][0]:
            return False, None, ["fails its plain-version check"]
        fast = p == cands[case.rows[0]["label"]][1]
        return True, [5.0 if fast else 10.0 + len(str(p))], ["ok"]

    cands = {c["family"]: kt.candidates(c, kt.default_params(c))
             for c in configs}
    monkeypatch.setattr(kt, "Case", Case)
    monkeypatch.setattr(kt, "measure", measure)

    def run(rec):
        entries = kt.sweep(_Torch, configs, 1, 0.03, rec)
        return {"version": 1, "provenance": {}, "entries": entries}

    return kt, run


def test_sweep_telemetry_passes_the_26a_audit(fake_sweep):
    """The sweep emits only `kernel_tune` events (no span), one `chosen`
    event an entry with its wall seconds, and the audit of phase 26a
    finds nothing wrong."""
    from deeplearning4j_tpu_torch.telemetry import Recorder

    kt, run = fake_sweep
    rec = Recorder()
    table = run(rec)
    events = list(rec.events)
    assert len(table["entries"]) == 2
    assert not [e for e in events if e["event"] == "span"]
    chosen = [e for e in events if e.get("role") == "chosen"]
    assert len(chosen) == 2 and all(e["wall_seconds"] >= 0 for e in chosen)
    assert sum(e.get("role") == "rejected" for e in events) == 2
    assert kt.audit(table, events) == []


def test_the_26a_audit_catches_what_c9_was(fake_sweep):
    """A `kerneltune_config` span (fault C9), a second `chosen` event, a
    chosen event without its wall seconds, a chosen event for a key the
    table lacks, and an entry whose params were rejected are each
    reported."""
    from deeplearning4j_tpu_torch.telemetry import Recorder

    kt, run = fake_sweep
    rec = Recorder()
    table = run(rec)
    good = list(rec.events)
    key = next(iter(table["entries"]))
    chosen = next(e for e in good if e.get("role") == "chosen"
                  and e["key"] == key)
    rejected = next(e for e in good if e.get("role") == "rejected"
                    and e["key"] == key)
    span = {"event": "span", "name": "kerneltune_config", "seconds": 1.0}
    bare = {k: v for k, v in chosen.items() if k != "wall_seconds"}
    stray = dict(chosen, key="softmax_xent:1:1")
    cases = {
        "unregistered span names": good + [span],
        f"{key}: chosen": good + [dict(chosen)],
        "no wall_seconds": [bare if e is chosen else e for e in good],
        "keys the table lacks": good + [stray],
    }
    for what, events in cases.items():
        bad = kt.audit(table, events)
        assert any(what in b for b in bad), (what, bad)
    forged = {**table, "entries": {**table["entries"], key: {
        **table["entries"][key], **rejected["params"]}}}
    assert any(key in b for b in kt.audit(forged, good))
