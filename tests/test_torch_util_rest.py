"""The rest of util/ in the port (image_loader, disk_queue, moving_window,
sloppy_math, string_grid, time_series, viterbi) against the JAX
package's modules on the CPU.

Each case runs the JAX module and the port's on the same inputs (the JAX
tests' own cases of test_small_utils.py and test_util_extras.py, and one
input a module made from a numpy seed) and holds the port to the JAX
result exactly: these modules are host numpy and Python in both, so
every array compares bit for bit and every string as it is. The image
loader runs once with Pillow and once with `_HAVE_PIL` set False in
both modules, the branch that runs wherever Pillow is missing.
"""

import math
import os

import numpy as np
import pytest

from deeplearning4j_tpu.util import disk_queue as jdq
from deeplearning4j_tpu.util import image_loader as jil
from deeplearning4j_tpu.util import moving_window as jmw
from deeplearning4j_tpu.util import sloppy_math as jsm
from deeplearning4j_tpu.util import string_grid as jsg
from deeplearning4j_tpu.util import time_series as jts
from deeplearning4j_tpu.util import viterbi as jvi
from deeplearning4j_tpu_torch.util import disk_queue as tdq
from deeplearning4j_tpu_torch.util import image_loader as til
from deeplearning4j_tpu_torch.util import moving_window as tmw
from deeplearning4j_tpu_torch.util import sloppy_math as tsm
from deeplearning4j_tpu_torch.util import string_grid as tsg
from deeplearning4j_tpu_torch.util import time_series as tts
from deeplearning4j_tpu_torch.util import viterbi as tvi

pytestmark = pytest.mark.port


@pytest.fixture(params=["pillow", "pnm"])
def codec(request, monkeypatch):
    """Both packages' image loaders with Pillow, then without it."""
    if request.param == "pnm":
        monkeypatch.setattr(jil, "_HAVE_PIL", False)
        monkeypatch.setattr(til, "_HAVE_PIL", False)
    else:
        assert til._HAVE_PIL and jil._HAVE_PIL
    return request.param


# --------------------------------------------------------- image loader

@pytest.mark.parametrize("name", ["a.png", "a.ppm", "a.pgm"])
def test_image_loader_round_trip_matches_jax(tmp_path, codec, name):
    """`save` then `as_array`, the row vector and the matrix of two
    files: the port's bytes are the JAX package's and decode to the same
    arrays (to within one 8-bit step of the saved floats)."""
    rng = np.random.default_rng(0)
    c = 1 if name.endswith(".pgm") else 3
    img = rng.random((20, 30, c)).astype(np.float32)
    jp, tp = str(tmp_path / f"j_{name}"), str(tmp_path / f"t_{name}")
    jil.ImageLoader.save(img, jp)
    til.ImageLoader.save(img, tp)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    for ch in (1, 3):
        want = jil.ImageLoader(channels=ch).as_array(jp)
        got = til.ImageLoader(channels=ch).as_array(tp)
        assert got.dtype == np.float32 and got.shape == (20, 30, ch)
        np.testing.assert_array_equal(got, want)
    back = til.ImageLoader(channels=c).as_array(tp)
    np.testing.assert_allclose(back, img, atol=1 / 255 + 1e-6)
    np.testing.assert_array_equal(
        til.ImageLoader(channels=c).as_row_vector(tp),
        jil.ImageLoader(channels=c).as_row_vector(jp))
    np.testing.assert_array_equal(
        til.ImageLoader(8, 12, c).as_matrix([tp, tp]),
        jil.ImageLoader(8, 12, c).as_matrix([jp, jp]))


def test_image_loader_resize_and_grayscale_match_jax(tmp_path, codec):
    """The JAX test's half-white image, resized to 8 x 8 grayscale, and a
    seeded image resized up and down in both channel counts."""
    img = np.zeros((16, 16, 3), np.float32)
    img[:8] = 1.0
    rng = np.random.default_rng(1)
    rand = rng.random((21, 13, 3)).astype(np.float32)
    for tag, arr in (("half", img), ("rand", rand)):
        path = str(tmp_path / f"{tag}.png")
        til.ImageLoader.save(arr, path)
        for h, w, ch in ((8, 8, 1), (8, 8, 3), (32, 7, 3), (5, 40, 1)):
            want = jil.ImageLoader(h, w, channels=ch).as_array(path)
            got = til.ImageLoader(h, w, channels=ch).as_array(path)
            assert got.shape == (h, w, ch)
            np.testing.assert_array_equal(got, want)
    arr = til.ImageLoader(8, 8, channels=1).as_array(str(tmp_path / "half.png"))
    assert arr[:3].mean() > 0.9 and arr[-3:].mean() < 0.1


def test_crop_to_square_matches_jax():
    rng = np.random.default_rng(2)
    for shape in ((6, 4, 1), (4, 6, 3), (5, 5, 3), (9, 2, 1)):
        arr = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(til.crop_to_square(arr),
                                      jil.crop_to_square(arr))
    assert til.crop_to_square(np.zeros((6, 4, 1))).shape == (4, 4, 1)


def _pnm(magic, w, h, body, header=None):
    return (header or b"%s\n# a comment line\n%d %d # trailing\n255\n"
            % (magic, w, h)) + body


@pytest.mark.parametrize("magic,c", [(b"P5", 1), (b"P6", 3)])
def test_hand_written_pnm_with_comments(tmp_path, magic, c):
    """P5 and P6 files written by hand, with comment lines in the header,
    decode in both packages to the same pixels."""
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (3, 5, c), dtype=np.uint8)
    path = tmp_path / ("x.pgm" if c == 1 else "x.ppm")
    path.write_bytes(_pnm(magic, 5, 3, px.tobytes()))
    np.testing.assert_array_equal(til._read_pnm(str(path)), px)
    np.testing.assert_array_equal(til._read_pnm(str(path)),
                                  jil._read_pnm(str(path)))
    got = til.ImageLoader(channels=c).as_array(str(path))
    np.testing.assert_array_equal(got, px.astype(np.float32) / 255.0)


def test_pnm_and_loader_errors_match_jax(tmp_path):
    """A maxval other than 255, an unknown magic, channels other than 1
    or 3, and a height without a width raise the JAX package's
    errors."""
    deep = tmp_path / "deep.pgm"
    deep.write_bytes(b"P5\n2 2\n65535\n" + bytes(8))
    odd = tmp_path / "odd.ppm"
    odd.write_bytes(b"P3\n2 2\n255\n" + bytes(12))
    for path, match in ((deep, "maxval 65535"), (odd, "magic")):
        for mod in (jil, til):
            with pytest.raises(ValueError, match=match):
                mod._read_pnm(str(path))
    for kw, match in (({"channels": 2}, "channels"),
                      ({"height": 8}, "height and width")):
        for mod in (jil, til):
            with pytest.raises(ValueError, match=match):
                mod.ImageLoader(**kw)


def test_resize_nearest_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (17, 11, 3), dtype=np.uint8)
    for h, w in ((1, 1), (17, 11), (34, 5), (3, 40)):
        np.testing.assert_array_equal(til._resize_nearest(img, h, w),
                                      jil._resize_nearest(img, h, w))


# ------------------------------------------------------------ disk queue

def _drain(q):
    out = []
    while not q.is_empty():
        out.append(q.poll())
    return out


def test_disk_based_queue_matches_jax(tmp_path):
    """The JAX test's sequence in both, then a seeded stream of arrays
    and objects, polled back in order and equal to what was added."""
    got = {}
    for tag, mod in (("jax", jdq), ("port", tdq)):
        q = mod.DiskBasedQueue(str(tmp_path / tag))
        assert q.is_empty() and q.poll() is None and q.peek() is None
        q.add({"a": 1})
        assert q.offer([1, 2])
        q.add_all(["three"])
        assert len(q) == 3 and q.peek() == {"a": 1}
        rng = np.random.default_rng(5)
        items = [rng.standard_normal((3, 4)).astype(np.float32),
                 {"tokens": rng.integers(0, 100, 7)}, (1.5, "x")]
        q.add_all(items)
        got[tag] = _drain(q)
        assert q.poll() is None
        q.add(1)
        q.clear()
        assert q.is_empty()
        assert os.listdir(q.dir) == [mod.DiskBasedQueue._MARKER]
        q.close()
        assert not os.path.exists(q.dir)
    j, t = got["jax"], got["port"]
    assert j[:3] == t[:3] == [{"a": 1}, [1, 2], "three"]
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[4]["tokens"], j[4]["tokens"])
    assert t[5] == j[5]


@pytest.mark.parametrize("mod", [jdq, tdq], ids=["jax", "port"])
def test_disk_queue_refuses_a_foreign_directory(tmp_path, mod):
    d = tmp_path / "data"
    d.mkdir()
    (d / "precious.txt").write_text("keep me")
    with pytest.raises(ValueError, match="refusing to clear"):
        mod.DiskBasedQueue(str(d))
    assert (d / "precious.txt").exists()
    f = tmp_path / "file"
    f.write_text("x")
    with pytest.raises(ValueError, match="directory"):
        mod.DiskBasedQueue(str(f))
    q1 = mod.DiskBasedQueue(str(tmp_path / "q"))
    q1.add(1)
    q2 = mod.DiskBasedQueue(str(tmp_path / "q"))
    assert q2.is_empty()
    q3 = mod.DiskBasedQueue()
    assert os.path.isdir(q3.dir)
    q3.close()


# ----------------------------------------------------------- sloppy math

def test_sloppy_math_matches_jax_cases():
    for sm in (jsm, tsm):
        assert np.isclose(sm.log_add(math.log(2), math.log(3)), math.log(5))
        assert np.isclose(sm.log_add([0.0, math.log(2), math.log(3)]),
                          math.log(6))
        assert sm.log_add(0.0, -40.0) == 0.0
        assert np.isclose(sm.log_subtract(math.log(5), math.log(2)),
                          math.log(3))
        np.testing.assert_allclose(np.exp(sm.log_normalize([0.0, 0.0])),
                                   [0.5, 0.5])
        assert sm.n_choose_k(5, 2) == 10 and sm.int_pow(3, 5) == 243
        assert sm.is_dangerous(float("nan")) and sm.is_dangerous(0.0)
        assert not sm.is_dangerous(1.0)


def test_sloppy_math_seeded_inputs_equal_jax():
    rng = np.random.default_rng(6)
    v = rng.standard_normal(50) * 20
    a, b = sorted(rng.standard_normal(2) * 5, reverse=True)
    same = [
        ("log_add", (v,)), ("log_add", (a, b)), ("log_add", ([],)),
        ("log_add", ([-np.inf, -np.inf],)), ("log_subtract", (a, b)),
        ("log_subtract", (a, a)), ("add_exp", (v / 10,)),
        ("n_choose_k", (30, 11)), ("int_pow", (1.5, 13)), ("int_pow", (7, 0)),
        ("approx_log", (abs(a) + 1,)), ("approx_exp", (b,)),
        ("sloppy_max", (a, b, 0.5)), ("sloppy_min", (a, b, 0.5)),
        ("relative_difference", (a, b)), ("relative_difference", (0.0, 0.0)),
        ("is_discrete_prob", (1.0 - 1e-7,)), ("is_very_dangerous", (np.inf,)),
        ("is_dangerous", (b,)),
    ]
    for name, args in same:
        assert getattr(tsm, name)(*args) == getattr(jsm, name)(*args), name
    np.testing.assert_array_equal(tsm.log_normalize(v), jsm.log_normalize(v))
    assert tsm.LOG_TOLERANCE == jsm.LOG_TOLERANCE
    for name, args in (("log_subtract", (b - 1, b)), ("int_pow", (2, -1))):
        for sm in (jsm, tsm):
            with pytest.raises(ValueError):
                getattr(sm, name)(*args)


# ----------------------------------------------------------- string grid

def _grid_ops(sg, lines, path):
    """The JAX tests' string-grid sequence; returns what it observed."""
    out = []
    c = sg.StringCluster(["Two words", "TWO words", "words two", "other"])
    out += [sg.fingerprint("Two words"), sg.fingerprint("words TWO!"),
            len(c), c.get_clusters()]
    g = sg.StringGrid.from_lines(lines, ",")
    out += [len(g), g.num_columns]
    g.remove_rows_with_empty_column(0)
    dup = g.get_rows_with_duplicate_values_in_column(0)
    out += [len(g), dup.rows]
    g.dedupe_by_cluster(0)
    out.append(g.rows)
    g.write_lines_to(path)
    out.append(sg.StringGrid.from_file(path, ",").rows)
    s = sg.StringGrid(",", rows=[["color", "colour"], ["color", "zebra"]])
    out.append(s.get_all_with_similarity(0.8, 0, 1).rows)
    return out


def test_string_grid_matches_jax_cases(tmp_path):
    lines = ["a,1,x", "b,2,y", "a,3,z", "A,4,w", ",5,v"]
    j = _grid_ops(jsg, lines, str(tmp_path / "j.csv"))
    t = _grid_ops(tsg, lines, str(tmp_path / "t.csv"))
    assert t == j
    assert t[2] == 2 and sum(t[3][0].values()) == 3
    assert t[6] == 4 and len(t[7]) == 2 and len(t[8]) == 2
    assert len(t[-1]) == 1
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _seeded_grid_ops(sg, rows):
    out = []
    g = sg.StringGrid(",", rows=rows)
    out.append(g.map_by_primary_key(1))
    out.append(g.select(1, "k1").rows)
    out.append(g.head(3).rows)
    out.append(g.cluster_column(0).get_clusters())
    g.sort_by(2)
    out.append(g.to_lines())
    g.swap(0, 2)
    g.prepend_to_each("<", 0)
    g.append_to_each(">", 1)
    g.fill_down("z", 3)
    g.add_column([str(i) for i in range(len(g))])
    g.add_row(["r"] * g.num_columns)
    out += [g.rows, g.num_columns]
    g.merge(0, 1, join_with="|")
    g.split(0, "|")
    out += [g.rows, g.num_columns, g.get_column(1), g.get_row(0)]
    g.filter_rows_by_column(1, {"k0>", "k2>"})
    g.remove_columns(3)
    out += [g.rows, g.num_columns]
    g.dedupe_by_cluster_all()
    out.append(g.rows)
    h = sg.StringGrid(",", rows=[[a, b] for a, b in zip(
        [r[0] for r in rows], [r[2] for r in rows])])
    h.filter_by_similarity(0.3, 0, 1)
    out.append(h.rows)
    for call in (lambda: g.remove_columns(99), lambda: g.merge(0, 99),
                 lambda: g.add_row(["x"]), lambda: g.add_column(["x"]),
                 lambda: sg.StringGrid(",", rows=[["a"], ["a", "b"]])):
        try:
            call()
            out.append(None)
        except (IndexError, ValueError) as exc:
            out.append(f"{type(exc).__name__}: {exc}")
    return out


def test_string_grid_seeded_rows_equal_jax():
    rng = np.random.default_rng(7)
    words = ["Alpha beta", "BETA alpha", "gamma", "Gamma!", "delta",
             "alpha  Beta", "eps"]
    rows = [[str(words[rng.integers(0, len(words))]),
             f"k{rng.integers(0, 3)}", str(words[rng.integers(0, len(words))]),
             str(rng.integers(0, 100))] for _ in range(24)]
    assert _seeded_grid_ops(tsg, [list(r) for r in rows]) == \
        _seeded_grid_ops(jsg, [list(r) for r in rows])


# ------------------------------------------- viterbi, windows, time series

def _decode(vi, labels, *args, **kw):
    return vi.Viterbi(*args, **kw).decode(labels)


@pytest.mark.parametrize("labels,args,kw,want", [
    ([0, 0, 0, 1, 0, 0, 0], ([0, 1],),
     dict(meta_stability=0.95, p_correct=0.8), [0] * 7),
    ([0, 0, 0, 1, 1, 1, 1], ([0, 1],),
     dict(meta_stability=0.9, p_correct=0.99), [0, 0, 0, 1, 1, 1, 1]),
    (np.eye(3)[[0, 0, 1, 1, 2]], ([0, 1, 2],), {}, [0, 0, 1, 1, 2]),
    ([], ([0, 1],), {}, []),
], ids=["isolated_flip", "sustained_switch", "one_hot", "empty"])
def test_viterbi_matches_jax_cases(labels, args, kw, want):
    js, jp = _decode(jvi, labels, *args, **kw)
    ts, tp = _decode(tvi, labels, *args, **kw)
    assert ts == js and tp.tolist() == jp.tolist() == want
    if want:
        assert ts < 0


def test_viterbi_seeded_sequence_equals_jax():
    """A noisy 4-state chain of 200 frames: the port's decode is the JAX
    package's (score and path), and it recovers the chain better than the
    noisy observations do."""
    rng = np.random.default_rng(8)
    true = np.repeat(rng.integers(0, 4, 20), 10)
    noisy = np.where(rng.random(200) < 0.15, rng.integers(0, 4, 200), true)
    for labels in (noisy, np.eye(4)[noisy]):
        js, jp = _decode(jvi, labels, [0, 1, 2, 3])
        ts, tp = _decode(tvi, labels, [0, 1, 2, 3])
        assert ts == js
        np.testing.assert_array_equal(tp, jp)
    assert (tp == true).mean() > (noisy == true).mean()
    for vi in (jvi, tvi):
        with pytest.raises(ValueError):
            vi.Viterbi([0])


@pytest.mark.parametrize("shape,rows,cols,rotate,flat", [
    ((4, 4), 2, 2, False, False), ((2, 2), 2, 2, True, True),
    ((5, 7), 3, 2, True, False), ((6, 3), 1, 3, False, True),
], ids=["count", "rotate_flat", "seeded_rotate", "seeded_flat"])
def test_moving_window_matches_jax(shape, rows, cols, rotate, flat):
    rng = np.random.default_rng(9)
    m = (np.arange(int(np.prod(shape))).reshape(shape) if shape == (4, 4)
         else rng.standard_normal(shape))
    j = jmw.MovingWindowMatrix(m, rows, cols, add_rotate=rotate).windows(flat)
    t = tmw.MovingWindowMatrix(m, rows, cols, add_rotate=rotate).windows(flat)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    if shape == (4, 4):
        assert len(t) == 9
        np.testing.assert_array_equal(t[0], [[0, 1], [4, 5]])
        np.testing.assert_array_equal(t[-1], [[10, 11], [14, 15]])
    if shape == (2, 2):
        assert len(t) == 4 and all(v.shape == (4,) for v in t)


def test_moving_window_refuses_what_jax_refuses():
    for mw in (jmw, tmw):
        with pytest.raises(ValueError, match="window larger"):
            mw.MovingWindowMatrix(np.zeros((2, 2)), 3, 1)
        with pytest.raises(ValueError, match="2-D"):
            mw.MovingWindowMatrix(np.zeros(4), 1, 1)


def test_time_series_matches_jax():
    np.testing.assert_allclose(tts.moving_average([1, 2, 3, 4, 5], 2),
                               [1.5, 2.5, 3.5, 4.5])
    mask = np.array([[1, 1, 0], [1, 0, 0]])
    np.testing.assert_array_equal(
        tts.reshape_time_series_mask_to_vector(mask), [1, 1, 0, 1, 0, 0])
    rng = np.random.default_rng(10)
    x = rng.standard_normal(300)
    for n in (1, 7, 300):
        np.testing.assert_array_equal(tts.moving_average(x, n),
                                      jts.moving_average(x, n))
    m = rng.integers(0, 2, (4, 9))
    np.testing.assert_array_equal(tts.reshape_time_series_mask_to_vector(m),
                                  jts.reshape_time_series_mask_to_vector(m))
    for ts in (jts, tts):
        with pytest.raises(ValueError):
            ts.moving_average(x, 0)
        with pytest.raises(ValueError):
            ts.reshape_time_series_mask_to_vector(np.zeros(3))
