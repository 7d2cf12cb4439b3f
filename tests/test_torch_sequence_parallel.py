"""Sequence parallelism of the port (parallel/ring_attention.py,
parallel/sequence_parallel.py, the SP branches of the attention and
positional-encoding layers) against the JAX package on the CPU.

The ring runs two ways: over a process group, its ranks subprocesses on
the CPU (gloo) started by the port's launcher with a deadline and
running tests/torch_parallel_worker.py, which imports neither jax nor
the JAX package; and in this process over `InProcessRing`, n shards'
hops in turn. On the CPU each hop's flash call runs the kernels' plain
versions (`_flash_fwd_reference` / `_flash_bwd_reference`, the lse
cotangent included); the JAX package's ring runs its Pallas kernels in
interpret mode on as many of its 8 virtual devices as there are shards.

Tolerances: f32 attention outputs 2e-5 and gradients 5e-5 absolute
(inputs standard normal; the ring merges per-hop partials by their lse,
the reference takes one softmax); dropout against the whole-sequence
kernel's plain version with the same step seed, 2e-5 / 5e-5 too (the
same keep mask, merged in another order); the SP step's f32 params
after three SGD steps 1e-5 of the largest entry.
"""

import importlib
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import transformer_lm as jax_lm
from deeplearning4j_tpu.parallel.ring_attention import (
    ring_self_attention as jax_ring,
    sequence_sharded_attention_reference as jax_reference,
)
from deeplearning4j_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deeplearning4j_tpu.parallel.sequence_parallel import (
    SequenceParallelTrainer as JaxSPTrainer,
)
from deeplearning4j_tpu_torch.distributed.launcher import launch_local
from deeplearning4j_tpu_torch.nn.conf.layers import PositionalEncodingLayer
from deeplearning4j_tpu_torch.nn.layers import get_impl
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    InProcessRing,
    ring_attention_blocks,
    ring_self_attention,
    sequence_sharded_attention_reference,
)
from deeplearning4j_tpu_torch.ops.shard_scope import SeqShard, sharded
from torch_parallel_worker import flatten, set_updater

pytestmark = pytest.mark.port

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
OUT_TOL, GRAD_TOL = 2e-5, 5e-5
SP_TOL = 1e-5
VOCAB, SP_T, SP_B = 101, 32, 4
SP_CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_length=SP_T, seed=99)
SP_CASE = dict(updater="sgd", lr=0.1)


def _qkv(seed, B, H, T, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, T, D)).astype(np.float32)
            for _ in range(3)]


def _torch_grads(fn, arrays):
    ts = [torch.from_numpy(a).clone().requires_grad_() for a in arrays]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol, (what, err)


# ------------------------------------------------------ in-process ring

@pytest.mark.parametrize("T,n", [(512, 4), (32, 4)],
                         ids=["flash-hops", "einsum"])
@pytest.mark.parametrize("causal", [True, False])
def test_in_process_ring_matches_references(T, n, causal):
    """The n-shard ring in one process (Tl = 128: a flash hop each;
    Tl = 8: the f32 einsum ring) against the port's and the JAX
    package's whole-sequence references and the JAX ring over n devices,
    forward; and its gradients against the reference's."""
    arrays = _qkv(0, 1, 2, T, 32)
    out, grads = _torch_grads(
        lambda q, k, v: ring_self_attention(q, k, v, n_shards=n,
                                            causal=causal), arrays)
    ref, ref_grads = _torch_grads(
        lambda q, k, v: sequence_sharded_attention_reference(
            q, k, v, causal=causal), arrays)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    _close(out, ref, OUT_TOL, "port reference")
    _close(out, jax_reference(
        jq, jk, jv, causal=causal), OUT_TOL, "JAX reference")
    _close(out, jax_ring(
        jq, jk, jv, jax_make_mesh({"seq": n}), causal=causal), OUT_TOL,
        "JAX ring")
    for g, r in zip(grads, ref_grads):
        _close(g, r, GRAD_TOL, "gradients")


def test_in_process_ring_launches_per_hop_case(monkeypatch):
    """A causal 4-shard ring runs 4 diagonal and 6 full hops and skips
    6: ten flash forwards (the counter moves only on the card, so the
    plain forward is counted here) and ten backwards."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa._flash_fwd, fa._flash_bwd_impl

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "_flash_fwd", count_fwd)
    monkeypatch.setattr(fa, "_flash_bwd_impl", count_bwd)
    _torch_grads(lambda q, k, v: ring_self_attention(q, k, v, n_shards=4),
                 _qkv(1, 1, 2, 512, 32))
    assert calls == {"fwd": 10, "bwd": 10}


@pytest.mark.parametrize("Tl,D,device,want", [
    (128, 128, "cuda", "flash"), (256, 32, "cuda", "flash"),
    (128, 96, "cuda", "einsum"), (512, 48, "cuda", "einsum"),
    (128, 512, "cuda", "einsum"), (8, 64, "cuda", "einsum"),
    (128, 96, "cpu", "flash"), (8, 96, "cpu", "einsum")])
def test_ring_route_by_block_head_dim_and_device(Tl, D, device, want):
    """On CUDA a head dim the flash kernels are not built for takes the
    f32 einsum ring, as a block length off the 128 grid does; the CPU's
    hops run the kernels' plain versions at any head dim."""
    ra = importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.ring_attention")

    assert ra.ring_route(Tl, D, device) == want


def test_einsum_ring_at_head_dim_96_matches_references(monkeypatch):
    """The route the card takes at D = 96 (d_model 384 over 4 heads),
    forced on the CPU: the f32 einsum ring over 4 blocks of 128 against
    the port's and the JAX package's whole-sequence references and the
    JAX ring, forward, and the reference's gradients."""
    ra = importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.ring_attention")

    route = ra.ring_route
    taken = []

    def as_on_cuda(Tl, D, device_type):
        taken.append(route(Tl, D, "cuda"))
        return taken[-1]

    monkeypatch.setattr(ra, "ring_route", as_on_cuda)
    arrays = _qkv(2, 1, 2, 512, 96)
    out, grads = _torch_grads(
        lambda q, k, v: ring_self_attention(q, k, v, n_shards=4), arrays)
    assert taken == ["einsum"]
    ref, ref_grads = _torch_grads(sequence_sharded_attention_reference,
                                  arrays)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    _close(out, ref, OUT_TOL, "port reference")
    _close(out, jax_reference(jq, jk, jv, causal=True), OUT_TOL,
           "JAX reference")
    _close(out, jax_ring(jq, jk, jv, jax_make_mesh({"seq": 4})), OUT_TOL,
           "JAX ring")
    for g, r in zip(grads, ref_grads):
        _close(g, r, GRAD_TOL, "gradients")


def test_ring_chunked_hop_matches_reference():
    """A hop_chunk hop: 2 shards of Tl = 256 cut into kernel tiles of
    128 (the chunked tier), forward and gradients."""
    arrays = _qkv(2, 1, 2, 512, 32)
    out, grads = _torch_grads(
        lambda q, k, v: ring_self_attention(q, k, v, n_shards=2,
                                            hop_chunk=128), arrays)
    ref, ref_grads = _torch_grads(
        lambda q, k, v: sequence_sharded_attention_reference(q, k, v),
        arrays)
    _close(out, ref, OUT_TOL, "forward")
    for g, r in zip(grads, ref_grads):
        _close(g, r, GRAD_TOL, "gradients")


@pytest.mark.parametrize("T,n,hop_chunk", [(512, 4, None), (512, 2, 128),
                                           (32, 4, None)],
                         ids=["flash-hops", "chunked-hops", "einsum"])
def test_ring_dropout_hashes_global_coordinates(T, n, hop_chunk):
    """Dropout 0.1 with one step seed: the ring drops what the
    whole-sequence flash kernel drops (its plain version here), in the
    flash, chunked and einsum rings; forward and gradients."""
    seed = torch.tensor([987654], dtype=torch.int32)
    arrays = _qkv(3, 1, 2, T, 32)
    out, grads = _torch_grads(
        lambda q, k, v: ring_self_attention(
            q, k, v, n_shards=n, hop_chunk=hop_chunk, dropout=0.1,
            seed=seed), arrays)

    def whole(q, k, v):
        B, H, _, D = q.shape
        o, _ = fa.flash_attention_lse_drop(
            *(t.reshape(B * H, T, D) for t in (q, k, v)), None,
            fa._drop_ctx(seed, 0, 0), 1.0 / math.sqrt(D), True, 0.1, T)
        return o.reshape(B, H, T, D)

    ref, ref_grads = _torch_grads(whole, arrays)
    no_drop, _ = _torch_grads(
        lambda q, k, v: sequence_sharded_attention_reference(q, k, v),
        arrays)
    assert float(np.abs(ref - no_drop).max()) > 0.1  # it does drop
    _close(out, ref, OUT_TOL, "forward")
    for g, r in zip(grads, ref_grads):
        _close(g, r, GRAD_TOL, "gradients")


def test_ring_blocks_take_a_generator_seed():
    """Without an explicit seed the ring draws one step seed from the
    generator: two generators in one state give one output."""
    arrays = [torch.from_numpy(a) for a in _qkv(4, 1, 2, 256, 32)]
    blocks = [list(t.chunk(2, dim=2)) for t in arrays]
    outs = [torch.cat(ring_attention_blocks(
        *blocks, InProcessRing(2), dropout=0.1,
        generator=torch.Generator().manual_seed(5)), dim=2)
        for _ in range(2)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# ---------------------------------------------------- positional offsets

def test_posenc_offsets_match_dense():
    """Each shard's encodings are the global-position rows of the dense
    layer's, sinusoidal and learned, against the JAX package's dense
    layer; a learned table shorter than the global sequence raises."""
    from deeplearning4j_tpu.nn.conf.layers import (
        PositionalEncodingLayer as JPosEnc,
    )
    from deeplearning4j_tpu.nn.layers.base import get_impl as jget_impl

    T, n, d = 32, 4, 8
    x = np.zeros((2, T, d), np.float32)
    jconf = JPosEnc(max_length=T, n_features=d)
    want, _ = jget_impl(jconf).apply(jconf, {}, {}, jnp.asarray(x))
    for learned in (False, True):
        conf = PositionalEncodingLayer(max_length=T, n_features=d,
                                       learned=learned,
                                       seq_parallel_axis="seq")
        impl = get_impl(conf)
        params, _ = impl.init(conf, torch.Generator().manual_seed(0),
                              torch.float32)
        dense, _ = impl.apply(conf, params, {}, torch.from_numpy(x))
        if not learned:
            _close(dense.numpy(), want, 1e-5, "dense vs JAX")
        Tl = T // n
        for i in range(n):
            with sharded(seq=SeqShard("seq", None, i, n)):
                y, _ = impl.apply(conf, params, {},
                                  torch.from_numpy(x[:, :Tl]))
            torch.testing.assert_close(y, dense[:, i * Tl:(i + 1) * Tl],
                                       rtol=0, atol=0)
    short = PositionalEncodingLayer(max_length=T // 2, n_features=d,
                                    learned=True, seq_parallel_axis="seq")
    p, _ = get_impl(short).init(short, torch.Generator(), torch.float32)
    with sharded(seq=SeqShard("seq", None, 0, n)):
        with pytest.raises(ValueError, match="exceeds learned"):
            get_impl(short).apply(short, p, {}, torch.zeros(2, Tl, d))


# --------------------------------------------------------- the fleets

def _sp_batches(seed, n_batches=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        toks = rng.integers(0, VOCAB, (SP_B, SP_T)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _jax_sp_net(axis=""):
    return set_updater(jax_lm(**SP_CFG, seq_parallel_axis=axis),
                       SP_CASE).init()


RING_CASES = {
    2: [("ring_flash", (1, 2, 256, 32), None),
        ("ring_chunk", (1, 2, 512, 32), 128),
        ("ring_einsum", (2, 2, 32, 16), None)],
    4: [("ring_flash", (1, 2, 512, 32), None)],
}
SP_AXES = {2: ({"seq": 2}, None), 4: ({"data": 2, "seq": 2}, "data")}


def _write_inputs(tmp, n):
    cases = []
    for name, shape, chunk in RING_CASES[n]:
        q, k, v = _qkv(sum(map(ord, name)), *shape)
        np.savez(tmp / f"{name}.npz", q=q, k=k, v=v)
        cases.append({"name": name, "kind": "ring", "hop_chunk": chunk})
    net = _jax_sp_net()
    arrays = {f"params/{k}": v for k, v in flatten(
        jax.tree.map(np.asarray, net.params)).items()}
    for i, (x, y) in enumerate(_sp_batches(7)):
        arrays[f"x{i}"], arrays[f"y{i}"] = x, y
    np.savez(tmp / "sp.npz", **arrays)
    axes, data_axis = SP_AXES[n]
    cases.append({"name": "sp", "kind": "sp", "model": "lm",
                  "cfg": dict(SP_CFG, seq_parallel_axis="seq"),
                  "axes": axes, "data_axis": data_axis, **SP_CASE})
    return cases


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{n: [rank outputs]} of the 2- and 4-rank fleets (deadline 120 s a
    launch; a rank that fails or is reaped fails the tests)."""
    out = {}
    for n in RING_CASES:
        tmp = tmp_path_factory.mktemp(f"sp{n}")
        spec = tmp / "spec.json"
        spec.write_text(json.dumps({"dir": str(tmp),
                                    "cases": _write_inputs(tmp, n)}))
        results = launch_local(
            [sys.executable, str(WORKER), str(spec)], n_processes=n,
            device="cpu", timeout=120.0, death_grace=5.0, cwd=ROOT,
            extra_env={"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
        for r in results:
            assert r.exit_class == "clean", "\n".join(r.lines[-60:])
        out[n] = [dict(np.load(tmp / f"out_rank{i}.npz")) for i in range(n)]
    return out


@pytest.mark.parametrize("n,name", [(2, "ring_flash"), (2, "ring_chunk"),
                                    (2, "ring_einsum"), (4, "ring_flash")])
def test_process_group_ring_matches_references(fleets, n, name):
    """ring_self_attention over a seq mesh of n gloo ranks (K/V passed on
    by batch_isend_irecv): every rank's gathered output against the
    reference and the JAX ring, both causal cases; each rank's block
    gradients through the per-shard ring (the cotangents travel the ring
    backwards) against the reference's slice."""
    shape, chunk = next((s, c) for nm, s, c in RING_CASES[n] if nm == name)
    arrays = _qkv(sum(map(ord, name)), *shape)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    T = shape[2]
    Tl = T // n
    _, ref_grads = _torch_grads(
        lambda q, k, v: sequence_sharded_attention_reference(q, k, v),
        arrays)
    for causal in (True, False):
        want = jax_reference(
            jq, jk, jv, causal=causal)
        for out in fleets[n]:
            _close(out[f"{name}/out_causal{int(causal)}"], want, OUT_TOL,
                   ("reference", causal))
        if chunk is None and T <= 256:
            _close(fleets[n][0][f"{name}/out_causal{int(causal)}"],
                   jax_ring(
                       jq, jk, jv, jax_make_mesh({"seq": n}),
                       causal=causal), OUT_TOL, ("JAX ring", causal))
    for r, out in enumerate(fleets[n]):
        sl = slice(r * Tl, (r + 1) * Tl)
        for g_name, ref in zip("qkv", ref_grads):
            _close(out[f"{name}/d{g_name}"], ref[:, :, sl], GRAD_TOL,
                   (r, g_name))


@pytest.mark.parametrize("n", [2, 4])
def test_sp_step_matches_jax(fleets, n):
    """SequenceParallelTrainer on seq = 2 and on data x seq = 2 x 2
    against the JAX package's on the same mesh shape: three SGD steps,
    every rank's params equal, within 1e-5 of the largest entry of the
    JAX net's; the loss 1e-5 relative."""
    axes, data_axis = SP_AXES[n]
    jnet = _jax_sp_net("seq")
    trainer = JaxSPTrainer(jnet, jax_make_mesh(axes), seq_axis="seq",
                           data_axis=data_axis)
    for x, y in _sp_batches(7):
        trainer.fit(_ListIt([JDataSet(x, y)]))
    ref = flatten(jax.tree.map(np.asarray, jnet.params))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    outs = fleets[n]
    for key, want in ref.items():
        got = outs[0][f"sp/params/{key}"]
        for other in outs[1:]:
            np.testing.assert_array_equal(other[f"sp/params/{key}"], got)
        _close(got, want, SP_TOL * scale, key)
    np.testing.assert_allclose(float(outs[0]["sp/score"]),
                               float(jnet.score_value), rtol=1e-5)


def _ListIt(items):
    from deeplearning4j_tpu.datasets.iterators import ListDataSetIterator

    return ListDataSetIterator(items)


# ------------------------------------------------------------ refusals

@pytest.fixture
def world1():
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "seq": 1}, device="cpu")
    try:
        yield mesh
    finally:
        bootstrap.shutdown()


def test_sp_refuses_masks_and_model_axis(world1):
    """Padding masks under SP raise ValueError (pad to full length), as
    in the JAX package; a 'model' axis waits for A7."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        SequenceParallelTrainer,
        make_sp_train_step,
    )

    net = transformer_lm(**SP_CFG, seq_parallel_axis="seq",
                         device="cpu").init()
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        make_sp_train_step(net, world1, model_axis="model")
    trainer = SequenceParallelTrainer(net, world1, data_axis="data")
    x, y = _sp_batches(1, 1)[0]
    with pytest.raises(ValueError, match="masks are not supported"):
        trainer.fit(DataSet(x, y, features_mask=np.ones_like(x,
                                                              np.float32)))
    before = net.params_flat()
    trainer.fit(DataSet(x, y))
    assert np.isfinite(net.score_value)
    assert not np.array_equal(before, net.params_flat())
