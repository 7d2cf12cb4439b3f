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
after three SGD steps 1e-5 of the largest entry; the Solver over the
ring (LBFGS under {"seq": 2}) 1e-5 of the largest entry from the JAX
package's solve under the same mesh and from the port's meshless one.

"seq" 2 x "model" 2 (the 4-rank fleet, set_mesh with both roles; V 128,
d 64, 4 heads, 2 blocks, T 256, B 4): three SGD steps against the JAX
net under set_mesh({"seq": 2, "model": 2}), the same 1e-5; with
attention dropout 0.1 the ring seeds each rank folded show the model
shards' masks apart and the seq shards of one head together. The
in-process split ring (2 model shards, each a ring of 2 blocks) holds
the whole layer's output and gradients within 2e-5 / 5e-5.
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
# tests/test_torch_solvers.py's tolerances of a solve
X_ATOL, SCORE_RTOL = 1e-5, 1e-5
VOCAB, SP_T, SP_B = 101, 32, 4
SP_CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_length=SP_T, seed=99)
SP_CASE = dict(updater="sgd", lr=0.1)
# "seq" 2 x "model" 2 (4 ranks): 4 heads of 16, T 256, so each rank's
# block of 128 takes the ring's flash hops on its 2 heads
SM_T, SM_B = 256, 4
SM_CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_length=SM_T, seed=99)
SM_AXES = {"seq": 2, "model": 2}
SM_ROLES = {"seq": "seq", "model": "model"}


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


@pytest.mark.parametrize("dtype,want", [(torch.float32, "flash"),
                                        (torch.bfloat16, "einsum")])
def test_ring_route_at_head_dim_16_follows_the_dtype(dtype, want):
    """Head dim 16 (examples/sequence_parallel_lm.py's 4 heads of 16): on
    CUDA the f32 kernels take it, the bf16 kernels do not."""
    ra = importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.ring_attention")

    assert ra.ring_route(256, 16, "cuda", dtype) == want


def test_einsum_ring_at_head_dim_96_matches_references(monkeypatch):
    """The route the card takes at D = 96 (d_model 384 over 4 heads),
    forced on the CPU: the f32 einsum ring over 4 blocks of 128 against
    the port's and the JAX package's whole-sequence references and the
    JAX ring, forward, and the reference's gradients."""
    ra = importlib.import_module(
        "deeplearning4j_tpu_torch.parallel.ring_attention")

    route = ra.ring_route
    taken = []

    def as_on_cuda(Tl, D, device_type, dtype=None):
        taken.append(route(Tl, D, "cuda", dtype))
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


def test_split_heads_ring_in_process_matches_whole_layer():
    """attention_shards over 2 model shards in this process, each
    running the ring over 2 blocks (a `SeqShard` of an `InProcessRing`),
    against the whole layer: the output within 2e-5 and the gradients of
    x and of every param within 5e-5 (f32, T 256, 4 heads of 16)."""
    from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        attention_shards,
    )
    from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards

    conf = SelfAttentionLayer(n_in=64, n_out=64, n_heads=4, causal=True,
                              activation="identity", weight_init="xavier",
                              seq_parallel_axis="seq")
    impl = get_impl(conf)
    params, _ = impl.init(conf, torch.Generator().manual_seed(3),
                          torch.float32)
    for k in params:
        params[k] = params[k] + 0.01 * torch.randn(
            params[k].shape, generator=torch.Generator().manual_seed(4))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 256, 64)).astype(np.float32))

    def run(split):
        p = {k: t.clone().requires_grad_() for k, t in params.items()}
        xi = x.clone().requires_grad_()
        if split:
            tr = InProcessShards(2)
            with sharded(seq=SeqShard("seq", InProcessRing(2), 0, 1)):
                y = attention_shards(conf, tr.pieces(
                    p, {"Wqkv": 1, "bqkv": 0, "Wo": 0}, 4), xi, tr)
        else:
            y, _ = impl.apply(conf, p, {}, xi)
        (y ** 2).sum().backward()
        return y.detach(), [xi.grad] + [p[k].grad for k in sorted(p)]

    (y0, g0), (y1, g1) = run(False), run(True)
    _close(y1.numpy(), y0.numpy(), OUT_TOL, "output")
    for a, b in zip(g1, g0):
        _close(a.numpy(), b.numpy(), GRAD_TOL, "gradient")


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
    if n == 2:
        # the Solver path over the ring: LBFGS under {"seq": 2}
        np.savez(tmp / "sp_solver.npz", **dict(np.load(tmp / "sp.npz")))
        cases.append({"name": "sp_solver", "kind": "solver", "model": "lm",
                      "cfg": dict(SP_CFG, seq_parallel_axis="seq"),
                      "mesh": {"seq": 2}, "axes": {"seq": "seq"},
                      "algo": "lbfgs", "iterations": 2, **SP_CASE})
    if n == 4:
        arrays = {f"params/{k}": v for k, v in flatten(jax.tree.map(
            np.asarray, _jax_sm_net().params)).items()}
        for i, (x, y) in enumerate(_sm_batches()):
            arrays[f"x{i}"], arrays[f"y{i}"] = x, y
        for name, drop in (("sp_model", 0.0), ("sp_model_drop", 0.1)):
            np.savez(tmp / f"{name}.npz", **arrays)
            cases.append({"name": name, "kind": "sp", "model": "lm",
                          "cfg": dict(SM_CFG, attention_dropout=drop),
                          "sp_axis": "seq", "axes": SM_AXES,
                          "roles": SM_ROLES, "record_seeds": bool(drop),
                          **SP_CASE})
    return cases


def _sm_batches():
    rng = np.random.default_rng(11)
    out = []
    for _ in range(3):
        toks = rng.integers(0, SM_CFG["vocab_size"], (SM_B, SM_T))
        toks = toks.astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _jax_sm_net(axis=""):
    return set_updater(jax_lm(**SM_CFG, seq_parallel_axis=axis),
                       SP_CASE).init()


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """{n: [rank outputs]} of the 2- and 4-rank fleets (deadline 120 s a
    launch, the 4-rank fleet's "seq" x "model" cases included; a rank
    that fails or is reaped fails the tests)."""
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


def test_seq_model_step_matches_jax(fleets):
    """"seq" 2 x "model" 2 through set_mesh (the SP step over the split
    layers: each rank runs the ring over its 2 heads) against the JAX
    net under set_mesh({"seq": 2, "model": 2}): three SGD steps, every
    rank's canonical params equal, within SP_TOL of the largest entry
    of the JAX net's; the loss 1e-5 relative. (The 4-rank gloo fleet,
    launch deadline 120 s.)"""
    jnet = _jax_sm_net("seq")
    jnet.set_mesh(jax_make_mesh(SM_AXES), axes=SM_ROLES)
    for x, y in _sm_batches():
        jnet.fit(JDataSet(x, y))
    ref = flatten(jax.tree.map(np.asarray, jnet.params))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    outs = fleets[4]
    for key, want in ref.items():
        got = outs[0][f"sp_model/params/{key}"]
        for other in outs[1:]:
            np.testing.assert_array_equal(other[f"sp_model/params/{key}"],
                                          got)
        _close(got, want, SP_TOL * scale, key)
    np.testing.assert_allclose(float(outs[0]["sp_model/score"]),
                               float(jnet.score_value), rtol=1e-5)


def test_solver_over_the_ring_matches_the_meshless_solve(fleets):
    """fit() through LBFGS (2 line-searched iterations a batch, three
    batches) under {"seq": 2}: each rank's time block through the ring,
    the loss and gradient means over "seq"; every rank's params equal
    and within 1e-5 of the largest entry (tests/test_torch_solvers.py's
    X_ATOL) of the JAX package's solve under set_mesh({"seq": 2}) and
    of the meshless port's solve, from the same params on the same
    batches; the score 1e-5 relative (SCORE_RTOL) to both. (The 2-rank
    gloo fleet, launch deadline 120 s.)"""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.weights_io import (
        params_from_jax,
        params_to_numpy,
    )

    jnet = set_updater(jax_lm(**SP_CFG, seq_parallel_axis="seq"), SP_CASE)
    net = set_updater(transformer_lm(**SP_CFG, device="cpu"), SP_CASE)
    for each in (jnet, net):
        each.conf.conf.optimization_algo = "lbfgs"
        each.conf.conf.iterations = 2
    jnet.init()
    net.init()
    net.params = params_from_jax(jax.tree.map(np.asarray,
                                              _jax_sp_net().params), "cpu")
    jnet.set_mesh(jax_make_mesh({"seq": 2}), axes={"seq": "seq"})
    for x, y in _sp_batches(7):
        jnet.fit(JDataSet(x, y))
        net.fit(DataSet(x, y))
    ref = flatten(jax.tree.map(np.asarray, jnet.params))
    want = flatten(params_to_numpy(net))
    scale = max(float(np.abs(a).max()) for a in ref.values())
    own = max(float(np.abs(a).max()) for a in want.values())
    outs = fleets[2]
    for key, v in want.items():
        got = outs[0][f"sp_solver/params/{key}"]
        np.testing.assert_array_equal(outs[1][f"sp_solver/params/{key}"],
                                      got)
        _close(got, ref[key], X_ATOL * scale, ("JAX", key))
        _close(got, v, SP_TOL * own, ("meshless", key))
    for score in (float(jnet.score_value), net.score_value):
        np.testing.assert_allclose(float(outs[0]["sp_solver/score"]), score,
                                   rtol=SCORE_RTOL)


def test_seq_model_dropout_masks_part_by_head_and_agree_by_block(fleets):
    """Attention dropout 0.1 under "seq" 2 x "model" 2: each ring takes
    one step seed a layer call, the same on the two seq shards of a
    model shard (so their blocks' keep masks are slices of one
    whole-sequence mask, as test_ring_dropout_hashes_global_coordinates
    holds) and folded past the other model shard's slices on the other
    (so no two heads share a mask); the ranks' params stay equal and
    the dropout moves the loss. (The 4-rank gloo fleet, launch deadline
    120 s.)"""
    outs = fleets[4]
    by_coords = {tuple(o["sp_model_drop/coords"]): o["sp_model_drop/seeds"]
                 for o in outs}
    assert sorted(by_coords) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for m in (0, 1):
        a, b = by_coords[(0, m)], by_coords[(1, m)]
        assert len(a) == 3 * SM_CFG["n_layers"]
        np.testing.assert_array_equal(a, b)
    s0, s1 = by_coords[(0, 0)], by_coords[(0, 1)]
    np.testing.assert_array_equal(s0[:, 0], s1[:, 0])  # one step seed
    assert (s0[:, 1] == 0).all()
    heads = SM_CFG["n_heads"] // SM_AXES["model"]
    assert (s1[:, 1] == SM_B * heads).all()  # past shard 0's slices
    assert (s0[:, 2] != s1[:, 2]).all()
    keys = [k for k in outs[0] if k.startswith("sp_model_drop/params/")]
    for other in outs[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], outs[0][k])
    assert abs(float(outs[0]["sp_model_drop/score"])
               - float(outs[0]["sp_model/score"])) > 1e-4


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
    in the JAX package, and so does "seq" with "expert"; a 'model' axis
    composes: the SP step over a net placed on {"seq": 1, "model": 1}
    takes a step (make_sp_train_step(model_axis=...) builds it)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.sequence_parallel import (
        SequenceParallelTrainer,
        make_sp_train_step,
    )

    x, y = _sp_batches(1, 1)[0]
    mesh = make_mesh({"seq": 1, "model": 1}, device="cpu")
    placed = transformer_lm(**SP_CFG, seq_parallel_axis="seq",
                            device="cpu").init()
    placed.set_mesh(mesh, axes={"seq": "seq", "model": "model"})
    assert placed._split_plan.layers
    step = make_sp_train_step(placed, mesh, model_axis="model")
    placed._train_step = step
    before = placed.params_flat()
    placed.fit(DataSet(x, y))
    assert np.isfinite(placed.score_value)
    assert not np.array_equal(before, placed.params_flat())
    with pytest.raises(ValueError, match="'seq' axis composes with"):
        placed.set_mesh(mesh, axes={"seq": "seq", "expert": "model"})
    net = transformer_lm(**SP_CFG, seq_parallel_axis="seq",
                         device="cpu").init()
    trainer = SequenceParallelTrainer(net, world1, data_axis="data")
    with pytest.raises(ValueError, match="masks are not supported"):
        trainer.fit(DataSet(x, y, features_mask=np.ones_like(x,
                                                              np.float32)))
    before = net.params_flat()
    trainer.fit(DataSet(x, y))
    assert np.isfinite(net.score_value)
    assert not np.array_equal(before, net.params_flat())
