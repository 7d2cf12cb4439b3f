"""Tensor parallelism of the port (parallel/tensor_parallel.py, the
"model" role of set_mesh, the split forms of nn/layers/attention.py and
feedforward.py, ops/shard_comm.py) against the JAX package on the CPU.

In this process: the packed QKV permutation both ways, and a Megatron
block split over m shards by `InProcessShards` (attention over its
heads, then the column- and row-parallel feed-forward) against the
whole layers, forward and every gradient. On gloo fleets of 2 and 4
ranks (tests/torch_parallel_worker.py, started by the port's launcher;
the ranks import no JAX): the transformer LM of the JAX package's
tests/test_unified_mesh.py (V 64, d 16, 2 heads, 4 blocks, d_ff 32,
T 8, B 8) trained three steps under {"model": 2}, {"data": 2,
"model": 2} and {"model": 4} — at 2 heads on 4 shards the attention
stays whole, the rest splits — from the JAX net's params, against the
JAX net trained densely, as that test holds its TP step; per-layer
gradient normalization over split leaves; set_mesh before init; and the
checkpoint of a placed net, which holds the canonical (whole, JAX
layout) trees.

Tolerances: the in-process split sums the shards' partial products in
another order than one matmul: f32 outputs and gradients 1e-5 of the
largest entry. After three SGD steps, params 1e-5 of the largest JAX
param and the score 1e-5 relative; with the model's Adam (lr 3e-4), the
score within 2e-4 of the JAX dense net's (the JAX contract's ATOL).
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu_torch.nn.conf.layers import (
    DenseLayer,
    SelfAttentionLayer,
)
from deeplearning4j_tpu_torch.nn.layers import get_impl
from deeplearning4j_tpu_torch.nn.layers.attention import attention_shards
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    dense_columns,
    dense_rows,
)
from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
    TRANSFORMER_TP_RULES,
    join_shards,
    qkv_columns,
    resolve_rules,
    shard_slice,
    sharding_for,
    spec_for,
)
from fleet_util import assert_trained_close, jax_net, run_fleet

pytestmark = pytest.mark.port

TOL = 1e-5
ADAM_ATOL = 2e-4
CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=4, d_ff=32,
           max_length=8)
B, STEPS = 8, 3


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.integers(0, CFG["vocab_size"], (B, CFG["max_length"]))
        x = x.astype(np.int32)
        out.append((x, np.roll(x, -1, axis=1), None))
    return out


def _case(name, mesh, axes, sgd=True, **kw):
    case = dict(name=name, kind="mesh", model="lm", cfg=CFG, mesh=mesh,
                axes=axes, batches=_batches(), **kw)
    if sgd:
        case.update(updater="sgd", lr=0.1)
    return case


CASES = {
    2: [_case("tp_m2", {"model": 2}, {"model": "model"}),
        _case("tp_m2_gradnorm", {"model": 2}, {"model": "model"},
              grad_norm="renormalize_l2_per_layer")],
    4: [_case("tp_d2m2", {"data": 2, "model": 2},
              {"data": "data", "model": "model"}),
        _case("tp_m4_adam", {"model": 4}, {"model": "model"}, sgd=False),
        dict(_case("tp_before_init", {"data": 2, "model": 2},
                   {"data": "data", "model": "model"}),
             kind="before_init")],
}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for n, cases in CASES.items():
        d = tmp_path_factory.mktemp(f"tp{n}")
        for c in cases:
            c["ckpt"] = str(d / f"ckpt_{c['name']}")
        out[n] = run_fleet(d, n, cases)
    return out


def _case_of(n, name):
    return next(c for c in CASES[n] if c["name"] == name)


def _jax_dense(case):
    net = jax_net(case)
    for x, y, _ in case["batches"]:
        net.fit(JDataSet(x, y))
    return net


# ------------------------------------------------------------ in process

@pytest.mark.parametrize("H,m", [(2, 2), (4, 2), (4, 4)])
def test_qkv_permutation_both_ways(H, m):
    """Shard r of a packed [.., 3n] projection holds the q, k and v
    columns of heads r*H/m .. (r+1)*H/m - 1, in q | k | v order, so a
    kernel reads it as a packed projection of H/m heads; joining the
    shards gives the whole leaf back, for the weight and the bias."""
    D = 8
    n = H * D
    W = torch.randn(5, 3 * n)
    b = torch.randn(3 * n)
    Hl = H // m
    for r in range(m):
        cols = qkv_columns(n, H, m, r)
        heads = range(r * Hl, (r + 1) * Hl)
        want = [part * n + h * D + d for part in range(3) for h in heads
                for d in range(D)]
        assert cols.tolist() == want
    parts = [shard_slice(W, 1, m, r, n_heads=H) for r in range(m)]
    assert all(p.shape == (5, 3 * n // m) for p in parts)
    torch.testing.assert_close(join_shards(parts, 1, n_heads=H), W,
                               rtol=0, atol=0)
    bparts = [shard_slice(b, 0, m, r, n_heads=H) for r in range(m)]
    torch.testing.assert_close(join_shards(bparts, 0, n_heads=H), b,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="heads do not split"):
        qkv_columns(n, H, 3, 0)


def test_rules_resolve_to_the_callers_axis_names():
    rules = resolve_rules({"data": "dp", "model": "mdl"})
    from types import SimpleNamespace

    mesh = SimpleNamespace(shape={"dp": 2, "mdl": 2})
    assert spec_for("blk0_attn/Wqkv", mesh, rules) == (None, "mdl")
    assert spec_for("out/b", mesh, rules) == ("mdl",)
    assert spec_for("blk0_ln1/gamma", mesh, rules) == ()
    # an axis not on the mesh leaves the leaf whole
    assert spec_for("blk0_ff1/W", SimpleNamespace(shape={"dp": 2}),
                    TRANSFORMER_TP_RULES) == ()


def test_sharding_for_gives_the_ranks_slice():
    """sharding_for: rank 1 of a "model" axis of 2 gets its heads' q, k
    and v columns of a packed leaf, its rows of a row-parallel weight,
    and a leaf no rule splits whole."""
    from types import SimpleNamespace

    mesh = SimpleNamespace(shape={"model": 2}, axis_size=lambda a: 2,
                           axis_index=lambda a: 1)
    W = torch.randn(4, 3 * 8)
    torch.testing.assert_close(
        sharding_for("blk0_attn/Wqkv", W, mesh, n_heads=2),
        W[:, [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23]], rtol=0, atol=0)
    W2 = torch.randn(6, 4)
    torch.testing.assert_close(sharding_for("blk0_ff2/W", W2, mesh), W2[3:],
                               rtol=0, atol=0)
    g = torch.ones(4)
    assert sharding_for("blk0_ln1/gamma", g, mesh) is g


def _split_block(m, H, seed=0):
    """One attention layer and one feed-forward pair, whole and split
    over m shards; random params."""
    torch.manual_seed(seed)
    d, ff, D = 4 * H, 8 * m, 4
    attn = SelfAttentionLayer(n_in=d, n_out=d, n_heads=H, causal=True,
                              activation="identity")
    ff1 = DenseLayer(n_in=d, n_out=ff, activation="gelu")
    ff2 = DenseLayer(n_in=ff, n_out=d, activation="identity")
    pa = {"Wqkv": torch.randn(d, 3 * d) / d ** 0.5,
          "bqkv": torch.randn(3 * d) * 0.1,
          "Wo": torch.randn(d, d) / d ** 0.5, "bo": torch.randn(d) * 0.1}
    p1 = {"W": torch.randn(d, ff) / d ** 0.5, "b": torch.randn(ff) * 0.1}
    p2 = {"W": torch.randn(ff, d) / ff ** 0.5, "b": torch.randn(d) * 0.1}
    assert D == d // H
    return attn, ff1, ff2, pa, p1, p2


def _leaves(ps):
    return [t for p in ps for t in p.values()]


@pytest.mark.parametrize("H,m", [(2, 2), (4, 2), (4, 4)])
def test_in_process_split_block_equals_whole(H, m):
    """attention_shards (each shard its H/m heads through the layer's
    kernels' plain versions), then dense_columns and dense_rows, over m
    in-process shards: the output and the gradients of x and of every
    param (the shards' gradients joined) equal the whole layers'."""
    attn, ff1, ff2, pa, p1, p2 = _split_block(m, H)
    x = torch.randn(3, 16, attn.n_in)

    def whole(x, pa, p1, p2):
        h, _ = get_impl(attn).apply(attn, pa, {}, x)
        h = x + h
        f, _ = get_impl(ff1).apply(ff1, p1, {}, h)
        y, _ = get_impl(ff2).apply(ff2, p2, {}, f)
        return h + y

    def split(x, pas, p1s, p2s, transport):
        h = x + attention_shards(attn, pas, x, transport)
        fs = dense_columns(ff1, p1s, h, transport)
        return h + dense_rows(ff2, p2s, fs, transport)

    shard = {"Wqkv": (1, H), "bqkv": (0, H), "Wo": (0, None)}
    pas = [{k: (shard_slice(v, shard[k][0], m, r, n_heads=shard[k][1])
                if k in shard else v).detach().requires_grad_()
            for k, v in pa.items()} for r in range(m)]
    p1s = [{k: shard_slice(v, v.ndim - 1, m, r).requires_grad_()
            for k, v in p1.items()} for r in range(m)]
    p2s = [{"W": shard_slice(p2["W"], 0, m, r).requires_grad_(),
            "b": p2["b"].clone().requires_grad_()} for r in range(m)]
    for p in (pa, p1, p2):
        for t in p.values():
            t.requires_grad_()
    xw, xs = x.clone().requires_grad_(), x.clone().requires_grad_()
    cot = torch.randn(3, 16, attn.n_in)
    yw = whole(xw, pa, p1, p2)
    ys = split(xs, pas, p1s, p2s, InProcessShards(m))
    scale = float(yw.detach().abs().max())
    torch.testing.assert_close(ys, yw, rtol=0, atol=TOL * scale)
    gw = torch.autograd.grad(yw, [xw] + _leaves([pa, p1, p2]), cot)
    gs = torch.autograd.grad(ys, [xs] + _leaves(pas + p1s + p2s), cot,
                             allow_unused=True)
    got = {"x": gs[0]}
    it = iter(gs[1:])
    pas_g = [{k: next(it) for k in p} for p in pas]
    p1s_g = [{k: next(it) for k in p} for p in p1s]
    p2s_g = [{k: next(it) for k in p} for p in p2s]
    for k in pa:
        if k in shard:
            got[f"attn/{k}"] = join_shards([g[k] for g in pas_g],
                                           shard[k][0], shard[k][1])
        else:  # whole: in one process only shard 0's copy is read
            got[f"attn/{k}"] = pas_g[0][k]
    for k in p1:
        got[f"ff1/{k}"] = join_shards([g[k] for g in p1s_g], p1[k].ndim - 1)
    got["ff2/W"] = join_shards([g["W"] for g in p2s_g], 0)
    got["ff2/b"] = p2s_g[0]["b"]
    names = (["x"] + [f"attn/{k}" for k in pa] + [f"ff1/{k}" for k in p1]
             + [f"ff2/{k}" for k in p2])
    for name, want in zip(names, gw):
        torch.testing.assert_close(got[name], want, rtol=0,
                                   atol=TOL * float(want.abs().max()),
                                   msg=name)


# ------------------------------------------------------------ gloo fleets

@pytest.mark.parametrize("n,name", [(2, "tp_m2"), (2, "tp_m2_gradnorm"),
                                    (4, "tp_d2m2")])
def test_tensor_parallel_matches_jax_dense(fleets, n, name):
    """Three SGD steps under the "model" role (with "data" at 4 ranks;
    with per-layer L2 renormalization, whose norms of split leaves sum
    over the shards): every rank's canonical params and the score equal
    the JAX net trained on one device; the attention, feed-forward,
    embedding and head leaves really split; the checkpoint holds the
    canonical trees."""
    case = _case_of(n, name)
    outs = fleets[n]
    assert_trained_close(outs, name, _jax_dense(case), TOL)
    m = case["mesh"]["model"]
    d, ff, V = CFG["d_model"], CFG["d_ff"], CFG["vocab_size"]
    want = {"blk0_attn/Wqkv": (d, 3 * d // m), "blk0_attn/Wo": (d // m, d),
            "blk0_ff1/W": (d, ff // m), "blk3_ff2/W": (ff // m, d),
            "embed/W": (V, d // m), "out/W": (d, V // m), "out/b": (V // m,)}
    for out in outs:
        for leaf, shape in want.items():
            assert tuple(out[f"{name}/split/{leaf}"]) == shape, leaf
        assert bool(out[f"{name}/ckpt_is_canonical"])


def test_heads_that_do_not_divide_keep_attention_whole(fleets):
    """2 heads on {"model": 4} (the JAX contract's H = 2 on model: 4):
    the attention layers run whole on every shard, the feed-forward
    layers, the embedding and the head split; with the model's Adam the
    score is within the contract's 2e-4 of the JAX dense net's."""
    case = _case_of(4, "tp_m4_adam")
    jnet = _jax_dense(case)
    for out in fleets[4]:
        keys = {k for k in out if k.startswith("tp_m4_adam/split/")}
        assert not any("_attn/" in k for k in keys)
        assert "tp_m4_adam/split/blk0_ff1/W" in keys
        assert "tp_m4_adam/split/out/W" in keys
        assert abs(float(out["tp_m4_adam/score"])
                   - float(jnet.score_value)) < ADAM_ATOL
    assert_trained_close(fleets[4], "tp_m4_adam", jnet, 1e-3,
                         score_rtol=1e-3)


def test_set_mesh_before_init_places_after_the_automatic_init(fleets):
    """set_mesh on a net not yet initialized: the placement follows the
    automatic init (split layers before the first fit), and three steps
    equal the meshless net's of the same init."""
    for out in fleets[4]:
        assert bool(out["tp_before_init/placed_before_fit"])
        keys = [k[len("tp_before_init/meshless/"):] for k in out
                if k.startswith("tp_before_init/meshless/params/")]
        assert keys
        scale = max(float(np.abs(out[f"tp_before_init/meshless/{k}"]).max())
                    for k in keys)
        for k in keys:
            err = float(np.abs(out[f"tp_before_init/placed/{k}"]
                               - out[f"tp_before_init/meshless/{k}"]).max())
            assert err <= TOL * scale, (k, err)


@pytest.mark.parametrize("name", ["model", "expert", "zero1"])
def test_one_rank_placement_is_the_meshless_step(name):
    """At world size 1 each placement runs its split forms and
    collectives over groups of one (the MoE layer also gathers the
    global batch over its data group): three steps leave the canonical
    params and the score bit for bit where the meshless net's three
    steps leave them (one intra-op thread: the CPU's threaded reductions
    do not repeat bit for bit)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_lm,
        transformer_moe_lm,
    )
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    def build():
        if name == "expert":
            return transformer_moe_lm(vocab_size=64, d_model=16, n_heads=2,
                                      n_layers=2, n_experts=4,
                                      d_expert_hidden=32, max_length=8,
                                      device="cpu").init(5)
        return transformer_lm(**CFG, device="cpu").init(5)

    kw = {"model": dict(axes={"data": "data", "model": "model"}),
          "expert": dict(axes={"data": "data", "expert": "expert"}),
          "zero1": dict(zero1=True)}[name]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bootstrap.initialize(device="cpu")
    try:
        plain, placed = build(), build()
        placed.set_mesh(make_mesh({"data": 1, "model": 1, "expert": 1},
                                  device="cpu"), **kw)
        for x, y, _ in _batches(3):
            plain.fit(DataSet(x, y))
            placed.fit(DataSet(x, y))
        assert (placed.params_flat().tobytes()
                == plain.params_flat().tobytes())
        assert placed.score_value == plain.score_value
    finally:
        bootstrap.shutdown()
        torch.set_num_threads(threads)


def test_model_role_validation(tmp_path):
    """A layer a rule splits in a way it cannot compute raises naming
    the layer; a placed net's decode function is built and its greedy
    tokens are the meshless net's; set_mesh(None) gives the whole params
    back."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    bootstrap.initialize(device="cpu")
    try:
        mesh = make_mesh({"model": 1}, device="cpu")
        net = transformer_lm(**CFG, device="cpu").init()
        before = net.params_flat()
        with pytest.raises(ValueError, match="blk0_ln1.*no split form"):
            net.set_mesh(mesh, axes={"model": "model"},
                         tp_rules=[(r".*_ln1/gamma$", ("model",))])
        want = _greedy(net, _PROMPT, 6)
        net.set_mesh(mesh, axes={"model": "model"})
        assert net._split_plan.layers
        assert callable(net.incremental_decode_fn())
        assert _greedy(net, _PROMPT, 6) == want
        net.set_mesh(None)
        assert net._split_plan is None
        assert net.params_flat().tobytes() == before.tobytes()
    finally:
        bootstrap.shutdown()


# ------------------------------------------------------- split decode

_PROMPT = np.array([3, 17, 41, 5, 9], np.int32)
DECODE_CFG = dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2,
                  d_ff=128, max_length=64)


def _greedy(net, prompt, k, kv_dtype="f32", bucket=8, cap=32, wrap=None):
    """One prefill of `prompt` then k - 1 decode steps: the greedy
    tokens (the JAX package's nets, their steps under `wrap` = jax.jit,
    and the port's alike)."""
    prefill = net.prefill_fn(kv_dtype=kv_dtype)
    step = net.incremental_decode_fn(kv_dtype=kv_dtype)
    if wrap is not None:
        prefill, step = wrap(prefill), wrap(step)
    cache = net.init_kv_cache(1, cap, kv_dtype=kv_dtype)
    L = len(prompt)
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0, :L] = prompt
    kmask = (np.arange(bucket) < L).astype(np.float32)[None]
    probs, cache = prefill(net.params, net.state, cache, tokens, kmask,
                           np.array([0], np.int32), np.array([0], np.int32),
                           np.array([L - 1], np.int32))
    out = [int(np.argmax(np.asarray(probs)[0]))]
    while len(out) < k:
        probs, cache = step(net.params, net.state, cache,
                            np.array([out[-1]], np.int32),
                            np.array([L + len(out) - 1], np.int32))
        out.append(int(np.argmax(np.asarray(probs)[0])))
    return out


def _decode_pair():
    from deeplearning4j_tpu.models.transformer import transformer_lm as jlm
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.weights_io import params_from_jax

    jnet = jlm(**DECODE_CFG).init()
    tnet = transformer_lm(**DECODE_CFG, device="cpu").init()
    tnet.params = params_from_jax(
        {k: {n: np.asarray(v) for n, v in d.items()}
         for k, d in jnet.params.items()}, "cpu")
    return jnet, tnet


# A7: the decode net split over a 2-rank "model" group, served in
# lockstep by GenerationEngine (tests/torch_parallel_worker.py
# case_serve); it rides the 2-rank fleet above
SERVE = dict(name="serve_m2", kind="serve", model="lm", cfg=DECODE_CFG,
             mesh={"model": 2}, axes={"model": "model"}, batches=[],
             prompts=[np.random.default_rng(i).integers(0, 64, n).tolist()
                      for i, n in enumerate((5, 11, 20))],
             new=12, seq_lens=[8, 16, 32], kv_dtypes=["f32", "int8"])
CASES[2].append(SERVE)
# the same engine over a group whose collectives time out after 3 s, with
# one rank's decode step failing (case_serve_fault)
SERVE_FAULT = dict(SERVE, name="serve_fault_m2", kind="serve_fault",
                   kv_dtypes=["f32"], timeout_s=3.0)
CASES[2].append(SERVE_FAULT)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_split_decode_matches_meshless_and_jax(kv_dtype):
    """The LM split over 2 "model" shards in this process
    (tensor_parallel.place_in_process: each shard's q, k and v columns
    and Wo rows, the dense layers' columns and rows, the embedding and
    the head gathered): 16 greedy tokens through the split prefill and
    decode steps equal the meshless port's and the JAX package's; each
    shard's cache entry holds its 2 heads, half the whole layer's
    bytes."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        place_in_process,
    )

    jnet, tnet = _decode_pair()
    want = _greedy(tnet, _PROMPT, 16, kv_dtype)
    assert want == _greedy(jnet, _PROMPT, 16, kv_dtype, wrap=jax.jit)
    whole = tnet.init_kv_cache(2, 32, kv_dtype=kv_dtype)
    place_in_process(tnet, 2)
    assert _greedy(tnet, _PROMPT, 16, kv_dtype) == want
    split = tnet.init_kv_cache(2, 32, kv_dtype=kv_dtype)
    for name, entries in split.items():
        assert len(entries) == 2
        for e in entries:
            assert e["k"].shape[2] == DECODE_CFG["n_heads"] // 2
            assert 2 * sum(t.numel() * t.element_size()
                           for t in e.values()) == sum(
                t.numel() * t.element_size() for t in whole[name].values())
    tnet.set_mesh(None)
    assert not any(isinstance(v, list)
                   for v in tnet.init_kv_cache(1, 16).values())


def test_generation_engine_serves_a_split_net():
    """GenerationEngine over the LM split over 2 "model" shards in this
    process, unchanged: the greedy tokens of 3 requests equal the
    meshless engine's."""
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        place_in_process,
    )
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)

    _, tnet = _decode_pair()
    prompts = [np.random.default_rng(i).integers(0, 64, n).astype(np.int32)
               for i, n in enumerate((5, 11, 20))]

    def served(net):
        engine = GenerationEngine(net, BucketLattice((1,), seq_lens=(
            8, 16, 32)), slots=2, max_new_tokens=12)
        engine.warmup()
        engine.start()
        try:
            return [list(engine.generate(p, 12, timeout=120))
                    for p in prompts]
        finally:
            engine.drain()

    want = served(tnet)
    place_in_process(tnet, 2)
    assert served(tnet) == want


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_lockstep_engine_over_two_ranks_serves_the_jax_tokens(fleets,
                                                              kv_dtype):
    """Rank 0 of a 2-rank gloo "model" group serves 3 prompts (2 slots,
    so prefills interleave with decode steps) through the lockstep
    GenerationEngine over the f32 or the int8 cache: each request's
    greedy tokens equal the JAX package's on the same params (f32), or
    the meshless port's over the int8 cache, which
    test_split_decode_matches_meshless_and_jax holds to the JAX
    package's. Rank 1's follower refuses a request, steps the same
    number of plans and retires at the stop plan."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.weights_io import params_from_jax

    outs = fleets[2]
    net = jax_net(SERVE)
    wrap = jax.jit
    if kv_dtype == "int8":
        params = {k: {n: np.asarray(v) for n, v in d.items()}
                  for k, d in net.params.items()}
        net = transformer_lm(**DECODE_CFG, device="cpu").init()
        net.params, wrap = params_from_jax(params, "cpu"), None
    key = f"serve_m2/{kv_dtype}"
    for i, prompt in enumerate(SERVE["prompts"]):
        want = _greedy(net, np.asarray(prompt, np.int32), SERVE["new"],
                       kv_dtype, bucket=32, cap=64, wrap=wrap)
        assert outs[0][f"{key}/tokens{i}"].tolist() == want, i
    assert bool(outs[1][f"{key}/refused"])
    plans = int(outs[0][f"{key}/plans"])
    # at least one prefill a prompt and a decode step a token after each
    # prompt's first
    assert plans >= len(SERVE["prompts"]) + SERVE["new"] - 1
    assert int(outs[1][f"{key}/plans"]) == plans
    assert bool(outs[0][f"{key}/retired"])
    assert bool(outs[1][f"{key}/retired"])


@pytest.mark.parametrize("bad", [0, 1])
def test_lockstep_step_failure_ends_both_ranks(fleets, bad):
    """In a 2-rank lockstep engine over a gloo group whose collectives
    time out after 3 s, a step of rank `bad` raises after its plan went
    out (0: the leader's second prefill chunk; 1: the follower's second
    decode step): its peer, left in the step's collective, raises at the
    timeout, and neither sends another plan. Both workers end dead, neither thread is left running, and
    each of rank 0's requests finishes with an error instead of
    hanging."""
    outs = fleets[2]
    key = f"serve_fault_m2/{bad}"
    for rank in (0, 1):
        assert str(outs[rank][f"{key}/state"]) == "dead", rank
        assert bool(outs[rank][f"{key}/ended"]), rank
    assert outs[0][f"{key}/failed"].tolist() == [True] * len(
        SERVE["prompts"])


def test_lockstep_follower_refuses_requests():
    """In this process, as rank 1 of a simulated 2-rank group (torch's
    fake process group): the engine over the split net follows, and its
    submit_generate and generate raise NotLeaderError; options the plan
    does not carry are refused at construction. A meshless net gets the
    plain worker, and a net placed over a "model" group of one the
    lockstep worker, whose rank leads."""
    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  GenerationEngine)
    from deeplearning4j_tpu_torch.serving.engine import (NotLeaderError,
                                                         _GenWorker)
    from deeplearning4j_tpu_torch.serving.lockstep import (
        LockstepBroken,
        LockstepUnsupported,
        LockstepWorker,
    )

    lattice = BucketLattice((1,), seq_lens=(8,))
    with bootstrap.simulated_group(1, 2, "cpu"):
        net = transformer_lm(**CFG, device="cpu").init()
        net.set_mesh(make_mesh({"model": 2}), axes={"model": "model"})
        engine = GenerationEngine(net, lattice, slots=1, max_new_tokens=4)
        assert not engine.leader
        with pytest.raises(NotLeaderError):
            engine.submit_generate([1, 2, 3])
        with pytest.raises(NotLeaderError):
            engine.generate([1, 2, 3], 2)
        with pytest.raises(LockstepUnsupported, match="speculative"):
            GenerationEngine(net, lattice, slots=1, max_new_tokens=4,
                             speculative_k=2)
    meshless = transformer_lm(**CFG, device="cpu").init()
    assert type(GenerationEngine(meshless, lattice).fleet_workers()[0]) \
        is _GenWorker
    with bootstrap.simulated_group(0, 1, "cpu"):
        net = transformer_lm(**CFG, device="cpu").init()
        net.set_mesh(make_mesh({"model": 1}), axes={"model": "model"})
        engine = GenerationEngine(net, lattice, slots=1, max_new_tokens=4)
        assert engine.leader
        (worker,) = engine.fleet_workers()
        assert type(worker) is LockstepWorker
        with pytest.raises(LockstepBroken):  # no rejoining the steps
            engine.fleet_respawn(worker)


def test_moe_decode_is_refused_as_in_jax():
    """The MoE LM's layers cannot stream one token at a time in the JAX
    package's decode: the port raises its ValueError, word for word,
    meshless and with the experts split over 2 "expert" shards."""
    from deeplearning4j_tpu.models.transformer import (
        transformer_moe_lm as jmoe,
    )
    from deeplearning4j_tpu.nn.decode import make_decode_fn as jdecode
    from deeplearning4j_tpu_torch.models.transformer import (
        transformer_moe_lm,
    )
    from deeplearning4j_tpu_torch.nn.decode import make_decode_fn
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        place_in_process,
    )

    cfg = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2,
               n_experts=4, max_length=16)
    with pytest.raises(ValueError) as e:
        jdecode(jmoe(**cfg).init())
    net = transformer_moe_lm(**cfg, device="cpu").init()
    for split in (False, True):
        if split:
            place_in_process(net, 2, role="expert")
            assert net._inproc_split.layers
        with pytest.raises(ValueError) as got:
            make_decode_fn(net)
        assert str(got.value) == str(e.value)

