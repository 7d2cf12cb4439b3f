"""The port's Mixture-of-Experts layer (deeplearning4j_tpu_torch/nn/layers/moe.py)
and MoE LM (models/transformer.py `transformer_moe_lm`) against the JAX
package on the CPU, inputs from numpy seeds and params copied with
`weights_io.params_from_jax`.

Tolerances, float32 on both sides: the top-k choice, gates, slot
positions and the routed/dense outputs to 1e-6 absolute (2e-5 for the
outputs, whose einsums sum in another order); the aux loss to 1e-6
relative. Three SGD steps of the MoE LM: per-step losses to 1e-5
relative, every param to 2e-5 absolute. bfloat16 runs hold the routed
path to the dense one within 2e-2 of the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.models.transformer import (
    transformer_moe_flops_per_token as jax_moe_flops,
    transformer_moe_lm as jax_moe_lm,
)
from deeplearning4j_tpu.nn.layers import moe as jmoe
from deeplearning4j_tpu_torch.datasets import DataSet as TDataSet
from deeplearning4j_tpu_torch.models.transformer import (
    transformer_moe_flops_per_token,
    transformer_moe_lm,
)
from deeplearning4j_tpu_torch.nn.conf import serde
from deeplearning4j_tpu_torch.nn.layers import moe as tmoe
from deeplearning4j_tpu_torch.nn.layers.base import AUX_LOSS_KEY
from deeplearning4j_tpu_torch.weights_io import params_from_jax, params_to_numpy

pytestmark = pytest.mark.port

ATOL = 1e-6
OUT_ATOL = 2e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
BF16_TOL = 2e-2
LR = 0.1


def _params(seed, D=16, E=4, H=24, O=16, scale=0.5):
    rng = np.random.default_rng(seed)
    p = {"Wg": rng.standard_normal((D, E)), "We1": rng.standard_normal((E, D, H)),
         "be1": rng.standard_normal((E, H)), "We2": rng.standard_normal((E, H, O)),
         "be2": rng.standard_normal((E, O))}
    return {k: (scale * v).astype(np.float32) for k, v in p.items()}


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()},
            jnp.asarray(x), torch.from_numpy(x))


def test_topk_matches_jax_and_ties_go_to_the_first_index():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 8)).astype(np.float32)
    # rows of ties: the first index wins each argmax pass
    logits[:8] = np.array([1, 3, 3, 0, 3, 2, 2, 1], np.float32)
    logits[8:16] = 0.0
    for k in (1, 2, 3):
        jg, ji, jp = jmoe.moe_topk_from_logits(jnp.asarray(logits), k)
        tg, ti, tp = tmoe.moe_topk_from_logits(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    _, ti, _ = tmoe.moe_topk_from_logits(torch.from_numpy(logits), 2)
    assert ti[0].tolist() == [1, 2] and ti[8].tolist() == [0, 1]


def test_gates_capacity_and_aux_loss_match_jax():
    p = _params(1)
    x = np.random.default_rng(2).standard_normal((40, 16)).astype(np.float32)
    jp, tp, jx, tx = _both(p, x)
    jg = jmoe.moe_gates(jx, jp["Wg"], 2)
    tg = tmoe.moe_gates(tx, tp["Wg"], 2)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)
    logits = x @ p["Wg"]
    ja = jmoe.moe_load_balance_loss(jnp.asarray(logits), jg, 2)
    ta = tmoe.moe_load_balance_loss(torch.from_numpy(logits), tg, 2)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    for args in ((256, 2, 1.25, 8), (40, 2, 1.0, 4), (7, 1, 2.0, 3),
                 (512, 2, 4.0, 8)):
        assert tmoe.expert_capacity(*args) == jmoe.expert_capacity(*args)


@pytest.mark.parametrize("dispatch,cf,group", [
    ("einsum", 1.0, 16), ("gather", 1.0, 16), ("einsum", 0.5, 0),
    ("gather", 2.0, 24)])
def test_routed_dispatch_matches_jax(dispatch, cf, group):
    """Both dispatches, with tokens dropped over capacity (cf <= 1) and a
    ragged last group (N = 40 is no multiple of 16 or 24)."""
    p = _params(3)
    x = np.random.default_rng(4).standard_normal((40, 16)).astype(np.float32)
    jp, tp, jx, tx = _both(p, x)
    kw = dict(top_k=2, capacity_factor=cf, activation="gelu",
              group_size=group, return_aux=True, dispatch=dispatch)
    jy, ja = jmoe.moe_apply_routed(jp, jx, **kw)
    ty, ta = tmoe.moe_apply_routed(tp, tx, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_dense_oracle_matches_jax_and_routed_at_ample_capacity():
    p = _params(5)
    x = np.random.default_rng(6).standard_normal((48, 16)).astype(np.float32)
    jp, tp, jx, tx = _both(p, x)
    jy = jmoe.moe_apply_dense(jp, jx, top_k=2, activation="tanh")
    ty = tmoe.moe_apply_dense(tp, tx, top_k=2, activation="tanh")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_ATOL)
    for dispatch in ("einsum", "gather"):
        routed = tmoe.moe_apply_routed(tp, tx, top_k=2, capacity_factor=2.0,
                                       activation="tanh", dispatch=dispatch)
        np.testing.assert_allclose(routed.numpy(), ty.numpy(), atol=OUT_ATOL)


def test_bf16_group_of_512_slots_every_token():
    """A group of S = 512 in bfloat16 with every token routed to the same
    two experts: slot positions run to 511, past the 256 that bf16 holds
    exactly. With capacity for all (cf = E / top_k) the routed path must
    equal the dense one; a position rounded in bf16 would put two tokens
    in one slot."""
    p = _params(7, E=4)
    p["Wg"][:, :2] = 0.0
    p["Wg"][:, 2:] = -50.0
    x = np.abs(np.random.default_rng(8).standard_normal((512, 16))).astype(
        np.float32)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    p["Wg"][0, :2] = (1.0, 0.5)  # a fixed order between the two experts
    tp["Wg"] = torch.from_numpy(p["Wg"]).bfloat16()
    tx = torch.from_numpy(x).bfloat16()
    dense = tmoe.moe_apply_dense(tp, tx, top_k=2, activation="gelu").float()
    for dispatch in ("einsum", "gather"):
        y = tmoe.moe_apply_routed(tp, tx, top_k=2, capacity_factor=2.0,
                                  activation="gelu", group_size=512,
                                  dispatch=dispatch).float()
        err = (y - dense).abs().max() / dense.abs().max()
        assert float(err) < BF16_TOL, (dispatch, float(err))


def test_layer_puts_the_weighted_aux_loss_in_its_state():
    lc = tmoe.MixtureOfExpertsLayer(n_in=16, n_out=16, n_experts=4, top_k=2,
                                    d_hidden=24, router_aux_weight=0.05,
                                    weight_init="xavier")
    jlc = jmoe.MixtureOfExpertsLayer(n_in=16, n_out=16, n_experts=4, top_k=2,
                                     d_hidden=24, router_aux_weight=0.05)
    p = _params(9)
    x = np.random.default_rng(10).standard_normal((2, 20, 16)).astype(
        np.float32)
    jp, tp, jx, tx = _both(p, x)
    impl = tmoe.MixtureOfExpertsImpl()
    ty, ts = impl.apply(lc, tp, {}, tx, train=True)
    jy, js = jmoe.MixtureOfExpertsImpl().apply(jlc, jp, {}, jx, train=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_ATOL)
    np.testing.assert_allclose(float(ts[AUX_LOSS_KEY]),
                               float(js[AUX_LOSS_KEY]), rtol=1e-6)
    _, eval_state = impl.apply(lc, tp, {}, tx, train=False)
    assert AUX_LOSS_KEY not in eval_state
    back = serde.from_json(serde.to_json(lc))
    assert back == lc
    params, _ = impl.init(lc, torch.Generator().manual_seed(0), torch.float32)
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: v.shape for k, v in p.items()}


MOE = dict(vocab_size=128, d_model=64, n_heads=2, n_layers=2, n_experts=4,
           top_k=2, d_expert_hidden=48)


def _moe_pair(T, **kw):
    jnet = jax_moe_lm(**MOE, max_length=T, learning_rate=LR, **kw)
    tnet = transformer_moe_lm(**MOE, max_length=T, learning_rate=LR,
                              device="cpu", **kw)
    # SGD, set on every layer too (the builder's Adam is resolved into
    # each): Adam moves a zero-gradient weight by lr on rounding noise
    for net in (jnet, tnet):
        net.conf.conf.updater = "sgd"
        for v in net.layer_vertices.values():
            v.layer.updater = "sgd"
    jnet.init()
    tnet.init()
    tnet.params = params_from_jax(jax.tree.map(np.asarray, jnet.params),
                                  "cpu")
    tnet.opt_state = tnet.tx.init(tnet.params)
    return jnet, tnet


def _lm_data(seed, B, T):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, MOE["vocab_size"], (B, T)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@pytest.mark.parametrize("routing", ["routed", "dense"])
def test_moe_lm_three_sgd_steps_match_jax(routing):
    """The MoE LM (routed at capacity factor 1.25, with its aux loss in
    the training loss; and the dense oracle) through three fit() steps
    in both packages from the same params and tokens."""
    jnet, tnet = _moe_pair(32, routing=routing)
    jl, tl = [], []
    for s in range(3):
        toks, labels = _lm_data(20 + s, 4, 32)
        jnet.fit(JDataSet(toks, labels))
        tnet.fit(TDataSet(toks, labels))
        jl.append(jnet.score_value)
        tl.append(tnet.score_value)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jp = jax.tree.map(np.asarray, jnet.params)
    tp = params_to_numpy(tnet.params)
    for layer in jp:
        for name in jp[layer]:
            np.testing.assert_allclose(tp[layer][name], jp[layer][name],
                                       atol=PARAM_ATOL,
                                       err_msg=f"{layer}.{name}")
    if routing == "routed":
        # the aux loss is in the training loss: score() in training mode
        # exceeds the inference-mode score by the blocks' aux terms
        toks, labels = _lm_data(30, 4, 32)
        ds = TDataSet(toks, labels)
        jds = JDataSet(toks, labels)
        np.testing.assert_allclose(tnet.score(ds, training=True),
                                   jnet.score(jds, training=True),
                                   rtol=LOSS_RTOL)
        assert tnet.score(ds, training=True) > tnet.score(ds)


def test_moe_lm_remat_gradients_equal_no_remat():
    """remat on the MoE LM with dropout 0.1: two fit() steps leave the
    params bit for bit where the steps without remat do (one intra-op
    thread: the CPU's threaded reductions are not bitwise repeatable)."""
    toks, labels = _lm_data(40, 2, 32)
    ds = TDataSet(toks, labels)

    def run(remat):
        net = transformer_moe_lm(**MOE, max_length=32, dropout=0.1,
                                 remat=remat, device="cpu").init(5)
        net.fit(ds)
        net.fit(ds)
        return params_to_numpy(net.params)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain, remat = run(False), run(True)
    finally:
        torch.set_num_threads(threads)
    for layer in plain:
        for name in plain[layer]:
            np.testing.assert_array_equal(remat[layer][name],
                                          plain[layer][name])


def test_moe_flops_match_jax():
    args = (10000, 256, 6, 8, 2, 512, 512)
    assert transformer_moe_flops_per_token(*args) == jax_moe_flops(*args)
