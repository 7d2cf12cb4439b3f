"""Expert parallelism of the port (parallel/expert_parallel.py, the
"expert" role of set_mesh, the split form of nn/layers/moe.py) against
the JAX package on the CPU.

In this process: `expert_parallel_apply` over 2 and 4 in-process shards
(`InProcessShards`) against the JAX package's dense MoE path, forward
and the gradients of the input and every param (`jax.vjp`); both routed
dispatches split over shards against the whole layer. On gloo fleets of
2 and 4 ranks (tests/torch_parallel_worker.py; the ranks import no
JAX): the MoE LM of the JAX package's tests/test_unified_mesh.py
`test_ep_train_via_set_mesh_matches_dense` (V 64, d 16, 2 heads, 2
blocks, 8 experts, top-2, expert hidden 32, T 8, B 8, routed) trained
three steps under {"expert": 2}, {"expert": 4} and {"data": 2,
"expert": 2} from the JAX net's params, against the JAX net trained
densely; with the model's Adam, the JAX contract's score tolerance.

Tolerances: f32; the split sums the shards' partial outputs in another
order: outputs and gradients 2e-5 absolute (inputs and params of order
one). After three SGD steps, params 2e-5 of the largest and the score
1e-5 relative (as tests/test_torch_moe.py holds the meshless MoE LM);
with Adam (lr 3e-4), the score within the contract's ATOL 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.api import DataSet as JDataSet
from deeplearning4j_tpu.nn.layers import moe as jmoe
from deeplearning4j_tpu_torch.nn.layers import moe as tmoe
from deeplearning4j_tpu_torch.ops.shard_comm import InProcessShards
from deeplearning4j_tpu_torch.parallel.expert_parallel import (
    expert_parallel_apply,
    shard_expert_params,
)
from fleet_util import assert_trained_close, jax_net, run_fleet

pytestmark = pytest.mark.port

OUT_ATOL = 2e-5
TOL = 2e-5
ADAM_ATOL = 2e-4
CFG = dict(vocab_size=64, d_model=16, n_heads=2, n_layers=2, n_experts=8,
           top_k=2, d_expert_hidden=32, max_length=8)
B, STEPS = 8, 3


def _params(seed, D=16, E=8, H=24, O=16, scale=0.5):
    rng = np.random.default_rng(seed)
    p = {"Wg": rng.standard_normal((D, E)),
         "We1": rng.standard_normal((E, D, H)),
         "be1": rng.standard_normal((E, H)),
         "We2": rng.standard_normal((E, H, O)),
         "be2": rng.standard_normal((E, O))}
    return {k: (scale * v).astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("n", [2, 4])
def test_in_process_expert_split_matches_jax_dense(n):
    """n shards of 8/n experts each, the partial outputs summed: the JAX
    package's dense MoE forward and its gradients in x and every param
    (the router's through the gates each shard reads its slice of)."""
    p = _params(1)
    x = np.random.default_rng(2).standard_normal((3, 10, 16)).astype(
        np.float32)
    cot = np.random.default_rng(3).standard_normal((3, 10, 16)).astype(
        np.float32)

    def jfn(params, xs):
        y = jmoe.moe_apply_dense(params, xs.reshape(-1, 16), top_k=2,
                                 activation="gelu")
        return y.reshape(xs.shape[:-1] + (16,))

    jy, vjp = jax.vjp(jfn, {k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ty = expert_parallel_apply(tp, tx, top_k=2, n_shards=n)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=OUT_ATOL, rtol=0)
    grads = torch.autograd.grad(ty, [tx] + list(tp.values()),
                                torch.from_numpy(cot))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx),
                               atol=OUT_ATOL, rtol=0)
    for name, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]),
                                   atol=OUT_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("n,cf", [(2, 1.0), (4, 0.5), (4, 2.0)])
def test_routed_split_matches_whole_layer(dispatch, n, cf):
    """The capacity-routed path (tokens dropped over capacity at cf <= 1,
    a ragged last group) split over n in-process shards: output, aux
    loss and gradients as the whole layer's."""
    p = _params(4)
    x = np.random.default_rng(5).standard_normal((40, 16)).astype(np.float32)
    kw = dict(top_k=2, capacity_factor=cf, activation="gelu", group_size=16,
              return_aux=True, dispatch=dispatch)

    def run(experts_of):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
        tx = torch.from_numpy(x).requires_grad_()
        y, aux = tmoe.moe_apply_routed(tp, tx, experts=experts_of(tp), **kw)
        grads = torch.autograd.grad((y ** 2).sum() + aux,
                                    [tx] + list(tp.values()))
        return y.detach(), aux.detach(), grads

    def split(tp):
        w = 8 // n
        return InProcessShards(n), [
            {k: (v[j * w:(j + 1) * w] if k != "Wg" else v)
             for k, v in tp.items()} for j in range(n)]

    yw, aw, gw = run(lambda tp: None)
    ys, as_, gs = run(split)
    torch.testing.assert_close(ys, yw, rtol=0, atol=OUT_ATOL)
    assert float(as_) == float(aw)
    for name, a, b in zip(["x"] + list(p), gs, gw):
        torch.testing.assert_close(a, b, rtol=0, atol=OUT_ATOL * max(
            1.0, float(b.abs().max())), msg=name)


def test_expert_counts_that_do_not_divide_raise():
    p = {k: torch.from_numpy(v) for k, v in _params(6).items()}
    with pytest.raises(ValueError, match="8 experts not divisible over 3"):
        expert_parallel_apply(p, torch.zeros(2, 16), top_k=2, n_shards=3)
    from types import SimpleNamespace

    mesh = SimpleNamespace(axis_size=lambda a: 3, axis_index=lambda a: 0)
    with pytest.raises(ValueError, match="not divisible over 3"):
        shard_expert_params(p, mesh)
    mesh = SimpleNamespace(axis_size=lambda a: 4, axis_index=lambda a: 1)
    shard = shard_expert_params(p, mesh)
    assert shard["We1"].shape == (2, 16, 24) and shard["Wg"] is p["Wg"]
    torch.testing.assert_close(shard["be2"], p["be2"][2:4])


# ------------------------------------------------------------ gloo fleets

def _batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        x = rng.integers(0, CFG["vocab_size"], (B, CFG["max_length"]))
        x = x.astype(np.int32)
        out.append((x, np.roll(x, -1, axis=1), None))
    return out


def _case(name, mesh, axes, sgd=True):
    case = dict(name=name, kind="mesh", model="moe", cfg=CFG, mesh=mesh,
                axes=axes, batches=_batches())
    if sgd:
        case.update(updater="sgd", lr=0.1)
    return case


CASES = {
    2: [_case("ep_e2", {"expert": 2}, {"expert": "expert"})],
    4: [_case("ep_e4", {"expert": 4}, {"expert": "expert"}),
        _case("ep_d2e2", {"data": 2, "expert": 2},
              {"data": "data", "expert": "expert"}),
        _case("ep_d2e2_adam", {"data": 2, "expert": 2},
              {"data": "data", "expert": "expert"}, sgd=False)],
}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    out = {}
    for n, cases in CASES.items():
        d = tmp_path_factory.mktemp(f"ep{n}")
        for c in cases:
            c["ckpt"] = str(d / f"ckpt_{c['name']}")
        out[n] = run_fleet(d, n, cases)
    return out


def _jax_dense(case):
    net = jax_net(case)
    for x, y, _ in case["batches"]:
        net.fit(JDataSet(x, y))
    return net


@pytest.mark.parametrize("n,name", [(2, "ep_e2"), (4, "ep_e4"),
                                    (4, "ep_d2e2")])
def test_expert_parallel_matches_jax_dense(fleets, n, name):
    """Three SGD steps of the routed MoE LM with its experts split (and
    the batch over "data"): canonical params and score as the JAX net
    trained on one device; each rank holds 8/m experts of each MoE
    layer and a whole router; the checkpoint holds the canonical
    trees."""
    case = next(c for c in CASES[n] if c["name"] == name)
    outs = fleets[n]
    assert_trained_close(outs, name, _jax_dense(case), TOL)
    m = case["mesh"]["expert"]
    for out in outs:
        for blk in ("blk0_moe", "blk1_moe"):
            assert tuple(out[f"{name}/split/{blk}/We1"]) == (8 // m, 16, 32)
            assert tuple(out[f"{name}/split/{blk}/be2"]) == (8 // m, 16)
            assert f"{name}/split/{blk}/Wg" not in out
        assert bool(out[f"{name}/ckpt_is_canonical"])


def test_expert_parallel_adam_score_within_the_jax_contract(fleets):
    """The JAX package's test_ep_train_via_set_mesh_matches_dense, at 4
    ranks ({"data": 2, "expert": 2} for its data: 2, expert: 4): the
    score after three steps of the model's Adam within 2e-4 of the dense
    net's."""
    case = next(c for c in CASES[4] if c["name"] == "ep_d2e2_adam")
    jnet = _jax_dense(case)
    for out in fleets[4]:
        assert abs(float(out["ep_d2e2_adam/score"])
                   - float(jnet.score_value)) < ADAM_ATOL
