"""Gradient checking (JAX counterpart
deeplearning4j_tpu/gradientcheck/gradient_check_util.py; reference
gradientcheck/GradientCheckUtil.java:48 (MultiLayerNetwork) and :140
(ComputationGraph)): central finite differences against the analytic
gradient, per parameter relative error, eps 1e-6, maxRelError 1e-3.

The analytic gradient is autograd's through the network loss (layers,
losses, masking, regularization), where the JAX package takes jax.grad.
Run it on a float64 net (`.dtype("float64").param_dtype("float64")`) on
the CPU, as the reference forces double precision. The loss is taken
with dropout off (no generator), so every evaluation is the same
function.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import tree


def check_gradients(net, dataset, *, epsilon: float = 1e-6,
                    max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
                    print_results: bool = False, subset: int | None = None,
                    seed: int = 12345) -> bool:
    """Central finite differences vs autograd for a MultiLayerNetwork or
    a ComputationGraph. `subset`: check only this many parameters, drawn
    with numpy from `seed` (the JAX package's choice)."""
    if hasattr(net, "_to_mds"):  # the graph
        dataset = net._to_mds(dataset)
    batch = net._batch_dict(dataset)
    like = net.params
    flat0 = tree.flatten(like).double()

    def loss_flat(flat):
        loss, _ = net._loss(tree.unflatten(flat, like), net.state, None,
                            batch)
        return loss

    x = flat0.clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss_flat(x), x)
    analytic = grad.detach().cpu().numpy().astype(np.float64)

    n = flat0.numel()
    idxs = np.arange(n, dtype=np.int64)
    if subset is not None and subset < n:
        idxs = np.random.default_rng(seed).choice(n, size=subset,
                                                  replace=False)
    max_err = 0.0
    fails = 0
    with torch.no_grad():
        for i in idxs:
            plus = flat0.clone()
            plus[i] += epsilon
            minus = flat0.clone()
            minus[i] -= epsilon
            numeric = (float(loss_flat(plus))
                       - float(loss_flat(minus))) / (2 * epsilon)
            a = analytic[i]
            denom = max(abs(a), abs(numeric))
            rel = 0.0 if denom == 0 else abs(a - numeric) / denom
            if rel > max_rel_error and abs(a - numeric) > min_abs_error:
                fails += 1
                if print_results:
                    print(f"param {i}: analytic {a:.6e} numeric "
                          f"{numeric:.6e} rel {rel:.3e}")
            max_err = max(max_err, rel)
    if print_results:
        print(f"checked {len(idxs)} params, max rel error {max_err:.3e}, "
              f"fails {fails}")
    return fails == 0


def check_gradients_graph(graph, mds, **kw) -> bool:
    """Gradient check of a ComputationGraph (reference
    GradientCheckUtil:140)."""
    return check_gradients(graph, mds, **kw)


class GradientCheckUtil:
    """Namespace matching the reference class name."""

    check_gradients = staticmethod(check_gradients)
    check_gradients_graph = staticmethod(check_gradients_graph)
