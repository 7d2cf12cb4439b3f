"""Op surface: the activation registry, the loss functions, the wrappers
over the hand-written CUDA kernels (flash_attention.py,
fused_softmax_xent.py; csrc/) and the decode-side cache attention (JAX
counterpart deeplearning4j_tpu/ops)."""

from deeplearning4j_tpu_torch.ops.activations import (  # noqa: F401
    Activations,
    get_activation,
)
from deeplearning4j_tpu_torch.ops.losses import (  # noqa: F401
    LossFunction,
    compute_loss,
    loss_fn,
)


class SecondDerivativeError(RuntimeError):
    """A second derivative was asked of a hand-written kernel (the
    Hessian-vector products of the HessianFree solver). The kernels'
    backward passes are kernels too, with no derivative of their own, as
    the JAX package's custom VJPs have none."""


def refuse_double_backward(kernel: str) -> None:
    """Called first in a kernel Function's backward: autograd runs a
    backward with grad mode on only when it builds a graph of it
    (create_graph=True), i.e. for a second derivative."""
    import torch

    if torch.is_grad_enabled():
        raise SecondDerivativeError(
            f"{kernel}: no second derivative through this kernel; a "
            "Hessian-vector product (HessianFree) needs a network that "
            "takes no kernel route")


def launch_counts() -> dict:
    """The launch counters of every kernel wrapper (K1–K13, and K9's
    dW/db kernel as "K9 dW") merged into one dict: what a process has
    launched on the card since its counters were last reset."""
    from deeplearning4j_tpu_torch.ops import (
        flash_attention,
        fused_layernorm,
        fused_neg_softmax,
        fused_sampling,
        fused_softmax_xent,
    )

    out = {}
    for mod in (flash_attention, fused_softmax_xent, fused_layernorm,
                fused_sampling, fused_neg_softmax):
        out.update(mod.LAUNCHES)
    return out
