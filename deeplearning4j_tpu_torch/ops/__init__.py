"""Op surface: the activation registry, the loss functions, the wrappers
over the hand-written CUDA kernels (flash_attention.py,
fused_softmax_xent.py; csrc/) and the decode-side cache attention (JAX
counterpart deeplearning4j_tpu/ops)."""

from deeplearning4j_tpu_torch.ops.activations import (  # noqa: F401
    Activations,
    get_activation,
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
