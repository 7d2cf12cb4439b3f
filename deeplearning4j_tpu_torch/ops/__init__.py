"""Op surface: the activation registry, the loss functions, the wrappers
over the hand-written CUDA kernels (flash_attention.py,
fused_softmax_xent.py; csrc/) and the decode-side cache attention (JAX
counterpart deeplearning4j_tpu/ops)."""

from deeplearning4j_tpu_torch.ops.activations import (  # noqa: F401
    Activations,
    get_activation,
)
