"""Layer implementations. Importing this package registers every impl."""

from deeplearning4j_tpu_torch.nn.layers.base import (  # noqa: F401
    LayerImpl,
    apply_dropout,
    get_impl,
    l1_l2_penalty,
    pop_aux_losses,
    register_impl,
)
import deeplearning4j_tpu_torch.nn.layers.feedforward  # noqa: F401
import deeplearning4j_tpu_torch.nn.layers.attention  # noqa: F401
import deeplearning4j_tpu_torch.nn.layers.convolution  # noqa: F401
import deeplearning4j_tpu_torch.nn.layers.recurrent  # noqa: F401
import deeplearning4j_tpu_torch.nn.layers.moe  # noqa: F401
import deeplearning4j_tpu_torch.nn.layers.nested  # noqa: F401
