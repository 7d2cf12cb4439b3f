"""Model zoo (JAX counterpart deeplearning4j_tpu/models): the BASELINE.json
configs in the builder API — LeNet-5, VGG-16, ResNet-20 and the
Transformer LM and its MoE variant."""

from deeplearning4j_tpu_torch.models.lenet import lenet5  # noqa: F401
from deeplearning4j_tpu_torch.models.resnet import resnet20  # noqa: F401
from deeplearning4j_tpu_torch.models.transformer import (  # noqa: F401
    transformer_lm,
    transformer_moe_lm,
)
from deeplearning4j_tpu_torch.models.vgg import vgg16  # noqa: F401
