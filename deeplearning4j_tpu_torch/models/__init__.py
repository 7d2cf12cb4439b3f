"""Model zoo (JAX counterpart deeplearning4j_tpu/models): the configs the
port serves."""

from deeplearning4j_tpu_torch.models.transformer import transformer_lm  # noqa: F401
