"""VGG-16 on CIFAR-10 (BASELINE.json config 2) through the DAG builder
API (JAX counterpart deeplearning4j_tpu/models/vgg.py): the same vertex
names and shapes, so a JAX net's params and batch-norm state copy across
by name (weights_io.py)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
        512, 512, 512, "M"]


def vgg16(num_classes: int = 10, image_size: int = 32, seed: int = 12345,
          learning_rate: float = 1e-3, batch_norm: bool = True,
          dtype: str = "float32", device=None) -> ComputationGraph:
    """VGG-16 (13 SAME 3x3 convolutions, each with batch norm unless
    `batch_norm` is off, five 2x2 max pools, a dense layer of 512 and a
    softmax output) for image_size² x 3 NHWC input, trained with Adam, on
    `device` (CUDA unless the caller names another)."""
    g = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(Updater.ADAM)
        .weight_init("relu")
        .dtype(dtype)
        .graph_builder()
        .add_inputs("input")
    )
    prev = "input"
    for i, v in enumerate(_CFG):
        if v == "M":
            name = f"pool{i}"
            g.add_layer(name, SubsamplingLayer(kernel_size=(2, 2),
                                               stride=(2, 2)), prev)
        else:
            name = f"conv{i}"
            g.add_layer(name, ConvolutionLayer(
                n_out=v, kernel_size=(3, 3), stride=(1, 1),
                convolution_mode="same", activation="relu"), prev)
            if batch_norm:
                bn = f"bn{i}"
                g.add_layer(bn, BatchNormalization(), name)
                name = bn
        prev = name
    g.add_layer("fc1", DenseLayer(n_out=512, activation="relu"), prev)
    g.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss_function="mcxent"), "fc1")
    g.set_outputs("out")
    g.set_input_types(input=InputType.convolutional(image_size, image_size,
                                                    3))
    return ComputationGraph(g.build(), device=device)
