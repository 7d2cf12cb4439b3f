"""ResNet-20 for CIFAR-10 (BASELINE.json config 4, the model of the
data-parallel benchmark) through the DAG builder API (JAX counterpart
deeplearning4j_tpu/models/resnet.py): residual adds are
ElementWiseVertexConf(op="add"); the same vertex names and shapes, so a
JAX net's params and batch-norm state copy across by name
(weights_io.py)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ActivationLayer,
    BatchNormalization,
    ConvolutionLayer,
    DenseLayer,
    ElementWiseVertexConf,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph


def resnet20(num_classes: int = 10, seed: int = 12345,
             learning_rate: float = 1e-3, dtype: str = "float32",
             device=None) -> ComputationGraph:
    """ResNet-20 (a 3x3 stem of 16 channels, nine residual blocks of two
    SAME 3x3 convolutions at 16, 32 and 64 channels, stride 2 at the
    stage boundaries with 1x1 projection shortcuts, an 8x8 average pool,
    a dense layer of 64 and a softmax output) for 32x32x3 NHWC input,
    trained with Adam, on `device` (CUDA unless the caller names
    another)."""
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
    g.add_layer("conv0", ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                          convolution_mode="same",
                                          activation="identity"), "input")
    g.add_layer("bn0", BatchNormalization(activation="relu"), "conv0")
    prev = "bn0"
    widths = [16, 16, 16, 32, 32, 32, 64, 64, 64]
    for i, w in enumerate(widths):
        stride = 2 if i in (3, 6) else 1  # downsample at stage boundaries
        base = f"b{i}"
        g.add_layer(f"{base}_conv1", ConvolutionLayer(
            n_out=w, kernel_size=(3, 3), stride=(stride, stride),
            convolution_mode="same", activation="identity"), prev)
        g.add_layer(f"{base}_bn1", BatchNormalization(activation="relu"),
                    f"{base}_conv1")
        g.add_layer(f"{base}_conv2", ConvolutionLayer(
            n_out=w, kernel_size=(3, 3), convolution_mode="same",
            activation="identity"), f"{base}_bn1")
        g.add_layer(f"{base}_bn2", BatchNormalization(activation="identity"),
                    f"{base}_conv2")
        shortcut = prev
        if stride != 1 or i == 0:
            # 1x1 projection shortcut where the shape changes
            g.add_layer(f"{base}_proj", ConvolutionLayer(
                n_out=w, kernel_size=(1, 1), stride=(stride, stride),
                convolution_mode="same", activation="identity"), prev)
            shortcut = f"{base}_proj"
        g.add_vertex(f"{base}_add", ElementWiseVertexConf(op="add"),
                     f"{base}_bn2", shortcut)
        g.add_layer(f"{base}_relu", ActivationLayer(activation="relu"),
                    f"{base}_add")
        prev = f"{base}_relu"
    # global average pool: an 8x8 AVG subsampling of the 8x8 last stage
    g.add_layer("gap", SubsamplingLayer(pooling_type="avg", kernel_size=(8, 8),
                                        stride=(8, 8)), prev)
    g.add_layer("fc", DenseLayer(n_out=64, activation="relu"), "gap")
    g.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss_function="mcxent"), "fc")
    g.set_outputs("out")
    g.set_input_types(input=InputType.convolutional(32, 32, 3))
    return ComputationGraph(g.build(), device=device)
