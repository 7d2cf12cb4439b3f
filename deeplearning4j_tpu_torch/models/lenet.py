"""LeNet-5 on MNIST (BASELINE.json config 1) through the sequential
builder API (JAX counterpart deeplearning4j_tpu/models/lenet.py): the
same layers, names (layer_0 .. layer_5) and shapes, so a JAX net's params
copy across by name (weights_io.py)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    ConvolutionLayer,
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
    SubsamplingLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def lenet5(seed: int = 12345, learning_rate: float = 1e-3,
           updater: str = Updater.ADAM, dtype: str = "float32",
           device=None) -> MultiLayerNetwork:
    """LeNet-5 (two 5x5 convolutions of 20 and 50 channels, each followed
    by a 2x2 max pool, a dense layer of 500, a softmax output of 10) for
    28x28x1 NHWC input, on `device` (CUDA unless the caller names
    another)."""
    conf = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(updater)
        .weight_init("xavier")
        .dtype(dtype)
        .list()
        .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                activation="relu"))
        .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                activation="relu"))
        .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        .layer(DenseLayer(n_out=500, activation="relu"))
        .layer(OutputLayer(n_out=10, activation="softmax",
                           loss_function="mcxent"))
        .set_input_type(InputType.convolutional(28, 28, 1))
        .build()
    )
    return MultiLayerNetwork(conf, device=device)
