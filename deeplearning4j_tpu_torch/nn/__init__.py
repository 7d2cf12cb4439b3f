"""NN core: configs, layers, the graph container and incremental decode
(JAX counterpart deeplearning4j_tpu/nn)."""
