"""The Transformer LM via the DAG builder API (JAX counterpart
deeplearning4j_tpu/models/transformer.py). Pre-norm blocks:

  x → Embedding → +PosEnc → [LN → MHSA → +res → LN → FF(gelu) → FF → +res]×L
    → LN → RnnOutput(softmax over vocab)

Same layer names, shapes and config fields as the JAX package's
`transformer_lm`, so its params copy across by name (weights_io.py), and
the same FLOP accounting (`transformer_flops_per_token[_executed]`). The
MoE variant, `remat` and the sequence-parallel options come with later
slices.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf import (
    DenseLayer,
    ElementWiseVertexConf,
    EmbeddingLayer,
    InputType,
    LayerNormalization,
    NeuralNetConfiguration,
    PositionalEncodingLayer,
    RnnOutputLayer,
    SelfAttentionLayer,
    Updater,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph


def transformer_lm(vocab_size: int = 10000, d_model: int = 256,
                   n_heads: int = 4, n_layers: int = 6, d_ff: int = 1024,
                   max_length: int = 512, dropout: float = 0.0,
                   seed: int = 12345, learning_rate: float = 3e-4,
                   dtype: str = "float32", attention_dropout: float = None,
                   device=None) -> ComputationGraph:
    """The dense-FF LM on `device` (CUDA unless the caller names
    another), trained with Adam at `learning_rate`; `dropout` drops the
    attention and FF inputs and (unless `attention_dropout` says
    otherwise) the attention weights while training."""
    g = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(Updater.ADAM)
        .weight_init("xavier")
        .dtype(dtype)
        .graph_builder()
        .add_inputs("tokens")
    )
    g.add_layer("embed", EmbeddingLayer(n_in=vocab_size, n_out=d_model,
                                        activation="identity",
                                        has_bias=False), "tokens")
    g.add_layer("posenc", PositionalEncodingLayer(
        max_length=max_length, n_features=d_model), "embed")
    prev = "posenc"
    for i in range(n_layers):
        b = f"blk{i}"
        g.add_layer(f"{b}_ln1", LayerNormalization(n_in=d_model,
                                                   n_out=d_model), prev)
        g.add_layer(f"{b}_attn", SelfAttentionLayer(
            n_in=d_model, n_out=d_model, n_heads=n_heads, causal=True,
            dropout=dropout,
            attention_dropout=(dropout if attention_dropout is None
                               else attention_dropout),
            activation="identity"), f"{b}_ln1")
        g.add_vertex(f"{b}_res1", ElementWiseVertexConf(op="add"),
                     prev, f"{b}_attn")
        g.add_layer(f"{b}_ln2", LayerNormalization(n_in=d_model,
                                                   n_out=d_model),
                    f"{b}_res1")
        g.add_layer(f"{b}_ff1", DenseLayer(n_in=d_model, n_out=d_ff,
                                           activation="gelu",
                                           dropout=dropout), f"{b}_ln2")
        g.add_layer(f"{b}_ff2", DenseLayer(n_in=d_ff, n_out=d_model,
                                           activation="identity"),
                    f"{b}_ff1")
        g.add_vertex(f"{b}_res2", ElementWiseVertexConf(op="add"),
                     f"{b}_res1", f"{b}_ff2")
        prev = f"{b}_res2"
    g.add_layer("ln_f", LayerNormalization(n_in=d_model, n_out=d_model), prev)
    g.add_layer("out", RnnOutputLayer(n_in=d_model, n_out=vocab_size,
                                      activation="softmax",
                                      loss_function="mcxent"), "ln_f")
    g.set_outputs("out")
    g.set_input_types(tokens=InputType.recurrent(1))
    return ComputationGraph(g.build(), device=device)


def transformer_flops_per_token(vocab_size, d_model, n_layers, d_ff, seq_len,
                                attention_factor=1.0):
    """Analytic forward+backward FLOPs per token for MFU accounting
    (backward ≈ 2x forward), the attention quadratic term counted on the
    full [T, T] matrix and scaled by `attention_factor` — the JAX
    package's formula, so both report the same model FLOPs."""
    per_layer = (
        4 * 2 * d_model * d_model  # qkv + out proj: 4 [d,d] matmuls
        + 2 * 2 * d_model * d_ff  # two FF matmuls
        + attention_factor * 2 * 2 * seq_len * d_model  # qk^T and attn@v
    )
    fwd = n_layers * per_layer + 2 * d_model * vocab_size  # + LM head
    return int(3 * fwd)


def causal_attention_factor(seq_len: int) -> float:
    """Executed fraction of the dense [T, T] attention matrix under a
    causal mask: T(T+1)/2 visible (query, key) pairs out of T*T."""
    return (seq_len + 1) / (2.0 * seq_len)


def transformer_flops_per_token_executed(vocab_size, d_model, n_layers,
                                         d_ff, seq_len, causal=True):
    """FLOPs per token counting the attention term at the T(T+1)/2 causal
    pairs the kernels execute (`causal_attention_factor`), not the full
    [T, T] matrix."""
    return transformer_flops_per_token(
        vocab_size, d_model, n_layers, d_ff, seq_len,
        attention_factor=causal_attention_factor(seq_len) if causal
        else 1.0)
