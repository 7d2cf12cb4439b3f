"""The Transformer LM via the DAG builder API (JAX counterpart
deeplearning4j_tpu/models/transformer.py). Pre-norm blocks:

  x → Embedding → +PosEnc → [LN → MHSA → +res → LN → FF(gelu) → FF → +res]×L
    → LN → RnnOutput(softmax over vocab)

Same layer names, shapes and config fields as the JAX package's
`transformer_lm`, so its params copy across by name (weights_io.py), and
the same FLOP accounting (`transformer_flops_per_token[_executed]`,
`transformer_moe_flops_per_token`); the MoE variant
(`transformer_moe_lm`) and `remat` as the JAX package's, and
`seq_parallel_axis` for sequence parallelism (ring attention and offset
positional encodings in a `seq` mesh step, parallel/sequence_parallel.py).
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


def _build_lm(vocab_size, d_model, n_heads, n_layers, max_length, dropout,
              seed, learning_rate, dtype, remat, attention_dropout,
              ff_builder, device, seq_parallel_axis="") -> ComputationGraph:
    """The pre-norm LM skeleton; `ff_builder(g, block, input_name)` adds
    each block's feed-forward sublayer(s) and returns the output name:
    the dense and MoE variants differ only there."""
    g = (
        NeuralNetConfiguration.builder()
        .seed(seed)
        .learning_rate(learning_rate)
        .updater(Updater.ADAM)
        .weight_init("xavier")
        .dtype(dtype)
        .remat(remat)
        .graph_builder()
        .add_inputs("tokens")
    )
    g.add_layer("embed", EmbeddingLayer(n_in=vocab_size, n_out=d_model,
                                        activation="identity",
                                        has_bias=False), "tokens")
    g.add_layer("posenc", PositionalEncodingLayer(
        max_length=max_length, n_features=d_model,
        seq_parallel_axis=seq_parallel_axis), "embed")
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
            activation="identity",
            seq_parallel_axis=seq_parallel_axis), f"{b}_ln1")
        g.add_vertex(f"{b}_res1", ElementWiseVertexConf(op="add"),
                     prev, f"{b}_attn")
        g.add_layer(f"{b}_ln2", LayerNormalization(n_in=d_model,
                                                   n_out=d_model),
                    f"{b}_res1")
        g.add_vertex(f"{b}_res2", ElementWiseVertexConf(op="add"),
                     f"{b}_res1", ff_builder(g, b, f"{b}_ln2"))
        prev = f"{b}_res2"
    g.add_layer("ln_f", LayerNormalization(n_in=d_model, n_out=d_model), prev)
    g.add_layer("out", RnnOutputLayer(n_in=d_model, n_out=vocab_size,
                                      activation="softmax",
                                      loss_function="mcxent"), "ln_f")
    g.set_outputs("out")
    g.set_input_types(tokens=InputType.recurrent(1))
    return ComputationGraph(g.build(), device=device)


def transformer_lm(vocab_size: int = 10000, d_model: int = 256,
                   n_heads: int = 4, n_layers: int = 6, d_ff: int = 1024,
                   max_length: int = 512, dropout: float = 0.0,
                   seed: int = 12345, learning_rate: float = 3e-4,
                   dtype: str = "float32", remat: bool = False,
                   seq_parallel_axis: str = "",
                   attention_dropout: float = None,
                   device=None) -> ComputationGraph:
    """The dense-FF LM on `device` (CUDA unless the caller names
    another), trained with Adam at `learning_rate`; `dropout` drops the
    attention and FF inputs and (unless `attention_dropout` says
    otherwise) the attention weights while training; `remat` recomputes
    each vertex's activations in the backward; `seq_parallel_axis` names
    the mesh axis to shard time over (an SP-ready conf for
    parallel/sequence_parallel.py)."""
    def ff(g, b, src):
        g.add_layer(f"{b}_ff1", DenseLayer(n_in=d_model, n_out=d_ff,
                                           activation="gelu",
                                           dropout=dropout), src)
        g.add_layer(f"{b}_ff2", DenseLayer(n_in=d_ff, n_out=d_model,
                                           activation="identity"),
                    f"{b}_ff1")
        return f"{b}_ff2"

    return _build_lm(vocab_size, d_model, n_heads, n_layers, max_length,
                     dropout, seed, learning_rate, dtype, remat,
                     attention_dropout, ff, device,
                     seq_parallel_axis=seq_parallel_axis)


def transformer_moe_lm(vocab_size: int = 10000, d_model: int = 256,
                       n_heads: int = 4, n_layers: int = 6,
                       n_experts: int = 8, top_k: int = 2,
                       d_expert_hidden: int = 512, max_length: int = 512,
                       dropout: float = 0.0, seed: int = 12345,
                       learning_rate: float = 3e-4, dtype: str = "float32",
                       remat: bool = False, routing: str = "routed",
                       capacity_factor: float = 1.25,
                       device=None) -> ComputationGraph:
    """The Mixture-of-Experts LM: each block's dense FF replaced by a
    top-k gated expert FFN (nn/layers/moe.py; `dropout` drops the expert
    input as the dense variant's first FF layer's); routing="routed"
    (default) dispatches tokens at `capacity_factor`, "dense" runs every
    expert (the oracle)."""
    from deeplearning4j_tpu_torch.nn.layers.moe import MixtureOfExpertsLayer

    def ff(g, b, src):
        g.add_layer(f"{b}_moe", MixtureOfExpertsLayer(
            n_in=d_model, n_out=d_model, n_experts=n_experts, top_k=top_k,
            d_hidden=d_expert_hidden, activation="gelu", dropout=dropout,
            routing=routing, capacity_factor=capacity_factor), src)
        return f"{b}_moe"

    return _build_lm(vocab_size, d_model, n_heads, n_layers, max_length,
                     dropout, seed, learning_rate, dtype, remat, None, ff,
                     device)


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


def transformer_moe_flops_per_token(vocab_size, d_model, n_layers,
                                    n_experts, top_k, d_expert_hidden,
                                    seq_len):
    """Forward+backward FLOPs per token of the MoE LM: the dense FF term
    becomes top_k expert FFNs plus the router product. Useful FLOPs only:
    the capacity buffers' zero padding is the implementation's overhead,
    not model compute (the JAX package's formula)."""
    per_layer = (
        4 * 2 * d_model * d_model
        + top_k * 2 * 2 * d_model * d_expert_hidden  # k routed expert FFNs
        + 2 * d_model * n_experts                    # router logits
        + 2 * 2 * seq_len * d_model
    )
    fwd = n_layers * per_layer + 2 * d_model * vocab_size
    return 3 * fwd
