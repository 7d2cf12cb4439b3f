"""Self-speculative n-gram draft proposal, the host half of speculative
decoding (JAX counterpart deeplearning4j_tpu/serving/speculative.py,
kept as the same pure host code).

A cheap draft proposer guesses the next k-1 tokens of each slot's
continuation, and one fixed-shape verification step
(nn/decode.make_verify_fn) checks the whole window: every accepted draft
is a decode step the slot never runs. The proposer is self-speculative:
no second model, no extra device memory. It mines the request's own
token history (prompt + everything emitted so far):

* longest-suffix n-gram match (order high to low): if the last n tokens
  of the history occurred earlier, propose whatever followed that
  earlier occurrence (the prompt-lookup decoder);
* fallback: repeat the last token (the order-0 guess, which wins
  whenever greedy decode has entered a fixed point).

It works on Python ints only and never touches logits or device
tensors. Acceptance (greedy): the verify step returns the model's argmax
m_i after each window row; the accepted window is the longest prefix
where each draft matches the argmax before it (d_{i+1} == m_i), plus the
bonus token m_a that ends it (`accept_greedy`), so every emitted token
is a model argmax given exactly the tokens before it.
"""

from __future__ import annotations


class NgramProposer:
    """Draft proposer over one slot's token history.

    `propose(history, n)` -> list of n draft ints. `history` is the
    slot's full token context (prompt + emitted), oldest first.
    Stateless across calls — all signal is in the history itself — so
    slot reuse needs no reset and replica respawn loses nothing."""

    def __init__(self, max_order: int = 3):
        if max_order < 1:
            raise ValueError(f"need max_order >= 1, got {max_order}")
        self.max_order = int(max_order)

    def propose(self, history, n: int) -> list[int]:
        if n <= 0:
            return []
        hist = [int(t) for t in history]
        if not hist:
            return [0] * n
        out = self._ngram_continuation(hist, n)
        if out is None:
            out = [hist[-1]] * n  # order-0: greedy fixed-point guess
        return out

    def _ngram_continuation(self, hist, n: int):
        """Longest-suffix match: find the most recent earlier
        occurrence of the last `order` tokens (highest order first) and
        propose what followed it, extending cyclically from the match
        if the continuation runs off the end."""
        L = len(hist)
        for order in range(min(self.max_order, L - 1), 0, -1):
            suffix = hist[L - order:]
            # scan right-to-left: the most recent precedent is the
            # best predictor of what comes next
            for i in range(L - order - 1, -1, -1):
                if hist[i:i + order] == suffix:
                    cont = hist[i + order:i + order + n]
                    j = i
                    while len(cont) < n:
                        cont.append(hist[j % L])
                        j += 1
                    return cont[:n]
        return None


def accept_greedy(drafts, model_argmax) -> tuple[int, list[int]]:
    """The greedy acceptance mask for one slot's verify window.

    drafts: the k-1 proposed tokens d_1..d_{k-1} (window rows 1..k-1);
    model_argmax: the k verify-row argmaxes m_0..m_{k-1}. Returns
    (n_accepted, emitted): the longest prefix a with d_{i+1} == m_i for
    all i < a, and the a+1 tokens to emit — m_0..m_a (each one a model
    argmax given exactly its true prefix, so the emitted stream is
    bit-identical to non-speculative greedy). n_accepted counts the
    accepted DRAFTS (0..k-1); len(emitted) == n_accepted + 1."""
    m = [int(t) for t in model_argmax]
    d = [int(t) for t in drafts]
    if len(d) != len(m) - 1:
        raise ValueError(
            f"window mismatch: {len(d)} drafts vs {len(m)} verify rows")
    a = 0
    while a < len(d) and d[a] == m[a]:
        a += 1
    return a, m[:a + 1]
