"""Analytic operation counts of the hand-written kernels, for the cost
book (telemetry/costbook.py).

The cost book counts one warm call of a step under
`torch.utils.flop_counter.FlopCounterMode`, which sees the plain torch
products (mm, bmm, addmm, convolutions, SDPA) and nothing that a
kernel wrapper launches through `ctypes`. So every wrapper of K1–K13
adds its own analytic count here, beside its launch counter, and runs
its body with the counter's mode suspended: on the CPU the wrapper's
plain version is invisible to the flop counter, on the card the kernel
is, and the count is the same on both.

Each count is the operation count behind the wrapper's bound in
`chip_smoke.py` (the same formulas, the same convention):

| kernel | count |
|---|---|
| K1–K3 flash forward | 4·BH·P·D, P = T(T+1)/2 visible (query, key) pairs when causal, T² otherwise |
| K4–K7 flash backward | 10·BH·P·D (s, dp, dv, dk, dq: five products of 2·P·D each) |
| K8 head forward | 2·N·d·V (the logits) |
| K9 head backward | 6·N·d·V (the logits again, G·Wᵀ and xᵀ·G) |
| K10 LayerNorm forward | 8·N·C |
| K11 LayerNorm backward | 12·N·C |
| K12 sampling | B·V·(3 + 2·passes + [top-p]), passes = 24 per filter on |
| K13 SGNS scores | 2·(K+1)·B·D |

Outside a count (the steady state) `kernel` costs one truth test of a
module list.
"""

from __future__ import annotations

import contextlib
import threading

# the counts in progress (telemetry/costbook._Count), each holding the
# flop-counter mode whose thread-local stack marks the threads it counts
_ACTIVE: list = []
_MU = threading.Lock()


def flash_pairs(T: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head: T(T+1)/2 causal, T² not."""
    return T * (T + 1) // 2 if causal else T * T


def flash_fwd_ops(BH: int, T: int, D: int, causal: bool) -> int:
    return 4 * BH * flash_pairs(T, causal) * D


def flash_bwd_ops(BH: int, T: int, D: int, causal: bool) -> int:
    return 10 * BH * flash_pairs(T, causal) * D


def sample_ops(B: int, V: int, top_k: int, top_p: float) -> int:
    passes = 24 * (int(0 < top_k < V) + int(top_p < 1.0))
    return B * V * (3 + 2 * passes + (1 if top_p < 1.0 else 0))


def begin(count) -> None:
    with _MU:
        _ACTIVE.append(count)


def end(count) -> None:
    with _MU:
        if count in _ACTIVE:
            _ACTIVE.remove(count)


def _counts_here() -> list:
    """The counts whose flop-counter mode is on this thread's dispatch
    stack: the counted call's own thread and the autograd engine's
    device threads, which inherit the stack. Another serving replica's
    thread is not counted."""
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack,
    )

    stack = {id(getattr(m, "counter", m))
             for m in _get_current_dispatch_mode_stack()}
    with _MU:
        return [c for c in _ACTIVE if id(c.mode) in stack]


@contextlib.contextmanager
def kernel(label: str, ops: int):
    """Wrap a kernel wrapper's body: adds `ops` under `label` to every
    count in progress on this thread, and hides the body from their
    flop counter."""
    if not _ACTIVE:
        yield
        return
    counts = _counts_here()
    if not counts:
        yield
        return
    for c in counts:
        c.add_kernel(label, int(ops))
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield
