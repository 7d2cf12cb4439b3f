"""The padding-bucket lattice — the shape contract between requests and
the serving workers (JAX counterpart deeplearning4j_tpu/serving/
buckets.py).

Every assembled predict batch, and every prompt chunk, is padded UP to
the smallest lattice point that fits, so the workers see a small fixed
set of shapes: in the JAX package that bounds the compiles, here it
bounds the kernel shapes and keeps the flash/dense dispatch a function
of the lattice alone. Selection is a pure function of the request shapes
(no clock, no state).

`validate_attention` checks every seq bucket against the attention
dispatch at server start (`servable_seq`: the flash kernels up to
T = 8192, the chunked tier and the monolithic fallback past it), so a
bucket no path serves fails there, with the dispatch's own reason,
instead of mid-traffic.

Pure stdlib.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Bucket:
    """One lattice point: the padded batch size and (for sequence
    models) the padded time length. `seq is None` means the model takes
    fixed-shape features and only the batch dimension is bucketed."""

    batch: int
    seq: int | None = None

    def key(self) -> tuple:
        return (self.batch, self.seq)


class BucketLattice:
    """The fixed (batch, seq) grid. `batch_sizes` sorted ascending;
    `seq_lens` is None for fixed-shape (non-sequence) models."""

    def __init__(self, batch_sizes=(1, 2, 4, 8), seq_lens=None):
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch sizes must be >= 1, got {batch_sizes}")
        self.batch_sizes = tuple(sizes)
        self.seq_lens = None
        if seq_lens is not None:
            lens = sorted({int(t) for t in seq_lens})
            if not lens or lens[0] < 1:
                raise ValueError(f"seq lens must be >= 1, got {seq_lens}")
            self.seq_lens = tuple(lens)

    # --------------------------------------------------------- selection
    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    @property
    def max_seq(self) -> int | None:
        return None if self.seq_lens is None else self.seq_lens[-1]

    def batch_bucket(self, n: int) -> int:
        """Smallest lattice batch size >= n (the batcher never cuts more
        than max_batch)."""
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds lattice max "
                             f"{self.max_batch}")
        for b in self.batch_sizes:
            if b >= n:
                return b
        raise AssertionError  # unreachable: guarded above

    def seq_bucket(self, t: int) -> int:
        """Smallest lattice seq len >= t; a prompt longer than the
        lattice max is a client error (HTTP 400), not a retrace."""
        if self.seq_lens is None:
            raise ValueError("lattice has no seq dimension (fixed-shape "
                             "model); construct with seq_lens to serve "
                             "sequences")
        if t > self.seq_lens[-1]:
            raise ValueError(f"sequence length {t} exceeds lattice max "
                             f"{self.seq_lens[-1]}")
        for s in self.seq_lens:
            if s >= t:
                return s
        raise AssertionError  # unreachable: guarded above

    def select(self, n_requests: int, max_len: int | None = None) -> Bucket:
        """The bucket for a group of `n_requests` whose longest sequence
        is `max_len` (None for fixed-shape models)."""
        seq = None
        if self.seq_lens is not None:
            if max_len is None:
                raise ValueError("sequence lattice needs the group's "
                                 "max length")
            seq = self.seq_bucket(max_len)
        return Bucket(self.batch_bucket(n_requests), seq)

    def shapes(self) -> list[Bucket]:
        """Every lattice point — the predict engine's warmup set; after
        warmup its trace count must not move."""
        if self.seq_lens is None:
            return [Bucket(b) for b in self.batch_sizes]
        return [Bucket(b, s) for b in self.batch_sizes
                for s in self.seq_lens]

    def prefill_buckets(self, chunk: int) -> list[int]:
        """The generation engine's prefill warmup set: every seq bucket
        up to the chunk length (a long prompt arrives as a sequence of
        exactly these shapes). The chunk must itself be a lattice
        point."""
        if self.seq_lens is None:
            raise ValueError("generation needs a sequence lattice "
                             "(construct with seq_lens)")
        if chunk not in self.seq_lens:
            raise ValueError(
                f"prefill chunk {chunk} must be a lattice seq bucket "
                f"{list(self.seq_lens)} — chunks are warmed shapes")
        return [t for t in self.seq_lens if t <= chunk]

    def validate_attention(self, head_dim: int, *, causal: bool = True,
                           dropout: bool = False,
                           masked: bool = True) -> None:
        """Check every seq bucket against the attention dispatch envelope
        so a bucket no path can serve fails at server start-up, not
        mid-traffic. No-op for fixed-shape lattices."""
        if self.seq_lens is None:
            return
        from deeplearning4j_tpu_torch.ops import flash_attention as fa

        for t in self.seq_lens:
            if not fa.servable_seq(t, head_dim, causal=causal,
                                   dropout=dropout, mask=masked):
                raise ValueError(
                    f"seq bucket {t} is outside the attention dispatch "
                    "envelope: "
                    + fa.chunked_unsupported_reason(
                        t, dropout=dropout, mask=masked, causal=causal,
                        head_dim=head_dim))

    def describe(self) -> dict:
        """JSON-able summary for /healthz and telemetry meta."""
        return {"batch_sizes": list(self.batch_sizes),
                "seq_lens": (None if self.seq_lens is None
                             else list(self.seq_lens))}

