"""Page-block KV-cache accounting on the bucket lattice (JAX counterpart
deeplearning4j_tpu/serving/kvcache.py).

The generation engine's device cache is ONE static allocation per
worker — ``[n_slots, capacity, H, D]`` per attention layer. What varies
per request is how much of a slot's row it earns; this module is the
page-granular accounting overlay on that allocation.

* Capacities are quantized to the ``(max_seqlen_bucket, page_size)``
  grid: a slot's key budget is ``quantize(prompt_bucket + max_new,
  page_size)``, never a raw request length.
* A ``PagePool`` holds the page budget. Admission reserves a request's
  worst-case pages (its quantized prompt + output budget) up front;
  completion (or failure) releases them. So exhaustion can only happen
  at admission, where the request waits in the queue, never mid-decode.
* The pool tracks pages in use and the high-water mark (`peak_in_use`),
  the occupancy the engine reports.
* The cache dtype is part of the accounting: an ``int8`` paged cache
  stores 1-byte codes plus one f32 scale per (page, head), so a slot's
  device-memory bill shrinks about 4x against f32. `bytes_per_slot` is
  the one home of that arithmetic; the speculative replay's
  ``slots_per_hbm_byte`` ratio is computed from it.

Pure stdlib.
"""

from __future__ import annotations

import threading

DEFAULT_PAGE_SIZE = 16

KV_DTYPES = ("f32", "int8")


def validate_kv_dtype(kv_dtype: str) -> str:
    """The serving cache dtype ('f32' | 'int8'), validated at the engine
    front door so a typo fails at construction."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype


def bytes_per_slot(capacity: int, attention_specs, kv_dtype: str = "f32",
                   page_size: int = DEFAULT_PAGE_SIZE) -> int:
    """Device bytes one decode slot's K+V rows cost across all attention
    layers. `attention_specs` is nn/decode.py's list of (name, n_heads,
    head_dim). f32: capacity*H*D*4 per tensor. int8: 1-byte codes plus
    one f32 scale per (page, head) per tensor."""
    validate_kv_dtype(kv_dtype)
    total = 0
    for _name, H, D in attention_specs:
        if kv_dtype == "f32":
            per_tensor = capacity * H * D * 4
        else:
            per_tensor = (capacity * H * D
                          + (capacity // int(page_size)) * H * 4)
        total += 2 * per_tensor  # K and V
    return total


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering `n_tokens` key slots (ceil)."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(page_size))


def quantize(n_tokens: int, page_size: int) -> int:
    """`n_tokens` rounded UP to the page grid — the only key-capacity
    shapes the device cache ever has."""
    return pages_for(n_tokens, page_size) * int(page_size)


class PagePool:
    """Thread-safe page budget for one worker's cache allocation.

    `try_reserve` takes the whole reservation or none of it (a
    half-admitted request would deadlock the slot machine); `release`
    returns pages at completion. The high-water mark (`peak_in_use`) is
    the occupancy headline's numerator."""

    def __init__(self, n_pages: int, page_size: int = DEFAULT_PAGE_SIZE):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"page pool needs n_pages >= 1 and page_size >= 1; got "
                f"{n_pages} pages of {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._in_use = 0
        self.peak_in_use = 0
        self._lock = threading.Lock()

    def pages_for(self, n_tokens: int) -> int:
        """Pages of this pool's size covering `n_tokens` key slots."""
        return pages_for(n_tokens, self.page_size)

    def try_reserve(self, n_pages: int) -> bool:
        with self._lock:
            if self._in_use + n_pages > self.n_pages:
                return False
            self._in_use += n_pages
            self.peak_in_use = max(self.peak_in_use, self._in_use)
            return True

    def release(self, n_pages: int) -> None:
        with self._lock:
            if n_pages > self._in_use:
                raise ValueError(
                    f"releasing {n_pages} pages with only {self._in_use} "
                    "reserved — double release")
            self._in_use -= n_pages

    @property
    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    @property
    def occupancy(self) -> float:
        return self.in_use / self.n_pages

    @property
    def peak_occupancy(self) -> float:
        with self._lock:
            return self.peak_in_use / self.n_pages

    def describe(self) -> dict:
        with self._lock:
            return {"pages_total": self.n_pages,
                    "page_size": self.page_size,
                    "pages_in_use": self._in_use,
                    "pages_peak": self.peak_in_use}


class CachePlan:
    """The quantized cache geometry one worker allocates: `n_slots` rows
    of `capacity` key slots, where capacity is the largest prompt bucket
    plus the output budget, rounded up to the page grid. The default
    pool budget is exactly the allocation (`n_slots` rows' pages); a
    smaller `pool_pages` models a tighter memory budget — admission then
    queues before the slots run out."""

    def __init__(self, max_seq_bucket: int, max_new_tokens: int,
                 n_slots: int, page_size: int = DEFAULT_PAGE_SIZE,
                 pool_pages: int | None = None, kv_dtype: str = "f32"):
        if n_slots < 1:
            raise ValueError(f"need n_slots >= 1, got {n_slots}")
        self.page_size = int(page_size)
        self.max_new_tokens = int(max_new_tokens)
        self.n_slots = int(n_slots)
        self.kv_dtype = validate_kv_dtype(kv_dtype)
        self.capacity = quantize(max_seq_bucket + max_new_tokens,
                                 page_size)
        self.pages_per_slot = self.capacity // self.page_size
        self.pool_pages = (self.n_slots * self.pages_per_slot
                           if pool_pages is None else int(pool_pages))

    def bytes_per_slot(self, attention_specs) -> int:
        """This plan's per-slot device bytes (module `bytes_per_slot`)."""
        return bytes_per_slot(self.capacity, attention_specs,
                              self.kv_dtype, self.page_size)

    def make_pool(self) -> PagePool:
        return PagePool(self.pool_pages, self.page_size)

    def request_pages(self, prompt_bucket: int, max_new: int) -> int:
        """A request's worst-case reservation: its QUANTIZED prompt
        bucket plus output budget — the page-grid point, never the raw
        length, so accounting and shapes stay on the same lattice."""
        return pages_for(prompt_bucket + max_new, self.page_size)

    def describe(self) -> dict:
        return {"n_slots": self.n_slots, "capacity": self.capacity,
                "page_size": self.page_size,
                "pages_per_slot": self.pages_per_slot,
                "pool_pages": self.pool_pages,
                "max_new_tokens": self.max_new_tokens,
                "kv_dtype": self.kv_dtype}
