"""Kernel autotuning — the launch parameters of the hand-written kernels
as data (JAX counterpart deeplearning4j_tpu/ops/autotune.py, with the
same key strings, table schema and resolution order).

`port_tools/kerneltune.py` is the sweep on the card that fills the
table; this module is where the kernels' wrappers read it.

Resolution order for a kernel's launch parameters:

1. an active `override(...)` context (tests and the kerneltune sweep
   force candidate variants through the real dispatch);
2. a checked-in tuning-table entry (`ops/tuning_table.json`) keyed on
   ``(kernel, T, D, causal, dropout, masked)``, applied only on CUDA and
   only when the table's ``provenance.device_kind`` equals
   `torch.cuda.get_device_name()` (or under ``DL4J_TPU_TUNING=force``);
   ``DL4J_TPU_TUNING=off`` turns the table off;
3. the heuristics the wrappers launch without a table, unchanged, so
   on the CPU, with the table off or on another card every launch is
   what it was before the table existed (bit for bit).

A resolved value is checked against its kernel's structural limits
before use. An entry that fails them falls back to the heuristic, with
a warning and a `kernel_tune` event of ``role: "rejected"`` (once per
key and params in a process); it never reaches a launch.

The families are the port's own: only knobs that the port's launches
take at run time.

* ``flash_chunk`` takes ``chunk``, the tile length of the chunked
  long-context tier (K1/K5 on tiles), keyed on (T, head_dim, causal,
  dropout, masked). A tile must be in `CHUNK_TILES`, within
  `max_tile_for_dim` and divide T into 2 or more tiles within the loop's
  budget (`MAX_CHUNK_PAIRS` causal pairs; the caller's `fits`).
* ``softmax_xent`` takes ``slices``: the slices of N that K9's bf16
  dW/db kernel sums in a fixed order (csrc/softmax_xent.cu `dw_slices`),
  keyed on (V, d) as in JAX. The entry is a TARGET clamped to the row
  blocks of the call (ceil(N / 64)), so a row count the sweep never saw
  still gets a legal value, and the wrapper sizes its workspace from the
  resolved count; the C entry refuses a count outside 1 to the row
  blocks.
* ``fused_layer_norm`` takes ``blocks``: the grid of K11's vector
  backward, one dgamma/dbeta partial a block, keyed on (N, C); at least
  1 and at most ceil(N / BWD_WARPS). The general path's partials
  (PARTIAL_ROWS rows each) are structural and not tuned.
* ``sample`` takes ``threads`` and ``cluster``: K12's (threads a block,
  blocks in a row's cluster), keyed on (B, V); threads in
  `PLAN_THREADS` (the kernel's instantiations), cluster from 1 to
  `MAX_CLUSTER` (8, the portable cluster size: csrc/sampling.cu does
  not set the non-portable attribute) and at most V.

The JAX families with no runtime knob in the port have no resolution
function here, and `validate_table` rejects their keys
(`JAX_ONLY_FAMILIES`): ``flash_fwd``/``flash_bwd`` (JAX `flash_blocks`,
`flash_g`) and the packed ``flash_*_qkv*`` families (G-batching): the
CUDA flash kernels fix their 64-row tiles at compile time and launch one
program a (b, h) with no G-batching; ``decode_attn`` and
``decode_attn_q8`` (`decode_block`, `decode_block_q8`): the port's
decode attention is plain PyTorch; ``neg_softmax`` (`neg_softmax_rows`):
K13's warps a block are a compile-time constant (csrc/neg_softmax.cu
WARPS). JAX's ``fused_layer_norm`` ``rows`` (`ln_rows`), ``sample``
``rows`` and ``softmax_xent`` ``block_n``/``block_v`` are VMEM row and
vocab blocks of the TPU kernels with no counterpart either: their
params are "not tunable" here.

Timings in entries are provenance, not configuration: the resolution
functions read only the param fields.

Stdlib at module level; torch is imported at the first unforced
lookup (`_device_matches`).
"""

from __future__ import annotations

import json
import os
import threading
import warnings

LANES = 128

# Chunk-tile lengths of the long-context loop, largest first. The
# backward streams full-tile K/V (resp. Q/dO) pairs, so the tile length
# shrinks as the head dim grows past 128: tile * max(D, 128) <=
# TILE_ELEM_BUDGET (8192 x 128), the JAX package's envelope, kept so
# that both packages route the same shapes.
CHUNK_TILES = (8192, 4096, 2048, 1024, 512)
TILE_ELEM_BUDGET = CHUNK_TILES[0] * LANES

ENV_TUNING = "DL4J_TPU_TUNING"  # "force" | "off" | unset (CUDA only)

SCHEMA_VERSION = 1

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tuning_table.json")

# Params each kernel family may tune; validation rejects anything else.
KERNEL_PARAMS = {
    "flash_chunk": ("chunk",),
    "softmax_xent": ("slices",),
    "fused_layer_norm": ("blocks",),
    "sample": ("threads", "cluster"),
}

# The JAX package's families whose knob has no counterpart in the port's
# launches (see the module docstring), and why.
JAX_ONLY_FAMILIES = {
    "flash_fwd": "the CUDA flash kernels' tiles are fixed at compile time",
    "flash_bwd": "the CUDA flash kernels' tiles are fixed at compile time",
    "flash_fwd_qkv": "the CUDA kernels launch one program a (b, h)",
    "flash_bwd_qkv": "the CUDA kernels launch one program a (b, h)",
    "flash_fwd_qkv_pair": "the CUDA kernels launch one program a (b, h)",
    "flash_bwd_qkv_pair": "the CUDA kernels launch one program a (b, h)",
    "decode_attn": "the port's decode attention is plain PyTorch",
    "decode_attn_q8": "the port's decode attention is plain PyTorch",
    "neg_softmax": "K13's warps a block are a compile-time constant",
}

# Timing/provenance fields an entry may carry alongside its params.
ENTRY_META_FIELDS = ("best_us", "default_us", "candidates", "source")


def pick_block(n: int, cap: int, base: int = LANES) -> int:
    """Largest power-of-two multiple of `base` dividing n up to cap (n %
    base == 0 assumed): the JAX package's shared divisor search under its
    name. No launch of the port takes a divisor block."""
    b = base
    while b * 2 <= cap and n % (b * 2) == 0:
        b *= 2
    return min(b, n)


def config_key(kernel: str, T: int, D: int, *, causal: bool = False,
               dropout: bool = False, masked: bool = False) -> str:
    """The table key: kernel|T|D|causal|dropout|masked. T and D are the
    kernel's own dims (flash_chunk: sequence x head_dim;
    fused_layer_norm: rows x feature dim; softmax_xent: vocab x feature
    dim; sample: batch x vocab)."""
    return (f"{kernel}|T{int(T)}|D{int(D)}|c{int(bool(causal))}"
            f"|d{int(bool(dropout))}|m{int(bool(masked))}")


def parse_key(key: str) -> dict:
    """Inverse of config_key. Raises ValueError on a malformed key."""
    parts = key.split("|")
    if len(parts) != 6:
        raise ValueError(f"malformed tuning key {key!r}")
    kernel, t, d, c, dr, m = parts
    if not (t[:1] == "T" and d[:1] == "D" and c[:1] == "c"
            and dr[:1] == "d" and m[:1] == "m"):
        raise ValueError(f"malformed tuning key {key!r}")
    return {"kernel": kernel, "T": int(t[1:]), "D": int(d[1:]),
            "causal": bool(int(c[1:])), "dropout": bool(int(dr[1:])),
            "masked": bool(int(m[1:]))}


def validate_table(table) -> list[str]:
    """Schema check -> list of problems (empty = valid). Used by the
    loader (a broken checked-in table fails loudly at load), kerneltune
    before writing, and the tests."""
    problems = []
    if not isinstance(table, dict):
        return ["table is not a JSON object"]
    if table.get("version") != SCHEMA_VERSION:
        problems.append(f"version {table.get('version')!r} != "
                        f"{SCHEMA_VERSION}")
    entries = table.get("entries")
    if not isinstance(entries, dict):
        return problems + ["missing 'entries' object"]
    for key, entry in entries.items():
        try:
            cfg = parse_key(key)
        except ValueError as exc:
            problems.append(str(exc))
            continue
        if cfg["kernel"] in JAX_ONLY_FAMILIES:
            problems.append(f"{key}: {cfg['kernel']!r} has no launch knob "
                            "in the port ("
                            f"{JAX_ONLY_FAMILIES[cfg['kernel']]})")
            continue
        allowed = KERNEL_PARAMS.get(cfg["kernel"])
        if allowed is None:
            problems.append(f"{key}: unknown kernel {cfg['kernel']!r}")
            continue
        if not isinstance(entry, dict):
            problems.append(f"{key}: entry is not an object")
            continue
        for field, value in entry.items():
            if field in ENTRY_META_FIELDS:
                continue
            if field not in allowed:
                problems.append(f"{key}: param {field!r} not tunable "
                                f"for {cfg['kernel']} (allowed: "
                                f"{list(allowed)})")
            elif (not isinstance(value, int) or isinstance(value, bool)
                  or value < 1):
                problems.append(f"{key}: param {field!r} must be a "
                                f"positive int, got {value!r}")
    return problems


# ------------------------------------------------------------ table state

_lock = threading.Lock()
_cache: dict = {"path": None, "table": None, "active": None}
_overrides: list[dict] = []  # innermost last; each {key -> params}
_rejected: set = set()


def load_table(path: str | None = None) -> dict:
    """Load (and cache) the tuning table. A missing file is an empty
    table (every lookup falls back); a malformed file raises at load."""
    path = path or TABLE_PATH
    with _lock:
        if _cache["path"] == path and _cache["table"] is not None:
            return _cache["table"]
        if not os.path.exists(path):
            table = {"version": SCHEMA_VERSION, "provenance": {},
                     "entries": {}}
        else:
            with open(path) as fh:
                table = json.load(fh)
            problems = validate_table(table)
            if problems:
                raise ValueError(
                    f"invalid tuning table {path}: " + "; ".join(problems))
        _cache["path"] = path
        _cache["table"] = table
        _cache["active"] = None
        return table


def reload_table(path: str | None = None) -> dict:
    """Drop the cache and re-read (kerneltune just rewrote the file)."""
    with _lock:
        _cache["path"] = None
        _cache["table"] = None
        _cache["active"] = None
    return load_table(path)


def _device_matches() -> bool:
    """Whether this process runs on the card the checked-in table was
    measured on (its provenance's device_kind); cached per load."""
    table = load_table()
    if _cache["active"] is None:
        import torch

        kind = table.get("provenance", {}).get("device_kind")
        _cache["active"] = bool(
            kind and torch.cuda.is_available()
            and torch.cuda.get_device_name() == kind)
    return _cache["active"]


def table_active() -> bool:
    """Whether table entries apply: on CUDA, on the card the table names.
    Off the card the answer is no (CPU runs stay bit-identical to the
    heuristics); DL4J_TPU_TUNING=force/off overrides for tests and
    debugging."""
    env = os.environ.get(ENV_TUNING, "").lower()
    if env in ("force", "1", "on"):
        return True
    if env in ("off", "0"):
        return False
    return _device_matches()


class override:
    """Context manager forcing explicit params for a kernel config: the
    hook kerneltune times candidates through and the tests pin variants
    with. Matches by exact config key, or by bare kernel name for every
    config of that kernel::

        with autotune.override({"sample": {"threads": 128, "cluster": 4}}):
            fused_sample(logits, noise, top_k=8)
    """

    def __init__(self, mapping: dict):
        self.mapping = dict(mapping)

    def __enter__(self):
        _overrides.append(self.mapping)
        return self

    def __exit__(self, *exc):
        _overrides.remove(self.mapping)
        return False


def lookup(kernel: str, T: int, D: int, *, causal: bool = False,
           dropout: bool = False, masked: bool = False) -> dict | None:
    """The raw entry for a config (override > table > None). Callers go
    through the typed resolution functions below, which validate."""
    key = config_key(kernel, T, D, causal=causal, dropout=dropout,
                     masked=masked)
    for mapping in reversed(_overrides):
        if key in mapping:
            return mapping[key]
        if kernel in mapping:
            return mapping[kernel]
    if not table_active():
        return None
    return load_table()["entries"].get(key)


def _reject(kernel: str, key: str, entry: dict, reason: str) -> None:
    """An entry that fails its kernel's limits: a warning and a
    `kernel_tune` event of role "rejected", once per key and params."""
    params = {k: v for k, v in entry.items() if k not in ENTRY_META_FIELDS}
    mark = (key, json.dumps(params, sort_keys=True))
    if mark in _rejected:
        return
    _rejected.add(mark)
    warnings.warn(f"tuning entry {key} {params} rejected ({reason}); "
                  "launching the heuristic's params", RuntimeWarning,
                  stacklevel=3)
    from deeplearning4j_tpu_torch.telemetry.recorder import get_default

    get_default().kernel_tune(kernel, key, params, role="rejected",
                              reason=reason)


def _int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


# ------------------------------------------------------------- resolution

def max_tile_for_dim(D: int | None) -> int:
    """Largest chunk tile for a head dim: the D-aware bound (tile *
    max(D, 128) <= TILE_ELEM_BUDGET). None means the caller has no
    head-dim information: the D <= 128 envelope."""
    if not D or D <= LANES:
        return CHUNK_TILES[0]
    for c in CHUNK_TILES:
        if c * D <= TILE_ELEM_BUDGET:
            return c
    return 0


def chunk_tile(T: int, D: int | None, *, causal: bool, dropout: bool,
               masked: bool, fits) -> int | None:
    """Tuned chunk length for the long-context loop, or None (the caller
    takes `pick_chunk`). `fits` is the caller's structural predicate
    (divisibility and the loop's budget), so the rule lives with the
    loop."""
    e = lookup("flash_chunk", T, D or 0, causal=causal, dropout=dropout,
               masked=masked)
    if not e:
        return None
    c = e.get("chunk")
    if (_int(c) and c in CHUNK_TILES and c <= max_tile_for_dim(D)
            and fits(c)):
        return c
    _reject("flash_chunk", config_key("flash_chunk", T, D or 0,
                                      causal=causal, dropout=dropout,
                                      masked=masked), e,
            f"chunk {c!r} is not a tile of {CHUNK_TILES} within the head "
            f"dim's {max_tile_for_dim(D)} that divides T={T} into 2+ "
            "tiles within the loop's budget")
    return None


def xent_slices(N: int, d: int, V: int, default: int,
                row_blocks: int) -> int:
    """Slices of N for K9's bf16 dW/db kernel: a tuned target clamped to
    the call's `row_blocks` (ceil(N / 64)), else `default` (the C
    heuristic `dw_slices`)."""
    e = lookup("softmax_xent", V, d)
    if not e:
        return default
    s = e.get("slices")
    if _int(s) and s >= 1:
        return min(s, row_blocks)
    _reject("softmax_xent", config_key("softmax_xent", V, d), e,
            f"slices {s!r} is not a positive int")
    return default


def ln_bwd_blocks(N: int, C: int, default: int, most: int) -> int:
    """Grid of K11's vector backward (one partial a block): a tuned
    count from 1 to `most` (ceil(N / BWD_WARPS): no block without a
    row), else `default`."""
    e = lookup("fused_layer_norm", N, C)
    if not e:
        return default
    b = e.get("blocks")
    if _int(b) and 1 <= b <= most:
        return b
    _reject("fused_layer_norm", config_key("fused_layer_norm", N, C), e,
            f"blocks {b!r} outside 1..{most}")
    return default


def sample_plan(B: int, V: int, default: tuple, threads: tuple,
                max_cluster: int) -> tuple:
    """K12's (threads a block, blocks in a row's cluster) for [B, V]
    logits: a tuned plan whose threads are an instantiation (`threads`)
    and whose cluster is from 1 to min(`max_cluster`, V), else
    `default`."""
    e = lookup("sample", B, V)
    if not e:
        return default
    t, c = e.get("threads"), e.get("cluster")
    if _int(t) and t in threads and _int(c) and 1 <= c <= min(max_cluster,
                                                               V):
        return t, c
    _reject("sample", config_key("sample", B, V), e,
            f"plan {(t, c)!r}: threads not in {threads} or cluster "
            f"outside 1..{min(max_cluster, V)}")
    return default
