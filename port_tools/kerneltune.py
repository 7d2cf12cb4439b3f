#!/usr/bin/env python
"""kerneltune — the sweep on the card behind
deeplearning4j_tpu_torch/ops/tuning_table.json (JAX counterpart
tools/kerneltune.py, with the same flags, table schema and margin rule).

    python port_tools/kerneltune.py                  # default sweep -> table
    python port_tools/kerneltune.py --quick          # small shapes (smoke)
    python port_tools/kerneltune.py --dry-run        # configs, no card
    python port_tools/kerneltune.py --configs sample fused_layer_norm
    python port_tools/kerneltune.py --out /tmp/t.json --repeats 5

For every swept config the sweep times the DEFAULT launch parameters (the
heuristics', resolved with the table off) and every structurally valid
candidate through the real dispatch (`autotune.override` forces the
candidate into the kernel's wrapper), with CUDA events over repeated
calls (L2 warm). Before a variant is timed its output is held against the
kernel's plain version at the limits chip_smoke.py's phases use (2b for
K9, 9 for K11, 13 for K12, 2c for the chunked tier), and a bf16 variant
of K9, K11 or K12 must repeat bit for bit; a candidate that fails is
recorded as `role: "rejected"` and never chosen (a default that fails
stops the sweep). The written entry is the fastest candidate only when it
beats the default by `--margin` (3%); otherwise the default params are
recorded with both timings, so every entry matches or beats the
heuristics in this sweep's own measurement.

Every measurement emits a `kernel_tune` telemetry event when
`--telemetry` (or DL4J_TPU_TELEMETRY) names a log. The table's
provenance names the card and its power limit as nvidia-smi reports
them; the table applies only on a card of that name (ops/autotune.py).

The sweep needs a CUDA device and exits with code 2 without one;
`--dry-run` lists the configs and candidates without a card. It imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEFAULT_MARGIN = 0.03
DEFAULT_REPEATS = 5
SEED = 0

# the limits of chip_smoke.py: phase 2b (K9's bf16 gradients, of their
# largest entry), 9 (K11's bf16 dx/dgamma/dbeta), 2c (the chunked tier in
# bf16), 13 (K12: ids exact without top-p, at most this share of rows
# apart with it; top-k thresholds bit for bit)
XENT_TOL = 2e-2
LN_TOL = 2e-2
CHUNK_TOL = 2e-2
SAMPLE_TOP_P_MAX_RATE = 1e-3
# rows K12's top-p rate is counted over (phase 13's largest shape)
SAMPLE_RATE_ROWS = 1024
DROP_RATE = 0.1
# query rows a block of the chunked tier's plain version
CHUNK_ROWS = 1024
# clock cycles a second `torch.cuda._sleep` is sized with (at or above
# an H100's SM clock, so a sleep lasts at least the time asked)
SLEEP_HZ = 2.0e9


# ------------------------------------------------------------- sweep plan

def sweep_configs(quick: bool) -> list[dict]:
    """The default config list: the main path's shapes (quick mode
    shrinks them so a smoke run finishes in seconds)."""
    if quick:
        return [
            dict(family="softmax_xent", V=4096, d=256, rows=(1024,)),
            dict(family="fused_layer_norm", N=2048, C=256),
            dict(family="sample", B=4, V=2048, top_k=8, top_p=0.9),
            dict(family="flash_chunk", B=1, H=2, T=2048, D=128,
                 causal=True, dropout=False, masked=False),
        ]
    return [
        # the flagship's head (N = 32 x 512 tokens) and a pipeline
        # microbatch's (N = 4 x 512); one key (V, d)
        dict(family="softmax_xent", V=10000, d=256, rows=(16384, 2048)),
        dict(family="fused_layer_norm", N=16384, C=256),
        # the flagship's slots x vocab, the replay's microbench block
        dict(family="sample", B=4, V=10000, top_k=8, top_p=0.9),
        dict(family="sample", B=8, V=128, top_k=8, top_p=0.9),
        # the long modes' chunked tier (bench modes longcontext_chunked
        # and longcontext_chunked_dropout: batch 8, 2 heads of 128)
        dict(family="flash_chunk", B=8, H=2, T=32768, D=128, causal=True,
             dropout=False, masked=False),
        dict(family="flash_chunk", B=8, H=2, T=32768, D=128, causal=True,
             dropout=True, masked=True),
    ]


def config_key(cfg: dict) -> str:
    from deeplearning4j_tpu_torch.ops import autotune
    fam = cfg["family"]
    if fam == "softmax_xent":
        return autotune.config_key(fam, cfg["V"], cfg["d"])
    if fam == "fused_layer_norm":
        return autotune.config_key(fam, cfg["N"], cfg["C"])
    if fam == "sample":
        return autotune.config_key(fam, cfg["B"], cfg["V"])
    if fam == "flash_chunk":
        return autotune.config_key(fam, cfg["T"], cfg["D"],
                                   causal=cfg["causal"],
                                   dropout=cfg["dropout"],
                                   masked=cfg["masked"])
    raise KeyError(fam)


@contextlib.contextmanager
def _tuning_off():
    """A context in which the table is off (DL4J_TPU_TUNING=off)."""
    from deeplearning4j_tpu_torch.ops import autotune

    prev = os.environ.get(autotune.ENV_TUNING)
    os.environ[autotune.ENV_TUNING] = "off"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(autotune.ENV_TUNING, None)
        else:
            os.environ[autotune.ENV_TUNING] = prev


def default_params(cfg: dict, on_card: bool = True) -> list[dict]:
    """What the heuristics launch for this config, one params dict a row
    count (softmax_xent) or one in all, with the table off. K9's slices
    come from the C heuristic on the card; off it (`on_card` False, the
    dry run) they are unknown (None)."""
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    fam = cfg["family"]
    with _tuning_off():
        if fam == "softmax_xent":
            return [{"slices": fsx.dw_slices(N, cfg["d"], cfg["V"])
                     if on_card else None} for N in cfg["rows"]]
        if fam == "fused_layer_norm":
            return [{"blocks": fln.bwd_blocks(cfg["N"], cfg["C"])}]
        if fam == "sample":
            t, c = fsm._plan(cfg["B"], cfg["V"])
            return [{"threads": t, "cluster": c}]
        if fam == "flash_chunk":
            return [{"chunk": fa.pick_chunk(cfg["T"], cfg["causal"],
                                            head_dim=cfg["D"])}]
    raise KeyError(fam)


def candidates(cfg: dict, default: list[dict]) -> list[dict]:
    """Structurally valid params for one config, the default's excluded
    (timed separately)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import fused_layernorm as fln
    from deeplearning4j_tpu_torch.ops import fused_sampling as fsm
    from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

    fam = cfg["family"]
    outs: list[dict] = []
    if fam == "softmax_xent":
        most = max(-(-N // fsx.DW_ROW_BLOCK) for N in cfg["rows"])
        outs = [{"slices": s} for s in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16,
                                        24, 32) if s <= most]
    elif fam == "fused_layer_norm":
        most = -(-cfg["N"] // fln.BWD_WARPS)
        outs = [{"blocks": b} for b in (66, 132, 198, 264, 396, 528, 792,
                                        1056) if b <= most]
    elif fam == "sample":
        outs = [{"threads": t, "cluster": c} for t in fsm.PLAN_THREADS
                for c in range(1, fsm.MAX_CLUSTER + 1) if c <= cfg["V"]]
    elif fam == "flash_chunk":
        outs = [{"chunk": c} for c in fa.CHUNK_TILES
                if fa._chunk_fits(c, cfg["T"], cfg["D"], cfg["causal"])]
    else:
        raise KeyError(fam)
    return [c for c in outs if c not in default]


# ---------------------------------------------------------------- inputs

def _errs(x, ref):
    """max |x - ref| over max |ref|."""
    ref = ref.float()
    return float((x.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


def _same(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _plain_chunked(torch, fa, q, k, v, mask, drop, do):
    """Causal attention over [BH, T, D] and its gradients for `do`,
    written out in CHUNK_ROWS-row query blocks with f32 math at the
    kernels' rounding points (chip_smoke.py phase 2c's plain version).
    mask: [BH, T] or None; drop: a `_Drop` (origin 0) or None."""
    BH, T, D = q.shape
    scale = D ** -0.5
    dev = q.device
    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk = torch.zeros(BH, T, D, device=dev)
    dv = torch.zeros(BH, T, D, device=dev)
    bh = torch.arange(BH, device=dev)
    for r0 in range(0, T, CHUNK_ROWS):
        r1 = r0 + CHUNK_ROWS
        qi, gi = q[:, r0:r1].float(), do[:, r0:r1].float()
        kk, vv = k[:, :r1].float(), v[:, :r1].float()
        s = scale * (qi @ kk.transpose(-1, -2))
        vis = (torch.arange(r1, device=dev)[None, :]
               <= torch.arange(r0, r1, device=dev)[:, None])[None]
        if mask is not None:
            vis = vis & (mask[:, None, :r1] > 0)
        s = s.masked_fill(~vis, fa.NEG_INF)
        m = s.amax(-1)
        if mask is not None:
            m = m.clamp_min(-1e20)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1).clamp_min(1e-30)
        ks = (torch.ones_like(p) if drop is None else
              fa._keep_mask(drop.seed, bh, r0, 0, CHUNK_ROWS, r1, T,
                            drop.rate).float() * fa.keep_scale(drop.rate))
        oi = ((p * ks).to(q.dtype).float() @ vv) / l[..., None]
        o[:, r0:r1] = oi.to(q.dtype)
        lse = m + torch.log(l)
        p = torch.exp(s - lse[..., None])
        delta = (gi * o[:, r0:r1].float()).sum(-1)
        dp = (gi @ vv.transpose(-1, -2)) * ks
        ds = p * (dp - delta[..., None]) * scale
        dsr = ds.to(q.dtype).float()
        dq[:, r0:r1] = (dsr @ kk).to(q.dtype)
        dk[:, :r1] += dsr.transpose(-1, -2) @ qi
        dv[:, :r1] += (p * ks).to(q.dtype).float().transpose(-1, -2) @ gi
        del s, p, ks, dp, ds, dsr
    return o, dq, dk.to(q.dtype), dv.to(q.dtype)


class Case:
    """One config's inputs on the card, its plain version's outputs, a
    check of a variant's outputs against them and the call the sweep
    times (`run(row)`; `rows` of them for softmax_xent, one otherwise)."""

    def __init__(self, torch, cfg):
        self.torch, self.cfg = torch, cfg
        self.dev = torch.device("cuda")
        gen = torch.Generator(device="cpu").manual_seed(SEED)
        getattr(self, "_setup_" + cfg["family"])(gen)

    # -- K9's dW/db
    def _setup_softmax_xent(self, gen):
        from deeplearning4j_tpu_torch.ops import fused_softmax_xent as fsx

        torch, cfg, dev = self.torch, self.cfg, self.dev
        d, V = cfg["d"], cfg["V"]
        self.rows = []
        for N in cfg["rows"]:
            x = torch.randn(N, d, generator=gen).to(dev, torch.bfloat16)
            w = (0.05 * torch.randn(d, V, generator=gen)).to(
                dev, torch.bfloat16)
            b = (0.01 * torch.randn(V, generator=gen)).to(
                dev, torch.bfloat16)
            labels = torch.randint(0, V, (N,), generator=gen).to(
                dev, torch.int32)
            g = (torch.rand(N, generator=gen) / N).to(dev)
            _, lse = fsx._xent_fwd_reference(x, w, b, labels)
            _, rdw, rdb = fsx._xent_bwd_reference(x, w, b, labels, lse, g)
            args = (x, w, b, labels, lse, g)
            self.rows.append(dict(
                label=f"N={N}", args=args, refs=(rdw, rdb),
                run=lambda a=args: fsx._xent_dwdb(*a)))

    def _check_softmax_xent(self, row):
        outs = [row["run"]() for _ in range(2)]
        self.torch.cuda.synchronize()
        err = max(_errs(o, r) for o, r in zip(outs[0], row["refs"]))
        same = _same(self.torch, outs[0], outs[1])
        return (err <= XENT_TOL and same,
                f"dW/db rel err {err:.3e} (tol {XENT_TOL}), two runs "
                f"{'equal' if same else 'DIFFER'}")

    # -- K11
    def _setup_fused_layer_norm(self, gen):
        from deeplearning4j_tpu_torch.ops import fused_layernorm as fln

        torch, cfg, dev = self.torch, self.cfg, self.dev
        N, C = cfg["N"], cfg["C"]
        dt = torch.bfloat16
        x = (1.5 * torch.randn(N, C, generator=gen) + 0.3).to(dev, dt)
        g = (1 + 0.2 * torch.randn(C, generator=gen)).to(dev, dt)
        b = (0.1 * torch.randn(C, generator=gen)).to(dev, dt)
        dy = torch.randn(N, C, generator=gen).to(dev, dt)
        _, mu, rstd = fln._ln_fwd_reference(x, g, b, 1e-5)
        refs = fln._ln_bwd_reference(x, g, mu, rstd, dy)
        args = (x, g, mu, rstd, dy)
        self.rows = [dict(label=f"N={N} C={C} bf16", args=args, refs=refs,
                          run=lambda: fln._ln_bwd(*args))]

    def _check_fused_layer_norm(self, row):
        outs = [row["run"]() for _ in range(2)]
        self.torch.cuda.synchronize()
        err = max(_errs(o, r) for o, r in zip(outs[0], row["refs"]))
        same = _same(self.torch, outs[0], outs[1])
        return (err <= LN_TOL and same,
                f"dx/dgamma/dbeta rel err {err:.3e} (tol {LN_TOL}), two "
                f"runs {'equal' if same else 'DIFFER'}")

    # -- K12
    def _setup_sample(self, gen):
        from deeplearning4j_tpu_torch.ops import fused_sampling as fsm

        torch, cfg, dev = self.torch, self.cfg, self.dev
        B, V = cfg["B"], cfg["V"]
        cgen = torch.Generator(device="cuda").manual_seed(SEED)
        mode = dict(temperature=1.0, top_k=cfg["top_k"], top_p=cfg["top_p"])
        self.mode = mode
        self.inputs = []
        for rows in (B, SAMPLE_RATE_ROWS):
            logits = 3.0 * torch.randn(rows, V, generator=cgen, device=dev)
            noise = fsm.gumbel_noise(cgen, rows, V, dev)
            self.inputs.append((logits, noise))
        logits, noise = self.inputs[0]
        self.rows = [dict(label=f"[{B},{V}] f32 T=1.0 top_k={cfg['top_k']}"
                          f" top_p={cfg['top_p']}",
                          run=lambda: fsm.fused_sample(logits, noise,
                                                       **mode))]

    def _check_sample(self, row):
        """Phase 13's gates on the variant: in every mode (the sweep's,
        top-k alone, temperature alone) at the config's rows and 1024
        more, f32 and bf16 logits: ids equal the plain version's without
        top-p, at most SAMPLE_TOP_P_MAX_RATE of the rows apart with it,
        top-k thresholds bit for bit, two runs equal."""
        from deeplearning4j_tpu_torch.ops import fused_sampling as fsm

        torch = self.torch
        modes = (self.mode, dict(temperature=0.8, top_k=self.mode["top_k"]),
                 dict(temperature=1.0))
        off, total, ok = 0, 0, True
        for logits32, noise in self.inputs:
            for dtype in (torch.float32, torch.bfloat16):
                logits = logits32.to(dtype)
                for mode in modes:
                    k, p = fsm._modes(logits, mode.get("top_k", 0),
                                      mode.get("top_p", 1.0))
                    got = fsm.fused_sample(logits, noise, **mode)
                    again, thr = fsm._launch(logits, noise,
                                             mode["temperature"], k, p,
                                             thresholds=True)
                    ref = fsm._select_reference(logits, noise, **mode)
                    ref_k, _ = fsm._thresholds_reference(
                        logits, mode["temperature"], k, p)
                    diff = int((got != ref).sum())
                    ok = (ok and torch.equal(got, again)
                          and torch.equal(thr[:, 0], ref_k))
                    if "top_p" in mode:
                        off, total = off + diff, total + logits.shape[0]
                    else:
                        ok = ok and diff == 0
        rate = off / max(total, 1)
        ok = ok and rate <= SAMPLE_TOP_P_MAX_RATE
        return ok, (f"ids exact without top-p, {off} of {total} top-p rows "
                    f"apart (most {SAMPLE_TOP_P_MAX_RATE}), thresholds and "
                    f"repeats {'equal' if ok else 'checked'}")

    # -- K1/K5 on the chunked tier's tiles
    def _setup_flash_chunk(self, gen):
        from deeplearning4j_tpu_torch.ops import flash_attention as fa

        torch, cfg, dev = self.torch, self.cfg, self.dev
        B, H, T, D = cfg["B"], cfg["H"], cfg["T"], cfg["D"]
        dt = torch.bfloat16
        q, k, v, do = (torch.randn(B, H, T, D, generator=gen).to(dev, dt)
                       for _ in range(4))
        mask = None
        if cfg["masked"]:
            mask = torch.ones(B, T, device=dev)
            mask[:, T - T // 5:] = 0  # the last fifth of the keys padded
        rate = DROP_RATE if cfg["dropout"] else 0.0
        seed = fa._step_seed(torch.Generator(device=dev).manual_seed(SEED))
        drop = fa._Drop(seed, rate, 0, 0, T) if rate else None
        flat = [t.reshape(B * H, T, D) for t in (q, k, v, do)]
        self.refs = _plain_chunked(
            torch, fa, *flat[:3],
            None if mask is None else mask.repeat_interleave(H, 0), drop,
            flat[3])
        torch.cuda.empty_cache()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def run():
            for t in leaves:
                t.grad = None
            gen_d = torch.Generator(device=dev).manual_seed(SEED)
            out = fa.chunked_flash_attention(
                *leaves, causal=cfg["causal"], mask=mask, dropout=rate,
                generator=gen_d)
            out.backward(do)
            return [out.detach()] + [t.grad for t in leaves]

        self.rows = [dict(label=f"B={B} H={H} T={T} D={D} bf16 causal "
                                f"dropout={rate} masked={cfg['masked']}",
                          run=run)]

    def _check_flash_chunk(self, row, params):
        from deeplearning4j_tpu_torch.ops import flash_attention as fa

        torch, cfg = self.torch, self.cfg
        before = dict(fa.LAUNCHES)
        outs = row["run"]()
        torch.cuda.synchronize()
        n = cfg["T"] // (params["chunk"] if params else fa.resolve_chunk(
            cfg["T"], cfg["D"], cfg["causal"], cfg["dropout"],
            cfg["masked"]))
        want = n * (n + 1) // 2
        # a tile pair's backward is the split K5, or the single-block K4
        # at tiles of BLOCK_Q_MAX rows or fewer
        launched = (fa.LAUNCHES["K1"] - before["K1"],
                    fa.LAUNCHES["K4"] + fa.LAUNCHES["K5"] - before["K4"]
                    - before["K5"])
        err = max(_errs(g.reshape(r.shape), r)
                  for g, r in zip(outs, self.refs))
        ok = err <= CHUNK_TOL and launched == (want, want)
        return ok, (f"o/dq/dk/dv rel err {err:.3e} (tol {CHUNK_TOL}), K1 "
                    f"and K4 + K5 launched {launched} (want {want} each)")

    def check(self, row, params):
        if self.cfg["family"] == "flash_chunk":
            return self._check_flash_chunk(row, params)
        return getattr(self, "_check_" + self.cfg["family"])(row)


def time_us(torch, fn, repeats):
    """Microseconds a call on the card: CUDA events around a window of
    calls, after a warm-up (L2 warm), the least of `repeats` windows'
    means. Each window is queued behind a `torch.cuda._sleep` long enough
    for the host to enqueue all of it, so the events time the kernels
    back to back and not the host's launch path (at tens of
    microseconds a launch the two are alike)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    per_window = max(1, min(50, int(0.02 / max(one, 1e-6))))
    cycles = int((2 * per_window * one + 1e-3) * SLEEP_HZ)
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(per_window):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e3 / per_window)
    return best


# ----------------------------------------------------------------- sweep

def _override(cfg, params):
    """Force `params` through the tuning layer; None forces nothing (the
    table, where one applies, or the heuristic)."""
    from deeplearning4j_tpu_torch.ops import autotune
    if params is None:
        return contextlib.nullcontext()
    return autotune.override({cfg["family"]: params})


def measure(torch, case, params_by_row, repeats):
    """Check then time one variant (`params_by_row`: one params dict a
    row, or None for what the dispatch resolves by itself). -> (ok, [us
    a row], [report a row])."""
    times, notes = [], []
    if params_by_row is None:
        params_by_row = [None] * len(case.rows)
    for row, params in zip(case.rows, params_by_row):
        with _override(case.cfg, params):
            ok, note = case.check(row, params)
            notes.append(f"{row['label']}: {note}")
            if not ok:
                return False, None, notes
            times.append(time_us(torch, row["run"], repeats))
    return True, times, notes


def sweep(torch, configs: list[dict], repeats: int, margin: float,
          recorder) -> dict:
    """Check and time the default and each candidate per config ->
    {key: entry}. The provenance is the `kernel_tune` events alone, as
    in the JAX sweep: each config's `chosen` event carries the config's
    wall seconds (`wall_seconds`)."""
    entries: dict[str, dict] = {}
    for cfg in configs:
        entries.update(_sweep_one(torch, cfg, repeats, margin, recorder))
    return entries


def _sweep_one(torch, cfg, repeats, margin, recorder) -> dict:
    """One config of `sweep` -> {key: entry}."""
    t_wall = time.perf_counter()
    key = config_key(cfg)
    fam = cfg["family"]
    case = Case(torch, cfg)
    dflt = default_params(cfg)
    ok, t_dflt, notes = measure(torch, case, dflt, repeats)
    print(f"{key}: default {dflt}: {'; '.join(notes)}", flush=True)
    if not ok:
        raise RuntimeError(f"{key}: the default params {dflt} fail "
                           f"their plain-version check: {notes}")
    recorder.kernel_tune(fam, key, dflt[0], seconds=sum(t_dflt) * 1e-6,
                         role="default", rows_us=t_dflt)
    best, t_best, n_cand = dflt[0], t_dflt, 0
    for cand in candidates(cfg, dflt):
        ok, t, notes = measure(torch, case, [cand] * len(case.rows),
                               repeats)
        if not ok:
            recorder.kernel_tune(fam, key, cand, role="rejected",
                                 reason="; ".join(notes))
            print(f"{key}: candidate {cand} REJECTED: "
                  f"{'; '.join(notes)}", flush=True)
            continue
        n_cand += 1
        recorder.kernel_tune(fam, key, cand, seconds=sum(t) * 1e-6,
                             role="candidate", rows_us=t)
        print(f"{key}: candidate {cand}: "
              f"{', '.join(f'{x:.3f}' for x in t)} us "
              f"(default {', '.join(f'{x:.3f}' for x in t_dflt)})",
              flush=True)
        if sum(t) < sum(t_best):
            best, t_best = cand, t
    # the margin rule: only a decisive win displaces the default
    if best is not dflt[0] and sum(t_best) >= sum(t_dflt) * (1 - margin):
        best, t_best = dflt[0], t_dflt
    entry = dict(best)
    entry["best_us"] = round(sum(t_best), 3)
    entry["default_us"] = round(sum(t_dflt), 3)
    entry["candidates"] = n_cand
    entry["source"] = "; ".join(
        f"{row['label']}: best {tb:.3f} us, default {td:.3f} us"
        for row, tb, td in zip(case.rows, t_best, t_dflt))
    recorder.kernel_tune(fam, key, best, seconds=sum(t_best) * 1e-6,
                         role="chosen",
                         default_seconds=round(sum(t_dflt) * 1e-6, 9),
                         wall_seconds=round(time.perf_counter() - t_wall, 6))
    won = "tuned" if best != dflt[0] else "default"
    print(f"{key}: {won} {best} best={sum(t_best):.3f}us "
          f"default={sum(t_dflt):.3f}us ({n_cand} candidates timed)",
          flush=True)
    del case
    torch.cuda.empty_cache()
    return {key: entry}


def nvidia_smi_name_power() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def provenance(torch, repeats: int, margin: float, quick: bool) -> dict:
    return {
        "tool": "port_tools/kerneltune.py",
        "date": time.strftime("%Y-%m-%d"),
        "device_kind": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_name_power(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "repeats": repeats,
        "margin": margin,
        "quick": quick,
        "timing": "CUDA events, L2 warm, least of the repeats' means",
    }


def audit(table: dict, events: list[dict]) -> list[str]:
    """What is wrong with a sweep's table beside its telemetry (the
    events of its `--telemetry` file) -> problems, none when the table is
    valid, each entry has exactly one `chosen` event with its wall
    seconds, its params are the default's or a candidate's that passed
    its plain-version check (never a rejected one), its candidate count
    is that of its `candidate` events, no `chosen` event names a key the
    table lacks, and every span name is a registered one."""
    from deeplearning4j_tpu_torch.ops import autotune
    from deeplearning4j_tpu_torch.telemetry.recorder import SPAN_NAMES

    bad = autotune.validate_table(table)
    tunes = [e for e in events if e.get("event") == "kernel_tune"]
    for key, entry in table["entries"].items():
        params = {k: v for k, v in entry.items()
                  if k not in autotune.ENTRY_META_FIELDS}
        evs = [e for e in tunes if e["key"] == key]
        passed = [e["params"] for e in evs
                  if e["role"] in ("default", "candidate")]
        rejected = [e["params"] for e in evs if e["role"] == "rejected"]
        chosen = [e for e in evs if e["role"] == "chosen"]
        timed = sum(e["role"] == "candidate" for e in evs)
        if ([e["params"] for e in chosen] != [params]
                or params not in passed or params in rejected
                or timed != entry["candidates"]):
            bad.append(f"{key}: chosen {[e['params'] for e in chosen]}, "
                       f"entry {params}, passed {passed}, rejected "
                       f"{rejected}, {timed} timed")
        elif not isinstance(chosen[0].get("wall_seconds"), (int, float)):
            bad.append(f"{key}: the chosen event has no wall_seconds")
    stray = sorted({e["key"] for e in tunes if e["role"] == "chosen"}
                   - set(table["entries"]))
    if stray:
        bad.append(f"chosen events for keys the table lacks: {stray}")
    names = sorted({e.get("name") for e in events if e.get("event") == "span"}
                   - SPAN_NAMES)
    if names:
        bad.append(f"unregistered span names: {names}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kerneltune", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None,
                    help="table path (default: the checked-in "
                         "deeplearning4j_tpu_torch/ops/tuning_table.json)")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes: a smoke run in seconds")
    ap.add_argument("--repeats", type=int, default=DEFAULT_REPEATS)
    ap.add_argument("--margin", type=float, default=DEFAULT_MARGIN,
                    help="relative win a candidate needs to displace the "
                         f"default (default {DEFAULT_MARGIN})")
    ap.add_argument("--configs", nargs="*", default=None,
                    help="restrict to these kernel families")
    ap.add_argument("--dry-run", action="store_true",
                    help="list configs and candidates; no card needed")
    ap.add_argument("--telemetry", default=None,
                    help="telemetry JSONL path (else DL4J_TPU_TELEMETRY)")
    args = ap.parse_args(argv)

    import torch

    from deeplearning4j_tpu_torch.ops import autotune

    configs = sweep_configs(args.quick)
    if args.configs:
        configs = [c for c in configs if c["family"] in args.configs]
        if not configs:
            print(f"kerneltune: no configs match {args.configs}",
                  file=sys.stderr)
            return 2
    if args.dry_run:
        for cfg in configs:
            dflt = default_params(cfg, on_card=torch.cuda.is_available())
            cands = candidates(cfg, dflt)
            shown = ("the C heuristic dw_slices on the card"
                     if dflt[0].get("slices", 0) is None else dflt)
            print(f"{config_key(cfg)}: default {shown}, {len(cands)} "
                  f"candidates {cands}")
        return 0
    if not torch.cuda.is_available():
        print("kerneltune: no CUDA device; the sweep times kernels on the "
              "card (use --dry-run to list the configs)", file=sys.stderr)
        return 2

    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.telemetry.recorder import (Recorder,
                                                             get_default)
    t0 = time.perf_counter()
    built = cuda_build.build()  # every kernel source, one nvcc each
    print(f"kerneltune: built {sorted(built) or 'nothing new'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rec = Recorder(args.telemetry) if args.telemetry else get_default()
    rec.meta(role="kerneltune", quick=args.quick, repeats=args.repeats)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"kerneltune: {nvidia_smi_name_power()}; torch {torch.__version__}"
          f", CUDA {torch.version.cuda}", flush=True)
    entries = sweep(torch, configs, args.repeats, args.margin, rec)

    out_path = args.out or autotune.TABLE_PATH
    table = {"version": autotune.SCHEMA_VERSION,
             "provenance": provenance(torch, args.repeats, args.margin,
                                      args.quick),
             "entries": entries}
    problems = autotune.validate_table(table)
    if problems:
        print("kerneltune: refusing to write an invalid table:\n  "
              + "\n  ".join(problems), file=sys.stderr)
        return 2
    tmp = out_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, out_path)
    print(f"wrote {len(table['entries'])} entries -> {out_path}", flush=True)
    rec.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
