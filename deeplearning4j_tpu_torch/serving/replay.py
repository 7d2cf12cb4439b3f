"""Traffic replay (JAX counterpart deeplearning4j_tpu/serving/replay.py):
the serving bench core behind the `serving_replay`, `serving_generate`,
`serving_speculative` and fleet rows. Every scoreboard is rebuilt from
the telemetry JSONL alone, and reads the JAX package's logs and the
port's alike: both recorders write the same fields.

The predict replay:

* `make_trace` — a SEEDED mixed-length, bursty request trace: every
  `burst`-th request opens a new exponential gap, the burst shares its
  instant, lengths draw from a weighted set. Same seed, same trace.
* `replay_http` — drives a running ServingServer's POST /predict at the
  trace's arrival offsets (a thread pool wider than the burst), checking
  only that each reply succeeded.
* `reconstruct` — p50/p99 latency from `request` events' `total_s`,
  sustained QPS from first enqueue to last completion, and the retrace
  count from non-warmup `compile` spans; `metric_lines` turns it into
  the bench rows.
* `run_replay` — the end-to-end run (bench mode `serving_replay`): the
  tiny LM or MLP, a warmed `InferenceEngine`, HTTP, drain, scoreboard.

The fleet replay: `run_fleet_replay` drives one seeded bursty trace
through two arms — a fixed single replica, and an autoscaling arm under
a `FleetSupervisor` that also absorbs a replica-kill chaos spec and a
mid-traffic weight hot-swap from a checkpoint it publishes (the port's
format, util/checkpoint.py). `reconstruct_fleet` adds `swap_ms`,
`respawn_ms`, the failed requests, the autoscale occupancy and the
weight generations seen in `request` events; `fleet_metric_lines` gives
the `fleet_*` rows.

The generation half:

* `make_generation_trace` — a SEEDED bursty trace with a prompt-length x
  output-length mix: same seed, same traffic.
* `replay_generate_http` — drives a running ServingServer over real HTTP
  at the trace's arrival offsets, reading each streamed /generate body;
  with `collect_tokens` it keeps every request's emitted tokens.
* `reconstruct_generation` — the scoreboard from the telemetry JSONL
  alone: tokens/sec, TTFT p50/p99, peak cache-page occupancy, retraces
  after warmup, decode-step medians and the speculative accounting
  (`accepted_tokens_per_step`, `draft_acceptance_rate`,
  `draft_overhead_us`). It reads the JAX package's logs and the port's
  alike: both recorders write the same fields.
* `run_generation_replay` and `run_speculative_replay` — the end-to-end
  runs. The speculative replay serves one trace through three arms,
  interleaved over `repeats` rounds — baseline (greedy, f32 cache),
  speculative (k-token verify windows) and quantized (int8 cache) —
  and counts the requests whose tokens differ from the baseline's first
  round (the two `*_parity_mismatches` rows, both 0 when greedy parity
  holds), plus `serving_sample_us` (the fused-sampling microbench, K12 on
  the card) and `serving_quantized_slots_per_hbm_byte_x` (the f32/int8
  bytes-per-slot ratio).

Entry points run on CUDA unless the caller passes `device="cpu"`.
Latency rows carry ``lower_is_better: true``.
"""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# the replay's HTTP concurrency must exceed the widest burst or the
# client itself serializes the burst and the queue-wait numbers lie
_CLIENT_WORKERS = 32


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[k])


def _events(telemetry_path: str):
    """Every JSON event of a telemetry file, skipping other lines."""
    with open(telemetry_path) as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw.startswith("{"):
                continue
            try:
                yield json.loads(raw)
            except json.JSONDecodeError:
                continue


# --------------------------------------------------------- predict replay

def make_trace(seed: int = 0, n_requests: int = 80, *,
               mean_gap_s: float = 0.002, burst: int = 4,
               lengths=(8, 16, 32), weights=None) -> list:
    """[(arrival_offset_s, seq_len), ...] sorted by offset. Bursty:
    every `burst`-th arrival opens a fresh exponential gap scaled by the
    burst width (keeping the MEAN rate at 1/mean_gap_s); the requests
    inside a burst land at the same instant — the pile-up the batcher's
    coalescing exists for."""
    rng = np.random.default_rng(seed)
    lengths = list(lengths)
    if weights is not None:
        weights = np.asarray(weights, np.float64)
        weights = weights / weights.sum()
    t = 0.0
    trace = []
    for i in range(n_requests):
        if i % max(1, burst) == 0 and i:
            t += float(rng.exponential(mean_gap_s * burst))
        seq_len = int(rng.choice(lengths, p=weights))
        trace.append((round(t, 6), seq_len))
    return trace


def trace_stats(trace) -> dict:
    lens = [l for _, l in trace]
    return {"n_requests": len(trace),
            "span_s": trace[-1][0] if trace else 0.0,
            "len_min": min(lens), "len_max": max(lens)}


def replay_http(url: str, trace, *, make_features, time_scale: float = 1.0,
                timeout_s: float = 60.0) -> dict:
    """POST every trace entry to `url`/predict at its (scaled) arrival
    offset. `make_features(index, seq_len)` builds the request payload —
    deterministic per index, so reruns send identical bytes. Returns
    client-side success counts only; the scoreboard comes from
    `reconstruct` over the telemetry log."""
    t_start = time.monotonic()

    def one(idx_entry):
        i, (offset, seq_len) = idx_entry
        delay = offset * time_scale - (time.monotonic() - t_start)
        if delay > 0:
            time.sleep(delay)
        feats = np.asarray(make_features(i, seq_len))
        body = json.dumps({"features": feats.tolist(),
                           "id": f"replay-{i}"}).encode()
        req = urllib.request.Request(
            f"{url}/predict", data=body,
            headers={"Content-Type": "application/json"})
        # one retry: a burst can race the ThreadingHTTPServer's accept
        # backlog on a loaded host — a reset on first contact is the
        # client environment, not a serving result
        last = None
        for _attempt in range(2):
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    json.loads(resp.read())
                    return None
            except Exception as exc:
                last = exc
        return f"replay-{i}: {last!r}"

    with concurrent.futures.ThreadPoolExecutor(_CLIENT_WORKERS) as pool:
        results = list(pool.map(one, enumerate(trace)))
    errors = [r for r in results if r is not None]
    return {"sent": len(results), "ok": len(results) - len(errors),
            "failed": len(errors), "errors": errors[:5],
            "wall_s": round(time.monotonic() - t_start, 3)}


def reconstruct(telemetry_path: str) -> dict:
    """The predict scoreboard from the telemetry JSONL alone:

    * latency percentiles (ms) over successful `request` events'
      `total_s` (enqueue -> result: queue + assemble + forward);
    * sustained QPS = completed / (last completion - first enqueue),
      both from each event's `ts` (completion) and `total_s`;
    * `recompiles_after_warmup` = `compile` spans without the warmup
      flag — above 0 means a shape escaped the bucket lattice.
    """
    requests, compiles, warm_compiles = [], 0, 0
    for ev in _events(telemetry_path):
        kind = ev.get("event")
        if kind == "request":
            requests.append(ev)
        elif kind == "span" and ev.get("name") == "compile":
            if ev.get("warmup"):
                warm_compiles += 1
            else:
                compiles += 1
    ok = [ev for ev in requests if ev.get("ok")]
    lat_ms = sorted(1000.0 * float(ev["total_s"]) for ev in ok
                    if "total_s" in ev)
    out = {
        "n_requests": len(requests),
        "n_ok": len(ok),
        "n_failed": len(requests) - len(ok),
        "p50_ms": round(_percentile(lat_ms, 50), 3),
        "p99_ms": round(_percentile(lat_ms, 99), 3),
        "warmup_compiles": warm_compiles,
        "recompiles_after_warmup": compiles,
    }
    if ok:
        first_enqueue = min(float(ev["ts"]) - float(ev["total_s"])
                            for ev in ok)
        last_done = max(float(ev["ts"]) for ev in ok)
        span = max(last_done - first_enqueue, 1e-9)
        out["qps"] = round(len(ok) / span, 2)
        out["span_s"] = round(span, 3)
    else:
        out["qps"] = 0.0
        out["span_s"] = 0.0
    return out


def metric_lines(scoreboard: dict, prefix: str = "serving_replay") -> list:
    """The bench metric lines of a predict scoreboard: QPS is
    higher-is-better (the default), the latency and retrace lines carry
    ``lower_is_better``."""
    return [
        {"metric": f"{prefix}_qps", "value": scoreboard["qps"],
         "unit": "req/sec", "n_ok": scoreboard["n_ok"],
         "n_failed": scoreboard["n_failed"]},
        {"metric": f"{prefix}_p50_ms", "value": scoreboard["p50_ms"],
         "unit": "ms", "lower_is_better": True},
        {"metric": f"{prefix}_p99_ms", "value": scoreboard["p99_ms"],
         "unit": "ms", "lower_is_better": True},
        {"metric": f"{prefix}_recompiles_after_warmup",
         "value": scoreboard["recompiles_after_warmup"], "unit": "count",
         "lower_is_better": True,
         "warmup_compiles": scoreboard["warmup_compiles"]},
    ]



def write_artifact(path: str, lines: list) -> dict:
    """Write a SERVE artifact: every metric line plus the trailing
    gate-carrying summary (telemetry/artifact.py parses it)."""
    from deeplearning4j_tpu_torch.telemetry.artifact import build_summary

    summary = build_summary(lines)
    with open(path, "w") as fh:
        for line in lines:
            fh.write(json.dumps(line) + "\n")
        fh.write(json.dumps(summary) + "\n")
    return summary


# ----------------------------------------------------- generation replay

def make_generation_trace(seed: int = 0, n_requests: int = 24, *,
                          mean_gap_s: float = 0.01, burst: int = 2,
                          prompt_lengths=(8, 16, 32),
                          output_lengths=(4, 8, 16),
                          weights=None) -> list:
    """[(arrival_offset_s, prompt_len, output_len), ...]: seeded, bursty
    arrivals (every `burst`-th request opens a fresh exponential gap;
    the burst shares its instant) with a prompt-length x output-length
    mix, so two rounds replay identical traffic and the prefill buckets
    and decode budgets both get exercised."""
    rng = np.random.default_rng(seed)
    plens = list(prompt_lengths)
    olens = list(output_lengths)
    if weights is not None:
        weights = np.asarray(weights, np.float64)
        weights = weights / weights.sum()
    t = 0.0
    trace = []
    for i in range(n_requests):
        if i % max(1, burst) == 0 and i:
            t += float(rng.exponential(mean_gap_s * burst))
        plen = int(rng.choice(plens, p=weights))
        olen = int(rng.choice(olens))
        trace.append((round(t, 6), plen, olen))
    return trace


def replay_generate_http(url: str, trace, *, make_prompt,
                         time_scale: float = 1.0,
                         timeout_s: float = 120.0,
                         collect_tokens: bool = False) -> dict:
    """POST every trace entry to `url`/generate at its arrival offset
    and drain the STREAMING body (each token line arrives as the decode
    loop emits it). `make_prompt(index, prompt_len)` builds the token
    prompt — deterministic per index. Client-side counts only; the
    scoreboard reconstructs from telemetry. With `collect_tokens` the
    result carries a `tokens` dict (request index -> the summary line's
    full emitted token list) — the raw material of the speculative
    replay's greedy-parity gates."""
    t_start = time.monotonic()

    def one(idx_entry):
        i, (offset, plen, olen) = idx_entry
        delay = offset * time_scale - (time.monotonic() - t_start)
        if delay > 0:
            time.sleep(delay)
        toks = np.asarray(make_prompt(i, plen))
        body = json.dumps({"tokens": toks.tolist(),
                           "max_new_tokens": olen,
                           "id": f"gen-{i}"}).encode()
        req = urllib.request.Request(
            f"{url}/generate", data=body,
            headers={"Content-Type": "application/json"})
        last = None
        for _attempt in range(2):
            try:
                with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                    lines = [json.loads(l)
                             for l in resp.read().splitlines() if l]
                if not lines or not lines[-1].get("done"):
                    return f"gen-{i}: stream ended without summary", None
                if lines[-1].get("error"):
                    return f"gen-{i}: {lines[-1]['error']}", None
                return None, [int(t) for t in lines[-1].get("tokens", [])]
            except urllib.error.HTTPError as exc:
                # 503 = pool saturated + queue full: the graceful
                # refusal contract, reported distinctly from transport
                # errors
                return f"gen-{i}: HTTP {exc.code}", None
            except Exception as exc:
                last = exc
        return f"gen-{i}: {last!r}", None

    with concurrent.futures.ThreadPoolExecutor(_CLIENT_WORKERS) as pool:
        results = list(pool.map(one, enumerate(trace)))
    errors = [err for err, _ in results if err is not None]
    out = {"sent": len(results), "ok": len(results) - len(errors),
           "failed": len(errors), "errors": errors[:5],
           "wall_s": round(time.monotonic() - t_start, 3)}
    if collect_tokens:
        out["tokens"] = {i: toks for i, (err, toks) in enumerate(results)
                         if err is None and toks is not None}
    return out


def reconstruct_generation(telemetry_path: str) -> dict:
    """The generation scoreboard from the telemetry JSONL alone:

    * tokens/sec — total generated tokens over the serving span (first
      enqueue to last completion), from `request` events with
      kind="generate";
    * time-to-first-token p50/p99 (ms) — the `ttft_s` field (enqueue to
      the prefill's final chunk emitting the first token);
    * cache-page occupancy — the PEAK pages_in_use/pages_total across
      `page_pool` events (lower = the same traffic held fewer resident
      pages);
    * `recompiles_after_warmup` — non-warmup `compile` spans, exactly
      the predict path's zero-retrace gate;
    * decode-step timing per prompt bucket — median `decode_step` span
      seconds, the flatness evidence for "decode cost is independent of
      prompt length";
    * speculative accounting, when `draft` events are on the record —
      `accepted_tokens_per_step` (the MEDIAN of per-verify-step emitted
      tokens per active slot: 1.0 is the plain-decode floor, anything
      above it is decode steps the slots never ran),
      `draft_acceptance_rate` (accepted drafts / offered drafts), and
      `draft_overhead_us` (mean host-side proposer wall clock per
      verify step), plus the median `verify_step` span time.
    """
    requests, compiles, warm_compiles = [], 0, 0
    occupancy_peak = 0.0
    decode_spans = []
    draft_events, verify_spans = [], []
    for ev in _events(telemetry_path):
        kind = ev.get("event")
        if kind == "request" and ev.get("kind") == "generate":
            requests.append(ev)
        elif kind == "span" and ev.get("name") == "compile":
            if ev.get("warmup"):
                warm_compiles += 1
            else:
                compiles += 1
        elif kind == "span" and ev.get("name") == "decode_step":
            decode_spans.append(ev)
        elif kind == "span" and ev.get("name") == "verify_step":
            verify_spans.append(ev)
        elif kind == "draft":
            draft_events.append(ev)
        elif kind == "page_pool":
            total = ev.get("pages_total") or 0
            if total:
                occupancy_peak = max(
                    occupancy_peak,
                    float(ev.get("pages_in_use", 0)) / total)
    ok = [ev for ev in requests if ev.get("ok")]
    ttft_ms = sorted(1000.0 * float(ev["ttft_s"]) for ev in ok
                     if "ttft_s" in ev)
    total_tokens = sum(int(ev.get("new_tokens", 0)) for ev in ok)
    out = {
        "n_requests": len(requests),
        "n_ok": len(ok),
        "n_failed": len(requests) - len(ok),
        "total_tokens": total_tokens,
        "ttft_p50_ms": round(_percentile(ttft_ms, 50), 3),
        "ttft_p99_ms": round(_percentile(ttft_ms, 99), 3),
        "page_occupancy_peak": round(occupancy_peak, 4),
        "warmup_compiles": warm_compiles,
        "recompiles_after_warmup": compiles,
        "decode_steps": len(decode_spans),
    }
    if decode_spans:
        secs = sorted(float(ev.get("seconds", 0.0))
                      for ev in decode_spans)
        out["decode_step_ms_p50"] = round(
            1000.0 * _percentile(secs, 50), 3)
    if draft_events:
        per_step = sorted(
            float(ev.get("emitted", 0)) / max(int(ev.get("n_active", 1)), 1)
            for ev in draft_events)
        offered = sum(int(ev.get("drafted", 0)) for ev in draft_events)
        accepted = sum(int(ev.get("accepted", 0)) for ev in draft_events)
        out["verify_steps"] = len(draft_events)
        out["accepted_tokens_per_step"] = round(_percentile(per_step, 50), 4)
        out["draft_acceptance_rate"] = round(
            accepted / offered, 4) if offered else 0.0
        out["draft_overhead_us"] = round(
            sum(float(ev.get("overhead_us", 0.0)) for ev in draft_events)
            / len(draft_events), 2)
    if verify_spans:
        secs = sorted(float(ev.get("seconds", 0.0)) for ev in verify_spans)
        out["verify_step_ms_p50"] = round(1000.0 * _percentile(secs, 50), 3)
    if ok:
        first_enqueue = min(float(ev["ts"]) - float(ev["total_s"])
                            for ev in ok)
        last_done = max(float(ev["ts"]) for ev in ok)
        span = max(last_done - first_enqueue, 1e-9)
        out["tokens_per_sec"] = round(total_tokens / span, 2)
        out["span_s"] = round(span, 3)
    else:
        out["tokens_per_sec"] = 0.0
        out["span_s"] = 0.0
    return out


def generation_metric_lines(scoreboard: dict,
                            prefix: str = "serving_generate") -> list:
    """Bench metric lines for the generation scoreboard. tokens/sec is
    higher-is-better (the default); TTFT latency, cache-page occupancy,
    and the retrace count carry the explicit lower_is_better flag
    benchdiff inverts on. A speculative scoreboard (draft events were
    on the record) adds `accepted_tokens_per_step` (higher) and
    `draft_overhead_us` (lower — the `_us` suffix is also in
    benchdiff's name-shape fallback)."""
    lines = [
        {"metric": f"{prefix}_tokens_per_sec",
         "value": scoreboard["tokens_per_sec"], "unit": "tok/sec",
         "n_ok": scoreboard["n_ok"], "n_failed": scoreboard["n_failed"],
         "total_tokens": scoreboard["total_tokens"]},
        {"metric": f"{prefix}_ttft_p50_ms",
         "value": scoreboard["ttft_p50_ms"], "unit": "ms",
         "lower_is_better": True},
        {"metric": f"{prefix}_ttft_p99_ms",
         "value": scoreboard["ttft_p99_ms"], "unit": "ms",
         "lower_is_better": True},
        {"metric": f"{prefix}_page_occupancy",
         "value": scoreboard["page_occupancy_peak"], "unit": "fraction",
         "lower_is_better": True},
        {"metric": f"{prefix}_recompiles_after_warmup",
         "value": scoreboard["recompiles_after_warmup"], "unit": "count",
         "lower_is_better": True,
         "warmup_compiles": scoreboard["warmup_compiles"]},
    ]
    if "accepted_tokens_per_step" in scoreboard:
        lines.append(
            {"metric": f"{prefix}_accepted_tokens_per_step",
             "value": scoreboard["accepted_tokens_per_step"],
             "unit": "tokens/step",
             "verify_steps": scoreboard["verify_steps"],
             "draft_acceptance_rate": scoreboard["draft_acceptance_rate"]})
        lines.append(
            {"metric": f"{prefix}_draft_overhead_us",
             "value": scoreboard["draft_overhead_us"], "unit": "us",
             "lower_is_better": True})
    return lines


def run_generation_replay(*, seed: int = 0, n_requests: int = 24,
                          burst: int = 2, mean_gap_s: float = 0.01,
                          prompt_lengths=(8, 16, 32),
                          output_lengths=(4, 8, 16),
                          slots: int = 4, page_size: int = 16,
                          replicas: int = 1,
                          prefill_chunk: int | None = None,
                          max_queue: int = 256,
                          speculative_k: int = 0,
                          kv_dtype: str = "f32",
                          telemetry_path: str,
                          artifact_path: str | None = None,
                          checkpoint: str | None = None,
                          emit=None, device=None) -> dict:
    """End-to-end generation replay: the tiny LM, a GenerationEngine
    warmed over the prompt-bucket lattice, the seeded trace over real
    HTTP with streaming reads, drain, the scoreboard from telemetry
    alone, and optionally a SERVE artifact. `speculative_k`/`kv_dtype`
    pass straight through to the engine. `checkpoint` (a checkpoint
    directory, util/checkpoint.py) serves a trained net instead: the net
    of the newest step's own configuration, which the engine restores
    before warmup."""
    from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
    from deeplearning4j_tpu_torch.serving.engine import GenerationEngine
    from deeplearning4j_tpu_torch.serving.server import ServingServer
    from deeplearning4j_tpu_torch.telemetry import Recorder

    rec = Recorder(telemetry_path)
    rec.meta(role="trafficreplay-generate", seed=seed,
             n_requests=n_requests, burst=burst,
             prompt_lengths=list(prompt_lengths),
             output_lengths=list(output_lengths),
             speculative_k=speculative_k, kv_dtype=kv_dtype)
    lattice = BucketLattice(batch_sizes=(1,),
                            seq_lens=sorted(set(prompt_lengths)))
    if checkpoint is None:
        net = _tiny_lm(max_seq=max(prompt_lengths) + max(output_lengths),
                       device=device)
    else:  # the engine restores it before warmup
        from deeplearning4j_tpu_torch.util.checkpoint import network_of

        net = network_of(checkpoint, device=device)[0].init()
    lattice.validate_attention(head_dim=_head_dim(net))
    make_prompt = _prompt_maker(seed, n_requests, max(prompt_lengths))
    engine = GenerationEngine(
        net, lattice, slots=slots, max_new_tokens=max(output_lengths),
        page_size=page_size, prefill_chunk=prefill_chunk,
        max_queue=max_queue, replicas=replicas, checkpoint=checkpoint,
        speculative_k=speculative_k, kv_dtype=kv_dtype, recorder=rec)
    warm = engine.warmup()
    server = ServingServer(engine, port=0).start()
    trace = make_generation_trace(
        seed, n_requests, mean_gap_s=mean_gap_s, burst=burst,
        prompt_lengths=prompt_lengths, output_lengths=output_lengths)
    try:
        client = replay_generate_http(server.url, trace,
                                      make_prompt=make_prompt)
    finally:
        server.stop()
        rec.close()
    scoreboard = reconstruct_generation(telemetry_path)
    scoreboard["client"] = client
    scoreboard["warmed_shapes"] = warm
    lines = generation_metric_lines(scoreboard)
    if emit is not None:
        for line in lines:
            emit(line)
    if artifact_path:
        scoreboard["summary"] = write_artifact(artifact_path, lines)
        scoreboard["artifact"] = artifact_path
    scoreboard["lines"] = lines
    return scoreboard


# -------------------------------------------------- speculative replay

def _sample_microbench_us(batch: int = 8, vocab: int = 128,
                          iters: int = 20, device=None) -> float:
    """Best-of-N wall clock (us) of one fused_sample call (temperature
    1.0, top_k 8, top_p 0.9) — the `serving_sample_us` row. On CUDA it
    launches K12 (one warm call and `iters` timed ones) and synchronizes
    before reading the clock; on the CPU it times the plain version."""
    from deeplearning4j_tpu_torch import resolve_device
    from deeplearning4j_tpu_torch.ops import fused_sampling

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    logits = torch.as_tensor(
        np.asarray(rng.normal(size=(batch, vocab)), np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = fused_sampling.gumbel_noise(gen, batch, vocab, dev)
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    def call():
        return fused_sampling.fused_sample(logits, noise, temperature=1.0,
                                           top_k=8, top_p=0.9)

    call()  # builds and loads the kernel outside the timed region
    sync()
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        call()
        sync()
        best = min(best, time.perf_counter() - t0)
    return round(best * 1e6, 2)


def run_speculative_replay(*, seed: int = 0, n_requests: int = 24,
                           burst: int = 2, mean_gap_s: float = 0.01,
                           prompt_lengths=(8, 16, 32),
                           output_lengths=(4, 8, 16),
                           slots: int = 4, page_size: int = 16,
                           speculative_k: int = 4,
                           repeats: int = 2,
                           max_queue: int = 256,
                           telemetry_path: str,
                           artifact_path: str | None = None,
                           emit=None, device=None) -> dict:
    """The SERVE_r04 bench: the SAME seeded generation trace through
    three arms, interleaved round-robin across `repeats` rounds:

    * **baseline** — plain greedy decode, f32 cache (`serving_generate`
      rows);
    * **speculative** — `speculative_k`-token windows: n-gram drafts and
      one fixed-shape verify step per window (`serving_speculative`
      rows, plus `accepted_tokens_per_step` and `draft_overhead_us`);
    * **quantized** — int8 paged KV cache (`serving_quantized` rows,
      plus the `slots_per_hbm_byte_x` capacity ratio).

    All arms share one weight init (the tiny LM from the port's seed) and
    serve identical prompts; every stream's tokens
    are captured, and the `*_parity_mismatches` rows count requests
    whose greedy tokens differ from the baseline's first round. Each arm
    appends every round to its own telemetry file (`<path>.<arm>`) and
    reconstructs from it alone. Parity failures are reported rows, not
    raises."""
    from deeplearning4j_tpu_torch.nn.decode import attention_specs
    from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
    from deeplearning4j_tpu_torch.serving.engine import GenerationEngine
    from deeplearning4j_tpu_torch.serving.kvcache import (CachePlan,
                                                          bytes_per_slot)
    from deeplearning4j_tpu_torch.serving.server import ServingServer
    from deeplearning4j_tpu_torch.telemetry import Recorder

    if speculative_k < 2:
        raise ValueError(
            f"need speculative_k >= 2 for the speculative arm, "
            f"got {speculative_k}")
    net = _tiny_lm(max_seq=max(prompt_lengths) + max(output_lengths),
                   device=device)
    make_prompt = _prompt_maker(seed, n_requests, max(prompt_lengths))
    trace = make_generation_trace(
        seed, n_requests, mean_gap_s=mean_gap_s, burst=burst,
        prompt_lengths=prompt_lengths, output_lengths=output_lengths)
    arms = (("baseline", 0, "f32", "serving_generate"),
            ("speculative", speculative_k, "f32", "serving_speculative"),
            ("quantized", 0, "int8", "serving_quantized"))

    def run_arm(name, k, dtype, rnd) -> dict:
        tpath = f"{telemetry_path}.{name}"
        rec = Recorder(tpath)
        rec.meta(role="trafficreplay-speculative", arm=name, round=rnd,
                 seed=seed, n_requests=n_requests, burst=burst,
                 speculative_k=k, kv_dtype=dtype)
        lattice = BucketLattice(batch_sizes=(1,),
                                seq_lens=sorted(set(prompt_lengths)))
        lattice.validate_attention(head_dim=16)
        engine = GenerationEngine(
            net, lattice, slots=slots,
            max_new_tokens=max(output_lengths), page_size=page_size,
            max_queue=max_queue, speculative_k=k, kv_dtype=dtype,
            recorder=rec)
        engine.warmup()
        server = ServingServer(engine, port=0).start()
        try:
            client = replay_generate_http(server.url, trace,
                                          make_prompt=make_prompt,
                                          collect_tokens=True)
        finally:
            server.stop()
            rec.close()
        client["telemetry"] = tpath
        return client

    token_rounds = {name: [] for name, _, _, _ in arms}
    for rnd in range(max(1, repeats)):
        for name, k, dtype, _prefix in arms:
            client = run_arm(name, k, dtype, rnd)
            token_rounds[name].append(client.get("tokens", {}))

    # parity: every arm's every round against the baseline's FIRST round
    # (a baseline round that disagrees with itself counts too)
    reference = token_rounds["baseline"][0]
    mismatches = {}
    for name, _, _, _ in arms:
        bad = 0
        for tokens in token_rounds[name]:
            for i, ref in reference.items():
                if tokens.get(i) != ref:
                    bad += 1
        mismatches[name] = bad

    scoreboards, lines = {}, []
    for name, _k, _dtype, prefix in arms:
        sb = reconstruct_generation(f"{telemetry_path}.{name}")
        sb["telemetry"] = f"{telemetry_path}.{name}"
        scoreboards[name] = sb
        lines.extend(generation_metric_lines(sb, prefix=prefix))

    # the capacity headline: slots per device byte with the int8 cache,
    # from the same plan the engines served under
    plan = CachePlan(max(prompt_lengths), max(output_lengths),
                     n_slots=slots, page_size=page_size)
    specs = attention_specs(net)
    f32_bytes = bytes_per_slot(plan.capacity, specs, "f32", page_size)
    int8_bytes = bytes_per_slot(plan.capacity, specs, "int8", page_size)
    ratio = round(f32_bytes / int8_bytes, 4)
    lines.append(
        {"metric": "serving_quantized_slots_per_hbm_byte_x",
         "value": ratio, "unit": "x", "f32_bytes_per_slot": f32_bytes,
         "int8_bytes_per_slot": int8_bytes})
    lines.append(
        {"metric": "serving_sample_us",
         "value": _sample_microbench_us(device=net.device), "unit": "us",
         "lower_is_better": True})
    lines.append(
        {"metric": "serving_speculative_parity_mismatches",
         "value": mismatches["speculative"] + mismatches["baseline"],
         "unit": "count", "lower_is_better": True,
         "n_reference": len(reference)})
    lines.append(
        {"metric": "serving_quantized_parity_mismatches",
         "value": mismatches["quantized"], "unit": "count",
         "lower_is_better": True, "n_reference": len(reference)})
    if emit is not None:
        for line in lines:
            emit(line)
    out = {"arms": scoreboards, "parity_mismatches": mismatches,
           "lines": lines, "repeats": max(1, repeats),
           "n_ok": sum(sb["n_ok"] for sb in scoreboards.values()),
           "slots_per_hbm_byte_x": ratio}
    if artifact_path:
        out["summary"] = write_artifact(artifact_path, lines)
        out["artifact"] = artifact_path
    return out


# ----------------------------------------------------------- the harness

def _prompt_maker(seed: int, n_requests: int, max_prompt: int):
    """The replay's prompts: request i's first `plen` tokens of a seeded
    [n_requests, max_prompt] draw over the tiny LM's 64-token vocab."""
    prompts = np.random.default_rng(seed + 1).integers(
        0, 64, (n_requests, max_prompt))

    def make_prompt(i, plen):
        return prompts[i, :plen].astype(np.int64)

    return make_prompt


def _tiny_lm(max_seq: int, vocab: int = 64, device=None):
    """The replays' LM: vocab 64, d_model 32, 2 heads, 2 layers, d_ff 64,
    initialised from the port's default seed."""
    from deeplearning4j_tpu_torch.models.transformer import transformer_lm

    net = transformer_lm(vocab_size=vocab, d_model=32, n_heads=2,
                         n_layers=2, d_ff=64, max_length=max_seq,
                         device=device)
    net.init()
    return net


def _head_dim(net) -> int:
    """The head dim of the net's first self-attention layer."""
    from deeplearning4j_tpu_torch.nn.conf.layers import SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.updater import named_layer_confs

    for lc in named_layer_confs(net).values():
        if isinstance(lc, SelfAttentionLayer):
            return lc.n_out // lc.n_heads
    raise ValueError("the generation replay serves a net with a "
                     "self-attention layer")


def _tiny_mlp(n_in: int = 8, n_out: int = 4, device=None):
    """The predict replays' MLP: dense 8 -> 16 (relu) -> softmax 4,
    configuration seed 7."""
    from deeplearning4j_tpu_torch.nn.conf import (DenseLayer,
                                                  NeuralNetConfiguration,
                                                  OutputLayer)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(7).list()
            .layer(DenseLayer(n_in=n_in, n_out=16, activation="relu"))
            .layer(OutputLayer(n_in=16, n_out=n_out, activation="softmax",
                               loss_function="mcxent"))
            .build())
    return MultiLayerNetwork(conf, device=device).init()


def run_replay(*, model: str = "lm", seed: int = 0, n_requests: int = 60,
               burst: int = 4, mean_gap_s: float = 0.002,
               lengths=(8, 16, 32), batch_sizes=(1, 2, 4),
               max_wait_ms: float = 4.0, replicas: int = 1,
               telemetry_path: str, artifact_path: str | None = None,
               checkpoint: str | None = None, chaos: str | None = None,
               emit=None, device=None) -> dict:
    """End-to-end predict replay (bench mode `serving_replay`): build the
    tiny model ("lm" or "mlp"), warm the bucket lattice, replay the
    seeded trace over HTTP, drain, reconstruct from the telemetry JSONL,
    and optionally write the SERVE artifact. `emit` receives each metric
    line. `chaos` is a replica-scoped fault spec (`r0:kill@batch3`): the
    faults fire inside the replicas and a FleetSupervisor heals them
    live. Setup errors raise; a replay with failed requests is reported,
    not raised."""
    from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.serving.server import ServingServer
    from deeplearning4j_tpu_torch.telemetry import Recorder

    sequence = model == "lm"
    rec = Recorder(telemetry_path)
    rec.meta(role="trafficreplay", model=model, seed=seed,
             n_requests=n_requests, burst=burst, lengths=list(lengths))
    feat_rng = np.random.default_rng(seed + 1)
    if sequence:
        lattice = BucketLattice(batch_sizes=batch_sizes,
                                seq_lens=sorted(set(lengths)))
        net = _tiny_lm(max_seq=max(lengths), device=device)
        # every seq bucket must have an attention path
        lattice.validate_attention(head_dim=16)
        tokens = feat_rng.integers(0, 64, (n_requests, max(lengths)))

        def make_features(i, seq_len):
            return tokens[i, :seq_len]
    else:
        lattice = BucketLattice(batch_sizes=batch_sizes)
        net = _tiny_mlp(device=device)
        feats = feat_rng.normal(size=(n_requests, 8)).astype(np.float32)

        def make_features(i, seq_len):
            return feats[i]

    engine = InferenceEngine(net, lattice, replicas=replicas,
                             max_wait_ms=max_wait_ms, sequence=sequence,
                             checkpoint=checkpoint, faults=chaos,
                             recorder=rec)
    warm = engine.warmup(make_features(0, max(lengths) if sequence else 0))
    server = ServingServer(engine, port=0).start()
    supervisor = None
    if chaos is not None:
        # chaos without a healer would just bleed: the supervisor reaps
        # the injected deaths and respawns, live, during the replay
        from deeplearning4j_tpu_torch.serving.fleet import (FleetSupervisor,
                                                            RespawnBackoff)

        supervisor = FleetSupervisor(
            engine, death_after_s=1.0,
            backoff=RespawnBackoff(base_s=0.01, jitter_frac=0.0),
            recorder=rec).run_in_thread(0.02)
    trace = make_trace(seed, n_requests, mean_gap_s=mean_gap_s,
                       burst=burst, lengths=lengths)
    try:
        client = replay_http(server.url, trace, make_features=make_features)
    finally:
        if supervisor is not None:
            supervisor.stop()
        server.stop()
        rec.close()
    scoreboard = (reconstruct_fleet(telemetry_path) if chaos is not None
                  else reconstruct(telemetry_path))
    scoreboard["client"] = client
    scoreboard["warmed_buckets"] = warm
    lines = metric_lines(scoreboard)
    if emit is not None:
        for line in lines:
            emit(line)
    if artifact_path:
        scoreboard["summary"] = write_artifact(artifact_path, lines)
        scoreboard["artifact"] = artifact_path
    scoreboard["lines"] = lines
    return scoreboard


# ---------------------------------------------------------- fleet replay

def reconstruct_fleet(telemetry_path: str) -> dict:
    """The fleet-operations scoreboard — `reconstruct` plus, from the
    telemetry JSONL alone:

    * `swap_ms` — the slowest successful `weight_swap` restore; `n_swaps`
      counts them, `swap_rejected` the refusals;
    * `respawn_ms` — the slowest `replica-respawn` fault event (reap ->
      re-warm -> re-admit), with `n_respawns` and `n_replica_deaths`;
    * `autoscale_occupancy` — mean of `n_replicas / max_replicas` over
      `autoscale` events, with `scale_ups` and `scale_downs`;
    * `weight_generations` — the distinct `weight_gen` values of
      `request` events: a hot-swap's flip shows here or it never reached
      traffic.
    """
    sb = reconstruct(telemetry_path)
    swap_ms, respawn_ms, occ = [], [], []
    swaps_rejected = deaths = ups = downs = 0
    gens = set()
    for ev in _events(telemetry_path):
        kind = ev.get("event")
        if kind == "weight_swap":
            if ev.get("ok"):
                swap_ms.append(float(ev.get("restore_ms", 0.0)))
            else:
                swaps_rejected += 1
        elif kind == "fault":
            if ev.get("kind") == "replica-respawn":
                respawn_ms.append(float(ev.get("respawn_ms", 0.0)))
            elif ev.get("kind") == "replica-dead":
                deaths += 1
        elif kind == "autoscale":
            total = ev.get("max_replicas") or 0
            if total:
                occ.append(float(ev.get("n_replicas", 0)) / total)
            if ev.get("action", 0) > 0:
                ups += 1
            elif ev.get("action", 0) < 0:
                downs += 1
        elif kind == "request" and "weight_gen" in ev:
            gens.add(int(ev["weight_gen"]))
    sb.update({
        "swap_ms": round(max(swap_ms), 3) if swap_ms else 0.0,
        "n_swaps": len(swap_ms),
        "swap_rejected": swaps_rejected,
        "respawn_ms": round(max(respawn_ms), 3) if respawn_ms else 0.0,
        "n_respawns": len(respawn_ms),
        "n_replica_deaths": deaths,
        "autoscale_occupancy": (round(sum(occ) / len(occ), 4)
                                if occ else 0.0),
        "scale_ups": ups,
        "scale_downs": downs,
        "weight_generations": sorted(gens),
    })
    return sb


def fleet_metric_lines(fixed: dict, autoscale: dict,
                       prefix: str = "fleet") -> list:
    """Bench metric lines of the two-arm fleet replay. QPS rows are
    higher-is-better; everything the fleet spends — latency, restore and
    respawn time, failed requests, held replicas, retraces — carries
    ``lower_is_better``."""
    return [
        {"metric": f"{prefix}_fixed_qps", "value": fixed["qps"],
         "unit": "req/sec", "n_ok": fixed["n_ok"],
         "n_failed": fixed["n_failed"]},
        {"metric": f"{prefix}_fixed_p99_ms", "value": fixed["p99_ms"],
         "unit": "ms", "lower_is_better": True},
        {"metric": f"{prefix}_autoscale_qps", "value": autoscale["qps"],
         "unit": "req/sec", "n_ok": autoscale["n_ok"],
         "n_failed": autoscale["n_failed"]},
        {"metric": f"{prefix}_autoscale_p99_ms",
         "value": autoscale["p99_ms"], "unit": "ms",
         "lower_is_better": True},
        {"metric": f"{prefix}_autoscale_occupancy",
         "value": autoscale["autoscale_occupancy"], "unit": "fraction",
         "lower_is_better": True, "scale_ups": autoscale["scale_ups"],
         "scale_downs": autoscale["scale_downs"]},
        {"metric": f"{prefix}_swap_ms", "value": autoscale["swap_ms"],
         "unit": "ms", "lower_is_better": True,
         "n_swaps": autoscale["n_swaps"]},
        {"metric": f"{prefix}_respawn_ms",
         "value": autoscale["respawn_ms"], "unit": "ms",
         "lower_is_better": True,
         "n_respawns": autoscale["n_respawns"]},
        {"metric": f"{prefix}_failed_requests",
         "value": autoscale["n_failed"], "unit": "count",
         "lower_is_better": True, "n_ok": autoscale["n_ok"]},
        {"metric": f"{prefix}_recompiles_after_warmup",
         "value": (fixed["recompiles_after_warmup"]
                   + autoscale["recompiles_after_warmup"]),
         "unit": "count", "lower_is_better": True,
         "warmup_compiles": (fixed["warmup_compiles"]
                             + autoscale["warmup_compiles"])},
    ]


def run_fleet_replay(*, seed: int = 0, n_requests: int = 120,
                     burst: int = 8, mean_gap_s: float = 0.004,
                     batch_sizes=(1, 2, 4), max_wait_ms: float = 3.0,
                     autoscale_max: int = 3,
                     chaos: str | None = "r0:kill@batch4",
                     hot_swap_after: int | None = None,
                     telemetry_path: str,
                     artifact_path: str | None = None,
                     emit=None, device=None) -> dict:
    """The fleet bench: one seeded bursty trace through two arms —

    * **fixed** — one replica, no supervisor;
    * **autoscale** — starts at one replica under a `FleetSupervisor`
      (AutoscalePolicy up to `autoscale_max`), absorbs the replica-kill
      `chaos` spec mid-traffic, and hot-swaps a checkpoint it publishes
      (the net's own weights saved at a new step, under
      `<telemetry_path>.publish`) once `hot_swap_after` requests have
      completed (default: half the trace).

    Each arm records to its own telemetry file (`<path>.fixed` /
    `<path>.autoscale`) and reconstructs from it alone; the artifact is
    the `fleet_*` metric lines and the gate summary."""
    from deeplearning4j_tpu_torch.serving.buckets import BucketLattice
    from deeplearning4j_tpu_torch.serving.engine import InferenceEngine
    from deeplearning4j_tpu_torch.serving.fleet import (AutoscalePolicy,
                                                        FleetSupervisor,
                                                        RespawnBackoff,
                                                        hot_swap)
    from deeplearning4j_tpu_torch.serving.server import ServingServer
    from deeplearning4j_tpu_torch.telemetry import Recorder
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    if hot_swap_after is None:
        hot_swap_after = n_requests // 2
    trace = make_trace(seed, n_requests, mean_gap_s=mean_gap_s,
                       burst=burst, lengths=(8,))
    feat_rng = np.random.default_rng(seed + 1)
    feats = feat_rng.normal(size=(n_requests, 8)).astype(np.float32)

    def make_features(i, seq_len):
        return feats[i]

    def run_arm(arm: str) -> dict:
        tpath = f"{telemetry_path}.{arm}"
        rec = Recorder(tpath)
        rec.meta(role="trafficreplay-fleet", arm=arm, seed=seed,
                 n_requests=n_requests, burst=burst,
                 autoscale_max=autoscale_max,
                 chaos=chaos if arm == "autoscale" else None)
        engine = InferenceEngine(
            _tiny_mlp(device=device), BucketLattice(batch_sizes=batch_sizes),
            max_wait_ms=max_wait_ms, replicas=1,
            faults=chaos if arm == "autoscale" else None, recorder=rec)
        engine.warmup(make_features(0, 0))
        server = ServingServer(engine, port=0).start()
        supervisor = swapper = None
        if arm == "autoscale":
            supervisor = FleetSupervisor(
                engine, death_after_s=1.0,
                policy=AutoscalePolicy(max_replicas=autoscale_max),
                backoff=RespawnBackoff(base_s=0.01, jitter_frac=0.0),
                recorder=rec).run_in_thread(0.02)
            # the "training job publishes a step" half: the serving
            # weights saved under a NEW step, hot-swapped once
            # `hot_swap_after` requests have completed
            ckdir = f"{telemetry_path}.publish"
            publish_net = engine.net.clone()
            publish_net.iteration_count = engine.restored_step + 1
            Checkpointer(ckdir).save(publish_net)
            stop = threading.Event()

            def swap_when_due():
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline and not stop.is_set():
                    if engine.served >= hot_swap_after:
                        hot_swap(engine, ckdir)
                        return
                    # the served counter has no notify hook to block on;
                    # the wait is bounded by the deadline
                    stop.wait(0.002)

            swapper = threading.Thread(target=swap_when_due, daemon=True,
                                       name="fleet-replay-swap")
            swapper.start()
        try:
            client = replay_http(server.url, trace,
                                 make_features=make_features)
        finally:
            if swapper is not None:
                swapper.join(timeout=60)
                stop.set()
            if supervisor is not None:
                supervisor.stop()
            server.stop()
            rec.close()
        sb = reconstruct_fleet(tpath)
        sb["client"] = client
        sb["telemetry"] = tpath
        return sb

    fixed = run_arm("fixed")
    autoscale = run_arm("autoscale")
    lines = fleet_metric_lines(fixed, autoscale)
    if emit is not None:
        for line in lines:
            emit(line)
    out = {"fixed": fixed, "autoscale": autoscale, "lines": lines,
           "n_ok": fixed["n_ok"] + autoscale["n_ok"]}
    if artifact_path:
        out["summary"] = write_artifact(artifact_path, lines)
        out["artifact"] = artifact_path
    return out
