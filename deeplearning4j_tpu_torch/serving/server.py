"""The serving front door: a stdlib ThreadingHTTPServer over an
InferenceEngine, a GenerationEngine or an EmbeddingServingEngine (JAX
counterpart
deeplearning4j_tpu/serving/server.py).

Endpoints (all JSON):

    POST /predict       {"features": [...], "mask": [...]?, "id": "..."?}
                        -> {"id", "output", "prediction", "timing"}.
                        The request rides the dynamic batcher: it
                        coalesces with concurrent requests into a bucket
                        batch (serving/batcher.py) and returns when its
                        batch completes. 400 on a malformed body, a
                        prompt longer than the lattice max or a drain
                        race; 503 while draining; 504 when the batch
                        never completed; 500 when the batch's forward
                        failed (the error names the cause); 404 when the
                        engine has no predict path.
    POST /generate      {"tokens": [...], "max_new_tokens": N?, "id"?}
                        -> STREAMING NDJSON (one {"token": t, "i": k}
                        line per generated token as it decodes, then a
                        {"done": true, "tokens": [...], "timing": ...}
                        summary line; close-delimited body). 400 on
                        malformed or oversized prompts, 503 while
                        draining or when the KV-cache page pool and
                        pending queue are saturated, 404 when the engine
                        has no generation path.
    POST /embed         {"ids": [...], "id"?} -> {"id", "vectors",
                        "timing"}: embedding-table rows, served by an
                        EmbeddingServingEngine (embedding/serving.py);
                        404 otherwise, 400 on out-of-range ids or a
                        batch over the lattice max, 503 while draining.
    POST /search        {"vector": [...]} or {"vectors": [[...], ...]},
                        "k"?, "id"? -> {"id", "ids", "scores", "timing"}:
                        ANN top-k by cosine through the partition-then-
                        refine index (embedding/ann.py), nearest first;
                        400 on a k off the warmed grid; the same
                        404/400/503 envelope as /embed.
    GET  /metrics       Prometheus text exposition (version 0.0.4) from
                        the stdlib registry (telemetry/metrics.py):
                        request latency and TTFT histograms fed live off
                        the telemetry `request` events, queue depth,
                        KV page-pool occupancy, speculative acceptance
                        gauges, weight generation, per-replica liveness
                        and heartbeat age, and the embedding engine's
                        gather / ann_probe span latencies and bytes
                        moved, the device-memory gauges from the
                        engine's memory sampler (serving_hbm_live_bytes,
                        serving_hbm_limit_bytes and
                        serving_hbm_headroom_ratio on the card,
                        serving_memory_ledger_bytes by subsystem) and
                        serving_mfu_live: the mean of recent samples of
                        the cost book's counted flops over a measured
                        forward (predict) or step (generation: the
                        prefill_chunk, decode_step and verify_step
                        spans) and the device's peak.
    GET  /healthz       the engine's stats plus "status": replicas,
                        counters, per-replica rows ("fleet": index,
                        state warming/serving/draining/dead/retired,
                        alive, counters, last_beat_age_s) and the
                        published weights (generation, step,
                        last_swap_ts)
    GET  /stats         the engine's stats, plus "kernel_launches":
                        this process's launch counts of K1–K13
                        (ops.launch_counts)
    POST /drain         begin graceful drain (stop admitting); the server
                        keeps answering GETs

Every 503 carries a ``Retry-After`` header: the condition is transient.

Run with ``ServingServer(engine, port=0).start()``; ``.url`` gives the
bound address. ``stop()`` drains the engine then closes the listener.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

# per-request wait bound inside the HTTP handler: far above any sane
# max-wait + forward time; a hit means the engine lost the batch
REQUEST_TIMEOUT_S = 60.0

# Retry-After seconds on every 503 (drain / saturation): drains flush in
# well under this, and a retrying client that waits it out lands on the
# replacement fleet member
RETRY_AFTER_S = 5


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-serve/1.0"

    def log_message(self, fmt, *args):  # quiet
        pass

    @property
    def serving(self) -> "ServingServer":
        return self.server.serving_server

    def _json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if code == 503:
            # a draining / saturated fleet is a transient condition: tell
            # well-behaved clients when to come back (RFC 9110 §10.2.3)
            self.send_header("Retry-After", str(RETRY_AFTER_S))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        route = self.path.rstrip("/")
        engine = self.serving.engine
        if route in ("", "/healthz"):
            stats = engine.stats()
            stats["status"] = ("draining" if self.serving.draining
                              else "serving")
            self._json(stats)
            return
        if route == "/stats":
            # the engine's stats, plus this process's kernel launch
            # counts (ops.launch_counts): how a client sees which
            # kernels its requests ran
            from deeplearning4j_tpu_torch.ops import launch_counts

            self._json({**engine.stats(), "kernel_launches": launch_counts()})
            return
        if route == "/metrics":
            body = self.serving.metrics.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", _metrics_mod().CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._json({"error": f"unknown path {self.path}"}, 404)

    def do_POST(self):  # noqa: N802
        route = self.path.rstrip("/")
        if route == "/drain":
            self.serving.begin_drain()
            self._json({"status": "draining"})
            return
        if route == "/generate":
            self._generate()
            return
        if route == "/predict":
            self._predict()
            return
        if route in ("/embed", "/search"):
            self._embedding(route)
            return
        self._json({"error": f"unknown path {self.path}"}, 404)

    def _predict(self):
        """One request through the dynamic batcher; the reply carries
        the output rows, their argmax and the request's timing."""
        engine = self.serving.engine
        if not hasattr(engine, "submit"):
            self._json({"error": "this engine does not serve predict "
                                 "(start an InferenceEngine)"}, 404)
            return
        if self.serving.draining:
            self._json({"error": "draining; not admitting requests"}, 503)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            features = np.asarray(payload["features"])
            mask = payload.get("mask")
        except (KeyError, ValueError, TypeError) as exc:
            self._json({"error": f"bad request body: {exc!r}"}, 400)
            return
        try:
            req = engine.submit(features, mask=mask,
                                request_id=payload.get("id"))
        except (ValueError, RuntimeError) as exc:
            # a lattice rejection (prompt longer than the max seq
            # bucket) or a drain race: the client's error
            self._json({"error": str(exc)}, 400)
            return
        if not req.wait(REQUEST_TIMEOUT_S):
            self._json({"id": req.request_id, "error": "timed out"}, 504)
            return
        if req.error is not None:
            self._json({"id": req.request_id, "error": req.error}, 500)
            return
        out = np.asarray(req.result)
        self._json({
            "id": req.request_id,
            "output": out.tolist(),
            "prediction": _argmax_last(out),
            "timing": {
                "queue_s": round(req.t_assembled - req.t_enqueue, 6),
                "total_s": round(req.t_done - req.t_enqueue, 6),
            },
        })

    def _generate(self):
        """Streaming generation: tokens flow to the client line-by-line
        as the decode loop emits them (queue → NDJSON; the body is
        close-delimited, so plain urllib readers see each line as it
        flushes). The summary line carries the full token list and the
        TTFT/total timing so a client that only reads the tail still
        gets everything."""
        engine = self.serving.engine
        if not hasattr(engine, "submit_generate"):
            self._json({"error": "this engine does not serve "
                                 "generation (start a "
                                 "GenerationEngine)"}, 404)
            return
        if self.serving.draining:
            self._json({"error": "draining; not admitting requests"}, 503)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            tokens = np.asarray(payload["tokens"])
            max_new = payload.get("max_new_tokens")
        except (KeyError, ValueError, TypeError) as exc:
            self._json({"error": f"bad request body: {exc!r}"}, 400)
            return
        from deeplearning4j_tpu_torch.serving.engine import QueueFullError

        try:
            req = engine.submit_generate(tokens, max_new,
                                         request_id=payload.get("id"))
        except QueueFullError as exc:
            self._json({"error": str(exc)}, 503)
            return
        except (ValueError, RuntimeError) as exc:
            code = 503 if "draining" in str(exc) else 400
            self._json({"error": str(exc)}, code)
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        i = 0
        while True:
            try:
                tok = req.stream.get(timeout=REQUEST_TIMEOUT_S)
            except Exception:
                self._line({"id": req.request_id, "error": "timed out"})
                return
            if tok is None:
                break
            self._line({"token": int(tok), "i": i})
            i += 1
        summary = {"done": True, "id": req.request_id,
                   "tokens": list(req.emitted),
                   "timing": {
                       "queue_s": round(req.t_admitted - req.t_enqueue, 6),
                       "ttft_s": (round(req.t_first_token - req.t_enqueue,
                                        6) if req.t_first_token else None),
                       "total_s": round(req.t_done - req.t_enqueue, 6)}}
        if req.error is not None:
            summary["error"] = req.error
        self._line(summary)

    def _embedding(self, route: str):
        """Embedding lookups and ANN vector search, served by an
        EmbeddingServingEngine (embedding/serving.py). Gated on the
        submit methods the same way /generate gates on
        submit_generate."""
        engine = self.serving.engine
        method = "submit_embed" if route == "/embed" else "submit_search"
        if not hasattr(engine, method):
            self._json({"error": "this engine does not serve embeddings "
                                 "(start an EmbeddingServingEngine)"}, 404)
            return
        if self.serving.draining:
            self._json({"error": "draining; not admitting requests"}, 503)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            if route == "/embed":
                req = engine.submit_embed(payload["ids"],
                                          request_id=payload.get("id"))
            else:
                queries = payload.get("vectors", payload.get("vector"))
                if queries is None:
                    raise KeyError("vector")
                req = engine.submit_search(queries, k=payload.get("k"),
                                           request_id=payload.get("id"))
        except (KeyError, ValueError, TypeError) as exc:
            self._json({"error": f"bad request body: {exc!r}"}, 400)
            return
        except RuntimeError as exc:
            code = 503 if "draining" in str(exc) else 400
            self._json({"error": str(exc)}, code)
            return
        if not req.wait(REQUEST_TIMEOUT_S):
            self._json({"id": req.request_id, "error": "timed out"}, 504)
            return
        if req.error is not None:
            self._json({"id": req.request_id, "error": req.error}, 500)
            return
        body = {"id": req.request_id,
                "timing": {"total_s": round(req.t_done - req.t_enqueue, 6)}}
        if route == "/embed":
            body["vectors"] = np.asarray(req.result["vectors"]).tolist()
        else:
            body["ids"] = np.asarray(req.result["ids"]).tolist()
            body["scores"] = np.asarray(req.result["scores"]).tolist()
        self._json(body)

    def _line(self, obj) -> None:
        try:
            self.wfile.write((json.dumps(obj) + "\n").encode())
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away mid-stream; the engine finishes anyway


# the generation step spans whose seconds sample the MFU gauge, and the
# cost-book entry each one ran (the JAX package samples predict
# forwards only)
_STEP_ENTRIES = {"prefill_chunk": "prefill", "decode_step": "decode",
                 "verify_step": "verify"}


def _metrics_mod():
    from deeplearning4j_tpu_torch.telemetry import metrics
    return metrics


def _argmax_last(out: np.ndarray):
    """Class index/indices over the last axis — the `predict` view of
    the raw output ([V] -> int, [T, V] -> [T] ints)."""
    if out.ndim == 0:
        return float(out)
    am = np.argmax(out, axis=-1)
    return int(am) if am.ndim == 0 else am.tolist()


class ServingMetrics:
    """The /metrics backing store for one engine: a MetricsRegistry
    whose request-latency histograms are fed LIVE from the telemetry
    event stream (`Recorder.add_sink` — no log parse, no device sync
    on the scrape path) and whose fleet gauges (queue depth, page-pool
    occupancy, weight generation, per-replica liveness) are scraped
    from `engine.stats()` at collection time."""

    def __init__(self, engine):
        m = _metrics_mod()
        self.engine = engine
        self.registry = m.MetricsRegistry()
        self.requests = self.registry.counter(
            "serving_requests_total",
            "served requests by outcome (ok/error) and kind")
        self.latency = self.registry.histogram(
            "serving_request_latency_seconds",
            "end-to-end request latency (enqueue -> result)")
        self.queue_wait = self.registry.histogram(
            "serving_request_queue_seconds",
            "request wait before its batch cut")
        self.ttft = self.registry.histogram(
            "serving_ttft_seconds",
            "generation time-to-first-token (enqueue -> first token)")
        self.anomalies = self.registry.counter(
            "serving_anomalies_total",
            "anomaly events on the record, by kind")
        self.queue_depth = self.registry.gauge(
            "serving_queue_depth", "pending requests in the batcher")
        self.replicas = self.registry.gauge(
            "serving_replicas", "replica count by lifecycle state")
        self.replica_up = self.registry.gauge(
            "serving_replica_up",
            "1 while the replica is alive and serving traffic")
        self.replica_beat_age = self.registry.gauge(
            "serving_replica_last_beat_age_seconds",
            "seconds since the replica's last heartbeat")
        self.weight_generation = self.registry.gauge(
            "serving_weight_generation",
            "published WeightStore generation (hot-swap flips bump it)")
        self.weight_step = self.registry.gauge(
            "serving_weight_step",
            "training step of the published weight set")
        self.pool_pages = self.registry.gauge(
            "serving_page_pool_pages",
            "KV-cache page pool occupancy (in_use/total/peak)")
        self.trace_count = self.registry.gauge(
            "serving_trace_count",
            "compiled-trace count (frozen after warmup: any growth "
            "mid-traffic is a retrace)")
        self.pool_occupancy = self.registry.gauge(
            "serving_page_occupancy_ratio",
            "KV-cache page pool fill fraction (pages_in_use / "
            "pages_total) per replica")
        self.spec_accepted = self.registry.gauge(
            "serving_speculative_accepted_tokens_per_step",
            "running mean tokens emitted per verify step per active "
            "slot (1.0 = the non-speculative floor)")
        self.spec_acceptance = self.registry.gauge(
            "serving_speculative_acceptance_rate",
            "fraction of offered draft tokens the verify step accepted")
        self.hbm_live = self.registry.gauge(
            "serving_hbm_live_bytes",
            "total live device bytes (the card's allocated bytes) from "
            "the engine's memory sampler")
        self.hbm_limit = self.registry.gauge(
            "serving_hbm_limit_bytes",
            "per-device memory capacity (absent off the card)")
        self.hbm_headroom = self.registry.gauge(
            "serving_hbm_headroom_ratio",
            "per-device 1 - bytes_in_use/bytes_limit, the autoscaler's "
            "memory signal (absent off the card)")
        self.ledger_bytes = self.registry.gauge(
            "serving_memory_ledger_bytes",
            "live bytes attributed per subsystem (params/opt_state/"
            "kv_pages/prefetch/activations/other)")
        self.mfu_live = self.registry.gauge(
            "serving_mfu_live",
            "model FLOPs utilization over recent forwards and steps: "
            "cost-book flops / measured seconds / device peak FLOPs")
        # recent MFU samples, appended by on_event; the gauge publishes
        # their mean at collection time
        from collections import deque
        self._mfu_window = deque(maxlen=64)
        # the embedding engine's data movement: one latency histogram
        # per span kind plus a bytes-moved counter, fed live off the
        # span events like the request latencies
        self.embed_spans = {
            name: self.registry.histogram(
                f"serving_embedding_{name}_seconds",
                f"embedding-engine {name} span wall time")
            for name in ("gather", "scatter_add", "ann_probe")}
        self.embed_bytes = self.registry.counter(
            "serving_embedding_bytes_total",
            "bytes moved by embedding-engine spans, by span kind")
        self.registry.add_collector(self._collect)

    # ------------------------------------------------------- live events
    def on_event(self, ev: dict) -> None:
        """The recorder sink: request events feed the latency histograms
        on the emitting thread; anomaly events bump their counter;
        embedding spans feed their histogram and the bytes counter."""
        kind = ev.get("event")
        if kind == "request":
            outcome = "ok" if ev.get("ok") else "error"
            self.registry.inc(self.requests, 1.0, outcome=outcome,
                              kind=str(ev.get("kind", "predict")))
            if "total_s" in ev:
                self.registry.observe(self.latency, float(ev["total_s"]))
            if "queue_s" in ev:
                self.registry.observe(self.queue_wait,
                                      float(ev["queue_s"]))
            if "ttft_s" in ev:
                self.registry.observe(self.ttft, float(ev["ttft_s"]))
            if "forward_s" in ev and "bucket" in ev:
                self._observe_mfu("forward", ev["bucket"], ev["forward_s"])
        elif kind == "span" and ev.get("name") in _STEP_ENTRIES and \
                ev.get("ok"):
            self._observe_mfu(_STEP_ENTRIES[ev["name"]], ev.get("bucket"),
                              ev.get("seconds"))
        elif kind == "anomaly":
            self.registry.inc(self.anomalies, 1.0,
                              kind=str(ev.get("kind", "unknown")))
        elif kind == "span" and ev.get("name") in self.embed_spans:
            name = ev["name"]
            if "seconds" in ev:
                self.registry.observe(self.embed_spans[name],
                                      float(ev["seconds"]))
            if ev.get("bytes"):
                self.registry.inc(self.embed_bytes, float(ev["bytes"]),
                                  span=str(name))

    def _observe_mfu(self, entry: str, shape, seconds) -> None:
        """One MFU sample: the warmed cost book's flops for the entry
        (and shape, where the event names one) over the measured seconds
        and the device's peak. Dict lookups only."""
        book = getattr(self.engine, "costbook", None)
        peak = float(getattr(self.engine, "peak_flops", 0.0) or 0.0)
        if book is None or peak <= 0.0:
            return
        flops = book.flops(entry, shape)
        seconds = float(seconds or 0.0)
        if flops <= 0.0 or seconds <= 0.0:
            return
        self._mfu_window.append(book.mfu(flops, seconds, peak))

    # ---------------------------------------------------------- scraping
    def _collect(self) -> None:
        stats = self.engine.stats()
        self.queue_depth.set(stats.get("queue_depth", 0))
        self.trace_count.set(stats.get("trace_count", 0))
        weights = stats.get("weights") or {}
        self.weight_generation.set(weights.get("generation", 0))
        self.weight_step.set(weights.get("step", 0))
        states: dict = {}
        self.replica_up.clear()
        self.replica_beat_age.clear()
        for row in stats.get("fleet", []):
            states[row["state"]] = states.get(row["state"], 0) + 1
            idx = str(row.get("index", "?"))
            up = 1.0 if row.get("alive") and row.get("state") == "serving" \
                else 0.0
            self.replica_up.set(up, replica=idx)
            if "last_beat_age_s" in row:
                self.replica_beat_age.set(row["last_beat_age_s"],
                                          replica=idx)
        self.replicas.clear()
        for state, n in states.items():
            self.replicas.set(n, state=state)
        self.pool_pages.clear()
        self.pool_occupancy.clear()
        for i, pool in enumerate(stats.get("page_pools", [])):
            for field in ("pages_in_use", "pages_total", "pages_peak"):
                if field in pool:
                    self.pool_pages.set(pool[field], replica=str(i),
                                        kind=field)
            total = float(pool.get("pages_total", 0) or 0)
            if total:
                self.pool_occupancy.set(
                    float(pool.get("pages_in_use", 0)) / total,
                    replica=str(i))
        spec = stats.get("speculative") or {}
        if spec.get("enabled"):
            self.spec_accepted.set(
                float(spec.get("accepted_tokens_per_step", 0.0)))
            self.spec_acceptance.set(
                float(spec.get("draft_acceptance_rate", 0.0)))
        mem = stats.get("memory") or {}
        if mem:
            self.hbm_live.set(float(mem.get("live_array_bytes", 0)))
            self.ledger_bytes.clear()
            for subsystem, nbytes in (mem.get("ledger") or {}).items():
                self.ledger_bytes.set(float(nbytes),
                                      subsystem=str(subsystem))
            self.hbm_limit.clear()
            self.hbm_headroom.clear()
            for dev, row in (mem.get("devices") or {}).items():
                limit = float(row.get("bytes_limit", 0) or 0)
                if limit > 0:
                    self.hbm_limit.set(limit, device=str(dev))
                    self.hbm_headroom.set(
                        1.0 - float(row.get("bytes_in_use", 0)) / limit,
                        device=str(dev))
        if self._mfu_window:
            window = list(self._mfu_window)
            self.mfu_live.set(sum(window) / len(window))

    def render(self) -> str:
        return self.registry.render()


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog must hold a burst of concurrent connections (the
    # replay client opens up to 32 at once): past the socketserver default
    # of 5 the kernel drops the SYN and the client's retransmit waits a
    # second before the request even reaches the batcher
    request_queue_size = 128


class ServingServer:
    """Facade owning the HTTP listener; the engine is constructed by the
    caller (CLI `serve` or a test) so its lattice/replica/checkpoint
    config stays explicit."""

    def __init__(self, engine, port: int = 0, host: str = "127.0.0.1"):
        self.engine = engine
        self.draining = False
        # the /metrics surface: live latency histograms off the
        # telemetry stream + fleet gauges scraped from engine.stats()
        self.metrics = ServingMetrics(engine)
        recorder = getattr(engine, "recorder", None)
        if recorder is not None and hasattr(recorder, "add_sink"):
            recorder.add_sink(self.metrics.on_event)
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.serving_server = self
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ServingServer":
        self.engine.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="serve-http")
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        """Stop admitting /predict requests; the engine flushes what it
        already accepted (POST /drain, and the first phase of stop())."""
        self.draining = True

    def stop(self, drain_timeout: float = 30.0) -> None:
        """Graceful shutdown: drain the engine (every admitted request
        completes or fails loudly), then close the listener."""
        self.begin_drain()
        self.engine.drain(drain_timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
