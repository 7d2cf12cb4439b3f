"""UI server (JAX counterpart deeplearning4j_tpu/ui/server.py, the same
endpoints and payloads; reference ui/UiServer.java — Dropwizard/Jetty app
hosting weights, flow, activations, tsne, nearestneighbors REST resources;
listeners POST JSON, browser polls GET).

Stdlib ThreadingHTTPServer replacement. Endpoints (all JSON):

    POST /weights/update?sid=S     histogram snapshots (ModelAndGradient)
    GET  /weights/data?sid=S
    POST /flow/update?sid=S        ModelInfo topology beans
    GET  /flow/data?sid=S
    POST /activations/update?sid=S activation means
    GET  /activations/data?sid=S
    POST /tsne/coords?sid=S        [[x, y], ...] embedding coords
    GET  /tsne/data?sid=S
    GET  /weights|/flow|/activations|/tsne?sid=S  — RENDERED live views
         (self-contained HTML + SVG from ui/views.py, auto-refreshing;
         the reference's in-browser histogram/flow/activation/tsne pages)
    GET  /timeline                 the fleet trace-timeline view: merged
         per-process telemetry shards (telemetry/trace.py) rendered as
         span lanes + per-span p50/p99 + anomaly findings; reads the
         path given as UiServer(telemetry_path=...) or the
         DL4J_TPU_TELEMETRY env var
    GET  /timeline/data            the same merged view as JSON
         ({processes, span_stats, anomalies})
    POST /nearestneighbors/vectors labelled vectors {labels, vectors}
    POST /nearestneighbors/query   {word, k} → {words, distances}
    GET  /sessions                 list of session ids
    GET  /                         minimal HTML index

Run with `UiServer(port=0).start()`; `.url` gives the bound address.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from deeplearning4j_tpu_torch.ui.storage import HistoryStorage

_INDEX_HTML = """<!doctype html>
<html><head><title>deeplearning4j_tpu UI</title></head>
<body><h1>deeplearning4j_tpu training UI</h1>
<p>Views: <a href="/weights">weights</a> | <a href="/flow">flow</a> |
<a href="/activations">activations</a> | <a href="/tsne">tsne</a> |
<a href="/timeline">timeline</a>
(append ?sid=&lt;session&gt; to pick a session)</p>
<p>Sessions: <span id="s"></span></p>
<script>
fetch('/sessions').then(r => r.json()).then(d => {
  document.getElementById('s').textContent = d.join(', ');
});
</script></body></html>"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-ui/1.0"

    # quiet request logging (reference logs through slf4j, not stdout)
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    @property
    def ui(self) -> "UiServer":
        return self.server.ui_server

    def _json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _html(self, body: str, code: int = 200) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        from deeplearning4j_tpu_torch.ui import views

        url = urlparse(self.path)
        sid = parse_qs(url.query).get("sid", ["default"])[0]
        route = url.path.rstrip("/")
        if route == "":
            self._html(_INDEX_HTML)
            return
        if route == "/sessions":
            self._json(self.ui.storage.sessions())
            return
        # live in-browser views (the reference's rendered weights/flow/
        # activation/tsne pages) — data views stay on /<kind>/data
        storage = self.ui.storage
        if route == "/weights":
            self._html(views.weights_page(storage.get(sid, "weights"),
                                          storage.history(sid, "weights"),
                                          sid))
            return
        if route == "/flow":
            self._html(views.flow_page(storage.get(sid, "flow"),
                                       storage.history(sid, "flow"), sid))
            return
        if route == "/activations":
            self._html(views.activations_page(
                storage.history(sid, "activations"), sid))
            return
        if route == "/tsne":
            self._html(views.tsne_page(storage.get(sid, "tsne"), sid))
            return
        if route in ("/timeline", "/timeline/data"):
            timeline, anomalies, source = self.ui.load_timeline()
            if route == "/timeline":
                self._html(views.timeline_page(timeline, anomalies,
                                               source))
                return
            from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

            stats = (trace_mod.span_stats(timeline)
                     if timeline is not None else {})
            self._json({
                "source": source,
                "processes": (timeline.processes if timeline is not None
                              else []),
                "span_stats": {f"{p}::{n}": row
                               for (p, n), row in sorted(stats.items())},
                "anomalies": anomalies,
            })
            return
        for kind in ("weights", "flow", "activations", "tsne"):
            if route == f"/{kind}/data":
                self._json(self.ui.storage.get(sid, kind) or {})
                return
            if route == f"/{kind}/history":
                self._json(self.ui.storage.history(sid, kind))
                return
        self._json({"error": f"unknown path {url.path}"}, 404)

    def do_POST(self):  # noqa: N802
        url = urlparse(self.path)
        sid = parse_qs(url.query).get("sid", ["default"])[0]
        route = url.path.rstrip("/")
        try:
            payload = self._read_body()
        except json.JSONDecodeError:
            self._json({"error": "bad json"}, 400)
            return
        for kind in ("weights", "flow", "activations"):
            if route == f"/{kind}/update":
                self.ui.storage.put(sid, kind, payload)
                self._json({"status": "ok"})
                return
        if route == "/tsne/coords":
            self.ui.storage.put(sid, "tsne", payload)
            self._json({"status": "ok"})
            return
        if route == "/nearestneighbors/vectors":
            self.ui.set_vectors(payload["labels"], payload["vectors"])
            self._json({"status": "ok"})
            return
        if route == "/nearestneighbors/query":
            result = self.ui.nearest(payload["word"], int(payload.get("k", 10)))
            if result is None:
                self._json({"error": "unknown word"}, 404)
            else:
                self._json(result)
            return
        self._json({"error": f"unknown path {url.path}"}, 404)


class UiServer:
    """The UI server facade (UiServer.getInstance() in the reference;
    here: instantiate + start/stop)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 telemetry_path: Optional[str] = None):
        self.storage = HistoryStorage()
        # the fleet-timeline source: explicit path beats the env var;
        # None leaves /timeline rendering its setup hint
        self.telemetry_path = telemetry_path
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.ui_server = self
        self._thread: Optional[threading.Thread] = None
        # nearest-neighbors state (reference: VPTree-backed word2vec NN —
        # ui/nearestneighbors; brute-force cosine is exact and fast enough
        # for UI-sized vocabularies, VPTree available for large ones)
        self._nn_lock = threading.Lock()
        self._nn_labels: list[str] = []
        self._nn_vectors: Optional[np.ndarray] = None

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "UiServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    # ------------------------------------------------------ fleet timeline
    def load_timeline(self):
        """(Timeline|None, anomalies, source) for the /timeline views:
        merges the `.pN` shards of the configured telemetry path (ctor
        arg, else DL4J_TPU_TELEMETRY) on every request — the files are
        append-only JSONL, so a refresh IS the live view."""
        import os

        from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
        from deeplearning4j_tpu_torch.telemetry.recorder import ENV_VAR

        path = self.telemetry_path or os.environ.get(ENV_VAR)
        if not path:
            return None, [], "unset"
        try:
            timeline = trace_mod.load_timeline(path)
        except (FileNotFoundError, OSError):
            return None, [], path
        return timeline, trace_mod.detect_anomalies(timeline), path

    # ---------------------------------------------------- nearest neighbors
    def set_vectors(self, labels, vectors) -> None:
        with self._nn_lock:
            self._nn_labels = list(labels)
            v = np.asarray(vectors, dtype=np.float32)
            self._nn_vectors = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)

    def nearest(self, word: str, k: int = 10):
        with self._nn_lock:
            if self._nn_vectors is None or word not in self._nn_labels:
                return None
            i = self._nn_labels.index(word)
            sims = self._nn_vectors @ self._nn_vectors[i]
            sims[i] = -np.inf
            top = np.argsort(-sims)[:k]
            return {
                "words": [self._nn_labels[j] for j in top],
                "similarities": [float(sims[j]) for j in top],
            }
