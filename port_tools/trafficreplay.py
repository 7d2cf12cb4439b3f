#!/usr/bin/env python
"""trafficreplay — the continuous-batching serving bench of the port
(JAX counterpart tools/trafficreplay.py, with the same flags and output,
plus `--device`).

    python port_tools/trafficreplay.py                      # tiny-LM replay
    python port_tools/trafficreplay.py --model mlp --requests 200
    python port_tools/trafficreplay.py --artifact SERVE.json
    python port_tools/trafficreplay.py --generate --checkpoint ckpt_dir
    python port_tools/trafficreplay.py --generate --prompt-lens 8,32 \
        --output-lens 4,16 --slots 4                   # generation replay
    python port_tools/trafficreplay.py --chaos r0:kill@batch4  # self-healing
    python port_tools/trafficreplay.py --fleet --artifact SERVE_fleet.json
    python port_tools/trafficreplay.py --device cpu         # no card

Replays a SEEDED mixed-length / bursty request trace against a freshly
started serving stack of the port (engine + HTTP front door,
deeplearning4j_tpu_torch/serving/), drains, and reports sustained QPS
plus p50/p99 latency reconstructed from the telemetry `request` events
ALONE — the JSONL log, not any in-process timer, is the source of
truth, so the same numbers rebuild from the artifact after a crash or a
stdout truncation.

`--generate` replays the AUTOREGRESSIVE trace instead (GenerationEngine:
prefill/decode split over the paged KV cache): a seeded prompt-length x
output-length mix streamed through POST /generate, with headline
tokens/sec (higher-is-better), time-to-first-token p50/p99 and peak
cache-page occupancy (both lower-is-better), and the zero-retrace row.
`--checkpoint` names a checkpoint directory of the port
(deeplearning4j_tpu_torch/util/checkpoint.py; the JAX tool takes an
Orbax one): the predict replay restores its tiny net from it, and the
generation replay serves the net of the checkpoint's own configuration.

`--chaos SPEC` injects replica-scoped faults (the distributed/faults.py
grammar: `r0:kill@batch4`, `r1:hang@batch2`, `;`-joined) into the
replay's serving replicas, with a live FleetSupervisor healing them.
`--fleet` runs the zero-downtime operations bench instead
(serving/fleet.py): the same bursty trace through a fixed-replica arm
and an autoscaling arm that also absorbs a replica kill and a
mid-traffic weight hot-swap.

The replay runs on the card (`--device cuda`, the default) and exits
with code 2 and a message when no CUDA device is present; `--device
cpu` runs it on the CPU.

Output: one JSON metric line per number ending with the gate-carrying
summary line (its `telemetry` field names the JSONL, which
port_tools/tracetool.py reads); `--artifact` also writes them as a SERVE
artifact. Exit code 0 unless the replay could not run at all or no
request completed. It imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trafficreplay", description=__doc__)
    ap.add_argument("--model", choices=("lm", "mlp"), default="lm",
                    help="tiny transformer LM (mixed-length sequences; "
                         "default) or fixed-shape MLP")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--burst", type=int, default=4,
                    help="requests per arrival burst")
    ap.add_argument("--mean-gap-ms", type=float, default=2.0,
                    help="mean inter-burst gap (the trace's rate knob)")
    ap.add_argument("--lens", default="8,16,32",
                    help="comma list of request sequence lengths "
                         "(lm model; also the seq bucket lattice)")
    ap.add_argument("--buckets", default="1,2,4",
                    help="comma list of batch-size buckets")
    ap.add_argument("--max-wait-ms", type=float, default=4.0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory of the port "
                         "(util/checkpoint.py) to serve the net from")
    ap.add_argument("--artifact", default=None,
                    help="write the SERVE artifact (metric lines + "
                         "summary) here")
    ap.add_argument("--telemetry", default=None,
                    help="telemetry JSONL path (default: a temp file; "
                         "the scoreboard is reconstructed from it)")
    ap.add_argument("--generate", action="store_true",
                    help="replay the autoregressive generation trace "
                         "(prefill/decode split, paged KV cache) "
                         "instead of one-shot predict")
    ap.add_argument("--prompt-lens", default="8,16,32",
                    help="generation trace prompt lengths (also the "
                         "prefill bucket lattice)")
    ap.add_argument("--output-lens", default="4,8,16",
                    help="generation trace output-token budgets")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots per generation replica")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size (tokens per page)")
    ap.add_argument("--speculative-k", type=int, default=0,
                    help="speculative decode window width for "
                         "--generate (0 = off; >= 2 drafts k-1 tokens "
                         "per slot and verifies the window in one step)")
    ap.add_argument("--kv-dtype", choices=("f32", "int8"), default="f32",
                    help="KV-cache storage dtype for --generate "
                         "(int8 = per-page-scale quantized pages)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="replica-scoped fault spec(s) to inject "
                         "(distributed/faults.py grammar, e.g. "
                         "'r0:kill@batch4'); a FleetSupervisor heals "
                         "them live during the replay")
    ap.add_argument("--fleet", action="store_true",
                    help="run the zero-downtime fleet-operations bench "
                         "(fixed vs autoscaling arm, replica-kill chaos "
                         "+ mid-traffic hot-swap; SERVE_r03 artifact)")
    ap.add_argument("--autoscale-max", type=int, default=3,
                    help="autoscaling arm's replica ceiling (--fleet)")
    ap.add_argument("--device", default="cuda",
                    help="device the served nets run on (default cuda; "
                         "cpu runs the replay without a card)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.stderr.write("trafficreplay: no CUDA device; pass --device "
                         "cpu to replay on the CPU\n")
        return 2
    from deeplearning4j_tpu_torch.serving.replay import (
        run_fleet_replay,
        run_generation_replay,
        run_replay,
    )

    tpath = args.telemetry or os.path.join(
        tempfile.mkdtemp(prefix="trafficreplay_"), "telemetry.jsonl")
    if args.fleet:
        scoreboard = run_fleet_replay(
            seed=args.seed, n_requests=args.requests, burst=args.burst,
            mean_gap_s=args.mean_gap_ms / 1000.0,
            batch_sizes=tuple(int(b) for b in args.buckets.split(",")),
            max_wait_ms=args.max_wait_ms,
            autoscale_max=args.autoscale_max,
            chaos=args.chaos or "r0:kill@batch4",
            telemetry_path=tpath, artifact_path=args.artifact,
            emit=lambda line: print(json.dumps(line), flush=True),
            device=device)
    elif args.generate:
        scoreboard = run_generation_replay(
            seed=args.seed, n_requests=args.requests, burst=args.burst,
            mean_gap_s=args.mean_gap_ms / 1000.0,
            prompt_lengths=tuple(int(t)
                                 for t in args.prompt_lens.split(",")),
            output_lengths=tuple(int(t)
                                 for t in args.output_lens.split(",")),
            slots=args.slots, page_size=args.page_size,
            speculative_k=args.speculative_k, kv_dtype=args.kv_dtype,
            replicas=args.replicas, telemetry_path=tpath,
            artifact_path=args.artifact, checkpoint=args.checkpoint,
            emit=lambda line: print(json.dumps(line), flush=True),
            device=device)
    else:
        scoreboard = run_replay(
            model=args.model, seed=args.seed, n_requests=args.requests,
            burst=args.burst, mean_gap_s=args.mean_gap_ms / 1000.0,
            lengths=tuple(int(t) for t in args.lens.split(",")),
            batch_sizes=tuple(int(b) for b in args.buckets.split(",")),
            max_wait_ms=args.max_wait_ms, replicas=args.replicas,
            telemetry_path=tpath, artifact_path=args.artifact,
            checkpoint=args.checkpoint, chaos=args.chaos,
            emit=lambda line: print(json.dumps(line), flush=True),
            device=device)
    from deeplearning4j_tpu_torch.telemetry.artifact import build_summary

    summary = build_summary(scoreboard["lines"])
    summary["telemetry"] = tpath
    print(json.dumps(summary), flush=True)
    if scoreboard["n_ok"] == 0:
        sys.stderr.write("trafficreplay: no request completed\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
