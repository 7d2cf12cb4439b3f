"""CLI driver of the port: train / test / predict on config files and
CSV/SVMLight input, serve, plan and reshard (JAX counterpart
deeplearning4j_tpu/cli/driver.py; reference:
cli/driver/CommandLineInterfaceDriver.java routing to
subcommands/Train.java:66 with flags -conf -input -output -model -type
:80-108, Test.java, Predict.java).

Every subcommand takes the JAX CLI's flags, plus `--device {cuda,cpu}`
(default cuda: nothing falls back to the CPU when no card is found).
Models are `ModelSerializer` zips (util/model_serializer.py), which the
JAX CLI reads and writes too.

Usage:
    python -m deeplearning4j_tpu_torch.cli train --conf conf.json \
        --input d.csv --model out.zip --num-classes 3 [--epochs 5] \
        [--batch 32] [--device cpu]
    python -m deeplearning4j_tpu_torch.cli test --model out.zip \
        --input d.csv --num-classes 3
    python -m deeplearning4j_tpu_torch.cli predict --model out.zip \
        --input d.csv --output preds.csv

Serving (serving/):

    python -m deeplearning4j_tpu_torch.cli serve --model out.zip \
        --port 9090 --buckets 1,2,4,8 --max-wait-ms 5 [--replicas 2] \
        [--warmup-features 0,0,0,...]
    python -m deeplearning4j_tpu_torch.cli predict \
        --server http://host:9090 --input d.csv --output preds.csv
    python -m deeplearning4j_tpu_torch.cli serve --model lm.zip \
        --buckets 1x64,1x256 --generate-slots 4 --max-new-tokens 64
                                         # POST /generate

Resharding and placement search (reshard/), dry runs:

    python -m deeplearning4j_tpu_torch.cli reshard --checkpoint ckpt_dir \
        --target-mesh data=1
    python -m deeplearning4j_tpu_torch.cli plan --model lm --fleet 1x4

Distributed runtimes. A port process owns one device, so a mesh spans
processes of one process group:

    ... train --mesh data=2 --multiprocess 2 ...   # print the launch plan
    python -m deeplearning4j_tpu_torch.cli coordinator [--port P]
    ... train --cluster HOST:PORT --num-workers 2 [--worker-id w0] \
        [--sync-every 1] [--checkpoint ck_dir] ...

Telemetry: `DL4J_TPU_TELEMETRY=<path>` records the run's JSONL events
(`memory` events at the `DL4J_TPU_MEM_EVERY` step cadence, a `cost`
event for the first step of each batch shape; telemetry/).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


class MeshTooLarge(SystemExit):
    """A `--mesh` whose size exceeds the process group's world size: a
    port process owns one device, so the fleet must have a process for
    every mesh position (`--multiprocess N` prints its launch plan)."""


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch",
        description="Train/test/predict on declarative model configs")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, model_required=True):
        sp.add_argument("--input", "-i", required=True,
                        help="input data file (CSV or SVMLight)")
        sp.add_argument("--format", choices=["csv", "svmlight"],
                        default="csv", help="input format (default csv)")
        sp.add_argument("--model", "-m", required=model_required,
                        help="model zip path")
        sp.add_argument("--batch", type=int, default=32)
        sp.add_argument("--label-index", type=int, default=-1,
                        help="label column in CSV (default: last)")
        sp.add_argument("--num-features", type=int, default=0,
                        help="feature count (required for svmlight)")
        sp.add_argument("--num-classes", type=int, default=-1,
                        help="one-hot classes; omit for regression input")
        sp.add_argument("--regression", action="store_true")

    t = sub.add_parser("train", help="fit a model config on a dataset")
    t.add_argument("--conf", "-c", required=True,
                   help="model configuration JSON "
                        "(MultiLayerConfiguration or ComputationGraph)")
    t.add_argument("--type", choices=["multi_layer_network",
                                      "computation_graph"],
                   default="multi_layer_network")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--output", "-o", default=None,
                   help="alias of --model for reference-flag parity")
    t.add_argument("--mesh", default=None,
                   help="single-process mesh axes, e.g. data=4 or "
                        "data=2,model=2,pipe=2 (roles: data/model/pipe/"
                        "expert/seq; one process a device: the product "
                        "may not exceed the process group's size, so "
                        "start the fleet with --multiprocess)")
    t.add_argument("--microbatches", type=int, default=None,
                   help="pipeline microbatches (with a pipe mesh axis)")
    t.add_argument("--multiprocess", type=int, default=None, metavar="N",
                   help="dry run: print the N-process local rendezvous "
                        "launch plan (DL4J_TPU_* env contract + one "
                        "command per process, one device each) "
                        "and exit. Run the printed lines — each process "
                        "initializes torch.distributed from the env "
                        "contract — or drive the fleet programmatically "
                        "via deeplearning4j_tpu_torch.distributed."
                        "launch_local")
    t.add_argument("--local-devices", type=int, default=4,
                   help="the JAX CLI's virtual devices per process "
                        "(a port process owns one device: ignored)")
    t.add_argument("--cluster", default=None,
                   help="coordinator HOST:PORT for multi-process elastic "
                        "data-parallel training (parameter averaging)")
    t.add_argument("--num-workers", type=int, default=1,
                   help="expected cluster size (data shards by rank)")
    t.add_argument("--worker-id", default=None,
                   help="stable worker id (default: host-pid)")
    t.add_argument("--sync-every", type=int, default=1,
                   help="local steps between cluster averaging rounds")
    t.add_argument("--checkpoint", default=None,
                   help="worker checkpoint directory "
                        "(util/checkpoint.py; elastic restart resumes)")
    t.add_argument("--prefetch-depth", type=int, default=None,
                   metavar="K",
                   help="input-pipeline queue depth (device-resident "
                        "batches prefetched ahead of the step loop; "
                        "0 = synchronous, default 2 — "
                        "data/pipeline.py)")
    common(t, model_required=False)

    co = sub.add_parser("coordinator",
                        help="run the cluster coordinator (registry + "
                             "heartbeats + averaging rounds)")
    co.add_argument("--host", default="0.0.0.0")
    co.add_argument("--port", type=int, default=9085)
    co.add_argument("--heartbeat-timeout", type=float, default=10.0)

    te = sub.add_parser("test", help="evaluate a trained model")
    common(te)

    pr = sub.add_parser("predict", help="write predictions for a dataset")
    pr.add_argument("--output", "-o", required=True,
                    help="predictions output CSV")
    pr.add_argument("--server", default=None, metavar="URL",
                    help="POST rows to a running `serve` instance "
                         "(http://host:port) instead of loading the "
                         "model in-process — rows ride the server's "
                         "continuous batcher")
    common(pr, model_required=False)

    sv = sub.add_parser(
        "serve", help="continuous-batching inference server "
                      "(serving/: bucket lattice + dynamic batching + "
                      "replica dispatch over HTTP)")
    sv.add_argument("--port", type=int, default=9090)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--model", "-m", default=None,
                    help="model zip to serve (ModelSerializer format)")
    sv.add_argument("--conf", "-c", default=None,
                    help="model configuration JSON (with --checkpoint: "
                         "build the net, then resume its params)")
    sv.add_argument("--type", choices=["multi_layer_network",
                                       "computation_graph"],
                    default="multi_layer_network")
    sv.add_argument("--checkpoint", default=None,
                    help="checkpoint dir (util/checkpoint.py) to resume "
                         "from at startup. The checkpoint may have been "
                         "written under any training placement: it "
                         "holds the canonical trees, which restore into "
                         "this serving process")
    sv.add_argument("--buckets", default="1,2,4,8",
                    help="padding-bucket lattice: batch sizes "
                         "('1,2,4,8') or explicit BxT pairs "
                         "('1x64,4x64,4x256') for sequence models")
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batcher deadline: the longest a request waits "
                         "for coalescing before its batch cuts")
    sv.add_argument("--replicas", type=int, default=1,
                    help="forward workers (round-robin dispatch)")
    sv.add_argument("--sequence", action="store_true",
                    help="requests are variable-length sequences (padded "
                         "to seq buckets with a validity mask)")
    sv.add_argument("--warmup-features", default=None,
                    help="example request row (comma floats, or ints for "
                         "token models) to warm every bucket before "
                         "traffic; required for the zero-retrace promise")
    sv.add_argument("--generate-slots", type=int, default=0, metavar="N",
                    help="serve autoregressive generation instead of "
                         "one-shot predict: a GenerationEngine with N "
                         "decode slots per replica (prefill/decode "
                         "split over a paged KV cache; POST /generate "
                         "streams tokens). Needs a BxT --buckets "
                         "lattice; warmup is automatic")
    sv.add_argument("--max-new-tokens", type=int, default=64,
                    help="generation output budget per request (also "
                         "sizes the KV cache: capacity = max prompt "
                         "bucket + this, page-quantized)")
    sv.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size in tokens "
                         "(serving/kvcache.py accounting grid)")
    sv.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt chunk length for interleaved prefill "
                         "(a lattice seq bucket; default: the largest)")
    sv.add_argument("--speculative-k", type=int, default=0, metavar="K",
                    help="speculative decode window width (0 = off; "
                         ">= 2: an n-gram proposer drafts K-1 tokens "
                         "per slot and ONE fixed-shape verify step "
                         "checks the window — greedy output stays "
                         "bit-identical, accepted drafts cut steps)")
    sv.add_argument("--kv-dtype", choices=["f32", "int8"], default="f32",
                    help="KV-cache storage dtype: int8 stores "
                         "per-page-scale quantized pages (~4x more "
                         "decode slots per HBM byte, greedy-parity "
                         "gated in the serving bench)")
    sv.add_argument("--watch-checkpoint", action="store_true",
                    help="fleet operations: keep watching --checkpoint "
                         "for newly committed steps and hot-swap each "
                         "one live (serving/fleet.CheckpointWatcher — "
                         "double-buffered restore off the request path, "
                         "atomic flip, zero dropped requests; a step "
                         "failing validation is rejected with the old "
                         "weights still serving)")
    sv.add_argument("--autoscale-max", type=int, default=0, metavar="N",
                    help="fleet operations: run a FleetSupervisor that "
                         "heals dead replicas and autoscales between "
                         "--replicas and N replicas from telemetry "
                         "queue-depth/p99 (0 = self-healing only, no "
                         "autoscaling)")
    sv.add_argument("--chaos", default=None, metavar="SPEC",
                    help="inject replica-scoped faults (distributed/"
                         "faults.py grammar, e.g. 'r0:kill@batch4') — "
                         "the self-healing demo/test hook")
    sv.add_argument("--multiprocess", type=int, default=None, metavar="N",
                    help="dry run: print the N-process serving fleet "
                         "plan (one engine per process on the "
                         "distributed runtime's env contract, ports "
                         "--port..--port+N-1) and exit")
    sv.add_argument("--local-devices", type=int, default=4,
                    help="the JAX CLI's virtual devices per process "
                         "(a port process owns one device: ignored)")

    pl = sub.add_parser(
        "plan", help="dry-run the automatic placement search "
                     "(reshard/search.py): enumerate every valid "
                     "dp x tp x pp x sp x ep placement for a model + "
                     "fleet shape, rank them with the per-step cost "
                     "model, and print the top-k table with the score "
                     "breakdown (memory, collective bytes, bubble). "
                     "Nothing is placed: the search is a pure function "
                     "and builtin profiles build no net")
    pl.add_argument("--model", "-m", default=None,
                    help="builtin profile name (mlp, lm) or "
                         "a trained model zip to profile")
    pl.add_argument("--conf", "-c", default=None,
                    help="model configuration JSON to profile instead "
                         "of --model")
    pl.add_argument("--type", choices=["multi_layer_network",
                                       "computation_graph"],
                    default="multi_layer_network")
    pl.add_argument("--fleet", required=True,
                    help="fleet shape PxK (processes x devices each), "
                         "e.g. 2x4; plain N means 1xN")
    pl.add_argument("--global-batch", type=int, default=None,
                    help="per-step global batch the cost model sizes "
                         "activations and microbatches with")
    pl.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device HBM budget in GiB; candidates "
                         "whose memory estimate exceeds it are pruned")
    pl.add_argument("--no-zero1", action="store_true",
                    help="drop the zero1 weight-update-sharding "
                         "variants from the candidate set")
    pl.add_argument("--top", type=int, default=5,
                    help="table rows to print (default 5)")
    pl.add_argument("--artifact", default=None,
                    help="also write the ranked scores as a PLAN "
                         "artifact (JSONL) for tools/benchdiff")

    rs = sub.add_parser(
        "reshard", help="dry-run the portable resharding planner: map a "
                        "checkpoint's recorded placement onto a target "
                        "mesh and print the per-action plan with bytes "
                        "moved vs the lower bound (reshard/planner.py; "
                        "nothing is restored or written)")
    rs.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (util/checkpoint.py "
                         "layout; the step's meta.json carries the "
                         "source placement)")
    rs.add_argument("--target-mesh", required=True,
                    help="target mesh axes, e.g. data=1 or "
                         "data=2,model=2 (same role grammar as train "
                         "--mesh; purely planned — no devices needed)")
    rs.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    rs.add_argument("--processes", type=int, default=1,
                    help="target process count (default 1 — the serve "
                         "case)")
    rs.add_argument("--zero1", action="store_true",
                    help="plan zero1 optimizer-state shardings on the "
                         "target data axis")
    rs.add_argument("--artifact", default=None,
                    help="also write the metric lines + summary as a "
                         "RESHARD artifact (JSONL) for tools/benchdiff")
    for sp in (t, te, pr, sv, pl, rs):
        sp.add_argument("--device", choices=["cuda", "cpu"],
                        default="cuda",
                        help="the device this process runs on (default "
                             "cuda; nothing falls back to the CPU)")
    return p


def _fetch_input(path: str) -> str:
    """Resolve a possibly remote input (`gs://...`) to a local file
    through datasets/cloud.GcsDownloader; a local path passes through."""
    from deeplearning4j_tpu_torch.datasets.cloud import (GcsDownloader,
                                                         _is_remote)

    if _is_remote(path):
        return GcsDownloader().download(path)
    return path


def _put_output(local_path: str, dest: str) -> None:
    """Upload a saved model when the destination is remote."""
    from deeplearning4j_tpu_torch.datasets.cloud import (GcsUploader,
                                                         _is_remote)

    if _is_remote(dest):
        GcsUploader().upload(local_path, dest)


def _make_iterator(args):
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
        SVMLightRecordReader,
    )

    args.input = _fetch_input(args.input)
    if args.format == "svmlight":
        if args.num_features <= 0:
            raise SystemExit("--num-features is required for svmlight input")
        reader = SVMLightRecordReader(args.input, args.num_features)
    else:
        reader = CSVRecordReader(args.input)
    return RecordReaderDataSetIterator(
        reader, args.batch,
        label_index=args.label_index,
        num_classes=args.num_classes,
        regression=args.regression)


def _load_model(path: str, device):
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    return ModelSerializer.restore(_fetch_input(path), device=device)


def _net_from_conf(conf_json: str, kind: str, device):
    """A network of the configuration JSON: `kind` is the --type value
    or a checkpoint's "ComputationGraph" / "MultiLayerNetwork"."""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if kind in ("computation_graph", "ComputationGraph"):
        return ComputationGraph(
            ComputationGraphConfiguration.from_json(conf_json),
            device=device)
    return MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                             device=device)


def _read_conf(path: str) -> str:
    with open(_fetch_input(path)) as f:
        return f.read()


def _parse_mesh(spec: str):
    """'data=2,model=2' -> {"data": 2, "model": 2} (ordered)."""
    axes = {}
    for part in spec.split(","):
        if "=" not in part:
            raise SystemExit(f"bad --mesh entry {part!r}; expected role=N")
        role, _, n = part.partition("=")
        role = role.strip()
        if role not in ("data", "model", "pipe", "expert", "seq"):
            raise SystemExit(f"unknown mesh role {role!r} "
                             "(valid: data, model, pipe, expert, seq)")
        try:
            size = int(n)
        except ValueError:
            raise SystemExit(f"bad --mesh size {n!r} for {role}; "
                             "expected a positive integer") from None
        if size < 1:
            raise SystemExit(f"--mesh {role}={size}: size must be >= 1")
        axes[role] = size
    return axes


def _apply_mesh(net, args) -> None:
    """Route --mesh through the unified set_mesh entry point
    (parallel/placement.py) over the process group's ranks, one device a
    rank."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    axes = _parse_mesh(args.mesh)
    need = int(np.prod(list(axes.values())))
    have = dist.get_world_size() if bootstrap.is_initialized() else 1
    if need > have:
        raise MeshTooLarge(
            f"--mesh {args.mesh} needs {need} processes but the process "
            f"group has {have}: a port process owns one device, so start "
            f"{need} processes (--multiprocess {need} prints their launch "
            "plan)")
    mesh = make_mesh(axes, device=args.device)
    net.set_mesh(mesh, axes={r: r for r in axes},
                 n_microbatches=args.microbatches)
    print(f"mesh: {dict(axes)} over {need} {args.device} processes")


def _scrub_multiprocess_argv(argv) -> list:
    """The per-process command of a --multiprocess plan is this same CLI
    invocation minus the plan flags themselves (a spawned process must
    train, not print another plan)."""
    out = []
    skip = False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok in ("--multiprocess", "--local-devices"):
            skip = True
            continue
        if tok.startswith(("--multiprocess=", "--local-devices=")):
            continue
        out.append(tok)
    return out


def _print_multiprocess_plan(args) -> int:
    """`train --multiprocess N` dry run: the copy-pastable local fleet,
    one process a device on the rendezvous env contract."""
    from deeplearning4j_tpu_torch.distributed.launcher import launch_plan

    worker_argv = ([sys.executable, "-m", "deeplearning4j_tpu_torch.cli"]
                   + _scrub_multiprocess_argv(args._raw_argv))
    print(f"# {args.multiprocess}-process local rendezvous fleet (one "
          f"{args.device} device each); run these lines from the repo "
          "root:")
    for line in launch_plan(worker_argv, args.multiprocess,
                            device=args.device):
        print(line)
    return 0


def _train_on_cluster(net, args, it) -> None:
    """Multi-process elastic parameter-averaging worker (reference
    cli-spark/SparkTrain.java): register with the coordinator, wait for
    the expected fleet, claim a shard slot, then run the elastic
    averaging loop over this worker's batches."""
    import socket
    import time

    from deeplearning4j_tpu_torch.parallel.cluster import (
        ClusterClient,
        run_elastic_worker,
    )

    worker_id = args.worker_id or f"{socket.gethostname()}-{os.getpid()}"
    probe = ClusterClient(args.cluster, worker_id)
    try:
        deadline = time.monotonic() + 120
        while len(probe.workers()) < args.num_workers:
            if time.monotonic() > deadline:
                raise SystemExit(
                    f"cluster at {args.cluster} has {len(probe.workers())} "
                    f"workers; expected {args.num_workers}")
            time.sleep(0.2)
        # claim a shard slot atomically on the coordinator: a replaced
        # worker's fresh rank modulo num_workers could collide with a
        # survivor's
        while True:
            shard_idx = probe.claim_slot(args.num_workers)
            if shard_idx is not None:
                break
            if time.monotonic() > deadline:
                raise SystemExit(f"no free shard slot at {args.cluster}")
            time.sleep(0.5)
        batches = [ds for i, ds in enumerate(it)
                   if i % args.num_workers == shard_idx]
    except BaseException:
        # the claim survives one heartbeat_timeout for a same-id restart
        probe.close(deregister=False)
        raise
    print(f"worker {worker_id} shard {shard_idx}: {len(batches)} local batches")
    # the live probe keeps heartbeating the claimed slot through setup
    run_elastic_worker(args.cluster, worker_id, net, batches,
                       sync_every=args.sync_every,
                       checkpoint_path=args.checkpoint, epochs=args.epochs,
                       client=probe)


def _bring_up(args) -> None:
    """A spawned fleet member (the env contract of the launcher or a
    printed --multiprocess plan line): torch.distributed comes up before
    any mesh is built."""
    from deeplearning4j_tpu_torch.distributed import bootstrap

    if bootstrap.env_contract_present():
        bootstrap.initialize(device=args.device)


def _cmd_train(args) -> int:
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ScoreIterationListener,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer,
    )

    if args.mesh and args.cluster:
        raise SystemExit("--mesh (one process group) and --cluster "
                         "(multi-process averaging) are separate runtimes; "
                         "pick one per process")
    if args.multiprocess:
        return _print_multiprocess_plan(args)
    _bring_up(args)
    net = _net_from_conf(_read_conf(args.conf), args.type, args.device)
    net.init()
    net.set_listeners(ScoreIterationListener(10, printer=print))
    if args.mesh:
        _apply_mesh(net, args)
    if args.prefetch_depth is not None:
        from deeplearning4j_tpu_torch.data.pipeline import set_prefetch_depth

        set_prefetch_depth(args.prefetch_depth)

    it = _make_iterator(args)
    if args.cluster:
        _train_on_cluster(net, args, it)
    else:
        # under a mesh every rank reads the same input file and each
        # keeps its rows of every batch (set_mesh: fit takes the global
        # batch)
        net.fit(it, epochs=args.epochs)

    out = args.model or args.output
    if not out:
        raise SystemExit("need --model (or --output) to save the trained model")
    from deeplearning4j_tpu_torch.datasets.cloud import _is_remote

    if _is_remote(out):
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            local = os.path.join(td, "model.zip")
            ModelSerializer.write_model(net, local)
            _put_output(local, out)
    else:
        # under a mesh every rank gathers and rank 0 writes
        ModelSerializer.write_model(net, out)
    print(f"model saved to {out}")
    return 0


def _cmd_coordinator(args) -> int:
    import threading

    from deeplearning4j_tpu_torch.parallel.cluster import ClusterCoordinator

    coord = ClusterCoordinator(host=args.host, port=args.port,
                               heartbeat_timeout=args.heartbeat_timeout)
    coord.start()
    try:
        # announced inside the try: a caller may interrupt as soon as it
        # reads the line
        print(f"coordinator listening on {coord.address}", flush=True)
        threading.Event().wait()
    except KeyboardInterrupt:
        coord.shutdown()
    return 0


def _serve_multiprocess_plan(args) -> int:
    """`serve --multiprocess N` dry run: one serving process per rank on
    the distributed runtime's env contract (per-process telemetry
    suffixes ride it), each behind its own port."""
    from deeplearning4j_tpu_torch.distributed.launcher import (free_port,
                                                               launch_plan)

    base = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli"]
    scrubbed = _scrub_multiprocess_argv(args._raw_argv)
    # each rank serves its own port: strip any --port from the shared
    # argv and append the per-rank one
    core = []
    skip = False
    for tok in scrubbed:
        if skip:
            skip = False
            continue
        if tok == "--port":
            skip = True
            continue
        if tok.startswith("--port="):
            continue
        core.append(tok)
    coordinator = f"127.0.0.1:{free_port()}"
    print(f"# {args.multiprocess}-process serving fleet "
          f"(ports {args.port}..{args.port + args.multiprocess - 1}); "
          "run these lines from the repo root:")
    lines = []
    for i in range(args.multiprocess):
        plan = launch_plan(base + core + ["--port", str(args.port + i)],
                           args.multiprocess, device=args.device,
                           coordinator=coordinator)
        lines.append(plan[i])
    for line in lines + ["wait"]:
        print(line)
    return 0


def _parse_warmup_features(spec: str, sequence: bool):
    vals = [v.strip() for v in spec.split(",") if v.strip()]
    try:
        return np.asarray([int(v) for v in vals],
                          np.int32 if sequence else np.float32)
    except ValueError:
        return np.asarray([float(v) for v in vals], np.float32)


def build_serving(args):
    """(engine, supervisor, watcher) of a `serve` invocation, warmed and
    not yet behind HTTP."""
    from deeplearning4j_tpu_torch.serving import (BucketLattice,
                                                  InferenceEngine)

    if bool(args.model) == bool(args.conf):
        raise SystemExit("serve needs exactly one of --model (a trained "
                         "zip) or --conf (a config JSON, optionally with "
                         "--checkpoint to resume params)")
    _bring_up(args)
    if args.model:
        net = _load_model(args.model, args.device)
    else:
        net = _net_from_conf(_read_conf(args.conf), args.type, args.device)
        net.init()
    lattice = BucketLattice.from_spec(args.buckets)
    if args.generate_slots > 0:
        from deeplearning4j_tpu_torch.serving import GenerationEngine

        engine = GenerationEngine(
            net, lattice, slots=args.generate_slots,
            max_new_tokens=args.max_new_tokens,
            page_size=args.page_size,
            prefill_chunk=args.prefill_chunk,
            speculative_k=args.speculative_k, kv_dtype=args.kv_dtype,
            replicas=args.replicas, checkpoint=args.checkpoint,
            faults=args.chaos)
        n = engine.warmup()
        print(f"warmed {n} prefill/decode shapes")
    else:
        engine = InferenceEngine(net, lattice, replicas=args.replicas,
                                 max_wait_ms=args.max_wait_ms,
                                 sequence=args.sequence,
                                 checkpoint=args.checkpoint,
                                 faults=args.chaos)
        if args.warmup_features:
            n = engine.warmup(_parse_warmup_features(args.warmup_features,
                                                     args.sequence))
            print(f"warmed {n} bucket shapes")
    supervisor = watcher = None
    if args.autoscale_max or args.chaos:
        from deeplearning4j_tpu_torch.serving import (AutoscalePolicy,
                                                      FleetSupervisor)

        policy = None
        if args.autoscale_max:
            policy = AutoscalePolicy(min_replicas=args.replicas,
                                     max_replicas=args.autoscale_max)
        supervisor = FleetSupervisor(engine, policy=policy).run_in_thread()
        print("fleet supervisor up"
              + (f" (autoscale {args.replicas}..{args.autoscale_max})"
                 if policy else " (self-healing only)"), flush=True)
    if args.watch_checkpoint:
        if not args.checkpoint:
            raise SystemExit("--watch-checkpoint needs --checkpoint (the "
                             "directory the training fleet publishes to)")
        from deeplearning4j_tpu_torch.serving import CheckpointWatcher

        watcher = CheckpointWatcher(engine, args.checkpoint).start()
        print(f"hot-swap watcher on {args.checkpoint}", flush=True)
    return engine, supervisor, watcher


def _cmd_serve(args) -> int:
    import threading

    from deeplearning4j_tpu_torch.serving import ServingServer

    if args.multiprocess:
        return _serve_multiprocess_plan(args)
    engine, supervisor, watcher = build_serving(args)
    server = ServingServer(engine, port=args.port, host=args.host).start()
    print(f"serving on {server.url} "
          f"(replicas={args.replicas}, buckets={args.buckets}, "
          f"max-wait={args.max_wait_ms}ms, device={args.device}"
          + (f", generate-slots={args.generate_slots}"
             if args.generate_slots > 0 else "")
          + (f", speculative-k={args.speculative_k}"
             if args.generate_slots > 0 and args.speculative_k >= 2 else "")
          + (f", kv-dtype={args.kv_dtype}"
             if args.generate_slots > 0 and args.kv_dtype != "f32" else "")
          + ")", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        print("draining...", flush=True)
        if watcher is not None:
            watcher.stop()
        if supervisor is not None:
            supervisor.stop()
        server.stop()
    return 0


def _predict_via_server(args, feats) -> "np.ndarray":
    """POST each row to a running `serve` instance; concurrent requests
    let the server's batcher coalesce them (order restored by index)."""
    import concurrent.futures
    import json as _json
    import urllib.request

    url = args.server.rstrip("/")

    def one(i):
        body = _json.dumps({"features": np.asarray(feats[i]).tolist(),
                            "id": f"cli-{i}"}).encode()
        req = urllib.request.Request(
            f"{url}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return _json.loads(resp.read())["output"]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        rows = list(pool.map(one, range(len(feats))))
    return np.asarray(rows, np.float32)


def _plan_profile(args):
    """Resolve `plan`'s model argument: a builtin pure-data profile (no
    net is built), a trained zip, or a config JSON built and profiled
    in-process."""
    from deeplearning4j_tpu_torch.reshard.search import (BUILTIN_PROFILES,
                                                         profile_net)

    if bool(args.model) == bool(args.conf):
        raise SystemExit(
            "plan needs exactly one of --model (a builtin profile name: "
            f"{sorted(BUILTIN_PROFILES)}, or a trained zip) or --conf "
            "(a config JSON)")
    if args.model and args.model in BUILTIN_PROFILES:
        return BUILTIN_PROFILES[args.model]
    if args.model:
        return profile_net(_load_model(args.model, args.device),
                           name=os.path.basename(args.model))
    net = _net_from_conf(_read_conf(args.conf), args.type, args.device)
    return profile_net(net.init(), name=os.path.basename(args.conf))


def _emit_lines(lines, artifact, what) -> None:
    """Print the metric lines and their summary; write them as an
    artifact (JSONL) when asked."""
    import json as _json

    from deeplearning4j_tpu_torch.telemetry.artifact import build_summary

    out = [_json.dumps(line) for line in lines]
    out.append(_json.dumps(build_summary(lines)))
    for line in out:
        print(line)
    if artifact:
        with open(artifact, "w") as fh:
            fh.write("\n".join(out) + "\n")
        print(f"# wrote {what} artifact to {artifact}")


def _cmd_plan(args) -> int:
    """`plan --model --fleet` dry run: the ranked placement table with
    its score breakdown plus PLAN metric lines (scores and search time
    are lower-is-better rows; the winner row carries the placement
    description)."""
    import time

    from deeplearning4j_tpu_torch.reshard.search import (
        FleetShape,
        Objective,
        SearchError,
        emit_search_event,
        search_placement,
    )

    profile = _plan_profile(args)
    try:
        fleet = FleetShape.parse(args.fleet)
    except ValueError as exc:
        raise SystemExit(f"plan: {exc}") from None
    obj_kwargs = {}
    if args.global_batch is not None:
        obj_kwargs["global_batch"] = args.global_batch
    if args.hbm_gb is not None:
        obj_kwargs["hbm_bytes_per_device"] = int(args.hbm_gb * (1 << 30))
    if args.no_zero1:
        obj_kwargs["zero1_options"] = (False,)
    objective = Objective(**obj_kwargs)
    t0 = time.perf_counter()
    try:
        result = search_placement(profile, fleet, objective=objective)
    except SearchError as exc:
        raise SystemExit(f"plan: {exc}") from None
    search_ms = round((time.perf_counter() - t0) * 1e3, 3)
    emit_search_event(result, path="cli", search_ms=search_ms)

    for line in result.table_lines(args.top):
        print(line)
    best = result.best
    lines = [
        {"metric": "plan_candidates", "value": len(result.candidates),
         "fleet": fleet.describe(), "profile": result.profile_name},
        {"metric": "plan_pruned", "value": len(result.pruned)},
        {"metric": "plan_winner_score", "value": float(best.score),
         "lower_is_better": True, "winner": best.describe(),
         "memory_bytes": float(best.memory_bytes),
         "collective_bytes": float(best.collective_bytes),
         "bubble_cost": float(best.bubble_cost),
         "idle_cost": float(best.idle_cost)},
        {"metric": "plan_search_ms", "value": search_ms,
         "lower_is_better": True},
    ]
    for c in result.candidates:
        lines.append({"metric": f"plan_score::{c.describe()}",
                      "value": float(c.score), "lower_is_better": True})
    _emit_lines(lines, args.artifact, "PLAN")
    return 0


def _cmd_reshard(args) -> int:
    """`reshard --checkpoint --target-mesh` dry run: plan the
    checkpoint -> mesh redistribution (reshard/planner.py) and print it:
    per-action leaf counts, bytes moved against the collective lower
    bound, and metric lines. Nothing moves."""
    import time

    from deeplearning4j_tpu_torch.reshard.executor import plan_net_reshard
    from deeplearning4j_tpu_torch.reshard.planner import (Placement,
                                                          PlacementError)
    from deeplearning4j_tpu_torch.util.checkpoint import Checkpointer

    ck = Checkpointer(args.checkpoint)
    steps = ck.steps()
    if not steps:
        raise SystemExit(f"no committed checkpoints under {args.checkpoint}")
    step = steps[-1] if args.step is None else args.step
    if step not in steps:
        raise SystemExit(f"no checkpoint for step {step} (have {steps})")
    meta = ck.read_meta(step)
    with open(os.path.join(ck.step_dir(step), "config.json")) as fh:
        net = _net_from_conf(fh.read(), meta.get("kind"), args.device)
    net.init()  # leaf shapes only
    src = (Placement.from_json(meta["placement"])
           if meta.get("placement") else Placement.solo())
    try:
        axes = _parse_mesh(args.target_mesh)
        dst = Placement.of(axes, {r: r for r in axes},
                           process_count=args.processes, zero1=args.zero1)
        t0 = time.perf_counter()
        plan = plan_net_reshard(net, dst, src=src)
    except PlacementError as exc:
        raise SystemExit(f"reshard: {exc}") from None
    plan_us = round((time.perf_counter() - t0) * 1e6, 1)

    s = plan.summary()
    print(f"# reshard plan: {s['src']} -> {s['dst']} "
          f"(step {meta.get('iteration')})")
    for action, n in sorted(s["actions"].items()):
        moved = sum(l.bytes_moved for l in plan.leaves
                    if l.action == action)
        print(f"#   {action:<16} {n:>4} leaves  {moved:>12} bytes")
    lines = [
        {"metric": "reshard_plan_leaves", "value": s["n_leaves"]},
        {"metric": "reshard_bytes_total", "value": s["bytes_total"]},
        {"metric": "reshard_bytes_moved", "value": s["bytes_moved"],
         "lower_is_better": True},
        {"metric": "reshard_bytes_lower_bound",
         "value": s["bytes_lower_bound"], "lower_is_better": True},
        {"metric": "reshard_plan_us", "value": plan_us,
         "lower_is_better": True},
    ]
    _emit_lines(lines, args.artifact, "RESHARD")
    return 0


def _cmd_test(args) -> int:
    net = _load_model(args.model, args.device)
    it = _make_iterator(args)
    ev = net.evaluate(it)
    print(ev.stats())
    return 0


def _cmd_predict(args) -> int:
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        SVMLightRecordReader,
    )

    if bool(args.model) == bool(args.server):
        raise SystemExit("predict needs exactly one of --model (load "
                         "in-process) or --server URL (a running `serve` "
                         "instance)")
    # prediction input has no label column: every CSV value is a feature
    # (svmlight rows still carry a label field; it is ignored)
    path = _fetch_input(args.input)
    if args.format == "svmlight":
        if args.num_features <= 0:
            raise SystemExit("--num-features is required for svmlight input")
        feats = [f for _, f in SVMLightRecordReader(path, args.num_features)]
    else:
        feats = [np.asarray([float(v) for v in rec], np.float32)
                 for rec in CSVRecordReader(path)]
    x = np.stack(feats)
    if args.server:
        preds = _predict_via_server(args, x)
    else:
        net = _load_model(args.model, args.device)
        rows = []
        for s in range(0, len(x), args.batch):
            rows.append(net.output(x[s:s + args.batch]).float().cpu()
                        .numpy())
        preds = np.concatenate(rows)
    write_predictions(args.output, preds)
    print(f"wrote {len(preds)} predictions to {args.output}")
    return 0


def write_predictions(path: str, preds) -> None:
    """One CSV row a prediction, every value at 8 significant digits
    (the JAX CLI's format)."""
    with open(path, "w") as f:
        for row in np.asarray(preds):
            f.write(",".join(f"{v:.8g}" for v in np.atleast_1d(row)) + "\n")


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    # the tokens behind this parse: what a --multiprocess plan re-emits
    args._raw_argv = list(sys.argv[1:] if argv is None else argv)
    return {"train": _cmd_train, "test": _cmd_test,
            "predict": _cmd_predict, "serve": _cmd_serve,
            "reshard": _cmd_reshard, "plan": _cmd_plan,
            "coordinator": _cmd_coordinator}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
