"""Worker program of the port's cluster and elastic CPU tests
(tests/test_torch_cluster.py, tests/test_torch_elastic.py). It imports
neither jax nor the JAX package.

    python tests/torch_fleet_worker.py cluster INPUTS.npz ADDRESS WORKER
        SHARD CKPT_DIR|- CRASH_AFTER|none KIND OUT.npz
    python tests/torch_fleet_worker.py elastic INPUTS.npz CKPT_DIR OUT_DIR
    python tests/torch_fleet_worker.py shards INPUTS.npz OUT_DIR
    python tests/torch_fleet_worker.py save INPUTS.npz CKPT_DIR OUT_DIR SHARED

INPUTS holds the initial params of the JAX package's
`tests/cluster_worker.build_net(kind)` (`params/<layer>/<name>`) and
the data: for `cluster` the full batch `x`, `y` (the worker trains on
its half, `shard` 0 or 1, `STEPS` times through
`parallel.cluster.run_elastic_worker`); for `elastic` the global batch
of every step, `x<step>`, `y<step>` (1-based), trained through
`distributed.elastic.run_elastic_steps` on a searched "data" placement
of this generation's fleet (`ElasticSupervisor` launches it); for
`shards` the sharded embedding engine's feeds and the device pipeline's
and GloVe's inputs, run over the fleet's process group (a fleet of 2
also fits Word2Vec through the engine at ep = 2); for `save` a
checkpoint under a 2-rank "data" mesh, into one directory (SHARED 1) or
one a rank, counting each rank's file writes.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn import conf as conf_mod
from deeplearning4j_tpu_torch.weights_io import params_from_jax

F, C, STEPS = 6, 3, 6
GLOBAL_BATCH = 24


def build_net(inputs, kind: str = "mln"):
    """The port's twin of tests/cluster_worker.build_net(kind) on the
    CPU, its params the JAX net's initial ones."""
    b = (conf_mod.NeuralNetConfiguration.builder().seed(7)
         .learning_rate(0.1).updater("sgd"))
    if kind == "cg":
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        g = b.graph_builder().add_inputs("in")
        g.add_layer("h", conf_mod.DenseLayer(n_in=F, n_out=8,
                                             activation="tanh"), "in")
        g.add_layer("out", conf_mod.OutputLayer(
            n_in=8, n_out=C, activation="softmax", loss_function="mcxent"),
            "h")
        g.set_outputs("out")
        net = ComputationGraph(g.build(), device="cpu")
    else:
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        conf = (b.list()
                .layer(conf_mod.DenseLayer(n_in=F, n_out=8,
                                           activation="tanh"))
                .layer(conf_mod.OutputLayer(n_in=8, n_out=C,
                                            activation="softmax",
                                            loss_function="mcxent"))
                .build())
        net = MultiLayerNetwork(conf, device="cpu")
    net.init()
    params = {}
    for key in inputs.files:
        if key.startswith("params/"):
            _, layer, name = key.split("/", 2)
            params.setdefault(layer, {})[name] = inputs[key]
    net.params = params_from_jax(params, "cpu")
    net.opt_state = net.tx.init(net.params)
    return net


def cluster_main(args) -> int:
    inputs_path, address, wid, shard, ckpt, crash_at, kind, out = args
    inputs = np.load(inputs_path)
    ckpt = None if ckpt == "-" else ckpt

    from deeplearning4j_tpu_torch.parallel import cluster

    if crash_at != "none":
        # a process failure after N averaging rounds
        n = int(crash_at)
        orig = cluster.ClusterClient.average
        calls = [0]

        def average(self, step, flat):
            calls[0] += 1
            if calls[0] > n:
                os._exit(1)
            return orig(self, step, flat)

        cluster.ClusterClient.average = average

    x, y = inputs["x"], inputs["y"]
    half = x.shape[0] // 2
    lo, hi = (0, half) if shard == "0" else (half, x.shape[0])
    net = build_net(inputs, kind)
    net = cluster.run_elastic_worker(
        address, wid, net, [DataSet(x[lo:hi], y[lo:hi])] * STEPS,
        sync_every=1, checkpoint_path=ckpt)
    np.savez(out, params=net.params_flat(),
             iteration=np.asarray(net.iteration_count))
    return 0


def elastic_main(args) -> int:
    inputs_path, ckpt_dir, out_dir = args
    inputs = np.load(inputs_path)

    from deeplearning4j_tpu_torch.distributed import bootstrap, elastic
    from deeplearning4j_tpu_torch.reshard.search import Objective

    total = elastic.worker_total_steps()
    # a dead peer must surface as an exception within seconds here
    info = bootstrap.initialize(device="cpu", connect_timeout=60.0,
                                init_timeout=20.0)
    pid = info["process_id"]
    net = build_net(inputs)
    mesh, axes, _ = elastic.searched_global_mesh(
        net, objective=Objective(global_batch=GLOBAL_BATCH))
    # the restore into this generation's placement: each rank reads only
    # its part of the checkpoint a fleet of another size wrote
    start = net.resume_from(ckpt_dir, target_mesh=mesh, target_axes=axes)
    print(f"p{pid}: resuming from step {start}/{total}", flush=True)
    elastic.run_elastic_steps(
        net, lambda s: DataSet(inputs[f"x{s}"], inputs[f"y{s}"]), total,
        checkpoint_dir=ckpt_dir, checkpoint_every=1)
    assert net.iteration_count == total
    flat = net.params_flat()
    if pid == 0:
        np.save(Path(out_dir) / "final_params.npy", flat)
        (Path(out_dir) / "done.txt").write_text(
            f"steps={net.iteration_count} "
            f"n_processes={info['num_processes']}\n")
    bootstrap.shutdown()
    print(f"p{pid}: finished at step {net.iteration_count}", flush=True)
    return 0


def engine_arm(inputs, ep, dp, in_process=False, device="cpu"):
    """SGNS steps then HS steps of the engine at (ep, dp) over the feeds
    of `inputs`: the whole tables and the losses."""
    from deeplearning4j_tpu_torch.embedding.engine import (
        ShardedEmbeddingEngine,
    )

    V, D = (int(v) for v in inputs["dims"][:2])
    lr = float(inputs["lr"])
    out = {}
    eng = ShardedEmbeddingEngine(V, D, ep=ep, dp=dp, device=device,
                                 in_process=in_process)
    for i in range(int(inputs["steps"])):
        eng.sgns_step(inputs[f"center{i}"], inputs[f"context{i}"],
                      inputs[f"negs{i}"], lr)
    hs = ShardedEmbeddingEngine(V, D, ep=ep, dp=dp, use_hs=True,
                                device=device, in_process=in_process)
    for i in range(int(inputs["steps"])):
        hs.hs_step(inputs[f"center{i}"], inputs["codes"], inputs["points"],
                   inputs["mask"], lr)
    for name, e in (("sgns", eng), ("hs", hs)):
        for t in ("syn0", "syn1", "syn1neg"):
            out[f"{name}/{t}"] = getattr(e, t)[:V].cpu().numpy()
        out[f"{name}/loss"] = np.asarray([float(x) for x in e.loss_history])
    out["table_bytes"] = np.asarray(eng.table_bytes_per_device())
    return out


def pipeline_arm(inputs, mesh):
    """One SGNS device-pipeline epoch over the inputs' corpus, its
    chunk groups split over `mesh` (None: meshless)."""
    from deeplearning4j_tpu_torch.nlp import device_pipeline as dp

    f = dp.make_sgns_epoch(window=3, negative=4, chunk=128, group=4,
                           mesh=mesh)
    s0 = torch.from_numpy(inputs["pipe_syn0"].copy())
    s1 = torch.zeros_like(s0)
    _, _, loss, pairs = f(
        s0, s1, torch.from_numpy(inputs["pipe_tokens"]),
        torch.from_numpy(inputs["pipe_sents"]),
        torch.from_numpy(inputs["pipe_J"]), torch.from_numpy(inputs["pipe_q"]),
        torch.Generator().manual_seed(1), 0.05, 0.01)
    return {"pipe/syn0": s0.numpy(), "pipe/syn1neg": s1.numpy(),
            "pipe/loss": loss.numpy(), "pipe/pairs": pairs.numpy()}


def glove_arm(inputs, mesh):
    """Two shuffled GloVe epochs over the inputs' triples, each batch
    split over `mesh` (None: meshless)."""
    from deeplearning4j_tpu_torch.nlp import glove

    V, D = (int(v) for v in inputs["dims"][:2])
    st = glove.init_glove_state(V, D, torch.Generator().manual_seed(0),
                                "cpu")
    ep = glove.make_glove_epoch(64, True, mesh=mesh)
    gen = torch.Generator().manual_seed(3)
    args = (torch.from_numpy(inputs["gl_i"]).long(),
            torch.from_numpy(inputs["gl_j"]).long(),
            torch.from_numpy(inputs["gl_logx"]),
            torch.from_numpy(inputs["gl_fx"]))
    losses = torch.cat([ep(st, *args, gen, 0.05) for _ in range(2)])
    out = {f"glove/{k}": v.numpy() for k, v in st.items()}
    out["glove/loss"] = losses.numpy()
    return out


def w2v_fit(**engine):
    """Word2Vec through the embedding engine (`use_engine(True,
    **engine)`) over 120 seeded sentences of a 40-word vocabulary."""
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    rng = np.random.default_rng(4)
    sents = [[f"w{int(i)}" for i in rng.integers(0, 40, 10)]
             for _ in range(120)]
    torch.manual_seed(0)
    m = (Word2Vec.builder().layer_size(16).window_size(3)
         .min_word_frequency(1).epochs(1).seed(3).batch_size(64)
         .use_engine(True, **engine).device("cpu").build())
    m.fit(sents)
    return m


def shards_main(args) -> int:
    inputs_path, out_dir = args
    inputs = np.load(inputs_path)

    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

    info = bootstrap.initialize(device="cpu", connect_timeout=60.0,
                                init_timeout=60.0)
    world = info["num_processes"]
    out = {}
    arms = [(2, 1), (1, 2)] if world == 2 else [(4, 1), (2, 2)]
    for ep, dp in arms:
        out.update({f"ep{ep}dp{dp}/{k}": v
                    for k, v in engine_arm(inputs, ep, dp).items()})
    if world == 2:
        mesh = make_mesh({"data": 2})
        out.update(pipeline_arm(inputs, mesh))
        out.update(glove_arm(inputs, mesh))
        w2v = w2v_fit(ep=2)
        out["w2v/ep"] = np.asarray(w2v._engine.ep)
        out["w2v/syn0"] = w2v.lookup_table.vectors()
        out["w2v/syn1neg"] = w2v.lookup_table.syn1neg.numpy()
    if info["process_id"] == 0:
        np.savez(Path(out_dir) / f"shards{world}.npz", **out)
    bootstrap.shutdown()
    return 0


def save_main(args) -> int:
    inputs_path, ckpt_dir, out_dir, shared = args
    inputs = np.load(inputs_path)

    from deeplearning4j_tpu_torch.distributed import bootstrap
    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.util import checkpoint

    info = bootstrap.initialize(device="cpu", init_timeout=30.0)
    rank = info["process_id"]
    writes = []
    real = checkpoint.torch.save

    def counted(obj, path):
        writes.append(str(path))
        return real(obj, path)

    checkpoint.torch.save = counted
    net = build_net(inputs)
    net.set_mesh(make_mesh({"data": -1}), axes={"data": "data"})
    d = Path(ckpt_dir) if shared == "1" else Path(ckpt_dir) / f"rank{rank}"
    for step in (1, 2):
        checkpoint.Checkpointer(str(d), keep=1).save(net, step)
    (Path(out_dir) / f"writes{rank}.txt").write_text("\n".join(writes))
    bootstrap.shutdown()
    return 0


def main(argv) -> int:
    torch.set_num_threads(1)
    role, args = argv[0], argv[1:]
    return {"cluster": cluster_main, "elastic": elastic_main,
            "shards": shards_main, "save": save_main}[role](args)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
