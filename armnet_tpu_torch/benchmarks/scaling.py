"""Train-step throughput against the number of devices (the counterpart of
the JAX package's benchmarks/scaling.py): the armnet_1h step of the
trainer's make_train_step() at each world size in SIZES up to the devices
there are, examples/s and the scaling efficiency against one device.

    python -m armnet_tpu_torch.benchmarks.scaling [--max_devices N]
        [--batch_per_device 4096] [--nfeat 2100000] [--nfield 39]
        [--shard_embedding] [--embedding_exchange psum|a2a]
        [--kernels auto|pallas-fused] [--warm 5] [--steps 10] [--reps 3]
        [--device cuda]

The recipe is the JAX script's (armnet_1h, E 10, h 128, MLP 2x500, alpha
2, lr 1e-3, seed 0) on the bench's seeded batch (benchmarks/timing
.bench_batch) of batch_per_device x devices rows, the same batch every
step. One device runs in this process. A world size d above 1 runs d
processes of this module (`--world d`), each one rank of a process group
(NCCL on cuda:rank, gloo on the CPU; the address is localhost and a free
port) on the port's parallel/ modules: the mesh data:d/m,model:m, m = 2
where --shard_embedding is given and d is even (the JAX script's rule),
else 1; each data rank takes its rows of the global batch; with
--shard_embedding the tables are cut by parallel/sharding.shard_tables
(psum or a2a exchange, capacity factor 4 as the JAX script's). Rank 0's
timing is the row's.

On the card the sizes stop at torch.cuda.device_count(), since NCCL
refuses two ranks on one GPU; on the CPU --max_devices gloo processes are
started (1 without it). Timing: benchmarks/timing.py. stdout: one JSON
line per world size, then the `scaling_table` line; stderr: where the
sizes stop and why.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.bench import LR, SEED
from armnet_tpu_torch.benchmarks.timing import (add_timing_args, bench_batch,
                                                measure)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.parallel.mesh import (make_mesh,
                                            maybe_initialize_distributed)
from armnet_tpu_torch.parallel.sharding import shard_tables
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)

__all__ = ["RECIPE", "SIZES", "CAPACITY_FACTOR", "config", "mesh_spec",
           "make_step", "measure_row", "main"]

RECIPE = dict(model="armnet_1h", nemb=10, h=128, mlp_nlayer=2, mlp_nhid=500,
              alpha=2.0)
SIZES = (1, 2, 4, 8, 16, 32)
CAPACITY_FACTOR = 4.0
WORKER_TIMEOUT = 1800


def config(nfeat, nfield):
    return ModelConfig(nfeat=nfeat, nfield=nfield, **RECIPE)


def mesh_spec(n_devices, shard_embedding):
    """The JAX script's mesh: a model axis of 2 where the tables are
    sharded and the device count is even."""
    model_par = 2 if (shard_embedding and n_devices % 2 == 0) else 1
    return f"data:{n_devices // model_par},model:{model_par}"


def make_step(cfg, batch_per_device, n_devices, device, kernels="auto",
              mesh=None, shard_embedding=False, exchange="psum"):
    """(step, sharded table names, meters): step() is one call of the
    trainer's make_train_step(mesh) on this rank's rows of the bench's
    batch of batch_per_device x n_devices rows, the model from SEED;
    meters[0] holds the meters after the last call."""
    batch = bench_batch(cfg, batch_per_device * n_devices, device)
    if mesh is not None:
        rows = batch["y"].shape[0] // mesh.data_size
        batch = {k: v[mesh.data_index * rows:(mesh.data_index + 1) * rows]
                 for k, v in batch.items()}
    model = create_model(cfg, seed=SEED, device=device, kernels=kernels)
    names = (shard_tables(model, mesh, cfg.nfeat, exchange, CAPACITY_FACTOR)
             if mesh is not None and shard_embedding else [])
    state = create_train_state(model, LR)
    train_step = make_train_step(mesh=mesh)
    meters = [init_meters(device)]

    def step():
        meters[0] = train_step(state, meters[0], batch)

    return step, names, meters


def measure_row(args, n_devices, device, mesh=None):
    """The row of one world size from this process's (rank's) timing."""
    cfg = config(args.nfeat, args.nfield)
    step, names, meters = make_step(
        cfg, args.batch_per_device, n_devices, device, args.kernels, mesh,
        args.shard_embedding, args.embedding_exchange)
    m = measure(step, device, args.warm, args.steps, args.reps)
    global_batch = args.batch_per_device * n_devices
    return {"devices": n_devices,
            "examples_per_sec": global_batch / m["step_ms"]["median"] * 1e3,
            "batch_size": global_batch,
            "mesh": mesh.shape if mesh is not None else None,
            "exchange": args.embedding_exchange if names else None,
            "sharded": names, "loss_last": float(meters[0]["loss_last"]),
            **{k: m[k] for k in ("step_ms", "device_ms_per_step",
                                 "idle_share", "launches", "card",
                                 "seconds")}}


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_world(argv, n_devices, device):
    """The row of world size n_devices > 1: n_devices processes of this
    module (--world n_devices; RANK and the rest in the environment) over
    localhost; rank 0's JSON line.
    Every process is killed if one fails or the group outlasts
    WORKER_TIMEOUT."""
    port = _free_port()
    procs = []
    for rank in range(n_devices):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(n_devices), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "armnet_tpu_torch.benchmarks.scaling",
             *argv, "--world", str(n_devices)], env=env,
            stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL,
            text=True))
    deadline = time.monotonic() + WORKER_TIMEOUT
    try:
        out = procs[0].communicate(timeout=WORKER_TIMEOUT)[0]
        codes = [p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                 for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"scaling: world {n_devices} ranks exited {codes}")
    return json.loads(out.strip().splitlines()[-1])


def worker(args, n_devices):
    """One rank of world size n_devices (the environment names it)."""
    maybe_initialize_distributed(args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if torch.device(args.device).type == "cuda"
              else torch.device("cpu"))
    mesh = make_mesh(mesh_spec(n_devices, args.shard_embedding))
    try:
        row = measure_row(args, n_devices, device, mesh)
    finally:
        torch.distributed.destroy_process_group()
    if mesh.rank == 0:
        print(json.dumps(row), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="train-step examples/s against the number of devices "
                    "(one JSON line per world size, then the table)")
    p.add_argument("--max_devices", type=int, default=None)
    p.add_argument("--batch_per_device", type=int, default=4096)
    p.add_argument("--nfeat", type=int, default=2_100_000)
    p.add_argument("--nfield", type=int, default=39)
    p.add_argument("--shard_embedding", action="store_true")
    p.add_argument("--embedding_exchange", type=str, default="psum",
                   choices=["psum", "a2a"])
    p.add_argument("--world", type=int, default=None,
                   help=argparse.SUPPRESS)   # a rank of a world this large
    add_timing_args(p, warm=5, steps=10, reps=3)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_matmul_precision("default")
    if args.world is not None:
        worker(args, args.world)
        return
    if device.type == "cuda":
        navail = torch.cuda.device_count()
        if (args.max_devices or navail) > navail:
            print(f"scaling: stops at {navail} device(s): NCCL refuses two "
                  f"ranks on one GPU", file=sys.stderr, flush=True)
    else:
        navail = args.max_devices or 1
    maxd = min(args.max_devices or navail, navail)
    rows, base = [], None
    for d in (s for s in SIZES if s <= maxd):
        row = (measure_row(args, 1, device) if d == 1
               else run_world(argv, d, device))
        base = base or row["examples_per_sec"]
        row["scaling_efficiency"] = row["examples_per_sec"] / (base * d)
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"metric": "scaling_table", "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
