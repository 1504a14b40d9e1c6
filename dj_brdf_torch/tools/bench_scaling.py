"""Scaling benchmark: data-parallel fitting-step throughput against the
world size. For each world size d = 1, 2, 4, ... up to the maximum it
starts one process group with ``python -m torch.distributed.run
--nproc-per-node d``: NCCL with one card a rank, or with ``--cpu`` gloo
with one CPU thread a rank and glibc's malloc thresholds fixed
(``CPU_MALLOC_ENV``). Each rank takes its block of the samples,
runs the GGX value-and-grad step on it (the fused fit kernel on a card,
its plain version on the CPU), and all-reduces the loss and gradient,
as ``fit/lsq.py::sharded_value_and_grad`` does: every rank gets the
unsharded step's loss and gradient.

Usage: python -m dj_brdf_torch.tools.bench_scaling [--devices N]
           [--n 1048576] [--iters 20] [--cpu] [--out results.json]

Prints one JSON line, ``{"metric": "dp_scaling_efficiency",
"per_device": {d: evals/s}, "efficiency_at_max": ...}``; ``--out``
also writes each world's loss and gradient there.

Counterpart of the JAX system's ``tools/bench_scaling.py``, whose mesh
is virtual CPU devices of one process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

#: the JAX tool's azimuth bound (tools/bench_scaling.py:50-60)
AZIMUTH = 6.28
WORKER_TIMEOUT = 900
#: glibc's malloc thresholds for CPU ranks, fixed. Left dynamic, they
#: follow a process's earlier allocations: the plain step's temporaries
#: then page-fault at a rate set by the block size and the inputs made
#: before, so a world of one ran slower per sample than a rank of eight
#: and the efficiency read above 100%. A value in the environment wins.
CPU_MALLOC_ENV = {"MALLOC_MMAP_THRESHOLD_": "33554432",
                  "MALLOC_TRIM_THRESHOLD_": "1073741824"}
#: the environment variable that carries a rank's job (JSON)
WORKER_ENV = "DJBT_BENCH_SCALING_JOB"


def make_inputs(n: int, device):
    """The step's global inputs on ``device``, the same on every rank:
    ``(pvec, comp, targets)``, the bench's headline problem
    (:func:`dj_brdf_torch.bench.headline_inputs`) with azimuths in
    [0, ``AZIMUTH``]."""
    from dj_brdf_torch import bench

    _, _, comp, targets, pvec = bench.headline_inputs(n, device, AZIMUTH)
    return pvec, comp, targets


def unsharded_step(pvec, comp, targets):
    """The step on one device: ``(loss, grad (8,))`` of the GGX fit."""
    from dj_brdf_torch.ops.fused_fit import ggx_lsq_value_and_grad

    return ggx_lsq_value_and_grad(pvec, *comp, *targets)


def sharded_step(mesh, n: int):
    """``step(pvec, *block) -> (loss, grad)`` over this rank's block of
    ``n`` samples: the block's sums over the global ``n``, all-reduced."""
    import torch

    from dj_brdf_torch.ops.fused_fit import ggx_lsq_value_and_grad

    def step(pvec, *data):
        if data[0].shape[0]:
            val, grad = ggx_lsq_value_and_grad(pvec, *data, n_valid=n)
        else:
            val, grad = pvec.new_zeros(()), torch.zeros_like(pvec)
        flat = mesh.all_reduce_sum(torch.cat([val.reshape(1), grad]))
        return flat[0], flat[1:]
    return step


def worker(job: dict) -> int:
    """One rank of a world started by torchrun: time ``job["iters"]``
    steps of ``job["n"]`` samples in rounds; rank 0 writes the rate, loss
    and gradient to ``job["result"]``."""
    import torch

    from dj_brdf_torch.parallel.mesh import make_mesh

    n, iters = job["n"], job["iters"]
    device = "cpu" if job["cpu"] else "cuda"
    if job["cpu"]:
        torch.set_num_threads(1)               # one core is one device
    mesh = make_mesh(int(os.environ["WORLD_SIZE"]), device)
    try:
        pvec, comp, targets = make_inputs(n, mesh.device)
        block = mesh.split(n)
        data = tuple(t[block].contiguous() for t in (*comp, *targets))
        step = sharded_step(mesh, n)
        val, grad = step(pvec, *data)

        def rnd():
            t0 = time.perf_counter()
            for _ in range(iters):
                v, _ = step(pvec, *data)
            float(v)                            # waits for the device
            return time.perf_counter() - t0

        rnd()
        dt = min(rnd() for _ in range(3))
        if mesh.rank == 0:
            with open(job["result"], "w") as fh:
                json.dump({"rate": n * iters / dt, "loss": float(val),
                           "grad": grad.tolist()}, fh)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def run_world(d: int, args, result: str) -> dict:
    """Start a world of ``d`` ranks of this module and return rank 0's
    result. The ranks take their job from ``WORKER_ENV`` (torchrun's own
    parser would claim options such as ``--n`` that follow the module)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(d), "-m",
           "dj_brdf_torch.tools.bench_scaling"]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**CPU_MALLOC_ENV, **os.environ} if args.cpu else dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env[WORKER_ENV] = json.dumps({"n": args.n, "iters": args.iters,
                                  "cpu": args.cpu, "result": result})
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=WORKER_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"world of {d} ranks failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-2000:]}")
    with open(result) as fh:
        return json.load(fh)


def main(argv=None) -> int:
    if WORKER_ENV in os.environ:
        return worker(json.loads(os.environ[WORKER_ENV]))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="max world size (0 = all cards; 8 with --cpu)")
    ap.add_argument("--n", type=int, default=1 << 20, help="batch per step")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU, one thread each")
    ap.add_argument("--out", default=None,
                    help="also write each world's rate, loss and gradient "
                         "to this JSON file")
    args = ap.parse_args(argv)

    if args.cpu:
        max_dev = args.devices or 8
    else:
        import torch

        total = torch.cuda.device_count()
        if total == 0:
            sys.exit("bench_scaling: no CUDA device (use --cpu for gloo "
                     "ranks on the CPU)")
        max_dev = min(args.devices or total, total)

    results, worlds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        d = 1
        while d <= max_dev:
            rec = run_world(d, args, os.path.join(tmp, f"world{d}.json"))
            worlds[d] = rec
            results[d] = rec["rate"]
            eff = rec["rate"] / (results[1] * d)
            print(f"devices={d}: {rec['rate']:.3e} evals/s  "
                  f"efficiency={eff:.1%}", file=sys.stderr)
            d *= 2

    if args.out:
        with open(args.out, "w") as fh:
            json.dump({str(k): v for k, v in worlds.items()}, fh)
    base = results[1]
    print(json.dumps({
        "metric": "dp_scaling_efficiency",
        "per_device": {str(k): v for k, v in results.items()},
        "efficiency_at_max": results[max(results)] / (base * max(results)),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
