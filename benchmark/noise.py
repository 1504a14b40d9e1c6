"""Where a cell's rate swings on the host: one process runs the cell's
loop after its set-up and warm-up for ``--seconds`` in slices of
``--slice`` seconds, and writes per slice its rate beside the machine's
counters over the same slice: the CPU time the hypervisor stole, the
busy time of the machine's other processes, this process's CPU time,
involuntary context switches and time in Python's collector, and the
cores' mean clock. Not part of a measured run: it is how the noise in
``PERF.md`` was read.

    python3 -m benchmark.noise --workload <name> --seed <n> \\
        --seconds 60 --slice 2 --out FILE
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import statistics
import sys
import time

from benchmark.run import ROOT  # sets the cache directories


def machine_jiffies():
    """(total, steal, busy) jiffies of all cores, from /proc/stat."""
    with open("/proc/stat") as f:
        v = [int(x) for x in f.readline().split()[1:]]
    idle = v[3] + v[4]
    steal = v[7] if len(v) > 7 else 0
    return sum(v[:8]), steal, sum(v[:8]) - idle - steal


def mean_mhz():
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(line.split(":")[1]) for line in f
                   if line.startswith("cpu MHz")]
        return statistics.fmean(mhz) if mhz else None
    except OSError:
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--slice", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("noise: no CUDA device", file=sys.stderr)
        return 2
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(spec, args.workload, ROOT)
    dev = torch.device("cuda")
    ctx = harness.Context(cell, args.seed, dev, harness.Spans(dev))
    state = cell.driver.setup(ctx)
    cell.driver.warmup(ctx, state)
    torch.cuda.synchronize()

    gc_s = [0.0]
    started = []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            gc_s[0] += time.perf_counter() - started.pop()
    gc.callbacks.append(on_gc)
    hz = os.sysconf("SC_CLK_TCK")
    rows, k, t_end = [], 0, time.perf_counter() + args.seconds
    with open(args.out, "a") as out:
        while time.perf_counter() < t_end:
            j0, r0, g0 = machine_jiffies(), resource.getrusage(
                resource.RUSAGE_SELF), gc_s[0]
            w = harness.measure(ctx, state, args.slice, first=k)
            k += len(w.records)
            j1, r1 = machine_jiffies(), resource.getrusage(
                resource.RUSAGE_SELF)
            own = (r1.ru_utime + r1.ru_stime - r0.ru_utime - r0.ru_stime)
            total = (j1[0] - j0[0]) / hz
            row = {"workload": args.workload, "slice": len(rows),
                   "units": len(w.records),
                   "rate": sum(r["items"] for r in w.records) / w.seconds,
                   "steal_s": (j1[1] - j0[1]) / hz,
                   "others_busy_s": (j1[2] - j0[2]) / hz - own,
                   "machine_s": total, "own_cpu_s": own,
                   "nivcsw": r1.ru_nivcsw - r0.ru_nivcsw,
                   "gc_s": gc_s[0] - g0, "mhz": mean_mhz(),
                   "wall_s": w.seconds}
            rows.append(row)
            out.write(json.dumps(row) + "\n")
            out.flush()
    rates = [r["rate"] for r in rows]
    q = statistics.quantiles(rates, n=4)
    print(json.dumps({"workload": args.workload, "slices": len(rows),
                      "median": statistics.median(rates),
                      "iqr_share": (q[2] - q[0]) / statistics.median(rates),
                      "min": min(rates), "max": max(rates)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
