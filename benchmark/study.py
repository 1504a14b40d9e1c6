"""Read a cell's compared numbers over many seeds in one process: each
seed's run as the benchmark makes it (set-up, a short window, the
check), then, for the first ``--control-seeds`` seeds, the same seed's
control, where the reference computed one precision below the
configuration's takes the program's place. Not part of a measured run: it is how the limits in
``traffic/<mix>.json`` were read.

    python3 -m benchmark.study --workload <name> --seeds 12 \\
        --first-seed 4000000000 --seconds 4 [--control-seeds 3] --out FILE
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark.run import ROOT  # sets the cache directories


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=4_000_000_000)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control-seeds", type=int, default=0,
                   help="also run the control on the first N seeds")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.resolve(spec, args.workload, ROOT)
    with open(args.out, "a") as out:
        for s in range(args.seeds):
            seed = args.first_seed + 7919 * s
            for control in ((False, True) if s < args.control_seeds
                            else (False,)):
                torch.cuda.reset_peak_memory_stats()
                r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                     time.perf_counter(), control=control)
                row = {"workload": args.workload, "seed": seed,
                       "control": control, "checks": r["checks"],
                       "attempted": r["attempted"], "metrics": r["metrics"],
                       "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
                out.write(json.dumps(row) + "\n")
                out.flush()
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
