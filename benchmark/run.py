"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program (``dj_brdf_torch``)
beside ``BENCHMARK.json`` and ``benchmark/``. It sets up the cell (the
program's libraries, the inputs made from ``--seed``, one warm unit of
every shape), measures for ``--seconds`` seconds (``--trace 1``: the
cell's per-layer metrics from a profiled window of ``trace_units``
units), compares the answers with the plain reference, and prints one
JSON line on standard output, after each compared number beside its
limit on standard error. It needs as many CUDA devices as the cell asks
for and exits with a non-zero code, printing no result, without them,
without the program, or when a module of JAX or of the JAX package has
been loaded.

The control, the reference one precision below the configuration's in
the program's place, is read by ``python3 -m benchmark.study``, never
by this command.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program in the checkout, at fixed
# paths, so that only a checkout's first run builds
CACHE = ROOT / "build" / "benchmark_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.is_file():
        return fail(f"{spec_path} is missing")
    spec = json.loads(spec_path.read_text())

    import torch

    from benchmark import harness

    cell = harness.resolve(spec, args.workload, ROOT)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} CUDA devices, "
                    f"{torch.cuda.device_count()} present")
    try:
        import dj_brdf_torch  # noqa: F401
    except ImportError as exc:
        return fail(f"the program dj_brdf_torch is not importable: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: "
                    f"{', '.join(found)}")
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
