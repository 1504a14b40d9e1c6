"""GGX and Beckmann roughness extraction for MERL BRDFs.

Equivalent of ``examples/merl_params.cpp``: for each MERL binary, run
the tabulation pipeline at res 90 and append
``name beckmann_alpha ggx_alpha`` to params.txt
(merl_params.cpp:53-68).

All materials stack on a leading axis and tabulate at once on one
device (fit/batch.py::tabulate_merl_batch). ``--device`` is ``cuda`` by
default and is never swapped for another: without that device the
program fails.

Usage: python -m dj_brdf_torch.cli.merl_params [--device cuda|cpu]
           merl1.binary merl2.binary ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="MERL .binary files")
    ap.add_argument("-o", "--output", default="params.txt")
    ap.add_argument("--res", type=int, default=90)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard materials over an N-device mesh (not "
                         "ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to tabulate on (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dj_brdf_torch.fit.batch import tabulate_merl_batch
    from dj_brdf_torch.io.merl_io import load_merl

    if args.mesh:
        raise NotImplementedError("--mesh: sharding over a device mesh is "
                                  "not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(use --device cpu to run on the CPU)")

    tables = torch.as_tensor(np.stack([load_merl(path) for path in args.files]),
                             device=device)
    t0 = time.perf_counter()
    _, _, ab, ag = tabulate_merl_batch(tables, args.res)
    ab, ag = ab.cpu().numpy(), ag.cpu().numpy()
    print(f"# tabulated {len(args.files)} materials in "
          f"{time.perf_counter() - t0:.2f}s on {device}", file=sys.stderr)

    with open(args.output, "w") as pf:
        pf.write("# MERL Beckmann GGX\n")
        for k, path in enumerate(args.files):
            name = os.path.splitext(os.path.basename(path))[0]
            pf.write(f"{name} {ab[k]:.3f} {ag[k]:.3f}\n")
            print(f"{name}: beckmann={ab[k]:.3f} ggx={ag[k]:.3f}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
