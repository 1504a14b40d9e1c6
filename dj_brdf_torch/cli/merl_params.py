"""GGX and Beckmann roughness extraction for MERL BRDFs.

Equivalent of ``examples/merl_params.cpp``: for each MERL binary, run
the tabulation pipeline at res 90 and append
``name beckmann_alpha ggx_alpha`` to params.txt
(merl_params.cpp:53-68).

All materials stack on a leading axis and tabulate at once on one
device (fit/batch.py::tabulate_merl_batch); ``--mesh N`` shards the
material axis over N ranks, started with ``torchrun --nproc-per-node N``
(or N = 1 in-process), and rank 0 writes the output. ``--device`` is
``cuda`` by default and is never swapped for another: without that
device the program fails.

Usage: python -m dj_brdf_torch.cli.merl_params [--device cuda|cpu]
           [--mesh N] merl1.binary merl2.binary ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from dj_brdf_torch.cli import checked_device, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="MERL .binary files")
    ap.add_argument("-o", "--output", default="params.txt")
    ap.add_argument("--res", type=int, default=90)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard materials over N ranks (torchrun "
                         "--nproc-per-node N, or 1)")
    device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dj_brdf_torch.fit.batch import tabulate_merl_batch
    from dj_brdf_torch.io.merl_io import load_merl

    device = checked_device(args.device)
    mesh = None
    if args.mesh:
        from dj_brdf_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh, device)
        device = mesh.device

    tables = torch.as_tensor(np.stack([load_merl(path) for path in args.files]),
                             device=device)
    t0 = time.perf_counter()
    _, _, ab, ag = tabulate_merl_batch(tables, args.res, mesh=mesh)
    ab, ag = ab.cpu().numpy(), ag.cpu().numpy()
    if mesh is not None and mesh.rank != 0:
        return 0
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
