"""White-furnace energy-conservation test for UTIA BRDFs, equivalent of
``tests/nrm_utia.cpp``: integrate evalp*sin(theta) over the hemisphere
for a 64x256 outgoing grid and require <= 1 per channel. Exit code 1
on violation (the reference's only machine-checkable test).

``--device`` is ``cuda`` by default and is never swapped for another:
without that device the program fails. ``--mesh`` (sharding the
outgoing grid) belongs to the distribution slice and raises.

Usage: python -m dj_brdf_torch.cli.nrm_utia [--device cuda|cpu]
           file1.bin file2.bin ...
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the outgoing grid over N devices (not "
                         "ported yet)")
    ap.add_argument("--ntheta", type=int, default=64)
    ap.add_argument("--nphi", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device to integrate on (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from dj_brdf_torch.io.utia_io import load_utia
    from dj_brdf_torch.models.utia import Utia
    from dj_brdf_torch.parallel import integrals

    if args.mesh:
        raise NotImplementedError("--mesh: sharding over a device mesh "
                                  "belongs to the distribution slice and "
                                  "is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(use --device cpu to run on the CPU)")

    ok_all = True
    for path in args.files:
        print(f"Testing {path}...")
        u = Utia.build(torch.as_tensor(load_utia(path), device=device))
        ok, max_val = integrals.furnace_test(
            u.evalp, n_out_theta=args.ntheta, n_out_phi=args.nphi,
            device=device)
        print(f"=> {'ok' if ok else 'FAILURE'} (max integral {max_val:.4f})")
        ok_all = ok_all and ok
    return 0 if ok_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
