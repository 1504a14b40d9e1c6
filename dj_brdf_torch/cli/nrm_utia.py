"""White-furnace energy-conservation test for UTIA BRDFs, equivalent of
``tests/nrm_utia.cpp``: integrate evalp*sin(theta) over the hemisphere
for a 64x256 outgoing grid and require <= 1 per channel. Exit code 1
on violation (the reference's only machine-checkable test).

``--device`` is ``cuda`` by default and is never swapped for another:
without that device the program fails. ``--mesh N`` shards the outgoing
grid over N ranks, started with ``torchrun --nproc-per-node N`` (or
N = 1 in-process); rank 0 prints, every rank exits with the same code.

Usage: python -m dj_brdf_torch.cli.nrm_utia [--device cuda|cpu]
           [--mesh N] file1.bin file2.bin ...
"""

from __future__ import annotations

import argparse

from dj_brdf_torch.cli import checked_device, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard the outgoing grid over N ranks (torchrun "
                         "--nproc-per-node N, or 1)")
    ap.add_argument("--ntheta", type=int, default=64)
    ap.add_argument("--nphi", type=int, default=256)
    device_arg(ap)
    args = ap.parse_args(argv)

    import torch

    from dj_brdf_torch.io.utia_io import load_utia
    from dj_brdf_torch.models.utia import Utia
    from dj_brdf_torch.parallel import integrals

    device = checked_device(args.device)
    mesh = None
    if args.mesh:
        from dj_brdf_torch.parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh, device)
        device = mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *_: None)

    ok_all = True
    for path in args.files:
        say(f"Testing {path}...")
        u = Utia.build(torch.as_tensor(load_utia(path), device=device))
        ok, max_val = integrals.furnace_test(
            u.evalp, n_out_theta=args.ntheta, n_out_phi=args.nphi,
            mesh=mesh, device=device)
        say(f"=> {'ok' if ok else 'FAILURE'} (max integral {max_val:.4f})")
        ok_all = ok_all and ok
    return 0 if ok_all else 1


if __name__ == "__main__":
    raise SystemExit(main())
