"""Displacement map -> normal map converter, equivalent of
``utils/dmap2nmap.cpp``: central-difference slopes, normal packed into
RGB8 (utils/dmap2nmap.cpp:13-44).

PNG is read and written by the port's own codec (:mod:`dj_brdf_torch.
io.png`). ``--device`` is ``cuda`` by default and is never swapped for
another: without that device the program fails.

Usage: python -m dj_brdf_torch.cli.dmap2nmap [--device cuda|cpu]
           [--scale S] [--clamp_to_border] dmap.png
"""

from __future__ import annotations

import argparse

from dj_brdf_torch.cli import checked_device, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dmap")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--clamp_to_border", action="store_true")
    ap.add_argument("-o", "--output", default="nmap.png")
    device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dj_brdf_torch.io import png
    from dj_brdf_torch.lean import maps

    device = checked_device(args.device)
    img = png.to_luma(png.read_png(args.dmap)).astype(np.float32) / 255.0
    nmap = maps.dmap_to_nmap(torch.as_tensor(img, device=device),
                             scale=args.scale,
                             clamp_to_border=args.clamp_to_border)
    # pack like the reference (:38-42): nx,ny -> [0,1], nz direct
    packed = torch.stack([0.5 * nmap[..., 0] + 0.5,
                          0.5 * nmap[..., 1] + 0.5, nmap[..., 2]], -1)
    png.write_png(args.output,
                  (packed.cpu().numpy() * 255).astype(np.uint8))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
