"""Normal map -> LEAN maps, equivalent of ``utils/nmap2leanmap.cpp``
(and its biased variant): per-texel slope moments with base roughness,
saved as float .npy planes (leanmap_1: E1,E2,1,1; leanmap_2:
E3,E4,E5,1, the reference's EXR channel layout,
utils/nmap2leanmap.cpp:45-54), plus the lrep->params sanity roundtrip
(:57-76).

PNG is read by the port's own codec (:mod:`dj_brdf_torch.io.png`).
``--device`` is ``cuda`` by default and is never swapped for another.

Usage: python -m dj_brdf_torch.cli.nmap2leanmap [--device cuda|cpu]
           [--base-roughness R] [--biased] nmap.png
"""

from __future__ import annotations

import argparse

from dj_brdf_torch.cli import checked_device, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("nmap")
    ap.add_argument("--base-roughness", type=float, default=1e-5)
    ap.add_argument("--biased", action="store_true",
                    help="+25/+625 bias for unsigned storage "
                         "(nmap2leanmap_biased.cpp)")
    ap.add_argument("--out1", default="leanmap_1.npy")
    ap.add_argument("--out2", default="leanmap_2.npy")
    device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dj_brdf_torch.io import png
    from dj_brdf_torch.lean import maps
    from dj_brdf_torch.lean.lrep import lrep_to_params

    device = checked_device(args.device)
    img = png.to_rgb(png.read_png(args.nmap)).astype(np.float32) / 255.0
    # unpack (nmap2leanmap.cpp:36-39)
    nmap = torch.as_tensor(np.stack([
        img[..., 0] * 2.0 - 1.0, img[..., 1] * 2.0 - 1.0,
        np.maximum(img[..., 2], 1e-3)], axis=-1), device=device)
    bias = maps.LEAN_BIAS if args.biased else 0.0
    lean = maps.nmap_to_lean(nmap, base_roughness=args.base_roughness,
                             bias=bias)

    # sanity roundtrip (check_lean_maps, nmap2leanmap.cpp:57-76)
    check = maps.unbias(lean, bias) if args.biased else lean
    if not bool(torch.isfinite(lrep_to_params(check).ax).all()):
        raise RuntimeError("nmap2leanmap: the LEAN maps give non-finite "
                           "roughness")

    e = [t.cpu().numpy() for t in (lean.E1, lean.E2, lean.E3, lean.E4,
                                   lean.E5)]
    ones = np.ones(e[0].shape, np.float32)
    np.save(args.out1, np.stack([e[0], e[1], ones, ones], axis=-1))
    np.save(args.out2, np.stack([e[2], e[3], e[4], ones], axis=-1))
    print(f"wrote {args.out1} {args.out2}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
