"""Dump radial CDF (or QF) curves for analytic and tabulated
Beckmann/GGX, equivalent of ``tests/plot_cdf.cpp`` and
``tests/plot_qf.cpp``: four text files of (theta_deg, value) rows for
plotting, validating the tabulation pipeline against closed forms.

``--device`` is ``cuda`` by default and is never swapped for another.

Usage: python -m dj_brdf_torch.cli.plot_cdf [--device cuda|cpu] [--qf]
           [--res 180] [--outdir .]
"""

from __future__ import annotations

import argparse
import os

from dj_brdf_torch.cli import checked_device, device_arg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--qf", action="store_true", help="dump quantile fns")
    ap.add_argument("--res", type=int, default=180)
    ap.add_argument("--outdir", default=".")
    device_arg(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dj_brdf_torch import fresnel
    from dj_brdf_torch.fit import tabular
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    device = checked_device(args.device)
    kind = "qf" if args.qf else "cdf"

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def dump(dist, path):
        cnt = 90
        u = np.arange(1, cnt) / cnt
        if args.qf:
            # (reference plot_qf.cpp:12-20)
            vals = torch.arctan(dist.qf_radial(f32(u))).cpu().numpy()
            rows = zip(u, np.degrees(vals.astype(np.float64)))
        else:
            # (reference plot_cdf.cpp:9-20)
            theta = u * np.pi / 2
            vals = dist.cdf_radial(f32(np.tan(theta))).cpu().numpy()
            rows = zip(np.degrees(theta), vals.astype(np.float64))
        with open(path, "w") as pf:
            for x, y in rows:
                pf.write(f"{float(x)} {float(y)}\n")

    for name, dist in [("beckmann", Beckmann()), ("ggx", GGX())]:
        dump(dist, os.path.join(args.outdir, f"eval_{kind}_{name}.txt"))
        eval_fn = tabular.microfacet_eval_fn(
            dist, fresnel.Ideal(), MicrofacetParams.isotropic(f32(1.0)))
        tab, _ = tabular.build_tabular(eval_fn, args.res, shadow=False,
                                       device=device)
        dump(tab, os.path.join(args.outdir, f"eval_{kind}_{name}_tab.txt"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
