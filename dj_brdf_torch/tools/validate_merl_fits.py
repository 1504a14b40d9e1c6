"""Validate MERL roughness fits against the C++ oracle + a pinned table.

The reference's flagship validation is that `tabular(merl, 90)` +
`fit_{beckmann,ggx}_parameters` reproduce the EGSR 2015 alpha table on
the real MERL database (the reference's README:20-22, driven by
examples/merl_params.cpp:53-68). This tool is the one-command recipe
for that check in the port:

    python -m dj_brdf_torch.tools.validate_merl_fits --data /path/to/merl

For every `*.binary` file found it runs the batched tabulation
(`fit.batch.tabulate_merl_batch`: on the card every MERL lookup is the
lookup kernel) and checks the fitted alphas two ways:

  1. against the C++ oracle compiled from the read-only reference
     (`tests/oracle`), at the oracle-test tolerance (rtol 2e-3);
  2. against the port's pinned table `tools/data/expected_merl_alphas.json`
     (rtol 5e-3), regression protection that needs no compiler.

No measured MERL data ships with the repo, so by default the tool bakes
a small synthetic corpus (`io.synth`) into `build/dj_brdf_torch/
synth_merl/`, a directory of the port's own, and validates that: the
same pipeline end to end. `--update-pinned` writes the port's pinned
table only.

``--device`` is ``cuda`` by default and is never swapped for another:
without that device the tool fails.

Exit status: 0 = all checks passed, 1 = any mismatch, 2 = nothing to
validate.

Counterpart of the JAX system's ``tools/validate_merl_fits.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from dj_brdf_torch.cli import checked_device, device_arg

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
PINNED = os.path.join(_HERE, "data", "expected_merl_alphas.json")
SYNTH_DIR = os.path.join(_ROOT, "build", "dj_brdf_torch", "synth_merl")

ORACLE_RTOL = 2e-3   # tests/test_oracle_data.py::test_tabular_merl_fit
PINNED_RTOL = 5e-3   # device/ordering drift allowance across versions


def bake_synthetic_corpus(outdir: str, device="cuda") -> list[str]:
    """Bake analytic BRDFs into MERL binaries (io/synth.py), on
    ``device``, so the pipeline runs end to end with no measured data
    present. Files already in ``outdir`` are kept."""
    import torch

    from dj_brdf_torch import fresnel
    from dj_brdf_torch.io import synth
    from dj_brdf_torch.io.merl_io import save_merl
    from dj_brdf_torch.microfacet import brdf as mf
    from dj_brdf_torch.microfacet.ndf import GGX, Beckmann
    from dj_brdf_torch.microfacet.params import MicrofacetParams
    from dj_brdf_torch.models.lambert import Lambert

    def vec(*x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    def material(dist, alpha, f0, kd):
        def eval_fn(i, o):
            spec = mf.eval(dist, fresnel.Schlick(f0=vec(*f0)),
                           MicrofacetParams.isotropic(vec(alpha)[0]), i, o)
            return spec + Lambert(reflectance=vec(*kd)).eval(i, o)
        return eval_fn

    corpus = {
        "synth-ggx-rough": material(GGX(), 0.4, [0.9, 0.6, 0.3],
                                    [0.2, 0.1, 0.05]),
        "synth-ggx-smooth": material(GGX(), 0.12, [0.95, 0.93, 0.88],
                                     [0.02, 0.02, 0.02]),
        "synth-beckmann-mid": material(Beckmann(), 0.25, [0.5, 0.5, 0.5],
                                       [0.1, 0.15, 0.1]),
    }
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for name, eval_fn in corpus.items():
        path = os.path.join(outdir, f"{name}.binary")
        if not os.path.exists(path):
            save_merl(path, synth.bake_merl(eval_fn, device=device).cpu()
                      .numpy())
        paths.append(path)
    return paths


def our_fits(paths: list[str], res: int, chunk: int = 16, device="cuda"):
    """Batched tabulation + moment fits on ``device`` -> {name: (ab, ag)}."""
    import numpy as np
    import torch

    from dj_brdf_torch.fit.batch import tabulate_merl_batch
    from dj_brdf_torch.io.merl_io import load_merl

    out = {}
    for k in range(0, len(paths), chunk):
        batch = paths[k:k + chunk]
        tables = torch.as_tensor(np.stack([load_merl(p) for p in batch]),
                                 device=device)
        _, _, ab, ag = tabulate_merl_batch(tables, res)
        for p, b, g in zip(batch, ab.tolist(), ag.tolist()):
            name = os.path.splitext(os.path.basename(p))[0]
            out[name] = (float(b), float(g))
    return out


def oracle_fits(paths: list[str], res: int):
    """C++ reference fits on the same files -> {name: (ab, ag)}, or None
    where the oracle (``tests/oracle``: numpy and ``g++`` on the
    reference header) is not available."""
    if _ROOT not in sys.path:
        sys.path.insert(0, _ROOT)
    try:
        import tests.oracle as orc
    except ImportError:
        return None

    if not orc.available():
        return None
    out = {}
    for p in paths:
        golden = orc.run_sections("tabular_merl", p, res)
        name = os.path.splitext(os.path.basename(p))[0]
        out[name] = (float(golden["fit_beckmann"]), float(golden["fit_ggx"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate MERL roughness fits (oracle + pinned table)")
    ap.add_argument("--data", default=os.environ.get("DJ_MERL_DATA", ""),
                    help="directory of real MERL .binary files "
                         "(default: $DJ_MERL_DATA; synthetic corpus if unset)")
    ap.add_argument("--res", type=int, default=90)
    ap.add_argument("--no-oracle", action="store_true",
                    help="skip the C++ oracle comparison")
    ap.add_argument("--update-pinned", action="store_true",
                    help="write oracle-verified alphas into the pinned table")
    device_arg(ap)
    args = ap.parse_args(argv)
    device = checked_device(args.device)

    paths = sorted(glob.glob(os.path.join(args.data, "*.binary"))) \
        if args.data else []
    synthetic = not paths
    if synthetic:
        print("# no measured data found — baking the synthetic corpus",
              file=sys.stderr)
        paths = bake_synthetic_corpus(SYNTH_DIR, device)
    if not paths:
        print("nothing to validate", file=sys.stderr)
        return 2

    ours = our_fits(paths, args.res, device=device)
    golden = None if args.no_oracle else oracle_fits(paths, args.res)
    if golden is None and not args.no_oracle:
        print("# C++ oracle unavailable (no g++ or reference); "
              "pinned-table check only", file=sys.stderr)

    pinned = {}
    if os.path.exists(PINNED):
        with open(PINNED) as f:
            pinned = json.load(f)

    failures = 0
    for name, (ab, ag) in sorted(ours.items()):
        line = f"{name}: beckmann {ab:.6f} ggx {ag:.6f}"
        if golden is not None:
            gb, gg = golden[name]
            rb = abs(ab - gb) / gb
            rg = abs(ag - gg) / gg
            ok = rb < ORACLE_RTOL and rg < ORACLE_RTOL
            line += f"  | oracle {gb:.6f}/{gg:.6f} rel {rb:.1e}/{rg:.1e}" \
                    + ("" if ok else "  ORACLE MISMATCH")
            failures += not ok
        if name in pinned and pinned[name].get("res", args.res) == args.res:
            pb, pg = pinned[name]["beckmann"], pinned[name]["ggx"]
            ok = (abs(ab - pb) / pb < PINNED_RTOL
                  and abs(ag - pg) / pg < PINNED_RTOL)
            line += "  | pinned ok" if ok else \
                f"  | PINNED MISMATCH (expected {pb:.6f}/{pg:.6f})"
            failures += not ok
        else:
            line += "  | not pinned"
        print(line)

    if args.update_pinned:
        src = golden if golden is not None else ours
        if golden is None:
            print("# WARNING: pinning OUR fits without oracle verification",
                  file=sys.stderr)
        for name, (ab, ag) in src.items():
            pinned[name] = {"beckmann": ab, "ggx": ag,
                            "source": "oracle" if golden else "self",
                            "synthetic": synthetic, "res": args.res}
        with open(PINNED, "w") as f:
            json.dump(pinned, f, indent=1, sort_keys=True)
        print(f"# pinned table updated: {PINNED}", file=sys.stderr)

    print(f"# {len(ours)} materials, {failures} failures on {device}",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
