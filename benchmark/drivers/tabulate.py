"""Tabulation calls on a MERL database: the closed loop of
``merl100.tabulate``.

One unit is one call of the program's ``tabulate_merl_batch`` on the
next database of the ring, with the Beckmann and GGX alphas back on the
host. A unit's items are the database's materials.

The check: every call's alphas against the reference's tabulation of
its database, and every table of the calls kept from the whole window by
reservoir sampling from the seed (the slope table p22, the projected
areas, the CDF and its inverse, the Fresnel points) against the same.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import Reservoir, generator

DATABASE, CHECK_CALLS = 0, 1
#: the tables compared by their relative gap; the inverse CDF ``qf`` is
#: compared in steps of its grid, since it is a step function of the
#: CDF: a CDF value an ulp from a node moves it one step
TABLES = ("p22", "sigma", "cdf", "fresnel")


def setup(ctx):
    from dj_brdf_torch.fit.batch import tabulate_merl_batch

    cfg, ref = ctx.cell.config, ctx.cell.reference
    tables = []
    for d in range(cfg["ring"]):
        alpha, f0 = ref.database_params(
            cfg["materials"], cfg["alpha_range"], cfg["f0_range"],
            generator(ctx.seed, DATABASE, d, device=ctx.device), ctx.device)
        tables.append(ref.bake_database(alpha, f0))
    kept = Reservoir(ctx.seed, CHECK_CALLS,
                     ctx.cell.traffic["check"]["calls"])
    return {"tables": tables, "tabulate": tabulate_merl_batch,
            "kept": kept}


def _call(ctx, state, k):
    tables = state["tables"][k % len(state["tables"])]
    with ctx.spans("tabulate_merl_batch"):
        return state["tabulate"](tables, ctx.cell.config["tabulation_res"])


def warmup(ctx, state):
    for d in range(len(state["tables"])):
        _call(ctx, state, d)


def unit(ctx, state, k):
    t0 = time.perf_counter()
    dists, fres, ab, ag = _call(ctx, state, k)
    with ctx.spans("readback"):
        out = {"items": ab.shape[0], "k": k,
               "alpha_beckmann": ab.cpu().numpy(),
               "alpha_ggx": ag.cpu().numpy()}
    out["latency_s"] = time.perf_counter() - t0
    state["kept"].offer(k, {"p22": dists.p22, "sigma": dists.sigma,
                            "cdf": dists.cdf, "qf": dists.qf,
                            "fresnel": fres})
    return out


def release(ctx, state):
    """Hand on the ring of tables and the kept calls' tables."""
    tables, kept = state["tables"], state["kept"].kept
    state.clear()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return tables, kept


def _rel(got, want):
    """Per material, the widest gap over the widest reference entry."""
    got, want = got.double(), want.double()
    dims = tuple(range(1, want.dim()))
    scale = want.abs().amax(dim=dims).clamp_min(1e-30) if dims \
        else want.abs().clamp_min(1e-30)
    gap = (got - want).abs().amax(dim=dims) if dims else (got - want).abs()
    return float((gap / scale).max())


def check(ctx, inputs, records):
    """(numbers, failed): ``alpha_rel_err``, the widest relative gap of a
    Beckmann or GGX alpha over every call; ``tables_rel_err``, the widest
    gap of a kept call's table (p22, sigma, CDF, Fresnel points) over
    its largest reference entry; ``qf_step_gap``, the widest gap of its
    inverse CDF in steps of that table's grid. ``failed`` counts the
    calls beyond a limit."""
    tables_ring, kept = inputs
    ref, limits = ctx.cell.reference, ctx.cell.traffic["limits"]
    res = ctx.cell.config["tabulation_res"]
    want = [ref.tabulate(t, res) for t in tables_ring]
    control = ([ref.tabulate(t, res, dtype=torch.bfloat16)
                for t in tables_ring] if ctx.control else None)
    worst_a = worst_t = worst_q = 0.0
    bad = 0
    for rec in records:
        d = rec["k"] % len(tables_ring)
        w = want[d]
        got = control[d] if control else {
            "alpha_beckmann": torch.as_tensor(rec["alpha_beckmann"]),
            "alpha_ggx": torch.as_tensor(rec["alpha_ggx"]),
            **kept.get(rec["k"], {})}
        a = max(_rel(got[name].to(w[name].device)[:, None],
                     w[name][:, None])
                for name in ("alpha_beckmann", "alpha_ggx"))
        t = q = 0.0
        if rec["k"] in kept:
            t = max(_rel(got[name], w[name]) for name in TABLES)
            q = float((got["qf"].double() - w["qf"].double()).abs().max()
                      * (8 * (res - 1)))
        worst_a, worst_t = max(worst_a, a), max(worst_t, t)
        worst_q = max(worst_q, q)
        bad += (a > limits["alpha_rel_err"] or t > limits["tables_rel_err"]
                or q > limits["qf_step_gap"])
    ctx.log(f"tabulate check: {len(records)} calls, the tables of calls "
            f"{sorted(kept)}")
    return {"alpha_rel_err": worst_a, "tables_rel_err": worst_t,
            "qf_step_gap": worst_q}, bad
