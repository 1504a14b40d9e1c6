"""Fit jobs on a MERL database: the closed loop of ``merl100.fit``.

One unit is one job: a fresh shared direction set drawn from (seed,
job), the program's ``merl_targets`` on the next database of the ring,
its ``fit_materials`` for the traffic's steps, and the (M,) parameters
and losses back on the host. A unit's items are its materials.

The check: every job's targets at entries drawn from the seed against
the reference's lookup, and the fits of sampled jobs' sampled materials
against the reference's own fit of the reference's targets, from the
same start, by the same Adam, in float64.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import generator, sample_indices, sub_seed

PARAMS = ("ax", "ay", "rho", "txn", "tyn", "f0r", "f0g", "f0b")
# keys of the seed's streams
DATABASE, DIRECTIONS, ENTRIES, CHECK_JOBS, CHECK_MATERIALS, WARM = range(6)


def setup(ctx):
    from dj_brdf_torch.fit.batch import fit_materials, merl_targets

    cfg, ref = ctx.cell.config, ctx.cell.reference
    m = cfg["materials"]
    tables = []
    for d in range(cfg["ring"]):
        alpha, f0 = ref.database_params(
            m, cfg["alpha_range"], cfg["f0_range"],
            generator(ctx.seed, DATABASE, d, device=ctx.device), ctx.device)
        tables.append(ref.bake_database(alpha, f0))
    return {"tables": tables, "merl_targets": merl_targets,
            "fit_materials": fit_materials}


def _directions(ctx, key, k):
    return ctx.cell.reference.direction_set(
        ctx.cell.config["directions"],
        generator(ctx.seed, key, k, device=ctx.device), ctx.device)


def _job(ctx, state, key, k):
    tr, spans = ctx.cell.traffic, ctx.spans
    tables = state["tables"][k % len(state["tables"])]
    with spans("make_inputs"):
        i, o = _directions(ctx, key, k)
    with spans("merl_targets", sync=ctx.trace):
        targets = state["merl_targets"](tables, i, o)
    with spans("fit_materials"):
        params, fres, losses = state["fit_materials"](
            targets, i, o, steps=tr["steps"], lr=tr["lr"])
    return targets, params, fres, losses


def warmup(ctx, state):
    _job(ctx, state, WARM, 0)


def _entries(ctx, k):
    """(material, row) of the target entries job ``k`` keeps."""
    cfg = ctx.cell.config
    gen = generator(ctx.seed, ENTRIES, k, device=ctx.device)
    n_keep = ctx.cell.traffic["check"]["target_entries"]
    return tuple(torch.randint(size, (n_keep,), generator=gen,
                               device=ctx.device)
                 for size in (cfg["materials"], cfg["directions"]))


def unit(ctx, state, k):
    t0 = time.perf_counter()
    targets, params, fres, losses = _job(ctx, state, DIRECTIONS, k)
    mat, row = _entries(ctx, k)
    with ctx.spans("readback"):
        pvec = torch.stack([params.ax, params.ay, params.rho, params.txn,
                            params.tyn, *fres.f0.unbind(-1)], -1).cpu()
        out = {"items": targets.shape[0], "k": k, "pvec": pvec.numpy(),
               "loss": losses.cpu().numpy(),
               "entries": targets[mat, row].cpu().numpy()}
    out["latency_s"] = time.perf_counter() - t0
    return out


def release(ctx, state):
    """Drop the program's references; hand on the inputs the check
    needs (the ring of tables the benchmark made)."""
    tables = state["tables"]
    state.clear()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return tables


def check(ctx, tables_ring, records):
    """(numbers, failed): ``targets_rel_l2``, the widest relative L2 gap
    of a job's kept target entries; ``param_gap``, the widest gap of a
    fitted parameter; ``loss_gap``, the widest relative gap of a last
    step's loss. ``failed`` counts the jobs beyond a limit."""
    ref, tr, cfg = ctx.cell.reference, ctx.cell.traffic, ctx.cell.config
    limits, chk = tr["limits"], tr["check"]
    low = torch.bfloat16 if ctx.control else torch.float32
    bad = set()
    worst_t = 0.0
    for rec in records:
        k = rec["k"]
        tables = tables_ring[k % len(tables_ring)]
        i, o = _directions(ctx, DIRECTIONS, k)
        mat, row = _entries(ctx, k)
        want = ref.lookup_entries(tables, i, o, mat, row).double()
        got = (ref.lookup_entries(tables, i, o, mat, row, dtype=low)
               if ctx.control else torch.as_tensor(rec["entries"],
                                                   device=ctx.device))
        gap = float(torch.linalg.vector_norm(got.double() - want)
                    / torch.linalg.vector_norm(want).clamp_min(1e-30))
        worst_t = max(worst_t, gap)
        if gap > limits["targets_rel_l2"]:
            bad.add(k)

    worst_p = worst_l = 0.0
    for j in sample_indices(ctx.seed, CHECK_JOBS, len(records),
                            chk["jobs"]):
        rec = records[j]
        k = rec["k"]
        tables = tables_ring[k % len(tables_ring)]
        mats = sample_indices(sub_seed(ctx.seed, k), CHECK_MATERIALS,
                              cfg["materials"], chk["materials"])
        i, o = _directions(ctx, DIRECTIONS, k)
        sel = torch.as_tensor(mats, device=ctx.device)

        def fitted(dtype):
            targets = ref.lookup(tables[sel], i, o,
                                 dtype=low if dtype == torch.bfloat16
                                 else torch.float32)
            return ref.fit(targets, i, o, tr["steps"], tr["lr"],
                           cfg["materials"], tr["init_alpha"],
                           tr["init_f0"], dtype=dtype)

        want_p, want_l = fitted(torch.float64)
        if ctx.control:
            got_p, got_l = fitted(torch.bfloat16)
        else:
            got_p = torch.as_tensor(rec["pvec"][mats], device=ctx.device)
            got_l = torch.as_tensor(rec["loss"][mats], device=ctx.device)
        gaps = (got_p.double() - want_p).abs()
        l_gaps = ((got_l.double() - want_l).abs()
                  / want_l.abs().clamp_min(1e-30))
        p_gap, l_gap = float(gaps.max()), float(l_gaps.max())
        worst_p, worst_l = max(worst_p, p_gap), max(worst_l, l_gap)
        if p_gap > limits["param_gap"] or l_gap > limits["loss_gap"]:
            bad.add(k)
        j, c = divmod(int(gaps.argmax()), gaps.shape[1])
        ctx.log(f"fit check: job {k}, materials {mats}: parameter gap "
                f"{p_gap!r} (material {mats[j]}, parameter {PARAMS[c]}, "
                f"reference {float(want_p[j, c])!r}, its loss "
                f"{float(want_l[j])!r}), loss gap {l_gap!r} (material "
                f"{mats[int(l_gaps.argmax())]})")
    return ({"targets_rel_l2": worst_t, "param_gap": worst_p,
             "loss_gap": worst_l}, len(bad))
