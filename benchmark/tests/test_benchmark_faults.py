"""The check against faults planted in the program underneath a run
that the harness drives as on the card (the look for a card skipped):
each fault a cell can have makes ``correct`` come out false."""

from __future__ import annotations

import pytest
import torch

from conftest import run_tiny


def _fit_stuck(monkeypatch):
    """A step that returns its state unchanged: Adam never moves."""
    from dj_brdf_torch.fit import lsq

    def adam_loop(vg, raw, data, steps, lr):
        val, _ = vg(raw, *data)
        return (lsq.RawFit(*(t.detach().clone() for t in raw)),
                torch.stack([val] * steps))
    monkeypatch.setattr(lsq, "adam_loop", adam_loop)


def _fit_half(monkeypatch):
    """Half of the samples left out, the mean taken over the rest."""
    from dj_brdf_torch.fit import batch

    real = batch.fit_materials

    def fit_materials(targets, i, o, **kw):
        n = i.shape[0] // 2
        return real(targets[:, :n], i[:n], o[:n], **kw)
    monkeypatch.setattr(batch, "fit_materials", fit_materials)


def _fit_altered(monkeypatch):
    """A fitted parameter altered where it is produced."""
    from dj_brdf_torch.fit import batch

    real = batch.fit_materials

    def fit_materials(*a, **kw):
        params, fres, losses = real(*a, **kw)
        ax = params.ax.clone()
        ax[0] = ax[0] * 1.05
        return params.replace(ax=ax), fres, losses
    monkeypatch.setattr(batch, "fit_materials", fit_materials)


def _targets_altered(monkeypatch):
    """The lookup's answers altered where they are produced."""
    from dj_brdf_torch.fit import batch

    real = batch.merl_targets
    monkeypatch.setattr(batch, "merl_targets",
                        lambda *a: real(*a) * (1.0 + 1e-2))


def _tab_stuck(monkeypatch):
    """The power iteration returns its start unchanged."""
    from dj_brdf_torch.fit import tabular

    real = tabular._power_iteration
    monkeypatch.setattr(tabular, "_power_iteration",
                        lambda a, iterations=4: real(a, 0))


def _tab_half(monkeypatch):
    """Half of the batch of materials left out: the first half's
    answers stand in for the rest."""
    from dj_brdf_torch.fit import batch

    real = batch.tabulate_merl_batch

    def tabulate(tables, res=90, *a, **kw):
        m = tables.shape[0]
        h = max(1, m // 2)
        dists, fres, ab, ag = real(tables[:h], res, *a, **kw)

        def spread(t):
            return t[torch.arange(m) % h]
        return (type(dists)(p22=spread(dists.p22), sigma=spread(dists.sigma),
                            cdf=spread(dists.cdf), qf=spread(dists.qf)),
                spread(fres), spread(ab), spread(ag))
    monkeypatch.setattr(batch, "tabulate_merl_batch", tabulate)


def _tab_altered(monkeypatch):
    from dj_brdf_torch.fit import batch

    real = batch.tabulate_merl_batch

    def tabulate(*a, **kw):
        dists, fres, ab, ag = real(*a, **kw)
        ag = ag.clone()
        ag[0] = ag[0] * 1.05
        return dists, fres, ab, ag
    monkeypatch.setattr(batch, "tabulate_merl_batch", tabulate)


def _render_half(monkeypatch):
    """Half of each pixel's samples left out, the mean over the rest."""
    from dj_brdf_torch.render import pathtrace

    def sample_mean(radiance, spp):
        return radiance.reshape(spp, -1, 3)[: spp // 2].mean(0)
    monkeypatch.setattr(pathtrace, "_sample_mean", sample_mean)


def _render_stuck(monkeypatch):
    """The last bounce returns the path's state unchanged."""
    from dj_brdf_torch.render import pathtrace

    real = pathtrace._trace

    def trace(mats, ld, lr, sky, ro, rd, u, u_env, *a, **kw):
        return real(mats, ld, lr, sky, ro, rd, u[:-1],
                    None if u_env is None else u_env[:-1], *a, **kw)
    monkeypatch.setattr(pathtrace, "_trace", trace)


def _render_stale(monkeypatch):
    """A frame's answer altered: every frame returns the first one."""
    from dj_brdf_torch.render import pathtrace

    real = pathtrace.render
    first = []

    def render(*a, **kw):
        img = real(*a, **kw)
        if not first:
            first.append(img)
        return first[0]
    monkeypatch.setattr(pathtrace, "render", render)


FAULTS = [
    ("merl100.fit", _fit_stuck), ("merl100.fit", _fit_half),
    ("merl100.fit", _fit_altered), ("merl100.fit", _targets_altered),
    ("merl100.tabulate", _tab_stuck), ("merl100.tabulate", _tab_half),
    ("merl100.tabulate", _tab_altered),
    ("preview512.frame", _render_half), ("preview512.frame", _render_stuck),
    ("preview512.frame", _render_stale),
    ("preview512.envmap", _render_half),
    ("preview512.envmap", _render_stuck),
    ("preview512.envmap", _render_stale),
]


@pytest.mark.parametrize("name,plant", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}"
                              for n, f in FAULTS])
def test_fault_is_not_correct(name, plant, monkeypatch):
    plant(monkeypatch)
    result = run_tiny(name, seconds=1.0)
    assert not result["correct"], result["checks"]
