"""The benchmark of dj_brdf_torch on one card: see ``run.py``."""
