"""Spherical integrals on one device (the JAX package's ``parallel``;
its device meshes come with the distribution slice)."""

from dj_brdf_torch.parallel import integrals
