"""dj_brdf_torch — the PyTorch/CUDA port of dj_brdf_tpu.

A port of the JAX package ``dj_brdf_tpu`` (itself modelled on the
dj_brdf C++ toolkit, jdupuy/dj_brdf, ``dj_brdf.h``) to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper. The port mirrors the JAX
package's module tree. Ported so far: the fitting step (the core
math, Fresnel models, the analytic microfacet distributions'
evaluation, the SoA fit loss with its hand adjoint, the fused fit
kernel, and the ``fit_lsq`` / ``fit_materials`` fitters), and measured
data with its tabulation (MERL file I/O, the ``Merl`` model with its
lookup kernel, synthetic baking, the ``Tabular`` distribution, the
power-iteration pipeline, moment fits, ``tabulate_merl_batch`` and the
``merl_params`` program), and the renderer's delta-light path (VNDF
sampling, the fused SoA samplers, ``render_sphere`` and the ``entry()``
forward, the renderer materials and ``render.pathtrace.render``), with
the autodiff cross-check of the fit step (``adjoint="ad"``) and its
kernel.

Conventions (match the reference, dj_brdf.h:23-26):
  * ``i`` is the direction toward the light, ``o`` toward the viewer.
  * Directions are tensors of shape ``(..., 3)`` in the local shading
    frame with ``z`` the geometric normal.
  * All functions broadcast over leading batch dimensions and run on
    the device of their input tensors.
"""

from dj_brdf_torch import config
from dj_brdf_torch.core import math as vecmath
from dj_brdf_torch.core import special, spline
from dj_brdf_torch import fresnel
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.microfacet.ndf import GGX, GGXSphericalCaps, Beckmann, Tabular
from dj_brdf_torch.microfacet import brdf as microfacet
from dj_brdf_torch.models.lambert import Lambert
from dj_brdf_torch.models.merl import Merl
from dj_brdf_torch.render.materials import (
    MicrofacetMaterial, MeasuredMaterial, CosineMaterial, ConductorWrap)
from dj_brdf_torch import io

__version__ = "0.1.0"
