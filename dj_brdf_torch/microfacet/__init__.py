from dj_brdf_torch.microfacet.params import (
    MicrofacetParams,
    ellipse_to_pdfparams,
    pdfparams_to_ellipse,
)
from dj_brdf_torch.microfacet.ndf import GGX, Beckmann, GGXSphericalCaps
from dj_brdf_torch.microfacet import brdf
