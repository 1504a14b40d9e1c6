from dj_brdf_torch.core import math, special, spline
from dj_brdf_torch.core.pytree import pytree_dataclass, static_field
