"""Process groups, sharded spherical integrals and the sharded
anisotropic power iteration (the JAX package's ``parallel``), on
``torch.distributed``."""

from dj_brdf_torch.parallel import integrals
from dj_brdf_torch.parallel.mesh import Mesh, init_distributed, make_mesh
