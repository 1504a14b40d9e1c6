from dj_brdf_torch.lean.lrep import Lrep, params_to_lrep, lrep_to_params
from dj_brdf_torch.lean import maps
from dj_brdf_torch.lean.filtered import (filtered_params,
                                         FilteredBeckmannMaterial)
