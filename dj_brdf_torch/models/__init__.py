from dj_brdf_torch.models.lambert import Lambert
from dj_brdf_torch.models.merl import Merl
from dj_brdf_torch.models.utia import Utia
from dj_brdf_torch.models.sgd import SGD
from dj_brdf_torch.models.abc_model import ABC
