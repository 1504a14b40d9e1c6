from dj_brdf_torch.models.lambert import Lambert
from dj_brdf_torch.models.merl import Merl
