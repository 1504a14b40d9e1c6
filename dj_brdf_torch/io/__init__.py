from dj_brdf_torch.io.merl_io import load_merl, save_merl
from dj_brdf_torch.io.utia_io import load_utia, save_utia
