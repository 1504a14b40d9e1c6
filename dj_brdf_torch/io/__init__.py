from dj_brdf_torch.io.merl_io import load_merl, save_merl
