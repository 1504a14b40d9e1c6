from dj_brdf_torch.fit import batch, lsq
