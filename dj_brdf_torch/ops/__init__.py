from dj_brdf_torch.ops import soa
