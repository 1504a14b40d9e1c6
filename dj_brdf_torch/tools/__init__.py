"""The port's counterparts of the JAX system's tools at the repo root:
``bench_scaling`` (data-parallel fit-step throughput against the world
size) and ``validate_merl_fits`` (MERL roughness fits against the C++
oracle and a pinned table). Run each with ``python -m
dj_brdf_torch.tools.<name>``."""
