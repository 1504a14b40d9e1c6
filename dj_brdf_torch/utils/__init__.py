"""Checkpoints and profiling (the JAX package's ``utils``)."""

from dj_brdf_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dj_brdf_torch.utils.profiling import Throughput, trace
