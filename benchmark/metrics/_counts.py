"""The yardstick's frozen counts: the card's peaks and the work of one
fused fit step, which no later change to the program moves.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet (dense, no sparsity):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.

The fit step's work (the bound of the program's bench at the time the
benchmark was written, from the SASS of the fused fit kernel's sm_90a
build, an FMA counted as two operations and a MUFU as one):

- bytes: the (N, 3) directions twice as SoA planes (24 N), the (M, N, 3)
  targets (12 M N), the (M, 8) parameters read and the (M, 9) sums
  written (68 M), each once;
- operations: 244 a (material, sample) pair for GGX (405 for Beckmann)
  and 38 a sample for loading the directions.
"""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_PAIR = {"ggx": 244, "beckmann": 405}
OPS_PER_SAMPLE = 38


def fit_step_bytes(m: int, n: int) -> int:
    return 24 * n + 12 * m * n + 68 * m


def fit_step_ops(m: int, n: int, family: str = "ggx") -> int:
    return OPS_PER_PAIR[family] * m * n + OPS_PER_SAMPLE * n


def fit_step_bound_s(m: int, n: int, family: str = "ggx") -> float:
    """The least time one fit step of M materials over N shared samples
    can take on the card: its bytes at the HBM rate or its operations at
    the float32 rate, whichever is longer."""
    return max(fit_step_bytes(m, n) / HBM_BYTES_PER_S,
               fit_step_ops(m, n, family) / F32_OPS_PER_S)
