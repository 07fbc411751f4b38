"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): HBM bandwidth and the operation rates a kernel's
roofline and the whole step's share of the peak are held against. bf16
is the tensor cores' rate; f32 the CUDA cores' (the port runs its f32 and
its elementwise work there)."""

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
STEP_PEAK = PEAK_OPS["bfloat16"]      # mfu: the card's bf16 peak


def least_seconds(nbytes: float, ops: float, dtype: str) -> float:
    """The least time a call can take: the larger of its bytes at the HBM
    rate and its operations at the dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])
