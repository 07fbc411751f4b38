"""Tensor ops and the CUDA kernel wrappers (``cuda_*.py``)."""
