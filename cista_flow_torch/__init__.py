"""PyTorch/CUDA port of cista_flow_tpu for NVIDIA Hopper (H100).

The same functions as the JAX package, NCHW/OIHW, with each Pallas kernel
on the serving path replaced by a CUDA kernel written for sm_90a
(``csrc/``, bound in ``ops/cuda_*.py``). Entry points run on the GPU unless
the caller passes ``device="cpu"``, where the kernels' plain PyTorch
versions run instead.
"""
