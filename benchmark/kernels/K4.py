"""K4: instance norm with its fused relu (``ops.cuda_norm.instance_norm_fused``).

Work: the input read and the output written once; 6 operations an
element on the CUDA cores (chip_smoke.py's count)."""

TARGETS = [("cista_flow_torch.ops.cuda_norm", "instance_norm_fused")]


def work(x, eps=1e-5, relu=False):
    return 2 * x.numel() * x.element_size(), 6 * x.numel(), "float32"
