"""K5: the square 3x3 convs of 64 and 128 channels (``ops.cuda_conv.conv3x3``).

Work: the input read and the output written once, the weights and bias
read; 2 * 9 * C * C operations a pixel (chip_smoke.py's count)."""

TARGETS = [("cista_flow_torch.ops.cuda_conv", "conv3x3")]


def work(x, w, b=None, padding_mode="zeros", relu=False):
    n, c, h, wd = x.shape
    es = x.element_size()
    nbytes = (2 * x.numel() + w.numel() + (0 if b is None else b.numel())) * es
    return nbytes, 2 * 9 * c * c * n * h * wd, "bfloat16" if es == 2 else "float32"
