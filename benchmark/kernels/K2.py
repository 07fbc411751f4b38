"""K2: the reflection warp of the previous frame and of the sparse code
(``ops.cuda_aug.warp_reflect``).

Work: the image read and the output written once, the f32 flow read;
operations 40 a pixel for the grid and the reflection plus 8 a channel
for the blend, on the CUDA cores (chip_smoke.py's count)."""

TARGETS = [("cista_flow_torch.ops.cuda_aug", "warp_reflect")]


def work(img, flow, sign, gate=None, row0=0):
    b, c, _, w = img.shape
    rows = flow.shape[2]
    nbytes = (img.numel() + b * c * rows * w) * img.element_size() + flow.numel() * 4
    return nbytes, b * rows * w * (40 + 8 * c), "float32"
