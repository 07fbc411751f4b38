"""K3: CISTA-LSTC's tied ISTA loop and the Dg conv (``ops.cuda_ista2.fused_ista_dg``).

Work: x1 and z read, z and rec written, the weights read once;
operations 2*depth + 1 reflect-padded 3x3 convs between C and 2C
channels (chip_smoke.py's count)."""

TARGETS = [("cista_flow_torch.ops.cuda_ista2", "fused_ista_dg")]


def work(w, gw, gb, x1, z, depth):
    b, c, h, wd = x1.shape
    es = x1.element_size()
    nbytes = (2 * x1.numel() + 2 * z.numel() + sum(t.numel() for t in w)
              + gw.numel() + gb.numel()) * es
    ops = (2 * depth + 1) * 2 * 9 * (2 * c) * c * b * h * wd
    return nbytes, ops, "bfloat16" if es == 2 else "float32"
