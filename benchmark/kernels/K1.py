"""K1: the correlation window lookup with its fused convc1 (``ops.cuda_corr.lookup``).

Work: each sample reads a 10 x 10 block of every pyramid level (the 9 x 9
bilinear window's corners), clipped to the level, and its coordinates;
it writes 256 channels (324 without the projection). Operations: the
324 -> 256 projection and the bilinear blend, 12 per tap."""

TARGETS = [("cista_flow_torch.ops.cuda_corr", "lookup")]


def work(pyr, coords, weight=None, bias=None):
    b, _, h1, w1 = coords.shape
    n = b * h1 * w1
    es = pyr.levels[0].element_size()
    entries = sum(min(100, lv.shape[1] * lv.shape[2]) for lv in pyr.levels)
    nbytes = n * entries * es + coords.numel() * 4
    ops = n * 324 * 12
    if weight is None:
        nbytes += n * 324 * es
    else:
        nbytes += weight.numel() * es + bias.numel() * 4 + n * 256 * es
        ops += n * 2 * 324 * 256
    return nbytes, ops, "bfloat16" if es == 2 else "float32"
