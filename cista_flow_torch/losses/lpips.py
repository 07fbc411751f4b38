"""LPIPS, the perceptual distance of the reconstruction loss (NCHW).

Counterpart of cista_flow_tpu/losses/lpips.py (ref: utils/evaluate.py:45-68,
loss.py:307-343, ``lpips.LPIPS(net='alex')`` with 1->3 channel tiling and
``normalize=True``): the scaling layer, AlexNet's five conv stages (or
VGG16's thirteen convs) with a tap after each stage's relu, each tap
unit-normalised over its channels, the squared difference through a learned
1x1 head, its spatial mean, summed over the taps. The convs are
``F.conv2d``: the JAX package computes them outside any Pallas kernel
(cista_flow_tpu/ops/conv.py:268, its Pallas route off by default).

Parameters are ``{'convs': [{'w': OIHW, 'b': (Cout,)}], 'lins': [{'w':
(1, C, 1, 1)}]}`` of f32 tensors; the network is AlexNet with 5 convs and
VGG16 with 13. ``init(seed)`` makes random ones (the repo holds no trained
LPIPS weights); ``load_npz``/``save_npz`` read and write the JAX package's
npz layout (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{i}_w``), which
``convert_lpips.py`` writes; ``load_weights`` also takes a full
``lpips.LPIPS`` state dict; ``params_from_env`` reads ``CISTA_LPIPS``,
``CISTA_LPIPS_ALEX`` or ``CISTA_LPIPS_VGG``. The distance runs in f32 (f64
where its inputs are).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.autograd import at_least_f32

# (out, in, kernel, stride, pad) of torchvision AlexNet's feature convs
ALEX = [(64, 3, 11, 4, 2), (192, 64, 5, 1, 2), (384, 192, 3, 1, 1),
        (256, 384, 3, 1, 1), (256, 256, 3, 1, 1)]
# VGG16 (out, in) per stage; taps after relu{1_2, 2_2, 3_3, 4_3, 5_3}, a 2x2
# max pool after every tap but the last
VGG = [[(64, 3), (64, 64)], [(128, 64), (128, 128)],
       [(256, 128), (256, 256), (256, 256)], [(512, 256), (512, 512), (512, 512)],
       [(512, 512), (512, 512), (512, 512)]]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
ENV_VARS = ("CISTA_LPIPS", "CISTA_LPIPS_ALEX", "CISTA_LPIPS_VGG")


def init(seed: int = 0, net: str = "alex") -> dict:
    """Random parameters from ``seed``: He-normal convs, zero biases,
    |N(0, 0.01)| heads."""
    rng = np.random.default_rng(seed)
    if net == "alex":
        shapes = [(cout, cin, k) for cout, cin, k, _, _ in ALEX]
        taps = [cout for cout, *_ in ALEX]
    elif net == "vgg":
        shapes = [(cout, cin, 3) for stage in VGG for cout, cin in stage]
        taps = [stage[-1][0] for stage in VGG]
    else:
        raise ValueError(f"net {net!r} is not alex or vgg")

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    convs = [{"w": t(rng.standard_normal((o, i, k, k)) * np.sqrt(2.0 / (i * k * k))),
              "b": t(np.zeros(o))} for o, i, k in shapes]
    lins = [{"w": t(np.abs(0.01 * rng.standard_normal((1, c, 1, 1))))} for c in taps]
    return {"convs": convs, "lins": lins}


def to(params: dict, device) -> dict:
    """``params`` with every tensor on ``device``."""
    return {k: [{n: v.to(device) for n, v in p.items()} for p in ps]
            for k, ps in params.items()}


def _features(params: dict, x: torch.Tensor) -> list:
    convs, taps = params["convs"], []
    if len(convs) == len(ALEX):
        for i, (_, _, _, stride, pad) in enumerate(ALEX):
            x = torch.relu(F.conv2d(x, convs[i]["w"], convs[i].get("b"), stride, pad))
            taps.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return taps
    i = 0
    for si, stage in enumerate(VGG):
        for _ in stage:
            x = torch.relu(F.conv2d(x, convs[i]["w"], convs[i].get("b"), 1, 1))
            i += 1
        taps.append(x)
        if si < len(VGG) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


def lpips(params: dict, pred: torch.Tensor, target: torch.Tensor,
          normalize: bool = True) -> torch.Tensor:
    """The mean LPIPS distance of (B, 1 or 3, H, W) images, in [0, 1] with
    ``normalize``, else in [-1, 1]; a 0-dim f32 tensor (f64 for f64 inputs
    and parameters)."""
    pred, target = at_least_f32(pred), at_least_f32(target)
    if pred.shape[1] == 1:
        pred, target = pred.expand(-1, 3, -1, -1), target.expand(-1, 3, -1, -1)
    if normalize:
        pred, target = 2.0 * pred - 1.0, 2.0 * target - 1.0
    shift = torch.tensor(SHIFT, dtype=torch.float32, device=pred.device).view(1, 3, 1, 1)
    scale = torch.tensor(SCALE, dtype=torch.float32, device=pred.device).view(1, 3, 1, 1)
    shift, scale = shift.to(pred.dtype), scale.to(pred.dtype)
    f1 = _features(params, (pred - shift) / scale)
    f2 = _features(params, (target - shift) / scale)
    total = 0.0
    for lin, a, b in zip(params["lins"], f1, f2):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + torch.mean(F.conv2d(d, lin["w"]), dim=(1, 2, 3))
    return torch.mean(total)


def save_npz(params: dict, path: str) -> None:
    """The JAX package's npz layout: ``conv{i}_w`` (HWIO), ``conv{i}_b``,
    ``lin{i}_w`` (1, 1, C, 1)."""
    flat = {}
    for i, p in enumerate(params["convs"]):
        flat[f"conv{i}_w"] = p["w"].detach().cpu().numpy().transpose(2, 3, 1, 0)
        if p.get("b") is not None:
            flat[f"conv{i}_b"] = p["b"].detach().cpu().numpy()
    for i, p in enumerate(params["lins"]):
        flat[f"lin{i}_w"] = p["w"].detach().cpu().numpy().transpose(2, 3, 1, 0)
    np.savez(path, **flat)


def load_npz(path: str) -> dict:
    """Parameters from the JAX package's npz layout (``save_npz``)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    with np.load(path) as z:
        n_convs = sum(1 for k in z.files if k.startswith("conv") and k.endswith("_w"))
        n_lins = sum(1 for k in z.files if k.startswith("lin"))
        convs = []
        for i in range(n_convs):
            p = {"w": t(z[f"conv{i}_w"].transpose(3, 2, 0, 1))}
            if f"conv{i}_b" in z.files:
                p["b"] = t(z[f"conv{i}_b"])
            convs.append(p)
        lins = [{"w": t(z[f"lin{i}_w"].transpose(3, 2, 0, 1))} for i in range(n_lins)]
    return {"convs": convs, "lins": lins}


def load_weights(path: str) -> dict:
    """Parameters from a converted ``.npz`` or from a full ``lpips.LPIPS``
    state dict (``net.slice{s}.{i}.weight`` convs, ``lin{i}.model.1.weight``
    heads; cista_flow_tpu/losses/lpips.py ``load_torch_weights``)."""
    if path.endswith(".npz"):
        return load_npz(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    keys = sorted((k for k in sd if k.startswith("net.") and k.endswith(".weight")
                   and sd[k].ndim == 4),
                  key=lambda k: (int(k.split(".")[1][5:]), int(k.split(".")[2])))
    convs = [{"w": sd[k].float(), "b": sd[k[:-6] + "bias"].float()} for k in keys]
    lins, i = [], 0
    while f"lin{i}.model.1.weight" in sd:
        lins.append({"w": sd[f"lin{i}.model.1.weight"].float()})
        i += 1
    return {"convs": convs, "lins": lins}


def params_from_env(env_vars=ENV_VARS) -> dict | None:
    """The weights named by the first of ``env_vars`` that points at a file
    (the reference's default net is 'alex': loss.py:307), or None."""
    for var in env_vars:
        path = os.environ.get(var)
        if path and os.path.exists(path):
            params = load_weights(path)
            print(f"Loaded LPIPS weights from {var}={path} "
                  f"({len(params['convs'])} convs)")
            return params
    return None
