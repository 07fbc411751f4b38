"""Reference-layout weights for the port.

``load_state_dict`` reads a reference checkpoint (``.npz`` such as the
committed ``gate/*_f16.npz``, or a ``.pth.tar``) into ``{key: ndarray}``,
a JAX-free copy of cista_flow_tpu/ckpt/torch_import.load_state_dict.
``from_jax`` turns the JAX package's parameter tree (numpy arrays, HWIO
convs) into the same key layout, so both packages can compute with one set
of weights.
"""
from __future__ import annotations

import re

import numpy as np

_LISTA = re.compile(r"^(.*lista_blocks\.)(\d+)(\..*)$")


def load_state_dict(path: str) -> dict:
    """{key: np.ndarray} with any ``module.`` prefix stripped and f16 upcast
    to f32 (the compute path casts to its own dtype)."""
    out = {}
    if path.endswith(".npz"):
        with np.load(path) as z:
            for k in z.files:
                v = z[k]
                key = k[7:] if k.startswith("module.") else k
                out[key] = v.astype(np.float32) if v.dtype == np.float16 else v
        return out
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict):
        for k in ("state_dict", "model", "model_state_dict"):
            if k in ckpt:
                ckpt = ckpt[k]
                break
    for k, v in ckpt.items():
        key = k[7:] if k.startswith("module.") else k
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        out[key] = v.astype(np.float32) if v.dtype == np.float16 else v
    return out


def tie_ista_blocks(sd: dict, depth: int) -> dict:
    """The reference registers one tied ISTA block ``depth`` times
    (``lista_blocks.{0..depth-1}``, ref: e2v/e2v_model.py:34-35). Keep block
    0's tensors and repeat them under each index the model has, as the JAX
    importer reads block 0 only (ckpt/torch_import.py:233)."""
    out = {}
    for k, v in sd.items():
        m = _LISTA.match(k)
        if m is None:
            out[k] = v
        elif m.group(2) == "0":
            for i in range(depth):
                out[f"{m.group(1)}{i}{m.group(3)}"] = v
    return out


# ------------------------- JAX parameter tree -> state dict -----------------

def _conv(out, prefix, p):
    out[prefix + ".weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1)))
    if "b" in p:
        out[prefix + ".bias"] = np.asarray(p["b"], np.float32)


def _bn(out, prefix, p, s):
    out[prefix + ".weight"] = np.asarray(p["scale"], np.float32)
    out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)
    out[prefix + ".running_mean"] = np.asarray(s["mean"], np.float32)
    out[prefix + ".running_var"] = np.asarray(s["var"], np.float32)
    out[prefix + ".num_batches_tracked"] = np.asarray(0, np.int64)


def _encoder(out, prefix, p, s, norm_fn):
    batch = norm_fn == "batch"
    _conv(out, prefix + ".conv1", p["conv1"])
    if batch:
        _bn(out, prefix + ".norm1", p["norm1"], s["norm1"])
    for i in (1, 2, 3):
        for j, suf in ((0, "a"), (1, "b")):
            bp, bs = p[f"layer{i}{suf}"], s.get(f"layer{i}{suf}", {})
            pre = f"{prefix}.layer{i}.{j}"
            _conv(out, pre + ".conv1", bp["conv1"])
            _conv(out, pre + ".conv2", bp["conv2"])
            if batch:
                _bn(out, pre + ".norm1", bp["norm1"], bs["norm1"])
                _bn(out, pre + ".norm2", bp["norm2"], bs["norm2"])
            if "down" in bp:
                _conv(out, pre + ".downsample.0", bp["down"])
                if batch:
                    _bn(out, pre + ".downsample.1", bp["norm3"], bs["norm3"])
                    _bn(out, pre + ".norm3", bp["norm3"], bs["norm3"])
    _conv(out, prefix + ".conv2", p["conv2"])


def from_jax(params_np: dict, model_state_np: dict) -> dict:
    """cista-eiflow or cista-eraft ``(params, model_state)`` of
    ``composite.init`` (leaves as numpy arrays) -> the reference key layout
    (``cista_net.*``, ``event_flownet.*``), with the ISTA block under
    ``lista_blocks.0``. The flow tree tells the two apart: DCEIFlow has an
    event encoder, E-RAFT a mask head."""
    out = {}
    c = params_np["cista"]
    pre = "cista_net."
    for name, key in (("We", "We.conv2d"), ("Wi", "Wi.conv2d"), ("W0", "W0.conv2d"),
                      ("upsamp", "upsamp_conv.conv2d"), ("final", "final_conv.conv2d")):
        _conv(out, pre + key, c[name])
    for name in ("gates", "out_gates", "P0"):
        _conv(out, pre + "P0." + name, c["P0"][name])
    _conv(out, pre + "lista_blocks.0.D.conv2d", c["ista"]["D"])
    _conv(out, pre + "lista_blocks.0.P.conv2d", c["ista"]["P"])
    out[pre + "lista_blocks.0.Lambda"] = np.ascontiguousarray(np.transpose(
        np.asarray(c["ista"]["Lambda"], np.float32), (0, 3, 1, 2)))
    _conv(out, pre + "Dg.conv.conv2d", c["Dg"]["conv"])
    _conv(out, pre + "Dg.recurrent_block.Gates", c["Dg"]["lstm"]["gates"])

    f, s = params_np["flow"], model_state_np["flow"]
    pre = "event_flownet."
    u = f["update"]
    _encoder(out, pre + "fnet", f["fnet"], s.get("fnet", {}), "instance")
    _encoder(out, pre + "cnet", f["cnet"], s["cnet"], "batch")
    if "enet" in f:                      # DCEIFlow
        _encoder(out, pre + "enet", f["enet"], s.get("enet", {}), "instance")
        for name in ("conv1", "conv2", "convo"):
            _conv(out, f"{pre}fusion.{name}", f["fusion"][name])
    else:                                # E-RAFT: the mask head is a Sequential
        _conv(out, f"{pre}update_block.mask.0", u["mask"]["conv1"])
        _conv(out, f"{pre}update_block.mask.2", u["mask"]["conv2"])
    for name, p in u["encoder"].items():
        _conv(out, f"{pre}update_block.encoder.{name}", p)
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(out, f"{pre}update_block.gru.{name}", u["gru"][name])
    for name in ("conv1", "conv2"):
        _conv(out, f"{pre}update_block.flow_head.{name}", u["flow_head"][name])
    return out
