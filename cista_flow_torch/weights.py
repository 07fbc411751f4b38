"""Reference-layout weights for the port.

``load_state_dict`` reads a reference checkpoint (``.npz`` such as the
committed ``gate/*_f16.npz``, or a ``.pth.tar``) into ``{key: ndarray}``,
a JAX-free copy of cista_flow_tpu/ckpt/torch_import.load_state_dict.
``from_jax`` turns the JAX package's parameter tree (numpy arrays, HWIO
convs) into the same key layout, so both packages can compute with one set
of weights (it maps a gradient tree the same way); ``flow_net_from_jax``
does so for a flow net's tree alone. ``save_checkpoint``
writes a model in the reference's ``{'epoch', 'state_dict'}`` ``.pth.tar``
layout, the trainer's checkpoints. ``basic_encoder_from_jax``,
``small_encoder_from_jax``, ``residual_block_from_jax``,
``bottleneck_block_from_jax`` (any norm, group norm among them),
``small_update_block_from_jax``, ``recurrent_layer_from_jax``,
``decay_gates_from_jax`` and ``neuron_lstc_from_jax`` carry the trees of
the JAX package's library blocks (the encoders and their blocks, the small
update block, the cell variants) into the port's modules' state dicts.
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


def save_checkpoint(path: str, model, epoch: int, key: str = "state_dict") -> None:
    """The reference's checkpoint, ``{'epoch': epoch, 'state_dict': ...}``
    (ref: train.py:137-140; the JAX package's ``save_torch_checkpoint``):
    the model's ``state_dict`` on the CPU in f32, which lists the
    reference's keys (the tied ISTA block under every ``lista_blocks.{i}``,
    BatchNorm's running statistics, ``norm3`` also as ``downsample.1``).
    A flow net's own checkpoint keeps it under ``key='model'`` (ref:
    DCEIFlow/DCEIFlow.py:120-140; the JAX ``pretrain_flow``'s)."""
    import torch

    torch.save({"epoch": epoch, key: {
        k: v.detach().cpu().float() if v.is_floating_point() else v.detach().cpu()
        for k, v in model.state_dict().items()}}, path)


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


def _norm(out, prefix, norm_fn, p, s):
    """One norm site: BatchNorm's parameters and statistics, GroupNorm's
    ``scale`` as ``weight`` and ``bias``; instance and no norm have none."""
    if norm_fn == "batch":
        _bn(out, prefix, p, s)
    elif norm_fn == "group":
        out[prefix + ".weight"] = np.asarray(p["scale"], np.float32)
        out[prefix + ".bias"] = np.asarray(p["bias"], np.float32)


def _block(out, pre, p, s, norm_fn, convs, norms):
    """A residual (``convs`` conv1-2, ``norms`` norm1-2, downsample norm3)
    or bottleneck block (conv1-3, norm1-3, norm4) under ``pre``; the
    downsample's norm also as ``downsample.1``, as the reference registers
    it."""
    for name in convs:
        _conv(out, pre + name, p[name])
    for name in norms:
        _norm(out, pre + name, norm_fn, p[name], s.get(name))
    if "down" in p:
        down = f"norm{len(norms) + 1}"
        _conv(out, pre + "downsample.0", p["down"])
        _norm(out, pre + "downsample.1", norm_fn, p[down], s.get(down))
        _norm(out, pre + down, norm_fn, p[down], s.get(down))


_RESIDUAL = (("conv1", "conv2"), ("norm1", "norm2"))
_BOTTLENECK = (("conv1", "conv2", "conv3"), ("norm1", "norm2", "norm3"))


def _encoder(out, pre, p, s, norm_fn, block=_RESIDUAL):
    """BasicEncoder (residual blocks) or SmallEncoder (bottleneck blocks)."""
    _conv(out, pre + "conv1", p["conv1"])
    _norm(out, pre + "norm1", norm_fn, p["norm1"], s.get("norm1"))
    for i in (1, 2, 3):
        for j, suf in ((0, "a"), (1, "b")):
            _block(out, f"{pre}layer{i}.{j}.", p[f"layer{i}{suf}"],
                   s.get(f"layer{i}{suf}", {}), norm_fn, *block)
    _conv(out, pre + "conv2", p["conv2"])


def _lite_encoder(out, prefix, p):
    """IDNet's LiteEncoder (norm 'none': convs only)."""
    _conv(out, prefix + ".conv1", p["conv1"])
    for i in (1, 2):
        for j, suf in ((0, "a"), (1, "b")):
            bp, pre = p[f"layer{i}{suf}"], f"{prefix}.layer{i}.{j}"
            _conv(out, pre + ".conv1", bp["conv1"])
            _conv(out, pre + ".conv2", bp["conv2"])
            if "down" in bp:
                _conv(out, pre + ".downsample.0", bp["down"])


def _idnet(out, pre, f):
    """IDNet's tree (cista_flow_tpu/ckpt/torch_import.py idnet_params,
    backwards): ``fnet.*``, ``update_net.*`` (the second head pair where the
    tree has it) and the context encoder ``cnet.*`` where it has one."""
    _lite_encoder(out, pre + "fnet", f["fnet"])
    if "cnet" in f:
        _lite_encoder(out, pre + "cnet", f["cnet"])
    u = f["update"]
    for name in ("convz", "convr", "convq"):
        _conv(out, f"{pre}update_net.gru.{name}", u["gru"][name])
    for head in ("flow_head", "flow_head2"):
        for name in ("conv1", "conv2"):
            if head in u:
                _conv(out, f"{pre}update_net.{head}.{name}", u[head][name])
    for head in ("mask", "mask2"):
        if head in u:
            _conv(out, f"{pre}update_net.{head}.0", u[head]["conv1"])
            _conv(out, f"{pre}update_net.{head}.2", u[head]["conv2"])


def from_jax(params_np: dict, model_state_np: dict) -> dict:
    """``(params, model_state)`` of ``composite.init`` (leaves as numpy
    arrays) in any model mode -> the reference key layout (``cista_net.*``,
    ``event_flownet.*``), with the ISTA block under ``lista_blocks.0``. The
    flow tree tells the modes apart: cista-lstc and cista-gtflow have none
    (``params['flow'] == {}``), IDNet's update block is a ConvGRU,
    DCEIFlow has an event encoder, E-RAFT a mask head."""
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

    if params_np["flow"]:                # cista-lstc and cista-gtflow have none
        out.update(flow_net_from_jax(params_np["flow"], model_state_np["flow"],
                                     "event_flownet."))
    return out


def flow_net_from_jax(f: dict, s: dict, pre: str = "") -> dict:
    """A flow net's own tree (params ``f`` and BatchNorm state ``s`` of
    ``dceiflow.init``, ``eraft.init``, ``raft.init`` or IDNet's, numpy
    leaves) -> the flow net's keys (``fnet.*``, ``cnet.*``,
    ``update_block.*``; IDNet ``fnet.*``, ``update_net.*``), each under
    ``pre``: the layout of a flow-net checkpoint (``pretrain_flow``'s
    ``{'epoch', 'model'}``). IDNet's update block is a ConvGRU, DCEIFlow
    has an event encoder, E-RAFT and RAFT a mask head."""
    out = {}
    if "convz" in f["update"]["gru"]:    # IDNet: a ConvGRU, no SepConvGRU
        _idnet(out, pre, f)
        return out
    u = f["update"]
    _encoder(out, pre + "fnet.", f["fnet"], s.get("fnet", {}), "instance")
    _encoder(out, pre + "cnet.", f["cnet"], s["cnet"], "batch")
    if "enet" in f:                      # DCEIFlow
        _encoder(out, pre + "enet.", f["enet"], s.get("enet", {}), "instance")
        for name in ("conv1", "conv2", "convo"):
            _conv(out, f"{pre}fusion.{name}", f["fusion"][name])
    else:                                # E-RAFT, RAFT: the mask head is a Sequential
        _conv(out, f"{pre}update_block.mask.0", u["mask"]["conv1"])
        _conv(out, f"{pre}update_block.mask.2", u["mask"]["conv2"])
    for name, p in u["encoder"].items():
        _conv(out, f"{pre}update_block.encoder.{name}", p)
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(out, f"{pre}update_block.gru.{name}", u["gru"][name])
    for name in ("conv1", "conv2"):
        _conv(out, f"{pre}update_block.flow_head.{name}", u["flow_head"][name])
    return out


# ------------------ the library surface's trees -> state dicts ----------------

def basic_encoder_from_jax(p: dict, s: dict, norm_fn: str, pre: str = "") -> dict:
    """``basic_encoder_init``'s (params, state) -> ``nn.encoders.BasicEncoder``'s
    keys: the residual blocks ``layer{i}.{0,1}``, BatchNorm's statistics
    where ``norm_fn`` is 'batch', GroupNorm's ``weight`` and ``bias`` where
    it is 'group' (``norm3`` also as ``downsample.1``)."""
    out = {}
    _encoder(out, pre, p, s, norm_fn)
    return out


def small_encoder_from_jax(p: dict, s: dict, norm_fn: str, pre: str = "") -> dict:
    """``small_encoder_init``'s (params, state) -> ``nn.encoders.SmallEncoder``'s
    keys: the bottleneck blocks ``layer{i}.{0,1}``, BatchNorm's statistics
    where ``norm_fn`` is 'batch', GroupNorm's ``weight`` and ``bias`` where
    it is 'group' (``norm4`` also as ``downsample.1``)."""
    out = {}
    _encoder(out, pre, p, s, norm_fn, _BOTTLENECK)
    return out


def residual_block_from_jax(p: dict, s: dict, norm_fn: str, pre: str = "") -> dict:
    """``residual_block_init``'s (params, state) -> ``nn.encoders.ResidualBlock``'s keys."""
    out = {}
    _block(out, pre, p, s, norm_fn, *_RESIDUAL)
    return out


def bottleneck_block_from_jax(p: dict, s: dict, norm_fn: str, pre: str = "") -> dict:
    """``bottleneck_block_init``'s (params, state) -> ``nn.encoders.BottleneckBlock``'s keys."""
    out = {}
    _block(out, pre, p, s, norm_fn, *_BOTTLENECK)
    return out


def small_update_block_from_jax(p: dict, pre: str = "") -> dict:
    """``small_update_block_init``'s params -> ``nn.gru.SmallUpdateBlock``'s keys."""
    out = {}
    for name, q in p["encoder"].items():
        _conv(out, f"{pre}encoder.{name}", q)
    for name in ("convz", "convr", "convq"):
        _conv(out, f"{pre}gru.{name}", p["gru"][name])
    for name in ("conv1", "conv2"):
        _conv(out, f"{pre}flow_head.{name}", p["flow_head"][name])
    return out


def recurrent_layer_from_jax(p: dict, pre: str = "") -> dict:
    """``recurrent_conv_layer_init``'s or ``recurrent_upsample_conv_layer_init``'s
    params -> ``RecurrentConvLayer``'s or ``RecurrentUpsampleConvLayer``'s keys."""
    out = {}
    _conv(out, pre + "conv.conv2d", p["conv"])
    _conv(out, pre + "recurrent_block.Gates", p["lstm"]["gates"])
    return out


def decay_gates_from_jax(p: dict, pre: str = "") -> dict:
    """``decay_gates_init``'s params -> ``DecayGates``'s ``nn.Linear`` keys
    (the JAX (cin, cout) weight transposed)."""
    out = {}
    for name in ("fc1", "fc2", "fc3"):
        out[f"{pre}{name}.weight"] = np.ascontiguousarray(np.asarray(p[name]["w"], np.float32).T)
        out[f"{pre}{name}.bias"] = np.asarray(p[name]["b"], np.float32)
    return out


def neuron_lstc_from_jax(p: dict, pre: str = "") -> dict:
    """``neuron_lstc_init``'s params -> ``NeuronLSTC``'s keys."""
    out = decay_gates_from_jax(p["gates"], pre + "gates.")
    _conv(out, pre + "P0.conv2d", p["P0"])
    _conv(out, pre + "conv1x1.conv2d", p["conv1x1"])
    return out
