"""Reference ``.pt`` loading and cUNet / SNDisc / ResNet weight conversion
from/to the JAX package's Flax variable trees (numpy arrays on both sides).

The reference saves GAN checkpoints as ``{'inference': state_dict,
'discriminator': state_dict, 'epoch', 'global_step'}``.  The port's modules
use the reference state_dict names directly, so a reference bundle loads
with ``strict=True``; the converters here only carry JAX parameters across
(and back), handling

* conv layout OIHW <-> HWIO and linear ``(out, in)`` <-> ``(in, out)``,
* the unused ``adain{i}.emb.weight`` embedding of the reference AdaIN:
  dropped going to JAX, synthesized (N(0, 1), seeded) coming from it so a
  strict ``load_state_dict`` succeeds,
* SNDisc spectral norm: ``weight_orig``/``weight_u``/``weight_v`` <-> the
  params ``kernel`` and the ``'spectral'`` collection's ``u`` (``weight_v``
  is recomputed from ``u``, as the JAX package does),
* ResNet BatchNorm ``scale/bias/mean/var`` <-> ``weight/bias/running_mean/
  running_var`` (+ ``num_batches_tracked``, which JAX does not keep), flat
  ``layer3_22`` <-> dotted ``layer3.22`` block names, ``downsample_conv/_bn``
  <-> ``downsample.0/.1``,
* the FID Inception-v3: the same BatchNorm mapping per ``BasicConv2d``, the
  fc head kept, torchvision's ``AuxLogits`` tower dropped.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        # numpy has no bfloat16 (a bfloat16 msgpack leaf is read as a
        # tensor); float32 holds every bfloat16 value exactly
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def _conv_in(w) -> np.ndarray:      # OIHW -> HWIO
    return np.transpose(_np(w), (2, 3, 1, 0))


def _conv_out(w) -> np.ndarray:     # HWIO -> OIHW
    return np.transpose(_np(w), (3, 2, 0, 1))


def _lin(w) -> np.ndarray:          # (out, in) <-> (in, out)
    return np.transpose(_np(w))


def load_torch_file(path: str) -> Any:
    """Load a ``.pt``/``.pth`` state-dict bundle on the CPU.  Only tensors and
    plain containers are unpickled (``weights_only=True``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


_CUNET_BLOCKS = (
    [(f"dconv_down{i}", f"down{i}") for i in (1, 2, 3, 4)]
    + [(f"dconv_up{i}", f"up{i}") for i in (3, 2, 1)]
)


def cunet_state_dict_from_jax(variables) -> Dict[str, np.ndarray]:
    """Flax ``ConditionalUNet`` variables -> reference state dict (numpy)."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for tname, fname in _CUNET_BLOCKS:
        sd[f"{tname}.0.weight"] = _conv_out(p[fname]["conv1"]["kernel"])
        sd[f"{tname}.0.bias"] = _np(p[fname]["conv1"]["bias"])
        sd[f"{tname}.2.weight"] = _conv_out(p[fname]["conv2"]["kernel"])
        sd[f"{tname}.2.bias"] = _np(p[fname]["conv2"]["bias"])
    for i in (1, 2, 3):
        sd[f"adain{i}.l1.weight"] = _lin(p[f"adain{i}"]["proj"]["kernel"])
        sd[f"adain{i}.l1.bias"] = _np(p[f"adain{i}"]["proj"]["bias"])
        ncls = sd[f"adain{i}.l1.weight"].shape[1]
        # unused embedding, synthesized for strict load_state_dict
        sd[f"adain{i}.emb.weight"] = np.random.default_rng(0).standard_normal(
            (ncls, ncls)).astype(np.float32)
    sd["conv_last.weight"] = _conv_out(p["conv_last"]["kernel"])
    sd["conv_last.bias"] = _np(p["conv_last"]["bias"])
    return sd


def cunet_state_dict_to_jax(sd) -> Dict[str, Any]:
    """Reference state dict -> Flax ``ConditionalUNet`` variables (numpy)."""
    p: Dict[str, Any] = {}
    for tname, fname in _CUNET_BLOCKS:
        p[fname] = {
            "conv1": {"kernel": _conv_in(sd[f"{tname}.0.weight"]),
                      "bias": _np(sd[f"{tname}.0.bias"])},
            "conv2": {"kernel": _conv_in(sd[f"{tname}.2.weight"]),
                      "bias": _np(sd[f"{tname}.2.bias"])},
        }
    for i in (1, 2, 3):
        p[f"adain{i}"] = {"proj": {"kernel": _lin(sd[f"adain{i}.l1.weight"]),
                                   "bias": _np(sd[f"adain{i}.l1.bias"])}}
    p["conv_last"] = {"kernel": _conv_in(sd["conv_last.weight"]),
                      "bias": _np(sd["conv_last.bias"])}
    return {"params": p}


# ---------------------------------------------------------------- SNDisc

_DISC_BLOCKS = [(f"conv{i}", f"block{i}") for i in (1, 2, 3, 4)]
_DISC_CONVS = ((0, "conv1"), (1, "conv2"))


def sndisc_state_dict_from_jax(variables) -> Dict[str, np.ndarray]:
    """Flax ``SNDisc`` variables (params + spectral) -> reference state dict
    (numpy): ``weight_orig``, ``bias``, ``weight_u`` and ``weight_v =
    normalize(W^T u)`` per spectral-norm layer."""
    p, s = variables["params"], variables["spectral"]
    sd: Dict[str, np.ndarray] = {}

    def emit(tkey, w, bias, u):
        w_mat = w.reshape(w.shape[0], -1)
        u = _np(u)
        v = w_mat.T @ u
        v = v / (np.linalg.norm(v) + 1e-12)
        sd[f"{tkey}.weight_orig"] = w
        sd[f"{tkey}.bias"] = _np(bias)
        sd[f"{tkey}.weight_u"] = u
        sd[f"{tkey}.weight_v"] = v.astype(w.dtype)

    for tname, fname in _DISC_BLOCKS:
        for j, cname in _DISC_CONVS:
            blk = p[fname][cname]
            emit(f"{tname}.{j}", _conv_out(blk["kernel"]), blk["bias"],
                 s[fname][cname]["u"])
    for tname, fname in (("l", "linear"), ("embed", "embed")):
        emit(tname, _lin(p[fname]["kernel"]), p[fname]["bias"],
             s[fname]["u"])
    return sd


def sndisc_state_dict_to_jax(sd) -> Dict[str, Any]:
    """Reference (or port) ``SNDisc`` state dict -> Flax variables (params +
    spectral, numpy)."""
    p: Dict[str, Any] = {}
    s: Dict[str, Any] = {}
    for tname, fname in _DISC_BLOCKS:
        p[fname], s[fname] = {}, {}
        for j, cname in _DISC_CONVS:
            p[fname][cname] = {
                "kernel": _conv_in(sd[f"{tname}.{j}.weight_orig"]),
                "bias": _np(sd[f"{tname}.{j}.bias"])}
            s[fname][cname] = {"u": _np(sd[f"{tname}.{j}.weight_u"])}
    for tname, fname in (("l", "linear"), ("embed", "embed")):
        p[fname] = {"kernel": _lin(sd[f"{tname}.weight_orig"]),
                    "bias": _np(sd[f"{tname}.bias"])}
        s[fname] = {"u": _np(sd[f"{tname}.weight_u"])}
    return {"params": p, "spectral": s}


# ---------------------------------------------------------------- ResNet

def _infer_block_counts(keys, sep: str) -> tuple:
    """Bottlenecks per layer from key names ``layer3.22.*`` (sep ".") or
    ``layer3_22`` (sep "_")."""
    counts = []
    for li in range(1, 5):
        n = 0
        while any(k == f"layer{li}{sep}{n}"
                  or k.startswith(f"layer{li}{sep}{n}.") for k in keys):
            n += 1
        counts.append(n)
    return tuple(counts)


def strip_module_prefix(sd) -> Dict[str, Any]:
    """Drop the ``module.`` that ``nn.DataParallel`` puts before every key."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def resnet_state_dict_from_jax(variables,
                               block_counts=None) -> Dict[str, np.ndarray]:
    """Flax ``ResNet`` variables (params + batch_stats) -> torchvision-layout
    state dict (numpy).  ``block_counts=None`` infers the depth from the
    block names."""
    p, bs = variables["params"], variables["batch_stats"]
    if block_counts is None:
        block_counts = _infer_block_counts(p.keys(), "_")
    sd: Dict[str, np.ndarray] = {
        "conv1.weight": _conv_out(p["conv1"]["kernel"])}

    def emit_bn(tkey, pb, sb):
        sd[f"{tkey}.weight"] = _np(pb["scale"])
        sd[f"{tkey}.bias"] = _np(pb["bias"])
        sd[f"{tkey}.running_mean"] = _np(sb["mean"])
        sd[f"{tkey}.running_var"] = _np(sb["var"])
        sd[f"{tkey}.num_batches_tracked"] = np.array(0, dtype=np.int64)

    emit_bn("bn1", p["bn1"], bs["bn1"])
    for li, n_blocks in enumerate(block_counts):
        for bi in range(n_blocks):
            t, f = f"layer{li + 1}.{bi}", f"layer{li + 1}_{bi}"
            for k in (1, 2, 3):
                sd[f"{t}.conv{k}.weight"] = _conv_out(
                    p[f][f"conv{k}"]["kernel"])
                emit_bn(f"{t}.bn{k}", p[f][f"bn{k}"], bs[f][f"bn{k}"])
            if "downsample_conv" in p[f]:
                sd[f"{t}.downsample.0.weight"] = _conv_out(
                    p[f]["downsample_conv"]["kernel"])
                emit_bn(f"{t}.downsample.1", p[f]["downsample_bn"],
                        bs[f]["downsample_bn"])
    sd["fc.weight"] = _lin(p["fc"]["kernel"])
    sd["fc.bias"] = _np(p["fc"]["bias"])
    return sd


def resnet_state_dict_to_jax(sd, block_counts=None) -> Dict[str, Any]:
    """torchvision-layout ResNet state dict -> Flax variables (numpy).  A
    leading ``module.`` is stripped; ``num_batches_tracked`` is dropped;
    ``block_counts=None`` infers the depth from the key names."""
    sd = strip_module_prefix(sd)
    if block_counts is None:
        block_counts = _infer_block_counts(sd.keys(), ".")

    def bn(prefix):
        return ({"scale": _np(sd[f"{prefix}.weight"]),
                 "bias": _np(sd[f"{prefix}.bias"])},
                {"mean": _np(sd[f"{prefix}.running_mean"]),
                 "var": _np(sd[f"{prefix}.running_var"])})

    p: Dict[str, Any] = {"conv1": {"kernel": _conv_in(sd["conv1.weight"])}}
    bs: Dict[str, Any] = {}
    p["bn1"], bs["bn1"] = bn("bn1")
    for li, n_blocks in enumerate(block_counts):
        for bi in range(n_blocks):
            t, f = f"layer{li + 1}.{bi}", f"layer{li + 1}_{bi}"
            p[f], bs[f] = {}, {}
            for k in (1, 2, 3):
                p[f][f"conv{k}"] = {
                    "kernel": _conv_in(sd[f"{t}.conv{k}.weight"])}
                p[f][f"bn{k}"], bs[f][f"bn{k}"] = bn(f"{t}.bn{k}")
            if f"{t}.downsample.0.weight" in sd:
                p[f]["downsample_conv"] = {
                    "kernel": _conv_in(sd[f"{t}.downsample.0.weight"])}
                p[f]["downsample_bn"], bs[f]["downsample_bn"] = bn(
                    f"{t}.downsample.1")
    p["fc"] = {"kernel": _lin(sd["fc.weight"]), "bias": _np(sd["fc.bias"])}
    return {"params": p, "batch_stats": bs}


# ---------------------------------------------------------------- Inception

def inception_state_dict_from_jax(variables) -> Dict[str, np.ndarray]:
    """Flax ``InceptionV3FID`` variables (params + batch_stats) ->
    pytorch-fid / torchvision-layout state dict (numpy): per
    ``BasicConv2d`` ``<block>.conv.weight`` and ``<block>.bn.{weight,
    bias, running_mean, running_var, num_batches_tracked}``, and ``fc.*``
    where the head is present."""
    sd: Dict[str, np.ndarray] = {}

    def walk(ptree, btree, prefix):
        if "kernel" in ptree.get("conv", {}):
            sd[f"{prefix}.conv.weight"] = _conv_out(ptree["conv"]["kernel"])
            bn_p, bn_b = ptree["bn"], btree["bn"]
            sd[f"{prefix}.bn.weight"] = _np(bn_p["scale"])
            sd[f"{prefix}.bn.bias"] = _np(bn_p["bias"])
            sd[f"{prefix}.bn.running_mean"] = _np(bn_b["mean"])
            sd[f"{prefix}.bn.running_var"] = _np(bn_b["var"])
            sd[f"{prefix}.bn.num_batches_tracked"] = np.array(0, np.int64)
            return
        if "kernel" in ptree:                       # the fc head
            sd[f"{prefix}.weight"] = _lin(ptree["kernel"])
            sd[f"{prefix}.bias"] = _np(ptree["bias"])
            return
        for k in ptree:
            walk(ptree[k], btree.get(k, {}), f"{prefix}.{k}" if prefix else k)

    walk(variables["params"], variables["batch_stats"], "")
    return sd


def inception_state_dict_to_jax(sd) -> Dict[str, Any]:
    """pytorch-fid (1008-way fc) or torchvision (1000-way fc) Inception-v3
    state dict -> Flax ``InceptionV3FID`` variables (numpy).  torchvision's
    training-only ``AuxLogits`` tower and ``num_batches_tracked`` are
    dropped; the fc head is kept (the Inception Score reads it)."""
    p: Dict[str, Any] = {}
    bs: Dict[str, Any] = {}

    def set_in(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    bn_fields = {"weight": (p, "scale"), "bias": (p, "bias"),
                 "running_mean": (bs, "mean"), "running_var": (bs, "var")}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[0] == "AuxLogits":
            continue
        if parts[0] == "fc":
            set_in(p, ["fc", "kernel" if parts[1] == "weight" else "bias"],
                   _lin(val) if parts[1] == "weight" else _np(val))
        elif parts[-2:] == ["conv", "weight"]:
            set_in(p, parts[:-1] + ["kernel"], _conv_in(val))
        elif parts[-2] == "bn" and parts[-1] in bn_fields:
            tree, field = bn_fields[parts[-1]]
            set_in(tree, parts[:-1] + [field], _np(val))
    return {"params": p, "batch_stats": bs}


def inception_state_dict(sd, with_logits: bool) -> Dict[str, Any]:
    """A pytorch-fid or torchvision Inception-v3 state dict as
    ``models/inception_fid.py::InceptionV3FID`` loads it with
    ``strict=True``: ``AuxLogits.*`` dropped (a training-only tower that
    eval-mode torchvision ignores too), the ``fc`` head dropped when the
    model has none (the FID graph reads pool3), and a missing
    ``num_batches_tracked`` (older checkpoints) set to 0."""
    out = {k: v for k, v in sd.items()
           if not k.startswith("AuxLogits.")
           and (with_logits or not k.startswith("fc."))}
    for key in [k for k in out if k.endswith(".bn.running_mean")]:
        out.setdefault(key[:-len("running_mean")] + "num_batches_tracked",
                       torch.tensor(0, dtype=torch.long))
    return out
