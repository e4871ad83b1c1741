"""flax → PyTorch weight migration for the modules the port holds.

``from_flax(variables, cfg)`` turns the JAX package's ``variables`` (numpy
leaves, e.g. ``jax.tree.map(np.asarray, variables)``) into a ``state_dict``
that loads, strictly, into ``build_model(cfg)`` of this package.  The rules
are the inverse of ``llmmil_tpu/models/migrate.py``:

- Dense ``kernel`` (in, out) → Linear ``weight`` (out, in); ``bias`` as is;
- LayerNorm ``scale``/``bias`` → ``weight``/``bias``; Embed ``embedding`` →
  ``weight``;
- raw parameters (``positional_embedding``, ``text_projection``, ``ctx``) as
  they are, ABMIL's ``V_kernel…w_bias`` onto ``attention_V.0`` /
  ``attention_U.0`` / ``attention_weights``;
- Conv ``kernel`` DHWIO → ``weight`` OIDHW; the 4-D HWIO kernel of a
  depth-independent (1,kH,kW) convolution gains its kD = 1 axis;
- BatchNorm ``params`` (``scale``, ``bias``) and ``batch_stats`` (``mean``,
  ``var``) → ``weight``, ``bias``, ``running_mean``, ``running_var``;
  ``num_batches_tracked`` is set to 0;
- TransMIL (``transmil``): ``fc1`` → ``_fc1.0``, the biasless ``to_qkv``,
  ``to_out`` → ``to_out.0``, ``res_conv`` (already in torch's (heads, 1, k,
  1) layout), PPEG's depthwise kernels (k, k, 1, D) → (D, 1, k, k); a
  TransMIL subtree must hold exactly the leaves it maps, or it raises.

The port names its modules by the reference's ``state_dict`` keys, so the
result has the key names of a reference checkpoint.

The rules are linear, so ``grads_from_flax`` sends a flax *gradient* tree
(the shape of ``params``) through the same rules to the layout of the
port's ``.grad`` tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import Config


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def dense(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    out = {pre + "weight": _t(np.asarray(p["kernel"]).T)}
    if "bias" in p:
        out[pre + "bias"] = _t(p["bias"])
    return out


def layer_norm(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    return {pre + "weight": _t(p["scale"]), pre + "bias": _t(p["bias"])}


def attention(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out.update(dense(p[name], f"{pre}{name}."))
    return out


def twoway(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    """``TwoWayTransformer`` params → ``<pre>layers.{i}...`` keys."""
    out: Dict[str, torch.Tensor] = {}
    depth = sum(1 for k in p if k.startswith("layers_"))
    for i in range(depth):
        lp, src = f"{pre}layers.{i}.", p[f"layers_{i}"]
        for name in ("self_attn", "cross_attn_token_to_image",
                     "cross_attn_image_to_token"):
            out.update(attention(src[name], f"{lp}{name}."))
        out.update(dense(src["mlp"]["lin1"], lp + "mlp.lin1."))
        out.update(dense(src["mlp"]["lin2"], lp + "mlp.lin2."))
        for name in ("norm1", "norm2", "norm3", "norm4"):
            out.update(layer_norm(src[name], f"{lp}{name}."))
    out.update(attention(p["final_attn_token_to_image"],
                         pre + "final_attn_token_to_image."))
    out.update(layer_norm(p["norm_final_attn"], pre + "norm_final_attn."))
    return out


def conv(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    k = np.asarray(p["kernel"])
    if k.ndim == 4:                       # (kH, kW, I, O): a (1,kH,kW) conv
        k = k[None]
    out = {pre + "weight": _t(k.transpose(4, 3, 0, 1, 2))}
    if "bias" in p:
        out[pre + "bias"] = _t(p["bias"])
    return out


def batch_norm(p: Mapping, stats: Mapping, pre: str
               ) -> Dict[str, torch.Tensor]:
    return {pre + "weight": _t(p["scale"]), pre + "bias": _t(p["bias"]),
            pre + "running_mean": _t(stats["mean"]),
            pre + "running_var": _t(stats["var"]),
            pre + "num_batches_tracked": torch.tensor(0, dtype=torch.long)}


def conv_bn(p: Mapping, stats: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    """``_ConvBN`` → torchvision's ``<pre>0`` (conv) / ``<pre>1`` (BN)."""
    return {**conv(p["conv"], pre + "0."),
            **batch_norm(p["bn"], stats["bn"], pre + "1.")}


def resnet_mc3(p: Mapping, stats: Mapping, pre: str
               ) -> Dict[str, torch.Tensor]:
    """``ResnetMC3_18`` → ``<pre>downsampling.*`` and torchvision ``mc3_18``
    keys under ``<pre>model.``."""
    out = conv(p["downsampling"], pre + "downsampling.")
    trunk, tstats, pre = p["trunk"], stats["trunk"], pre + "model."
    out.update(conv_bn(trunk["stem"], tstats["stem"], pre + "stem."))
    for name in sorted(k for k in trunk if k.startswith("layer")):
        stage, block = name.split("_")
        for part in trunk[name]:          # conv1, conv2, downsample
            out.update(conv_bn(trunk[name][part], tstats[name][part],
                               f"{pre}{stage}.{block}.{part}."))
    return out


def _exact(p: Mapping, keys, where: str) -> None:
    """A subtree holds exactly ``keys``: a leaf without a destination, or a
    destination without a leaf, raises."""
    have, want = set(p), set(keys)
    if have != want:
        raise KeyError(f"from_flax: {where} holds {sorted(have - want)} "
                       f"without a destination and lacks "
                       f"{sorted(want - have)}")


def transmil(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    """``TransMIL`` params → the reference's ``<pre>_fc1.0``, ``cls_token``,
    ``layer{1,2}.{norm,attn.*}``, ``pos_layer.proj*``, ``norm`` keys."""
    _exact(p, ("fc1", "cls_token", "layer1", "pos_layer", "layer2", "norm"),
           pre or "TransMIL")
    out = dense(p["fc1"], pre + "_fc1.0.")
    out[pre + "cls_token"] = _t(p["cls_token"])
    out.update(layer_norm(p["norm"], pre + "norm."))
    _exact(p["pos_layer"], ("proj", "proj1", "proj2"), pre + "pos_layer")
    for name in ("proj", "proj1", "proj2"):
        conv_p = p["pos_layer"][name]
        _exact(conv_p, ("kernel", "bias"), f"{pre}pos_layer.{name}")
        out[f"{pre}pos_layer.{name}.weight"] = _t(
            np.asarray(conv_p["kernel"]).transpose(3, 2, 0, 1))
        out[f"{pre}pos_layer.{name}.bias"] = _t(conv_p["bias"])
    for layer in ("layer1", "layer2"):
        lp, src = f"{pre}{layer}.", p[layer]
        _exact(src, ("norm", "attn"), lp[:-1])
        _exact(src["attn"], ("to_qkv", "to_out", "res_conv"), lp + "attn")
        _exact(src["attn"]["to_qkv"], ("kernel",), lp + "attn.to_qkv")
        out.update(layer_norm(src["norm"], lp + "norm."))
        out.update(dense(src["attn"]["to_qkv"], lp + "attn.to_qkv."))
        out.update(dense(src["attn"]["to_out"], lp + "attn.to_out.0."))
        out[lp + "attn.res_conv.weight"] = _t(src["attn"]["res_conv"])
    return out


def abmil(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    if "abmil" in p:                      # ABMILv2 wraps an ABMIL
        p = p["abmil"]
    return {
        pre + "attention_V.0.weight": _t(np.asarray(p["V_kernel"]).T),
        pre + "attention_V.0.bias": _t(p["V_bias"]),
        pre + "attention_U.0.weight": _t(np.asarray(p["U_kernel"]).T),
        pre + "attention_U.0.bias": _t(p["U_bias"]),
        pre + "attention_weights.weight": _t(np.asarray(p["w_kernel"]).T),
        pre + "attention_weights.bias": _t(p["w_bias"]),
    }


def simple_fcs(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    """simpleFCs_v{1,1d,2,2d}: Linear layers sit at ``fc.0`` / ``fc.2``."""
    out = dense(p["fc0"], pre + "fc.0.")
    if "fc1" in p:
        out.update(dense(p["fc1"], pre + "fc.2."))
    return out


def clip_text(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    """``CLIPTextEncoder`` params → OpenAI CLIP text-side keys."""
    out = {
        pre + "token_embedding.weight": _t(p["token_embedding"]["embedding"]),
        pre + "positional_embedding": _t(p["positional_embedding"]),
        pre + "text_projection": _t(p["text_projection"]),
    }
    out.update(layer_norm(p["ln_final"], pre + "ln_final."))
    layers = sum(1 for k in p if k.startswith("resblock_"))
    for i in range(layers):
        bp, src = f"{pre}transformer.resblocks.{i}.", p[f"resblock_{i}"]
        out.update(layer_norm(src["ln_1"], bp + "ln_1."))
        out.update(layer_norm(src["ln_2"], bp + "ln_2."))
        in_proj = src["attn"]["in_proj"]
        out[bp + "attn.in_proj_weight"] = _t(np.asarray(in_proj["kernel"]).T)
        out[bp + "attn.in_proj_bias"] = _t(in_proj["bias"])
        out.update(dense(src["attn"]["out_proj"], bp + "attn.out_proj."))
        out.update(dense(src["c_fc"], bp + "mlp.c_fc."))
        out.update(dense(src["c_proj"], bp + "mlp.c_proj."))
    return out


def coop(p: Mapping, pre: str) -> Dict[str, torch.Tensor]:
    out = clip_text(p["clip"], pre + "model.")
    if "ctx" in p:
        out[pre + "ctx"] = _t(p["ctx"])
    return out


def clinic_extractor(p: Mapping, cfg: Config, pre: str = "clinic_extractor."
                     ) -> Dict[str, torch.Tensor]:
    if cfg.model_CI == "CLIP":
        return coop(p, pre)
    return simple_fcs(p, pre)


def _batch_stats(variables: Mapping, branch: str) -> Mapping:
    if "batch_stats" not in variables:
        raise KeyError(
            "from_flax: a configuration with 'CT' in its modality needs "
            "variables['batch_stats'] (the trunk's BatchNorm running "
            "statistics) beside variables['params']")
    return variables["batch_stats"][branch]


def from_flax(variables: Mapping, cfg: Config) -> Dict[str, torch.Tensor]:
    """The JAX package's ``variables`` for ``cfg`` → this package's
    ``state_dict``.  With ``'CT'`` in the modality ``variables`` must hold
    ``batch_stats`` beside ``params``.  Raises ``KeyError`` on a tree that
    lacks a branch the configuration needs, and ``NotImplementedError`` on
    a family the port does not hold yet."""
    p = variables["params"] if "params" in variables else variables
    has_ct, has_pth = "CT" in cfg.modality, "pathology" in cfg.modality
    sd: Dict[str, torch.Tensor] = {}
    if cfg.model_family == "concat":
        if has_ct:
            sd.update(resnet_mc3(
                p["extractor_CT"]["trunk"],
                _batch_stats(variables, "extractor_CT")["trunk"],
                "extractor_CT.trunk."))
        if "extractor_pathology" in p:
            sd.update(abmil(p["extractor_pathology"], "extractor_pathology."))
        sd.update(dense(p["fc1"], "fc1."))
        sd.update(dense(p["fc2"], "fc2."))
        return sd
    if cfg.model_family != "aggregator":
        raise NotImplementedError(
            f"from_flax: model_family={cfg.model_family!r} is not ported")
    if cfg.separate_CI_encoders and has_ct and has_pth:
        for name in ("clinic_extractor_CT", "clinic_extractor_Pth"):
            sd.update(clinic_extractor(p[name], cfg, name + "."))
    else:
        sd.update(clinic_extractor(p["clinic_extractor"], cfg))
    if has_ct:
        if "extractor_CT" in p:           # absent with precomputed features
            sd.update(resnet_mc3(p["extractor_CT"],
                                 _batch_stats(variables, "extractor_CT"),
                                 "extractor_CT."))
        if "fc_CT_proj" in p:
            sd.update(dense(p["fc_CT_proj"], "fc_CT_proj."))
        sd.update(dense(p["fc_CI2CT"], "fc_CI2CT.0."))
    if has_pth:
        sd.update(dense(p["fc_pathology"], "fc_pathology.0."))
        sd.update(dense(p["fc_CI2Pth"], "fc_CI2Pth.0."))
    for name in ("TwoWayTransformer_Both", "TwoWayTransformer_CT",
                 "TwoWayTransformer_Pth"):
        if name in p:
            sd.update(twoway(p[name], name + "."))
    if not has_ct and not has_pth:
        sd.update(dense(p["fc_CI"], "fc_CI.0."))
    if cfg.aggregator == "TransMIL":
        sd.update(transmil(p["aggregator"], "aggregator."))
    elif cfg.aggregator != "-":
        sd.update(abmil(p["aggregator"], "aggregator."))
    for name in ("aggregator_CT", "aggregator_Pth"):   # TransMIL_seperate
        if name in p:
            sd.update(transmil(p[name], name + "."))
    for name in ("fc", "fc_CT", "fc_Pth"):    # <name>.0 is the Dropout
        if name in p:
            sd.update(dense(p[name], name + ".1."))
    return sd


def _stats_like(params: Mapping) -> Dict:
    """A ``batch_stats`` tree for ``params``: every BatchNorm (a ``bn``
    node) gets placeholder ``mean`` / ``var`` leaves of its scale's shape."""
    out: Dict = {}
    for k, v in params.items():
        if not isinstance(v, Mapping):
            continue
        if k == "bn":
            out[k] = {"mean": v["scale"], "var": v["scale"]}
        else:
            sub = _stats_like(v)
            if sub:
                out[k] = sub
    return out


def grads_from_flax(grads: Mapping, cfg: Config) -> Dict[str, torch.Tensor]:
    """A flax gradient tree (of ``params``) → ``{parameter name: gradient}``
    in the port's layout (no BatchNorm buffers)."""
    p = grads["params"] if "params" in grads else grads
    sd = from_flax({"params": p, "batch_stats": _stats_like(p)}, cfg)
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}
