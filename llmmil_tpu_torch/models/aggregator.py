"""Flagship multimodal MIL model — the branches ported so far.

Structure of the full model (the JAX package's ``models/aggregator.py``):
  extractor_CT (model_CT) ─┐
  fc_pathology 768→512 Tanh ─┤
  clinic_extractor (model_CI / CoOp-CLIP) → fc_CI2CT / fc_CI2Pth (Tanh) ─┤
  TwoWayTransformer(depth 2, dim 512, heads 8, mlp 2048) fuses each
  modality's tokens with the projected CI; concat token streams → MIL
  aggregator → Dropout(0.25) + Linear → sigmoid/softmax.

Ported: every modality mix (tri-modal ``["CT", "pathology"]``, CT-only,
pathology-only, clinical-information-only) with ``model_CT`` ``resnetMC3_18``
/ ``resnetMC3_18_wMask`` and aggregators ``ABMIL``, ``ABMIL_v2``,
``TransMIL`` (one module pools the fused stream and, under
``loss_point="CT-Pth-Last"``, the CT and pathology streams: one module,
three calls), ``TransMIL_seperate`` (tri-modal: a TransMIL pools each
modality's CI-side stream into one token, ``aggregator_CT`` /
``aggregator_Pth``, and ABMIL pools the result; elsewhere ABMIL alone, as in
the JAX package) and ``-``.  The other CT trunks and
``TransMIL_per_modality`` raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.
Submodules carry the reference's ``state_dict`` names (``extractor_CT.model.
stem.0``, ``fc_pathology.0``, ``TwoWayTransformer_Both.layers.0...``,
``fc.1``).

The tri-modal forward returns three probability heads (``probs``,
``probs_CT``, ``probs_Pth`` under ``loss_point="CT-Pth-Last"``) and the pair
of CI-alignment embeddings (``emb_CT2CI``, ``emb_Pth2CI``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..config import Config, resolve_memory_config
from ..device import resolve_device
from ..ops.kernels import resolve_use_kernel
from ..ops.positional import sinusoidal_pe
from .abmil import ABMIL, ABMILv2
from .clip_text import CLIPTextConfig, CoOpClinicalEncoder
from .ct_mc3 import ResnetMC3_18
from .layers import Dense, compute_dtype, init_weights
from .simple_fcs import (SimpleFCsV1, SimpleFCsV1d, SimpleFCsV2,
                         SimpleFCsV2d)
from .transmil import TransMIL
from .twoway import TwoWayTransformer

EMBED_DIM = 512

_MC3 = ("resnetMC3_18", "resnetMC3_18_wMask")
_CT_TRUNK_ITEM = ("model_CT={kind!r} is not ported yet (ROADMAP.md, Queue 1 "
                  "item 5: the other trunks and heads)")
_PER_MODALITY_ITEM = ("aggregator='TransMIL_per_modality' is not ported yet "
                      "(ROADMAP.md, Queue 1 item 5: the other trunks and "
                      "heads, transmil_per_modality.py)")


def make_clinic_extractor(c: Config, dtype: torch.dtype) -> nn.Module:
    n = c.n_clinical
    if c.model_CI == "simpleFCs_v1":
        return SimpleFCsV1(n, dtype)
    if c.model_CI == "simpleFCs_v1d":
        return SimpleFCsV1d(n, dtype)
    if c.model_CI == "simpleFCs_v2":
        return SimpleFCsV2(dtype)
    if c.model_CI == "simpleFCs_v2d":
        return SimpleFCsV2d(dtype)
    if c.model_CI == "CLIP":
        tcfg = CLIPTextConfig(
            vocab_size=c.clip_vocab, context_length=c.clip_context,
            width=c.clip_width, heads=c.clip_heads, layers=c.clip_layers,
            embed_dim=c.clip_embed)
        return CoOpClinicalEncoder(
            n_prompts=n + 1, n_ctx=c.n_ctx,
            learnable=bool(c.learnablePrompt), cfg=tcfg, dtype=dtype)
    raise ValueError(f"unknown model_CI {c.model_CI}")


def mask_centroids(m: torch.Tensor) -> torch.Tensor:
    """Per-sample tumour-mask centroid (B, 3) int32 from a (B, D, H, W) mask
    (reference ``get_center_of_mask``)."""
    m = m.float()
    tot = m.sum(dim=(1, 2, 3)).clamp_min(1.0)                   # (B,)

    def along(axis):
        others = tuple(a for a in (1, 2, 3) if a != axis)
        idx = torch.arange(m.shape[axis], device=m.device, dtype=m.dtype)
        return (m.sum(dim=others) * idx).sum(1) / tot

    return torch.stack([along(1), along(2), along(3)], dim=-1).to(torch.int32)


def make_ct_extractor(cfg: Config, dtype: torch.dtype) -> nn.Module:
    """CT-extractor factory.  ``ct_remat='auto'`` resolves as the JAX
    package resolves it for a module built directly (training assumptions,
    ``resolve_memory_config``); rematerialisation acts only while the trunk
    trains with autograd on."""
    cfg = resolve_memory_config(cfg, training=True)
    if cfg.ct_layers and cfg.model_CT not in _MC3:
        # loud rejection: ct_layers only shapes the MC3 stages — silently
        # ignoring it for other trunks would mislead dryrun/debug users
        raise ValueError(
            f"ct_layers={cfg.ct_layers} is only honored by "
            f"resnetMC3_18/_wMask, not model_CT={cfg.model_CT!r}")
    if cfg.model_CT in _MC3:
        if cfg.ct_shard_axis:
            raise NotImplementedError(
                f"ct_shard_axis={cfg.ct_shard_axis!r}: the depth-sharded "
                "trunk is not ported yet (ROADMAP.md, Queue 1 item 10: "
                "parallel/sp_ct)")
        return ResnetMC3_18(
            in_channels=2 if "wMask" in cfg.model_CT else 1,
            spacing_xy=cfg.spacing[0], dtype=dtype,
            layers=tuple(cfg.ct_layers) or (2, 2, 2, 2),
            temporal_mode=cfg.ct_temporal_mode,
            conv_backend=cfg.ct_conv_backend,
            fwd_lowering=cfg.ct_fwd_lowering, remat=cfg.ct_remat)
    if cfg.model_CT in ("medicalNet", "resnet2plus1d_18", "MViT") \
            or "SwinUNETR" in cfg.model_CT:
        raise NotImplementedError(_CT_TRUNK_ITEM.format(kind=cfg.model_CT))
    raise ValueError(f"unknown model_CT {cfg.model_CT}")


def _tanh_proj(in_dim: int, dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(Dense(in_dim, EMBED_DIM, dtype), nn.Tanh())


def activation(cfg: Config, logits: torch.Tensor) -> torch.Tensor:
    if cfg.activationF == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def _mask_or_ones(streams, masks):
    """Key-validity mask of concatenated token streams; None when no stream
    carries one."""
    if all(m is None for m in masks):
        return None
    return torch.cat(
        [m.expand(s.shape[:2]) if m is not None
         else torch.ones(s.shape[:2], dtype=torch.bool, device=s.device)
         for s, m in zip(streams, masks)], dim=1)


class Aggregator(nn.Module):
    """``ct_feature_dim``: None builds the CT extractor; an int builds none
    and expects precomputed ``batch["ct_features"]`` of that width (the
    reference's SwinUNETR feature path), projected by ``fc_CT_proj`` when
    the width is not 512.  A model with an extractor also takes
    ``ct_features`` (a layer4 map or 512-d tokens) in its place."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32,
                 ct_feature_dim: int | None = None):
        super().__init__()
        c = self.cfg = cfg
        self.compute_dtype = dtype
        self.has_ct = has_ct = "CT" in c.modality
        self.has_pth = has_pth = "pathology" in c.modality

        ab = c.alignment_base
        if ab not in ("CT", "pathology", "CI", "none"):
            raise ValueError(f"unknown alignment_base {ab!r}")
        if ab == "CT" and not has_ct:
            raise ValueError("alignment_base='CT' without CT modality")
        if ab == "pathology" and not has_pth:
            raise ValueError("alignment_base='pathology' without pathology")

        # aggregator_tmp: one clinical encoder and one TwoWay tower per
        # modality
        self.separate = bool(c.separate_CI_encoders) and has_ct and has_pth
        if self.separate:
            self.clinic_extractor_CT = make_clinic_extractor(c, dtype)
            self.clinic_extractor_Pth = make_clinic_extractor(c, dtype)
        else:
            self.clinic_extractor = make_clinic_extractor(c, dtype)
        ci_dim = c.clip_embed if c.model_CI == "CLIP" else 512

        def twoway():
            return TwoWayTransformer(
                depth=c.twoway_depth or 2, embedding_dim=EMBED_DIM,
                num_heads=8, mlp_dim=2048, ct_reduce="mean", dtype=dtype)

        if has_ct:
            if ct_feature_dim is None:
                self.extractor_CT = make_ct_extractor(c, dtype)
            elif ct_feature_dim != EMBED_DIM:
                self.fc_CT_proj = Dense(ct_feature_dim, EMBED_DIM, dtype)
        if has_pth:
            self.fc_pathology = _tanh_proj(768, dtype)
        if has_ct and has_pth:
            if self.separate:
                self.TwoWayTransformer_CT = twoway()
                self.TwoWayTransformer_Pth = twoway()
            else:
                self.TwoWayTransformer_Both = twoway()
            self.fc_CI2CT = _tanh_proj(ci_dim, dtype)
            self.fc_CI2Pth = _tanh_proj(ci_dim, dtype)
        elif has_ct:
            self.TwoWayTransformer_CT = twoway()
            self.fc_CI2CT = _tanh_proj(ci_dim, dtype)
        elif has_pth:
            self.TwoWayTransformer_Pth = twoway()
            self.fc_CI2Pth = _tanh_proj(ci_dim, dtype)
        else:
            self.fc_CI = _tanh_proj(ci_dim, dtype)

        # the flagship pools fused 512-d streams — 'auto' resolves to off
        use_kernel = resolve_use_kernel(c.use_pallas, raw_bag=False)
        kind = c.aggregator
        head_in = EMBED_DIM

        def transmil(moe_experts=0):
            return TransMIL(c.num_classes, L=EMBED_DIM, dtype=dtype,
                            pinv_iterations=c.nystrom_pinv_iters,
                            moe_experts=moe_experts)

        if kind in ("ABMIL", "TransMIL_seperate"):
            # TransMIL_seperate's final pooling is ABMIL
            self.aggregator = ABMIL(L=EMBED_DIM, dtype=dtype,
                                    use_kernel=use_kernel)
            if kind == "TransMIL_seperate" and has_ct and has_pth:
                self.aggregator_CT = transmil()
                self.aggregator_Pth = transmil()
        elif kind == "ABMIL_v2":
            self.aggregator = ABMILv2(L=EMBED_DIM, dtype=dtype,
                                      use_kernel=use_kernel)
            head_in = EMBED_DIM + 1
        elif kind == "TransMIL":
            self.aggregator = transmil(c.moe_experts)
        elif kind == "TransMIL_per_modality":
            raise NotImplementedError(_PER_MODALITY_ITEM)
        elif kind == "-":
            self.aggregator = None
        else:
            raise ValueError(f"unknown aggregator {kind}")

        def head():
            return nn.Sequential(nn.Dropout(0.25),
                                 Dense(head_in, c.num_classes, dtype))

        self.fc = head()
        self.three_heads = has_ct and has_pth \
            and c.loss_point == "CT-Pth-Last"
        if self.three_heads:
            self.fc_CT = head()
            self.fc_Pth = head()
        # positional tables on the device, one per (length, dtype, device):
        # a served model sees a few bag buckets, and building and copying
        # a 16k-row table on every forward would cost more than the forward
        self._pe = {}

    def _pe_for(self, tokens):
        """Table for a token stream; a 5-D CT map counts its depth slices
        (TwoWay's spatial mean leaves one token a slice)."""
        key = (tokens.shape[1], tokens.dtype, tokens.device)
        if key not in self._pe:
            self._pe[key] = sinusoidal_pe(key[0], EMBED_DIM, dtype=key[1],
                                          device=key[2])[None]
        return self._pe[key]

    def _pool(self, tokens, mask, bprc, return_attn):
        """Run the MIL aggregator, normalising its return to ((B, D), attn)."""
        if isinstance(self.aggregator, TransMIL):
            return self.aggregator(tokens, mask=mask, return_attn=return_attn)
        if isinstance(self.aggregator, ABMILv2):
            pooled, attn = self.aggregator(tokens, bprc, mask=mask)
        else:
            pooled, attn = self.aggregator(tokens, mask=mask)
        return pooled[:, 0], attn           # K=1 → squeeze

    def _ct_tokens(self, batch):
        """The CT side's tokens: a 5-D layer4 map or (B, T, 512)."""
        c = self.cfg
        if "ct_features" in batch:
            feat = batch["ct_features"]
        elif not hasattr(self, "extractor_CT"):
            raise ValueError("this model was built for precomputed CT "
                             "features: the batch lacks 'ct_features'")
        else:
            ct_in = batch["input_CT"]
            if "wMask" in c.model_CT:
                # mask-aware variant: tumour mask as a 2nd input channel.
                # The trunk's stem is sized when the module is built, so a
                # wMask model needs the mask in every batch.
                if "mask_CT" not in batch:
                    raise ValueError(
                        f"model_CT={c.model_CT!r} takes the tumour mask as "
                        "a second input channel: the batch lacks 'mask_CT'")
                ct_in = torch.cat(
                    [ct_in, batch["mask_CT"].to(ct_in.dtype)], dim=-1)
            feat = self.extractor_CT(ct_in)
        if feat.dim() == 2:                         # pooled vector
            feat = feat[:, None, :]
        if feat.dim() == 3 and feat.shape[-1] != EMBED_DIM:
            if not hasattr(self, "fc_CT_proj"):
                raise ValueError(
                    f"ct_features of width {feat.shape[-1]} need a model "
                    f"built with ct_feature_dim={feat.shape[-1]}")
            feat = self.fc_CT_proj(feat)
        return feat

    def _fuse(self, tw, tokens, tok_mask, ci, swap):
        """Cross-attend modality tokens with the projected CI.

        Returns (modality_emb, ci_emb, (modality_emb_mask, ci_emb_mask)):
        ``swap=False`` → CI is the query side (reference default);
        ``swap=True`` → the modality is the query side.  The first return
        is always the reference's ``x_<mod>2CI`` (the query-side output),
        the second the other side.
        """
        if swap:
            q, k = tw(ci, self._pe_for(ci), tokens, point_mask=tok_mask)
            return q, k, (tok_mask, None)
        q, k = tw(tokens, self._pe_for(tokens), ci, image_mask=tok_mask)
        return q, k, (None, tok_mask)

    def forward(self, batch: Dict[str, Any], return_attn: bool = False):
        c = self.cfg
        ab = c.alignment_base
        has_ct, has_pth = self.has_ct, self.has_pth
        outputs: Dict[str, Any] = {}

        def encode_ci(extractor):
            y = extractor(batch["input_CI"])
            return y[:, None, :] if y.dim() == 2 else y

        if self.separate:
            x_ci_ct = encode_ci(self.clinic_extractor_CT)
            x_ci_pth = encode_ci(self.clinic_extractor_Pth)
        else:
            x_ci = x_ci_ct = x_ci_pth = encode_ci(self.clinic_extractor)

        pth_mask = batch.get("mask_pathology")
        ct_tokens = self._ct_tokens(batch) if has_ct else None
        pth_tokens = self.fc_pathology(batch["input_pathology"]) \
            if has_pth else None

        attns = []
        emb_ct2ci = emb_pth2ci = None
        pth_token_span = None       # (start, len, total) of the bag-instance
                                    # tokens inside x0
        if has_ct and has_pth:
            if self.separate:
                tw_ct = self.TwoWayTransformer_CT
                tw_pth = self.TwoWayTransformer_Pth
            else:
                tw_ct = tw_pth = self.TwoWayTransformer_Both
            emb_ct2ci, x_ci2ct, (ct_emb_mask, ci2ct_mask) = self._fuse(
                tw_ct, ct_tokens, None, self.fc_CI2CT(x_ci_ct),
                swap=(ab == "CT"))
            emb_pth2ci, x_ci2pth, (pth_emb_mask, ci2pth_mask) = self._fuse(
                tw_pth, pth_tokens, pth_mask, self.fc_CI2Pth(x_ci_pth),
                swap=(ab == "pathology"))
            if self.separate:
                outputs["emb_CI2CT"] = x_ci2ct
                outputs["emb_CI2Pth"] = x_ci2pth
            if hasattr(self, "aggregator_CT"):       # TransMIL_seperate
                x_ci2ct = self.aggregator_CT(
                    x_ci2ct, mask=ci2ct_mask)[0][:, None]
                x_ci2pth = self.aggregator_Pth(
                    x_ci2pth, mask=ci2pth_mask)[0][:, None]
                ci2ct_mask = ci2pth_mask = None
            streams = [emb_ct2ci, x_ci2ct, emb_pth2ci, x_ci2pth]
            masks = [ct_emb_mask, ci2ct_mask, pth_emb_mask, ci2pth_mask]
            x0 = torch.cat(streams, dim=1)
            x0_mask = _mask_or_ones(streams, masks)
            if ab != "pathology":   # x_ci2pth = TwoWay keys, 1 per instance
                pth_token_span = (x0.shape[1] - x_ci2pth.shape[1],
                                  x_ci2pth.shape[1], x0.shape[1])
        elif has_ct:
            emb_ct2ci, x_ci2ct, _ = self._fuse(
                self.TwoWayTransformer_CT, ct_tokens, None,
                self.fc_CI2CT(x_ci), swap=(ab == "CT"))
            x0 = torch.cat([emb_ct2ci, x_ci2ct], dim=1)
            x0_mask = None
        elif has_pth:
            emb_pth2ci, x_ci2pth, (pth_emb_mask, ci2pth_mask) = self._fuse(
                self.TwoWayTransformer_Pth, pth_tokens, pth_mask,
                self.fc_CI2Pth(x_ci), swap=(ab == "pathology"))
            streams = [emb_pth2ci, x_ci2pth]
            x0 = torch.cat(streams, dim=1)
            x0_mask = _mask_or_ones(streams, [pth_emb_mask, ci2pth_mask])
            if ab != "pathology":
                pth_token_span = (x0.shape[1] - x_ci2pth.shape[1],
                                  x_ci2pth.shape[1], x0.shape[1])
        else:                                            # CI-only
            x0 = self.fc_CI(x_ci)
            x0_mask = None

        bprc = batch.get("BpRc_class")
        if bprc is None and c.aggregator == "ABMIL_v2":
            bprc = torch.zeros((x0.shape[0], 1), dtype=x0.dtype,
                               device=x0.device)

        def head(fc, tokens, mask):
            if self.aggregator is None:
                pooled = tokens.mean(dim=1)
            else:
                pooled, attn = self._pool(tokens, mask, bprc, return_attn)
                if return_attn:
                    attns.append(attn)
            return activation(c, fc(pooled))

        outputs["probs"] = head(self.fc, x0, x0_mask)
        if self.three_heads:
            ct_streams = [emb_ct2ci, x_ci2ct]
            outputs["probs_CT"] = head(
                self.fc_CT, torch.cat(ct_streams, dim=1),
                _mask_or_ones(ct_streams, [ct_emb_mask, ci2ct_mask]))
            pth_streams = [emb_pth2ci, x_ci2pth]
            outputs["probs_Pth"] = head(
                self.fc_Pth, torch.cat(pth_streams, dim=1),
                _mask_or_ones(pth_streams, [pth_emb_mask, ci2pth_mask]))

        if emb_ct2ci is not None:
            outputs["emb_CT2CI"] = emb_ct2ci
        if emb_pth2ci is not None:
            outputs["emb_Pth2CI"] = emb_pth2ci
        if return_attn:
            outputs["attns"] = attns
            if pth_token_span is not None:
                outputs["pth_token_span"] = pth_token_span
        return outputs


def build_model(cfg: Config, device=None, seed: int | None = None,
                ct_feature_dim: int | None = None) -> nn.Module:
    """Model factory: ``model_family`` selects the flagship ``Aggregator``
    or a baseline.  The module is initialised from ``seed`` (``cfg.seed``
    when None) with an explicit CPU generator, so a seed gives the same
    weights on every device, then moved to ``device`` — the CUDA card unless
    the caller names another — in eval mode.  ``ct_feature_dim`` builds the
    flagship for precomputed CT features of that width, without a trunk
    (see :class:`Aggregator`)."""
    device = resolve_device(device)
    dtype = compute_dtype(cfg.compute_dtype)
    if "CT" in cfg.modality:
        known = ("resnetMC3_18", "resnetMC3_18_wMask", "medicalNet",
                 "resnet2plus1d_18", "MViT")
        if cfg.model_CT not in known and "SwinUNETR" not in cfg.model_CT:
            raise ValueError(f"unknown model_CT {cfg.model_CT!r}; "
                             f"expected one of {known} or *SwinUNETR*")
    if cfg.model_family == "clip":
        raise NotImplementedError(
            "model_family='clip' (AggregatorClip) is not ported yet "
            "(ROADMAP.md, Queue 1 item 6: the baselines' remaining branches)")
    if cfg.model_family == "concat":
        from .baselines import AggregatorConcat
        model = AggregatorConcat(cfg, dtype)
    elif "wMask" in cfg.model_CT and cfg.wmask_family == "concat":
        raise NotImplementedError(
            "the wMask concat-fusion model (AggregatorWMask) is not ported "
            "yet (ROADMAP.md, Queue 1 item 6: the baselines' remaining "
            "branches)")
    else:
        model = Aggregator(cfg, dtype, ct_feature_dim=ct_feature_dim)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(cfg.seed if seed is None else seed)
    init_weights(model, gen)
    return model.to(device).eval()
