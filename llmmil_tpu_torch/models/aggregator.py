"""Flagship multimodal MIL model — the branches ported so far.

Structure of the full model (the JAX package's ``models/aggregator.py``):
  extractor_CT (model_CT) ─┐
  fc_pathology 768→512 Tanh ─┤
  clinic_extractor (model_CI / CoOp-CLIP) → fc_CI2CT / fc_CI2Pth (Tanh) ─┤
  TwoWayTransformer(depth 2, dim 512, heads 8, mlp 2048) fuses each
  modality's tokens with the projected CI; concat token streams → MIL
  aggregator → Dropout(0.25) + Linear → sigmoid/softmax.

Ported: ``modality=["pathology"]`` and clinical-information-only, with
aggregators ``ABMIL``, ``ABMIL_v2`` and ``-``.  The CT branch and the
TransMIL aggregators raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them.  Submodules carry the reference's ``state_dict``
names (``fc_pathology.0``, ``TwoWayTransformer_Pth.layers.0...``, ``fc.1``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..config import Config
from ..device import resolve_device
from ..ops.kernels import resolve_use_kernel
from ..ops.positional import sinusoidal_pe
from .abmil import ABMIL, ABMILv2
from .clip_text import CLIPTextConfig, CoOpClinicalEncoder
from .layers import Dense, compute_dtype, init_weights
from .simple_fcs import (SimpleFCsV1, SimpleFCsV1d, SimpleFCsV2,
                         SimpleFCsV2d)
from .twoway import TwoWayTransformer

EMBED_DIM = 512

_CT_ITEM = ("the CT branch is not ported yet (ROADMAP.md, Queue 1 item 1: "
            "models/ct_mc3.py and the tri-modal Aggregator branches)")
_TRANSMIL_ITEM = ("aggregator={kind!r} is not ported yet (ROADMAP.md, "
                  "Queue 1 item 2: models/transmil.py + ops/nystrom.py)")


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


def _tanh_proj(in_dim: int, dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(Dense(in_dim, EMBED_DIM, dtype), nn.Tanh())


def activation(cfg: Config, logits: torch.Tensor) -> torch.Tensor:
    if cfg.activationF == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


class Aggregator(nn.Module):
    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.compute_dtype = dtype
        self.has_pth = "pathology" in c.modality
        if "CT" in c.modality:
            raise NotImplementedError(_CT_ITEM)

        ab = c.alignment_base
        if ab not in ("CT", "pathology", "CI", "none"):
            raise ValueError(f"unknown alignment_base {ab!r}")
        if ab == "CT":
            raise ValueError("alignment_base='CT' without CT modality")
        if ab == "pathology" and not self.has_pth:
            raise ValueError("alignment_base='pathology' without pathology")

        self.clinic_extractor = make_clinic_extractor(c, dtype)
        ci_dim = c.clip_embed if c.model_CI == "CLIP" else 512
        if self.has_pth:
            self.fc_pathology = _tanh_proj(768, dtype)
            self.TwoWayTransformer_Pth = TwoWayTransformer(
                depth=c.twoway_depth or 2, embedding_dim=EMBED_DIM,
                num_heads=8, mlp_dim=2048, dtype=dtype)
            self.fc_CI2Pth = _tanh_proj(ci_dim, dtype)
        else:
            self.fc_CI = _tanh_proj(ci_dim, dtype)

        # the flagship pools fused 512-d streams — 'auto' resolves to off
        use_kernel = resolve_use_kernel(c.use_pallas, raw_bag=False)
        kind = c.aggregator
        head_in = EMBED_DIM
        if kind == "ABMIL":
            self.aggregator = ABMIL(L=EMBED_DIM, dtype=dtype,
                                    use_kernel=use_kernel)
        elif kind == "ABMIL_v2":
            self.aggregator = ABMILv2(L=EMBED_DIM, dtype=dtype,
                                      use_kernel=use_kernel)
            head_in = EMBED_DIM + 1
        elif kind in ("TransMIL", "TransMIL_seperate",
                      "TransMIL_per_modality"):
            raise NotImplementedError(_TRANSMIL_ITEM.format(kind=kind))
        elif kind == "-":
            self.aggregator = None
        else:
            raise ValueError(f"unknown aggregator {kind}")
        self.fc = nn.Sequential(nn.Dropout(0.25),
                                Dense(head_in, c.num_classes, dtype))
        # positional tables on the device, one per (length, dtype, device):
        # a served model sees a few bag buckets, and building and copying
        # a 16k-row table on every forward would cost more than the forward
        self._pe = {}

    def _pe_for(self, tokens):
        key = (tokens.shape[1], tokens.dtype, tokens.device)
        if key not in self._pe:
            self._pe[key] = sinusoidal_pe(key[0], EMBED_DIM, dtype=key[1],
                                          device=key[2])[None]
        return self._pe[key]

    def _pool(self, tokens, mask, bprc):
        """Run the MIL aggregator, normalising its return to ((B, D), attn)."""
        if isinstance(self.aggregator, ABMILv2):
            pooled, attn = self.aggregator(tokens, bprc, mask=mask)
        else:
            pooled, attn = self.aggregator(tokens, mask=mask)
        return pooled[:, 0], attn           # K=1 → squeeze

    def forward(self, batch: Dict[str, Any], return_attn: bool = False):
        c = self.cfg
        outputs: Dict[str, Any] = {}

        x_ci = self.clinic_extractor(batch["input_CI"])
        if x_ci.dim() == 2:
            x_ci = x_ci[:, None, :]

        pe_for = self._pe_for
        attns = []
        emb_pth2ci = None
        pth_token_span = None       # (start, len, total) of the bag-instance
                                    # tokens inside x0
        if self.has_pth:
            pth_tokens = self.fc_pathology(batch["input_pathology"])
            pth_mask = batch.get("mask_pathology")
            ci_pth = self.fc_CI2Pth(x_ci)
            tw = self.TwoWayTransformer_Pth
            # alignment_base picks the query ("point") side: CI by default,
            # the bag with 'pathology'
            if c.alignment_base == "pathology":
                emb_pth2ci, x_ci2pth = tw(ci_pth, pe_for(ci_pth), pth_tokens,
                                          point_mask=pth_mask)
                masks = [pth_mask, None]
            else:
                emb_pth2ci, x_ci2pth = tw(pth_tokens, pe_for(pth_tokens),
                                          ci_pth, image_mask=pth_mask)
                masks = [None, pth_mask]
                pth_token_span = (emb_pth2ci.shape[1], x_ci2pth.shape[1],
                                  emb_pth2ci.shape[1] + x_ci2pth.shape[1])
            streams = [emb_pth2ci, x_ci2pth]
            x0 = torch.cat(streams, dim=1)
            x0_mask = None
            if pth_mask is not None:
                x0_mask = torch.cat(
                    [m.expand(s.shape[:2]) if m is not None
                     else torch.ones(s.shape[:2], dtype=torch.bool,
                                     device=s.device)
                     for s, m in zip(streams, masks)], dim=1)
        else:                                            # CI-only
            x0 = self.fc_CI(x_ci)
            x0_mask = None

        bprc = batch.get("BpRc_class")
        if bprc is None and c.aggregator == "ABMIL_v2":
            bprc = torch.zeros((x0.shape[0], 1), dtype=x0.dtype,
                               device=x0.device)
        if self.aggregator is None:
            pooled = x0.mean(dim=1)
        else:
            pooled, attn = self._pool(x0, x0_mask, bprc)
            if return_attn:
                attns.append(attn)
        outputs["probs"] = activation(c, self.fc(pooled))

        if emb_pth2ci is not None:
            outputs["emb_Pth2CI"] = emb_pth2ci
        if return_attn:
            outputs["attns"] = attns
            if pth_token_span is not None:
                outputs["pth_token_span"] = pth_token_span
        return outputs


def build_model(cfg: Config, device=None, seed: int | None = None
                ) -> nn.Module:
    """Model factory: ``model_family`` selects the flagship ``Aggregator``
    or a baseline.  The module is initialised from ``seed`` (``cfg.seed``
    when None) with an explicit CPU generator, so a seed gives the same
    weights on every device, then moved to ``device`` — the CUDA card unless
    the caller names another — in eval mode."""
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
    elif "wMask" in cfg.model_CT and cfg.wmask_family == "concat" \
            and "CT" in cfg.modality:
        raise NotImplementedError(
            "the wMask concat-fusion model (AggregatorWMask) is not ported "
            "yet (ROADMAP.md, Queue 1 item 6: the baselines' remaining "
            "branches)")
    else:
        model = Aggregator(cfg, dtype)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(cfg.seed if seed is None else seed)
    init_weights(model, gen)
    return model.to(device).eval()
