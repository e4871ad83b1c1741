"""Baseline fusion models — the branches ported so far.

``AggregatorConcat``: the oldest baseline — per-modality features
concatenated → fc1 → fc2 → sigmoid.  Its CT branch mean-pools the layer4 map
of an MC3-18 trunk built with the trunk's defaults (native 3-D
convolutions); its pathology branch pools the RAW 768-d bag with ABMIL,
which is where ``use_pallas='auto'`` turns the fused kernel on.
``AggregatorClip`` and ``AggregatorWMask`` are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..config import Config
from ..ops.kernels import resolve_use_kernel
from .abmil import ABMIL
from .aggregator import EMBED_DIM, activation
from .ct_mc3 import ResnetMC3_18
from .layers import Dense


class _CTPooled(nn.Module):
    """CT volume → pooled 512-d vector (mean over the layer4 map)."""

    def __init__(self, spacing_xy: float = 0.6869,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trunk = ResnetMC3_18(spacing_xy=spacing_xy, dtype=dtype)

    def forward(self, x):
        return self.trunk(x).mean(dim=(1, 2, 3))


class AggregatorConcat(nn.Module):
    """Concat-fusion baseline."""

    def __init__(self, cfg: Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        in_dim = 0
        self.has_ct = "CT" in cfg.modality
        if self.has_ct:
            self.extractor_CT = _CTPooled(cfg.spacing[0], dtype)
            in_dim += EMBED_DIM
        self.has_pth = "pathology" in cfg.modality
        if self.has_pth:
            self.extractor_pathology = ABMIL(
                L=768, dtype=dtype,
                use_kernel=resolve_use_kernel(cfg.use_pallas, raw_bag=True))
            in_dim += 768
        # The JAX module sizes fc1 from the first batch, so numeric
        # clinical information joins the concat whenever a batch carries
        # it.  Here fc1 is sized when the module is built: 'CI' in
        # ``modality`` says that batches carry the numeric vector.
        self.n_ci = cfg.ci_input_dim if "CI" in cfg.modality else 0
        in_dim += self.n_ci
        self.fc1 = Dense(in_dim, EMBED_DIM, dtype)
        self.fc2 = Dense(EMBED_DIM, cfg.num_classes, dtype)

    def forward(self, batch: Dict[str, Any], return_attn: bool = False):
        parts = []
        if self.has_ct:
            parts.append(self.extractor_CT(batch["input_CT"]))
        if self.has_pth:
            pooled, _ = self.extractor_pathology(
                batch["input_pathology"], batch.get("mask_pathology"))
            parts.append(pooled[:, 0])
        ci = batch.get("input_CI")
        has_ci = ci is not None and ci.is_floating_point()
        if has_ci != bool(self.n_ci):
            raise ValueError(
                "AggregatorConcat was built "
                + ("with" if self.n_ci else "without") + " 'CI' in "
                "cfg.modality, but the batch "
                + ("carries" if has_ci else "lacks") + " a numeric input_CI")
        if has_ci:
            parts.append(ci.to(self.compute_dtype))
        x = torch.cat(parts, dim=-1)
        x = torch.relu(self.fc1(x))
        return {"probs": activation(self.cfg, self.fc2(x))}
