"""Loss functions (the JAX package's ``train/losses.py``).

BCE on sigmoid outputs for two classes, cross-entropy above (the reference
feeds softmaxed outputs to it, reproduced), the cosine-embedding alignment
term of ``loss="...textCosSim"``, the CT + Pth + Last multi-head sum and the
CLIP contrastive loss.  The arithmetic follows the JAX functions op for op,
in the inputs' types.
"""

from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-7


def bce_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``torch.nn.BCELoss`` on probabilities vs one-hot targets (mean)."""
    p = probs.clamp(_EPS, 1.0 - _EPS)
    return -torch.mean(targets * torch.log(p)
                       + (1.0 - targets) * torch.log1p(-p))


def ce_as_torch(outputs: torch.Tensor, targets_onehot: torch.Tensor
                ) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss`` semantics: inputs treated as logits."""
    logp = torch.log_softmax(outputs, dim=-1)
    return -torch.mean(torch.sum(targets_onehot * logp, dim=-1))


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor,
                          target: int = 1, margin: float = 0.0
                          ) -> torch.Tensor:
    """``torch.nn.CosineEmbeddingLoss`` with the JAX package's epsilon."""
    cos = torch.sum(x1 * x2, dim=-1) / torch.clamp_min(
        torch.linalg.norm(x1, dim=-1) * torch.linalg.norm(x2, dim=-1), _EPS)
    if target == 1:
        return torch.mean(1.0 - cos)
    return torch.mean(torch.clamp_min(cos - margin, 0.0))


def _criterion(num_classes: int):
    return bce_probs if num_classes <= 2 else ce_as_torch


def multihead_loss(outputs: Dict[str, torch.Tensor], targets: torch.Tensor,
                   loss_point: str, loss_name: str, num_classes: int = 2
                   ) -> Dict[str, torch.Tensor]:
    """CT + Pth + Last sum plus the optional textCosSim term; a dict of
    named scalars with the total under 'loss'."""
    crit = _criterion(num_classes)
    terms: Dict[str, torch.Tensor] = {}
    loss_last = crit(outputs["probs"], targets)
    if loss_point == "CT-Pth-Last" and "probs_CT" in outputs:
        terms["loss_CT"] = crit(outputs["probs_CT"], targets)
        terms["loss_Pth"] = crit(outputs["probs_Pth"], targets)
        terms["loss_Last"] = loss_last
        total = terms["loss_CT"] + terms["loss_Pth"] + loss_last
    else:
        total = loss_last
    if "textCosSim" in loss_name and "emb_CT2CI" in outputs \
            and "emb_Pth2CI" in outputs:
        cos = cosine_embedding_loss(outputs["emb_CT2CI"][:, 0],
                                    outputs["emb_Pth2CI"][:, 0])
        terms["loss_CosSim"] = cos
        total = total + cos
    terms["loss"] = total
    return terms


def clip_contrastive_loss(features: torch.Tensor,
                          text_features: torch.Tensor,
                          logit_scale: float = 100.0) -> torch.Tensor:
    """Cross-entropy between scaled feature/text similarity logits and
    identity labels (the reference's ``CLIPloss_v1``)."""
    f = features / torch.clamp_min(
        torch.linalg.norm(features, dim=-1, keepdim=True), _EPS)
    t = text_features / torch.clamp_min(
        torch.linalg.norm(text_features, dim=-1, keepdim=True), _EPS)
    logits = logit_scale * f @ t.T
    n = logits.shape[0]
    labels = torch.nn.functional.one_hot(
        torch.arange(n, device=logits.device), logits.shape[-1]).to(
        logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels * logp, dim=-1))
