"""Evaluation metrics, host-side numpy (the JAX package's
``train/metrics.py``, which mirrors sklearn's ``roc_auc_score``,
``recall_score`` and ``precision_score`` as the reference uses them and the
Youden threshold ``argmax(tpr - fpr)``).  No sklearn."""

from __future__ import annotations

import numpy as np

# numpy >= 2.0 names it trapezoid; older releases only trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def roc_curve(labels, scores):
    """(fpr, tpr, thresholds) like ``sklearn.roc_curve`` with
    ``drop_intermediate=False``: thresholds descending."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    scores_s, labels_s = scores[order], labels[order]
    distinct = np.where(np.diff(scores_s))[0]
    idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels_s)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, scores_s[idx]]
    n_pos = max(labels.sum(), 1)
    n_neg = max((~labels).sum(), 1)
    return fps / n_neg, tps / n_pos, thr


def roc_auc(labels, scores) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return float(_trapezoid(tpr, fpr))


def roc_auc_ovo_macro(labels, probs) -> float:
    """Multi-class one-vs-one macro AUC: the binary AUC of every ordered
    class pair over the samples of those two classes, averaged."""
    labels = np.asarray(labels)
    probs = np.asarray(probs)
    classes = np.unique(labels)
    aucs = []
    for i, a in enumerate(classes):
        for b in classes[i + 1:]:
            sel = np.isin(labels, (a, b))
            if labels[sel].min() == labels[sel].max():
                continue
            y = (labels[sel] == b).astype(int)
            aucs.append(roc_auc(y, probs[sel, b]))
            aucs.append(roc_auc(1 - y, probs[sel, a]))
    return float(np.mean(aucs)) if aucs else float("nan")


def youden_threshold(labels, scores) -> float:
    """Best decision threshold = argmax(tpr − fpr)."""
    fpr, tpr, thr = roc_curve(labels, scores)
    return float(thr[np.argmax(tpr - fpr)])


def accuracy_onehot(probs, targets_onehot) -> float:
    """Top-1 accuracy of argmax(probs) vs argmax(one-hot target)."""
    preds = np.argmax(np.asarray(probs), axis=-1)
    want = np.argmax(np.asarray(targets_onehot), axis=-1)
    return float((preds == want).mean())


def precision_recall(labels, preds, average: str = "binary"):
    """(precision, recall); 'binary' (positive class 1) or 'macro'."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)

    def _pr(cls):
        tp = np.sum((preds == cls) & (labels == cls))
        fp = np.sum((preds == cls) & (labels != cls))
        fn = np.sum((preds != cls) & (labels == cls))
        prec = tp / (tp + fp) if tp + fp else np.nan
        rec = tp / (tp + fn) if tp + fn else np.nan
        return prec, rec

    if average == "binary":
        return _pr(1)
    classes = np.unique(np.r_[labels, preds])
    prs = np.array([_pr(c) for c in classes], dtype=np.float64)
    return tuple(np.nanmean(prs, axis=0))
