"""Run-directory naming and configuration provenance (the JAX package's
``utils/run_dir.py``): the save directory is a function of the configuration
(test hospitals, modality code, training stages, model names, spacing,
mask/crop flags, fold, timestamp), and every run writes ``config.txt`` and
``config.json`` into it.
"""

from __future__ import annotations

import json
import os
import time

from ..config import Config

_MODALITY_CODE = {"CT": "1", "pathology": "2", "CI": "3"}


def _model_name(cfg: Config) -> str:
    parts = []
    if "CT" in cfg.modality:
        parts.append(cfg.model_CT)
    if "pathology" in cfg.modality:
        parts.append(cfg.model_pathology)
    if "CI" in cfg.modality:
        parts.append(cfg.model_CI)
    return "-".join(parts) + f"({cfg.aggregator})"


def make_save_dir(cfg: Config) -> str:
    hosp = "+".join(cfg.hospital_test)
    modality = "".join(_MODALITY_CODE[m] for m in cfg.modality)
    spacing = ",".join(str(s) for s in cfg.spacing)
    ts = time.strftime("%Y-%m-%d-%H:%M:%S")
    if "CT" in cfg.modality:
        mask = "O" if "wMask" in cfg.model_CT else "X"
        crop = "O" if cfg.tumorCrop else "X"
        rel = (f"{hosp}/modality({modality})/stage_tr({cfg.cancerstageTrain})"
               f"/{_model_name(cfg)}/norm_[{spacing}]/mask({mask})"
               f"/crop({crop})/[{cfg.val_fold}]{ts}")
    else:
        rel = (f"{hosp}/modality({modality})/stage_tr({cfg.cancerstageTrain})"
               f"/{_model_name(cfg)}/norm_[{spacing}]/[{cfg.val_fold}]{ts}")
    save_dir = os.path.join(cfg.save_dir, "SavedModels", rel)
    os.makedirs(save_dir, exist_ok=True)
    return save_dir


def dump_config(cfg: Config, save_dir: str) -> None:
    """config.txt (key: value lines) + config.json."""
    with open(os.path.join(save_dir, "config.txt"), "w") as f:
        for k, v in cfg.to_dict().items():
            f.write(f"{k}: {v}\n")
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
