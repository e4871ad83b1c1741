"""Clinical-information encoding: scalar vectors, one-hots, text prompts
(the JAX package's ``data/clinical.py``): the reference's value
normalisation, the v1 scalar vector, the v2 one-hot concatenation, their
tiled "duplicated" variants, the single / devided prompt sentences and the
CoOp "X " prefix.  Pure-python functions of one cohort row (a dict).
"""

from __future__ import annotations

import datetime

import math
from typing import Dict, List

import numpy as np

CLINICAL_FEATURES = [
    "sex", "age", "sm", "locationcancer", "cancerimaging",
    "cancerimagingT", "cancerimagingN", "cancerimagingM",
    "classification_cancer",
]

_LOCATIONS = {1: "right superior lobe", 2: "right middle lobe",
              3: "right inferior lobe", 4: "left superior lobe",
              5: "left inferior lobe"}
_TYPES = {1: "adenocarcinoma", 2: "squamous cell carcinoma"}

_CAT = {"M": 0, "F": 1, "N": 0, "Y": 1, "n": 0, "y": 1}
_STAGE = {"1a": 1, "1b": 1, "1c": 1, "2a": 2, "2b": 2, "2c": 2,
          "3a": 3, "3b": 3, "3c": 3, "4a": 4, "4b": 4, "4c": 4}


def _canon(v):
    """M/F→0/1, N/Y→0/1, '3a'→3, '2'→2."""
    if isinstance(v, str):
        if v in _CAT:
            return _CAT[v]
        if v in _STAGE:
            return _STAGE[v]
        return int(v)
    return int(v)


def _age(row: Dict) -> float:
    """age = 2023 − birth-year; the birth date as an ISO 'YYYY-MM-DD…'
    string or a date."""
    if "age" in row and row["age"] is not None:
        return float(row["age"])
    born = row["birth date"]
    if not isinstance(born, (datetime.date, datetime.datetime)):
        born = datetime.date.fromisoformat(str(born).strip()[:10])
    return float(2023 - born.year)


def replace_fields(row: Dict) -> Dict:
    """Canonicalised numeric fields for one patient row."""
    out = {
        "sex": _canon(row["sex"]),
        "age": _age(row),
        "sm": _canon(row["sm"]),
        "locationcancer": _canon(row["locationcancer"]),
        "cancerimaging": _canon(row["cancerimaging"]),
        "cancerimagingT": _canon(row["cancerimagingT"]),
        "cancerimagingN": _canon(row["cancerimagingN"]),
        "cancerimagingM": _canon(row["cancerimagingM"]),
        "classification_cancer": _canon(
            row.get("classification cancer", row.get("classification_cancer"))),
    }
    return out


def clinical_vector(row: Dict, version: str = "v1",
                    features: List[str] = CLINICAL_FEATURES,
                    duplicated: bool = False) -> np.ndarray:
    """v1 scalar vector or v2 one-hot concatenation; ``duplicated`` tiles it
    for the *d model variants."""
    r = replace_fields(row)
    if version == "v1":
        norm = {
            "sex": r["sex"], "age": (r["age"] - 30) / 90, "sm": r["sm"],
            "locationcancer": r["locationcancer"] / 5,
            "cancerimaging": r["cancerimaging"] / 4,
            "cancerimagingT": r["cancerimagingT"] / 4,
            "cancerimagingN": r["cancerimagingN"] / 4,
            "cancerimagingM": r["cancerimagingM"],
            "classification_cancer": r["classification_cancer"] / 2,
        }
        vec = np.array([norm[f] for f in features], dtype=np.float32)
    elif version == "v2":
        onehots = {
            "sex": np.eye(2)[r["sex"]],
            "age": np.array([(r["age"] - 30) / 90]),
            "sm": np.eye(2)[r["sm"]],
            "locationcancer": np.eye(5)[r["locationcancer"] - 1],
            "cancerimaging": np.eye(4)[r["cancerimaging"] - 1],
            "cancerimagingT": np.eye(4)[r["cancerimagingT"] - 1],
            "cancerimagingN": np.eye(5)[r["cancerimagingN"]],
            "cancerimagingM": np.eye(2)[r["cancerimagingM"]],
            "classification_cancer": np.eye(2)[r["classification_cancer"] - 1],
        }
        vec = np.concatenate([np.atleast_1d(onehots[f]) for f in features]
                             ).astype(np.float32)
    else:
        raise ValueError(version)
    if duplicated:
        reps = 1 + math.floor(512 / vec.shape[0])
        vec = np.tile(vec, reps)
    return vec


def clinical_prompts(row: Dict, prompt_version: str = "single",
                     learnable_prompt: bool = True, n_ctx: int = 8
                     ) -> List[str]:
    """Render the clinical sentence(s)."""
    r = replace_fields(row)
    sex = "male" if r["sex"] == 0 else "female"
    smoke = "nonsmoker" if r["sm"] == 0 else "smoker"
    location = _LOCATIONS[r["locationcancer"]]
    ctype = _TYPES[r["classification_cancer"]]
    age = int(r["age"])
    if prompt_version == "single":
        clinic = ["%d years old %s %s lung cancer patient, stage %d, "
                  "T%dN%dM%d, location %s, type %s"
                  % (age, sex, smoke, r["cancerimaging"],
                     r["cancerimagingT"], r["cancerimagingN"],
                     r["cancerimagingM"], location, ctype)]
    elif prompt_version == "devided":
        clinic = ["a photo of lung cancer patient",
                  "a photo of %d years old" % age,
                  "a photo of %s" % sex,
                  "a photo of %s" % smoke,
                  "a photo of stage %d" % r["cancerimaging"],
                  "a photo of T stage %d" % r["cancerimagingT"],
                  "a photo of N stage %d" % r["cancerimagingN"],
                  "a photo of M stage %d" % r["cancerimagingM"],
                  "a photo of %s" % location,
                  "a photo of %s" % ctype]
    else:
        raise ValueError(prompt_version)
    if learnable_prompt:
        prefix = " ".join(["X"] * n_ctx)
        return [prefix + " " + c + "." for c in clinic]
    return [c.replace(",", "") + "." for c in clinic]
