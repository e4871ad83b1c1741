"""Cohort construction: master-table filtering, survival labels, splits (the
JAX package's ``data/cohort.py``, without pandas or sklearn).

The cohort table is a list of records (one dict a patient, the reference's
column names as keys).  ``kfold_split`` reproduces sklearn's
``KFold(n_splits, shuffle=True, random_state=42)``: the same folds, each
split's rows in the table's order.  The master table is read from a
same-schema ``Lung_Overall2.csv``; the ``.xlsx`` reader waits with the other
file readers (ROADMAP.md, Queue 1 item 12).
"""

from __future__ import annotations

import csv
import datetime
import os
from typing import Dict, List, Sequence

import numpy as np

Records = List[Dict]

ALL_HOSPITALS = ["AJMC", "EUMC", "CNUH", "HUMC", "PNUH", "SCHMC"]

# CT rotated / too few z-slices / over-cropped
EXCLUDED_PATIENT_IDS = [
    "A10065", "A10094",
    "A11512", "A12867",
    "A10237", "A110004", "A110027", "A110541",
    "A40186", "A40211", "A40222", "A40235", "A40251", "A40261", "A40273",
    "A40274", "A40280", "A40281", "A40282", "A40301", "A40308", "A40322",
    "A40326", "A40343", "A40348", "A40359", "A40368", "A40374", "A40375",
    "A40379", "A40393", "A40430", "A40453", "A40461", "A40472", "A40478",
    "A40490", "A40494", "A40495", "A40505", "A40541", "A40629", "A40637",
    "A40856", "A40860", "A40865", "A40884", "A40914", "A40932", "A40941",
    "A40947", "A40949", "A40958", "A40966", "A40968", "A40988", "A40991",
    "A40992", "A40993", "A41011", "A41056", "A41060", "A41508", "A41510",
    "A41513", "A41521", "A41547", "A41548", "A41557", "A41592", "A41599",
    "A41601", "A41614", "A41619", "A41622", "A41637", "A41653", "A41690",
    "A41704", "A41710", "A41712",
    "A60253", "A60374",
    "A93650", "A96982",
    "A131302", "A131341",
    "A70312",
    "A90169", "A91031", "A93350", "A93761", "A96937",
]

_STAGE_SETS = {
    "1": [1, "1", "1a", "1b", "1c"],
    "2": [2, "2", "2a", "2b", "2c"],
    "3": [3, "3", "3a", "3b", "3c"],
    "4": [4, "4", "4a", "4b", "4c"],
}


def _cell(v: str):
    """A csv cell as the number it spells, '' as None, else the string."""
    if v == "":
        return None
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def load_cohort_table(path_data_excel: str) -> Records:
    """The master sheet as records, from ``Lung_Overall2.csv``."""
    path = os.path.join(path_data_excel, "Lung_Overall2.csv")
    if os.path.exists(path):
        with open(path, newline="") as f:
            return [{k: _cell(v) for k, v in row.items()}
                    for row in csv.DictReader(f)]
    if os.path.exists(os.path.join(path_data_excel, "Lung_Overall2.xlsx")):
        raise NotImplementedError(
            "reading Lung_Overall2.xlsx is not ported yet (ROADMAP.md, Queue "
            "1 item 12: real-file loading); export it as Lung_Overall2.csv")
    raise FileNotFoundError(f"no Lung_Overall2.csv under {path_data_excel}")


def _date(v) -> datetime.date:
    if isinstance(v, datetime.datetime):
        return v.date()
    if isinstance(v, datetime.date):
        return v
    return datetime.date.fromisoformat(str(v).strip()[:10])


def select_with_label(records: Records, survival_type: str = "OS",
                      year: int = 5) -> Records:
    """Survival labels: 0 = survived ≥ year·365 days, 1 = died of the
    disease (deathsign 1, or any death at EUMC), 2 = excluded (deathsign
    2), 3 = undetermined; keeps {0, 1}."""
    out = []
    for r in records:
        days = abs((_date(r["lastdate"]) - _date(r["treatedate"])).days)
        label = 3
        if survival_type == "OS":
            if days >= year * 365 and r["dead"] == 0:
                label = 0
            if days < year * 365 and days > 0 and r["dead"] == 1:
                if r["deathsign"] == 1:
                    label = 1
                if r["deathsign"] == 2:
                    label = 2
                if r["hospital"] == "EUMC":
                    label = 1
        elif survival_type == "RFS":
            if days >= year * 365 and r["relapse"] == 1:
                label = 0
            if days < year * 365 and days > 0 and r["relapse"] != 1:
                label = 1
        if label in (0, 1):
            out.append(dict(r, label=label))
    return out


def select_valid_fields(records: Records) -> Records:
    """Clinical-field validity filter and the derived T / TNM labels."""
    stages = [1, 2, 3, 4, "1", "2", "3", "4",
              "1a", "1b", "1c", "2a", "2b", "2c",
              "3a", "3b", "3c", "4a", "4b", "4c"]
    high_t = [3, "3", "3a", "3b", "3c", 4, "4", "4a", "4b", "4c"]
    out = []
    for r in records:
        if (r["classification cancer"] in (1, 2)
                and r["cancerimaging"] in stages
                and r["cancerimagingT"] in stages
                and r["cancerimagingN"] in [0, "0"] + stages
                and r["cancerimagingM"] in (0, 1, "0", "1", "1a", "1b", "1c")
                and r["sex"] in ("M", "F") and r["sm"] in ("N", "Y")
                and r["locationcancer"] in (1, 2, 3, 4, 5)):
            out.append(dict(r, label_T=int(r["cancerimagingT"] in high_t),
                            label_TNM=int(r["cancerimaging"] in high_t)))
    return out


def hospital_split(records: Records, hospital_test: Sequence[str],
                   mode: str) -> Records:
    """Train hospitals = all − ``hospital_test``; 'test' takes the rest."""
    if mode == "test":
        hospitals = list(hospital_test)
    else:
        hospitals = [h for h in ALL_HOSPITALS if h not in hospital_test]
    return [r for r in records if r["hospital"] in hospitals]


def kfold_split(records: Records, kfold_num: int, val_fold: int,
                mode: str) -> Records:
    """sklearn's ``KFold(kfold_num, shuffle=True, random_state=42)``: fold
    ``val_fold`` is 'valid', the others 'train'; 'test' passes through."""
    if mode == "test":
        return records
    n = len(records)
    if not 0 <= val_fold < kfold_num:
        raise ValueError(f"val_fold {val_fold} out of range")
    if kfold_num > n:
        raise ValueError(f"Cannot have number of splits n_splits="
                         f"{kfold_num} greater than the number of samples: "
                         f"n_samples={n}.")
    order = np.arange(n)
    np.random.RandomState(42).shuffle(order)
    sizes = np.full(kfold_num, n // kfold_num)
    sizes[:n % kfold_num] += 1
    start = int(sizes[:val_fold].sum())
    valid = np.zeros(n, bool)
    valid[order[start:start + sizes[val_fold]]] = True
    keep = valid if mode == "valid" else ~valid
    return [r for r, k in zip(records, keep) if k]


def stage_filter(records: Records, cancerstage: str) -> Records:
    """Keep the cancer stages named by the digits of ``cancerstage``."""
    if cancerstage in ("", "1234", None):
        return records
    allowed: List = []
    for ch in cancerstage:
        allowed += _STAGE_SETS[ch]
    return [r for r in records if r["cancerimaging"] in allowed]


def build_cohort(cfg, mode: str) -> Records:
    """The cohort of a split from the master table."""
    rows = load_cohort_table(cfg.path_data_excel)
    rows = [r for r in rows if r.get("CT_before1") is not None]
    if rows and "CT ID mismatch" in rows[0]:
        rows = [r for r in rows if r["CT ID mismatch"] == 0]
    rows = [r for r in rows if r["pathologyimage"] in ("Biopsy", "Resection")]
    rows = select_with_label(rows, cfg.survival_type, cfg.year)
    rows = select_valid_fields(rows)
    rows = hospital_split(rows, cfg.hospital_test, mode)
    rows = kfold_split(rows, cfg.kfold_num, cfg.val_fold, mode)
    rows = [r for r in rows if r["patientid"] not in EXCLUDED_PATIENT_IDS]
    stage = cfg.cancerstageTrain if mode == "train" else cfg.cancerstageTest
    return stage_filter(rows, stage)
