"""CT volume preprocessing, numpy (the array functions of the JAX package's
``data/ct_io.py``): the DICOM-metadata HU normalisation, the crop/pad to
(160, H, W) and the tumour-crop box.

Reading volumes from files (NIfTI, DICOM tags, NRRD masks, the decoded-CT
cache) is not ported yet: those readers raise, naming ROADMAP.md Queue 1
item 12.  The synthetic cohort and in-memory feature stores need none of
them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

FILE_READERS_ITEM = (
    "reading CT volumes, masks and metadata from files is not ported yet "
    "(ROADMAP.md, Queue 1 item 12: real-file loading)")


def read_nifti(path: str) -> np.ndarray:
    raise NotImplementedError(f"{FILE_READERS_ITEM}: {path}")


def load_ct_metadata(path: str) -> Dict:
    raise NotImplementedError(f"{FILE_READERS_ITEM}: {path}")


def hu_normalize(img: np.ndarray, metadata: Dict | None = None
                 ) -> np.ndarray:
    """Slope/intercept rescale, clamp to [−1024, 1000], MONOCHROME1
    inversion, map to [0, 1)."""
    metadata = metadata or {}
    img = np.asarray(img, dtype=np.float32)
    if "RescaleSlope" in metadata and "RescaleIntercept" in metadata:
        img = img * float(metadata["RescaleSlope"]) \
            + float(metadata["RescaleIntercept"])
    img = np.clip(img, -1024, 1000)
    if metadata.get("PhotometricInterpretation") == "MONOCHROME1":
        img = 2 ** int(metadata.get("BitsStored", 12)) - img
    return (img + 1024) / (1000 + 1024)


def crop_or_pad_volume(img: np.ndarray, depth: int = 160,
                       hw: int = 512) -> np.ndarray:
    """Fix (C, H, W) to (depth, hw, hw): slice from the front / centre-pad
    the depth, centre-crop / pad in-plane."""
    c, h, w = img.shape
    if c >= depth:
        img = img[:depth]
    else:
        d = depth - c
        img = np.pad(img, ((d // 2, d - d // 2), (0, 0), (0, 0)))
    h = img.shape[1]
    if h >= hw:
        d = h - hw
        img = img[:, d // 2:d // 2 + hw, d // 2:d // 2 + hw]
    else:
        d = hw - h
        img = np.pad(img, ((0, 0), (d // 2, d - d // 2),
                           (d // 2, d - d // 2)))
    return img


def tumor_crop_box(img: np.ndarray, mask: np.ndarray,
                   half: int = 50) -> np.ndarray:
    """Zero outside a (2·half)³ box around the mask's centre."""
    box = np.zeros_like(mask)
    coords = np.where(mask == 1)
    if len(coords[0]) == 0:
        center = [s // 2 for s in mask.shape]
    else:
        center = [int((c.max() - c.min()) / 2) for c in coords]
    sl = tuple(slice(max(0, ctr - half), min(s, ctr + half))
               for ctr, s in zip(center, mask.shape))
    box[sl] = 1
    return img * box
