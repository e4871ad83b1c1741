"""Dataset and host-side batch loader (the JAX package's
``data/pipeline.py``).

- ``MultimodalDataset`` assembles one patient's sample from an in-memory
  feature store (``{(kind, hospital, patientid): array}``): the CT volume
  (crop/pad, augmentation, tumour mask), the pathology bag (instance
  dropout), the clinical vector or tokenised prompts, the one-hot label.
  Augmentation draws from a ``RandomState`` per (epoch, index), so samples
  load in any order, on any number of threads, with the same result;
- ``SyntheticCohort`` is the deterministic in-memory cohort that stands in
  for the hospital data; it draws its ``RandomState`` in the JAX package's
  order, so cohorts and batches are the same in both packages;
- ``BatchLoader`` batches, pads each batch's bags to its bucket with a
  validity mask, loads samples on a thread pool (``num_workers``) and
  assembles batches on a background thread (``prefetch``); ``skip_next``
  and ``first_batch`` serve the mid-epoch resume and model set-up.

Loading from files (NIfTI / DICOM / NRRD volumes and masks, ``.npy`` bags,
the decoded-CT and WSI caches) and ``loader_pool="process"`` are not ported
yet and raise, naming ROADMAP.md Queue 1 item 12; whole-slide images
(``pathology_source="wsi"``) are item 7.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config
from . import augment as aug
from .bags import bucket_for, instance_dropout, pad_bag
from .clinical import clinical_prompts, clinical_vector
from .cohort import Records, build_cohort, hospital_split, kfold_split
from .ct_io import FILE_READERS_ITEM, crop_or_pad_volume, tumor_crop_box
from .tokenizer import ClipTokenizer, tokenize

REAL_FILES_ITEM = ("loading samples from files is not ported yet "
                   "(ROADMAP.md, Queue 1 item 12: real-file loading); the "
                   "port reads an in-memory feature store")


class MultimodalDataset:
    """Per-sample assembly over a cohort (records) and a feature store."""

    def __init__(self, cfg: Config, mode: str = "train",
                 records: Optional[Records] = None,
                 feature_store: Optional[Dict] = None):
        self.cfg = cfg
        self.mode = mode
        self.records = list(records) if records is not None \
            else build_cohort(cfg, mode)
        self.feature_store = feature_store or {}
        self._tokenizer = None
        # fixed per-mode offsets, so that identically seeded runs draw the
        # same augmentation streams
        mode_off = {"train": 0, "valid": 1, "test": 2}.get(mode, 3)
        self.base_seed = cfg.seed + mode_off
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _sample_rng(self, idx: int) -> np.random.RandomState:
        return np.random.RandomState(
            (self.base_seed * 1_000_003 + self.epoch * 9_973 + idx)
            % (2 ** 31 - 1))

    def __len__(self) -> int:
        return len(self.records)

    def _stored(self, kind: str, row) -> Optional[np.ndarray]:
        a = self.feature_store.get((kind, row["hospital"], row["patientid"]))
        return None if a is None else np.asarray(a, dtype=np.float32)

    def _load_ct(self, row, rng):
        cfg = self.cfg
        img = self._stored("CT", row)
        if img is None:
            raise NotImplementedError(
                f"{REAL_FILES_ITEM}: no CT volume of {row['patientid']} in "
                f"the store")
        if img.shape != (cfg.ct_shape[0], cfg.ct_hw, cfg.ct_hw):
            img = crop_or_pad_volume(img, cfg.ct_shape[0], cfg.ct_hw)
        mask = None
        if cfg.tumorCrop or "wMask" in cfg.model_CT:
            mask = self._load_tumor_mask(row, img.shape)
        if self.mode == "train" and cfg.augmentation:
            if mask is not None:
                img, mask = aug.augment_ct(img, rng, mask=mask)
            else:
                img = aug.augment_ct(img, rng)
        if cfg.tumorCrop and mask is not None:
            img = tumor_crop_box(img, mask)
        img = img[..., None].astype(np.float32)          # (D, H, W, 1)
        if "wMask" in cfg.model_CT and mask is not None:
            return img, mask[..., None].astype(np.float32)
        return img, None

    def _load_tumor_mask(self, row, shape) -> np.ndarray:
        """The store's mask, or zeros where the patient has none (as the
        JAX package does where no mask file exists)."""
        m = self._stored("mask", row)
        if m is None:
            base = f"{self.cfg.path_data_mask}/CT_{row['patientid']}"
            if any(os.path.exists(base + ext)
                   for ext in (".nrrd", ".npy", ".nii.gz")):
                raise NotImplementedError(f"{FILE_READERS_ITEM}: {base}")
            return np.zeros(shape, np.float32)
        return crop_or_pad_volume(np.clip(m, 0, 1), self.cfg.ct_shape[0],
                                  self.cfg.ct_hw)

    def _load_bag(self, row, rng) -> np.ndarray:
        cfg = self.cfg
        if cfg.pathology_source == "wsi":
            raise NotImplementedError(
                "pathology_source='wsi' is not ported yet (ROADMAP.md, Queue "
                "1 item 7: CLIP vision and WSI)")
        feat = self._stored("pathology", row)
        if feat is None:
            raise NotImplementedError(
                f"{REAL_FILES_ITEM}: no bag of {row['patientid']} in the "
                f"store")
        if self.mode == "train" and cfg.augmentation:
            feat = instance_dropout(feat, row["pathologyimage"], rng)
        return feat

    def _load_ci(self, row) -> np.ndarray:
        cfg = self.cfg
        if cfg.CI_input_version in ("v1", "v2"):
            return clinical_vector(
                dict(row), cfg.CI_input_version, cfg.clinical_features,
                duplicated=cfg.model_CI.endswith("d"))
        prompts = clinical_prompts(
            dict(row), cfg.CI_prompt_version,
            learnable_prompt=bool(cfg.learnablePrompt), n_ctx=cfg.n_ctx)
        if self._tokenizer is None:
            self._tokenizer = ClipTokenizer(cfg.bpe_vocab_path or None,
                                            vocab_size=cfg.clip_vocab)
        # the byte-level fallback emits ~1 token a character, so the
        # 'single' sentence overflows 77: truncate (a real vocab fits)
        return tokenize(prompts,
                        context_length=cfg.clip_context - cfg.prompt_len,
                        tokenizer=self._tokenizer,
                        truncate=not self._tokenizer.bpe_ranks)

    def _label(self, row) -> np.ndarray:
        cfg = self.cfg
        if cfg.label == "5yOS":
            y = int(row["label"])
        elif cfg.label == "BpRs":
            y = 0 if row["pathologyimage"] == "Biopsy" else 1
        elif cfg.label == "Tstage":
            y = int(row["label_T"])
        elif cfg.label == "locationcancer":
            y = int(row["locationcancer"]) - 1
        elif cfg.label == "classification_cancer":
            y = int(row.get("classification cancer",
                            row.get("classification_cancer"))) - 1
        else:
            y = int(row["label"])
        return np.eye(cfg.num_classes, dtype=np.float32)[y]

    def __getitem__(self, idx: int) -> Dict:
        cfg = self.cfg
        row = self.records[idx]
        rng = self._sample_rng(idx)
        sample: Dict = {"ID": row["patientid"], "label": self._label(row)}
        if "CT" in cfg.modality:
            ct, ct_mask = self._load_ct(row, rng)
            sample["input_CT"] = ct
            if ct_mask is not None:
                sample["mask_CT"] = ct_mask
        if "pathology" in cfg.modality:
            sample["input_pathology"] = self._load_bag(row, rng)
            sample["BpRc_class"] = np.array(
                [0.0 if row["pathologyimage"] == "Biopsy" else 1.0],
                dtype=np.float32)
        sample["input_CI"] = self._load_ci(row)
        return sample


class SyntheticCohort:
    """Deterministic synthetic stand-in for the hospital data: a cohort
    table with the reference's schema, in-memory CT volumes and
    label-correlated CTransPath-like bags (the JAX package's, without its
    whole-slide images, ROADMAP.md Queue 1 item 7)."""

    def __init__(self, cfg: Config, n_per_hospital: int = 8,
                 ct_shape=(16, 64, 64), bag_range=(80, 300), seed: int = 0):
        rs = np.random.RandomState(seed)
        rows: Records = []
        store: Dict = {}
        hospitals = ["AJMC", "CNUH", "PNUH", "EUMC", "HUMC", "SCHMC"]
        pid = 0
        for hosp in hospitals:
            for _ in range(n_per_hospital):
                label = int(rs.randint(0, 2))
                patient = f"S{pid:05d}"
                pid += 1
                kind = "Biopsy" if rs.rand() < 0.5 else "Resection"
                rows.append({
                    "patientid": patient, "hospital": hosp,
                    "pathologyimage": kind, "CT_before1": "(1, x, 1)",
                    "CT ID mismatch": 0,
                    "sex": "M" if rs.rand() < 0.5 else "F",
                    "sm": "N" if rs.rand() < 0.5 else "Y",
                    "age": int(rs.randint(40, 85)),
                    "birth date": "1950-01-01",
                    "locationcancer": int(rs.randint(1, 6)),
                    "cancerimaging": int(rs.randint(1, 5)),
                    "cancerimagingT": int(rs.randint(1, 5)),
                    "cancerimagingN": int(rs.randint(0, 4)),
                    "cancerimagingM": int(rs.randint(0, 2)),
                    "classification cancer": int(rs.randint(1, 3)),
                    "label": label, "label_T": 0, "label_TNM": 0,
                })
                n_inst = int(rs.randint(*bag_range))
                bag = rs.randn(n_inst, 768).astype(np.float32) + label * 0.3
                store[("pathology", hosp, patient)] = bag
                vol = rs.rand(*ct_shape).astype(np.float32) * 0.2 \
                    + label * 0.1
                store[("CT", hosp, patient)] = vol
        self.records = rows
        self.store = store

    def dataset(self, cfg: Config, mode: str) -> MultimodalDataset:
        rows = hospital_split(self.records, cfg.hospital_test, mode)
        rows = kfold_split(rows, cfg.kfold_num, cfg.val_fold, mode)
        return MultimodalDataset(cfg, mode, records=rows,
                                 feature_store=self.store)


class BatchLoader:
    """Batched iterator with per-batch bag bucketing, a thread pool for the
    samples and a background thread for the batches."""

    def __init__(self, dataset: MultimodalDataset, batch_size: int,
                 sampler=None, shuffle: bool = False, seed: int = 0,
                 buckets: Sequence[int] | None = None,
                 prefetch: int = 2, drop_last: bool = False,
                 num_workers: int = 0, pool: str = "thread"):
        if pool == "process":
            raise NotImplementedError(
                "loader_pool='process' is not ported yet (ROADMAP.md, Queue "
                "1 item 12: real-file loading); use 'thread'")
        if pool != "thread":
            raise ValueError(f"pool must be 'thread' or 'process', "
                             f"got {pool!r}")
        self.ds = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.buckets = tuple(buckets or dataset.cfg.bag_buckets)
        self.prefetch = prefetch
        self.drop_last = drop_last
        # the dataset draws its randomness per (epoch, index), so a pool of
        # any size gives the same samples
        self.num_workers = num_workers
        self.pool = pool
        self._skip_once = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.ds.set_epoch(epoch)
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def skip_next(self, n_batches: int) -> None:
        """Skip the first ``n_batches`` of the next iteration only: the
        mid-epoch resume hook.  The epoch's order is fixed by ``set_epoch``
        and the samples' randomness by (epoch, index), so the remaining
        batches are those the interrupted epoch would have given."""
        self._skip_once = int(n_batches)

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.ds)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            return np.asarray(list(self.sampler.indices()))
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    @staticmethod
    def _stack(arrs):
        # batch 1: a leading-axis view instead of np.stack's copy (a full
        # CT volume is 168 MB)
        if len(arrs) == 1:
            return arrs[0][None]
        return np.stack(arrs)

    def _collate(self, samples: List[Dict]) -> Dict:
        st = self._stack
        batch: Dict = {"ID": [s["ID"] for s in samples]}
        batch["label"] = st([s["label"] for s in samples])
        if "input_CT" in samples[0]:
            batch["input_CT"] = st([s["input_CT"] for s in samples])
        if "mask_CT" in samples[0]:
            batch["mask_CT"] = st([s["mask_CT"] for s in samples])
        if "input_pathology" in samples[0]:
            longest = max(s["input_pathology"].shape[0] for s in samples)
            target = bucket_for(longest, self.buckets)
            feats, masks = zip(*(pad_bag(s["input_pathology"], target)
                                 for s in samples))
            batch["input_pathology"] = st(list(feats))
            batch["mask_pathology"] = st(list(masks))
            batch["BpRc_class"] = st([s["BpRc_class"] for s in samples])
        batch["input_CI"] = st([s["input_CI"] for s in samples])
        return batch

    def _produce(self) -> Iterator[Dict]:
        idx = self._indices()
        if self.drop_last:
            idx = idx[:len(idx) - len(idx) % self.batch_size]
        if self._skip_once:
            idx = idx[self._skip_once * self.batch_size:]
            self._skip_once = 0               # one-shot: the next is whole
        if self.num_workers <= 1:
            for start in range(0, len(idx), self.batch_size):
                chunk = idx[start:start + self.batch_size]
                yield self._collate([self.ds[int(i)] for i in chunk])
            return
        # a window of per-sample futures across batches, yielded in order:
        # a per-batch map would cap the parallelism at the batch size
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        window = max(self.num_workers * 2, self.batch_size)
        futs: deque = deque()
        with ThreadPoolExecutor(self.num_workers) as pool:
            try:
                pos = 0
                for start in range(0, len(idx), self.batch_size):
                    chunk = idx[start:start + self.batch_size]
                    while pos < len(idx) and len(futs) < len(chunk) + window:
                        futs.append(pool.submit(self.ds.__getitem__,
                                                int(idx[pos])))
                        pos += 1
                    yield self._collate(
                        [futs.popleft().result() for _ in chunk])
            finally:
                for f in futs:          # abandoned mid-epoch
                    f.cancel()

    def first_batch(self) -> Dict:
        """One batch without starting the background thread."""
        return next(self._produce())

    def __iter__(self) -> Iterator[Dict]:
        if self.prefetch <= 0:
            yield from self._produce()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self._produce():
                    if not put(b):
                        return
            except BaseException as e:          # raised to the consumer
                err.append(e)
            put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                yield item
        finally:
            stop.set()
            t.join(timeout=5)
        if err:
            raise err[0]
