"""The data layer of the PyTorch port against the JAX package's: the
synthetic cohort, the dataset with augmentation and instance dropout, the
loader with bucket padding and the epoch sampler give bit-identical batches;
the tokenizer (stdlib ``re`` here, the ``regex`` package there) gives the
same ids; the splits and the survival labels select the same patients; the
prefetch keeps every batch and its host-side label."""

import numpy as np
import pandas as pd
import pytest
import torch

from llmmil_tpu.config import Config as JConfig
from llmmil_tpu.data import BatchLoader as JBatchLoader
from llmmil_tpu.data import SyntheticCohort as JSyntheticCohort
from llmmil_tpu.data import bags as jbags
from llmmil_tpu.data import cohort as jcohort
from llmmil_tpu.data import ct_io as jct_io
from llmmil_tpu.data import tokenizer as jtok
from llmmil_tpu.parallel.sampler import ShardedEpochSampler as JSampler
from llmmil_tpu_torch import Config
from llmmil_tpu_torch.data import BatchLoader, SyntheticCohort, bags
from llmmil_tpu_torch.data import cohort, ct_io, tokenizer
from llmmil_tpu_torch.parallel import ShardedEpochSampler, prefetch_to_device

KW = dict(modality=["CT", "pathology"], model_CI="CLIP",
          CI_input_version="text", CI_prompt_version="devided", n_ctx=4,
          clip_vocab=128, clip_context=24, spacing=[2.0, 2.0, 2.5],
          ct_hw_override=16, ct_shape=[6, 16, 16], bag_buckets=[64, 128],
          augmentation=1, seed=11)


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    assert list(got["ID"]) == list(want["ID"])
    for k in want:
        if k != "ID":
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(), dict(CI_prompt_version="single", learnablePrompt=0),
    dict(modality=["pathology"], model_CI="simpleFCs_v1",
         CI_input_version="v2"),
    dict(model_CT="resnetMC3_18_wMask", tumorCrop=1, label="BpRs")])
def test_synthetic_batches_are_bit_identical(kw):
    """Two epochs of shuffled, augmented, bucket-padded training batches
    and one of validation batches, on a thread pool."""
    cfg, jcfg = Config(**dict(KW, **kw)), JConfig(**dict(KW, **kw))
    syn = SyntheticCohort(cfg, n_per_hospital=3, ct_shape=(5, 18, 14),
                          bag_range=(40, 120), seed=4)
    jsyn = JSyntheticCohort(jcfg, n_per_hospital=3, ct_shape=(5, 18, 14),
                            bag_range=(40, 120), seed=4)
    assert syn.records == jsyn.df.to_dict("records")
    assert syn.store.keys() == jsyn.store.keys()
    for mode in ("train", "valid"):
        ds, jds = syn.dataset(cfg, mode), jsyn.dataset(jcfg, mode)
        smp = ShardedEpochSampler(len(ds), seed=3)
        jsmp = JSampler(len(jds), num_shards=1, shard_id=0, seed=3)
        loader = BatchLoader(ds, 2, sampler=smp, num_workers=2, prefetch=1)
        jloader = JBatchLoader(jds, 2, sampler=jsmp, num_workers=2,
                               prefetch=1)
        assert len(loader) == len(jloader)
        for epoch in (0, 1) if mode == "train" else (0,):
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
            got, want = list(loader), list(jloader)
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)


def test_skip_next_and_first_batch_follow_the_jax_loader():
    cfg, jcfg = Config(**KW), JConfig(**KW)
    syn = SyntheticCohort(cfg, n_per_hospital=3, bag_range=(40, 120), seed=2)
    jsyn = JSyntheticCohort(jcfg, n_per_hospital=3, bag_range=(40, 120),
                            seed=2)
    loader = BatchLoader(syn.dataset(cfg, "train"), 2, shuffle=True,
                         prefetch=0, drop_last=True)
    jloader = JBatchLoader(jsyn.dataset(jcfg, "train"), 2, shuffle=True,
                           prefetch=0, drop_last=True)
    for lo in (loader, jloader):
        lo.set_epoch(3)
        lo.skip_next(2)
    _assert_batches_equal(loader.first_batch(), jloader.first_batch())
    assert len(list(loader)) == len(loader)            # skip is one-shot


@pytest.mark.parametrize("n,shards,drop", [(13, 1, False), (13, 3, False),
                                           (13, 4, True), (2, 3, False)])
def test_sampler_matches_jax(n, shards, drop):
    for shard in range(shards):
        s = ShardedEpochSampler(n, shards, shard, seed=5, drop_last=drop)
        j = JSampler(n, shards, shard, seed=5, drop_last=drop)
        for epoch in (0, 7):
            s.set_epoch(epoch)
            j.set_epoch(epoch)
            np.testing.assert_array_equal(s.indices(), j.indices())
            assert len(s) == len(j)


@pytest.mark.parametrize("texts", [
    ["X X X X a photo of 63 years old.", "a photo of T stage 2.",
     "X X a photo of left inferior lobe."],
    ["71 years old female smoker lung cancer patient, stage 3, T2N1M0, "
     "location right superior lobe, type squamous cell carcinoma."],
    ["It's the patient's CT; they've 2 nodules (3.5cm & 12mm)!"]])
@pytest.mark.parametrize("vocab", [None, 128, 49408])
def test_tokenizer_ids_match_jax(texts, vocab):
    """The port splits words with ``re`` on ASCII classes, the JAX package
    here with the ``regex`` package's Unicode classes: the same ids on
    ASCII text (byte-level fallback vocabulary)."""
    tok = tokenizer.ClipTokenizer(None, vocab_size=vocab)
    jt = jtok.ClipTokenizer(None, vocab_size=vocab)
    assert jtok.re.__name__ == "regex"
    for text in texts:
        assert tok.encode(text) == jt.encode(text)
    np.testing.assert_array_equal(
        tokenizer.tokenize(texts, 77, tok, truncate=True),
        jtok.tokenize(texts, 77, jt, truncate=True))


def test_tokenizer_with_a_bpe_vocabulary_matches_jax(tmp_path):
    """A small merges file: the BPE branch gives the same ids."""
    import gzip
    merges = ["#version", "p h", "o t", "ph ot", "pho t", "a </w>",
              "ca n", "can c", "canc er</w>", "t h", "th e</w>"]
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(merges))
    text = "a photo of the cancer patient, stage 3."
    got = tokenizer.ClipTokenizer(str(path)).encode(text)
    want = jtok.ClipTokenizer(str(path)).encode(text)
    assert got == want and len(got) < len(text)


@pytest.mark.parametrize("n,k", [(9, 4), (13, 4), (4, 4), (30, 5)])
def test_kfold_and_hospital_splits_match_jax(n, k):
    rows = [{"patientid": f"P{i}", "hospital": jcohort.ALL_HOSPITALS[i % 6]}
            for i in range(n)]
    df = pd.DataFrame(rows)
    for mode in ("train", "valid", "test"):
        for fold in range(k):
            got = cohort.kfold_split(rows, k, fold, mode)
            want = jcohort.kfold_split(df, k, fold, mode)
            assert [r["patientid"] for r in got] == list(want["patientid"])
        got = cohort.hospital_split(rows, ["EUMC", "HUMC"], mode)
        want = jcohort.hospital_split(df, ["EUMC", "HUMC"], mode)
        assert [r["patientid"] for r in got] == list(want["patientid"])


def test_cohort_from_a_csv_table_matches_jax(tmp_path):
    """Survival labels, validity filters, excluded IDs, stage filter and
    the splits, from one same-schema csv."""
    rs = np.random.RandomState(0)
    rows = []
    for i in range(80):
        treated = pd.Timestamp("2010-01-01") + pd.Timedelta(
            days=int(rs.randint(0, 800)))
        last = treated + pd.Timedelta(days=int(rs.randint(-30, 3000)))
        rows.append({
            "patientid": "A10065" if i == 3 else f"P{i:03d}",
            "hospital": jcohort.ALL_HOSPITALS[rs.randint(0, 6)],
            "CT_before1": "" if i == 5 else "(1, x, 1)",
            "CT ID mismatch": int(i == 7),
            "pathologyimage": ["Biopsy", "Resection", "none"][i % 3],
            "treatedate": treated.strftime("%Y-%m-%d"),
            "lastdate": last.strftime("%Y-%m-%d"),
            "dead": int(rs.randint(0, 2)), "deathsign": int(rs.randint(0, 3)),
            "relapse": int(rs.randint(0, 2)),
            "classification cancer": int(rs.randint(1, 4)),
            "cancerimaging": ["1a", "2", "3b", "4", "5"][rs.randint(0, 5)],
            "cancerimagingT": ["1", "2b", "3", "4a"][rs.randint(0, 4)],
            "cancerimagingN": int(rs.randint(0, 4)),
            "cancerimagingM": ["0", "1a", "1"][rs.randint(0, 3)],
            "sex": "MF"[rs.randint(0, 2)], "sm": "NY"[rs.randint(0, 2)],
            "locationcancer": int(rs.randint(1, 7)), "age": 60})
    pd.DataFrame(rows).to_csv(tmp_path / "Lung_Overall2.csv", index=False)
    for kw in (dict(), dict(survival_type="RFS", cancerstageTrain="12"),
               dict(hospital_test=["AJMC"], val_fold=2, year=3)):
        cfg = Config(path_data_excel=str(tmp_path), **kw)
        jcfg = JConfig(path_data_excel=str(tmp_path), **kw)
        for mode in ("train", "valid", "test"):
            got = cohort.build_cohort(cfg, mode)
            want = jcohort.build_cohort(jcfg, mode)
            assert [r["patientid"] for r in got] \
                == list(want["patientid"]), (kw, mode)
            assert [r["label"] for r in got] == list(want["label"])
            assert [r["label_T"] for r in got] == list(want["label_T"])


@pytest.mark.parametrize("kind", ["Biopsy", "Resection"])
def test_instance_dropout_matches_jax(kind):
    feat = np.random.RandomState(0).randn(57, 6).astype(np.float32)
    got = bags.instance_dropout(feat, kind, np.random.RandomState(3))
    want = jbags.instance_dropout(feat, kind, np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)


def test_ct_array_functions_match_jax():
    rs = np.random.RandomState(1)
    img = rs.randint(-2000, 2000, (7, 21, 21)).astype(np.float32)
    meta = {"RescaleSlope": 1.5, "RescaleIntercept": -10,
            "PhotometricInterpretation": "MONOCHROME1", "BitsStored": 12}
    np.testing.assert_array_equal(ct_io.hu_normalize(img, meta),
                                  jct_io.hu_normalize(img, meta))
    for d, hw in ((5, 16), (9, 24)):
        np.testing.assert_array_equal(ct_io.crop_or_pad_volume(img, d, hw),
                                      jct_io.crop_or_pad_volume(img, d, hw))
    mask = (rs.rand(7, 21, 21) > 0.95).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        np.testing.assert_array_equal(ct_io.tumor_crop_box(img, m, 4),
                                      jct_io.tumor_crop_box(img, m, 4))


@pytest.mark.parametrize("call", [
    lambda: ct_io.read_nifti("x.nii.gz"),
    lambda: ct_io.load_ct_metadata("x.json"),
    lambda: BatchLoader(SyntheticCohort(Config(**KW), 2).dataset(
        Config(**KW), "train"), 2, pool="process")])
def test_file_readers_and_process_pool_name_their_item(call):
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        call()


def test_prefetch_keeps_batches_and_host_labels():
    cfg = Config(**KW)
    ds = SyntheticCohort(cfg, n_per_hospital=2, bag_range=(40, 80),
                         seed=7).dataset(cfg, "train")
    direct = list(BatchLoader(ds, 2, prefetch=0))
    fetched = list(prefetch_to_device(BatchLoader(ds, 2, prefetch=0), 2,
                                      "cpu"))
    assert len(fetched) == len(direct)
    for want, got in zip(direct, fetched):
        np.testing.assert_array_equal(got.pop("_host_label"), want["label"])
        assert got["ID"] == want["ID"]
        for k in want:
            if k != "ID":
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(got[k].numpy(), want[k])
