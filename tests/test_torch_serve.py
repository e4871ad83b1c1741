"""Export → ``ServingModel`` → ``InferenceServer`` of the PyTorch port, on
``device="cpu"``.

Invariants (those of ``tests/test_serve.py``):
- served probs are byte-identical to ``ServingModel.call`` on the same
  artifact, and equal the module called directly;
- warmup touches every exported signature before the socket opens;
- an unknown signature is a 400 listing the available signatures, a
  malformed body is a 400, an unknown route is a 404, an oversized body a
  413 — the daemon stays up through all of them;
- /healthz and /signatures describe the artifact.
"""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from llmmil_tpu_torch import Config
from llmmil_tpu_torch.eval import export as export_mod
from llmmil_tpu_torch.eval.export import (ServingModel, _entry_key,
                                          export_model, load_artifact,
                                          make_example_batch, save_artifact)
from llmmil_tpu_torch.eval.serve import (InferenceServer, serve_artifact,
                                         warmup_batches)
from llmmil_tpu_torch.models import build_model


def _cfg(**kw):
    return Config(**dict(dict(
        modality=["pathology"], model_pathology="ABMIL", aggregator="ABMIL",
        model_CI="simpleFCs_v1", CI_input_version="v1", loss_point="Last",
        compute_dtype="float32", learnablePrompt=0, twoway_depth=1,
        use_pallas=True, bag_buckets=[16, 32]), **kw))


def _batch(B, N, seed=0):
    rs = np.random.RandomState(seed)
    return {"input_pathology": rs.randn(B, N, 768).astype(np.float32),
            "mask_pathology": np.arange(N)[None].repeat(B, 0)
            < rs.randint(N // 2, N, (B, 1)),
            "input_CI": rs.rand(B, 9).astype(np.float32)}


def _post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.load(r)


@pytest.fixture(scope="module")
def served():
    cfg = _cfg()
    model = build_model(cfg, device="cpu", seed=1)
    blob = export_model(cfg, model.state_dict(),
                        [_batch(1, 16), _batch(1, 32)])
    return model, ServingModel(blob, device="cpu")


def test_serving_model_equals_direct_call(served):
    model, sm = served
    ex = _batch(1, 32, seed=3)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in ex.items()})["probs"]
    np.testing.assert_array_equal(sm.call(ex), want.numpy())
    assert sm.manifest["num_classes"] == 2
    assert sm.manifest["torch_version"] == torch.__version__
    assert Config.from_dict(sm.manifest["config"]) == _cfg()


def test_unknown_signature_keyerror_lists_available(served):
    _, sm = served
    with pytest.raises(KeyError) as err:
        sm.call(_batch(2, 24))
    msg = str(err.value)
    assert "no exported entry for signature" in msg and "available" in msg
    for key in sm.signatures:
        assert key in msg.replace("\\n", "\n")


def test_entry_key_matches_jax_package_format():
    from llmmil_tpu.eval.export import _entry_key as jax_entry_key
    ex = _batch(2, 16)
    assert _entry_key(ex) == jax_entry_key(ex)


def test_warmup_covers_every_signature(served):
    _, sm = served
    warm = dict(warmup_batches(sm))
    assert set(warm) == set(sm.signatures)
    for key, b in warm.items():
        assert _entry_key(b) == key


def test_serve_predict_matches_direct_call(served):
    _, sm = served
    ex16, ex32 = _batch(1, 16), _batch(1, 32)
    with InferenceServer(sm) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.load(r)
            assert r.status == 200 and health["status"] == "ok"
        assert sorted(health["signatures"]) == sorted(sm.signatures)
        with urllib.request.urlopen(f"{base}/signatures", timeout=30) as r:
            assert json.load(r) == sm.signatures

        for ex in (ex16, ex32, _batch(1, 32, seed=3)):
            code, out = _post(f"{base}/predict", ex)
            assert code == 200
            np.testing.assert_array_equal(
                np.asarray(out["probs"], np.float32), sm.call(ex))
            assert out["device_ms"] >= 0

        # unknown signature -> 400 listing what's available
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/predict", _batch(2, 24))
        assert err.value.code == 400
        assert "available" in json.load(err.value)["error"]

        # malformed body -> 400; unknown route -> 404; server stays up
        req = urllib.request.Request(f"{base}/predict", data=b"not an npz")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert err.value.code == 404

        # oversized Content-Length -> 413 before the body is read
        req = urllib.request.Request(
            f"{base}/predict", data=b"x",
            headers={"Content-Length": str(srv._max_body + 1)})
        try:
            urllib.request.urlopen(req, timeout=30)
            raise AssertionError("oversized body not rejected")
        except urllib.error.HTTPError as e:
            assert e.code == 413
            assert "cap" in json.load(e)["error"]
        except urllib.error.URLError:
            pass  # server may drop the connection on the length mismatch

        code, out = _post(f"{base}/predict", ex16)   # still serving
        assert code == 200
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] >= 5 and stats["errors"] == 2


def test_non_finite_probs_are_a_400(served):
    _, sm = served
    ex = _batch(1, 16)
    ex["input_CI"][:] = np.nan
    with InferenceServer(sm, warmup=False) as srv:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"http://127.0.0.1:{srv.port}/predict", ex)
        assert err.value.code == 400
        assert "non-finite" in json.load(err.value)["error"]


def test_artifact_file_round_trip_and_cli(tmp_path, served):
    _, sm = served
    path = str(tmp_path / "model.llmmil")
    out = export_mod.main([
        "--out", path, "--device", "cpu", "--modality", "['pathology']",
        "--model_pathology", "ABMIL", "--aggregator", "ABMIL",
        "--loss_point", "Last", "--compute_dtype", "float32",
        "--learnablePrompt", "0", "--twoway_depth", "1", "--use_pallas",
        "true", "--export_batch", "2", "--export_bags", "[16]", "--seed",
        "7"])
    assert out == path
    loaded = load_artifact(path, device="cpu")
    assert list(loaded.signatures) == [_entry_key(_batch(2, 16))]
    probs = loaded.call(_batch(2, 16))
    assert probs.shape == (2, 2) and np.isfinite(probs).all()
    # the same seed builds the same weights
    again = build_model(Config.from_dict(loaded.manifest["config"]),
                        device="cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, loaded.model.state_dict()[k]), k
    srv = serve_artifact(path, port=0, device="cpu")
    try:
        code, got = _post(f"http://127.0.0.1:{srv.port}/predict",
                          _batch(2, 16))
        assert code == 200
        np.testing.assert_array_equal(np.asarray(got["probs"], np.float32),
                                      probs)
    finally:
        srv.stop()
    save_artifact(path, b"junk")
    with pytest.raises(Exception):
        load_artifact(path, device="cpu")


def test_export_refuses_a_state_dict_of_another_config():
    model = build_model(_cfg(), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        export_model(_cfg(aggregator="ABMIL_v2"), model.state_dict(),
                     [_batch(1, 16)])


@pytest.mark.parametrize("kw,keys", [
    (dict(), {"input_pathology": ((3, 16, 768), "float32"),
              "mask_pathology": ((3, 16), "bool"),
              "input_CI": ((3, 9), "float32")}),
    (dict(model_CI="CLIP", CI_input_version="text",
          CI_prompt_version="devided"),
     {"input_CI": ((3, 10, 77), "int32")}),
    (dict(model_CI="CLIP", CI_input_version="text"),
     {"input_CI": ((3, 1, 77), "int32")}),
    (dict(model_pathology="ABMIL_v2"),
     {"BpRc_class": ((3, 1), "float32")}),
    (dict(CI_input_version="v2"), {"input_CI": ((3, 27), "float32")}),
    (dict(CI_input_version="v1d"), {"input_CI": ((3, 9 * 57), "float32")}),
    (dict(modality=[]), {"input_CI": ((3, 9), "float32")}),
])
def test_make_example_batch_matches_jax_package(kw, keys):
    from llmmil_tpu.config import Config as JConfig
    from llmmil_tpu.eval.export import make_example_batch as jax_example
    cfg = _cfg(**kw)
    got = make_example_batch(cfg, 3, bag=16)
    want = jax_example(JConfig(**cfg.to_dict()), 3, bag=16)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape and str(v.dtype) == str(want[k].dtype)
        np.testing.assert_array_equal(v, np.asarray(want[k]))
    for k, (shape, dtype) in keys.items():
        assert got[k].shape == shape and str(got[k].dtype) == dtype


# ------------------------------------------------------------- the CT path --

def _ct_cfg(**kw):
    """Tri-modal flagship at a tiny size: 32 x 32 slices, one block a stage,
    a one-layer CLIP text tower."""
    return Config(**dict(dict(
        modality=["CT", "pathology"], model_CT="resnetMC3_18",
        model_pathology="ABMIL", aggregator="ABMIL", model_CI="CLIP",
        CI_input_version="text", CI_prompt_version="devided",
        loss_point="CT-Pth-Last", compute_dtype="float32", n_ctx=4,
        spacing=[2.0, 2.0, 2.5], ct_hw_override=32, ct_layers=[1, 1, 1, 1],
        ct_conv_backend="pallas", use_pallas=True, twoway_depth=1,
        clip_vocab=128, clip_context=16, clip_width=32, clip_heads=4,
        clip_layers=1, clip_embed=32, bag_buckets=[16]), **kw))


def _ct_request(cfg, depth=8, seed=0):
    rs = np.random.RandomState(seed)
    ex = make_example_batch(cfg, 1, bag=16, ct_depth=depth)
    ex["input_CT"] = rs.rand(*ex["input_CT"].shape).astype(np.float32)
    if "input_pathology" in ex:
        ex["input_pathology"] = rs.randn(1, 16, 768).astype(np.float32)
        ex["mask_pathology"] = np.arange(16)[None] < 11
    toks = rs.randint(1, 126, ex["input_CI"].shape).astype(np.int32)
    toks[..., -1] = 127
    ex["input_CI"] = toks
    return ex


def test_served_ct_artifact_answers_over_http():
    cfg = _ct_cfg()
    model = build_model(cfg, device="cpu", seed=2)
    blob = export_model(cfg, model.state_dict(),
                        [make_example_batch(cfg, 1, bag=16, ct_depth=8)])
    sm = ServingModel(blob, device="cpu")
    assert sm.manifest["ct_feature_dim"] is None
    assert any("input_CT:1x8x32x32x1:float32" in k for k in sm.signatures)
    ex = _ct_request(cfg)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v).long() if v.dtype == np.int32
                      else torch.from_numpy(v) for k, v in ex.items()})
    np.testing.assert_array_equal(sm.call(ex), want["probs"].numpy())
    with InferenceServer(sm) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        assert srv._max_body >= 4 * ex["input_CT"].nbytes
        for seed in (0, 1):
            req = _ct_request(cfg, seed=seed)
            code, out = _post(f"{base}/predict", req)
            assert code == 200 and out["device_ms"] >= 0
            np.testing.assert_array_equal(
                np.asarray(out["probs"], np.float32), sm.call(req))
        with pytest.raises(urllib.error.HTTPError) as err:   # another depth
            _post(f"{base}/predict", _ct_request(cfg, depth=4))
        assert err.value.code == 400
        assert "available" in json.load(err.value)["error"]


def test_export_cli_with_a_ct_configuration(tmp_path):
    path = str(tmp_path / "ct.llmmil")
    export_mod.main([
        "--out", path, "--device", "cpu", "--modality", "['CT']",
        "--model_CT", "resnetMC3_18_wMask", "--wmask_family", "twoway",
        "--aggregator", "ABMIL", "--compute_dtype", "float32",
        "--spacing", "[2.0, 2.0, 2.5]", "--ct_hw_override", "16",
        "--ct_layers", "[1,1,1,1]", "--ct_temporal_mode", "dshift",
        "--ct_conv_backend", "pallas", "--twoway_depth", "1",
        "--learnablePrompt", "0", "--export_ct_depth", "4", "--seed", "3"])
    loaded = load_artifact(path, device="cpu")
    (key,) = loaded.signatures
    assert "input_CT:1x4x16x16x1:float32" in key \
        and "mask_CT:1x4x16x16x1:float32" in key
    cfg = Config.from_dict(loaded.manifest["config"])
    assert cfg.ct_temporal_mode == "dshift" and cfg.ct_conv_backend == "pallas"
    ex = make_example_batch(cfg, 1, ct_depth=4)
    ex["input_CT"] += 0.5
    probs = loaded.call(ex)
    assert probs.shape == (1, 2) and np.isfinite(probs).all()


def test_artifact_of_a_model_for_precomputed_ct_features():
    """No trunk in the state_dict: the artifact records the feature width
    and ``ServingModel`` rebuilds the same module."""
    cfg = _ct_cfg(modality=["CT"], loss_point="Last")
    model = build_model(cfg, device="cpu", ct_feature_dim=48)
    ex = _ct_request(cfg)
    del ex["input_CT"]
    ex["ct_features"] = np.random.RandomState(1).randn(1, 5, 48).astype(
        np.float32)
    sm = ServingModel(export_model(cfg, model.state_dict(), [ex]),
                      device="cpu")
    assert sm.manifest["ct_feature_dim"] == 48
    assert set(sm.model.state_dict()) == set(model.state_dict())
    assert np.isfinite(sm.call(ex)).all()


@pytest.mark.parametrize("kw,keys", [
    (dict(), {"input_CT": (2, 3, 512, 512, 1),
              "input_pathology": (2, 16, 768)}),
    (dict(modality=["CT"], spacing=[2.0, 2.0, 2.5]),
     {"input_CT": (2, 3, 224, 224, 1)}),
    (dict(modality=["CT"], model_CT="resnetMC3_18_wMask"),
     {"input_CT": (2, 3, 512, 512, 1), "mask_CT": (2, 3, 512, 512, 1)}),
])
def test_make_example_batch_with_ct_matches_jax_package(kw, keys):
    from llmmil_tpu.config import Config as JConfig
    from llmmil_tpu.eval.export import make_example_batch as jax_example
    cfg = _ct_cfg(**dict(dict(ct_hw_override=0, spacing=[0.6869, 0.6869, 3.0]),
                         **kw))
    got = make_example_batch(cfg, 2, bag=16, ct_depth=3)
    want = jax_example(JConfig(**cfg.to_dict()), 2, bag=16, ct_depth=3)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == want[k].shape and str(v.dtype) == str(want[k].dtype)
        np.testing.assert_array_equal(v, np.asarray(want[k]))
    for k, shape in keys.items():
        assert got[k].shape == shape and got[k].dtype == np.float32
    assert make_example_batch(cfg, 1, bag=16)["input_CT"].shape[1] == 160
