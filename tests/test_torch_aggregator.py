"""The slices as a whole: ``build_model`` of the PyTorch port against the JAX
package's for the pathology + clinical-information flagship (simpleFCs and a
tiny CLIP text tower), the tri-modal and CT-only flagship with the MC3-18
trunk, and the concat baseline.  Weights are drawn with numpy
in the shape of flax's variables, ``from_flax`` carries them across, the same
numpy batch goes through both, fp32, inference mode; rtol 1e-4 / atol 1e-5 on
probabilities, embeddings and attention (a two-block transformer deep; only
summation order differs).  The kernel route (``use_pallas=True``) runs on both sides through
the kernel's plain version: the JAX package gates its Pallas kernel off on
the CPU, the port's wrapper takes the plain version for a CPU tensor."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu.config import Config as JConfig
from llmmil_tpu.models import build_model as jax_build_model
from llmmil_tpu_torch import Config
from llmmil_tpu_torch.models import build_model
from llmmil_tpu_torch.models.migrate import from_flax
from llmmil_tpu_torch.ops.kernels import mil_pool

from _torch_port_util import (ct_variables, load, n, numpy_variables,
                              ragged_mask, t, to_numpy_tree)

RTOL, ATOL = 1e-4, 1e-5
TINY_CLIP = dict(clip_vocab=64, clip_context=16, clip_width=32, clip_heads=4,
                 clip_layers=1, clip_embed=16)
BASE = dict(modality=["pathology"], model_pathology="ABMIL",
            aggregator="ABMIL", model_CI="simpleFCs_v1",
            CI_input_version="v1", loss_point="Last",
            compute_dtype="float32", learnablePrompt=0, twoway_depth=1,
            bag_buckets=[16, 32])
CLIP = dict(model_CI="CLIP", CI_input_version="text",
            CI_prompt_version="devided", learnablePrompt=1, n_ctx=3,
            **TINY_CLIP)


def _batch(cfg, b=2, n_rows=24, seed=0, mask=True):
    rs = np.random.RandomState(seed)
    out = {"input_pathology": rs.randn(b, n_rows, 768).astype(np.float32)}
    if mask:
        out["mask_pathology"] = ragged_mask(rs, b, n_rows)
    if cfg.model_CI == "CLIP":
        toks = rs.randint(1, 60, (b, cfg.n_clinical + 1, 16)).astype(np.int32)
        toks[..., 0] = 1
        np.put_along_axis(toks, rs.randint(8, 16, toks.shape[:2])[..., None],
                          63, axis=-1)
        out["input_CI"] = toks
    else:
        out["input_CI"] = rs.rand(b, cfg.ci_input_dim).astype(np.float32)
    return out


def _pair(kw, batch_kw=None):
    """(torch model, torch out, jax out, batch) for one configuration."""
    cfg, jcfg = Config(**kw), JConfig(**kw)
    batch = _batch(cfg, **(batch_kw or {}))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(jcfg)
    variables = numpy_variables(jmodel, jbatch)
    want = jmodel.apply(variables, jbatch, train=False, return_attn=True)
    model = load(build_model(cfg, device="cpu"),
                 from_flax(to_numpy_tree(variables), cfg))
    tbatch = {k: t(v).long() if v.dtype == np.int32 else t(v)
              for k, v in batch.items()}
    with torch.no_grad():
        got = model(tbatch, return_attn=True)
    return model, got, want, tbatch


def _close(got, want):
    np.testing.assert_allclose(n(got), n(want), rtol=RTOL, atol=ATOL)


CASES = {
    "simplefcs": dict(BASE),
    "simplefcs_kernel": dict(BASE, use_pallas=True),
    "simplefcs_depth2": dict(BASE, twoway_depth=0),
    "clip": dict(BASE, **CLIP),
    "clip_kernel": dict(BASE, use_pallas=True, **CLIP),
    "clip_frozen_prompt": dict(BASE, **dict(CLIP, learnablePrompt=0)),
    "abmil_v2": dict(BASE, aggregator="ABMIL_v2"),
    "mean_pool": dict(BASE, aggregator="-"),
    "pathology_is_query": dict(BASE, alignment_base="pathology"),
    "softmax_head": dict(BASE, activationF="softmax"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flagship_matches_jax(case):
    _, got, want, _ = _pair(CASES[case])
    assert got["probs"].shape == (2, 2)
    _close(got["probs"], want["probs"])
    _close(got["emb_Pth2CI"], want["emb_Pth2CI"])
    assert len(got["attns"]) == len(want["attns"])
    for a, b in zip(got["attns"], want["attns"]):
        _close(a, b)
    assert got.get("pth_token_span") == want.get("pth_token_span")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_flagship_without_mask(use_pallas):
    """No ``mask_pathology``: the JAX model pools unmasked; the port's
    kernel route gives the kernel an all-true mask, the same numbers."""
    _, got, want, _ = _pair(dict(BASE, use_pallas=use_pallas),
                            {"mask": False})
    _close(got["probs"], want["probs"])
    _close(got["attns"][0], want["attns"][0])


def test_ci_only_matches_jax():
    kw = dict(BASE, modality=[])
    cfg, jcfg = Config(**kw), JConfig(**kw)
    ci = np.random.RandomState(1).rand(3, 9).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    variables = numpy_variables(jmodel, {"input_CI": jnp.asarray(ci)})
    want = jmodel.apply(variables, {"input_CI": jnp.asarray(ci)})
    model = load(build_model(cfg, device="cpu"),
                 from_flax(to_numpy_tree(variables), cfg))
    with torch.no_grad():
        got = model({"input_CI": t(ci)})
    _close(got["probs"], want["probs"])
    assert "emb_Pth2CI" not in got


@pytest.mark.parametrize("use_pallas,with_ci", [("auto", False),
                                                (False, False),
                                                ("auto", True)])
def test_concat_baseline_matches_jax(use_pallas, with_ci):
    kw = dict(BASE, model_family="concat", use_pallas=use_pallas,
              modality=["pathology", "CI"] if with_ci else ["pathology"])
    cfg, jcfg = Config(**kw), JConfig(**kw)
    batch = _batch(cfg)
    if not with_ci:
        del batch["input_CI"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch.setdefault("input_CI", None)
    jmodel = jax_build_model(jcfg)
    variables = numpy_variables(jmodel, jbatch)
    want = jmodel.apply(variables, jbatch)
    model = load(build_model(cfg, device="cpu"),
                 from_flax(to_numpy_tree(variables), cfg))
    assert model.extractor_pathology.use_kernel is (use_pallas == "auto")
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})
    _close(got["probs"], want["probs"])


def test_concat_baseline_refuses_a_batch_it_was_not_built_for():
    cfg = Config(**dict(BASE, model_family="concat"))
    model = build_model(cfg, device="cpu")
    batch = {k: t(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="without 'CI'"):
        model(batch)


@pytest.mark.parametrize("case", ["simplefcs_kernel", "clip", "abmil_v2"])
@pytest.mark.parametrize("garbage", [1e3, float("nan")])
def test_mask_leak_probe(case, garbage):
    """Garbage in masked bag rows leaves ``probs`` bit-identical."""
    cfg = Config(**CASES[case])
    model = build_model(cfg, device="cpu")
    batch = {k: t(v).long() if v.dtype == np.int32 else t(v)
             for k, v in _batch(cfg).items()}
    with torch.no_grad():
        clean = model(batch)["probs"]
        dirty_bag = batch["input_pathology"].clone()
        dirty_bag[~batch["mask_pathology"]] = garbage
        dirty = model(dict(batch, input_pathology=dirty_bag))["probs"]
    assert torch.isfinite(clean).all()
    assert torch.equal(clean, dirty)


def test_state_dict_has_reference_key_names():
    model = build_model(Config(**CASES["clip"]), device="cpu")
    keys = set(model.state_dict())
    for k in ("fc_pathology.0.weight", "fc_CI2Pth.0.bias", "fc.1.weight",
              "TwoWayTransformer_Pth.layers.0.self_attn.q_proj.weight",
              "TwoWayTransformer_Pth.final_attn_token_to_image.out_proj.bias",
              "TwoWayTransformer_Pth.norm_final_attn.weight",
              "aggregator.attention_V.0.weight",
              "aggregator.attention_weights.bias",
              "clinic_extractor.ctx",
              "clinic_extractor.model.token_embedding.weight",
              "clinic_extractor.model.transformer.resblocks.0.attn."
              "in_proj_weight",
              "clinic_extractor.model.transformer.resblocks.0.mlp.c_fc.bias"):
        assert k in keys, k


def test_bf16_compute_runs_and_stays_close_to_fp32():
    """bf16 compute path on the CPU: finite, bf16 probs, near the fp32
    result (bf16 keeps ~3 significant digits through the transformer)."""
    kw = dict(BASE, use_pallas=True)
    m32 = build_model(Config(**kw), device="cpu", seed=5)
    m16 = build_model(Config(**dict(kw, compute_dtype="bfloat16")),
                      device="cpu", seed=5)
    batch = {k: t(v) for k, v in _batch(Config(**kw)).items()}
    with torch.no_grad():
        p32, p16 = m32(batch)["probs"], m16(batch)["probs"]
    assert p16.dtype == torch.bfloat16 and torch.isfinite(p16).all()
    np.testing.assert_allclose(n(p16.float()), n(p32), atol=3e-2)


def test_cpu_forward_launches_no_kernel():
    before = mil_pool.launches
    cfg = Config(**CASES["simplefcs_kernel"])
    build_model(cfg, device="cpu")({k: t(v) for k, v in _batch(cfg).items()})
    assert mil_pool.launches == before


@pytest.mark.parametrize("kw,match", [
    (dict(alignment_base="nope"), "unknown alignment_base 'nope'"),
    (dict(alignment_base="CT"), "alignment_base='CT' without CT modality"),
    (dict(modality=[], alignment_base="pathology"),
     "alignment_base='pathology' without pathology"),
    (dict(modality=["CT", "pathology"], model_CT="nope"),
     "unknown model_CT 'nope'"),
    (dict(model_CI="nope"), "unknown model_CI nope"),
    (dict(aggregator="nope"), "unknown aggregator nope"),
    (dict(compute_dtype="float8"), "unknown compute_dtype"),
])
def test_bad_config_raises_value_error(kw, match):
    with pytest.raises(ValueError, match=match):
        build_model(Config(**dict(BASE, **kw)), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(alignment_base="nope"), dict(alignment_base="CT"),
    dict(modality=[], alignment_base="pathology")])
def test_bad_alignment_base_raises_the_jax_message(kw):
    """Same ValueError text as the JAX package (it raises inside init)."""
    jmodel = jax_build_model(JConfig(**dict(BASE, **kw)))
    batch = _batch(Config(**BASE))
    with pytest.raises(ValueError) as jerr:
        numpy_variables(jmodel,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError) as terr:
        build_model(Config(**dict(BASE, **kw)), device="cpu")
    assert str(terr.value) in str(jerr.value)


@pytest.mark.parametrize("kw", [
    dict(modality=["CT", "pathology"], model_CT="medicalNet"),
    dict(modality=["CT"], model_CT="resnet2plus1d_18"),
    dict(modality=["CT"], model_CT="SwinUNETR"),
    dict(modality=["CT"], model_CT="MViT"),
    dict(modality=["CT"], ct_shard_axis="depth"),
    dict(modality=["CT", "pathology"], aggregator="TransMIL",
         moe_experts=4),
    dict(aggregator="TransMIL", moe_experts=4),
    dict(modality=["CT", "pathology"], aggregator="TransMIL_per_modality"),
    dict(aggregator="TransMIL_per_modality"),
    dict(model_family="clip"),
    dict(model_family="clip", modality=["CT", "pathology"]),
    dict(modality=["CT", "pathology"], model_CT="resnetMC3_18_wMask"),
])
def test_unported_branch_raises_not_implemented(kw):
    """The TransMIL aggregators themselves are ported (their parity tests
    are in tests/test_torch_transmil.py); a routed-FFN TransMIL and
    ``TransMIL_per_modality`` are not."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(Config(**dict(BASE, **kw)), device="cpu")


def test_wmask_concat_without_ct_raises_as_the_jax_package_dispatches():
    """The JAX ``build_model`` takes ``AggregatorWMask`` whenever
    ``'wMask' in model_CT`` under ``wmask_family='concat'``, whatever the
    modality; the port has not ported it, so it raises there too rather
    than build another model."""
    kw = dict(BASE, model_CT="resnetMC3_18_wMask", wmask_family="concat")
    assert type(jax_build_model(JConfig(**kw))).__name__ == "AggregatorWMask"
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        build_model(Config(**kw), device="cpu")


def test_wmask_twoway_without_ct_still_builds():
    kw = dict(BASE, model_CT="resnetMC3_18_wMask", wmask_family="twoway")
    assert type(jax_build_model(JConfig(**kw))).__name__ == "Aggregator"
    model = build_model(Config(**kw), device="cpu")
    assert type(model).__name__ == "Aggregator"


# ------------------------------------------------------------- the CT path --
# The tiny tri-modal batch of tests/test_golden.py (two 8 x 32 x 32 volumes,
# bags of 48 rows with 40 valid, ten CLIP prompts of 16 tokens) with
# aggregator="ABMIL" and one TwoWay block.  The trunk's random weights are
# scaled so that the layer4 map is O(1) (``ct_variables``).

CT_BASE = dict(modality=["CT", "pathology"], model_CT="resnetMC3_18",
               model_pathology="ABMIL", model_CI="CLIP",
               CI_input_version="text", CI_prompt_version="devided",
               aggregator="ABMIL", loss_point="CT-Pth-Last",
               learnablePrompt=1, n_ctx=4, compute_dtype="float32",
               spacing=[2.0, 2.0, 2.5], clip_vocab=128, clip_context=16,
               clip_width=32, clip_heads=4, clip_layers=1, clip_embed=32,
               twoway_depth=1, ct_layers=[1, 1, 1, 1], bag_buckets=[48])


def _ct_batch(cfg, seed=42):
    rs = np.random.RandomState(seed)
    toks = rs.randint(1, cfg.clip_vocab - 2, (2, 10, cfg.clip_context))
    toks[..., -1] = cfg.clip_vocab - 1
    batch = {"input_CT": rs.rand(2, 8, 32, 32, 1).astype(np.float32)}
    if "pathology" in cfg.modality:
        batch["input_pathology"] = rs.randn(2, 48, 768).astype(np.float32)
        batch["mask_pathology"] = np.arange(48)[None].repeat(2, 0) < 40
    if cfg.model_CI == "CLIP":
        batch["input_CI"] = toks.astype(np.int32)
    if "wMask" in cfg.model_CT:
        batch["mask_CT"] = (rs.rand(2, 8, 32, 32, 1) > 0.8).astype(np.float32)
    return batch


def _ct_pair(kw, batch=None, **build_kw):
    """(torch model, torch out, jax out, torch batch) for a configuration
    with a CT branch; the JAX side runs its Pallas conv3x3 in interpret mode
    where the port's backend is 'pallas'."""
    cfg = Config(**kw)
    jcfg = JConfig(**dict(kw, ct_conv_backend="pallas_interpret")) \
        if kw.get("ct_conv_backend") == "pallas" else JConfig(**kw)
    batch = batch or _ct_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(jcfg)
    variables = ct_variables(numpy_variables(jmodel, jbatch))
    want = jmodel.apply(variables, jbatch, train=False, return_attn=True)
    model = load(build_model(cfg, device="cpu", **build_kw),
                 from_flax(variables, cfg))
    tbatch = {k: t(v).long() if v.dtype == np.int32 else t(v)
              for k, v in batch.items()}
    with torch.no_grad():
        got = model(tbatch, return_attn=True)
    return model, got, want, tbatch


CT_CASES = {
    "trimodal_kernels": dict(CT_BASE, ct_conv_backend="pallas",
                             use_pallas=True),
    "trimodal_full_layout": dict(CT_BASE, ct_layers=[],
                                 ct_conv_backend="pallas"),
    "ci_is_query": dict(CT_BASE, alignment_base="CI"),
    "ct_is_query": dict(CT_BASE, alignment_base="CT"),
    "separate_ci_encoders": dict(CT_BASE, separate_CI_encoders=1),
    "wmask": dict(CT_BASE, model_CT="resnetMC3_18_wMask",
                  wmask_family="twoway"),
    "last_head_only": dict(CT_BASE, loss_point="Last"),
    "ct_only_kernels": dict(CT_BASE, modality=["CT"],
                            ct_conv_backend="pallas", use_pallas=True),
    "ct_only_ct_is_query": dict(CT_BASE, modality=["CT"],
                                alignment_base="CT"),
}
CT_OUTPUTS = ("probs", "probs_CT", "probs_Pth", "emb_CT2CI", "emb_Pth2CI",
              "emb_CI2CT", "emb_CI2Pth")


@pytest.mark.parametrize("case", sorted(CT_CASES))
def test_ct_flagship_matches_jax(case):
    kw = CT_CASES[case]
    _, got, want, _ = _ct_pair(kw)
    tri = kw["modality"] == ["CT", "pathology"]
    expected = {"probs", "emb_CT2CI"}
    if tri:
        expected |= {"emb_Pth2CI"}
        if kw["loss_point"] == "CT-Pth-Last":
            expected |= {"probs_CT", "probs_Pth"}
        if kw.get("separate_CI_encoders"):
            expected |= {"emb_CI2CT", "emb_CI2Pth"}
    assert {k for k in CT_OUTPUTS if k in got} == expected \
        == {k for k in CT_OUTPUTS if k in want}
    for k in sorted(expected):
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k])
    assert len(got["attns"]) == len(want["attns"]) \
        == (3 if "probs_CT" in expected else 1)
    for a, b in zip(got["attns"], want["attns"]):
        _close(a, b)
    assert got.get("pth_token_span") == want.get("pth_token_span")
    if tri and kw.get("alignment_base") != "pathology":
        total = got["attns"][0].shape[-1]       # tokens of the fused head
        assert got["pth_token_span"] == (total - 48, 48, total)


def test_ct_flagship_the_kernel_route_equals_the_stock_route():
    """``ct_conv_backend`` 'pallas' against 'xla' on the same weights (both
    in the port; each is held against the JAX package above)."""
    cfg = Config(**CT_BASE)
    stock = build_model(cfg, device="cpu", seed=3)
    model = load(build_model(cfg.replace(ct_conv_backend="pallas"),
                             device="cpu"), stock.state_dict())
    tbatch = {k: t(v).long() if v.dtype == np.int32 else t(v)
              for k, v in _ct_batch(cfg).items()}
    with torch.no_grad():
        got, want = model(tbatch), stock(tbatch)
    for k in ("probs", "probs_CT", "probs_Pth"):
        _close(got[k], want[k])


def test_precomputed_ct_features_match_jax(width=48):
    """``ct_features`` in the batch: no trunk is built; ``fc_CT_proj``
    projects a width that is not 512."""
    kw = dict(CT_BASE, modality=["CT"])
    batch = _ct_batch(Config(**kw))
    del batch["input_CT"]
    batch["ct_features"] = np.random.RandomState(5).randn(2, 7, width).astype(
        np.float32)
    model, got, want, _ = _ct_pair(kw, batch, ct_feature_dim=width)
    assert not hasattr(model, "extractor_CT")
    assert hasattr(model, "fc_CT_proj") is (width != 512)
    _close(got["probs"], want["probs"])
    _close(got["emb_CT2CI"], want["emb_CT2CI"])


def test_layer4_map_as_ct_features_bypasses_the_trunk():
    """A model with a trunk takes a precomputed layer4 map in its place
    (the Grad-CAM hook of the JAX package)."""
    cfg = Config(**dict(CT_BASE, modality=["CT"]))
    model = build_model(cfg, device="cpu")
    batch = {k: t(v).long() if v.dtype == np.int32 else t(v)
             for k, v in _ct_batch(cfg).items()}
    with torch.no_grad():
        want = model(batch)["probs"]
        feat = model.extractor_CT(batch["input_CT"])
        assert feat.shape == (2, 8, 2, 2, 512)
        del batch["input_CT"]
        got = model(dict(batch, ct_features=feat))["probs"]
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="ct_feature_dim=48"):
            model(dict(batch, ct_features=torch.zeros(2, 7, 48)))


def test_wmask_model_needs_the_mask():
    cfg = Config(**CT_CASES["wmask"])
    model = build_model(cfg, device="cpu")
    batch = {k: t(v).long() if v.dtype == np.int32 else t(v)
             for k, v in _ct_batch(cfg).items()}
    del batch["mask_CT"]
    with pytest.raises(ValueError, match="lacks 'mask_CT'"):
        model(batch)


def test_concat_baseline_with_ct_matches_jax():
    """The baseline builds the trunk with its defaults (native 3-D
    convolutions, full layout): the branch of ``_ConvBN`` the flagship does
    not take."""
    kw = dict(CT_BASE, model_family="concat", ct_layers=[])
    cfg, jcfg = Config(**kw), JConfig(**kw)
    batch = _ct_batch(cfg)
    del batch["input_CI"]
    jbatch = dict({k: jnp.asarray(v) for k, v in batch.items()},
                  input_CI=None)
    jmodel = jax_build_model(jcfg)
    variables = ct_variables(numpy_variables(jmodel, jbatch))
    want = jmodel.apply(variables, jbatch)
    model = load(build_model(cfg, device="cpu"), from_flax(variables, cfg))
    assert "extractor_CT.trunk.model.layer4.1.conv2.0.weight" \
        in model.state_dict()
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})
    _close(got["probs"], want["probs"])


def test_from_flax_needs_batch_stats_with_ct():
    cfg = Config(**CT_BASE)
    jbatch = {k: jnp.asarray(v) for k, v in _ct_batch(cfg).items()}
    variables = numpy_variables(jax_build_model(JConfig(**CT_BASE)), jbatch)
    with pytest.raises(KeyError, match="batch_stats"):
        from_flax({"params": to_numpy_tree(variables)["params"]}, cfg)


def test_ct_state_dict_has_reference_key_names():
    keys = set(build_model(Config(**CT_BASE), device="cpu").state_dict())
    for k in ("extractor_CT.downsampling.weight",
              "extractor_CT.model.stem.0.weight",
              "extractor_CT.model.layer1.0.conv1.1.running_mean",
              "extractor_CT.model.layer4.0.downsample.0.weight",
              "TwoWayTransformer_Both.layers.0.self_attn.q_proj.weight",
              "fc_CI2CT.0.weight", "fc_CI2Pth.0.bias", "fc_CT.1.weight",
              "fc_Pth.1.bias", "fc.1.weight", "clinic_extractor.ctx"):
        assert k in keys, k
    assert not any(k.startswith(("TwoWayTransformer_CT", "fc_CT_proj"))
                   for k in keys)
    sep = set(build_model(Config(**CT_CASES["separate_ci_encoders"]),
                          device="cpu").state_dict())
    assert "clinic_extractor_CT.ctx" in sep \
        and "TwoWayTransformer_Pth.norm_final_attn.weight" in sep \
        and "clinic_extractor.ctx" not in sep \
        and not any(k.startswith("TwoWayTransformer_Both") for k in sep)


@pytest.mark.parametrize("garbage", [1e3, float("nan")])
def test_ct_mask_leak_probe(garbage):
    """Garbage in masked bag rows leaves all three heads bit-identical."""
    cfg = Config(**dict(CT_BASE, use_pallas=True))
    model = build_model(cfg, device="cpu")
    batch = {k: t(v).long() if v.dtype == np.int32 else t(v)
             for k, v in _ct_batch(cfg).items()}
    with torch.no_grad():
        clean = model(batch)
        dirty_bag = batch["input_pathology"].clone()
        dirty_bag[~batch["mask_pathology"]] = garbage
        dirty = model(dict(batch, input_pathology=dirty_bag))
    for k in ("probs", "probs_CT", "probs_Pth"):
        assert torch.isfinite(clean[k]).all()
        assert torch.equal(clean[k], dirty[k]), k


def test_ct_cpu_forward_launches_no_kernel():
    from llmmil_tpu_torch.ops.kernels import conv3x3
    before = conv3x3.launches, mil_pool.launches
    cfg = Config(**CT_CASES["trimodal_kernels"])
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        model({k: t(v).long() if v.dtype == np.int32 else t(v)
               for k, v in _ct_batch(cfg).items()})
    assert (conv3x3.launches, mil_pool.launches) == before


@pytest.mark.parametrize("kw,match", [
    (dict(ct_temporal_mode="nope"), "ct_temporal_mode 'nope'"),
    (dict(ct_conv_backend="pallas_interpret"), "ct_conv_backend"),
    (dict(ct_fwd_lowering="nope"), "ct_fwd_lowering 'nope'"),
    (dict(model_CT="medicalNet", ct_layers=[1, 1]), "ct_layers"),
])
def test_ct_bad_config_raises_value_error(kw, match):
    with pytest.raises(ValueError, match=match):
        build_model(Config(**dict(CT_BASE, **kw)), device="cpu")
