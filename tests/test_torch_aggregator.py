"""The slice as a whole: ``build_model`` of the PyTorch port against the JAX
package's for the pathology + clinical-information flagship (simpleFCs and a
tiny CLIP text tower) and the concat baseline.  Weights are drawn with numpy
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

from _torch_port_util import (load, n, numpy_variables, ragged_mask, t,
                              to_numpy_tree)

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
    dict(modality=["CT", "pathology"]),
    dict(modality=["CT"]),
    dict(aggregator="TransMIL"),
    dict(aggregator="TransMIL_seperate"),
    dict(aggregator="TransMIL_per_modality"),
    dict(model_family="clip"),
    dict(model_family="concat", modality=["CT", "pathology"]),
    dict(modality=["CT", "pathology"], model_CT="resnetMC3_18_wMask"),
])
def test_unported_branch_raises_not_implemented(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(Config(**dict(BASE, **kw)), device="cpu")
