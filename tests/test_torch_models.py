"""Modules of the PyTorch port against their flax counterparts: weights are
drawn with numpy in the shape of flax's variables, ``models/migrate.py`` of
the port carries them across, the same numpy inputs go through both, fp32,
inference mode.  atol 1e-5 (a few matmuls and a softmax deep; only summation
order differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu import models as jm
from llmmil_tpu_torch import models as tm
from llmmil_tpu_torch.models import migrate
from llmmil_tpu_torch.models.layers import Dense, LayerNorm32, init_weights

from _torch_port_util import (load, n, numpy_variables, ragged_mask, t,
                              to_numpy_tree)

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(n(got), n(want), atol=atol, rtol=0)


def _params(variables):
    return to_numpy_tree(variables)["params"]


@pytest.mark.parametrize("variant,width", [
    ("SimpleFCsV1", 9), ("SimpleFCsV1d", 9 * 57), ("SimpleFCsV2", 27),
    ("SimpleFCsV2d", 27 * 19)])
def test_simple_fcs(variant, width):
    x = np.random.RandomState(0).rand(3, width).astype(np.float32)
    jmod = getattr(jm, variant)()
    variables = numpy_variables(jmod, jnp.asarray(x))
    tmod = load(getattr(tm, variant)(),
                migrate.simple_fcs(_params(variables), ""))
    _close(tmod(t(x)), jmod.apply(variables, jnp.asarray(x)))


def test_simple_fcs_tiled_width_is_checked():
    with pytest.raises(ValueError, match="tiled"):
        tm.SimpleFCsV1d()(torch.zeros(1, 9))


TINY_CLIP = dict(vocab_size=64, context_length=16, width=32, heads=4,
                 layers=1, embed_dim=16)


def _tokens(rs, *lead):
    toks = rs.randint(1, 60, (*lead, 16)).astype(np.int32)
    eot = rs.randint(10, 16, lead)
    np.put_along_axis(toks, eot[..., None], 63, axis=-1)   # EOT = argmax id
    return toks


def test_clip_text_encoder():
    toks = _tokens(np.random.RandomState(1), 8)
    jmod = jm.CLIPTextEncoder(jm.CLIPTextConfig(**TINY_CLIP))
    variables = numpy_variables(jmod, jnp.asarray(toks))
    tmod = load(tm.CLIPTextEncoder(tm.CLIPTextConfig(**TINY_CLIP)),
                migrate.clip_text(_params(variables), ""))
    got = tmod(t(toks).long())
    assert got.shape == (8, 16)
    _close(got, jmod.apply(variables, jnp.asarray(toks)))


@pytest.mark.parametrize("learnable,p", [(True, 4), (True, 2), (False, 4)])
def test_coop_clinical_encoder(learnable, p):
    """[SOT | ctx[:P] | suffix] splice and EOT pooling; ``p`` < n_prompts
    uses the first P context rows."""
    toks = _tokens(np.random.RandomState(2), 8 // p, p)   # 8 prompts in all
    kw = dict(n_prompts=4, n_ctx=3, learnable=learnable)
    jmod = jm.CoOpClinicalEncoder(cfg=jm.CLIPTextConfig(**TINY_CLIP), **kw)
    variables = numpy_variables(jmod, jnp.asarray(toks))
    tmod = load(tm.CoOpClinicalEncoder(cfg=tm.CLIPTextConfig(**TINY_CLIP),
                                       **kw),
                migrate.coop(_params(variables), ""))
    got = tmod(t(toks).long())
    assert got.shape == (8 // p, p, 16)
    _close(got, jmod.apply(variables, jnp.asarray(toks)))


def test_coop_gradient_reaches_only_the_context():
    toks = _tokens(np.random.RandomState(3), 1, 2)
    tmod = tm.CoOpClinicalEncoder(n_prompts=2, n_ctx=3,
                                  cfg=tm.CLIPTextConfig(**TINY_CLIP))
    init_weights(tmod, torch.Generator().manual_seed(0))
    tmod(t(toks).long()).sum().backward()
    assert tmod.ctx.grad is not None and tmod.ctx.grad.abs().sum() > 0
    assert tmod.model.token_embedding.weight.grad is None


@pytest.mark.parametrize("case", ["key_mask", "no_mask", "downsample2",
                                  "nan_in_masked_values"])
def test_attention(case):
    rs = np.random.RandomState(4)
    q = rs.randn(2, 3, 32).astype(np.float32)
    k = rs.randn(2, 11, 32).astype(np.float32)
    v = rs.randn(2, 11, 32).astype(np.float32)
    mask = None if case == "no_mask" else ragged_mask(rs, 2, 11)
    rate = 2 if case == "downsample2" else 1
    jmod = jm.Attention(32, 4, rate)
    jmask = None if mask is None else jnp.asarray(mask)
    variables = numpy_variables(jmod, jnp.asarray(q), jnp.asarray(k),
                          jnp.asarray(v), jmask)
    tmod = load(tm.Attention(32, 4, rate),
                migrate.attention(_params(variables), ""))
    want = jmod.apply(variables, jnp.asarray(q), jnp.asarray(k),
                      jnp.asarray(v), jmask)
    if case == "nan_in_masked_values":
        v = v.copy()
        v[~mask] = np.nan
    got = tmod(t(q), t(k), t(v), None if mask is None else t(mask))
    _close(got, want)


@pytest.mark.parametrize("case", ["image_mask", "point_mask", "no_mask",
                                  "depth1"])
def test_twoway_transformer(case):
    rs = np.random.RandomState(5)
    image = rs.randn(2, 12, 64).astype(np.float32)
    pe = rs.randn(1, 12, 64).astype(np.float32)
    point = rs.randn(2, 3, 64).astype(np.float32)
    kw, tkw = {}, {}
    if case == "image_mask":
        m = ragged_mask(rs, 2, 12)
        kw, tkw = {"image_mask": jnp.asarray(m)}, {"image_mask": t(m)}
    elif case == "point_mask":
        m = ragged_mask(rs, 2, 3, low=1)
        kw, tkw = {"point_mask": jnp.asarray(m)}, {"point_mask": t(m)}
    cfg = dict(depth=1 if case == "depth1" else 2, embedding_dim=64,
               num_heads=4, mlp_dim=96)
    jmod = jm.TwoWayTransformer(**cfg)
    args = (jnp.asarray(image), jnp.asarray(pe), jnp.asarray(point))
    variables = numpy_variables(jmod, *args, **kw)
    tmod = load(tm.TwoWayTransformer(**cfg),
                migrate.twoway(_params(variables), ""))
    want_q, want_k = jmod.apply(variables, *args, **kw)
    got_q, got_k = tmod(t(image), t(pe), t(point), **tkw)
    _close(got_q, want_q)
    _close(got_k, want_k)


def test_tokens_from_feature_map():
    from llmmil_tpu.models.twoway import tokens_from_feature_map as jf
    from llmmil_tpu_torch.models.twoway import tokens_from_feature_map as tf
    x = np.random.RandomState(6).randn(2, 3, 4, 5, 6).astype(np.float32)
    for reduce in ("mean", "flatten"):
        _close(tf(t(x), reduce), jf(jnp.asarray(x), reduce), atol=1e-6)
    assert tf(t(x[:, :, 0, 0]), "mean").shape == (2, 3, 6)


@pytest.mark.parametrize("case", ["plain_masked", "plain_unmasked",
                                  "kernel_masked", "kernel_unmasked",
                                  "plain_k2"])
def test_abmil(case):
    """Plain path and kernel path (on the CPU: the kernel's plain version)
    against flax ABMIL; without a mask the kernel path gets an all-true
    mask and must equal the unmasked pool."""
    rs = np.random.RandomState(7)
    x = rs.randn(2, 37, 64).astype(np.float32)
    masked = case.endswith("_masked")
    mask = ragged_mask(rs, 2, 37) if masked else None
    k = 2 if case == "plain_k2" else 1
    jmod = jm.ABMIL(L=64, D=32, K=k)
    jmask = None if mask is None else jnp.asarray(mask)
    variables = numpy_variables(jmod, jnp.asarray(x), jmask)
    tmod = load(tm.ABMIL(L=64, D=32, K=k,
                         use_kernel=case.startswith("kernel")),
                migrate.abmil(_params(variables), ""))
    want_m, want_a = jmod.apply(variables, jnp.asarray(x), jmask)
    got_m, got_a = tmod(t(x), None if mask is None else t(mask))
    assert got_m.shape == (2, k, 64) and got_a.shape == (2, k, 37)
    _close(got_m, want_m)
    _close(got_a, want_a)


def test_abmil_kernel_is_single_head():
    with pytest.raises(ValueError, match="K == 1"):
        tm.ABMIL(L=64, D=32, K=2, use_kernel=True)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_abmil_v2(use_kernel):
    rs = np.random.RandomState(8)
    x = rs.randn(2, 20, 64).astype(np.float32)
    mask = ragged_mask(rs, 2, 20)
    bprc = np.array([[0.0], [1.0]], np.float32)
    jmod = jm.ABMILv2(L=64, D=32)
    variables = numpy_variables(jmod, jnp.asarray(x), jnp.asarray(bprc),
                          jnp.asarray(mask))
    tmod = load(tm.ABMILv2(L=64, D=32, use_kernel=use_kernel),
                migrate.abmil(_params(variables), ""))
    want_m, want_a = jmod.apply(variables, jnp.asarray(x),
                                jnp.asarray(bprc), jnp.asarray(mask))
    got_m, got_a = tmod(t(x), t(bprc), t(mask))
    assert got_m.shape == (2, 1, 65)
    _close(got_m, want_m)
    _close(got_a, want_a)


def test_dense_and_layernorm_mirror_flax_mixed_precision():
    """bf16 compute: Dense casts input and fp32 params to bf16 and returns
    bf16; LayerNorm computes and returns fp32 with eps 1e-6."""
    import flax.linen as nn
    x = np.random.RandomState(9).randn(4, 16).astype(np.float32)
    jd = nn.Dense(8, dtype=jnp.bfloat16)
    vd = numpy_variables(jd, jnp.asarray(x))
    td = load(Dense(16, 8, torch.bfloat16), migrate.dense(_params(vd), ""))
    got = td(t(x))
    assert got.dtype == torch.bfloat16 and td.weight.dtype == torch.float32
    _close(got.float(), jd.apply(vd, jnp.asarray(x)).astype(jnp.float32),
           atol=2e-2)                      # one bf16 rounding of |y| <~ 4
    jl = nn.LayerNorm()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    vl = numpy_variables(jl, xb)
    tl = load(LayerNorm32(16), migrate.layer_norm(_params(vl), ""))
    got = tl(t(x).to(torch.bfloat16))
    want = jl.apply(vl, xb)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)


def test_seeded_init_is_reproducible_and_device_free():
    a, b = tm.ABMIL(L=16, D=8), tm.ABMIL(L=16, D=8)
    init_weights(a, torch.Generator().manual_seed(3))
    init_weights(b, torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.attention_V[0].bias.abs().sum() == 0
    assert a.attention_V[0].weight.std() > 0
