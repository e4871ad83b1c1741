"""TransMIL in the PyTorch port against the JAX package: ``ops/nystrom.py``
(``moore_penrose_pinv``, ``nystrom_attention`` with and without a mask and
its factored map), ``models/transmil.py`` (``NystromSelfAttention`` with a
token count that needs front padding, ``PPEG`` with a mask, ``TransMIL``),
the flagship with ``aggregator="TransMIL"`` and ``"TransMIL_seperate"``
(tri-modal, tiny trunk) and pathology-only, the concat baseline under the
default ``model_pathology="TransMIL"``, and ``GOLDEN_PROBS`` of
``tests/test_golden.py`` reproduced from flax's own initialisation carried
across by ``from_flax``.

Same numpy inputs on both sides, weights drawn with numpy in the shape of
flax's variables (``numpy_variables``) except for the golden values, fp32,
inference mode.  Tolerances: rtol 1e-4 / atol 1e-5 on outputs, as the other
parity tests (only summation order differs; the pinv's six iterations of
three (m, m) products amplify that order by a few times, which stays far
inside it at these sizes); the golden values at that test's own rtol 1e-4 /
atol 1e-6.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu.config import Config as JConfig
from llmmil_tpu.models import build_model as jax_build_model
from llmmil_tpu.models import transmil as jtm
from llmmil_tpu.models.baselines import AggregatorConcat as JConcat
from llmmil_tpu.ops import nystrom as jny
from llmmil_tpu_torch import Config
from llmmil_tpu_torch.eval.export import ServingModel, export_model
from llmmil_tpu_torch.models import build_model
from llmmil_tpu_torch.models import transmil as ttm
from llmmil_tpu_torch.models.migrate import from_flax, transmil
from llmmil_tpu_torch.ops import nystrom as tny

from _torch_port_util import (ct_variables, load, n, numpy_variables,
                              ragged_mask, t, to_numpy_tree)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _close_attn(got, want):
    """Nested lists / tuples of factored maps (or None), element by
    element."""
    if want is None:
        assert got is None
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_attn(g, w)
        return
    _close(got, want)


def _softmax_rows(rs, shape):
    a = np.exp(rs.randn(*shape))
    return (a / a.sum(-1, keepdims=True)).astype(np.float32)


# ----------------------------------------------------------------- ops --

def test_moore_penrose_pinv_matches_jax():
    a = _softmax_rows(np.random.RandomState(0), (2, 3, 8, 8))
    want = jny.moore_penrose_pinv(jnp.asarray(a), 6)
    got = tny.moore_penrose_pinv(t(a), 6)
    _close(got, want)
    # z0 is scaled per (b, h) matrix: scaling one matrix changes only it
    b = a.copy()
    b[0, 0] *= 3.0
    got_b = tny.moore_penrose_pinv(t(b), 6)
    _close(got_b[0, 0], jny.moore_penrose_pinv(jnp.asarray(b), 6)[0, 0])
    assert torch.equal(got_b[1], got[1])


@pytest.mark.parametrize("masked", [False, True])
def test_nystrom_attention_matches_jax(masked):
    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, 2, 16, 8).astype(np.float32) for _ in range(3))
    mask = ragged_mask(rs, 2, 16, low=5) if masked else None
    want, (w_left, w_right) = jny.nystrom_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_landmarks=4,
        mask=None if mask is None else jnp.asarray(mask), return_attn=True)
    got, (g_left, g_right) = tny.nystrom_attention(
        t(q), t(k), t(v), num_landmarks=4,
        mask=None if mask is None else t(mask), return_attn=True)
    _close(got, want)
    _close(g_left, w_left)
    _close(g_right, w_right)
    _close(tny.nystrom_attn_full((g_left, g_right)),
           jny.nystrom_attn_full((w_left, w_right)))
    _close(tny.nystrom_attn_rows((g_left, g_right), 0),
           jny.nystrom_attn_rows((w_left, w_right), 0))
    if masked:                     # masked keys get no weight
        assert (g_right.transpose(1, 3)[~t(mask)] == 0).all()


def test_nystrom_int8_mode_raises():
    x = torch.zeros(1, 1, 4, 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        tny.nystrom_attention(x, x, x, num_landmarks=2, int8=True)


# -------------------------------------------------------------- modules --

def _apply(jmod, variables, *args, **kwargs):
    """``jmod.apply``, jitted where every argument is an array or None: one
    compilation of the whole graph costs less than compiling op by op."""
    if all(isinstance(a, jax.Array) for a in jax.tree.leaves(args)):
        return jax.jit(functools.partial(jmod.apply, **kwargs))(variables,
                                                                *args)
    return jmod.apply(variables, *args, **kwargs)


def _module_pair(jmod, tmod, sd_fn, *args, seed=0, **kwargs):
    """JAX module applied to numpy-drawn variables, the port's module loaded
    from them; returns (jax out, torch module)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in args]
    variables = numpy_variables(jmod, *jargs, seed=seed, **kwargs)
    want = _apply(jmod, variables, *jargs, **kwargs)
    sd = sd_fn(to_numpy_tree(variables)["params"])
    return want, load(tmod, sd)


@pytest.mark.parametrize("masked", [False, True])
def test_nystrom_self_attention_with_front_padding(masked):
    """13 tokens, 8 landmarks: three rows of front padding, which take part
    when there is no mask."""
    rs = np.random.RandomState(2)
    x = rs.randn(2, 13, 32).astype(np.float32)
    mask = ragged_mask(rs, 2, 13, low=6) if masked else None
    jmod = jtm.NystromSelfAttention(dim=32, heads=4, dim_head=8,
                                    num_landmarks=8)

    def sd_fn(p):
        return {"to_qkv.weight": t(p["to_qkv"]["kernel"].T),
                "to_out.0.weight": t(p["to_out"]["kernel"].T),
                "to_out.0.bias": t(p["to_out"]["bias"]),
                "res_conv.weight": t(p["res_conv"])}

    (want, want_attn), mod = _module_pair(
        jmod, ttm.NystromSelfAttention(dim=32, heads=4, dim_head=8,
                                       num_landmarks=8),
        sd_fn, x, mask, return_attn=True)
    with torch.no_grad():
        got, attn = mod(t(x), None if mask is None else t(mask),
                        return_attn=True)
    assert got.shape == (2, 13, 32)
    _close(got, want)
    _close_attn(attn, want_attn)


def test_ppeg_with_a_mask():
    """Masked tokens are zeroed before the convolutions and in the identity
    term; garbage there changes nothing."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 17, 16).astype(np.float32)          # cls + 4 x 4
    mask = np.ones((2, 17), bool)
    mask[0, 12:] = False
    mask[1, 5:9] = False
    jmod = jtm.PPEG(dim=16)

    def sd_fn(p):
        return {f"{k}.{leaf}": t(p[k]["kernel"].transpose(3, 2, 0, 1))
                if leaf == "weight" else t(p[k]["bias"])
                for k in ("proj", "proj1", "proj2")
                for leaf in ("weight", "bias")}

    want, mod = _module_pair(jmod, ttm.PPEG(dim=16), sd_fn, x, 4, 4, mask)
    with torch.no_grad():
        got = mod(t(x), 4, 4, t(mask))
        dirty = t(x).clone()
        dirty[~t(mask)] = float("nan")
        dirty[:, 0] = t(x)[:, 0]            # the cls token is never masked
        assert torch.equal(mod(dirty, 4, 4, t(mask)), got)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_transmil_matches_jax(masked):
    """20 tokens: a 5 x 5 square (five rows wrapped), the cls token, front
    padding to 32 (16 landmarks)."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 20, 24).astype(np.float32)
    mask = ragged_mask(rs, 2, 20, low=8) if masked else None
    (want, want_attn), mod = _module_pair(
        jtm.TransMIL(L=24, D=32), ttm.TransMIL(L=24, D=32),
        lambda p: transmil(p, ""), x, mask, return_attn=True)
    with torch.no_grad():
        got, attn = mod(t(x), None if mask is None else t(mask),
                        return_attn=True)
    assert got.shape == (2, 32) and got.dtype == torch.float32
    _close(got, want)
    _close_attn(attn, want_attn)


def test_transmil_refuses_moe():
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        ttm.TransMIL(L=8, D=16, moe_experts=4)


# ----------------------------------------------------------- gradients --
# ``res_conv``'s weight gradient: oneDNN's depthwise weight gradient is ~6 %
# of its max off at a padded length of 256, so the port writes it out
# (``models/transmil.py::_ResConv``).  Held to 1e-5 of its max against an
# fp64 evaluation of dW[h, t] = Σ v_pad[b, h, n + t, d] · g[b, h, n, d] on
# the same operands: the fp32 sums of B·N·Dh products leave ~1e-6.

RES_CONV_TOL = 1e-5


def res_conv_operands(mod):
    """Hooks that keep what ``mod``'s ``res_conv`` reads: the values v
    (B, heads, N, Dh), from ``to_qkv``'s output, and the gradient g at its
    output, which is the gradient at ``to_out``'s input.  Returns the dict
    they fill ("v", and "out" whose ``.grad`` is g after a backward)."""
    kept = {}
    h, dh = mod.heads, mod.dim_head

    def keep_v(_, __, qkv):
        v = qkv[..., 2 * h * dh:]
        kept["v"] = v.detach().reshape(v.shape[0], -1, h, dh).transpose(1, 2)

    def keep_out(_, args):
        args[0].retain_grad()
        kept["out"] = args[0]

    mod.to_qkv.register_forward_hook(keep_v)
    mod.to_out[0].register_forward_pre_hook(keep_out)
    return kept


def res_conv_wgrad64(v, g, taps):
    """dW (heads, 1, taps, 1) in fp64: taps sums of shifted products."""
    n = v.shape[2]
    vp = torch.nn.functional.pad(v.double(), (0, 0, taps // 2, taps // 2))
    g = g.double()
    return torch.stack([(vp[:, :, j:j + n] * g).sum((0, 2, 3))
                        for j in range(taps)], -1)[:, None, :, None]


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("dh", [64, 4])
@pytest.mark.parametrize("padded", [256, 512])
def test_res_conv_weight_gradient_against_fp64(padded, dh, b):
    """``NystromSelfAttention`` (8 heads, 256 landmarks) over a token count
    that front-pads to ``padded``, fp32: ``res_conv.weight.grad`` against
    the fp64 sum of the same operands."""
    rs = np.random.RandomState(padded + dh + b)
    n_tok = padded - 56
    x = rs.randn(b, n_tok, 8 * dh).astype(np.float32)
    r = rs.randn(b, n_tok, 8 * dh).astype(np.float32)
    mod = ttm.NystromSelfAttention(dim=8 * dh, heads=8, dim_head=dh,
                                   num_landmarks=256).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(t(rs.randn(*p.shape).astype(np.float32) * 0.1))
    kept = res_conv_operands(mod)
    out, _ = mod(t(x))
    (out * t(r)).sum().backward()
    g = kept["out"].grad.reshape(b, padded, 8, dh).transpose(1, 2)
    assert kept["v"].shape == g.shape == (b, 8, padded, dh)
    want = res_conv_wgrad64(kept["v"], g, 33)
    err = float((mod.res_conv.weight.grad.double() - want).abs().max())
    assert err <= RES_CONV_TOL * float(want.abs().max()), \
        (err, float(want.abs().max()))


@pytest.mark.parametrize("masked", [False, True])
def test_transmil_gradients_match_jax(masked):
    """D = 512, 70 tokens (a 9 x 9 square, the cls token, front padding to
    256 landmarks), eval mode: every parameter's gradient of Σ out · r
    against ``jax.grad`` of the JAX ``TransMIL`` on the same numpy inputs,
    the weights carried across by the ``from_flax`` mapping, which maps
    the gradient tree the same way."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, 70, 32).astype(np.float32)
    r = rs.randn(2, 512).astype(np.float32)
    mask = ragged_mask(rs, 2, 70, low=30) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    jmod = jtm.TransMIL(L=32, D=512)
    variables = numpy_variables(jmod, jnp.asarray(x), jmask, scale=0.05)

    def loss(params):
        out, _ = jmod.apply({"params": params}, jnp.asarray(x), jmask)
        return jnp.sum(out * jnp.asarray(r))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    want = transmil(to_numpy_tree(grads), "")
    mod = load(ttm.TransMIL(L=32, D=512),
               transmil(to_numpy_tree(variables)["params"], ""))
    out, _ = mod(t(x), None if mask is None else t(mask))
    (out * t(r)).sum().backward()
    got = dict(mod.named_parameters())
    assert set(got) == set(want)
    for name in sorted(want):
        np.testing.assert_allclose(n(got[name].grad), n(want[name]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_from_flax_transmil_needs_exactly_its_leaves():
    rs = np.random.RandomState(5)
    x = jnp.asarray(rs.randn(1, 4, 8).astype(np.float32))
    p = to_numpy_tree(numpy_variables(jtm.TransMIL(L=8, D=16), x))["params"]
    assert set(transmil(p, "a.")) == {
        "a." + k for k in ttm.TransMIL(L=8, D=16).state_dict()}
    with pytest.raises(KeyError, match="without a destination"):
        transmil(dict(p, extra=np.zeros(1)), "a.")
    layer = {k: v for k, v in p["layer1"]["attn"].items() if k != "res_conv"}
    with pytest.raises(KeyError, match="lacks \\['res_conv'\\]"):
        transmil(dict(p, layer1=dict(p["layer1"], attn=layer)), "a.")


# ------------------------------------------------------------ the model --
# The tiny tri-modal batch of tests/test_golden.py (two 8 x 32 x 32 volumes,
# bags of 48 rows with 40 valid, ten CLIP prompts of 16 tokens), one TwoWay
# block and one block a trunk stage; the aggregator at full width.

CT_BASE = dict(modality=["CT", "pathology"], model_CT="resnetMC3_18",
               model_pathology="TransMIL", model_CI="CLIP",
               CI_input_version="text", CI_prompt_version="devided",
               aggregator="TransMIL", loss_point="CT-Pth-Last",
               learnablePrompt=1, n_ctx=4, compute_dtype="float32",
               spacing=[2.0, 2.0, 2.5], clip_vocab=128, clip_context=16,
               clip_width=32, clip_heads=4, clip_layers=1, clip_embed=32,
               twoway_depth=1, ct_layers=[1, 1, 1, 1], bag_buckets=[48])


def _ct_batch(cfg, seed=42, modality=("CT", "pathology")):
    rs = np.random.RandomState(seed)
    toks = rs.randint(1, cfg.clip_vocab - 2, (2, 10, cfg.clip_context))
    toks[..., -1] = cfg.clip_vocab - 1
    batch = {"input_CI": toks.astype(np.int32)}
    if "CT" in modality:
        batch["input_CT"] = rs.rand(2, 8, 32, 32, 1).astype(np.float32)
    batch["input_pathology"] = rs.randn(2, 48, 768).astype(np.float32)
    batch["mask_pathology"] = np.arange(48)[None].repeat(2, 0) < [[40], [29]]
    return batch


def _torch_batch(batch):
    return {k: t(v).long() if v.dtype == np.int32 else t(v)
            for k, v in batch.items()}


def _flagship_pair(kw):
    """(torch model, torch out, jax out) for one configuration; the CT
    trunk's variables are made fit for a deep comparison
    (``ct_variables``).  Where the port's backend is 'pallas' the JAX side
    runs its Pallas conv3x3 interpreted and the port's wrapper takes its
    plain version (a CPU tensor)."""
    cfg = Config(**kw)
    jcfg = JConfig(**dict(kw, ct_conv_backend="pallas_interpret")) \
        if kw.get("ct_conv_backend") == "pallas" else JConfig(**kw)
    batch = _ct_batch(cfg, modality=kw["modality"])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jax_build_model(jcfg)
    variables = numpy_variables(jmodel, jbatch)
    if "CT" in kw["modality"]:
        variables = ct_variables(variables)
    want = _apply(jmodel, variables, jbatch, train=False, return_attn=True)
    model = load(build_model(cfg, device="cpu"),
                 from_flax(to_numpy_tree(variables), cfg))
    with torch.no_grad():
        got = model(_torch_batch(batch), return_attn=True)
    return model, got, want


FLAGSHIP_CASES = {
    "trimodal_transmil": dict(CT_BASE),
    "trimodal_transmil_kernel_route": dict(CT_BASE, ct_conv_backend="pallas"),
    "trimodal_transmil_seperate": dict(CT_BASE,
                                       aggregator="TransMIL_seperate"),
    "pathology_transmil": dict(CT_BASE, modality=["pathology"],
                               loss_point="Last"),
}


@pytest.fixture(scope="module")
def flagship_pairs():
    """Each configuration built and run once for the tests below."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _flagship_pair(FLAGSHIP_CASES[case])
        return cache[case]
    return get


@pytest.mark.parametrize("case", sorted(FLAGSHIP_CASES))
def test_flagship_with_transmil_matches_jax(case, flagship_pairs):
    model, got, want = flagship_pairs(case)
    heads = ("probs", "probs_CT", "probs_Pth") if "probs_CT" in want \
        else ("probs",)
    assert {k for k in got if k.startswith("probs")} == set(heads)
    for k in heads + tuple(k for k in ("emb_CT2CI", "emb_Pth2CI")
                           if k in want):
        assert got[k].shape == want[k].shape, k
        _close(got[k], want[k])
    _close_attn(got["attns"], want["attns"])
    assert got.get("pth_token_span") == want.get("pth_token_span")
    if FLAGSHIP_CASES[case]["aggregator"] == "TransMIL_seperate":
        assert hasattr(model, "aggregator_CT") \
            and got["pth_token_span"] == (21, 1, 22)   # 10 + 1 + 10 + 1
    else:
        # one module pools all three streams
        assert not hasattr(model, "aggregator_CT")


@pytest.mark.parametrize("garbage", [1e3, float("nan")])
def test_transmil_mask_leak_probe(garbage, flagship_pairs):
    """Garbage in masked bag rows leaves every head bit-identical."""
    model, _, _ = flagship_pairs("trimodal_transmil")
    batch = _torch_batch(_ct_batch(Config(**CT_BASE)))
    with torch.no_grad():
        clean = model(batch)
        dirty_bag = batch["input_pathology"].clone()
        dirty_bag[~batch["mask_pathology"]] = garbage
        dirty = model(dict(batch, input_pathology=dirty_bag))
    for k in ("probs", "probs_CT", "probs_Pth"):
        assert torch.isfinite(clean[k]).all()
        assert torch.equal(clean[k], dirty[k]), k


def test_transmil_flagship_is_served(flagship_pairs):
    """export_model → ServingModel rebuilds the TransMIL flagship from the
    artifact and answers what the module answers."""
    model, _, _ = flagship_pairs("trimodal_transmil")
    cfg = Config(**CT_BASE)
    batch = _ct_batch(cfg)
    served = ServingModel(export_model(cfg, model.state_dict(), [batch]),
                          device="cpu")
    with torch.no_grad():
        want = model(_torch_batch(batch))["probs"]
    assert np.array_equal(served.call(batch), n(want))


def test_transmil_state_dict_has_reference_key_names():
    keys = set(build_model(Config(**dict(CT_BASE, ct_layers=[1, 1, 1, 1])),
                           device="meta").state_dict())
    for k in ("aggregator._fc1.0.weight", "aggregator.cls_token",
              "aggregator.layer1.norm.weight",
              "aggregator.layer1.attn.to_qkv.weight",
              "aggregator.layer2.attn.to_out.0.bias",
              "aggregator.layer2.attn.res_conv.weight",
              "aggregator.pos_layer.proj.weight",
              "aggregator.pos_layer.proj2.bias", "aggregator.norm.bias"):
        assert k in keys, k
    assert "aggregator.layer1.attn.to_qkv.bias" not in keys
    sep = set(build_model(Config(**FLAGSHIP_CASES[
        "trimodal_transmil_seperate"]), device="meta").state_dict())
    assert "aggregator.attention_V.0.weight" in sep \
        and "aggregator_CT.cls_token" in sep \
        and "aggregator_Pth.pos_layer.proj1.weight" in sep


def test_concat_baseline_under_model_pathology_transmil_matches_jax():
    """The JAX concat baseline pools the raw bag with ABMIL whatever
    ``model_pathology`` says (its TransMIL branch belongs to the wMask
    model, ``AggregatorWMask``); under the default ``"TransMIL"`` the port
    computes the same."""
    kw = dict(CT_BASE, modality=["pathology"], model_family="concat",
              use_pallas="auto")
    assert Config(**kw).model_pathology == "TransMIL"
    cfg, jcfg = Config(**kw), JConfig(**kw)
    rs = np.random.RandomState(6)
    batch = {"input_pathology": rs.randn(2, 24, 768).astype(np.float32),
             "mask_pathology": ragged_mask(rs, 2, 24)}
    jbatch = dict({k: jnp.asarray(v) for k, v in batch.items()},
                  input_CI=None)
    jmodel = jax_build_model(jcfg)
    assert isinstance(jmodel, JConcat)
    variables = numpy_variables(jmodel, jbatch)
    want = _apply(jmodel, variables, jbatch)
    model = load(build_model(cfg, device="cpu"),
                 from_flax(to_numpy_tree(variables), cfg))
    assert model.fc1.in_features == 768
    with torch.no_grad():
        got = model({k: t(v) for k, v in batch.items()})
    _close(got["probs"], want["probs"])


def test_golden_probs_from_flax_init():
    """``GOLDEN_PROBS`` of tests/test_golden.py: the tiny TransMIL flagship
    (full MC3-18 trunk, two TwoWay blocks) with flax's own
    ``init(PRNGKey(0))`` carried across by ``from_flax``."""
    from test_golden import GOLDEN_PROBS, _tiny_flagship
    jcfg, jbatch = _tiny_flagship()
    variables = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0),
                                                    jbatch)
    cfg = Config(**jcfg.to_dict())
    model = load(build_model(cfg, device="cpu"),
                 from_flax(to_numpy_tree(variables), cfg))
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    with torch.no_grad():
        out = model(_torch_batch(batch))
    got = np.stack([n(out[k]) for k in ("probs", "probs_CT", "probs_Pth")])
    np.testing.assert_allclose(got.astype(np.float64),
                               np.array(GOLDEN_PROBS, np.float64),
                               rtol=1e-4, atol=1e-6)
