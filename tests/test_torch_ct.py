"""``models/ct_mc3.py`` of the PyTorch port against the JAX package: the
depth-folded convolution in its three forms, the MC3-18 trunk through
``from_flax`` with random BatchNorm statistics, and the CT-extractor
factory.  The same numpy inputs and weights go through both, fp32, rtol 1e-4
/ atol 1e-5 unless a test states another with its reason.  Where the JAX
side reaches its Pallas ``conv3x3`` kernel it runs it in interpret mode
(``conv_backend="pallas_interpret"``); the port's ``"pallas"`` takes the
kernel's plain version on a CPU tensor."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu.config import Config as JConfig
from llmmil_tpu.models import aggregator as jagg
from llmmil_tpu.models import ct_mc3 as jct
from llmmil_tpu_torch import Config
from llmmil_tpu_torch.models import aggregator as agg
from llmmil_tpu_torch.models import ct_mc3 as ct
from llmmil_tpu_torch.models import migrate
from llmmil_tpu_torch.ops.kernels import conv3x3

from _torch_port_util import ct_variables, load, n, numpy_variables, t

RTOL, ATOL = 1e-4, 1e-5
CASES = {       # (kernel, stride, padding): the shapes the MC3 trunk uses
    "stem": ((3, 7, 7), (1, 2, 2), (1, 3, 3)),
    "layer1": ((3, 3, 3), (1, 1, 1), (1, 1, 1)),
    "strided": ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
    "spacing_stem": ((3, 4, 4), (1, 2, 2), (1, 1, 1)),
}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol, atol=atol)


def _fold_pair(case, mode, cin=3, features=4, backend="xla",
               lowering="fold", bias=True, seed=0):
    kernel, stride, padding = CASES[case]
    x = np.random.RandomState(seed).randn(2, 9, 12, 12, cin).astype(
        np.float32)
    jmod = jct.DepthFoldedConv(
        features, kernel, stride, padding, mode=mode, use_bias=bias,
        conv_backend="pallas_interpret" if backend == "pallas" else backend,
        fwd_lowering=lowering)
    variables = numpy_variables(jmod, jnp.asarray(x), seed=seed + 1)
    want = jmod.apply(variables, jnp.asarray(x))
    mod = load(ct.DepthFoldedConv(cin, features, kernel, stride, padding,
                                  mode=mode, use_bias=bias,
                                  conv_backend=backend,
                                  fwd_lowering=lowering),
               migrate.conv(variables["params"], ""))
    with torch.no_grad():
        got = mod(t(x))
    assert got.shape == want.shape and got.is_contiguous()
    return got, want


@pytest.mark.parametrize("mode", ["dfold", "dsum", "dshift"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_depthfold_matches_flax(mode, case):
    _close(*_fold_pair(case, mode))


@pytest.mark.parametrize("mode", ["dfold", "dsum", "dshift"])
def test_depthfold_kernel_route_matches_interpreted_pallas(mode):
    """3×3, stride 1, pad 1: the gate sends the folded convolutions to
    ``conv3x3`` on both sides."""
    before = conv3x3.launches
    _close(*_fold_pair("layer1", mode, cin=5, features=6, backend="pallas",
                       bias=False))
    assert conv3x3.launches == before      # CPU: the plain version


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv3d_fwd_lowering_matches_flax(case):
    """``fwd_lowering='conv3d'`` with cin >= 8 and cout < 128 is a plain 3-D
    convolution on both sides."""
    _close(*_fold_pair(case, "dfold", cin=8, lowering="conv3d"))


def test_conv3d_fwd_lowering_keeps_the_fold_form_where_jax_does(monkeypatch):
    """Low-channel inputs and the kernel route never take the 3-D form."""
    called = []
    real = ct.conv3d_ndhwc
    monkeypatch.setattr(ct, "conv3d_ndhwc",
                        lambda *a: called.append(1) or real(*a))
    _close(*_fold_pair("layer1", "dfold", cin=3, lowering="conv3d"))
    _close(*_fold_pair("layer1", "dfold", cin=8, lowering="conv3d",
                       backend="pallas"))
    assert called == []
    _close(*_fold_pair("layer1", "dfold", cin=8, lowering="conv3d"))
    assert called == [1]


def test_folded_weights_follow_a_later_load():
    """The folded weights are cached for inference; loading other weights
    must not leave the old ones in use."""
    kernel, stride, padding = CASES["layer1"]
    mod = ct.DepthFoldedConv(3, 4, kernel, stride, padding, mode="dshift")
    other = ct.DepthFoldedConv(3, 4, kernel, stride, padding, mode="dshift")
    gen = torch.Generator().manual_seed(0)
    mod.init_weights(gen)
    other.init_weights(gen)
    x = torch.randn(1, 5, 6, 6, 3, generator=gen)
    with torch.no_grad():
        first = mod(x)
        assert len(mod._cache) == 1 and torch.equal(mod(x), first)
        mod.load_state_dict(other.state_dict())
        assert torch.equal(mod(x), other(x))
        assert not torch.equal(mod(x), first)


def test_unknown_fold_mode_is_refused():
    with pytest.raises(ValueError, match="mode 'conv3d'"):
        ct.DepthFoldedConv(3, 4, (3, 3, 3), (1, 1, 1), (1, 1, 1),
                           mode="conv3d")


def test_batchnorm_matches_flax_and_refuses_training():
    import flax.linen as nn
    x = np.random.RandomState(0).randn(2, 3, 4, 4, 6).astype(np.float32)
    rs = np.random.RandomState(1)
    variables = {"params": {"scale": rs.randn(6).astype(np.float32),
                            "bias": rs.randn(6).astype(np.float32)},
                 "batch_stats": {"mean": rs.randn(6).astype(np.float32),
                                 "var": rs.rand(6).astype(np.float32) + 0.1}}
    sd = migrate.batch_norm(variables["params"], variables["batch_stats"], "")
    assert int(sd["num_batches_tracked"]) == 0
    for dtype, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                            (torch.bfloat16, jnp.bfloat16, 2 ** -6)):
        # bf16: fp32 statistics, fp32 arithmetic, one rounding at the end
        jbn = nn.BatchNorm(use_running_average=True, momentum=0.9,
                           epsilon=1e-5, dtype=jdt)
        want = jbn.apply(variables, jnp.asarray(x, jdt))
        bn = load(ct.BatchNorm(6, dtype), sd)
        got = bn(t(x).to(dtype))
        assert got.dtype == dtype
        _close(got.float(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    # training mode: batch statistics, flax's running update (biased
    # variance, momentum 0.9), gradients of x, scale and bias; the same
    # numbers in fp32 up to the order of the sums
    dy = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def jloss(params, xx):
        y, upd = jbn.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, upd["batch_stats"])

    import jax
    (gp, gx), (want, stats) = jax.grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    bn = load(ct.BatchNorm(6), sd).train()
    xt = t(x).requires_grad_(True)
    got = bn(xt)
    (got * t(dy)).sum().backward()
    _close(got, want, rtol=1e-5, atol=1e-5)
    _close(bn.running_mean, stats["mean"], rtol=1e-5, atol=1e-6)
    _close(bn.running_var, stats["var"], rtol=1e-5, atol=1e-6)
    _close(xt.grad, gx, rtol=1e-4, atol=1e-5)
    _close(bn.weight.grad, gp["scale"], rtol=1e-4, atol=1e-5)
    _close(bn.bias.grad, gp["bias"], rtol=1e-4, atol=1e-5)
    # update_stats off (a rematerialised block's second forward): the same
    # output, running statistics untouched
    bn.update_stats = False
    before = bn.running_var.clone()
    assert torch.equal(bn(t(x)), got.detach()) \
        and torch.equal(bn.running_var, before)


def _trunk_pair(spacing_xy, layers, mode, backend="xla", lowering="fold",
                dtype="float32", in_channels=1, shape=(1, 4, 16, 16)):
    x = np.random.RandomState(0).rand(*shape, in_channels).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jmod = jct.ResnetMC3_18(
        spacing_xy=spacing_xy, remat=False, dtype=jdt, layers=layers,
        temporal_mode=mode, fwd_lowering=lowering,
        conv_backend="pallas_interpret" if backend == "pallas" else backend)
    variables = ct_variables(numpy_variables(jmod, jnp.asarray(x)))
    want = jmod.apply(variables, jnp.asarray(x))
    mod = load(ct.ResnetMC3_18(in_channels, spacing_xy,
                               getattr(torch, dtype), layers, mode, backend,
                               lowering),
               migrate.resnet_mc3(variables["params"],
                                  variables["batch_stats"], ""))
    with torch.no_grad():
        got = mod(t(x))
    assert got.shape == want.shape and got.shape[-1] == 512
    return got, np.asarray(want, np.float32)


def _close_map(got, want):
    """A layer4 value is a sum of ~1e3 products, 9 to 17 layers deep, and
    the map reaches ~10: where terms cancel, the two back ends' different
    orders of summation leave an absolute error of a few fp32 steps of the
    *largest* values.  So atol is 1e-5 of the map's largest value (rtol
    stays 1e-4), and the map must not have vanished."""
    top = np.abs(want).max()
    assert top > 1e-2
    _close(got, want, atol=ATOL * max(1.0, top))


@pytest.mark.parametrize("spacing_xy,mode,backend", [
    (2.0, "dfold", "xla"), (2.0, "dfold", "pallas"),
    (2.0, "dshift", "pallas"), (2.0, "conv3d", "xla"),
    (0.6869, "dfold", "pallas"), (0.6869, "conv3d", "xla")])
def test_mc3_trunk_matches_flax(spacing_xy, mode, backend):
    _close_map(*_trunk_pair(spacing_xy, (1, 1, 1, 1), mode, backend))


def test_mc3_full_layout_matches_flax():
    _close_map(*_trunk_pair(2.0, (2, 2, 2, 2), "dfold", "pallas"))


def test_mc3_conv3d_lowering_and_mask_channel_match_flax():
    _close_map(*_trunk_pair(2.0, (1, 1, 1, 1), "dfold", lowering="conv3d",
                            in_channels=2))


def test_mc3_bf16_follows_flax_bf16():
    """bf16 compute: both sides keep fp32 parameters and BatchNorm
    statistics and round activations to bf16 between layers; the convolution
    back ends sum in different orders, so a value may sit one bf16 step off
    and the steps add up through nine blocks: 5 % of the map's largest
    value."""
    got, want = _trunk_pair(2.0, (1, 1, 1, 1), "dfold", "pallas",
                            dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got.float()), want, rtol=0,
                               atol=0.05 * np.abs(want).max())


def test_trunk_carries_torchvision_key_names():
    mod = ct.ResnetMC3_18(temporal_mode="dfold")
    keys = set(mod.state_dict())
    for k in ("downsampling.weight", "downsampling.bias",
              "model.stem.0.weight", "model.stem.1.running_var",
              "model.layer1.0.conv1.0.weight", "model.layer1.1.conv2.1.bias",
              "model.layer2.0.downsample.0.weight",
              "model.layer2.0.downsample.1.num_batches_tracked",
              "model.layer4.1.conv2.0.weight"):
        assert k in keys, k
    assert not any("downsample" in k for k in keys if "layer1" in k)
    sd = mod.state_dict()
    assert sd["downsampling.weight"].shape == (3, 1, 3, 4, 4)
    assert sd["model.stem.0.weight"].shape == (64, 3, 3, 7, 7)
    assert sd["model.layer1.0.conv1.0.weight"].shape == (64, 64, 3, 3, 3)
    assert sd["model.layer2.0.conv1.0.weight"].shape == (128, 64, 1, 3, 3)
    assert sd["model.layer2.0.downsample.0.weight"].shape \
        == (128, 64, 1, 1, 1)
    # the same keys whatever the lowering
    assert keys == set(ct.ResnetMC3_18().state_dict())


def test_only_layer1_reaches_the_kernel(monkeypatch):
    """As in the JAX package: the stems get no ``conv_backend`` and layers
    2-4 are (1,3,3); 2 blocks x 2 convolutions launch the kernel."""
    calls = []
    monkeypatch.setattr(ct, "conv3x3",
                        lambda x, k: calls.append(tuple(x.shape) + (
                            k.shape[-1],)) or torch.zeros(
                            *x.shape[:3], k.shape[-1]))
    mod = ct.ResnetMC3_18(spacing_xy=2.0, temporal_mode="dfold",
                          conv_backend="pallas")
    mod.eval()
    with torch.no_grad():
        mod(torch.zeros(1, 4, 16, 16, 1))
    assert calls == [(4, 8, 8, 192, 64)] * 4


def test_seeded_init_is_reproducible_and_scaled():
    a, b = ct.ResnetMC3_18(), ct.ResnetMC3_18()
    from llmmil_tpu_torch.models.layers import init_weights
    init_weights(a, torch.Generator().manual_seed(3))
    init_weights(b, torch.Generator().manual_seed(3))
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    w = a.state_dict()["model.layer1.0.conv1.0.weight"]
    assert abs(float(w.std()) - (64 * 27) ** -0.5) < 2e-3
    assert float(a.state_dict()["model.stem.1.running_var"].min()) == 1.0
    assert float(a.state_dict()["downsampling.bias"].abs().max()) == 0.0


def test_mask_centroids_matches_jax():
    rs = np.random.RandomState(0)
    m = (rs.rand(3, 6, 9, 7) > 0.7).astype(np.float32)
    m[1] = 0.0                                   # an empty mask → zeros
    want = jagg.mask_centroids(jnp.asarray(m))
    got = agg.mask_centroids(t(m))
    assert got.dtype == torch.int32 and got.shape == (3, 3)
    np.testing.assert_array_equal(n(got), np.asarray(want))


BASE = dict(modality=["CT"], compute_dtype="float32")


@pytest.mark.parametrize("kw,match", [
    (dict(ct_temporal_mode="nope"), "ct_temporal_mode 'nope'"),
    (dict(ct_conv_backend="cudnn"), "ct_conv_backend 'cudnn'"),
    (dict(ct_conv_backend="pallas_interpret"), "no interpreter"),
    (dict(ct_fwd_lowering="nope"), "ct_fwd_lowering 'nope'"),
    (dict(model_CT="nope"), "unknown model_CT nope"),
    (dict(model_CT="medicalNet", ct_layers=[1, 1]), "only honored by"),
])
def test_ct_extractor_bad_config_names_the_field(kw, match):
    with pytest.raises(ValueError, match=match):
        agg.make_ct_extractor(Config(**dict(BASE, **kw)), torch.float32)


def test_ct_layers_rejection_has_the_jax_message():
    kw = dict(BASE, model_CT="medicalNet", ct_layers=[1, 1])
    with pytest.raises(ValueError) as jerr:
        jagg.make_ct_extractor(JConfig(**kw), jnp.float32)
    with pytest.raises(ValueError) as terr:
        agg.make_ct_extractor(Config(**kw), torch.float32)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw,item", [
    (dict(model_CT="medicalNet"), "Queue 1 item 5"),
    (dict(model_CT="resnet2plus1d_18"), "Queue 1 item 5"),
    (dict(model_CT="SwinUNETR_wMask"), "Queue 1 item 5"),
    (dict(model_CT="MViT"), "Queue 1 item 5"),
    (dict(ct_shard_axis="depth"), "Queue 1 item 10"),
])
def test_ct_extractor_unported_names_its_roadmap_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        agg.make_ct_extractor(Config(**dict(BASE, **kw)), torch.float32)


@pytest.mark.parametrize("model_ct,cin", [("resnetMC3_18", 1),
                                          ("resnetMC3_18_wMask", 2)])
def test_ct_extractor_reads_the_config(model_ct, cin):
    cfg = Config(**dict(BASE, model_CT=model_ct, ct_layers=[1, 2, 1, 1],
                        spacing=[2.0, 2.0, 2.5], ct_temporal_mode="dshift",
                        ct_conv_backend="pallas", ct_remat="early"))
    mod = agg.make_ct_extractor(cfg, torch.bfloat16)
    assert mod.downsampling.weight.shape == (3, cin, 3, 3, 3)
    assert len(mod.model.layer2) == 2 and len(mod.model.layer1) == 1
    conv = mod.model.layer1[0].conv1[0]
    assert isinstance(conv, ct.DepthFoldedConv) and conv.mode == "dshift"
    assert conv.use_kernel and conv.compute_dtype == torch.bfloat16
    assert not mod.model.stem[0].use_kernel
    assert not mod.downsampling.use_kernel
    assert isinstance(mod.model.layer2[0].conv1[0], ct.Conv3d)


# -------------------------------------------------------------- training --

@pytest.fixture
def centred_flax_variance(monkeypatch):
    """flax's BatchNorm takes E[x²] − E[x]², which loses most of fp32's
    digits where a channel's mean is large against its spread (the maps
    after a ReLU), and its gradient with them; the port's is the centred
    variance.  The JAX side computes that here (tests/test_torch_train.py
    measures the difference)."""
    from flax.linen import normalization
    real = normalization._compute_stats
    monkeypatch.setattr(normalization, "_compute_stats",
                        lambda *a, **k: real(*a, **dict(
                            k, use_fast_variance=False)))


@pytest.mark.parametrize("backend,remat", [("pallas", "all")])
def test_trunk_training_vjp_matches_flax(centred_flax_variance, backend,
                                         remat):
    """The trunk in training mode, one upstream gradient: every parameter's
    gradient and the running statistics after the step, as flax.  The
    JAX package's convolution gradients on the CPU and the port's differ
    by ~1e-5 of a tensor's largest value: atol 1e-4 of it."""
    import jax
    x = np.random.RandomState(0).rand(2, 6, 16, 16, 1).astype(np.float32)
    jmod = jct.ResnetMC3_18(
        spacing_xy=2.0, remat=False, layers=(1, 1, 1, 1),
        temporal_mode="dfold",
        conv_backend="pallas_interpret" if backend == "pallas" else backend)
    variables = ct_variables(numpy_variables(jmod, jnp.asarray(x)))
    shape = jax.eval_shape(jmod.apply, variables, jnp.asarray(x)).shape
    dy = np.random.RandomState(1).randn(*shape).astype(np.float32)

    def loss(params):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * dy), upd["batch_stats"]

    grads, stats = jax.jit(jax.grad(loss, has_aux=True))(
        variables["params"])
    mod = load(ct.ResnetMC3_18(1, 2.0, torch.float32, (1, 1, 1, 1), "dfold",
                               backend, "fold", remat),
               migrate.resnet_mc3(variables["params"],
                                  variables["batch_stats"], "")).train()
    (mod(t(x)) * t(dy)).sum().backward()
    want = migrate.resnet_mc3(grads, migrate._stats_like(grads), "")
    for k, p in mod.named_parameters():
        top = float(np.abs(n(want[k])).max())
        _close(p.grad, want[k], rtol=1e-4, atol=1e-4 * top)
    moved = migrate.resnet_mc3(variables["params"], stats, "")
    for k, v in mod.state_dict().items():
        if "running_" in k:
            _close(v, moved[k], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["layer1", "strided"])
def test_conv3d_fwd_lowering_gradients_match_flax(case):
    """``fwd_lowering='conv3d'``: a 3-D convolution forward whose gradients
    are the fold form's, as the JAX package's custom VJP."""
    import jax
    kernel, stride, padding = CASES[case]
    x = np.random.RandomState(2).randn(2, 9, 12, 12, 8).astype(np.float32)
    jmod = jct.DepthFoldedConv(6, kernel, stride, padding, mode="dfold",
                               use_bias=True, fwd_lowering="conv3d")
    variables = numpy_variables(jmod, jnp.asarray(x), seed=3)
    shape = jmod.apply(variables, jnp.asarray(x)).shape
    dy = np.random.RandomState(4).randn(*shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(jmod.apply({"params": p}, xx)
                                            * dy), argnums=(0, 1))(
        variables["params"], jnp.asarray(x))
    mod = load(ct.DepthFoldedConv(8, 6, kernel, stride, padding,
                                  mode="dfold", use_bias=True,
                                  fwd_lowering="conv3d"),
               migrate.conv(variables["params"], "")).train()
    xt = t(x).requires_grad_(True)
    (mod(xt) * t(dy)).sum().backward()
    want = migrate.conv(gp, "")
    _close(xt.grad, gx, rtol=1e-4, atol=1e-5)
    _close(mod.weight.grad, want["weight"], rtol=1e-4, atol=1e-4)
    _close(mod.bias.grad, want["bias"], rtol=1e-4, atol=1e-4)
