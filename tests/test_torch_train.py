"""The training slice of the PyTorch port against the JAX package.

The train step: the tiny tri-modal flagship of ``tests/test_torch_aggregator.py``
(MC3-18 ``ct_layers=[1,1,1,1]``, one TwoWay block, tiny CLIP, ABMIL through
the ``mil_pool`` route), fp32, dropout off on both sides (flax's ``Dropout``
patched to the identity for the JAX step, the port's dropout modules in
eval mode), the same numpy weights through ``from_flax`` and the same numpy
batch.  The JAX side runs ``make_train_step`` once (its ``conv3x3`` Pallas
kernels interpreted); a first optax stage records the gradients the step
computes.  The port's step must give every loss term (rtol 1e-5), every
gradient (rtol 1e-4, atol 1e-5 of the tensor's largest |gradient|, at least
1e-8: only the order of the sums differs), the parameters after one SGD and
one Adam update and the BatchNorm running statistics, with ``ct_remat``
'none' and 'all'.  The CT trunk's gradients are held at atol 2e-2 of their
max instead: the JAX package's own fp32 trunk gradients on the CPU are that
far from an fp64 evaluation of the same step (``_grad_atol``); the trunk's
VJP alone is held at 1e-4 in ``tests/test_torch_ct.py``.

Then the pieces around the step, each against its JAX counterpart where one
exists: losses, metrics, the schedule, freezing, ``grad_accum``, ``data_echo``
and checkpoints with the mid-epoch resume.
"""

import os
import signal
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from llmmil_tpu.config import Config as JConfig
from llmmil_tpu.models import build_model as jax_build_model
from llmmil_tpu.train import losses as jlosses
from llmmil_tpu.train import metrics as jmetrics
from llmmil_tpu.train import optim as joptim
from llmmil_tpu.train.state import TrainState as JTrainState
from llmmil_tpu.train.step import make_train_step as jax_make_train_step
from llmmil_tpu_torch import Config
from llmmil_tpu_torch.data import BatchLoader, SyntheticCohort
from llmmil_tpu_torch.models import build_model
from llmmil_tpu_torch.models.abmil import ABMIL
from llmmil_tpu_torch.models.migrate import from_flax, grads_from_flax
from llmmil_tpu_torch.train import checkpoint as ckpt
from llmmil_tpu_torch.train import create_train_state, make_train_step
from llmmil_tpu_torch.train import losses, metrics, optim
from llmmil_tpu_torch.train.loop import fit

from _torch_port_util import ct_variables, load, n, numpy_variables, t

STEPS = 10
KW = dict(modality=["CT", "pathology"], model_CT="resnetMC3_18",
          model_pathology="ABMIL", model_CI="CLIP", CI_input_version="text",
          CI_prompt_version="devided", aggregator="ABMIL",
          loss_point="CT-Pth-Last", learnablePrompt=1, n_ctx=4,
          compute_dtype="float32", spacing=[2.0, 2.0, 2.5], clip_vocab=128,
          clip_context=16, clip_width=32, clip_heads=4, clip_layers=1,
          clip_embed=32, twoway_depth=1, ct_layers=[1, 1, 1, 1],
          bag_buckets=[48], use_pallas=True, ct_remat="none")
TERMS = ("loss", "loss_CT", "loss_Pth", "loss_Last")


def _batch(seed=42):
    rs = np.random.RandomState(seed)
    toks = rs.randint(1, 126, (2, 10, 16))
    toks[..., -1] = 127
    return {"input_CT": rs.rand(2, 8, 32, 32, 1).astype(np.float32),
            "input_pathology": rs.randn(2, 48, 768).astype(np.float32),
            "mask_pathology": np.arange(48)[None].repeat(2, 0) < 40,
            "input_CI": toks.astype(np.int32),
            "label": np.eye(2, dtype=np.float32)[[0, 1]]}


def _torch_batch(batch):
    return {k: t(v).long() if v.dtype == np.int32 else t(v)
            for k, v in batch.items()}


def _record_grads():
    """An optax stage that passes the updates on and keeps them as its
    state: the gradients the JAX step computed."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def jax_side():
    import flax.linen as fnn
    from flax.linen import normalization
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    # flax's BatchNorm takes the variance as E[x²] − E[x]² by default; where
    # a channel's mean is large against its spread (the trunk's maps after
    # a ReLU) that loses most of fp32's digits, and its gradient with them:
    # the trunk's weight gradients of this batch come out 2.6 % of a
    # tensor's max off an fp64 evaluation, the port's (F.batch_norm,
    # centred variance) 2e-6.  The JAX side computes the centred variance.
    real_stats = normalization._compute_stats
    mp.setattr(normalization, "_compute_stats",
               lambda *a, **k: real_stats(*a, **dict(
                   k, use_fast_variance=False)))
    try:
        jcfg = JConfig(**dict(KW, ct_conv_backend="pallas_interpret"))
        batch = _batch()
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jmodel = jax_build_model(jcfg)
        variables = ct_variables(numpy_variables(
            jmodel, {k: v for k, v in jb.items() if k != "label"}))
        tx = optax.chain(_record_grads(),
                         joptim.make_optimizer(jcfg, variables["params"],
                                               STEPS))
        state = JTrainState.create(apply_fn=jmodel.apply,
                                   params=variables["params"], tx=tx,
                                   batch_stats=variables["batch_stats"])
        new, jm = jax_make_train_step(jcfg, donate=False)(
            state, jb, jax.random.PRNGKey(0))
        grads = new.opt_state[0]
        adam = JTrainState.create(
            apply_fn=jmodel.apply, params=variables["params"],
            tx=joptim.make_optimizer(jcfg.replace(learnablePrompt=0),
                                     variables["params"], STEPS),
            batch_stats=variables["batch_stats"])
        # one jitted update: op by op, optax compiles each leaf's ops anew
        adam = jax.jit(lambda s, g: s.apply_gradients(grads=g))(adam, grads)
        np_tree = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        return {"variables": variables, "batch": batch,
                "grads": np_tree(grads),
                "terms": {k: float(jm[k]) for k in TERMS},
                "stats": np_tree(new.batch_stats),
                "sgd": np_tree(new.params), "adam": np_tree(adam.params)}
    finally:
        mp.undo()


def dropout_off(model):
    model.train()
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, ABMIL)):
            m.eval()
    return model


def _port_step(jax_side, opt="sgd", remat="none", **kw):
    cfg = Config(**dict(KW, ct_remat=remat, ct_conv_backend="pallas", **kw))
    model = load(build_model(cfg, device="cpu"),
                 from_flax(jax_side["variables"], cfg))
    ocfg = cfg if opt == "sgd" else cfg.replace(learnablePrompt=0)
    state = create_train_state(model, ocfg, steps_per_epoch=STEPS)
    dropout_off(model)
    grads = {}
    real = state.optimizer.step

    def capture():
        grads.update({k: p.grad.detach().clone()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
        return real()

    state.optimizer.step = capture
    state, m = make_train_step(cfg)(state, _torch_batch(jax_side["batch"]))
    return cfg, state, m, grads


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# Gradients: rtol 1e-4 and atol 1e-5 of the tensor's largest |gradient|
# (only the order of the sums differs; single elements of the two fp32
# evaluations sit 2e-6 of the max apart), with a floor of 1e-8 for the key
# biases and the attention bias, whose gradients are 0 in exact arithmetic
# (a softmax ignores a shift) and 1e-13 to 3e-9 here.  The CT trunk's weight
# gradients take atol 2e-2 of their max: the JAX package's own are that far
# from an fp64 evaluation of the same step (its CPU convolution gradients;
# measured 8.7e-3 at layer1.0.conv2, the port's 2e-6), so the reference
# cannot hold them closer; the trunk's VJP of one upstream gradient is held
# at 1e-4 in tests/test_torch_ct.py.
TRUNK = "extractor_CT."


def _grad_atol(name, top):
    return 2e-2 * top if name.startswith(TRUNK) else max(1e-5 * top, 1e-8)


@pytest.mark.parametrize("opt,remat", [("sgd", "none"), ("sgd", "all"),
                                       ("adam", "none"), ("adam", "all")])
def test_train_step_matches_jax(jax_side, opt, remat):
    cfg, state, m, grads = _port_step(jax_side, opt, remat)
    for k in TERMS:
        _close(m[k], jax_side["terms"][k], rtol=1e-5)
    want_grads = grads_from_flax(jax_side["grads"], cfg)
    assert set(grads) <= set(want_grads)
    atol = {}
    for k, want in want_grads.items():
        top = float(np.abs(n(want)).max())
        atol[k] = _grad_atol(k, top)
        if k not in grads:      # stop_gradient in JAX, detached here
            assert top == 0.0, k
            continue
        _close(grads[k], want, rtol=1e-4, atol=atol[k], what=k)
    want = from_flax({"params": jax_side[opt],
                      "batch_stats": jax_side["stats"]}, cfg)
    got = state.model.state_dict()
    # one update: SGD moves a parameter by lr·(g + wd·p) (lr 1e-3), so by
    # the gradients' tolerance times lr; Adam by lr·m̂/(√v̂ + ε) ≈ ±lr (lr
    # 1e-5) wherever |g| ≫ ε, so an element whose gradient lies within ten
    # tolerances of 0 may move either way (2·lr), the others within 1e-3·lr
    lr = 1e-3 if opt == "sgd" else 1e-5
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            _close(got[k], w, rtol=1e-5, atol=1e-6, what=k)
            continue
        g = np.abs(n(want_grads[k]))
        if opt == "sgd":
            step_tol = lr * (atol[k] + 1e-4 * g.max())
        else:
            step_tol = np.where(g > 10 * atol[k], 1e-3 * lr, 2 * lr)
        diff = np.abs(n(got[k]) - np.asarray(w))
        bad = diff > 1e-8 + step_tol + 1e-6 * np.abs(np.asarray(w))
        assert not bad.any(), (k, diff[bad][:4], g[bad][:4])
    assert state.step == 1 and state.optimizer.count == 1


def test_remat_moves_the_running_statistics_once(jax_side):
    """ct_remat='all' recomputes every block in the backward, BatchNorm
    included: the running statistics and the gradients equal those of
    'none' bit for bit."""
    _, a, _, ga = _port_step(jax_side, remat="none")
    _, b, _, gb = _port_step(jax_side, remat="all")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        if "running_" in k:
            assert torch.equal(sa[k], sb[k]), k
    for k in ga:
        torch.testing.assert_close(ga[k], gb[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("remat,stages", [
    ("all", [0, 1, 2, 3]), ("early", [0, 1]), ("layer2", [1]),
    ("none", []), ("auto", [1])])
def test_remat_modes_name_the_jax_stages(monkeypatch, remat, stages):
    from llmmil_tpu_torch.models import ct_mc3
    seen = []
    real = ct_mc3._rematerialised
    monkeypatch.setattr(ct_mc3, "_rematerialised",
                        lambda block, x: seen.append(block) or real(block, x))
    cfg = Config(**dict(KW, ct_remat=remat, batch_size=1))
    model = build_model(cfg, device="cpu").train()
    trunk = model.extractor_CT.model
    out = trunk(torch.rand(1, 4, 16, 16, 3))
    out.sum().backward()
    want = [b for i in stages for b in getattr(trunk, f"layer{i + 1}")]
    assert [id(b) for b in seen] == [id(b) for b in want]
    seen.clear()
    with torch.no_grad():                  # nothing kept, nothing recomputed
        trunk(torch.rand(1, 4, 16, 16, 3))
    assert seen == []


def test_bad_remat_mode_is_refused():
    with pytest.raises(ValueError, match="ct_remat 'sometimes'"):
        build_model(Config(**dict(KW, ct_remat="sometimes")), device="cpu")


# ------------------------------------------------------------ optimizer --

def _toy(seed=0):
    """A module whose parameters a flax tree can name the same way."""
    g = torch.Generator().manual_seed(seed)
    m = torch.nn.Module()
    m.extractor_CT = torch.nn.Linear(3, 2)
    m.fc = torch.nn.Linear(2, 2)
    for p in m.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=g))
    return m


def _toy_tree(m):
    return {name: {"weight": m_.weight.detach().numpy().copy(),
                   "bias": m_.bias.detach().numpy().copy()}
            for name, m_ in (("extractor_CT", m.extractor_CT), ("fc", m.fc))}


@pytest.mark.parametrize("learnable,accum,freeze", [
    (1, 1, False), (0, 1, False), (1, 2, False), (0, 3, False),
    (1, 1, True), (0, 2, True)])
def test_optimizer_matches_optax(learnable, accum, freeze):
    """SGD / Adam with coupled decay 1e-7, ``MultiSteps`` averaging and
    ``set_to_zero`` freezing, fed the same gradients for six calls."""
    kw = dict(modality=["CT", "pathology"], learnablePrompt=learnable,
              grad_accum=accum, schedule=[2], cos=False)
    if freeze:
        kw.update(pretrainedExt_CT=1, pretrainedExt_freeze=1)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    model = _toy()
    opt = optim.Optimizer(cfg, model, steps_per_epoch=2)
    params = _toy_tree(model)
    tx = joptim.make_optimizer(jcfg, params, steps_per_epoch=2)
    ostate = tx.init(params)
    rs = np.random.RandomState(1)
    for call in range(6):
        g = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32),
                         params)
        for name, m_ in (("extractor_CT", model.extractor_CT),
                         ("fc", model.fc)):
            for key in ("weight", "bias"):
                p = getattr(m_, key)
                if p.requires_grad:
                    p.grad = t(g[name][key])
        applied = opt.step()
        opt.zero_grad()
        upd, ostate = tx.update(g, ostate, params)
        params = optax.apply_updates(params, upd)
        assert applied == ((call + 1) % accum == 0)
        for name, m_ in (("extractor_CT", model.extractor_CT),
                         ("fc", model.fc)):
            for key in ("weight", "bias"):
                _close(getattr(m_, key), params[name][key], rtol=1e-6,
                       atol=1e-7)
    frozen = [p for p in model.extractor_CT.parameters()]
    assert all(not p.requires_grad for p in frozen) == freeze
    held = {id(p) for p in opt.params}
    assert all((id(p) in held) != freeze for p in frozen)
    assert opt.count == 6 // accum


@pytest.mark.parametrize("kw", [
    dict(cos=False, schedule=[2, 4]), dict(cos=True, n_epochs=5),
    dict(cos=False, schedule=[3], learnablePrompt=0, num_classes=3),
    dict(cos=True, n_epochs=4, learnablePrompt=0)])
@pytest.mark.parametrize("steps_per_epoch,accum", [(3, 1), (6, 2), (1, 4)])
def test_schedule_matches_jax_across_epochs(kw, steps_per_epoch, accum):
    cfg = Config(**dict(kw, grad_accum=accum))
    jcfg = JConfig(**dict(kw, grad_accum=accum))
    assert optim.effective_lr(cfg) == joptim.effective_lr(jcfg)
    spe = max(steps_per_epoch // accum, 1)
    jsched = joptim.make_lr_schedule(jcfg, spe)
    opt = optim.Optimizer(cfg, _toy(), steps_per_epoch=steps_per_epoch)
    for count in range(6 * spe + 1):
        np.testing.assert_allclose(opt.schedule(count),
                                   float(jsched(count)), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(), dict(pretrainedExt_CT=1), dict(pretrainedExt_CT=1,
                                           pretrainedExt_freeze=0),
    dict(pretrainedExt_CT=1, pretrainedExt_pathology=1, pretrainedExt_CI=1,
         modality=["CT", "pathology", "CI"]),
    dict(pretrainedExt_CT=1, modality=["pathology"])])
def test_frozen_branches_agree_with_jax(kw):
    assert optim.frozen_prefixes_from_config(Config(**kw)) \
        == joptim.frozen_prefixes_from_config(JConfig(**kw))


def test_frozen_trunk_keeps_its_weights_but_moves_its_statistics(jax_side):
    """``pretrainedExt_freeze``: no update, no decay, no optimizer state
    for the CT trunk, yet its BatchNorm statistics move (flax replaces
    ``batch_stats`` whole), so the trunk is not put in eval mode."""
    cfg = Config(**dict(KW, pretrainedExt_CT=1, ct_conv_backend="pallas"))
    model = load(build_model(cfg, device="cpu"),
                 from_flax(jax_side["variables"], cfg))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, cfg, steps_per_epoch=STEPS)
    dropout_off(model)
    state, _ = make_train_step(cfg)(state, _torch_batch(jax_side["batch"]))
    after = model.state_dict()
    trunk = [k for k in after if k.startswith("extractor_CT.")]
    for k in trunk:
        if "running_" in k:
            assert not torch.equal(after[k], before[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(after[k], before[k]), k
    assert not torch.equal(after["fc.1.weight"], before["fc.1.weight"])
    assert not any(n_.startswith("extractor_CT.")
                   for n_ in state.optimizer.names)
    assert len(state.optimizer.inner.state) == 0       # plain SGD
    # JAX: the same sets of frozen and trained leaves
    labels = joptim.freeze_label_tree(jax_side["variables"]["params"],
                                      ["extractor_CT"])
    frozen = grads_from_flax(jax.tree.map(
        lambda lab, p: np.full(np.shape(p), lab == "frozen", np.float32),
        labels, jax_side["variables"]["params"]), cfg)
    assert sorted(k for k, v in frozen.items() if float(v.max()) == 1.0) \
        == sorted(k for k, p in model.named_parameters()
                  if not p.requires_grad)


@pytest.mark.parametrize("field,item", [
    ("pp_axis", "item 10"), ("tp_axis", "item 10"),
    ("ct_shard_axis", "item 10"), ("moe_experts", "item 5")])
def test_unported_step_modes_raise(field, item):
    value = 4 if field == "moe_experts" else "model"
    with pytest.raises(NotImplementedError, match=item):
        make_train_step(Config(**{field: value}))


# --------------------------------------------------- losses and metrics --

@pytest.mark.parametrize("num_classes,loss,point", [
    (2, "BCE", "CT-Pth-Last"), (2, "BCE+textCosSim", "CT-Pth-Last"),
    (2, "BCE", "Last"), (3, "BCE+textCosSim", "CT-Pth-Last")])
def test_multihead_loss_matches_jax(num_classes, loss, point):
    rs = np.random.RandomState(num_classes)
    out = {k: rs.rand(4, num_classes).astype(np.float32)
           for k in ("probs", "probs_CT", "probs_Pth")}
    out["probs"][0, 0] = 1.0                      # the clip at 1 - 1e-7
    out.update(emb_CT2CI=rs.randn(4, 3, 8).astype(np.float32),
               emb_Pth2CI=rs.randn(4, 5, 8).astype(np.float32))
    y = np.eye(num_classes, dtype=np.float32)[rs.randint(0, num_classes, 4)]
    want = jlosses.multihead_loss({k: jnp.asarray(v) for k, v in out.items()},
                                  jnp.asarray(y), point, loss, num_classes)
    got = losses.multihead_loss({k: t(v) for k, v in out.items()}, t(y),
                                point, loss, num_classes)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], rtol=1e-6, atol=1e-7)


def test_other_losses_match_jax():
    rs = np.random.RandomState(3)
    a, b = rs.randn(5, 8).astype(np.float32), rs.randn(5, 8).astype(np.float32)
    for target in (1, -1):
        _close(losses.cosine_embedding_loss(t(a), t(b), target, 0.1),
               jlosses.cosine_embedding_loss(jnp.asarray(a), jnp.asarray(b),
                                             target, 0.1), 1e-6, 1e-7)
    _close(losses.clip_contrastive_loss(t(a), t(b)),
           jlosses.clip_contrastive_loss(jnp.asarray(a), jnp.asarray(b)),
           1e-5, 1e-6)
    _close(losses.ce_as_torch(t(a), t(np.eye(8, dtype=np.float32)[:5])),
           jlosses.ce_as_torch(jnp.asarray(a),
                               jnp.eye(8, dtype=jnp.float32)[:5]), 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 2, 40)
    s = np.round(rs.rand(40), 1)                   # ties
    for fn in ("roc_curve", "roc_auc", "youden_threshold"):
        got, want = getattr(metrics, fn)(y, s), getattr(jmetrics, fn)(y, s)
        for g, w in zip(np.atleast_1d(got) if fn != "roc_curve" else got,
                        np.atleast_1d(want) if fn != "roc_curve" else want):
            np.testing.assert_array_equal(g, w)
    y3 = rs.randint(0, 3, 40)
    p3 = rs.dirichlet(np.ones(3), 40)
    assert metrics.roc_auc_ovo_macro(y3, p3) \
        == jmetrics.roc_auc_ovo_macro(y3, p3)
    preds = rs.randint(0, 3, 40)
    for avg in ("binary", "macro"):
        np.testing.assert_array_equal(
            metrics.precision_recall(y3, preds, avg),
            jmetrics.precision_recall(y3, preds, avg))
    assert metrics.accuracy_onehot(p3, np.eye(3)[y3]) \
        == jmetrics.accuracy_onehot(p3, np.eye(3)[y3])


# ------------------------------------------------- loop and checkpoints --

def _loop_cfg(tmp_path, **kw):
    base = dict(modality=["pathology"], model_pathology="ABMIL",
                aggregator="ABMIL", model_CI="simpleFCs_v1",
                CI_input_version="v1", loss_point="Last",
                compute_dtype="float32", learnablePrompt=0, batch_size=4,
                bag_buckets=[128, 256, 512], save_dir=str(tmp_path),
                n_epochs=1, log_every=100, twoway_depth=1, device_prefetch=0,
                num_workers=0)
    base.update(kw)
    return Config(**base)


class _Recorder:
    """Loader wrapper that records the IDs of every batch and can send
    SIGTERM once it has handed out ``kill_after`` batches."""

    def __init__(self, loader, kill_after=None):
        self.loader, self.seen, self.kill_after = loader, [], kill_after

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, e):
        self.loader.set_epoch(e)

    def skip_next(self, k):
        self.loader.skip_next(k)

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if i == self.kill_after:
                os.kill(os.getpid(), signal.SIGTERM)
            self.seen.append(tuple(b["ID"]))
            yield b


def test_mid_epoch_resume_covers_each_batch_exactly_once(tmp_path):
    """Preemption mid-epoch, then ``resume``: across the two runs every
    batch of the epoch's order is trained once (as the JAX package's
    ``tests/test_prefetch_preempt.py``)."""
    cfg = _loop_cfg(tmp_path)
    syn = SyntheticCohort(cfg, n_per_hospital=8, seed=33)

    def make_loader():
        return BatchLoader(syn.dataset(cfg, "train"), 4, shuffle=True,
                           drop_last=True, prefetch=0)

    full = [tuple(b["ID"]) for b in make_loader()]
    assert len(full) >= 3
    vl = BatchLoader(syn.dataset(cfg, "valid"), 4, prefetch=0)
    r1 = _Recorder(make_loader(), kill_after=1)
    s1 = fit(cfg, r1, vl, device="cpu")
    assert s1.get("preempted") is True
    raw = ckpt.load_checkpoint(s1["save_dir"])
    assert raw["epoch"] == 0 and raw["batch_in_epoch"] == len(r1.seen) \
        == raw["step"]
    r2 = _Recorder(make_loader())
    s2 = fit(cfg.replace(resume=os.path.join(s1["save_dir"],
                                             "checkpoint_last.pt")),
             r2, vl, device="cpu")
    assert s2.get("preempted") is None
    assert r1.seen + r2.seen == full
    assert np.isfinite(s2["train"]["loss"])
    assert ckpt.load_checkpoint(s2["save_dir"])["epoch"] == 1


def test_resumed_step_equals_the_uninterrupted_one(tmp_path, jax_side):
    """A checkpoint, resumed into a freshly built model, gives the next
    step bit for bit (dropout on: its generator follows the step count)."""
    cfg = Config(**dict(KW, ct_conv_backend="pallas", grad_accum=2,
                        learnablePrompt=1))
    ocfg = cfg.replace(learnablePrompt=0)                 # Adam: has state
    batch = _torch_batch(jax_side["batch"])
    step = make_train_step(cfg)
    state = create_train_state(build_model(cfg, device="cpu"), ocfg)
    state, _ = step(state, batch)                         # one mini-step
    path = ckpt.save_checkpoint(state, str(tmp_path), 0, next_epoch=0,
                                batch_in_epoch=1)
    state, m1 = step(state, batch)
    fresh = create_train_state(build_model(cfg, device="cpu", seed=9), ocfg)
    fresh, epoch, start = ckpt.resume(fresh, path)
    assert (epoch, start, fresh.step) == (0, 1, 1)
    fresh, m2 = step(fresh, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    a, b = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert fresh.optimizer.count == state.optimizer.count == 1


def test_async_checkpoint_writes_what_the_sync_one_writes(tmp_path):
    cfg = _loop_cfg(tmp_path)
    state = create_train_state(build_model(cfg, device="cpu"), cfg)
    sync = ckpt.save_checkpoint(state, str(tmp_path), 3, is_best=True)
    saver = ckpt.AsyncCheckpointer()
    (tmp_path / "a").mkdir()
    path = saver.save_checkpoint(state, str(tmp_path / "a"), 3, is_best=True)
    saver.wait()
    a, b = ckpt.load_checkpoint(sync), ckpt.load_checkpoint(path)
    assert a["epoch"] == b["epoch"] == 4
    assert all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
    assert ckpt.load_checkpoint(str(tmp_path / "a"))["epoch"] == 4  # best


def test_restore_branch_and_restore_for_eval(tmp_path):
    cfg = _loop_cfg(tmp_path)
    src = create_train_state(build_model(cfg, device="cpu", seed=1), cfg)
    path = ckpt.save_checkpoint(src, str(tmp_path), 0)
    dst = create_train_state(build_model(cfg, device="cpu", seed=2), cfg)
    s = src.model.state_dict()
    d0 = {k: v.clone() for k, v in dst.model.state_dict().items()}
    ckpt.restore_branch(dst, path, "fc_pathology")
    d = dst.model.state_dict()
    for k in d:
        want = s[k] if k.startswith("fc_pathology.") else d0[k]
        assert torch.equal(d[k], want), k
    assert not torch.equal(s["fc.1.weight"], d["fc.1.weight"])
    other = create_train_state(build_model(cfg, device="cpu", seed=3),
                               cfg.replace(learnablePrompt=1))
    ckpt.restore_for_eval(other, path)              # SGD state vs Adam's
    o = other.model.state_dict()
    assert all(torch.equal(s[k], o[k]) for k in s)


def test_data_echo_and_schedule_horizon(tmp_path):
    """``data_echo`` applies each loaded batch that many times, and the
    schedule's horizon counts applications."""
    cfg = _loop_cfg(tmp_path, data_echo=2, schedule=[1])
    syn = SyntheticCohort(cfg, n_per_hospital=4, seed=5)
    tl = BatchLoader(syn.dataset(cfg, "train"), 4, prefetch=0)
    vl = BatchLoader(syn.dataset(cfg, "valid"), 4, prefetch=0)
    summary = fit(cfg, tl, vl, device="cpu")
    state = summary["state"]
    assert state.step == 2 * len(tl) == state.optimizer.count
    assert summary["train"]["n_batches"] == len(tl)
    # epoch 0 ends after 2·len(tl) applications: the milestone at epoch 1
    assert state.optimizer.schedule(2 * len(tl) - 1) == 1e-5
    assert state.optimizer.schedule(2 * len(tl)) == pytest.approx(1e-6)


def test_fit_wants_a_card_unless_cpu_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _loop_cfg(tmp_path)
    syn = SyntheticCohort(cfg, n_per_hospital=4, seed=5)
    tl = BatchLoader(syn.dataset(cfg, "train"), 4, prefetch=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit(cfg, tl, tl)
    from llmmil_tpu_torch.train.__main__ import main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--synthetic", "--modality", "['pathology']",
              "--save_dir", str(tmp_path)])


def test_cli_trains_on_the_cpu_when_asked(tmp_path, capsys):
    from llmmil_tpu_torch.train.__main__ import main
    summary = main(["--cpu", "--synthetic", "--modality", "['pathology']",
                    "--model_pathology", "ABMIL", "--aggregator", "ABMIL",
                    "--loss_point", "Last", "--compute_dtype", "float32",
                    "--learnablePrompt", "0", "--twoway_depth", "1",
                    "--bag_buckets", "[512]", "--n_epochs", "1",
                    "--batch_size", "8", "--num_workers", "2",
                    "--save_dir", str(tmp_path)])
    assert np.isfinite(summary["train"]["loss"]) \
        and 0.0 <= summary["best_auc"] <= 1.0
    assert "best valid AUC" in capsys.readouterr().out
    assert os.path.exists(os.path.join(summary["save_dir"],
                                       "checkpoint_last.pt"))
    assert sys.modules["llmmil_tpu_torch.train.loop"].fit is fit
