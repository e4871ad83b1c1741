"""``ops/kernels/mil_pool.py`` of the PyTorch port against the JAX package:
its plain version (which a CPU tensor takes, and which the CUDA kernel is
held against on the card by ``chip_smoke.py``) vs the Pallas kernel run in
interpret mode and vs ``mil_pool_reference``.  Tolerances are those of
``tests/test_pallas.py``: pooled atol 1e-5, attention atol 1e-7, gradients
atol 1e-5 (fp32; only the order of the sums over N differs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu.ops.pallas import mil_pool as jax_mil_pool
from llmmil_tpu.ops.pallas import mil_pool_reference
from llmmil_tpu_torch.ops import kernels
from llmmil_tpu_torch.ops.kernels import (mil_pool, mil_pool_plain,
                                          resolve_use_kernel)

from _torch_port_util import n, ragged_mask, t


def _setup(B=2, N=700, L=256, D=192, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, L).astype(np.float32)
    mask = ragged_mask(rs, B, N)
    params = [(rs.randn(L, D) * 0.05).astype(np.float32),
              (rs.randn(D) * 0.05).astype(np.float32),
              (rs.randn(L, D) * 0.05).astype(np.float32),
              (rs.randn(D) * 0.05).astype(np.float32),
              (rs.randn(D, 1) * 0.05).astype(np.float32),
              (rs.randn(1) * 0.05).astype(np.float32)]
    return x, mask, params


@pytest.mark.parametrize("n_rows", [700, 130, 257])
def test_plain_matches_interpreted_pallas_kernel(n_rows):
    x, mask, params = _setup(N=n_rows)
    want_p, want_a = jax_mil_pool(jnp.asarray(x), jnp.asarray(mask),
                                  *map(jnp.asarray, params), 512, True)
    got_p, got_a = mil_pool_plain(t(x), t(mask), *map(t, params))
    np.testing.assert_allclose(n(got_p), n(want_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(got_a), n(want_a), atol=1e-7, rtol=0)
    assert got_a.shape == (2, n_rows) and got_p.shape == (2, 256)


@pytest.mark.parametrize("n_rows", [700, 130, 257])
def test_wrapper_on_cpu_matches_reference(n_rows):
    x, mask, params = _setup(N=n_rows, seed=1)
    want_p, want_a = mil_pool_reference(jnp.asarray(x), jnp.asarray(mask),
                                        *map(jnp.asarray, params))
    got_p, got_a = mil_pool(t(x), t(mask), *map(t, params))
    np.testing.assert_allclose(n(got_p), n(want_p), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(got_a), n(want_a), atol=1e-7, rtol=0)


def test_cpu_call_leaves_launch_counter_unchanged():
    x, mask, params = _setup(N=64, L=64, D=32)
    before = mil_pool.launches
    mil_pool(t(x), t(mask), *map(t, params))
    assert mil_pool.launches == before
    assert kernels.mil_pool is mil_pool


def test_nan_in_masked_rows_contributes_nothing():
    x, mask, params = _setup(N=130)
    clean_p, clean_a = mil_pool(t(x), t(mask), *map(t, params))
    x = x.copy()
    x[~mask] = np.nan
    dirty_p, dirty_a = mil_pool(t(x), t(mask), *map(t, params))
    assert torch.equal(clean_p, dirty_p) and torch.equal(clean_a, dirty_a)
    assert (dirty_a[t(~mask)] == 0).all()


def test_all_masked_bag_gives_zeros():
    x, mask, params = _setup(N=130)
    mask = mask.copy()
    mask[0] = False
    got_p, got_a = mil_pool(t(x), t(mask), *map(t, params))
    want_p, want_a = mil_pool_reference(jnp.asarray(x), jnp.asarray(mask),
                                        *map(jnp.asarray, params))
    assert (got_p[0] == 0).all() and (got_a[0] == 0).all()
    assert torch.isfinite(got_p).all() and torch.isfinite(got_a).all()
    np.testing.assert_allclose(n(got_p), n(want_p), atol=1e-5, rtol=0)


def test_bf16_bag_is_computed_in_fp32():
    """The plain version upcasts: a bf16 bag gives the result of the same
    bf16-rounded values in fp32 (what the kernel is held against)."""
    x, mask, params = _setup(N=64, L=64, D=32)
    xb = t(x).to(torch.bfloat16)
    got_p, got_a = mil_pool_plain(xb, t(mask), *map(t, params))
    want_p, want_a = mil_pool_plain(xb.float(), t(mask), *map(t, params))
    assert got_p.dtype == torch.float32 and got_a.dtype == torch.float32
    assert torch.equal(got_p, want_p) and torch.equal(got_a, want_a)


@pytest.fixture(scope="module")
def jax_grads():
    x, mask, params = _setup(B=1, N=300, L=128, D=64)

    def loss(xj, wvj):
        p = [wvj] + [jnp.asarray(a) for a in params[1:]]
        return mil_pool_reference(xj, jnp.asarray(mask), *p)[0].sum()

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                          jnp.asarray(params[0]))


@pytest.mark.parametrize("wrt", ["x", "wv"])
def test_gradients_match_jax(wrt, jax_grads):
    x, mask, params = _setup(B=1, N=300, L=128, D=64)
    gx, gwv = jax_grads
    xt = t(x).requires_grad_(True)
    pt = [t(a).requires_grad_(True) for a in params]
    mil_pool(xt, t(mask), *pt)[0].sum().backward()
    got, want = (xt.grad, gx) if wrt == "x" else (pt[0].grad, gwv)
    np.testing.assert_allclose(n(got), n(want), atol=1e-5, rtol=0)


def test_autograd_function_backward_recomputes_through_plain(monkeypatch):
    """The CUDA path's backward (recompute through the plain version) gives
    the plain version's own gradients; driven here with the kernel launch
    replaced by the plain forward, since the kernel itself needs the card."""
    import sys
    # the package re-exports the function under the submodule's name
    mod = sys.modules["llmmil_tpu_torch.ops.kernels.mil_pool"]

    x, mask, params = _setup(B=1, N=40, L=64, D=32)
    xt = t(x).requires_grad_(True)
    pt = [t(a).requires_grad_(True) for a in params]
    monkeypatch.setattr(mod, "_mil_pool_cuda", lambda *a: tuple(
        o.detach() for o in mil_pool_plain(*a)))
    pooled, attn = mod._MilPoolFunction.apply(xt, t(mask), *pt)
    (pooled.sum() + (attn ** 2).sum()).backward()
    got = [xt.grad] + [p.grad for p in pt]

    xr = t(x).requires_grad_(True)
    pr = [t(a).requires_grad_(True) for a in params]
    pooled, attn = mil_pool_plain(xr, t(mask), *pr)
    (pooled.sum() + (attn ** 2).sum()).backward()
    for g, w in zip(got, [xr.grad] + [p.grad for p in pr]):
        np.testing.assert_allclose(n(g), n(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("val,raw_bag,want", [
    ("auto", True, True), ("auto", False, False), (True, False, True),
    (False, True, False), ("true", False, True), ("false", True, False),
    (" Auto ", True, True), ("on", False, True), (0, True, False)])
def test_resolve_use_kernel(val, raw_bag, want):
    """The JAX rule (``resolve_use_pallas``) without its backend gate: the
    tensor's device decides whether the kernel launches."""
    assert resolve_use_kernel(val, raw_bag) is want


def test_resolve_use_kernel_agrees_with_jax_rule_on_tpu(monkeypatch):
    import llmmil_tpu.ops.pallas as pk
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for val in ("auto", True, False, "true", "false", "yes", "0"):
        for raw in (True, False):
            assert resolve_use_kernel(val, raw) \
                == pk.resolve_use_pallas(val, raw_bag=raw)
