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


def _kernel_module():
    import sys
    # the package re-exports the function under the submodule's name
    return sys.modules["llmmil_tpu_torch.ops.kernels.mil_pool"]


@pytest.mark.parametrize("l", [64, 512])
def test_packed_gates_layout_against_cat(l):
    """The bf16 kernel's B operand: [V | U] K-major, in two halves of 96
    columns, V's half-h columns then U's same columns."""
    mod = _kernel_module()
    rs = np.random.RandomState(3)
    wv, wu = (t(rs.randn(l, 192).astype(np.float32)) for _ in range(2))
    got = mod.pack_gates(wv, wu)
    cat = torch.cat([wv, wu], dim=1).t()               # (384, L)
    rows = [*range(0, 96), *range(192, 288), *range(96, 192), *range(288, 384)]
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.shape == (384, l)
    assert torch.equal(got, cat[rows].to(torch.bfloat16))
    # V's column j and U's column j sit 96 rows apart in one half
    for j in (0, 95, 96, 191):
        h, i = divmod(j, 96)
        assert torch.equal(got[192 * h + i], wv[:, j].to(torch.bfloat16))
        assert torch.equal(got[192 * h + 96 + i], wu[:, j].to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gate_operands_reused_then_rebuilt_after_in_place_update(
        dtype, monkeypatch):
    """Built once a version of V and U (as the model hands them: transposed
    views of the Dense weights, a new view each call), rebuilt after an
    in-place update such as an optimizer step."""
    mod = _kernel_module()
    monkeypatch.setattr(mil_pool, "gates", type(mil_pool.gates)())
    rs = np.random.RandomState(4)
    weight_v = t(rs.randn(192, 128).astype(np.float32))   # Dense: (D, L)
    weight_u = t(rs.randn(192, 128).astype(np.float32))
    first = mod._gate_operands(weight_v.t(), weight_u.t(), dtype)
    again = mod._gate_operands(weight_v.t(), weight_u.t(), dtype)
    assert again is first and len(mil_pool.gates) == 1
    with torch.no_grad():
        weight_v.add_(1.0)
    rebuilt = mod._gate_operands(weight_v.t(), weight_u.t(), dtype)
    assert rebuilt is not first and len(mil_pool.gates) == 1
    if dtype == torch.bfloat16:
        assert rebuilt[1] is None
        assert torch.equal(rebuilt[0],
                           mod.pack_gates(weight_v.t(), weight_u.t()))
    else:
        assert torch.equal(rebuilt[0], weight_v.t())
        assert torch.equal(rebuilt[1], weight_u.t())
        assert rebuilt[0].is_contiguous() and rebuilt[1].is_contiguous()
    # the entry holds V and U, so their memory cannot pass to a new tensor
    assert mil_pool.gates[next(iter(mil_pool.gates))][1][0] \
        .data_ptr() == weight_v.data_ptr()


def test_gate_cache_keeps_a_bounded_number_of_entries(monkeypatch):
    mod = _kernel_module()
    monkeypatch.setattr(mil_pool, "gates", type(mil_pool.gates)())
    for i in range(mod._GATE_CACHE + 3):
        w = torch.full((64, 192), float(i))
        mod._gate_operands(w, w + 1, torch.bfloat16)
    assert len(mil_pool.gates) == mod._GATE_CACHE


@pytest.mark.parametrize("case", ["rank", "dtype", "D", "L", "B", "tiles",
                                  "mask", "bias"])
def test_wrapper_checks_raise_before_the_library_loads(case, monkeypatch):
    """A shape or type the kernel does not take raises before anything is
    built or loaded (driven with CPU or meta tensors: only the checks run)."""
    mod = _kernel_module()

    def no_load(*a, **k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(mod, "load_library", no_load)
    monkeypatch.setattr(mil_pool, "launcher", None)
    b, n, l, d = 2, 70, 64, 192
    x = torch.zeros(b, n, l, dtype=torch.bfloat16)
    mask = torch.ones(b, n, dtype=torch.bool)
    wv, wu = torch.zeros(l, d), torch.zeros(l, d)
    bv, bu, ww, bw = (torch.zeros(d), torch.zeros(d), torch.zeros(d, 1),
                      torch.zeros(1))
    want = ValueError
    if case == "rank":
        x = x[0]
    elif case == "dtype":
        x, want = x.to(torch.float16), TypeError
    elif case == "D":
        wv = wu = torch.zeros(l, 64)
    elif case == "L":
        x = torch.zeros(b, n, 96, dtype=torch.bfloat16)
    elif case == "B":
        x = torch.empty(65536, 1, l, dtype=torch.bfloat16, device="meta")
    elif case == "tiles":
        x = torch.empty(2, 64 * (mod.BF16_MAX_TILES // 2) + 1, l,
                        dtype=torch.bfloat16, device="meta")
    elif case == "mask":
        mask = mask[:, :-1]
    elif case == "bias":
        bv = torch.zeros(d, dtype=torch.float64)
        want = TypeError
    with pytest.raises(want, match="mil_pool"):
        mod._mil_pool_cuda(x, mask, wv, bv, wu, bu, ww, bw)
    assert mil_pool.launcher is None
