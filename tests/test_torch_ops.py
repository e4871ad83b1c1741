"""Pure ops of the PyTorch port against their JAX counterparts: the same
numpy inputs through both, fp32, atol 1e-6 (the ops are elementwise maths
and short reductions; only the order of a sum can differ)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu import ops as jops
from llmmil_tpu_torch import ops as tops

from _torch_port_util import n, ragged_mask, t

ATOL = 1e-6


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(n(got), n(want), atol=atol, rtol=0)


@pytest.mark.parametrize("case", ["masked", "unmasked", "all_masked",
                                  "broadcast_mask", "axis1"])
def test_masked_softmax(case):
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 4, 11) * 3).astype(np.float32)
    mask = rs.rand(3, 4, 11) > 0.3
    axis = -1
    if case == "unmasked":
        mask = None
    elif case == "all_masked":
        mask[1] = False
    elif case == "broadcast_mask":
        mask = mask[:, :1]
    elif case == "axis1":
        axis = 1
    want = jops.masked_softmax(jnp.asarray(x),
                               None if mask is None else jnp.asarray(mask),
                               axis=axis)
    got = tops.masked_softmax(t(x), None if mask is None else t(mask),
                              dim=axis)
    _close(got, want)
    if case == "all_masked":
        assert np.all(n(got)[1] == 0.0)
        assert np.isfinite(n(got)).all()


@pytest.mark.parametrize("masked", [True, False])
def test_masked_mean(masked):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 9, 5).astype(np.float32)
    mask = ragged_mask(rs, 2, 9, low=0) if masked else None
    want = jops.masked_mean(jnp.asarray(x),
                            None if mask is None else jnp.asarray(mask))
    got = tops.masked_mean(t(x), None if mask is None else t(mask))
    _close(got, want)


@pytest.mark.parametrize("masked", [True, False])
def test_segment_mean_landmarks(masked):
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 12, 5).astype(np.float32)
    mask = rs.rand(2, 1, 12) > 0.4 if masked else None
    if masked:
        mask[0, 0, :3] = False            # one landmark with no valid token
    want = jops.segment_mean_landmarks(
        jnp.asarray(x), 4, None if mask is None else jnp.asarray(mask))
    got = tops.segment_mean_landmarks(
        t(x), 4, None if mask is None else t(mask))
    _close(got, want)


@pytest.mark.parametrize("length,dim", [(1, 512), (10, 512), (77, 64),
                                        (300, 512)])
def test_sinusoidal_pe(length, dim):
    want = jops.sinusoidal_pe(length, dim)
    got = tops.sinusoidal_pe(length, dim)
    assert got.shape == (length, dim) and got.dtype == torch.float32
    _close(got, want, atol=0)             # the same numpy table on both sides


def test_sinusoidal_pe_dtype_and_independence():
    a = tops.sinusoidal_pe(5, 16, dtype=torch.bfloat16)
    assert a.dtype == torch.bfloat16
    b = tops.sinusoidal_pe(5, 16)
    b += 1.0                              # must not write into the cache
    _close(tops.sinusoidal_pe(5, 16), jops.sinusoidal_pe(5, 16), atol=0)


def test_quick_gelu():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(tops.quick_gelu(t(x)), jops.quick_gelu(jnp.asarray(x)))


def _gate_params(rs, l, d, k):
    return [rs.randn(l, d).astype(np.float32) * 0.1,
            rs.randn(d).astype(np.float32) * 0.1,
            rs.randn(l, d).astype(np.float32) * 0.1,
            rs.randn(d).astype(np.float32) * 0.1,
            rs.randn(d, k).astype(np.float32) * 0.1,
            rs.randn(k).astype(np.float32) * 0.1]


@pytest.mark.parametrize("k", [1, 3])
def test_gated_attention_logits(k):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 13, 24).astype(np.float32)
    params = _gate_params(rs, 24, 16, k)
    want = jops.gated_attention_logits(jnp.asarray(x),
                                       *map(jnp.asarray, params))
    got = tops.gated_attention_logits(t(x), *map(t, params))
    _close(got, want)


@pytest.mark.parametrize("case", ["masked", "unmasked", "all_masked", "k3"])
def test_gated_attention_pool(case):
    rs = np.random.RandomState(4)
    x = rs.randn(2, 13, 24).astype(np.float32)
    params = _gate_params(rs, 24, 16, 3 if case == "k3" else 1)
    mask = None if case == "unmasked" else ragged_mask(rs, 2, 13)
    if case == "all_masked":
        mask[0] = False
    want_m, want_a = jops.gated_attention_pool(
        jnp.asarray(x), *map(jnp.asarray, params),
        mask=None if mask is None else jnp.asarray(mask))
    got_m, got_a = tops.gated_attention_pool(
        t(x), *map(t, params), mask=None if mask is None else t(mask))
    _close(got_m, want_m)
    _close(got_a, want_a)


def test_gated_attention_pool_nan_in_masked_rows():
    """Masked rows' values are zeroed: NaN there must not reach the pool."""
    rs = np.random.RandomState(5)
    x = rs.randn(1, 9, 24).astype(np.float32)
    params = _gate_params(rs, 24, 16, 1)
    mask = np.arange(9)[None] < 6
    clean, _ = tops.gated_attention_pool(t(x), *map(t, params), mask=t(mask))
    x[:, 6:] = np.nan
    dirty, att = tops.gated_attention_pool(t(x), *map(t, params),
                                           mask=t(mask))
    assert torch.equal(clean, dirty)
    assert torch.isfinite(att).all() and (att[..., 6:] == 0).all()
