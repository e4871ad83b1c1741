"""``ops/kernels/conv3x3.py`` of the PyTorch port against the JAX package:
its plain version (which a CPU tensor takes, and which the CUDA kernel is
held against on the card by ``chip_smoke.py``) vs the Pallas kernel run in
interpret mode and vs ``conv3x3_reference``, at the cases of
``tests/test_conv3x3.py`` and at ragged shapes.  fp32, atol 1e-5 / rtol 1e-5
as there (only the order of the nine tap sums differs); bf16 against the
fp32 reference at 0.05 (input rounding only, accumulation is fp32)."""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from llmmil_tpu.ops.pallas.conv3x3 import conv3x3 as jax_conv3x3
from llmmil_tpu.ops.pallas.conv3x3 import conv3x3_reference
from llmmil_tpu_torch.ops import kernels
from llmmil_tpu_torch.ops.kernels import conv3x3, conv3x3_plain

from _torch_port_util import n, t

PORT = Path(__file__).resolve().parents[1] / "llmmil_tpu_torch"


def _data(nb=2, h=16, w=16, c=8, f=4, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(nb, h, w, c).astype(np.float32),
            (rs.randn(3, 3, c, f) * 0.1).astype(np.float32))


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(n(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("h,bh", [(16, 4), (16, 16), (10, 4)])
def test_plain_matches_interpreted_pallas_kernel(h, bh):
    x, k = _data(h=h)
    want = jax_conv3x3(jnp.asarray(x), jnp.asarray(k), bh, True)
    got = conv3x3_plain(t(x), t(k))
    assert got.shape == (2, h, 16, 4) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8, 4), (2, 10, 16, 8, 4),
                                   (3, 17, 13, 24, 40), (1, 5, 7, 3, 5),
                                   (1, 1, 1, 1, 1), (2, 4, 6, 64, 192)])
def test_wrapper_on_cpu_matches_reference(shape):
    nb, h, w, c, f = shape
    x, k = _data(nb, h, w, c, f, seed=1)
    want = conv3x3_reference(jnp.asarray(x), jnp.asarray(k))
    before = conv3x3.launches
    got = conv3x3(t(x), t(k))
    assert conv3x3.launches == before       # a CPU tensor launches nothing
    assert got.shape == (nb, h, w, f)
    _close(got, want)
    assert kernels.conv3x3 is conv3x3


def test_bf16_close_to_fp32_reference():
    x, k = _data()
    want = conv3x3_reference(jnp.asarray(x), jnp.asarray(k))
    got = conv3x3(t(x).to(torch.bfloat16), t(k).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, tol=0.05)


def test_bf16_plain_matches_interpreted_pallas_kernel():
    """Both round the same bf16 inputs, multiply exactly and sum in fp32;
    the order of the sums may move the result by one bf16 step (2^-8
    relative, outputs reach ~3): atol 2^-6."""
    x, k = _data(seed=2)
    want = jax_conv3x3(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(k, jnp.bfloat16), 4, True)
    got = conv3x3_plain(t(x).to(torch.bfloat16), t(k))   # fp32 k is cast
    np.testing.assert_allclose(n(got.float()), np.asarray(want, np.float32),
                               atol=2 ** -6, rtol=0)


def test_weight_is_cast_to_the_input_type():
    x, k = _data(seed=3)
    xb = t(x).to(torch.bfloat16)
    assert torch.equal(conv3x3_plain(xb, t(k)),
                       conv3x3_plain(xb, t(k).to(torch.bfloat16)))


@pytest.mark.parametrize("bad", [(5, 5, 8, 4), (3, 3, 7, 4), (3, 3, 8)])
def test_rejects_what_is_not_a_3x3_kernel_of_the_input(bad):
    x, _ = _data()
    with pytest.raises(ValueError, match="3×3"):
        conv3x3(t(x), torch.zeros(bad))
    with pytest.raises(ValueError, match="3×3"):
        conv3x3_plain(t(x), torch.zeros(bad))


def test_rejects_non_3x3_as_the_jax_package_does():
    x, _ = _data()
    with pytest.raises(ValueError, match="3×3"):
        jax_conv3x3(jnp.asarray(x), jnp.zeros((5, 5, 8, 4)), 4, True)


@pytest.fixture(scope="module")
def jax_grads():
    x, k = _data()
    dy = np.random.RandomState(1).randn(2, 16, 16, 4).astype(np.float32)

    def loss(x_, k_):
        return jnp.sum(conv3x3_reference(x_, k_) * dy)

    return dy, jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))


@pytest.mark.parametrize("wrt", ["x", "w"])
def test_plain_version_gradients_match_jax(wrt, jax_grads):
    """The plain version is differentiable by autograd (tolerance of
    ``tests/test_conv3x3.py::test_grads_match_xla``)."""
    x, k = _data()
    dy, (gx, gk) = jax_grads
    xt, kt = t(x).requires_grad_(True), t(k).requires_grad_(True)
    (conv3x3(xt, kt) * t(dy)).sum().backward()
    got, want = (xt.grad, gx) if wrt == "x" else (kt.grad, gk)
    _close(got, want, tol=1e-4)


class _OnTheCard:
    """Stands in for a CUDA tensor where there is no card."""
    is_cuda = True

    def __init__(self, shape, requires_grad=False):
        self.shape, self.requires_grad = torch.Size(shape), requires_grad

    def dim(self):
        return len(self.shape)


@pytest.mark.parametrize("x_grad,w_grad", [(True, False), (False, True)])
def test_cuda_tensor_that_requires_grad_raises(monkeypatch, x_grad, w_grad):
    """The backward kernels are not ported: no differentiating through the
    plain version, and no launch either."""
    mod = sys.modules["llmmil_tpu_torch.ops.kernels.conv3x3"]
    reached = []
    monkeypatch.setattr(mod, "_conv3x3_cuda",
                        lambda *a: reached.append("kernel"))
    monkeypatch.setattr(mod, "conv3x3_plain",
                        lambda *a: reached.append("plain"))
    x = _OnTheCard((2, 8, 8, 4), x_grad)
    w = _OnTheCard((3, 3, 4, 6), w_grad)
    with pytest.raises(NotImplementedError, match="Queue 2 rows 2 .* 5"):
        conv3x3(x, w)
    assert reached == []
    with torch.no_grad():                  # inference: the kernel, no error
        conv3x3(x, w)
    assert reached == ["kernel"]


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrapper decides by where the tensor lies, nothing else: the
    source holds no ``try`` and the CUDA branch only launches or raises."""
    src = (PORT / "ops" / "kernels" / "conv3x3.py").read_text()
    assert "try:" not in src and "except" not in src
    body = src.split("def conv3x3(")[1]
    assert body.index("if x.is_cuda:") < body.index("raise NotImplemented") \
        < body.index("return _conv3x3_cuda(x, w)") \
        < body.index("return conv3x3_plain(x, w)")
    cuda = src.split("def _conv3x3_cuda(")[1].split("def conv3x3(")[0]
    assert "conv3x3_plain" not in cuda and "F.conv" not in cuda
    assert cuda.index("raise RuntimeError") < cuda.index("launches += 1")


def test_kernel_source_calls_no_library():
    cu = (PORT / "csrc" / "conv3x3.cu").read_text()
    for lib in ("cudnn", "cublas", "cutlass", "torch/"):
        assert lib not in cu.lower(), lib
    assert "mma.sync.aligned.m16n8k16" in cu and 'extern "C" int conv3x3_fwd' in cu
    from llmmil_tpu_torch.ops.kernels import build
    assert build.library_path("conv3x3").name.startswith("libconv3x3_")
