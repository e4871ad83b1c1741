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
    """Where autograd records, a CUDA tensor goes through the autograd
    Function (forward kernel, backward kernels), never through the plain
    version; in inference it goes straight to the forward kernel.  Whatever
    the Function's launch raises reaches the caller."""
    mod = sys.modules["llmmil_tpu_torch.ops.kernels.conv3x3"]
    reached = []

    def launch(*a):
        reached.append("kernel")
        raise RuntimeError("conv3x3: kernel launch failed")

    monkeypatch.setattr(mod, "_launch_fwd", launch)
    monkeypatch.setattr(mod, "conv3x3_plain",
                        lambda *a: reached.append("plain"))
    real_apply = mod._Conv3x3Function.apply
    monkeypatch.setattr(mod._Conv3x3Function, "apply",
                        lambda *a: reached.append("function") or launch(*a))
    x = _OnTheCard((2, 8, 8, 4), x_grad)
    w = _OnTheCard((3, 3, 4, 6), w_grad)
    with pytest.raises(RuntimeError, match="launch failed"):
        conv3x3(x, w)
    assert reached == ["function", "kernel"]
    reached.clear()
    with torch.no_grad():                  # inference: the kernel itself
        with pytest.raises(RuntimeError, match="launch failed"):
            conv3x3(x, w)
    assert reached == ["kernel"]
    assert real_apply is not None


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers decide by where the tensor lies, nothing else: the
    source holds no ``try`` and the CUDA branches only launch or raise."""
    src = (PORT / "ops" / "kernels" / "conv3x3.py").read_text()
    assert "try:" not in src and "except" not in src
    body = src.split("def conv3x3(")[1]
    assert body.index("_Conv3x3Function.apply(x, w)") \
        < body.index("if x.is_cuda:") \
        < body.index("return _launch_fwd(x, w, conv3x3)") \
        < body.index("return conv3x3_plain(x, w)")
    for fn, launch, plain in (
            ("conv3x3_dgrad", "_launch_fwd(g, _rotated(w), conv3x3_dgrad)",
             "conv3x3_dgrad_plain"),
            ("conv3x3_wgrad", "_launch_wgrad(x, dy)", "conv3x3_wgrad_plain")):
        body = src.split(f"def {fn}(")[1].split("\ndef ")[0]
        assert body.index("is_cuda:") < body.index(launch) \
            < body.index(f"return {plain}")
    function = src.split("class _Conv3x3Function")[1].split("def conv3x3(")[0]
    assert function.index("if x.is_cuda:") \
        < function.index("_launch_fwd(x, w, conv3x3)") \
        < function.index("return conv3x3_plain(x, w)")
    for launcher in ("_launch_fwd", "_launch_wgrad"):
        cuda = src.split(f"def {launcher}(")[1].split("\ndef ")[0]
        assert "_plain" not in cuda and "F.conv" not in cuda
        assert cuda.index("raise RuntimeError") < cuda.index("launches += 1")


def test_kernel_source_calls_no_library():
    cu = (PORT / "csrc" / "conv3x3.cu").read_text()
    sm90 = (PORT / "csrc" / "conv3x3_sm90.cuh").read_text()
    for lib in ("cudnn", "cublas", "cutlass", "torch/"):
        assert lib not in cu.lower() and lib not in sm90.lower(), lib
    # the bf16 products are Hopper's wgmma, fed by TMA, through the shared
    # header's halo kernel, which the tout kernel instantiates too; no
    # mma.sync is left
    assert '#include "conv3x3_sm90.cuh"' in cu and "wgmma<0, 1>(" in cu
    assert "halo::launch<Taps>(" in cu
    tout = (PORT / "csrc" / "conv3x3_tout.cu").read_text()
    assert "halo::launch<Tout>(" in tout and "wgmma<1, 0>(" in tout
    assert "wgmma.mma_async.sync.aligned.m64n64k16" in sm90
    assert "cp.async.bulk.tensor" in sm90 and "tma_load_4d(" in sm90
    assert "mma.sync.aligned" not in cu + sm90
    assert 'extern "C" int conv3x3_fwd' in cu
    from llmmil_tpu_torch.ops.kernels import build
    assert build.library_path("conv3x3").name.startswith("libconv3x3_")


# ------------------------------------------------------------- backward --
# The input and weight gradients' plain versions (which a CPU tensor takes,
# and which the CUDA kernels are held against by chip_smoke.py) against the
# Pallas kernels the JAX package's custom VJP runs, interpreted, at the
# cases of tests/test_conv3x3.py: fp32 at 1e-4 (grads), bf16 against the
# fp32 reference at 0.05 (input rounding only).

from llmmil_tpu.ops.pallas.conv3x3 import _conv_fwd, _conv_wgrad
from llmmil_tpu_torch.ops.kernels import (conv3x3_dgrad, conv3x3_dgrad_plain,
                                          conv3x3_wgrad, conv3x3_wgrad_plain)


def _rot(k):
    return jnp.transpose(jnp.asarray(k)[::-1, ::-1], (0, 1, 3, 2))


@pytest.mark.parametrize("h,bh", [(16, 4), (16, 16), (10, 4)])
def test_dgrad_plain_matches_interpreted_pallas_kernel(h, bh):
    _, k = _data(h=h)
    g = np.random.RandomState(4).randn(2, h, 16, 4).astype(np.float32)
    want = _conv_fwd(jnp.asarray(g), _rot(k), block_h=bh, interpret=True)
    got = conv3x3_dgrad_plain(t(g), t(k))
    assert got.shape == (2, h, 16, 8)
    _close(got, want, tol=1e-4)
    before = conv3x3_dgrad.launches
    assert torch.equal(conv3x3_dgrad(t(g), t(k)), got)
    assert conv3x3_dgrad.launches == before       # CPU: no launch


@pytest.mark.parametrize("h,bh", [(16, 4), (16, 16), (10, 4)])
def test_wgrad_plain_matches_interpreted_pallas_kernel(h, bh):
    x, _ = _data(h=h)
    dy = np.random.RandomState(5).randn(2, h, 16, 4).astype(np.float32)
    want = _conv_wgrad(jnp.asarray(x), jnp.asarray(dy), block_h=bh,
                       interpret=True)
    got = conv3x3_wgrad_plain(t(x), t(dy))
    assert got.shape == (3, 3, 8, 4) and got.dtype == torch.float32
    _close(got, want, tol=1e-4)
    before = conv3x3_wgrad.launches
    assert torch.equal(conv3x3_wgrad(t(x), t(dy)), got)
    assert conv3x3_wgrad.launches == before
    _close(conv3x3_wgrad_plain(t(x), t(dy), torch.float64), want, tol=1e-4)


def test_bf16_gradients_close_to_fp32_reference():
    x, k = _data(seed=6)
    dy = np.random.RandomState(7).randn(2, 16, 16, 4).astype(np.float32)
    want_dx = _conv_fwd(jnp.asarray(dy), _rot(k), interpret=True)
    want_dw = _conv_wgrad(jnp.asarray(x), jnp.asarray(dy), interpret=True)
    xb, dyb = t(x).to(torch.bfloat16), t(dy).to(torch.bfloat16)
    dx = conv3x3_dgrad_plain(dyb, t(k).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16
    _close(dx.float(), want_dx, tol=0.05)
    np.testing.assert_allclose(n(conv3x3_wgrad_plain(xb, dyb)),
                               np.asarray(want_dw), rtol=0.05, atol=0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_follows_the_jax_custom_vjp(dtype):
    """conv3x3 under autograd: g cast to x's type before both products,
    the weight gradient cast to the kernel's type, as
    ``llmmil_tpu/ops/pallas/conv3x3.py``'s ``_conv3x3_bwd``."""
    x, k = _data(h=10, seed=8)
    dy = np.random.RandomState(9).randn(2, 10, 16, 4).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def loss(x_, k_):
        return jnp.sum(jax_conv3x3(x_, k_, 4, True).astype(jnp.float32) * dy)

    gx, gk = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt),
                                            jnp.asarray(k, jdt))
    xt = t(x).to(dtype).requires_grad_(True)
    kt = t(k).to(dtype).requires_grad_(True)
    (conv3x3(xt, kt).float() * t(dy)).sum().backward()
    assert xt.grad.dtype == kt.grad.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6
    np.testing.assert_allclose(n(xt.grad.float()), np.asarray(gx, np.float32),
                               rtol=tol, atol=tol)
    top = float(np.abs(np.asarray(gk, np.float32)).max())
    np.testing.assert_allclose(n(kt.grad.float()), np.asarray(gk, np.float32),
                               rtol=tol, atol=tol * top)


def test_backward_takes_only_the_gradients_asked_for(monkeypatch):
    mod = sys.modules["llmmil_tpu_torch.ops.kernels.conv3x3"]
    called = []
    for name in ("conv3x3_dgrad", "conv3x3_wgrad"):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real: (
            called.append(_n), _r(*a))[1])
    x, k = _data(h=6)
    xt = t(x).requires_grad_(True)
    conv3x3(xt, t(k)).sum().backward()
    assert called == ["conv3x3_dgrad"]
    called.clear()
    kt = t(k).requires_grad_(True)
    conv3x3(t(x), kt).sum().backward()
    assert called == ["conv3x3_wgrad"]


def test_wgrad_source_has_no_float_atomics():
    """The taps weight gradient is hand-written: no library kernel; its bf16
    products are Hopper's wgmma fed by TMA, through the shared header's
    weight-gradient kernel (which the tout weight gradient instantiates
    too), no mma.sync left; no float atomics (the partials are added in a
    fixed order); both C entry points."""
    cu = (PORT / "csrc" / "conv3x3_wgrad.cu").read_text()
    sm90 = (PORT / "csrc" / "conv3x3_sm90.cuh").read_text()
    for lib in ("cudnn", "cublas", "cutlass", "torch/"):
        assert lib not in cu.lower() and lib not in sm90.lower(), lib
    assert "atomicAdd" not in cu + sm90
    assert '#include "conv3x3_sm90.cuh"' in cu
    assert "wgrad::launch<bf::Taps>(" in cu and "wgmma<1, 1>(" in cu
    assert "wgmma.mma_async.sync.aligned" in sm90
    assert "cp.async.bulk.tensor" in sm90 and "tma_load_4d(" in sm90
    assert "mma.sync" not in cu and "ldmatrix" not in cu
    assert 'extern "C" int conv3x3_wgrad(' in cu \
        and 'extern "C" int conv3x3_wgrad_splits(' in cu
    from llmmil_tpu_torch.ops.kernels import build
    assert build.library_path("conv3x3_wgrad").name.startswith(
        "libconv3x3_wgrad_")


# ---------------------------------------------------------------- modes --
# The patch and tout modes (forward and input gradient) and the tout weight
# gradient: their plain versions (which a CPU tensor takes, and which the
# CUDA kernels are held against on the card by chip_smoke.py) against the
# JAX package's ``_conv_fwd(mode=)`` / ``_conv_wgrad(mode="tout")`` run in
# interpret mode, at the cases of tests/test_conv3x3.py (bh 4 and 16, and
# h = 10, which bh 4 does not divide): fp32 at 1e-5 for the forward, 1e-4
# for the gradients, bf16 against the fp32 reference at 0.05.

from llmmil_tpu_torch.eval import bench_conv3x3
from llmmil_tpu_torch.ops.kernels import (FWD_MODES, WGRAD_MODES,
                                          conv3x3_fwd, conv3x3_patch,
                                          conv3x3_patch_plain, conv3x3_tout,
                                          conv3x3_tout_plain,
                                          conv3x3_wgrad_tout,
                                          conv3x3_wgrad_tout_plain)

MODE_PLAIN = {"patch": conv3x3_patch_plain, "tout": conv3x3_tout_plain}
MODE_CASES = [(16, 4), (16, 16), (10, 4)]


@pytest.mark.parametrize("mode", sorted(MODE_PLAIN))
@pytest.mark.parametrize("h,bh", MODE_CASES)
def test_mode_plain_matches_interpreted_pallas_kernel(mode, h, bh):
    x, k = _data(h=h)
    want = _conv_fwd(jnp.asarray(x), jnp.asarray(k), block_h=bh,
                     interpret=True, mode=mode)
    got = MODE_PLAIN[mode](t(x), t(k))
    assert got.shape == (2, h, 16, 4) and got.dtype == torch.float32
    assert got.is_contiguous()
    _close(got, want)
    # the input gradient: the same mode on the rotated, transposed kernel
    g = np.random.RandomState(10).randn(2, h, 16, 4).astype(np.float32)
    want_dx = _conv_fwd(jnp.asarray(g), _rot(k), block_h=bh, interpret=True,
                        mode=mode)
    got_dx = conv3x3_dgrad(t(g), t(k), mode)
    assert got_dx.shape == (2, h, 16, 8)
    _close(got_dx, want_dx, tol=1e-4)


@pytest.mark.parametrize("h,bh", MODE_CASES)
def test_wgrad_tout_plain_matches_interpreted_pallas_kernel(h, bh):
    x, _ = _data(h=h)
    dy = np.random.RandomState(11).randn(2, h, 16, 4).astype(np.float32)
    want = _conv_wgrad(jnp.asarray(x), jnp.asarray(dy), block_h=bh,
                       interpret=True, mode="tout")
    got = conv3x3_wgrad_tout_plain(t(x), t(dy))
    assert got.shape == (3, 3, 8, 4) and got.dtype == torch.float32
    _close(got, want, tol=1e-4)
    _close(conv3x3_wgrad(t(x), t(dy), "tout"), want, tol=1e-4)
    _close(conv3x3_wgrad_tout_plain(t(x), t(dy), torch.float64), want,
           tol=1e-4)


def test_bf16_modes_close_to_fp32_reference():
    x, k = _data(seed=12)
    dy = np.random.RandomState(13).randn(2, 16, 16, 4).astype(np.float32)
    want = conv3x3_reference(jnp.asarray(x), jnp.asarray(k))
    want_dw = _conv_wgrad(jnp.asarray(x), jnp.asarray(dy), interpret=True,
                          mode="tout")
    xb, kb = t(x).to(torch.bfloat16), t(k).to(torch.bfloat16)
    for mode in MODE_PLAIN:
        got = conv3x3_fwd(xb, kb, mode)
        assert got.dtype == torch.bfloat16
        _close(got.float(), want, tol=0.05)
    got_dw = conv3x3_wgrad(xb, t(dy).to(torch.bfloat16), "tout")
    assert got_dw.dtype == torch.float32
    np.testing.assert_allclose(n(got_dw), np.asarray(want_dw), rtol=0.05,
                               atol=0.5)


@pytest.mark.parametrize("fn,mode,modes", [
    (conv3x3_fwd, "nope", FWD_MODES), (conv3x3_dgrad, "taps ", FWD_MODES),
    (conv3x3_wgrad, "patch", WGRAD_MODES)])
def test_unknown_mode_raises(fn, mode, modes):
    """The JAX functions take ``taps`` for any other string; the port
    refuses it, naming the mode."""
    x, k = _data()
    second = t(k) if fn is not conv3x3_wgrad else t(x)[..., :4]
    with pytest.raises(ValueError, match=f"unknown mode '{mode}'"):
        fn(t(x), second, mode)
    assert set(modes) <= {"taps", "patch", "tout"}


def test_mode_wrappers_on_cpu_take_the_plain_versions():
    x, k = _data(seed=14)
    dy = np.random.RandomState(15).randn(2, 16, 16, 4).astype(np.float32)
    before = (conv3x3.launches, conv3x3_patch.launches,
              conv3x3_tout.launches, conv3x3_wgrad_tout.launches)
    for mode, fn in (("patch", conv3x3_patch), ("tout", conv3x3_tout)):
        assert torch.equal(fn(t(x), t(k)), MODE_PLAIN[mode](t(x), t(k)))
        assert torch.equal(conv3x3_fwd(t(x), t(k), mode),
                           MODE_PLAIN[mode](t(x), t(k)))
    assert torch.equal(conv3x3_fwd(t(x), t(k)), conv3x3_plain(t(x), t(k)))
    assert torch.equal(conv3x3_wgrad_tout(t(x), t(dy)),
                       conv3x3_wgrad_tout_plain(t(x), t(dy)))
    assert (conv3x3.launches, conv3x3_patch.launches, conv3x3_tout.launches,
            conv3x3_wgrad_tout.launches) == before


def test_mode_wrappers_never_take_the_plain_version_on_the_card():
    src = (PORT / "ops" / "kernels" / "conv3x3.py").read_text()
    for fn, launch, plain in (
            ("conv3x3_patch", '_launch_fwd(x, w, conv3x3_patch, "patch")',
             "conv3x3_patch_plain"),
            ("conv3x3_tout", '_launch_fwd(x, w, conv3x3_tout, "tout")',
             "conv3x3_tout_plain"),
            ("conv3x3_wgrad_tout", '_launch_wgrad(x, dy, "tout")',
             "conv3x3_wgrad_tout_plain")):
        body = src.split(f"def {fn}(")[1].split("\ndef ")[0]
        assert body.index("is_cuda:") < body.index(launch) \
            < body.index(f"return {plain}")


def test_plain_modes_build_the_im2col_matrix_by_groups_of_images(
        monkeypatch):
    """The plain versions hold at most a few images' im2col matrix at once
    (at the path the whole one would be 18 GB in fp32); the result does not
    depend on the grouping."""
    mod = sys.modules["llmmil_tpu_torch.ops.kernels.conv3x3"]
    x, k = _data(nb=3, seed=16)
    dy = np.random.RandomState(17).randn(3, 16, 16, 4).astype(np.float32)
    whole = [conv3x3_patch_plain(t(x), t(k)), conv3x3_tout_plain(t(x), t(k)),
             conv3x3_wgrad_tout_plain(t(x), t(dy))]
    monkeypatch.setattr(mod, "_IM2COL_CHUNK", 16 * 16 * 72)   # one image
    assert len(mod._image_groups(t(x), 72)) == 3
    grouped = [conv3x3_patch_plain(t(x), t(k)),
               conv3x3_tout_plain(t(x), t(k)),
               conv3x3_wgrad_tout_plain(t(x), t(dy))]
    for a, b, tol in zip(whole, grouped, (1e-5, 1e-5, 1e-4)):
        _close(a, n(b), tol=tol)


def test_bench_entry_point_runs_the_plain_versions_on_the_cpu(capsys):
    assert bench_conv3x3.main(["--small", "--device", "cpu", "--iters", "1",
                               "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    for mode in FWD_MODES:
        assert any(line.startswith(f"parity {mode}: fwd") for line in out)
        assert any(line.startswith(f"kernel dgrad {mode} ") for line in out)
    for mode in WGRAD_MODES:
        assert any(line.startswith(f"kernel wgrad {mode} ") for line in out)
    assert not any("FAILED" in line for line in out)
    last = __import__("json").loads(out[-1])
    assert last["device"] == "cpu" and last["failed"] == []


def test_bench_entry_point_refuses_a_row_block_and_fails_a_bad_mode(capsys):
    with pytest.raises(SystemExit):
        bench_conv3x3.main(["--small", "--device", "cpu", "--block-h", "8"])
    assert bench_conv3x3.main(["--small", "--device", "cpu", "--iters", "1",
                               "--reps", "1", "--modes", "taps,nope",
                               "--ops", "fwd"]) == 1
    assert "parity nope: fwd: FAILED ValueError" in capsys.readouterr().out


def test_tout_wrapper_turns_the_kernels_yt_back_to_nhwc(monkeypatch):
    """On the card ``conv3x3_tout`` launches the kernel, which writes yᵀ (F,
    N·H·W) (``_tout_yt`` returns it as it is), and transposes it back to
    NHWC.  With the launch faked to write the plain version's yᵀ for a
    tensor that claims to lie on the card, the wrapper gives the plain
    version's NHWC output; a yᵀ of distinct values lands element by
    element where it belongs."""
    mod = sys.modules["llmmil_tpu_torch.ops.kernels.conv3x3"]
    x, k = _data(nb=2, h=5, w=7, c=3, f=4, seed=18)
    xt, kt = t(x), t(k)
    nb, h, w, f = 2, 5, 7, 4
    want_yt = (kt.reshape(27, f).t() @ mod.im2col(xt).t())
    launched = []

    def fake_launch(a, wk, counter, mode="taps"):
        launched.append((counter.__name__, mode))
        return want_yt.clone()

    monkeypatch.setattr(mod, "_launch_fwd", fake_launch)
    on_card = _OnTheCard((nb, h, w, 3))
    assert torch.equal(mod._tout_yt(on_card, kt), want_yt)
    y = conv3x3_tout(on_card, kt)
    assert launched == [("conv3x3_tout", "tout")] * 2
    assert y.shape == (nb, h, w, f) and y.is_contiguous()
    _close(y, n(conv3x3_tout_plain(xt, kt)), tol=1e-5)
    distinct = torch.arange(f * nb * h * w, dtype=torch.float32).reshape(
        f, nb * h * w)
    y = mod._nhwc(distinct, on_card)
    for i, j, m, c in ((0, 0, 0, 0), (1, 4, 6, 3), (1, 2, 3, 1)):
        assert y[i, j, m, c] == distinct[c, (i * h + j) * w + m]


def test_probe_covers_every_fwd_kernel_and_its_phases():
    """``probe_conv3x3 --kernel`` names each forward kernel's and each
    weight gradient's source and C entry point (a weight gradient's planning
    entry beside it), and each source (with the headers it includes) honours
    the four CONV3X3_SKIP_* macros that split its time; without a card the
    probe refuses to run."""
    from llmmil_tpu_torch.eval import probe_conv3x3
    assert sorted(probe_conv3x3.KERNELS) == sorted(
        FWD_MODES + ("wgrad", "wgrad_tout"))
    csrc = PORT / "csrc"
    headers = {h.name: h.read_text() for h in csrc.glob("*.cuh")}
    for mode, (source, entry) in probe_conv3x3.KERNELS.items():
        cu = (csrc / f"{source}.cu").read_text()
        assert f'extern "C" int {entry}(' in cu, mode
        if mode.startswith("wgrad"):
            assert f'extern "C" int {entry}_splits(' in cu, mode
        text = cu + "".join(v for k_, v in headers.items()
                            if f'#include "{k_}"' in cu)
        for phase in ("X", "W", "MMA", "STORE"):
            assert f"CONV3X3_SKIP_{phase}" in text, (mode, phase)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            probe_conv3x3.main(["--kernel", "tout"])
    with pytest.raises(SystemExit):
        probe_conv3x3.main(["--kernel", "nope"])


def test_probe_wgrad_ranges_rewrites_the_shipped_constants():
    """``probe_wgrad_ranges`` varies the weight-gradient kernel by rewriting
    three lines of ``conv3x3_sm90.cuh``: each stands there once, each
    variant replaces all three, and a header without them is refused;
    without a card the probe refuses to run."""
    from llmmil_tpu_torch.eval import probe_wgrad_ranges as probe
    header = (PORT / "csrc" / "conv3x3_sm90.cuh").read_text()
    assert probe.VARIANTS["shipped"] == (4, 2, 32768)
    for th, stages, pixels in probe.VARIANTS.values():
        text = probe.variant_header(header, th, stages, pixels)
        assert f"constexpr int TH = {th}, TW = 64;" in text
        assert f"constexpr int STAGES = {stages};" in text
        assert f"MAX_RANGE_TILES = {pixels} / (TH * TW);" in text
    with pytest.raises(RuntimeError, match="no longer holds"):
        probe.variant_header(header.replace(probe.STAGES_LINE, ""), 4, 2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            probe.main([])
