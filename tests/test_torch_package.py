"""Rules the PyTorch port keeps as a package: it imports nothing of JAX or of
the JAX package, nor the packages its card's installation lacks (optax,
pandas, regex, sklearn); its build directory is git-ignored, its entry
points want a CUDA card unless the caller names the CPU, and the
configuration and bag helpers it copied agree with the JAX package's."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "llmmil_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax|pandas|regex|sklearn|llmmil_tpu)\b(?!_)"
    r"|from\s+(jax|flax|optax|pandas|regex|sklearn|llmmil_tpu)(\.[\w.]*)?"
    r"\s+import)", re.M)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "from flax import linen", "  import flax.linen as nn",
                "from llmmil_tpu.config import Config", "import llmmil_tpu",
                "from llmmil_tpu import Config", "import optax",
                "import pandas as pd", "    import regex as re",
                "from sklearn.model_selection import KFold"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from llmmil_tpu_torch import Config",
               "import llmmil_tpu_torch.ops", "from .config import Config",
               "# import jax would be wrong here", "import re",
               "from .train import optim"):
        assert not FORBIDDEN.search(ok), ok


def test_importing_the_port_loads_no_jax():
    """In a fresh interpreter: every module of the port imported, and neither
    jax, flax nor the JAX package in ``sys.modules``."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in SOURCES if p.name != "__init__.py"
            and p.parent != ROOT]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'llmmil_tpu', 'triton', 'optax', 'pandas', "
            "'regex', 'sklearn')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_gitignore_lists_the_build_directory():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "llmmil_tpu_torch/ops/kernels/_build/" in lines
    from llmmil_tpu_torch.ops.kernels import build
    assert build.BUILD_DIR == PORT / "ops" / "kernels" / "_build"
    assert (build.CSRC_DIR / "mil_pool.cu").is_file()
    assert (build.CSRC_DIR / "conv3x3.cu").is_file()
    assert (build.CSRC_DIR / "conv3x3_wgrad.cu").is_file()


def test_library_path_is_keyed_by_the_source():
    from llmmil_tpu_torch.ops.kernels import build
    path = build.library_path("mil_pool")
    assert path.parent == build.BUILD_DIR
    assert re.fullmatch(r"libmil_pool_[0-9a-f]{16}\.so", path.name)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_cfg():
    from llmmil_tpu_torch import Config
    return Config(modality=["pathology"], aggregator="ABMIL",
                  loss_point="Last", compute_dtype="float32",
                  twoway_depth=1, bag_buckets=[16])


def test_build_model_wants_a_card_unless_cpu_is_named(no_card):
    from llmmil_tpu_torch.models import build_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(_tiny_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(_tiny_cfg(), device="cuda")
    model = build_model(_tiny_cfg(), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert not model.training


def test_serving_entry_points_want_a_card_unless_cpu_is_named(
        no_card, tmp_path):
    from llmmil_tpu_torch.eval import export, serve
    from llmmil_tpu_torch.models import build_model
    cfg = _tiny_cfg()
    blob = export.export_model(
        cfg, build_model(cfg, device="cpu").state_dict(),
        [export.make_example_batch(cfg, 1, 16)])
    path = tmp_path / "a.llmmil"
    export.save_artifact(str(path), blob)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.ServingModel(blob)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.load_artifact(str(path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_artifact(str(path), port=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.main(["--out", str(tmp_path / "b.llmmil"), "--modality",
                     "['pathology']", "--aggregator", "ABMIL"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--artifact", str(path), "--port", "0"])
    assert export.ServingModel(blob, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    """No card: non-zero exit and no result line."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_config_copy_agrees_with_the_jax_package():
    from llmmil_tpu.config import Config as JConfig
    from llmmil_tpu.config import create_arg_parser as jax_parser
    from llmmil_tpu_torch.config import Config, create_arg_parser
    assert [f.name for f in dataclasses.fields(Config)] \
        == [f.name for f in dataclasses.fields(JConfig)]
    assert Config().to_dict() == JConfig().to_dict()
    c = Config(modality=["pathology"], clip_layers=1)
    assert c.replace(n_ctx=2).n_ctx == 2 and c.n_ctx == 8
    assert Config.from_dict(dict(c.to_dict(), junk=1)) == c
    assert c.n_clinical == JConfig().n_clinical == 9
    assert c.bag_max == JConfig().bag_max and c.ct_hw == JConfig().ct_hw
    argv = ["--modality", "['pathology']", "--lr", "0.1", "--save_best",
            "--no-pretrain", "--use_pallas", "true", "--ct_temporal_mode",
            "dshift", "--ct_conv_backend", "pallas", "--ct_fwd_lowering",
            "conv3d", "--ct_layers", "[1,1,1,1]"]
    assert vars(create_arg_parser().parse_args(argv)) \
        == vars(jax_parser().parse_args(argv))
    # the three CT lowering fields mean the same in both packages
    for name, values in (("ct_temporal_mode", ("conv3d", "dfold", "dsum",
                                               "dshift")),
                         ("ct_conv_backend", ("xla", "pallas")),
                         ("ct_fwd_lowering", ("fold", "conv3d"))):
        assert getattr(Config(), name) == getattr(JConfig(), name) \
            == values[1 if name == "ct_temporal_mode" else 0]
        for v in values:
            assert Config(**{name: v}).to_dict() == JConfig(**{name: v}
                                                            ).to_dict()


@pytest.mark.parametrize("field,bad", [
    ("ct_temporal_mode", "nope"), ("ct_conv_backend", "nope"),
    ("ct_conv_backend", "pallas_interpret"), ("ct_fwd_lowering", "nope")])
def test_bad_ct_field_is_a_value_error_that_names_it(field, bad):
    """The bad-config probe for the fields that steer the CT trunk; every
    value the JAX package documents builds."""
    from llmmil_tpu_torch import Config
    from llmmil_tpu_torch.models import build_model
    base = dict(modality=["CT"], aggregator="ABMIL", twoway_depth=1,
                ct_layers=[1, 1, 1, 1], clip_layers=1)
    with pytest.raises(ValueError, match=field):
        build_model(Config(**dict(base, **{field: bad})), device="cpu")
    good = {"ct_temporal_mode": "dsum", "ct_conv_backend": "pallas",
            "ct_fwd_lowering": "conv3d"}[field]
    assert build_model(Config(**dict(base, **{field: good})), device="meta")


@pytest.mark.parametrize("version,dim", [("v1", 9), ("v2", 27),
                                         ("v1d", 513), ("v2d", 513)])
def test_ci_input_dim(version, dim):
    from llmmil_tpu_torch import Config
    assert Config(CI_input_version=version).ci_input_dim == dim


@pytest.mark.parametrize("n_rows", [1, 512, 513, 8192, 8193, 16384, 20000])
def test_bucket_for_agrees_with_the_jax_package(n_rows):
    from llmmil_tpu.data import bags as jbags
    from llmmil_tpu_torch.data import bags
    assert bags.DEFAULT_BUCKETS == jbags.DEFAULT_BUCKETS
    assert bags.bucket_for(n_rows) == jbags.bucket_for(n_rows)
    assert bags.bucket_for(n_rows, (16, 32)) \
        == jbags.bucket_for(n_rows, (16, 32))


@pytest.mark.parametrize("n_rows,dtype", [(5, np.float32), (16, np.float32),
                                          (20, np.float32), (5, np.float64),
                                          (20, np.float16)])
def test_pad_bag_agrees_with_the_jax_package(n_rows, dtype):
    from llmmil_tpu.data import bags as jbags
    from llmmil_tpu_torch.data import bags
    feat = np.random.RandomState(0).randn(n_rows, 8).astype(dtype)
    got, got_mask = bags.pad_bag(feat, 16)
    want, want_mask = jbags.pad_bag(feat, 16)
    assert got.shape == (16, 8) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)


@pytest.mark.parametrize("device,ok", [("cpu", True), ("meta", True),
                                       (None, False), ("cuda", False),
                                       ("cuda:0", False)])
def test_resolve_device(no_card, device, ok):
    from llmmil_tpu_torch.device import resolve_device
    if ok:
        assert resolve_device(device) == torch.device(device)
    else:
        with pytest.raises(RuntimeError):
            resolve_device(device)


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrapper decides by where the tensor lies, nothing else: the
    source holds no ``try`` and the CUDA branch only launches."""
    src = (PORT / "ops" / "kernels" / "mil_pool.py").read_text()
    assert "try:" not in src and "except" not in src
    body = src.split("def mil_pool(")[1]
    assert body.index("if x.is_cuda:") < body.index("_MilPoolFunction.apply") \
        < body.index("return mil_pool_plain")
    build_src = (PORT / "ops" / "kernels" / "build.py").read_text()
    assert "except" not in build_src


MODE_SOURCES = {       # source: (C entry point, the TPU kernel it replaces)
    "conv3x3_patch": ("conv3x3_patch_fwd", "_fwd_patch_kernel"),
    "conv3x3_tout": ("conv3x3_tout_fwd", "_tout_kernel"),
    "conv3x3_wgrad_tout": ("conv3x3_wgrad_tout", "_wgrad_tout_kernel")}
# the sources whose bf16 products run on Hopper's wgmma (conv3x3_sm90.cuh);
# conv3x3_im2col.cuh keeps only the fp32 paths' cp.async loaders
WGMMA_SOURCES = ("conv3x3_patch", "conv3x3_tout", "conv3x3_wgrad_tout")


@pytest.mark.parametrize("name", sorted(MODE_SOURCES))
def test_mode_kernel_source_calls_no_library_and_no_float_atomics(name):
    """The patch, tout and tout weight-gradient kernels (and the headers they
    share) are hand-written: no library kernel, no float atomics, a plain C
    entry point; the bf16 products through wgmma, fed by TMA, no mma.sync
    left in the source or in the im2col header its fp32 path includes."""
    cu = (PORT / "csrc" / f"{name}.cu").read_text()
    im2col = (PORT / "csrc" / "conv3x3_im2col.cuh").read_text()
    sm90 = (PORT / "csrc" / "conv3x3_sm90.cuh").read_text()
    for text in (cu, im2col, sm90):
        for lib in ("cudnn", "cublas", "cutlass", "torch/", "atomicadd"):
            assert lib not in text.lower(), (name, lib)
    entry, replaces = MODE_SOURCES[name]
    assert '#include "conv3x3_im2col.cuh"' in cu
    assert f'extern "C" int {entry}(' in cu and f"`{replaces}`" in cu
    assert "__pipeline_memcpy_async" in im2col
    assert name in WGMMA_SOURCES
    assert '#include "conv3x3_sm90.cuh"' in cu
    assert "wgmma.mma_async.sync.aligned" in sm90 \
        and "cp.async.bulk.tensor" in sm90
    assert "mma.sync" not in cu and "ldsm_x4" not in cu
    assert "mma.sync" not in im2col and "ldmatrix" not in im2col
    from llmmil_tpu_torch.ops.kernels import build
    assert build.library_path(name).name.startswith(f"lib{name}_")


def test_mil_pool_source_is_hand_written_wgmma_and_tma():
    """The pooling kernel and the header it includes call no library kernel
    and add no floats atomically (the only atomic additions count the
    blocks at the grid barrier, in unsigned ints); its bf16 products run on
    wgmma fed by TMA, and nothing of the mma.sync design it replaced is
    left."""
    cu = (PORT / "csrc" / "mil_pool.cu").read_text()
    sm90 = (PORT / "csrc" / "conv3x3_sm90.cuh").read_text()
    for text in (cu, sm90):
        for lib in ("cudnn", "cublas", "cutlass", "torch/", "#include <torch"):
            assert lib not in text.lower(), lib
    calls = re.findall(r"atomicAdd\(([^,]*),", cu)
    assert calls and all(re.fullmatch(r"bar( \+ 1)?", c.strip())
                         for c in calls)
    assert "unsigned int* bar" in cu
    assert "atomicadd" not in sm90.lower()
    assert '#include "conv3x3_sm90.cuh"' in cu
    assert 'extern "C" int mil_pool_fwd(' in cu and "`_mil_kernel`" in cu
    assert "wgmma_n192<" in cu and "wgmma.mma_async.sync.aligned.m64n192k16" in sm90
    assert "tma_load_3d(" in cu and "cp.async.bulk.tensor" in sm90
    assert "mma.sync" not in cu and "ldmatrix" not in cu and "ldsm_" not in cu


def test_library_path_follows_the_shared_header(tmp_path, monkeypatch):
    """A library is rebuilt when a header it includes changes."""
    from llmmil_tpu_torch.ops.kernels import build
    for src in (PORT / "csrc").iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    for name, included in (("mil_pool", "conv3x3_sm90.cuh"),
                           ("conv3x3_patch", "conv3x3_im2col.cuh"),
                           ("conv3x3_tout", "conv3x3_sm90.cuh"),
                           ("conv3x3", "conv3x3_sm90.cuh"),
                           ("conv3x3_wgrad", "conv3x3_sm90.cuh"),
                           ("conv3x3_wgrad_tout", "conv3x3_sm90.cuh")):
        assert f'#include "{included}"' in (tmp_path / f"{name}.cu").read_text()
        before = build.library_path(name)
        header = tmp_path / included
        header.write_text(header.read_text() + "\n// changed\n")
        assert build.library_path(name) != before, (name, included)


def test_bench_entry_point_imports_nothing_of_jax():
    src = (PORT / "eval" / "bench_conv3x3.py").read_text()
    assert not FORBIDDEN.search(src)
    assert "llmmil_tpu." not in src and "import jax" not in src
