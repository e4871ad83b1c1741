"""Typed experiment configuration of the PyTorch port.

The port's own copy of ``llmmil_tpu/config.py``: every field keeps its name
and default, so a launch command or a saved config snapshot means the same in
both packages (``tests/test_torch_package.py`` holds the two ``to_dict()``s
equal).  Fields that steer only the JAX package's device mesh, XLA options or
TPU lowerings are kept as inert fields: the port reads none of them yet.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Sequence


def arg_as_list(s: str) -> list:
    """Parse a python-literal list flag."""
    v = ast.literal_eval(s)
    if type(v) is not list:
        raise argparse.ArgumentTypeError(f'Argument "{s}" is not a list')
    return v


DEFAULT_CLINICAL_FEATURES = [
    "sex", "age", "sm", "locationcancer", "cancerimaging",
    "cancerimagingT", "cancerimagingN", "cancerimagingM",
    "classification_cancer",
]


@dataclass(frozen=True)
class Config:
    """All experiment knobs; names and defaults match the reference flags."""

    # ---- cohort / folds ----
    hospital_test: List[str] = field(
        default_factory=lambda: ["EUMC", "HUMC", "SCHMC"])
    kfold_num: int = 4
    val_fold: int = 0

    # ---- eval mode ----
    mode: str = "test"
    best_thres: float = 0.5

    # ---- CT geometry ----
    resampleXY: int = 1
    spacing: List[float] = field(default_factory=lambda: [0.6869, 0.6869, 3.0])
    tumorCrop: int = 0

    # ---- data paths ----
    type: str = "Biopsy+Resection"
    test_type: str = "Biopsy+Resection"
    path_data_CT: str = "data/CT"
    path_feature_CT: str = "data/CT/SwinUNETR_feature"
    path_data_pathology: str = "data/Pathology_feature"
    path_data_excel: str = "data/Clinical_excel"
    path_data_mask: str = "data/CT/TumorMask"
    clinical_features: List[str] = field(
        default_factory=lambda: list(DEFAULT_CLINICAL_FEATURES))
    pathology_info_version: str = "v1"

    # ---- image-only WSI patch pipeline ----
    pathology_source: str = "features"   # 'features' | 'wsi'
    path_data_wsi: str = "data/WSI"
    wsi_tile: int = 224            # tile size on the slide (px)
    wsi_stride: int = 0            # 0 → non-overlapping (= wsi_tile)
    wsi_px: int = 224              # encoder input resolution
    wsi_encode_batch: int = 256    # tiles per device batch (fixed shape)
    wsi_min_foreground: float = 0.0  # drop tiles below this tissue frac
    wsi_cache_dir: str = ""        # encoded-bag cache ("" = no cache)
    patch_encoder_ckpt: str = ""
    wsi_patch: int = 32
    wsi_vit_width: int = 768
    wsi_vit_layers: int = 12
    wsi_embed_dim: int = 512

    # ---- modality / model selection ----
    modality: List[str] = field(default_factory=lambda: ["CT", "pathology"])
    alignment_base: str = "none"       # CT | pathology | CI | none
    model_CT: str = "resnetMC3_18"     # resnetMC3_18 | medicalNet | SwinUNETR | MViT | resnet2plus1d_18
    model_pathology: str = "TransMIL"  # ABMIL | ABMIL_v2 | TransMIL
    CI_input_version: str = "v1"       # v1 | v2 | text
    CI_prompt_version: str = "single"  # single | devided
    model_CI: str = "simpleFCs_v1"     # simpleFCs_v{1,1d,2,2d} | CLIP
    aggregator: str = "TransMIL"       # ABMIL | ABMIL_v2 | TransMIL | TransMIL_seperate | TransMIL_per_modality | -
    model_family: str = "aggregator"   # aggregator | clip (late fusion) | concat (early baseline)
    # 'wMask' in model_CT: 'concat' = the reference's concat-fusion model,
    # 'twoway' = the TwoWay fusion model fed the mask as an extra channel
    wmask_family: str = "concat"
    # separate clinical encoders + per-modality TwoWayTransformers
    separate_CI_encoders: int = 0
    swin_n_subsample: int = 0
    swin_crop: List[int] = field(default_factory=list)
    swin_crop_chunk: int = -1
    mvit_arch: str = "v2_s"
    mvit_depths: List[int] = field(default_factory=list)

    # ---- prompts ----
    learnablePrompt: int = 1
    n_ctx: int = 8
    n_prompts: int = 2
    prompt_len: int = 0

    # ---- misc data ----
    data_integration: int = 0
    augmentation: int = 1
    cancerstageTrain: str = "1234"
    cancerstageTest: str = "1234"

    # ---- pretrain / model shape ----
    pretrain: bool = True
    pretrained_weights: str = "DEFAULT"
    dim: str = "3d"
    num_classes: int = 2
    activationF: str = "sigmoid"

    # ---- training ----
    start_epoch: int = 0
    n_epochs: int = 1000
    resume: str = ""
    pretrainedExt_CT: int = 0
    pretrainedExt_CT_pth: str = ""
    pretrainedExt_pathology: int = 0
    pretrainedExt_pathology_pth: str = ""
    pretrainedExt_CI: int = 0
    pretrainedExt_CI_pth: str = ""
    pretrainedExt_freeze: int = 1
    weight_decay: float = 5e-4
    lr: float = 1e-5
    loss: str = "BCE"                 # BCE | CS | BCE+CS | BCE+CLIP
    loss_point: str = "CT-Pth-Last"   # CT-Pth-Last | Last
    schedule: List[int] = field(default_factory=lambda: [500])
    b1: float = 0.9
    b2: float = 0.999
    seed: int = 1234
    iter_per_epoch: int = 100
    val_iter_per_epoch: int = 50
    batch_size: int = 8
    num_workers: int = 4
    loader_pool: str = "thread"       # 'thread' | 'process'
    save_best: bool = False
    cos: bool = False

    # ---- labels ----
    survival_type: str = "OS"
    year: int = 5
    label: str = "5yOS"

    # ---- eval / analysis ----
    test_pth: str | None = None
    watch_ID: str = "A000000"
    map_type: str = "saliencyMap"

    # ---- CLIP text tower size (ViT-B/32 text defaults; shrinkable for
    # tests / dry runs) ----
    clip_vocab: int = 49408
    bpe_vocab_path: str = ""
    clip_context: int = 77
    clip_width: int = 512
    clip_heads: int = 8
    clip_layers: int = 12
    clip_embed: int = 512

    # ---- additions of the JAX package (no reference counterpart) ----
    mesh_shape: List[int] = field(default_factory=lambda: [-1])   # inert here
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])  # inert
    compute_dtype: str = "bfloat16"    # dtype of the matmul compute path
    param_dtype: str = "float32"
    bag_buckets: List[int] = field(
        default_factory=lambda: [512, 1024, 2048, 4096, 8192, 16384])
    # Fused MIL-pooling kernel (ops/kernels/mil_pool.py; the field keeps the
    # JAX package's name).  True/False force either path; 'auto' turns the
    # kernel on where a raw 768-d bag is pooled (the concat baseline) and
    # off for the flagship's fused streams, as the JAX package rules.  The
    # kernel launches only for tensors that lie on a CUDA device.
    use_pallas: Any = "auto"
    bag_shard_axis: str = ""           # inert here
    fsdp_axis: str = ""                # inert here
    tp_axis: str = ""                  # inert here
    pp_axis: str = ""                  # inert here
    pp_micro: int = 2                  # inert here
    ct_shard_axis: str = ""            # non-empty: not ported yet, raises
    xla_options: List[str] = field(    # inert here
        default_factory=lambda: ["xla_tpu_scoped_vmem_limit_kib=32768"])
    moe_experts: int = 0
    moe_hidden: int = 1024
    moe_k: int = 2
    moe_capacity: float = 1.25
    moe_group: int = 512
    moe_aux_weight: float = 0.01
    ep_axis: str = ""                  # inert here
    # Which CT trunk stages recompute their activations in the backward
    # ('all' | 'early' | 'layer2' | 'none'); 'auto' → resolve_memory_config
    ct_remat: str = "auto"
    # Temporal (kD>1) convolutions of the CT trunk: 'conv3d' is a plain 3-D
    # convolution; 'dfold' / 'dsum' / 'dshift' compute the same thing as
    # depth-folded 2-D convolutions (models/ct_mc3.py::DepthFoldedConv).
    ct_temporal_mode: str = "dfold"
    # 2-D backend of the depth-folded convolutions: 'xla' is stock PyTorch
    # (F.conv2d, cuDNN on the card), 'pallas' sends the 3×3 stride-1 ones
    # (MC3 layer1) to the hand-written kernel ops/kernels/conv3x3.py (the
    # field keeps the JAX package's names).  On a CPU tensor 'pallas' takes
    # the kernel's plain version; 'pallas_interpret' is refused.
    ct_conv_backend: str = "xla"
    # 'conv3d' computes the dfold forward as a plain 3-D convolution where
    # the JAX package does (cin >= 8, cout < 128, kernel not on 'pallas').
    ct_fwd_lowering: str = "fold"
    ct_layers: List[int] = field(default_factory=list)
    # TwoWayTransformer block depth (debug knob): 0 = the reference's 2
    twoway_depth: int = 0
    nystrom_pinv_iters: int = 6
    ct_shape: List[int] = field(default_factory=lambda: [160, 512, 512])
    ct_cache_dir: str = ""
    save_dir: str = "results"
    log_every: int = 10
    device_prefetch: int = 2
    data_echo: int = 1
    grad_accum: int = 1
    profile_dir: str = ""
    async_checkpoint: int = 0
    handle_preemption: bool = True

    # ------------------------------------------------------------------
    @property
    def n_clinical(self) -> int:
        return len(self.clinical_features)

    @property
    def ci_input_dim(self) -> int:
        """Width of the numeric clinical vector ``CI_input_version`` names
        (the tiled ``*d`` versions repeat it up to just past 512)."""
        dim = self.n_clinical if self.CI_input_version.startswith("v1") \
            else 27
        if self.CI_input_version.endswith("d"):
            dim *= 1 + 512 // dim
        return dim

    @property
    def bag_max(self) -> int:
        """Fixed max bag length for batch>1."""
        return 14880 if self.path_data_pathology.endswith("_sn") else 15592

    # 0 → in-plane size keyed on spacing like the reference; >0 overrides
    ct_hw_override: int = 0

    @property
    def ct_hw(self) -> int:
        """CT in-plane size as a function of spacing."""
        if self.ct_hw_override:
            return self.ct_hw_override
        return 224 if self.spacing[0] == 2.0 else 512

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def resolve_memory_config(cfg: Config, training: bool) -> Config:
    """Resolve ``ct_remat='auto'`` as the JAX package does: 'early' when
    training at batch >= 2, else 'layer2'.  An explicit value passes through.
    (The rule was measured on a 16 GB TPU; on the card it is kept as the same
    default, not as a measurement.)"""
    if cfg.ct_remat != "auto":
        return cfg
    remat = "early" if (training and cfg.batch_size >= 2) else "layer2"
    if remat == "early":
        print(f"[memory] ct_remat=auto -> 'early' (batch_size="
              f"{cfg.batch_size} >= 2)", flush=True)
    return cfg.replace(ct_remat=remat)


def create_arg_parser() -> argparse.ArgumentParser:
    """CLI with one flag per :class:`Config` field."""
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = (f.default_factory() if f.default_factory
                   is not dataclasses.MISSING else f.default)
        if isinstance(default, list):
            p.add_argument(name, default=default, type=arg_as_list)
        elif isinstance(default, bool):
            p.add_argument(name, default=default,
                           action="store_true" if not default else
                           argparse.BooleanOptionalAction)
        elif default is None:
            p.add_argument(name, default=None, type=str)
        else:
            p.add_argument(name, default=default, type=type(default))
    return p


def parse_config(argv: Sequence[str] | None = None) -> Config:
    ns = create_arg_parser().parse_args(argv)
    return Config(**vars(ns))
