"""Serving export: freeze a model into one self-contained artifact file.

The JAX package bakes the weights into a StableHLO program per input
signature (``jax.export``).  PyTorch runs eagerly and needs no program per
shape, so the port's artifact is one ``torch.save`` file holding

- the manifest: config snapshot, per-entry signatures (batch size x bag
  bucket, as exported), ``num_classes``, the torch version;
- the ``state_dict``.

:class:`ServingModel` rebuilds the module with ``build_model`` from the
snapshot, loads the weights (``weights_only=True``: nothing is unpickled but
tensors and plain containers) and, like the JAX package's, answers only the
signatures that were exported: a fixed set of shapes is what lets a server
warm up every one of them before the first request.

CLI: ``python -m llmmil_tpu_torch.eval.export --out model.llmmil ...``.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from ..config import Config, create_arg_parser
from ..device import resolve_device
from ..models import build_model


def make_example_batch(cfg: Config, batch: int = 1,
                       bag: Optional[int] = None,
                       ct_depth: int = 160) -> Dict[str, np.ndarray]:
    """Zero-filled numpy batch with the production shapes the config
    implies: a CT volume of ``ct_depth`` slices at the in-plane size the
    spacing names (plus its tumour mask for a ``wMask`` trunk), a bag of
    ``bag`` rows, the clinical encoding."""
    out: Dict[str, np.ndarray] = {}
    if "CT" in cfg.modality:
        hw = cfg.ct_hw
        out["input_CT"] = np.zeros((batch, ct_depth, hw, hw, 1), np.float32)
        if "wMask" in cfg.model_CT:
            out["mask_CT"] = np.zeros((batch, ct_depth, hw, hw, 1),
                                      np.float32)
    if "pathology" in cfg.modality:
        n = bag or (cfg.bag_buckets[-1] if cfg.bag_buckets else cfg.bag_max)
        out["input_pathology"] = np.zeros((batch, n, 768), np.float32)
        out["mask_pathology"] = np.ones((batch, n), bool)
        if cfg.model_pathology == "ABMIL_v2":
            out["BpRc_class"] = np.zeros((batch, 1), np.float32)
    if cfg.model_CI == "CLIP":
        n_p = cfg.n_clinical + 1 if cfg.CI_prompt_version == "devided" \
            else 1
        toks = np.zeros((batch, n_p, cfg.clip_context - cfg.prompt_len),
                        np.int32)
        toks[..., 0] = 1
        toks[..., -1] = cfg.clip_vocab - 1        # EOT = argmax id
        out["input_CI"] = toks
    else:
        out["input_CI"] = np.zeros((batch, cfg.ci_input_dim), np.float32)
    return out


def precomputed_ct_feature_dim(cfg: Config, state_dict) -> Optional[int]:
    """Width of the precomputed CT features a flagship ``state_dict`` was
    built for (it holds no ``extractor_CT``), None for one with a trunk."""
    if "CT" not in cfg.modality or cfg.model_family != "aggregator" \
            or any(k.startswith("extractor_CT.") for k in state_dict):
        return None
    proj = state_dict.get("fc_CT_proj.weight")
    return 512 if proj is None else int(proj.shape[1])


def _entry_key(batch: Mapping[str, Any]) -> str:
    sig = sorted((k, tuple(np.shape(v)), str(np.asarray(v).dtype))
                 for k, v in batch.items())
    return ";".join(f"{k}:{'x'.join(map(str, s))}:{d}" for k, s, d in sig)


def export_model(cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 batches: Iterable[Mapping[str, Any]]) -> bytes:
    """Serialize the weights and one entry per example batch signature into
    one artifact blob.  The ``state_dict`` is checked against the module
    that ``cfg`` builds (names and shapes), so an artifact that cannot be
    served is refused here and not when it is loaded."""
    ct_feature_dim = precomputed_ct_feature_dim(cfg, state_dict)
    want = build_model(cfg, device="meta",
                       ct_feature_dim=ct_feature_dim).state_dict()
    have = {k: tuple(v.shape) for k, v in state_dict.items()}
    if have != {k: tuple(v.shape) for k, v in want.items()}:
        odd = sorted(set(have.items()) ^ {(k, tuple(v.shape))
                                          for k, v in want.items()})
        raise ValueError("state_dict does not match the model that cfg "
                         f"builds; first differences: {odd[:6]}")
    sigs = {_entry_key(b): {k: [list(np.shape(v)), str(np.asarray(v).dtype)]
                            for k, v in b.items()} for b in batches}
    manifest = {"torch_version": torch.__version__,
                "entries": sigs,
                "num_classes": cfg.num_classes,
                "ct_feature_dim": ct_feature_dim,
                "config": cfg.to_dict()}
    buf = io.BytesIO()
    torch.save({"manifest": json.dumps(manifest),
                "state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()}}, buf)
    return buf.getvalue()


def save_artifact(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


class ServingModel:
    """A loaded artifact: ``call(batch) -> probs`` (numpy in, numpy out),
    dispatching on the batch's exact shape signature.  Runs on the CUDA
    card unless ``device`` names another."""

    def __init__(self, blob: bytes, device=None):
        self.device = resolve_device(device)
        raw = torch.load(io.BytesIO(blob), map_location="cpu",
                         weights_only=True)
        self.manifest = json.loads(raw["manifest"])
        cfg = Config.from_dict(self.manifest["config"])
        self.model = build_model(
            cfg, device=self.device,
            ct_feature_dim=self.manifest.get("ct_feature_dim"))
        self.model.load_state_dict(raw["state_dict"], strict=True)

    @property
    def signatures(self):
        return self.manifest["entries"]

    def call(self, batch: Mapping[str, Any]) -> np.ndarray:
        key = _entry_key(batch)
        if key not in self.signatures:
            have = "\n  ".join(sorted(self.signatures))
            raise KeyError(
                f"no exported entry for signature\n  {key}\n"
                f"available:\n  {have}")
        with torch.inference_mode():
            tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                       .to(self.device) for k, v in batch.items()}
            probs = self.model(tensors)["probs"]
            return probs.float().cpu().numpy()


def load_artifact(path: str, device=None) -> ServingModel:
    with open(path, "rb") as f:
        return ServingModel(f.read(), device=device)


def main(argv=None) -> str:
    """Export seeded-random or saved weights as a serving artifact."""
    parser = create_arg_parser()
    parser.description = main.__doc__
    parser.add_argument("--out", required=True, help="artifact output path")
    parser.add_argument("--export_batch", type=int, default=1)
    parser.add_argument("--export_bags", type=str, default="",
                        help="bag lengths to export entries for "
                             "(default: cfg.bag_buckets)")
    parser.add_argument("--export_ct_depth", type=int, default=0,
                        help="CT slices per volume of the exported entries "
                             "(default: cfg.ct_shape[0])")
    parser.add_argument("--state_dict", type=str, default="",
                        help="torch.save'd state_dict to export; without "
                             "it the weights are random, made from --seed")
    parser.add_argument("--device", type=str, default=None,
                        help="device to build the weights on (default "
                             "cuda; pass cpu to run without a card)")
    ns = parser.parse_args(argv)
    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(ns).items() if k in names})

    bags = (ast.literal_eval(ns.export_bags) if ns.export_bags
            else (cfg.bag_buckets or [cfg.bag_max]))
    if isinstance(bags, int):
        bags = [bags]
    depth = ns.export_ct_depth or cfg.ct_shape[0]
    batches = ([make_example_batch(cfg, ns.export_batch, bag=b,
                                   ct_depth=depth) for b in bags]
               if "pathology" in cfg.modality else
               [make_example_batch(cfg, ns.export_batch, ct_depth=depth)])
    if ns.state_dict:
        resolve_device(ns.device)
        state_dict = torch.load(ns.state_dict, map_location="cpu",
                                weights_only=True)
        print(f"=> loaded state_dict '{ns.state_dict}'")
    else:
        print("WARNING: no --state_dict given; exporting seeded random "
              f"weights (seed {cfg.seed})")
        state_dict = build_model(cfg, device=ns.device).state_dict()
    blob = export_model(cfg, state_dict, batches)
    save_artifact(ns.out, blob)
    print(f"=> wrote {ns.out} ({len(blob) / 1e6:.1f} MB, {len(batches)} "
          f"signature(s))")
    return ns.out


if __name__ == "__main__":
    main()
