"""Training CLI: ``python -m llmmil_tpu_torch.train [--synthetic] ...``, with
the flags of the JAX package's ``scripts/train.py`` (one per ``Config``
field, plus ``--synthetic`` and ``--cpu``).

It trains on the CUDA card; ``--cpu`` runs on the CPU instead (debugging).
``--synthetic`` trains on the deterministic synthetic cohort (8 patients a
hospital, 16 x 64 x 64 volumes padded to ``ct_shape``); without it the cohort comes from
``path_data_excel`` and the samples from files, which the port does not read
yet (ROADMAP.md, Queue 1 item 12).

Example (the tri-modal flagship on the synthetic cohort):

  python -m llmmil_tpu_torch.train --synthetic \\
      --modality "['CT','pathology']" --model_CI CLIP \\
      --CI_input_version text --aggregator ABMIL --use_pallas true \\
      --ct_conv_backend pallas --loss_point CT-Pth-Last --n_epochs 1
"""

from __future__ import annotations

import dataclasses

from ..config import Config, create_arg_parser
from ..device import resolve_device


def main(argv=None):
    parser = create_arg_parser()
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--cpu", action="store_true")
    ns = parser.parse_args(argv)
    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(ns).items() if k in names})
    device = resolve_device("cpu" if ns.cpu else None)

    from ..data import BatchLoader, MultimodalDataset, SyntheticCohort
    from ..parallel import ShardedEpochSampler
    from .loop import fit

    if ns.synthetic:
        # as the JAX package's CLI: 16 x 64 x 64 volumes, padded to
        # ct_shape when a sample loads
        syn = SyntheticCohort(cfg, n_per_hospital=8, seed=cfg.seed)
        train_ds = syn.dataset(cfg, "train")
        valid_ds = syn.dataset(cfg, "valid")
    else:
        train_ds = MultimodalDataset(cfg, "train")
        valid_ds = MultimodalDataset(cfg, "valid")
    sampler = ShardedEpochSampler(len(train_ds), shuffle=True, seed=cfg.seed)
    train_loader = BatchLoader(train_ds, cfg.batch_size, sampler=sampler,
                               num_workers=cfg.num_workers,
                               pool=cfg.loader_pool)
    valid_loader = BatchLoader(valid_ds, cfg.batch_size, shuffle=False,
                               num_workers=cfg.num_workers,
                               pool=cfg.loader_pool)
    summary = fit(cfg, train_loader, valid_loader,
                  profile_dir=cfg.profile_dir or None, device=device)
    print(f"best valid AUC: {summary['best_auc']:.4f} "
          f"(saved to {summary['save_dir']})")
    return summary


if __name__ == "__main__":
    main()
