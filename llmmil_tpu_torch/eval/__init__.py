"""Serving: ``export`` (artifact + ``ServingModel``) and ``serve`` (HTTP
daemon).  Both are also CLIs: ``python -m llmmil_tpu_torch.eval.export`` and
``python -m llmmil_tpu_torch.eval.serve``."""
