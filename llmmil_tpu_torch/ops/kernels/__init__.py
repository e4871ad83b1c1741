"""Hand-written CUDA kernels of the port: wrappers and plain versions.

The sources are in ``llmmil_tpu_torch/csrc``; ``build.py`` compiles them at
first use.
"""

from .conv3x3 import (FWD_MODES, WGRAD_MODES, conv3x3, conv3x3_dgrad,
                      conv3x3_dgrad_plain, conv3x3_fwd, conv3x3_patch,
                      conv3x3_patch_plain, conv3x3_plain, conv3x3_tout,
                      conv3x3_tout_plain, conv3x3_wgrad, conv3x3_wgrad_plain,
                      conv3x3_wgrad_tout, conv3x3_wgrad_tout_plain)
from .mil_pool import mil_pool, mil_pool_plain


def resolve_use_kernel(val, raw_bag: bool) -> bool:
    """Resolve the ``use_pallas`` config knob to a concrete bool.

    True/False (or their CLI string forms) force either path; ``'auto'``
    turns the fused kernel on exactly where a RAW bag is pooled (the
    concat baseline's 768-d rows) and off for the flagship's fused
    streams.  That is the JAX package's rule with its backend gate left
    out: whether the kernel launches is decided by where the tensor lies
    (``mil_pool`` launches it for a CUDA tensor and takes the plain
    version for a CPU tensor).
    """
    if isinstance(val, str):
        v = val.strip().lower()
        if v == "auto":
            return bool(raw_bag)
        return v in ("1", "true", "yes", "on")
    return bool(val)


__all__ = ["FWD_MODES", "WGRAD_MODES", "conv3x3", "conv3x3_dgrad",
           "conv3x3_dgrad_plain", "conv3x3_fwd", "conv3x3_patch",
           "conv3x3_patch_plain", "conv3x3_plain", "conv3x3_tout",
           "conv3x3_tout_plain", "conv3x3_wgrad", "conv3x3_wgrad_plain",
           "conv3x3_wgrad_tout", "conv3x3_wgrad_tout_plain", "mil_pool",
           "mil_pool_plain", "resolve_use_kernel"]
