"""llmmil_tpu_torch — the PyTorch/CUDA port of ``llmmil_tpu``.

A second package beside the JAX one, module for module, for one NVIDIA
Hopper card: plain tensor code is stock PyTorch, and each Pallas kernel of
the JAX package is a kernel written by hand in CUDA C++
(``csrc/`` + ``ops/kernels/``).  It imports ``torch`` and nothing of JAX or
of ``llmmil_tpu``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .config import Config, parse_config

__version__ = "0.1.0"
__all__ = ["Config", "parse_config"]
