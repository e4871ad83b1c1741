from .activations import quick_gelu
from .masked import masked_mean, masked_softmax, segment_mean_landmarks
from .mil import gated_attention_logits, gated_attention_pool
from .positional import sinusoidal_pe

__all__ = [
    "sinusoidal_pe", "masked_softmax", "masked_mean",
    "segment_mean_landmarks", "gated_attention_logits",
    "gated_attention_pool", "quick_gelu",
]
