from .abmil import ABMIL, ABMILv2
from .aggregator import Aggregator, build_model
from .baselines import AggregatorConcat
from .clip_text import CLIPTextConfig, CLIPTextEncoder, CoOpClinicalEncoder
from .ct_mc3 import DepthFoldedConv, ResnetMC3_18, VideoResNetFeatures
from .simple_fcs import SimpleFCsV1, SimpleFCsV1d, SimpleFCsV2, SimpleFCsV2d
from .twoway import (Attention, MLPBlock, TwoWayAttentionBlock,
                     TwoWayTransformer)

__all__ = [
    "SimpleFCsV1", "SimpleFCsV1d", "SimpleFCsV2", "SimpleFCsV2d",
    "ABMIL", "ABMILv2", "TwoWayTransformer", "TwoWayAttentionBlock",
    "Attention", "MLPBlock", "CLIPTextEncoder", "CoOpClinicalEncoder",
    "CLIPTextConfig", "ResnetMC3_18", "VideoResNetFeatures",
    "DepthFoldedConv", "Aggregator", "AggregatorConcat", "build_model",
]
