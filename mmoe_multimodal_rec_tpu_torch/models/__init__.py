"""The MMoE model in PyTorch, baseline and HoME, for serving and
training: the encoders with per-layer recompute (model.remat), the
shared-base text expert, the dense and top-k gated heads."""
from .bert import BertEncoder, BertLayer
from .cross import EnhancedCrossFuse, RobustTextCrossExpert
from .heads import DenseGate, TopKGate, Tower, TwoTaskMMoE
from .home import (FeatureGate, HomeExpertWrapper, HomeMMoEHead, HomeTower,
                   SelfGate)
from .image_expert import (ImageExpertWithProjection, ItemImageExpert,
                           normalize_patches)
from .layers import (Attention, AttnPool1D, BatchNorm1D, LoRADense, Mlp,
                     PreNormBlock)
from .mmoe import MMoERecModel, ModelOutputs
from .text_expert import DualTextExpert, TextExpert
from .vit import ViTEncoder, ViTLayer

__all__ = [
    "BertEncoder", "BertLayer", "EnhancedCrossFuse", "RobustTextCrossExpert",
    "DenseGate", "TopKGate", "Tower", "TwoTaskMMoE", "FeatureGate",
    "HomeExpertWrapper", "HomeMMoEHead", "HomeTower", "SelfGate",
    "ImageExpertWithProjection", "ItemImageExpert", "normalize_patches",
    "Attention", "AttnPool1D", "BatchNorm1D", "LoRADense", "Mlp",
    "PreNormBlock", "MMoERecModel", "ModelOutputs", "DualTextExpert",
    "TextExpert", "ViTEncoder", "ViTLayer",
]
