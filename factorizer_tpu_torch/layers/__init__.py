from .basic import ACTIVATIONS, MLP, Conv, ConvTranspose, Identity, LayerNorm, Linear
from .pos_embed import PositionalEmbedding

__all__ = [
    "ACTIVATIONS",
    "MLP",
    "Conv",
    "ConvTranspose",
    "Identity",
    "LayerNorm",
    "Linear",
    "PositionalEmbedding",
]
