from .basic import (
    ACTIVATIONS,
    MLP,
    Conv,
    ConvTranspose,
    GroupNorm,
    Identity,
    InstanceNorm,
    LayerNorm,
    Linear,
    resolve_activation,
)
from .pos_embed import PositionalEmbedding

__all__ = [
    "ACTIVATIONS",
    "MLP",
    "Conv",
    "ConvTranspose",
    "GroupNorm",
    "Identity",
    "InstanceNorm",
    "LayerNorm",
    "Linear",
    "PositionalEmbedding",
    "resolve_activation",
]
