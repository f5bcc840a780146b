from .deconver import Deconver, DeconverBlock, DeconverStage, DeconvMixer, Stem
from .factorizer import FactMixer, Factorizer, FactorizerBlock, FactorizerStage
from .unet import UNet

__all__ = [
    "DeconvMixer", "Deconver", "DeconverBlock", "DeconverStage", "Stem",
    "FactMixer", "Factorizer", "FactorizerBlock", "FactorizerStage", "UNet",
]
