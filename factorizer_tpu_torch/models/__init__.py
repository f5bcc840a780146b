from .factorizer import FactMixer, Factorizer, FactorizerBlock, FactorizerStage
from .unet import UNet

__all__ = ["FactMixer", "Factorizer", "FactorizerBlock", "FactorizerStage", "UNet"]
