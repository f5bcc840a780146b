from .deconver import Deconver, DeconverBlock, DeconverStage, DeconvMixer, Stem
from .dynunet import DynUNet, DynUNetBlock
from .factorizer import FactMixer, Factorizer, FactorizerBlock, FactorizerStage
from .segresnet import SegResBlock, SegResNet
from .swinunetr import PatchMerging, SwinBlock, SwinUNETR, WindowAttention
from .unet import Same, UNet
from .unetr import UNETR

__all__ = [
    "DeconvMixer", "Deconver", "DeconverBlock", "DeconverStage", "Stem",
    "DynUNet", "DynUNetBlock",
    "FactMixer", "Factorizer", "FactorizerBlock", "FactorizerStage",
    "PatchMerging", "SegResBlock", "SegResNet", "SwinBlock", "SwinUNETR", "WindowAttention",
    "Same", "UNet", "UNETR",
]
