from .segresnet import SegResNet
from .unet import UNet
from .unetr import UNETR

__all__ = ["SegResNet", "UNet", "UNETR"]
