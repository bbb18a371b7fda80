from .models import PatchDiscriminator, ResnetGenerator
from .train import train_cyclegan, train_pix2pix

__all__ = [
    "PatchDiscriminator",
    "ResnetGenerator",
    "train_cyclegan",
    "train_pix2pix",
]
