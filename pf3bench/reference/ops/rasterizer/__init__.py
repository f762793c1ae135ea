from .api import render
from .types import Camera, RasterizeConfig, ScreenGaussians

__all__ = ["render", "Camera", "RasterizeConfig", "ScreenGaussians"]
