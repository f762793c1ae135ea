from .api import DEFAULT_CONFIG, render
from .types import Camera, RasterizeConfig, ScreenGaussians

__all__ = ["DEFAULT_CONFIG", "render", "Camera", "RasterizeConfig", "ScreenGaussians"]
