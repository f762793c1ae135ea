from .api import (
    DEFAULT_CONFIG,
    DepthRenderingMode,
    render,
    render_depth,
    render_orthographic,
)
from .types import Camera, RasterizeConfig, ScreenGaussians

__all__ = [
    "DEFAULT_CONFIG", "DepthRenderingMode", "render", "render_depth",
    "render_orthographic", "Camera", "RasterizeConfig", "ScreenGaussians",
]
