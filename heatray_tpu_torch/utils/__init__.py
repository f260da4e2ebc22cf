"""Helpers around the renderer: logging, timing and camera framing."""

from .framing import frame_scene
from .log import get_logger, install_ring_buffer_handler
from .timing import RenderTimers, Timer

__all__ = [
    "get_logger",
    "install_ring_buffer_handler",
    "Timer",
    "RenderTimers",
    "frame_scene",
]
