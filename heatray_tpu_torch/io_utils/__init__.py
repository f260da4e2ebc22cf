"""Image and session I/O (port of ``heatray_tpu.io_utils``)."""

from .image import load_image, save_hdr, save_ldr

__all__ = ["load_image", "save_hdr", "save_ldr"]
