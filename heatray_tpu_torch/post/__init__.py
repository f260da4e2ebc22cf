"""Display post-processing: the ACES tonemap and the colour pipeline (port
of ``heatray_tpu.post``)."""

from .pipeline import PostProcessingParams, aces_tonemap, apply_post_pipeline

__all__ = ["PostProcessingParams", "aces_tonemap", "apply_post_pipeline"]
