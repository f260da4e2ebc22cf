"""Helpers around the renderer (camera framing)."""
