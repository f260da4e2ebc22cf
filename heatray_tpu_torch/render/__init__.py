"""Rendering core: BSDF terms and sampling, light selection, shading, and
the wavefront integrator."""
