"""Rendering core: BSDF terms and sampling, light selection, shading, and
the wavefront integrator.

The public names load on first use: ``scene.textures`` reads
``render.texture``, and the integrator reads the scene, so an eager import
here would be circular."""

import importlib

# name -> the submodule that defines it (itself, for a submodule).
_EXPORTS = {
    "brdf": "brdf",
    "bsdf_sampling": "bsdf_sampling",
    "onb": "onb",
    "env_radiance": "envmap",
    "RenderContext": "integrator",
    "generate_primary_rays": "integrator",
    "make_context": "integrator",
    "render": "integrator",
    "render_pass": "integrator",
    "resolve": "integrator",
    "LightSample": "light_sampling",
    "compute_light_sample": "light_sampling",
    "ShadeResult": "shade",
    "shade_hits": "shade",
    "compute_multiscattering": "multiscatter",
    "generate_multiscatter_lut": "multiscatter",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
    return module if _EXPORTS[name] == name else getattr(module, name)
