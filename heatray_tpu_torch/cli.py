"""Command-line interface: render, optimize, sequence-vis (port of
``heatray_tpu.cli``, with the same arguments and defaults).

    python -m heatray_tpu_torch.cli render --scene model.ply --size 1920 1080 \\
        --depth 4 --passes 4 --out render.exr

``--scene`` is a built-in scene's name, a session ``.json`` or a model file
(OBJ, PLY, STL, OFF, glTF/GLB, DAE, FBX).  Everything runs on the CUDA card
unless ``--cpu`` is given; without a card and without ``--cpu`` the command
raises, as ``render`` does.  ``render --preview [PORT]`` serves the
progressive render over HTTP (``viewer.py``); with ``--edit`` as well, it
runs the edit loop (``interactive.py``) over that server until interrupted.
The ``benchmark`` command is not ported yet: it raises
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The ROADMAP items that port what this CLI does not have yet.
_NOT_PORTED = {
    "benchmark": "ROADMAP Queue 1 item 1 (bench_gpu.py; the root bench.py imports JAX)",
}
SAMPLE_MODES = ["sobol", "halton", "hammersley", "bluenoise", "random"]
BOKEH_SHAPES = ["circular", "pentagon", "hexagon", "octagon"]
HDR_SUFFIXES = (".tiff", ".tif", ".npy", ".exr", ".hdr")


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to heatray_tpu_torch yet: "
                              f"{_NOT_PORTED[what]}")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--scene", default="multi-material",
                   help="built-in scene name or path to a session .json / model file")
    p.add_argument("--size", type=int, nargs=2, default=(512, 512),
                   metavar=("W", "H"))
    p.add_argument("--passes", type=int, default=32)
    p.add_argument("--depth", type=int, default=10)
    p.add_argument("--sample-mode", default="sobol", choices=SAMPLE_MODES)
    p.add_argument("--bokeh", default="circular", choices=BOKEH_SHAPES)
    p.add_argument("--orbit", type=float, nargs=3, default=(6.0, 0.0, 0.3),
                   metavar=("DIST", "PHI", "THETA"))
    p.add_argument("--focal-length", type=float, default=50.0, help="mm")
    p.add_argument("--focus-distance", type=float, default=None, help="m")
    p.add_argument("--fstop", type=float, default=0.0,
                   help="aperture f-stop; 0 = pinhole")
    p.add_argument("--env", default=None,
                   help="lat/long HDR image path (or built-in environment name) for "
                        "environment lighting")
    p.add_argument("--env-exposure", type=float, default=0.0)
    p.add_argument("--env-rotation", type=float, default=0.0)
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the kernels' plain versions), not the card")
    p.add_argument("--max-channel", type=float, default=3.14159265,
                   help="firefly clamp (maxChannelValue)")


def _device(args) -> str:
    return "cpu" if args.cpu else "cuda"


def build(args):
    """(scene, camera, options) the arguments describe, on the host."""
    from .camera import orbit_camera
    from .options import AOV, RenderOptions
    from .scene.builtin import BUILTIN_SCENES
    from .scene.lights import EnvironmentLightDesc

    w, h = args.size
    env = None
    if args.env:
        from .scene.environments import BUILTIN_ENVIRONMENTS

        if args.env in BUILTIN_ENVIRONMENTS:
            from .scene.environments import get_environment

            image = get_environment(args.env)  # already top row first
        else:
            from .io_utils.image import load_image

            # EnvironmentLightDesc.image is top row first (sky at row 0);
            # load_image returns bottom row first, so flip.
            image = load_image(args.env)[::-1]
        env = EnvironmentLightDesc(image=image, exposure=args.env_exposure,
                                   rotation=args.env_rotation)

    if args.scene in BUILTIN_SCENES:
        builder = BUILTIN_SCENES[args.scene]
        try:
            scene = builder(env=env)
        except TypeError:
            scene = builder()
    elif args.scene.endswith(".json"):
        from .io_utils.session import load_session

        return load_session(args.scene, override_size=(w, h))
    else:
        from .scene.loaders import load_model_scene

        scene = load_model_scene(args.scene, env=env)

    aperture = 0.0
    if args.fstop > 0.0:
        # ``RenderOptions::Camera::setApertureRadius`` (PassGenerator.h:93).
        aperture = (args.focal_length / args.fstop) / 1000.0
    dist, phi, theta = args.orbit
    camera = orbit_camera(
        w, h, distance=dist, phi=phi, theta=theta,
        focal_length_mm=args.focal_length,
        focus_distance=args.focus_distance,
        aperture_radius=aperture,
    )
    options = RenderOptions(
        width=w, height=h, max_render_passes=max(args.passes, 1),
        max_ray_depth=args.depth, sample_mode=args.sample_mode,
        bokeh_shape=args.bokeh,
        aov=AOV(getattr(args, "aov", "none")),
        debug_pass_rendering=getattr(args, "debug_pass", None) is not None,
        debug_pass_index=getattr(args, "debug_pass", None) or 0,
    )
    return scene, camera, options


def cmd_render(args) -> int:
    import contextlib

    import torch

    from .post import PostProcessingParams
    from .render.integrator import render

    device = _device(args)
    scene, camera, options = build(args)
    t0 = time.time()
    post = PostProcessingParams(tonemapping_enabled=args.tonemap)
    pass_callback = viewer = None
    if args.preview is not None:
        from .viewer import ProgressiveViewer

        viewer = ProgressiveViewer(port=args.preview).start()
        print(f"live preview: http://localhost:{viewer.port}/ "
              f"(updates every {args.preview_every} pass(es))", file=sys.stderr)
        pass_callback = viewer.make_callback(options, post, every=args.preview_every)
    if args.edit:
        if viewer is None:
            print("--edit requires --preview", file=sys.stderr)
            return 2
        return _edit_loop(args, scene, camera, options, post, viewer, device)
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([] if device == "cpu" else [ProfilerActivity.CUDA])
        trace_cm = profile(activities=activities)
    else:
        trace_cm = contextlib.nullcontext()
    with trace_cm as prof:
        accum, _ = render(scene, camera, options, num_passes=args.passes,
                          max_channel_value=args.max_channel, pass_callback=pass_callback,
                          device=device)
        if device != "cpu":
            torch.cuda.synchronize()
    dt = time.time() - t0
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"wrote torch.profiler trace to {path}", file=sys.stderr)
    print(f"rendered {options.width}x{options.height} x{args.passes} passes "
          f"in {dt:.1f}s", file=sys.stderr)

    _save(args.out, accum, post)
    if viewer is not None:
        if args.preview_hold:
            print("render done; preview still serving (ctrl-C to exit)", file=sys.stderr)
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
        viewer.stop()
    return 0


def _save(path, accum, post):
    import torch

    from .io_utils.image import save_hdr, save_ldr
    from .post import apply_post_pipeline
    from .render.integrator import resolve

    with torch.no_grad():
        if path.lower().endswith(HDR_SUFFIXES):
            save_hdr(path, resolve(accum).cpu().numpy())
        else:
            save_ldr(path, apply_post_pipeline(accum, post).cpu().numpy())
    print(f"wrote {path}", file=sys.stderr)


def _edit_loop(args, scene, camera, options, post, viewer, device) -> int:
    """``render --preview --edit``: the edit loop over the preview server,
    serving until interrupted; then the last accumulation is written."""
    from .interactive import InteractiveRenderer

    dist, phi, theta = args.orbit
    r = InteractiveRenderer(
        scene, camera, options, post=post, viewer=viewer,
        orbit=dict(distance=dist, phi=phi, theta=theta, focal_length=args.focal_length,
                   fstop=args.fstop, focus_distance=args.focus_distance),
        max_channel_value=args.max_channel, device=device,
    )
    viewer.set_scene_info(r.scene_info())
    print("interactive edit loop: POST /edit on the preview port", file=sys.stderr)
    accum = r.run(publish_every=args.preview_every)
    viewer.stop()
    _save(args.out, accum, r.post)
    return 0


def cmd_sequence_vis(args) -> int:
    from .io_utils.image import save_ldr
    from .sampling.visualize import scatter_image, sequence_points

    pts = sequence_points(
        sample_mode=args.sample_mode,
        bokeh_shape=args.bokeh,
        sequence_index=args.sequence,
        count=args.count,
        aperture=args.aperture,
    )
    img = scatter_image(pts, size=args.plot_size, aperture=args.aperture)
    save_ldr(args.out, img)
    print(f"wrote {args.out} ({args.count} points)", file=sys.stderr)
    return 0


def cmd_benchmark(args) -> int:
    _not_ported("benchmark")


def cmd_optimize(args) -> int:
    import torch

    from .diff.inverse import optimize
    from .io_utils.image import load_image
    from .render.integrator import make_context

    device = _device(args)
    scene, camera, options = build(args)
    target = torch.from_numpy(load_image(args.target)[..., :3].copy())
    if tuple(target.shape[:2]) != (options.height, options.width):
        raise ValueError(f"target {tuple(target.shape)} vs render "
                         f"{options.height}x{options.width}")
    scene = scene.to(device)
    ctx = make_context(options, scene, device, static_shading=False)
    init = {
        "base_color": scene.materials.base_color,
        "roughness": scene.materials.roughness,
    }
    params, _ = optimize(
        scene, camera, ctx, options, target, init,
        steps=args.steps, learning_rate=args.lr, num_passes=args.passes_per_step,
        callback=lambda i, loss, p: print(f"step {i}: loss {loss:.6f}", file=sys.stderr)
        if i % 10 == 0 else None,
    )
    print(json.dumps({k: v.cpu().numpy().tolist() for k, v in params.items()}))
    return 0


def make_parser() -> argparse.ArgumentParser:
    """The parser of every command (``args.fn`` runs the chosen one)."""
    from .options import AOV

    parser = argparse.ArgumentParser(prog="heatray_tpu_torch",
                                     description="PyTorch/CUDA path tracer")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render a scene to an image")
    _add_common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--tonemap", action="store_true", help="enable ACES tonemap")
    p.add_argument("--aov", default="none", choices=[m.value for m in AOV],
                   help="debug visualization mode (PassGenerator.h:123-141)")
    p.add_argument("--debug-pass", type=int, default=None, metavar="INDEX",
                   help="freeze rendering to this single pass index "
                        "(PassGenerator.h:145-149)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render to DIR/trace.json")
    p.add_argument("--preview", type=int, nargs="?", const=8000, default=None,
                   metavar="PORT", help="live progressive preview over HTTP")
    p.add_argument("--preview-every", type=int, default=1, metavar="N",
                   help="update the preview every N passes")
    p.add_argument("--preview-hold", action="store_true",
                   help="keep serving the preview after the render finishes")
    p.add_argument("--edit", action="store_true",
                   help="interactive edit loop over the preview server")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser(
        "sequence-vis",
        help="scatter-plot a QMC sequence prefix to a PNG "
             "(HeatrayRenderer.cpp:455-498)",
    )
    p.add_argument("--sample-mode", default="sobol", choices=SAMPLE_MODES)
    p.add_argument("--bokeh", default="circular", choices=BOKEH_SHAPES)
    p.add_argument("--sequence", type=int, default=0, help="sequence index")
    p.add_argument("--count", type=int, default=64, help="prefix length")
    p.add_argument("--aperture", action="store_true",
                   help="plot the bokeh aperture distribution instead")
    p.add_argument("--plot-size", type=int, default=256)
    p.add_argument("--out", default="sequence.png")
    p.set_defaults(fn=cmd_sequence_vis)

    p = sub.add_parser("benchmark", help="measure rays/s (not ported yet)")
    _add_common(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("optimize", help="inverse-render material parameters")
    _add_common(p)
    p.add_argument("--target", required=True, help="target image path")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--passes-per-step", type=int, default=1)
    p.set_defaults(fn=cmd_optimize)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
