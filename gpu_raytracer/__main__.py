"""Command-line application.

The headless counterpart of the reference's windowed app
(src/main.rs): render frames, path-trace progressively, run
a scripted fly-through (the WASD/mouse interaction surface, main.rs:150-197),
inspect glTF files, and benchmark — with the compile-time constants promoted
to flags (SURVEY.md §5 "config").

    python -m gpu_raytracer render   [--gltf FILE | --demo | --courtyard N] -o out.png
    python -m gpu_raytracer pathtrace --spp 64 -o out.png
    python -m gpu_raytracer fly      --script "w w mouse:30,0 s" -o dir/
    python -m gpu_raytracer info     --gltf FILE
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .config import RaytracerConfig, add_config_args, config_from_args


def _load_scene(args, config):
    from .models.scene import build_default_scene

    if getattr(args, "gltf", None):
        from .models.gltf import scene_from_gltf_or_default

        return scene_from_gltf_or_default(args.gltf, config=config)
    if getattr(args, "courtyard", 0):
        from .utils.procgen import make_courtyard_scene

        return make_courtyard_scene(args.courtyard, seed=0, config=config,
                                    textured=getattr(args, "textured", False))
    return build_default_scene(config)


def _add_scene_args(p):
    p.add_argument("--gltf", type=str, default=None, help="glTF/GLB scene file")
    p.add_argument("--demo", action="store_true", help="built-in demo scene (default)")
    p.add_argument("--courtyard", type=int, default=0, metavar="TRIS",
                   help="procedural courtyard with ~TRIS triangles")
    p.add_argument("--textured", action="store_true",
                   help="courtyard variant with procedural texture atlases")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("-o", "--output", type=str, default="out.png")


def cmd_render(args, config):
    from .engine.renderer import Renderer
    from .utils.image import write_png
    from .models.scene import print_memory_usage

    scene = _load_scene(args, config)
    print_memory_usage(scene)
    r = Renderer(scene, args.width, args.height, config=config,
                 shadows=args.shadows)
    t0 = time.time()
    img = r.render()
    dt = time.time() - t0
    rays = args.width * args.height * 3
    print(f"frame: {dt*1e3:.1f}ms ({rays/dt/1e6:.1f} Mrays/s ref-equiv, "
          f"incl. compile on first run)")
    write_png(args.output, img)
    print(f"wrote {args.output}")


def cmd_pathtrace(args, config):
    from .engine.pathtracer import PathTracer
    from .utils.image import write_png

    scene = _load_scene(args, config)
    if args.adaptive:
        from .engine.adaptive import AdaptivePathTracer
        pt = AdaptivePathTracer(scene, args.width, args.height,
                                config=config, spectral=args.spectral,
                                shadows=not args.no_shadows, seed=args.seed,
                                tiles_per_step=args.adaptive)
    else:
        pt = PathTracer(scene, args.width, args.height, config=config,
                        spectral=args.spectral, shadows=not args.no_shadows,
                        seed=args.seed, sampler=args.sampler)
    if args.resume and os.path.exists(args.resume):
        pt.load_checkpoint(args.resume)
        print(f"resumed at {pt.samples} spp")
    img = pt.render(args.spp, progress=True)
    if args.checkpoint:
        pt.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    if args.denoise:
        img = pt.denoised_image(iterations=args.denoise_iters)
        print(f"denoised ({args.denoise_iters} a-trous iterations)")
    # display output is sRGB by default (utils/image.py header);
    # --linear keeps raw linear u8 for data/parity use
    write_png(args.output, img, srgb=not args.linear)
    print(f"wrote {args.output} ({pt.samples} spp)")


def cmd_fly(args, config):
    from .engine.viewer import Viewer
    from .utils.image import write_png

    scene = _load_scene(args, config)
    v = Viewer(scene, args.width, args.height, config=config,
               shadows=args.shadows)
    if args.pathtrace:
        # the full interactive quality stack: wavefront path tracing with
        # temporal reprojection across the scripted camera moves and the
        # a-trous denoised preview while each stop's accumulation is young
        v.handle_key("p")
    os.makedirs(args.output, exist_ok=True)
    script = []
    for tok in args.script.split():
        if tok.startswith("mouse:"):
            dx, dy = tok[6:].split(",")
            script.append(("mouse", float(dx), float(dy)))
        else:
            script.append(("key", tok))
    frames = v.fly_through(script, frames_per_step=args.frames_per_step)
    for i, f in enumerate(frames):
        write_png(os.path.join(args.output, f"frame_{i:04d}.png"), f)
    print(f"wrote {len(frames)} frames to {args.output}/")


def cmd_serve(args, config):
    from .engine.viewer import Viewer
    from .engine.server import ViewerServer

    scene = _load_scene(args, config)
    v = Viewer(scene, args.width, args.height, config=config,
               shadows=args.shadows)
    ViewerServer(v, host=args.host, port=args.port,
                 max_fps=args.max_fps).serve_forever()


def cmd_window(args, config):
    from .engine.viewer import Viewer
    from .engine.window import NativeWindow, window_available

    if not window_available():
        print("error: no display server reachable (Tk root failed); "
              "use `serve` for the HTTP live viewer on headless hosts",
              file=sys.stderr)
        raise SystemExit(1)
    scene = _load_scene(args, config)
    v = Viewer(scene, args.width, args.height, config=config,
               shadows=args.shadows)
    NativeWindow(v, max_fps=args.max_fps).run()


def cmd_info(args, config):
    from .models.gltf import GltfError, GltfLoader

    try:
        loader = GltfLoader.load_from_path(args.gltf)
    except GltfError as e:   # clean CLI error, not a traceback
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(1)
    print("scenes: ", loader.list_scenes())
    print("cameras:", loader.list_cameras())
    print("lights: ", loader.list_lights())
    loaded = loader.extract_scene(args.scene_index)
    print(f"triangles={loaded.triangles.shape[0]} "
          f"vertices={loaded.vertices.shape[0]} "
          f"materials={len(loaded.materials)} lights={len(loaded.lights)} "
          f"images={len(loaded.images)}")


def cmd_export(args, config):
    """Scene → .glb through the writer (models/gltf_export.py): ships the
    demo/courtyard scenes — or re-packs a loaded glTF — as self-contained
    binary assets the loader (and any glTF 2.0 consumer) ingests."""
    from .models.gltf_export import export_glb

    scene = _load_scene(args, config)
    images = wraps = None
    if getattr(args, "courtyard", 0) and getattr(args, "textured", False):
        from .utils.procgen import courtyard_source_images

        images = courtyard_source_images(0)
    elif getattr(args, "gltf", None):
        from .models.gltf import load_gltf

        loaded = load_gltf(args.gltf)
        if loaded.images:
            # one image per TEXTURE slot, alignment preserved (a dangling
            # source index gets the white placeholder, not a compaction
            # that would shift every later texture), wrap modes forwarded
            images = [loaded.images[i] if i < len(loaded.images)
                      else np.full((1, 1, 4), 255, np.uint8)
                      for i in loaded.texture_image]
            wraps = [loaded.texture_wrap[t] if t < len(loaded.texture_wrap)
                     else 0 for t in range(len(loaded.texture_image))]
    export_glb(scene, args.output, images=images, texture_wrap=wraps)
    print(f"wrote {args.output} ({os.path.getsize(args.output)} bytes, "
          f"{scene.num_triangles} triangles)")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="gpu_raytracer")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="single-frame Whitted render")
    _add_scene_args(p)
    p.add_argument("--shadows", action="store_true")
    add_config_args(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("pathtrace", help="progressive path tracing")
    _add_scene_args(p)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--spectral", action="store_true",
                   help="one ray per wavelength channel (true dispersion)")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--linear", action="store_true",
                   help="write raw linear u8 instead of the default sRGB "
                        "display encode")
    p.add_argument("--denoise", action="store_true",
                   help="edge-avoiding a-trous reconstruction filter")
    p.add_argument("--denoise-iters", type=int, default=4)
    p.add_argument("--sampler", choices=("qmc", "rng"), default="qmc",
                   help="qmc: low-discrepancy lattice sampling (~2x lower "
                        "MSE per spp); rng: independent threefry stream")
    p.add_argument("--adaptive", type=int, default=0, metavar="K",
                   help="variance-guided sampling: each step refines the K "
                        "highest-error 64x64 tiles (0 = uniform; --spp then "
                        "counts steps, average spp = spp*K/tiles)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    add_config_args(p)
    p.set_defaults(fn=cmd_pathtrace)

    p = sub.add_parser("fly", help="scripted interactive fly-through")
    _add_scene_args(p)
    p.add_argument("--script", type=str, default="w w d mouse:40,0 w",
                   help="space-separated keys (w/a/s/d/space/l) and mouse:dx,dy")
    p.add_argument("--frames-per-step", type=int, default=1)
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--pathtrace", action="store_true",
                   help="path-traced fly-through: temporal reprojection "
                        "carries the accumulation across camera moves, "
                        "frames-per-step = spp added at each stop, young "
                        "frames present denoised")
    add_config_args(p)
    p.set_defaults(fn=cmd_fly)

    p = sub.add_parser("serve", help="live viewer over HTTP (browser WASD)")
    p.add_argument("--gltf", type=str, default=None)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--courtyard", type=int, default=0, metavar="TRIS",
                   help="procedural courtyard with TRIS triangles")
    p.add_argument("--textured", action="store_true",
                   help="with --courtyard: procedural texture atlases")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--max-fps", type=float, default=30.0)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("window", help="native OS-window viewer (Tk present)")
    p.add_argument("--gltf", type=str, default=None)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--courtyard", type=int, default=0, metavar="TRIS",
                   help="procedural courtyard with TRIS triangles")
    p.add_argument("--textured", action="store_true",
                   help="with --courtyard: procedural texture atlases")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--shadows", action="store_true")
    p.add_argument("--max-fps", type=float, default=120.0)
    p.set_defaults(fn=cmd_window)

    p = sub.add_parser("export", help="write a scene as a binary glTF (.glb)")
    _add_scene_args(p)
    # _add_scene_args defaults -o to out.png (the render subcommands');
    # export writes GLB bytes, so the default must carry the right extension
    p.set_defaults(fn=cmd_export, output="out.glb")

    p = sub.add_parser("info", help="inspect a glTF file")
    p.add_argument("--gltf", type=str, required=True)
    p.add_argument("--scene-index", type=int, default=None)
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    from .device import enable_compile_cache

    enable_compile_cache()
    config = config_from_args(args) if hasattr(args, "tile_size") else RaytracerConfig()
    args.fn(args, config)


if __name__ == "__main__":
    main()
