#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU, through its entry points.

    python chip_smoke.py

One process drives every user-facing path once at full size and checks
what comes out; each phase prints one JSON line with its timings (first
call = compile + run, warm = median of runs ended by block_until_ready),
the memory analysis of its main compiled program and the device's peak
bytes in use, and its checks. Phases:

  1 primary      100k-triangle courtyard, Renderer at 1920x1080 with
                 shadows; a centred 128x64 tile against the XLA path on the
                 host CPU device; the default scene at 48x48 against the
                 NumPy oracle (reference/cpu_tracer.py)
  2 textured     the same courtyard with the 25.2-MTexel texture set
                 (4096² + 2x2048², mip pyramid, no atlas budget), 1080p,
                 same tile check
  3 gltf         phase 2's scene written as a .glb and read back with the
                 loader, rendered once; its difference from phase 2
  4 pathtrace    PathTracer at 1024², depth 4, shadows, spectral, QMC:
                 4 steps; then 64x64 at 16 spp against the CPU device
  5 interactive  Viewer path tracing at 1024², 4 moving one-dispatch
                 frames at interleave 8; one LBVH rebuild frame; the HTTP
                 server's /stats, /key and /stream
  6 cli          `render --courtyard 100000 ... -o frame.png`, in-process
  7 kernel       the traversal kernel against its XLA twin on the GPU, on
                 phase 1's rays, its shadow rays and a depth-2 bounce pool

Any failed check raises and the script exits non-zero. It refuses to run
without a GPU. The last line of stdout is one JSON object naming the
device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np

# GPU-vs-CPU tile parity: the two backends round differently (the GPU
# contracts multiply-adds), so a ray within rounding of a triangle edge or
# of an exact-t tie may pick another winner and its pixel another colour.
# At most this fraction of the tile's pixels may differ by more than
# PIXEL_TOL, and the mean difference must stay below MEAN_TOL.
PIXEL_TOL = 1e-3
EDGE_FRACTION = 1e-3
MEAN_TOL = 1e-4
# Path-traced 64x64 at 16 spp, GPU against the CPU device: both draw the
# identical QMC samples, but a path that grazes an edge can branch
# differently and from there on is an independent sample of the same
# estimator. The RMSE bound leaves room for a few per cent of diverged
# paths at 16 spp; a wrong estimator (bias, NaN, lost bounce) exceeds it.
PT_RMSE_TOL = 2e-2
# Traversal kernel vs its XLA twin on the same card (phase 7).
MASK_FRACTION = 1e-4
REL_T_TOL = 1e-5
ORACLE_RMSE_TOL = 1e-3     # BASELINE.json fidelity bar


def report(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp

    from gpu_raytracer import device

    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (devices: {jax.devices()})",
              file=sys.stderr)
        return 1
    cache = device.enable_compile_cache()
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    report("start", device_kind=gpu.device_kind, compile_cache=cache,
           jax=jax.__version__)

    from gpu_raytracer import Renderer, build_default_scene, render_image
    from gpu_raytracer.engine.renderer import render_chunk
    from gpu_raytracer.ops.packet_trace import tiled_pixel_order
    from gpu_raytracer.utils.procgen import (courtyard_source_images,
                                             make_courtyard_scene)

    def peak():
        return gpu.memory_stats().get("peak_bytes_in_use")

    def memory(jitted, *args, **kw):
        m = jitted.lower(*args, **kw).compile().memory_analysis()
        return {k: int(getattr(m, k)) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}

    def timed(fn, reps=5):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        first = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        warm = sorted(ts)[len(ts) // 2]
        return out, {"first_call_s": first, "warm_ms": warm * 1e3,
                     "compile_s_approx": first - warm}

    def tile_parity(scene, W, H):
        """Centred 128x64 tile: GPU main path vs the XLA path on the CPU
        device (device.py picks it there)."""
        px, py = tiled_pixel_order(128, 64, 64)
        px = jnp.asarray(px + (W - 128) // 2)
        py = jnp.asarray(py + (H - 64) // 2)
        kw = dict(shadows=True, leaf_size=scene.bvh.max_leaf)
        got = np.asarray(render_chunk(scene, px, py, W, H, **kw))
        with jax.default_device(cpu):
            sc = jax.device_put(scene, cpu)
            want = np.asarray(render_chunk(sc, jax.device_put(px, cpu),
                                           jax.device_put(py, cpu), W, H,
                                           **kw))
        diff = np.abs(got - want).max(axis=1)
        frac = float((diff > PIXEL_TOL).mean())
        out = {"tile_max_diff": float(diff.max()),
               "tile_mean_diff": float(diff.mean()),
               "tile_edge_fraction": frac,
               "tile_lit_fraction": float((want.max(axis=1) > 0).mean())}
        assert frac <= EDGE_FRACTION and diff.mean() <= MEAN_TOL, out
        return out

    W, H = 1920, 1080
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # ---- 1. primary ----
        t0 = time.perf_counter()
        scene = make_courtyard_scene(target_triangles=100_000, seed=0)
        build_s = time.perf_counter() - t0
        r = Renderer(scene, W, H, shadows=True)
        fb, t = timed(r.render_device)
        fb = np.asarray(fb)
        assert np.isfinite(fb).all() and fb.max() > 0.0
        px0, py0 = r._device_chunks()[0]
        mem = memory(render_chunk, scene, px0, py0, W, H, shadows=True,
                     leaf_size=scene.bvh.max_leaf)
        par = tile_parity(scene, W, H)
        dsc = build_default_scene()
        from gpu_raytracer.reference import cpu_tracer
        from gpu_raytracer.utils.image import rmse
        oracle = float(rmse(render_image(dsc, 48, 48),
                            cpu_tracer.render(cpu_tracer.scene_dict_from(dsc),
                                              48, 48)))
        assert oracle < ORACLE_RMSE_TOL, oracle
        report("primary", triangles=int(scene.num_triangles),
               bvh_nodes=int(scene.bvh.num_nodes), scene_build_s=build_s,
               mrays_per_s=W * H / (t["warm_ms"] * 1e-3) / 1e6, **t,
               memory=mem, peak_bytes=peak(), **par,
               oracle_rmse_48=oracle)

        # ---- 2. textured ----
        t0 = time.perf_counter()
        tex_scene = make_courtyard_scene(target_triangles=100_000, seed=0,
                                         textured=True, texture_size=4096)
        images = courtyard_source_images(0, texture_size=4096)
        build_s = time.perf_counter() - t0
        mtexel = sum(i.shape[0] * i.shape[1] for i in images) / 1e6
        assert mtexel > 25.0, mtexel
        # no atlas budget: every source texture keeps its level 0
        widths = sorted(int(w) for w in np.asarray(tex_scene.textures.width))
        assert widths == sorted(i.shape[1] for i in images), widths
        rt = Renderer(tex_scene, W, H, shadows=True)
        fbt, t = timed(rt.render_device)
        fbt = np.asarray(fbt)
        assert np.isfinite(fbt).all() and fbt.max() > 0.0
        px0, py0 = rt._device_chunks()[0]
        mem = memory(render_chunk, tex_scene, px0, py0, W, H, shadows=True,
                     leaf_size=tex_scene.bvh.max_leaf)
        par = tile_parity(tex_scene, W, H)
        report("textured", mtexel=mtexel,
               atlas_bytes=int(tex_scene.textures.data_u32.size * 4),
               mip_levels=int(tex_scene.textures.n_levels),
               scene_build_s=build_s,
               mrays_per_s=W * H / (t["warm_ms"] * 1e-3) / 1e6, **t,
               memory=mem, peak_bytes=peak(), **par)

        # ---- 3. glTF loader ----
        from gpu_raytracer.models.gltf import scene_from_gltf
        from gpu_raytracer.models.gltf_export import export_glb

        glb = os.path.join(tmp, "courtyard.glb")
        t0 = time.perf_counter()
        export_glb(tex_scene, glb, images=images)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gscene = scene_from_gltf(glb)
        load_s = time.perf_counter() - t0
        rg = Renderer(gscene, W, H, shadows=True)
        fbg, t = timed(rg.render_device, reps=2)
        fbg = np.asarray(fbg)
        assert np.isfinite(fbg).all()
        d = np.abs(fbg - fbt).max(axis=1)
        report("gltf", glb_mb=os.path.getsize(glb) / 1e6, export_s=export_s,
               load_s=load_s, triangles=int(gscene.num_triangles), **t,
               peak_bytes=peak(), max_diff_vs_textured=float(d.max()),
               mean_diff_vs_textured=float(d.mean()),
               pixels_differing=float((d > PIXEL_TOL).mean()))
        del gscene, rg, fbg

        # ---- 4. path tracing ----
        from gpu_raytracer.engine.pathtracer import (PathTracer,
                                                     _step_whole_frame)
        from gpu_raytracer.ops.wavefront import RGB_CHANNEL

        pt = PathTracer(scene, 1024, 1024, shadows=True, spectral=True)
        assert pt._whole_frame_ok() and pt.sampler == "qmc"
        cfg = pt.config

        def step():
            pt.step()
            return pt.accum

        _, t = timed(step, reps=3)
        img = pt.image()
        assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() > 0
        mem = memory(_step_whole_frame, pt.scene, pt.accum, pt.key,
                     jnp.int32(0), pt._px, pt._py, width=1024, height=1024,
                     channel=RGB_CHANNEL, max_depth=cfg.max_bounce_depth,
                     rr_start=cfg.russian_roulette_start, shadows=True,
                     leaf_size=cfg.bvh_leaf_size, use_bvh=pt.use_bvh,
                     antialias=True, spp=1, qmc=True, qmc_seed=pt._qmc_seed,
                     tex_lod_bias=cfg.bounce_lod_bias)
        counts = pt.counters().rays_per_bounce[:cfg.max_bounce_depth + 1]
        small = PathTracer(scene, 64, 64, shadows=True, spectral=True)
        got = small.render(16)
        with jax.default_device(cpu):
            ref = PathTracer(jax.device_put(scene, cpu), 64, 64,
                             shadows=True, spectral=True).render(16)
        pt_rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
        assert np.isfinite(got).all() and pt_rmse < PT_RMSE_TOL, pt_rmse
        report("pathtrace", size=1024, steps=4, **t,
               ms_per_spp=t["warm_ms"], rays_per_depth=counts, memory=mem,
               peak_bytes=peak(), rmse_64px_16spp_vs_cpu=pt_rmse,
               image_mean_64px=float(ref.mean()))
        del pt, small

        # ---- 5. interactive ----
        from gpu_raytracer.engine.pathtracer import _fly_frame
        from gpu_raytracer.engine.server import ViewerServer
        from gpu_raytracer.engine.viewer import Viewer
        from gpu_raytracer.models.scene import refit_scene

        v = Viewer(scene, 1024, 1024, shadows=True, verbose=False)
        v.handle_key("p")
        v.fly_interleave = 8
        v.run_compute()                      # the static first sample
        jax.block_until_ready(v._fb_dev)
        times = []
        for i in range(4):
            v.handle_key("d" if i % 2 == 0 else "a")
            t0 = time.perf_counter()
            v.run_compute()                  # moving: PathTracer.fly_frame
            jax.block_until_ready(v._fb_dev)
            times.append(time.perf_counter() - t0)
        fly = np.asarray(v.framebuffer)
        assert fly.shape == (1024, 1024, 3) and np.isfinite(fly).all()
        assert fly.max() > 0.0
        # each interleave phase is its own program (a static coset
        # stride), so every one of these frames includes a compile
        report("fly", size=1024, interleave=8,
               frame_ms_incl_compile=[x * 1e3 for x in times],
               compiled_fly_programs=_fly_frame._cache_size(),
               peak_bytes=peak())
        del v

        verts = np.asarray(scene.mesh.vertices)
        moved = jnp.asarray(verts + np.float32([0.0, 0.05, 0.0]))
        t0 = time.perf_counter()
        rscene = refit_scene(scene, moved, rebuild=True)
        rr = Renderer(rscene, W, H, shadows=True)
        fbr = np.asarray(jax.block_until_ready(rr.render_device()))
        first = time.perf_counter() - t0

        def refit_frame():
            return Renderer(refit_scene(scene, moved, rebuild=True), W, H,
                            shadows=True).render_device()

        _, t = timed(refit_frame, reps=3)
        assert np.isfinite(fbr).all() and fbr.max() > 0.0
        report("refit", lbvh_nodes=int(rscene.bvh.num_nodes),
               leaf=int(rscene.bvh.max_leaf), first_frame_s=first,
               warm_ms=t["warm_ms"], peak_bytes=peak())

        sv = Viewer(scene, 640, 384, shadows=True, verbose=False)
        srv = ViewerServer(sv, port=0)
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            stats = json.loads(urllib.request.urlopen(
                base + "/stats", timeout=60).read())
            z0 = stats["camera"][2]
            urllib.request.urlopen(urllib.request.Request(
                base + "/key?k=w", method="POST"), timeout=60).read()
            z1 = json.loads(urllib.request.urlopen(
                base + "/stats", timeout=60).read())["camera"][2]
            assert z1 != z0, (z0, z1)
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + "/stream",
                                        timeout=300) as s:
                length = None
                while True:
                    line = s.readline()
                    assert line, "stream closed before a frame"
                    if line.lower().startswith(b"content-length:"):
                        length = int(line.split(b":")[1])
                    elif line in (b"\r\n", b"\n") and length:
                        png = s.read(length)
                        break
            stream_s = time.perf_counter() - t0
            assert png[:8] == b"\x89PNG\r\n\x1a\n", png[:8]
        finally:
            srv.stop()
        report("server", camera_z=[z0, z1], first_part_bytes=len(png),
               first_part_s=stream_s)

        # ---- 6. CLI ----
        from gpu_raytracer.__main__ import main as cli

        out_png = os.path.join(tmp, "frame.png")
        t0 = time.perf_counter()
        cli(["render", "--courtyard", "100000", "--width", "1920",
             "--height", "1080", "--shadows", "-o", out_png])
        cli_s = time.perf_counter() - t0
        with open(out_png, "rb") as f:
            head = f.read(8)
        assert head == b"\x89PNG\r\n\x1a\n"
        report("cli", seconds=cli_s, png_bytes=os.path.getsize(out_png),
               peak_bytes=peak())

        # ---- 7. traversal kernel vs its XLA twin, both on the GPU ----
        from gpu_raytracer.ops.bvh_traverse import bvh_traverse_threaded
        from gpu_raytracer.ops.camera_rays import generate_rays
        from gpu_raytracer.ops.sampling import cosine_hemisphere
        from gpu_raytracer.ops.traverse_kernel import kernel_traverse
        from gpu_raytracer.ops.wavefront import _sort_perm

        tables = (scene.bvh, scene.tri_v0, scene.tri_e1, scene.tri_e2)
        ls = scene.bvh.max_leaf

        def kernel(o, d, mt, any_hit=False):
            return kernel_traverse(*tables, o, d, mt, leaf_size=ls,
                                   any_hit=any_hit)

        def twin(o, d, mt, any_hit=False):
            return bvh_traverse_threaded(*tables, o, d, mt, leaf_size=ls,
                                         any_hit=any_hit)

        def bounce(o, d, t, tri, hit, key):
            p = o + d * jnp.where(hit, t, 0.0)[:, None]
            ti = jnp.clip(tri, 0)
            n = jnp.cross(scene.tri_e1[ti], scene.tri_e2[ti])
            n = n / jnp.maximum(jnp.linalg.norm(n, axis=1, keepdims=True),
                                1e-30)
            n = jnp.where((jnp.sum(n * d, axis=1) < 0)[:, None], n, -n)
            u = jax.random.uniform(key, (o.shape[0], 2))
            nd = cosine_hemisphere(n, u[:, 0], u[:, 1])
            no = p + n * 1e-3
            perm = _sort_perm(scene, no, nd, hit)
            return no[perm], nd[perm], jnp.where(hit, 3.0e38, 0.0)[perm], p, n

        px, py = tiled_pixel_order(W, H, tile=64)
        o, d = generate_rays(scene.camera, W, H, jnp.asarray(px),
                             jnp.asarray(py))
        mt = jnp.full((o.shape[0],), 3.0e38, jnp.float32)
        checks = {}

        def closest(name, o, d, mt):
            (tk, ik, hk, _), tkt = timed(lambda: kernel(o, d, mt), reps=3)
            (tx, ix, hx), txt = timed(lambda: twin(o, d, mt), reps=1)
            hk, hx = np.asarray(hk), np.asarray(hx)
            both = hk & hx
            rel = (np.abs(np.asarray(tk) - np.asarray(tx))[both]
                   / np.maximum(np.abs(np.asarray(tx))[both], 1e-30))
            c = {"rays": int(o.shape[0]), "live": int((mt > 0).sum()),
                 "mask_mismatch_fraction": float((hk != hx).mean()),
                 "max_rel_t": float(rel.max()) if rel.size else 0.0,
                 "kernel_ms": tkt["warm_ms"], "xla_twin_ms": txt["warm_ms"]}
            checks[name] = c
            assert c["mask_mismatch_fraction"] <= MASK_FRACTION, (name, c)
            assert c["max_rel_t"] <= REL_T_TOL, (name, c)
            return tk, ik, hk

        t1, i1, h1 = closest("primary", o, d, mt)
        h1 = jnp.asarray(h1)
        o1, d1, mt1, p1, n1 = bounce(o, d, t1, i1, h1,
                                     jax.random.PRNGKey(1))
        lp = scene.lights.position[0]
        tl = lp[None, :] - p1
        dist = jnp.linalg.norm(tl, axis=1)
        so, sd = p1 + n1 * 1e-3, tl / dist[:, None]
        smt = jnp.where(h1, dist - 1e-3, 0.0)
        (_, _, hk, _), tkt = timed(lambda: kernel(so, sd, smt, True), reps=3)
        (_, _, hx), txt = timed(lambda: twin(so, sd, smt, True), reps=1)
        checks["shadow_anyhit"] = {
            "rays": int(so.shape[0]),
            "mask_mismatch": int((np.asarray(hk) != np.asarray(hx)).sum()),
            "kernel_ms": tkt["warm_ms"], "xla_twin_ms": txt["warm_ms"]}
        assert checks["shadow_anyhit"]["mask_mismatch"] == 0, checks
        t2, i2, h2 = closest("bounce1", o1, d1, mt1)
        o2, d2, mt2, _, _ = bounce(o1, d1, t2, i2, jnp.asarray(h2) & (mt1 > 0),
                                   jax.random.PRNGKey(2))
        closest("bounce2", o2, d2, mt2)
        report("kernel", **checks, peak_bytes=peak())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
