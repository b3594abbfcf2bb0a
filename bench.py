#!/usr/bin/env python
"""Benchmarks for every BASELINE.json config.

Default: the headline config 3 (1024^2 Kerr a=0.9 shadow), ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "vs_native_cpu": N}

--all additionally runs configs 1/2/4/5 (one JSON line each). Every line
names the device it ran on; a run that finds no GPU fails. The card's name
and power limit are printed first, on a comment line.

vs_baseline compares against the CPU reference measured on one CPU core
(BASELINE.md): the reference's own Kerr tracer (metrics.py:419-567) run
per-ray over a uniform sample of the same 1024^2 pixel grid. numba is not
installed in this image, so the reference executes its documented
pure-Python fallback path (metrics.py:16-29) single-core: 162.7 rays/s.
vs_native_cpu compares against this repo's own C++/OpenMP engine
(native/) — the honest "reference rebuilt with a proper native tier"
comparator — measured live on a ray sample when the engine is available,
else the recorded 57.5k rays/s (BASELINE.md, 1 core).
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

CPU_BASELINE_RAYS_PER_SEC = 162.7    # measured 2026-08-16, see BASELINE.md
NATIVE_CPU_RAYS_PER_SEC = 57_500.0   # recorded fallback, see BASELINE.md
_DEVICE = {}   # platform / device_kind / count, filled in by main()


def _emit(metric, value, unit, **extra):
    line = {"metric": metric, "value": round(value, 1), "unit": unit,
            "device": _DEVICE}
    line.update(extra)
    print(json.dumps(line), flush=True)


def measure_native_cpu(size, spin, n_sample=1500):
    """Live rays/s of the native C++ engine on a grid ray sample."""
    from light_path_tracer_tpu import native, camera
    if not native.available():
        return NATIVE_CPU_RAYS_PER_SEC
    import jax.numpy as jnp
    dim = (size, size)
    fov = camera.fov_from_vertical(np.radians(40.0), dim)
    al = np.asarray(camera.build_alpha_lookup(dim, fov, dtype=jnp.float32),
                    np.float64).ravel()
    th = np.asarray(camera.build_theta_lookup(dim, fov, dtype=jnp.float32),
                    np.float64).ravel()
    rng = np.random.default_rng(0)
    pick = rng.choice(al.size, size=n_sample, replace=False)
    t0 = time.perf_counter()
    native.kerr_trace_batch(1.0, spin, float(100.0), al[pick], th[pick])
    return n_sample / (time.perf_counter() - t0)


def _best_rays_per_sec(render, repeats):
    render()  # warmup: compile
    best = None
    for _ in range(repeats):
        _img, stats = render()
        dt = stats["timings"]["precompute"]
        rays_per_sec = stats["traced_rays"] / dt
        best = rays_per_sec if best is None else max(best, rays_per_sec)
    return best


def bench_kerr_headline(args):
    """Config 3: Kerr a=0.9 shadow, adaptive stepping (the north star)."""
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu.pipeline import render_shadow

    scene = SceneConfig(M=1.0, a=args.spin, r_obs_mult=100.0)
    cfg = RenderConfig(dtype=args.dtype, chunk_size=None,
                       integrator=args.integrator)
    dim = (args.size, args.size)

    best = _best_rays_per_sec(
        lambda: render_shadow(scene, dim, cfg), args.repeats)

    try:
        native_rps = measure_native_cpu(args.size, args.spin)
    except Exception:
        native_rps = NATIVE_CPU_RAYS_PER_SEC

    _emit(f"kerr_a{args.spin}_shadow_{args.size}sq_rays_per_sec_chip",
          best, "rays/s",
          vs_baseline=round(best / CPU_BASELINE_RAYS_PER_SEC, 1),
          vs_native_cpu=round(best / native_rps, 1))


def bench_schwarzschild_shadow(args):
    """Config 1: Schwarzschild shadow, integrated per-pixel rays."""
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu.pipeline import render_shadow

    scene = SceneConfig(M=1.0, a=0.0, r_obs_mult=100.0)
    cfg = RenderConfig(dtype=args.dtype, chunk_size=None)
    dim = (args.size, args.size)
    best = _best_rays_per_sec(
        lambda: render_shadow(scene, dim, cfg), args.repeats)
    _emit(f"schwarzschild_shadow_{args.size}sq_rays_per_sec_chip",
          best, "rays/s")


def bench_lensed(args):
    """Config 2: 512^2 Schwarzschild lensed background render."""
    import jax
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu.pipeline import render_scene

    rng = np.random.default_rng(3)
    src = rng.random((512, 512, 3)).astype(np.float32)
    scene = SceneConfig(M=1.0, a=0.0, r_obs_mult=100.0)
    cfg = RenderConfig(dtype=args.dtype, chunk_size=None)

    render_scene(scene, src, cfg)  # warmup
    best = None
    for _ in range(args.repeats):
        out = render_scene(scene, src, cfg)
        jax.block_until_ready(out.image)
        total = out.timings["total"]
        best = total if best is None else min(best, total)
    _emit("schwarzschild_lensed_512sq_seconds_per_frame", best, "s",
          trace_rays_per_sec=round(
              out.precompute.traced_rays / out.timings["precompute"], 1))


def bench_disk(args):
    """Config 4: accretion disk with redshift + Doppler beaming."""
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
    from light_path_tracer_tpu.disk import render_disk, DiskConfig

    scene = SceneConfig(M=1.0, a=args.spin, r_obs_mult=100.0,
                        theta_obs=np.radians(80.0))
    cfg = RenderConfig(dtype=args.dtype)
    dim = (args.size, args.size)

    def render():
        img, stats = render_disk(scene, dim, cfg, DiskConfig())
        return img, stats

    best = _best_rays_per_sec(render, args.repeats)
    _emit(f"disk_a{args.spin}_{args.size}sq_rays_per_sec_chip",
          best, "rays/s")


def bench_aa_4k(args):
    """Config 5: 4k shadow, 4x jittered AA, rows tiled across all
    devices (one card: no mesh)."""
    import jax
    from light_path_tracer_tpu.aa import render_shadow_aa
    from light_path_tracer_tpu.parallel.mesh import make_mesh
    from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig

    scene = SceneConfig(M=1.0, a=args.spin, r_obs_mult=100.0)
    cfg = RenderConfig(dtype=args.dtype)
    dim = (2160, 3840)
    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev) if n_dev > 1 else None

    def run():
        img, stats = render_shadow_aa(scene, dim, cfg, aa_samples=4,
                                      mesh=mesh)
        jax.block_until_ready(img)
        return stats

    run()  # warm/compile
    best = None
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        stats = run()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    rays = dim[0] * dim[1] * 4
    _emit(f"kerr_a{args.spin}_4k_aa4_rays_per_sec", rays / best, "rays/s",
          seconds_per_frame=round(best, 3), devices=n_dev,
          traced_rays=int(stats["traced_rays"]),
          traced_rays_per_sec=round(stats["traced_rays"] / best, 1))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--spin", type=float, default=0.9)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--integrator", default="dp45",
                        choices=["dp45", "dop853"],
                        help="headline-config Kerr integrator")
    parser.add_argument("--all", action="store_true",
                        help="run every BASELINE.json config")
    args = parser.parse_args()

    import jax
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX's first device is "
                 f"{dev.platform}); nothing measured")
    _DEVICE.update(platform=dev.platform, kind=dev.device_kind,
                   count=len(jax.devices()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"# card: {card.stdout.strip()}", flush=True)

    from light_path_tracer_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    bench_kerr_headline(args)
    if args.all:
        bench_schwarzschild_shadow(args)
        bench_lensed(args)
        bench_disk(args)
        bench_aa_4k(args)


if __name__ == "__main__":
    main()
