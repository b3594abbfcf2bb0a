"""End-to-end lensing pipeline: camera grids -> ray tracing -> renderer.

Parity surface: /root/reference/image_lens.py:432-535 (`main`) and the two
precompute paths:
  * spherically symmetric (1-D alpha only): image_lens.py:155-178.
  * Kerr (alpha, theta) with the axis-refine column band and top/bottom
    mirror symmetry: image_lens.py:185-280.

Array structure: the camera grids, ray tracing, and renderer are each
single jitted XLA programs over the whole pixel grid; the only host logic
is configuration, chunk scheduling, and the symmetry fold.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu import camera
from light_path_tracer_tpu.ops.batch import trace_batch
from light_path_tracer_tpu.render import render_lensed_image
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig
from light_path_tracer_tpu.utils.timing import StageTimer


@dataclasses.dataclass
class PrecomputeResult:
    final_alpha: jnp.ndarray      # (H, W) float32, NaN = shadow
    winding: jnp.ndarray          # (H, W) uint16
    total_rays: int
    traced_rays: int
    # Device scalar (or int): kept lazy — forcing it mid-pipeline costs a
    # host round-trip.
    integrator_steps: object

    @property
    def steps(self) -> int:
        return int(self.integrator_steps)


@dataclasses.dataclass
class RenderOutput:
    image: Any
    alpha_lookup: jnp.ndarray
    precompute: PrecomputeResult
    alpha_crit: float
    timings: dict
    scene: SceneConfig
    render_cfg: RenderConfig


def _dtype_of(cfg: RenderConfig):
    return jnp.float64 if cfg.dtype == "float64" else jnp.float32


def precompute_final_alpha(scene: SceneConfig, cfg: RenderConfig,
                           image_dimension, fov, alpha_lookup=None,
                           chunk_store=None) -> PrecomputeResult:
    """Trace one ray per pixel; returns per-pixel (final_alpha, winding).

    Dispatches on spherical symmetry like image_lens.py:477-498, applies
    the axis-refine band (image_lens.py:210-216) and top/bottom mirror
    symmetry (image_lens.py:218-229, 272-276) for the 2-D path.

    The whole body (camera grids -> trace -> winding clip -> symmetry
    fold) executes as ONE jitted program when possible: every extra
    dispatch costs a scheduling round-trip, which matters at
    millisecond trace times. Chunked or progress-reporting runs fall back to the
    eager host loop.
    """
    fov = (float(fov[0]), float(fov[1]))
    image_dimension = (int(image_dimension[0]), int(image_dimension[1]))
    whole_grid = cfg.chunk_size is None or (
        cfg.chunk_size >= image_dimension[0] * image_dimension[1])
    if (alpha_lookup is None and not cfg.progress and whole_grid
            and chunk_store is None):
        fa, wind, steps = _precompute_fused(scene, cfg, image_dimension,
                                            fov)
        height, width = image_dimension
        use_tb = _use_tb(scene, cfg)
        metric = scene.metric()
        traced = (height if (metric.is_spherically_symmetric or not use_tb)
                  else (height + 1) // 2) * width
        return PrecomputeResult(fa, wind, height * width, traced, steps)
    return _precompute_eager(scene, cfg, image_dimension, fov,
                             alpha_lookup, chunk_store=chunk_store)


def _use_tb(scene: SceneConfig, cfg: RenderConfig) -> bool:
    # A vertical boost component breaks the up/down mirror symmetry
    # (x/z components preserve it: aberration is axisymmetric about the
    # velocity, which then lies in the equatorial symmetry plane).
    return (cfg.use_tb_symmetry
            and bool(np.isclose(scene.theta_obs, np.pi / 2))
            and bool(np.isclose(scene.psi[0], 0.0))
            and float(scene.boost[1]) == 0.0)


@functools.partial(
    jax.jit, static_argnames=("scene", "cfg", "image_dimension", "fov"))
def _precompute_fused(scene, cfg, image_dimension, fov):
    pre = _precompute_eager(scene, cfg, image_dimension, fov, None)
    return pre.final_alpha, pre.winding, pre.integrator_steps


@functools.partial(
    jax.jit, static_argnames=("scene", "cfg", "image_dimension", "fov"))
def _render_scene_fused(scene, cfg, image_dimension, fov, img):
    """The ENTIRE lens pipeline — camera grids, trace, symmetry fold,
    and the texture-gather render — as ONE jitted program.

    One dispatch and one device->host readback per frame (at save),
    instead of a host round trip per stage. The background image
    enters as a traced ARGUMENT (closing over it would constant-fold
    megabytes through XLA — measured minutes of compile elsewhere).
    Returns (lensed, alpha_lookup, final_alpha, winding, steps).
    """
    from light_path_tracer_tpu.render import _render_core
    dtype = _dtype_of(cfg)
    alpha_lookup = camera.build_alpha_lookup(
        image_dimension, fov, psi=scene.psi, dtype=dtype,
        boost=scene.boost)
    pre = _precompute_eager(scene, cfg, image_dimension, fov,
                            alpha_lookup)
    # Renderer theta grid: same convention as the staged path — the
    # aberrated (static-frame) grid in compute dtype when boosted, the
    # plain f32 grid otherwise (render_lensed_image's default).
    if scene.boosted:
        theta_r = camera.build_theta_lookup(
            image_dimension, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
    else:
        theta_r = camera.build_theta_lookup(
            image_dimension, fov, psi=scene.psi,
            dtype=pre.final_alpha.dtype)
    frame = camera.psi_frame(scene.psi)
    lensed = _render_core(img, theta_r, pre.final_alpha, pre.winding,
                          frame.d, frame.e_x, frame.e_y,
                          image_dimension, fov, cfg.render_loop_around,
                          cfg.sampling)
    return (lensed, alpha_lookup, pre.final_alpha, pre.winding,
            pre.integrator_steps)


def _precompute_eager(scene: SceneConfig, cfg: RenderConfig,
                      image_dimension, fov, alpha_lookup=None,
                      chunk_store=None) -> PrecomputeResult:
    metric = scene.metric()
    dtype = _dtype_of(cfg)
    height, width = image_dimension
    if alpha_lookup is None:
        alpha_lookup = camera.build_alpha_lookup(
            image_dimension, fov, psi=scene.psi, dtype=dtype,
            boost=scene.boost)
    alpha = jnp.asarray(alpha_lookup, dtype)
    n_total = height * width

    if metric.is_spherically_symmetric:
        res = trace_batch(
            metric, scene.r_obs, alpha.ravel(),
            chunk_size=None, phi_max=cfg.phi_max, h_max=cfg.h_max,
            backend=cfg.backend)
        fa = res.final_alpha.reshape(image_dimension).astype(jnp.float32)
        wind = jnp.clip(res.n_half_orbits, 0, cfg.winding_max).astype(
            jnp.uint16).reshape(image_dimension)
        return PrecomputeResult(fa, wind, n_total, n_total,
                                res.n_steps)

    theta_lookup = camera.build_theta_lookup(
        image_dimension, fov, psi=scene.psi, dtype=dtype,
        boost=scene.boost)
    refine_cols = camera.axis_refine_columns(
        image_dimension, fov, psi=scene.psi,
        refine_frac=cfg.axis_refine_frac, boost=scene.boost)

    use_tb = _use_tb(scene, cfg)
    trace_rows = (height + 1) // 2 if use_tb else height

    alpha_t = alpha[:trace_rows, :].ravel()
    theta_t = theta_lookup[:trace_rows, :].ravel()
    refine_t = jnp.broadcast_to(
        jnp.asarray(refine_cols)[None, :], (trace_rows, width)).ravel()

    res = trace_batch(
        metric, scene.r_obs, alpha_t, theta_t, scene.theta_obs, refine_t,
        chunk_size=cfg.chunk_size,
        sort_by_difficulty=cfg.sort_by_difficulty,
        max_steps=cfg.max_steps, backend=cfg.backend,
        integrator=cfg.integrator, event_interp=cfg.event_interp,
        formulation=cfg.formulation, precision=cfg.precision,
        progress=cfg.progress, chunk_store=chunk_store)

    fa_rows = res.final_alpha.reshape(
        (trace_rows, width)).astype(jnp.float32)
    w_rows = jnp.clip(res.n_half_orbits, 0, cfg.winding_max).astype(
        jnp.uint16).reshape((trace_rows, width))

    if use_tb:
        top_half = height // 2
        fa = jnp.full((height, width), jnp.nan, jnp.float32)
        wind = jnp.zeros((height, width), jnp.uint16)
        fa = fa.at[:trace_rows].set(fa_rows)
        wind = wind.at[:trace_rows].set(w_rows)
        if top_half > 0:
            fa = fa.at[height - top_half:].set(fa[:top_half][::-1])
            wind = wind.at[height - top_half:].set(wind[:top_half][::-1])
    else:
        fa, wind = fa_rows, w_rows

    return PrecomputeResult(fa, wind, n_total, trace_rows * width,
                            res.n_steps)


def render_scene(scene: SceneConfig, source_image,
                 cfg: RenderConfig = RenderConfig()) -> RenderOutput:
    """Full lensed render of `source_image` (the image_lens.main pipeline).

    Default path: the whole pipeline is ONE fused XLA program
    (_render_scene_fused) — one dispatch, one readback at save; the
    per-stage breakdown collapses into the "precompute" timing (the
    gather render is a few percent of it). Chunked / progress-reporting
    runs fall back to the staged path with true per-stage timings.
    """
    metric = scene.metric()
    timer = StageTimer()

    height, width = np.asarray(source_image).shape[:2]
    fov = camera.fov_from_vertical(scene.vertical_fov, (height, width))
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs)

    with timer.stage("load_image") as out:
        img = jnp.asarray(source_image)
        if img.dtype == jnp.uint8:
            img = img.astype(jnp.float32) / 255.0
        out.append(img)

    whole_grid = cfg.chunk_size is None or (
        cfg.chunk_size >= height * width)
    if whole_grid and not cfg.progress:
        with timer.stage("precompute") as out:
            (lensed, alpha_lookup, fa, wind,
             steps) = _render_scene_fused(scene, cfg, (height, width),
                                          tuple(fov), img)
            out.append(lensed)
        use_tb = _use_tb(scene, cfg)
        traced = (height if (metric.is_spherically_symmetric
                             or not use_tb)
                  else (height + 1) // 2) * width
        pre = PrecomputeResult(fa, wind, height * width, traced, steps)
        timings = timer.finish()
        # One program = one timing: lookup build and render are fused
        # into "precompute"; keep the stage keys for the benchmark
        # summary contract (print_benchmark_summary).
        timings.setdefault("build_lookup", 0.0)
        timings.setdefault("render", 0.0)
        return RenderOutput(lensed, alpha_lookup, pre, alpha_crit,
                            timings, scene, cfg)

    with timer.stage("build_lookup") as out:
        alpha_lookup = camera.build_alpha_lookup(
            (height, width), fov, psi=scene.psi, dtype=_dtype_of(cfg),
            boost=scene.boost)
        out.append(alpha_lookup)

    with timer.stage("precompute") as out:
        pre = precompute_final_alpha(
            scene, cfg, (height, width), fov, alpha_lookup=alpha_lookup)
        out.append((pre.final_alpha, pre.winding))

    with timer.stage("render") as out:
        # The renderer reconstructs escape directions from the SAME
        # theta grid the tracer saw — under a camera boost that is the
        # aberrated (static-frame) one.
        theta_lookup = (camera.build_theta_lookup(
            (height, width), fov, psi=scene.psi, dtype=_dtype_of(cfg),
            boost=scene.boost) if scene.boosted else None)
        lensed = render_lensed_image(
            img, alpha_lookup, pre.final_alpha, pre.winding,
            alpha_crit, fov, cfg.render_loop_around, psi=scene.psi,
            theta_lookup=theta_lookup, sampling=cfg.sampling)
        out.append(lensed)

    timings = timer.finish()
    return RenderOutput(lensed, alpha_lookup, pre, alpha_crit, timings,
                        scene, cfg)


def render_shadow(scene: SceneConfig, resolution,
                  cfg: RenderConfig = RenderConfig(),
                  analytic: bool = False):
    """Black-hole shadow image: white background, black where captured.

    analytic=True reproduces black_hole_shadow.py's zero-integration
    threshold test against alpha_crit (black_hole_shadow.py:12-15);
    analytic=False integrates every pixel ray (BASELINE.json configs 1/3).
    Returns (image (H, W) float32 in {0, 1}, stats dict).
    """
    metric = scene.metric()
    timer = StageTimer()
    height, width = resolution
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    alpha_crit = metric.alpha_crit(scene.r_obs, scene.theta_obs)

    if analytic:
        with timer.stage("render") as out:
            alpha = camera.build_alpha_lookup(
                resolution, fov, psi=scene.psi, dtype=_dtype_of(cfg),
                boost=scene.boost)
            image = jnp.where(alpha < alpha_crit, 0.0, 1.0).astype(
                jnp.float32)
            out.append(image)
        stats = dict(total_rays=height * width, traced_rays=0,
                     integrator_steps=0)
    else:
        with timer.stage("precompute") as out:
            pre = precompute_final_alpha(scene, cfg, resolution, fov)
            out.append(pre.final_alpha)
        with timer.stage("render") as out:
            image = jnp.where(jnp.isnan(pre.final_alpha), 0.0, 1.0)
            out.append(image)
        stats = dict(total_rays=pre.total_rays,
                     traced_rays=pre.traced_rays,
                     integrator_steps=pre.steps)

    stats["alpha_crit"] = alpha_crit
    stats["timings"] = timer.finish()
    return image, stats


def print_benchmark_summary(image_dimension, alpha_crit, total_rays,
                            traced_rays, timings):
    """Parity: image_lens.py:404-425, plus rays/sec."""
    height, width = image_dimension
    pixel_count = width * height
    render_time = max(timings.get("render", 0.0), 1e-12)
    total_time = max(timings.get("total", 0.0), 1e-12)
    precompute_time = max(timings.get("precompute", 0.0), 1e-12)

    print("\nBenchmark summary")
    print(f"  resolution: {width}x{height} ({pixel_count:,} pixels)")
    print(f"  alpha_crit: {alpha_crit:.6f} rad")
    print(f"  total rays: {total_rays:,}")
    print(f"  traced rays: {traced_rays:,}")
    for key in ("load_image", "build_lookup", "precompute", "render",
                "save_image", "total"):
        print(f"  {key:<26}{timings.get(key, 0.0):>10.3f} s")
    print(f"  {'render_throughput':<26}"
          f"{(pixel_count / render_time) / 1e6:>10.2f} MPix/s")
    print(f"  {'overall_throughput':<26}"
          f"{(pixel_count / total_time) / 1e6:>10.2f} MPix/s")
    print(f"  {'trace_throughput':<26}"
          f"{traced_rays / precompute_time:>10.0f} rays/s")


def render_rings(scene: SceneConfig, resolution,
                 cfg: RenderConfig = RenderConfig(), max_order: int = 3):
    """Photon-ring decomposition render (render.ring_decomposition).

    Returns (masks (max_order+2, H, W) bool, composite (H, W, 3) float32,
    stats) — stats includes per-order pixel counts.
    """
    from light_path_tracer_tpu.render import ring_decomposition

    timer = StageTimer()
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    with timer.stage("precompute") as out:
        pre = precompute_final_alpha(scene, cfg, resolution, fov)
        out.append(pre.final_alpha)
    with timer.stage("render") as out:
        masks, composite = ring_decomposition(
            pre.final_alpha, pre.winding, max_order=max_order)
        out.append(composite)

    from light_path_tracer_tpu.render import ring_labels
    counts = np.asarray(masks.sum(axis=(1, 2)))
    labels = ring_labels(max_order)
    metric = scene.metric()
    stats = dict(
        alpha_crit=metric.alpha_crit(scene.r_obs, scene.theta_obs),
        order_pixels={lab: int(c) for lab, c in zip(labels, counts)},
        total_rays=pre.total_rays, traced_rays=pre.traced_rays,
        integrator_steps=pre.steps, timings=timer.finish())
    return masks, composite, stats


def lensed_ring_layers(final_alpha, winding, image, max_order: int = 3):
    """Split a rendered lensed image into photon-ring-order layers.

    Works from the lookup tables an existing render already has —
    zero extra tracing. Returns (layers (max_order+2, H, W[, C]),
    order_pixels dict); layers are disjoint and sum to `image` exactly
    on non-shadow pixels.
    """
    from light_path_tracer_tpu.render import (ring_decomposition,
                                              ring_labels)
    masks, _ = ring_decomposition(final_alpha, winding,
                                  max_order=max_order)
    lensed = jnp.asarray(image)
    expand = (lambda m: m) if lensed.ndim == 2 else (lambda m: m[..., None])
    layers = jnp.stack([jnp.where(expand(m), lensed, 0.0) for m in masks])
    counts = np.asarray(masks.sum(axis=tuple(range(1, masks.ndim))))
    order_pixels = {lab: int(c)
                    for lab, c in zip(ring_labels(max_order), counts)}
    return layers, order_pixels


def render_scene_rings(scene: SceneConfig, source_image,
                       cfg: RenderConfig = RenderConfig(),
                       max_order: int = 3):
    """Photon-ring decomposition of a LENSED render: the full lensed
    image split by winding order (direct image, first lensed image,
    n-th photon ring). One trace serves all orders (the per-pixel
    winding already exists in the lookup tables). Beyond the reference
    (which folds every order into one image); the EHT-style use is
    isolating the exponentially thinner higher-order rings.

    Returns (layers, full lensed image, stats).
    """
    out = render_scene(scene, source_image, cfg)
    layers, order_pixels = lensed_ring_layers(
        out.precompute.final_alpha, out.precompute.winding, out.image,
        max_order=max_order)
    stats = dict(order_pixels=order_pixels, alpha_crit=out.alpha_crit,
                 timings=out.timings)
    return layers, out.image, stats


def render_magnification(scene: SceneConfig, resolution,
                         cfg: RenderConfig = RenderConfig()):
    """Signed lensing-magnification map of the scene's celestial lens
    map (render.magnification_map): one standard precompute, then the
    Jacobian solid-angle ratio by central differences.

    New product beyond the reference: |mu| -> inf traces the critical
    curves (the Einstein ring of a perfectly aligned source and the
    photon-ring stack), mu < 0 marks parity-flipped (odd) images, and
    far-field pixels calibrate at mu = 1. Returns (mu, stats) with mu
    (H, W) float32, NaN in the shadow.
    """
    timer = StageTimer()
    resolution = tuple(resolution)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = _dtype_of(cfg)

    metric = scene.metric()
    whole_grid = cfg.chunk_size is None or (
        cfg.chunk_size >= resolution[0] * resolution[1])
    single = (not metric.is_spherically_symmetric and whole_grid
              and not cfg.progress)
    if single:
        # ONE program: precompute + magnification epilogue, camera
        # lookups traced (see _magnification_single).
        frame = camera.psi_frame(scene.psi)
        alpha_lookup, theta_lookup = _mode_lookups(scene, resolution,
                                                   fov, dtype)
        refine_cols = jnp.asarray(camera.axis_refine_columns(
            resolution, fov, psi=scene.psi,
            refine_frac=cfg.axis_refine_frac, boost=scene.boost))
        use_tb = _use_tb(scene, cfg)
        traced_rays = ((resolution[0] + 1) // 2 if use_tb
                       else resolution[0]) * resolution[1]
        with timer.stage("precompute") as out:
            packed = _magnification_single(
                metric, scene.r_obs, alpha_lookup, theta_lookup,
                refine_cols, scene.theta_obs, cfg, tuple(resolution),
                fov, use_tb, jnp.asarray(frame.d, dtype),
                jnp.asarray(frame.e_x, dtype),
                jnp.asarray(frame.e_y, dtype))
            out.append(packed)
    else:
        with timer.stage("precompute") as out:
            pre = _precompute_eager(scene, cfg, resolution, fov)
            out.append(pre.final_alpha)
        traced_rays = pre.traced_rays

        with timer.stage("render") as out:
            theta_lookup = camera.build_theta_lookup(
                resolution, fov, psi=scene.psi, dtype=dtype,
                boost=scene.boost)
            frame = camera.psi_frame(scene.psi)
            packed = _magnification_fused(
                pre.final_alpha.astype(dtype), theta_lookup,
                jnp.asarray(frame.d, dtype),
                jnp.asarray(frame.e_x, dtype),
                jnp.asarray(frame.e_y, dtype),
                jnp.asarray(pre.integrator_steps), tuple(resolution),
                fov)
            out.append(packed)

    flat = np.asarray(packed)              # one host fetch
    n_px = int(np.prod(resolution))
    mu_np = flat[:n_px].reshape(resolution).astype(np.float32)
    mu = mu_np
    finite = np.isfinite(mu_np)
    stats = {
        "timings": timer.finish(),
        "total_rays": n_px,
        "traced_rays": traced_rays,
        "integrator_steps": int(flat[-1]),
        "shadow_pixels": int((~finite).sum()),
        "mu_abs_max": float(np.abs(mu_np[finite]).max()) if finite.any()
        else float("nan"),
        "negative_parity_pixels": int((mu_np[finite] < 0).sum()),
    }
    return mu, stats


def _metric_5d(metric):
    """The 5-D Kerr-machinery equivalent of a metric: spherically-
    symmetric families integrate on the reduced 2-D orbit path, which
    carries neither coordinate time nor the raw escape state — route
    them through Kerr/Kerr-Newman at a = 0 (a = 0 traces are
    oracle-pinned equal in tests)."""
    if hasattr(metric, "initial_conditions_5d"):
        return metric
    from light_path_tracer_tpu.models import (Kerr, KerrNewman,
                                              Schwarzschild,
                                              ReissnerNordstrom)
    if isinstance(metric, ReissnerNordstrom):
        return KerrNewman(M=metric.M, a=0.0, Q=metric.Q)
    if isinstance(metric, Schwarzschild):
        return Kerr(M=metric.M, a=0.0)
    raise ValueError(
        f"{type(metric).__name__} has no 5-D tracer "
        "(initial_conditions_5d) and no known a = 0 equivalent")


def _surface_beta_body(metric, r_obs, alpha_lookup, theta_lookup,
                       theta_obs, max_steps, precision, method,
                       record_time, resolution):
    """Trace-to-escape + the side-exact source chart, as a plain traced
    body shared by every jitted entry that embeds it (the standalone
    `_surface_beta_fused` program and the per-mode single-program
    wrappers below).

    Fusing the chart extraction (render.world_escape_beta, ~40 ops)
    into the trace program spares the source-plane modes (time delay,
    microlens, caustics, magnification, shear) one dispatch per op
    inside the timed precompute stage; the camera lookups
    stay TRACED arguments so a new pointing reuses this compile (a
    static scene would recompile per pointing)."""
    from light_path_tracer_tpu import render as _render
    from light_path_tracer_tpu.ops.kerr_trace import (
        trace_rays_surface, ESCAPED)

    res = trace_rays_surface(
        metric, r_obs, alpha_lookup.ravel(), theta_lookup.ravel(),
        theta_obs, r_surface=float(metric.capture_radius()),
        lambda_max=max(5000.0, 6.0 * r_obs), max_steps=max_steps,
        precision=precision, method=method, record_time=record_time)
    bx, by = _render.world_escape_beta(
        metric, 2.0 * r_obs, res.theta, res.phi, res.p_r,
        res.p_theta, res.xi, res.status == ESCAPED, theta_obs)
    return bx.reshape(resolution), by.reshape(resolution), res


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "max_steps",
                     "precision", "method", "record_time", "resolution"))
def _surface_beta_fused(metric, r_obs, alpha_lookup, theta_lookup,
                        theta_obs, max_steps, precision, method,
                        record_time, resolution):
    """ONE XLA program: surface trace + the side-exact source chart
    (`_surface_beta_body`). Standalone entry for callers that need the
    raw (bx, by, res) — the mesh path and images.find_point_images."""
    return _surface_beta_body(metric, r_obs, alpha_lookup, theta_lookup,
                              theta_obs, max_steps, precision, method,
                              record_time, resolution)


def _trace_escape_beta(scene: SceneConfig, cfg: RenderConfig,
                       resolution, fov, record_time: bool = False,
                       mesh=None):
    """Trace the pixel grid on the raw-escape-state path and return
    the side-EXACT gnomonic source coordinates (bx, by) plus the raw
    SurfaceResult (render.world_escape_beta — the collapsed
    (final_alpha, theta) chart cannot distinguish which azimuthal side
    a crossing ray escaped on). mesh: optional jax.sharding.Mesh for
    row-wise tile DP (parallel.tiles.trace_surface_grid_sharded);
    single-device runs go through the fused one-dispatch program."""
    from light_path_tracer_tpu import render as _render
    from light_path_tracer_tpu.ops.kerr_trace import ESCAPED

    dtype = _dtype_of(cfg)
    metric = _metric_5d(scene.metric())
    r_obs = scene.r_obs
    alpha_lookup = camera.build_alpha_lookup(
        resolution, fov, psi=scene.psi, dtype=dtype,
        boost=scene.boost)
    theta_lookup = camera.build_theta_lookup(
        resolution, fov, psi=scene.psi, dtype=dtype,
        boost=scene.boost)
    if mesh is not None:
        from light_path_tracer_tpu.parallel.tiles import (
            trace_surface_grid_sharded)
        res = trace_surface_grid_sharded(
            metric, r_obs, alpha_lookup,
            theta_lookup.astype(dtype), scene.theta_obs,
            float(metric.capture_radius()), mesh=mesh,
            lambda_max=max(5000.0, 6.0 * r_obs),
            max_steps=cfg.max_steps, precision=cfg.precision,
            method=cfg.integrator, record_time=record_time)
        bx, by = _render.world_escape_beta(
            metric, 2.0 * r_obs, res.theta, res.phi, res.p_r,
            res.p_theta, res.xi, res.status == ESCAPED,
            scene.theta_obs)
        return (bx.reshape(resolution), by.reshape(resolution), res,
                theta_lookup)
    bx, by, res = _surface_beta_fused(
        metric, r_obs, alpha_lookup, theta_lookup.astype(dtype),
        scene.theta_obs, cfg.max_steps, cfg.precision, cfg.integrator,
        record_time, tuple(resolution))
    return bx, by, res, theta_lookup


# ---------------------------------------------------------------------
# Fused source-plane epilogues. Each is ONE
# small jitted program whose varying inputs are TRACED (pointing jitter
# reuses the compile) and whose output is ONE flat array: the payload
# maps raveled with the integrator step count riding the tail — so the
# host pays exactly one fetch per mode instead of one per map plus one
# per stats scalar.
# ---------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("metric", "r_e", "resolution"))
def _tau_pack_fused(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi,
                    t_hit, status, bx, by, n_steps, resolution):
    from light_path_tracer_tpu.ops.kerr_trace import ESCAPED
    from light_path_tracer_tpu.render import fermat_tau

    escaped = status == ESCAPED
    tau = fermat_tau(metric, r_e, theta_f, phi_f, p_r_f, p_th_f, xi,
                     t_hit, escaped)
    tau = tau - jnp.nanmin(tau)
    dtype = tau.dtype
    return jnp.concatenate([
        tau.ravel(), bx.ravel().astype(dtype), by.ravel().astype(dtype),
        jnp.reshape(n_steps, (1,)).astype(dtype)])


@functools.partial(jax.jit, static_argnames=("resolution", "fov",
                                             "beta_max", "bins"))
def _caustics_fused(bx, by, n_steps, resolution, fov, beta_max, bins):
    from light_path_tracer_tpu.render import source_plane_map

    amap, _extent = source_plane_map(bx, by, resolution, fov, beta_max,
                                     bins)
    return jnp.concatenate([
        amap.ravel(),
        jnp.reshape(n_steps, (1,)).astype(amap.dtype)])


@functools.partial(jax.jit, static_argnames=("resolution", "fov",
                                             "source_radius"))
def _microlens_fused(bx, by, track, n_steps, resolution, fov,
                     source_radius):
    from light_path_tracer_tpu.render import microlens_light_curve

    curve = microlens_light_curve(bx, by, resolution, fov, track,
                                  source_radius)
    return jnp.concatenate([
        curve, jnp.reshape(n_steps, (1,)).astype(curve.dtype)])


@functools.partial(jax.jit, static_argnames=("resolution", "fov"))
def _magnification_fused(final_alpha, theta_lookup, d, e_x, e_y,
                         n_steps, resolution, fov):
    from light_path_tracer_tpu import render as _render

    frame = camera.PsiFrame(d, e_x, e_y, True)
    mu = _render.magnification_map(final_alpha, theta_lookup, frame,
                                   resolution, fov)
    return jnp.concatenate([
        mu.ravel(), jnp.reshape(n_steps, (1,)).astype(mu.dtype)])


def _shear_epilogue(bx, by, d, e_x, e_y, n_steps, resolution, fov,
                    boost):
    from light_path_tracer_tpu import render as _render
    from light_path_tracer_tpu.camera import _view_grids, aberrate_view

    dtype = bx.dtype
    vx, vy, vz = _view_grids(resolution, fov, dtype)
    vy = jnp.broadcast_to(vy, resolution)
    vx = jnp.broadcast_to(vx, resolution)
    vz = jnp.broadcast_to(vz, resolution)
    if boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    # image_gnomonic_grids with the frame as traced vectors.
    vd = vx * d[0] + vy * d[1] + vz * d[2]
    nan = jnp.asarray(jnp.nan, dtype)
    vd_safe = jnp.where(vd > 1e-12, vd, 1.0)
    xb = jnp.where(vd > 1e-12,
                   (vx * e_x[0] + vy * e_x[1] + vz * e_x[2]) / vd_safe,
                   nan)
    yb = jnp.where(vd > 1e-12,
                   (vx * e_y[0] + vy * e_y[1] + vz * e_y[2]) / vd_safe,
                   nan)
    kappa, gamma1, gamma2, omega = (
        _render.lens_jacobian_decomposition(bx, by, xb, yb))
    gamma = jnp.sqrt(gamma1 ** 2 + gamma2 ** 2)
    packed = jnp.stack([kappa, gamma1, gamma2, omega, gamma]).astype(
        jnp.float32)
    return jnp.concatenate([
        packed.ravel(),
        jnp.reshape(n_steps, (1,)).astype(jnp.float32)])


@functools.partial(jax.jit, static_argnames=("resolution", "fov",
                                             "boost"))
def _shear_fused(bx, by, d, e_x, e_y, n_steps, resolution, fov, boost):
    return _shear_epilogue(bx, by, d, e_x, e_y, n_steps, resolution,
                           fov, boost)


# ---------------------------------------------------------------------
# Single-program source-plane modes. The fused trace and the fused
# epilogue above are still TWO programs — two dispatches plus an
# intermediate (bx, by) materialization, which short (~77-step) traces
# are bound by. Whether the fusion still pays on the GPU is not
# measured (ROADMAP D6). Each wrapper below embeds
# `_surface_beta_body` AND the mode's epilogue in ONE jitted program
# whose output is the packed payload: one launch, one fetch, nothing
# intermediate. The mesh path keeps the two-stage structure (the
# sharded trace cannot live inside a single-device jit).
# ---------------------------------------------------------------------


def _mode_lookups(scene, resolution, fov, dtype):
    """Camera lookup tables as traced inputs (pointing jitter reuses
    the compile)."""
    alpha_lookup = camera.build_alpha_lookup(
        resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost)
    theta_lookup = camera.build_theta_lookup(
        resolution, fov, psi=scene.psi, dtype=dtype, boost=scene.boost)
    return alpha_lookup, theta_lookup.astype(dtype)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "max_steps",
                     "precision", "method", "resolution", "fov",
                     "beta_max", "bins"))
def _caustics_single(metric, r_obs, alpha_lookup, theta_lookup,
                     theta_obs, max_steps, precision, method,
                     resolution, fov, beta_max, bins):
    from light_path_tracer_tpu.render import source_plane_map

    bx, by, res = _surface_beta_body(
        metric, r_obs, alpha_lookup, theta_lookup, theta_obs,
        max_steps, precision, method, False, resolution)
    amap, _extent = source_plane_map(bx, by, resolution, fov, beta_max,
                                     bins)
    return jnp.concatenate([
        amap.ravel(),
        jnp.reshape(res.n_steps, (1,)).astype(amap.dtype)])


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "max_steps",
                     "precision", "method", "resolution", "fov",
                     "source_radius"))
def _microlens_single(metric, r_obs, alpha_lookup, theta_lookup,
                      theta_obs, max_steps, precision, method,
                      resolution, fov, track, source_radius):
    from light_path_tracer_tpu.render import microlens_light_curve

    bx, by, res = _surface_beta_body(
        metric, r_obs, alpha_lookup, theta_lookup, theta_obs,
        max_steps, precision, method, False, resolution)
    curve = microlens_light_curve(bx, by, resolution, fov, track,
                                  source_radius)
    return jnp.concatenate([
        curve, jnp.reshape(res.n_steps, (1,)).astype(curve.dtype)])


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "max_steps",
                     "precision", "method", "resolution", "r_e"))
def _tau_single(metric, r_obs, alpha_lookup, theta_lookup, theta_obs,
                max_steps, precision, method, resolution, r_e):
    from light_path_tracer_tpu.ops.kerr_trace import ESCAPED
    from light_path_tracer_tpu.render import fermat_tau

    bx, by, res = _surface_beta_body(
        metric, r_obs, alpha_lookup, theta_lookup, theta_obs,
        max_steps, precision, method, True, resolution)
    escaped = res.status == ESCAPED
    tau = fermat_tau(metric, r_e, res.theta, res.phi, res.p_r,
                     res.p_theta, res.xi, res.t_hit, escaped)
    tau = tau - jnp.nanmin(tau)
    dtype = tau.dtype
    return jnp.concatenate([
        tau.ravel(), bx.ravel().astype(dtype), by.ravel().astype(dtype),
        jnp.reshape(res.n_steps, (1,)).astype(dtype)])


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "max_steps",
                     "precision", "method", "resolution", "fov",
                     "boost"))
def _shear_single(metric, r_obs, alpha_lookup, theta_lookup, theta_obs,
                  max_steps, precision, method, resolution, fov,
                  d, e_x, e_y, boost):
    bx, by, res = _surface_beta_body(
        metric, r_obs, alpha_lookup, theta_lookup, theta_obs,
        max_steps, precision, method, False, resolution)
    return _shear_epilogue(bx, by, d, e_x, e_y, res.n_steps,
                           resolution, fov, boost)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "cfg",
                     "resolution", "fov", "use_tb"))
def _magnification_single(metric, r_obs, alpha_lookup, theta_lookup,
                          refine_cols, theta_obs, cfg, resolution, fov,
                          use_tb, d, e_x, e_y):
    """ONE program: the standard (final-alpha) precompute + the
    magnification epilogue. The 5-D trace path of `_precompute_eager`'s
    non-spherical branch with the camera lookups as TRACED inputs (the
    benchmark's pointing jitter reuses the compile; `_precompute_fused`
    takes the scene statically and would recompile per jitter)."""
    height, width = resolution
    from light_path_tracer_tpu import render as _render

    trace_rows = (height + 1) // 2 if use_tb else height
    alpha_t = alpha_lookup[:trace_rows, :].ravel()
    theta_t = theta_lookup[:trace_rows, :].ravel()
    refine_t = jnp.broadcast_to(refine_cols[None, :],
                                (trace_rows, width)).ravel()
    res = trace_batch(
        metric, r_obs, alpha_t, theta_t, theta_obs, refine_t,
        chunk_size=None, sort_by_difficulty=cfg.sort_by_difficulty,
        max_steps=cfg.max_steps, backend=cfg.backend,
        integrator=cfg.integrator, event_interp=cfg.event_interp,
        formulation=cfg.formulation, precision=cfg.precision)
    fa_rows = res.final_alpha.reshape(
        (trace_rows, width)).astype(jnp.float32)
    if use_tb:
        top_half = height // 2
        fa = jnp.full((height, width), jnp.nan, jnp.float32)
        fa = fa.at[:trace_rows].set(fa_rows)
        if top_half > 0:
            fa = fa.at[height - top_half:].set(fa[:top_half][::-1])
    else:
        fa = fa_rows
    frame = camera.PsiFrame(d, e_x, e_y, True)
    mu = _render.magnification_map(fa.astype(theta_lookup.dtype),
                                   theta_lookup, frame,
                                   resolution, fov)
    return jnp.concatenate([
        mu.ravel(), jnp.reshape(res.n_steps, (1,)).astype(mu.dtype)])


def render_caustics(scene: SceneConfig, resolution,
                    cfg: RenderConfig = RenderConfig(),
                    bins: int = 256, beta_max: float | None = None,
                    mesh=None):
    """Source-plane magnification (caustic) map by inverse ray
    shooting (render.source_plane_map): one standard precompute, then
    every escaped pixel carries its image-plane solid angle to its
    source position; A(beta) = arriving solid angle / source-plane
    solid angle, summed over ALL images. Caustics = the ridges where
    A diverges (the point caustic of Schwarzschild, its deformation
    for Kerr/charged/custom metrics).

    beta_max defaults to 70% of the FOV half-angle (bins mapping
    partly outside the camera FOV would read low). Returns
    (A (bins, bins) float32, extent, stats). Uses the side-exact
    escape chart (render.world_escape_beta), so asymmetric (Kerr)
    caustic structure lands on the correct side.
    """
    timer = StageTimer()
    resolution = tuple(resolution)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    if beta_max is None:
        beta_max = 0.7 * (scene.vertical_fov / 2.0)

    if mesh is None:
        # ONE program, one dispatch, one fetch (see the single-program
        # block above); the timed "precompute" stage is the whole
        # pipeline.
        metric = _metric_5d(scene.metric())
        lookups = _mode_lookups(scene, resolution, fov, _dtype_of(cfg))
        with timer.stage("precompute") as out:
            packed = _caustics_single(
                metric, scene.r_obs, *lookups, scene.theta_obs,
                cfg.max_steps, cfg.precision, cfg.integrator,
                tuple(resolution), fov, float(beta_max), int(bins))
            out.append(packed)
    else:
        with timer.stage("precompute") as out:
            bx, by, res, _th = _trace_escape_beta(
                scene, cfg, resolution, fov, mesh=mesh)
            out.append(bx)

        with timer.stage("render") as out:
            packed = _caustics_fused(bx, by, res.n_steps,
                                     tuple(resolution), fov,
                                     float(beta_max), int(bins))
            out.append(packed)

    extent = (-float(beta_max), float(beta_max))
    flat = np.asarray(packed)              # one host fetch
    amap_np = flat[:bins * bins].reshape(bins, bins).astype(np.float32)
    amap = amap_np
    stats = {
        "timings": timer.finish(),
        "total_rays": int(np.prod(resolution)),
        "traced_rays": int(np.prod(resolution)),
        "integrator_steps": int(flat[-1]),
        "beta_max": float(beta_max),
        "A_max": float(amap_np.max()),
        "A_far_field": float(np.median(amap_np[amap_np > 0]))
        if (amap_np > 0).any() else float("nan"),
    }
    return amap, extent, stats


def render_microlens_curve(scene: SceneConfig, resolution,
                           cfg: RenderConfig = RenderConfig(),
                           impact_u: float = 1.0,
                           span_u: float = 4.0,
                           n_points: int = 81,
                           source_radius_u: float = 0.3,
                           mesh=None):
    """Microlensing light curve A(t) of a finite circular source
    crossing the lens (render.microlens_light_curve): a straight
    source-plane track at impact parameter `impact_u` (units of the
    point-lens Einstein angle theta_E = sqrt(4 M / r_obs), the
    source-at-infinity weak-field scale), from -span_u to +span_u.

    For Schwarzschild in the weak field this reproduces the classic
    Paczynski curve A(u) = (u^2+2)/(u sqrt(u^2+4)); in the strong
    field / for spinning, charged, or user metrics it is the exact
    traced generalization. Returns (u_axis, A, stats).
    """
    timer = StageTimer()
    resolution = tuple(resolution)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    theta_e = math.sqrt(4.0 * scene.M / scene.r_obs)

    xs = np.linspace(-span_u, span_u, n_points)
    track = np.stack(
        [xs * theta_e, np.full(n_points, impact_u * theta_e)],
        axis=-1)
    if mesh is None:
        metric = _metric_5d(scene.metric())
        dtype = _dtype_of(cfg)
        lookups = _mode_lookups(scene, resolution, fov, dtype)
        with timer.stage("precompute") as out:
            packed = _microlens_single(
                metric, scene.r_obs, *lookups, scene.theta_obs,
                cfg.max_steps, cfg.precision, cfg.integrator,
                tuple(resolution), fov, jnp.asarray(track, dtype),
                float(source_radius_u * theta_e))
            out.append(packed)
    else:
        with timer.stage("precompute") as out:
            bx, by, res, _th = _trace_escape_beta(
                scene, cfg, resolution, fov, mesh=mesh)
            out.append(bx)

        with timer.stage("render") as out:
            packed = _microlens_fused(
                bx, by, jnp.asarray(track, bx.dtype), res.n_steps,
                tuple(resolution), fov,
                float(source_radius_u * theta_e))
            out.append(packed)

    u_axis = np.hypot(xs, impact_u)
    flat = np.asarray(packed)              # one host fetch
    curve_np = flat[:n_points].astype(np.float32)
    curve = curve_np
    stats = {
        "timings": timer.finish(),
        "total_rays": int(np.prod(resolution)),
        "traced_rays": int(np.prod(resolution)),
        "integrator_steps": int(flat[-1]),
        "theta_E": theta_e,
        "A_peak": float(curve_np.max()),
        "A_baseline": float(curve_np[0]),
    }
    return u_axis, curve, stats


def render_time_delay(scene: SceneConfig, resolution,
                      cfg: RenderConfig = RenderConfig(dtype="float64"),
                      mesh=None):
    """Per-pixel gravitational ARRIVAL-TIME map — the time-delay-
    cosmography observable (multiply-imaged sources arrive at
    different times; the delay measures the lens potential).

    Coordinate time rides the adaptive integrator as an
    error-controlled extra state component (dt/dlambda = metric.tdot,
    the same machinery as the retarded-time light curves), Hermite-
    localized onto the escape sphere r_e = 2 r_obs. The raw t there is
    dominated by geometry, so each ray is referenced to the plane wave
    of its own escape direction: tau = t - X.v (X = escape position,
    v = escape unit direction, both in BH-centered Cartesian) — the
    Fermat arrival time up to a global constant. Differences of tau
    between pixels imaging the SAME source position are the physical
    delays; the weak-field point-lens oracle
    dt = 4M [u sqrt(u^2+4)/2 + ln((sqrt(u^2+4)+u)/(sqrt(u^2+4)-u))]
    is pinned in tests/test_timedelay_map.py. The common ln(r)
    Shapiro growth cancels in any such difference.

    float64 recommended: t accumulates to ~4 r_obs while image delays
    are a few M (f32 resolution at t ~ 4000 M is ~0.25 M).

    Returns (tau (H, W), stats): tau relative to its finite minimum,
    NaN where captured/invalid; stats carries the side-exact source
    coordinates ("beta_x"/"beta_y", render.world_escape_beta) for
    image pairing.
    """
    timer = StageTimer()
    resolution = tuple(resolution)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    metric = _metric_5d(scene.metric())
    r_obs = scene.r_obs
    r_e = 2.0 * r_obs

    if mesh is None:
        lookups = _mode_lookups(scene, resolution, fov, _dtype_of(cfg))
        with timer.stage("precompute") as out:
            packed = _tau_single(
                metric, r_obs, *lookups, scene.theta_obs,
                cfg.max_steps, cfg.precision, cfg.integrator,
                tuple(resolution), float(r_e))
            out.append(packed)
    else:
        with timer.stage("precompute") as out:
            bx, by, res, _th = _trace_escape_beta(
                scene, cfg, resolution, fov, record_time=True,
                mesh=mesh)
            out.append(res.t_hit)

        with timer.stage("render") as out:
            packed = _tau_pack_fused(metric, float(r_e), res.theta,
                                     res.phi, res.p_r, res.p_theta,
                                     res.xi, res.t_hit, res.status,
                                     bx, by, res.n_steps,
                                     tuple(resolution))
            out.append(packed)

    # ONE host fetch for everything: (tau, bx, by) maps + the step
    # count riding the tail.
    flat = np.asarray(packed)
    n_px = int(np.prod(resolution))
    tau_np, bx_np, by_np = (flat[k * n_px:(k + 1) * n_px]
                            .reshape(resolution) for k in range(3))
    tau = tau_np
    finite = np.isfinite(tau_np)
    stats = {
        "timings": timer.finish(),
        "total_rays": n_px,
        "traced_rays": n_px,
        "integrator_steps": int(flat[-1]),
        "shadow_pixels": int((~finite).sum()),
        "tau_max": float(tau_np[finite].max()) if finite.any()
        else float("nan"),
        "beta_x": bx_np,
        "beta_y": by_np,
    }
    return tau, stats


def render_shear(scene: SceneConfig, resolution,
                 cfg: RenderConfig = RenderConfig(), mesh=None):
    """Convergence/shear/rotation maps of the traced lens map — the
    weak-lensing decomposition of the image-to-source Jacobian,
    computed exactly in the strong field
    (render.lens_jacobian_decomposition).

    kappa: isotropic focusing (-> 0 in the point-mass weak field;
    genuinely nonzero in the strong field); gamma1/gamma2: tidal
    shear (point-lens oracle theta_E^2/theta^2, tangential); omega:
    image rotation — ZERO for any static spacetime, nonzero under
    frame dragging: a direct, map-level spin observable. The raw
    omega map carries a grid-symmetric sin(4*phi) finite-difference
    artifact (~1e-3 at 128^2; insensitive to stencil order and
    tolerance tier — it tracks the adaptive controller's
    sub-smoothness, not truncation), but that artifact is ORTHOGONAL
    to the physics: the azimuthal m=0 (net twist) and m=1 moments of
    omega in an annulus read ~1e-6 at a=0 vs ~1e-3..1e-2 at a=0.9 —
    three orders of magnitude of frame-dragging discrimination
    (tests/test_shear.py).

    Returns (maps, stats): maps = dict with "kappa", "gamma1",
    "gamma2", "omega", "gamma" (= |gamma|), each (H, W) float32, NaN
    within one FD pixel of the shadow/chart edge.
    """
    from light_path_tracer_tpu import render as _render

    timer = StageTimer()
    resolution = tuple(resolution)
    fov = camera.fov_from_vertical(scene.vertical_fov, resolution)
    dtype = _dtype_of(cfg)

    frame = camera.psi_frame(scene.psi)
    if mesh is None:
        metric = _metric_5d(scene.metric())
        lookups = _mode_lookups(scene, resolution, fov, dtype)
        with timer.stage("precompute") as out:
            packed = _shear_single(
                metric, scene.r_obs, *lookups, scene.theta_obs,
                cfg.max_steps, cfg.precision, cfg.integrator,
                tuple(resolution), fov, jnp.asarray(frame.d, dtype),
                jnp.asarray(frame.e_x, dtype),
                jnp.asarray(frame.e_y, dtype), tuple(scene.boost))
            out.append(packed)
    else:
        with timer.stage("precompute") as out:
            bx, by, res, _th = _trace_escape_beta(
                scene, cfg, resolution, fov, mesh=mesh)
            out.append(bx)

        with timer.stage("render") as out:
            packed = _shear_fused(
                bx, by, jnp.asarray(frame.d, dtype),
                jnp.asarray(frame.e_x, dtype),
                jnp.asarray(frame.e_y, dtype), res.n_steps,
                tuple(resolution), fov, tuple(scene.boost))
            out.append(packed)

    flat = np.asarray(packed)              # one host fetch
    n_px = int(np.prod(resolution))
    names = ("kappa", "gamma1", "gamma2", "omega", "gamma")
    maps = {k: flat[i * n_px:(i + 1) * n_px].reshape(resolution)
            for i, k in enumerate(names)}
    gnp = maps["gamma"]
    onp = maps["omega"]
    finite = np.isfinite(gnp)
    stats = {
        "timings": timer.finish(),
        "total_rays": n_px,
        "traced_rays": n_px,
        "integrator_steps": int(flat[-1]),
        "shadow_pixels": int((~finite).sum()),
        "gamma_max": float(gnp[finite].max()) if finite.any()
        else float("nan"),
        "omega_abs_max": float(np.abs(onp[np.isfinite(onp)]).max())
        if np.isfinite(onp).any() else float("nan"),
    }
    return maps, stats
