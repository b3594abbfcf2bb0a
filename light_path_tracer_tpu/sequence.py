"""Animation / serving: frame sequences without per-frame recompilation.

The static pipeline folds the camera pointing psi into compiled constants
(fastest for a single frame). For sequences — a camera pan, an orbiting
observer — that would recompile every frame; here psi is a *traced*
argument instead, so the whole per-frame program (camera grids -> Kerr
trace -> renderer) compiles once and every subsequent frame is a single
dispatch.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from light_path_tracer_tpu.models import Kerr
from light_path_tracer_tpu import camera
from light_path_tracer_tpu.ops.kerr_trace import (
    trace_rays_kerr, trace_rays_kerr_hybrid)
from light_path_tracer_tpu.render import _render_core
from light_path_tracer_tpu.utils.config import SceneConfig, RenderConfig


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "resolution", "fov",
                     "max_steps", "shadow_only", "loop_around", "boost"))
def _render_frame_dynamic(psi_y, psi_x, source_image, *, metric, r_obs,
                          theta_obs, resolution, fov, max_steps,
                          shadow_only, loop_around, boost=(0.0, 0.0, 0.0)):
    dtype = jnp.float32
    alpha, theta = camera.build_angle_lookups_dynamic(
        resolution, fov, psi_y, psi_x, dtype=dtype, boost=boost)
    # Hybrid tracer: the mu-form bulk plus a theta-form retrace of the
    # pole-aimed rays (the camera may pan across the axis).
    res = trace_rays_kerr_hybrid(
        metric, r_obs, alpha.ravel(), theta.ravel(), theta_obs,
        jnp.zeros(alpha.size, bool), max(5000.0, 6.0 * r_obs),
        max_steps)
    fa = res.final_alpha.reshape(resolution)
    if shadow_only:
        return jnp.where(jnp.isnan(fa), 0.0, 1.0).astype(jnp.float32)
    winding = jnp.clip(res.n_half_orbits, 0, 65535).astype(
        jnp.uint16).reshape(resolution)
    d, e_x, e_y = camera.psi_frame_dynamic(
        jnp.asarray(psi_y, dtype), jnp.asarray(psi_x, dtype))
    return _render_core(source_image, theta, fa, winding, d, e_x, e_y,
                        resolution, fov, loop_around)


def render_sequence(scene: SceneConfig, psi_frames, source_image=None,
                    resolution=None, cfg: RenderConfig = RenderConfig(),
                    max_steps: int = 20000):
    """Render frames for a sequence of (psi_y, psi_x) camera pointings.

    One compile for the whole sequence. source_image=None renders binary
    shadows (resolution required); otherwise full lensed frames at the
    source image's resolution.

    Dynamic-psi tradeoffs vs the static pipeline: no top/bottom mirror
    shortcut and no axis-refine band (both depend on psi at trace time).
    Returns a list of device arrays.
    """
    from light_path_tracer_tpu.disk import _scene_metric
    metric = _scene_metric(scene)   # Kerr, or Kerr-Newman when charged
    shadow_only = source_image is None
    if shadow_only:
        if resolution is None:
            raise ValueError("resolution required for shadow sequences")
        src = jnp.zeros((1, 1), jnp.float32)   # unused placeholder
        resolution = tuple(resolution)
    else:
        src = jnp.asarray(source_image)
        if src.dtype == jnp.uint8:
            src = src.astype(jnp.float32) / 255.0
        resolution = tuple(src.shape[:2])
    fov = tuple(float(f) for f in
                camera.fov_from_vertical(scene.vertical_fov, resolution))

    frames = []
    for psi_y, psi_x in psi_frames:
        frames.append(_render_frame_dynamic(
            jnp.asarray(psi_y, jnp.float32),
            jnp.asarray(psi_x, jnp.float32), src,
            metric=metric, r_obs=float(scene.r_obs),
            theta_obs=float(scene.theta_obs), resolution=resolution,
            fov=fov, max_steps=max_steps, shadow_only=shadow_only,
            loop_around=cfg.render_loop_around,
            boost=tuple(float(b) for b in scene.boost)))
    return frames


@functools.partial(
    jax.jit,
    static_argnames=("r_obs", "theta_obs", "resolution", "fov",
                     "max_steps", "boost"))
def _shadow_frame_param_dynamic(psi_y, psi_x, M, a, *, r_obs, theta_obs,
                                resolution, fov, max_steps,
                                boost=(0.0, 0.0, 0.0)):
    dtype = jnp.float32
    alpha, theta = camera.build_angle_lookups_dynamic(
        resolution, fov, psi_y, psi_x, dtype=dtype, boost=boost)
    placeholder = Kerr(M=1.0, a=0.0)   # API placeholder; params are traced
    res = trace_rays_kerr_hybrid(
        placeholder, r_obs, alpha.ravel(), theta.ravel(), theta_obs,
        jnp.zeros(alpha.size, bool), max(5000.0, 6.0 * r_obs),
        max_steps, dynamic_params=(M, a))
    fa = res.final_alpha.reshape(resolution)
    return jnp.where(jnp.isnan(fa), 0.0, 1.0).astype(jnp.float32)


@functools.partial(
    jax.jit,
    static_argnames=("theta_obs", "resolution", "fov", "lambda_max",
                     "max_steps", "shadow_only", "loop_around"))
def _flyby_frame_dynamic(psi_y, psi_x, M, a, r_obs, bx, by, bz,
                         source_image, *, theta_obs, resolution, fov,
                         lambda_max, max_steps, shadow_only,
                         loop_around):
    """One flyby frame with (psi, M, a, r_obs, boost) ALL traced.

    The observer radius rides the trace as dynamic_params[2] and the
    camera boost goes through the traced
    aberration map, so a whole approach/flyby animation — radius ramp +
    accelerating camera — is ONE compiled program. `lambda_max` is the
    static affine-parameter bound and must cover the LARGEST radius of
    the sweep (the caller passes max(5000, 6 * max r_obs)).
    """
    dtype = jnp.float32
    psi_y = jnp.asarray(psi_y, dtype)
    psi_x = jnp.asarray(psi_x, dtype)
    r_obs = jnp.asarray(r_obs, dtype)
    alpha, theta = camera.build_angle_lookups_dynamic(
        resolution, fov, psi_y, psi_x, dtype=dtype,
        boost_dynamic=(bx, by, bz))
    placeholder = Kerr(M=1.0, a=0.0)   # API placeholder; params traced
    res = trace_rays_kerr_hybrid(
        placeholder, 100.0, alpha.ravel(), theta.ravel(), theta_obs,
        jnp.zeros(alpha.size, bool), lambda_max, max_steps,
        dynamic_params=(jnp.asarray(M, dtype), jnp.asarray(a, dtype),
                        r_obs))
    fa = res.final_alpha.reshape(resolution)
    if shadow_only:
        return jnp.where(jnp.isnan(fa), 0.0, 1.0).astype(jnp.float32)
    winding = jnp.clip(res.n_half_orbits, 0, 65535).astype(
        jnp.uint16).reshape(resolution)
    d, e_x, e_y = camera.psi_frame_dynamic(psi_y, psi_x)
    return _render_core(source_image, theta, fa, winding, d, e_x, e_y,
                        resolution, fov, loop_around)


def render_flyby(scene: SceneConfig, frames, source_image=None,
                 resolution=None, cfg: RenderConfig = RenderConfig(),
                 max_steps: int = 20000):
    """Flyby / approach sequences: one compile over frames that vary the
    OBSERVER — radius and velocity — as well as the camera pointing.

    frames: iterable of (r_obs, boost) or (psi_y, psi_x, r_obs, boost)
    tuples, boost a 3-vector in units of c (camera coords: +x right,
    +y down, +z forward — (0, 0, b) flies toward the BH; the shadow
    shrinks by aberration even as the approach grows it). Omitted psi
    uses scene.psi for every frame. source_image=None renders binary
    shadows (resolution required); otherwise lensed frames at the
    source image's resolution.

    Unlike render_sequence / render_param_sequence (static r_obs and
    boost folded into compiled constants), r_obs enters the trace as a
    traced scalar (dynamic_params[2]) and
    the boost goes through camera.aberrate_view_dynamic — so an
    approach animation costs one compile total. Escape radius (2 r_obs)
    and initial step size track the traced radius per frame; the affine
    bound lambda_max is static at max(5000, 6 * max r_obs).
    """
    if getattr(scene, "Q", 0.0):
        raise ValueError(
            "render_flyby traces the metric through TracedKerr, which "
            "is uncharged; charged flybys are not supported — use "
            "render_sequence (static Kerr-Newman metric) instead")
    norm = []
    for f in frames:
        if len(f) == 2:
            r_o, boost = f
            psi_y, psi_x = scene.psi
        else:
            psi_y, psi_x, r_o, boost = f
        bx, by, bz = (float(b) for b in boost)
        if bx * bx + by * by + bz * bz >= 1.0:
            raise ValueError("|boost| must be < 1 (units of c)")
        norm.append((float(psi_y), float(psi_x), float(r_o),
                     (bx, by, bz)))
    if not norm:
        return []
    lambda_max = max(5000.0, 6.0 * max(f[2] for f in norm))

    shadow_only = source_image is None
    if shadow_only:
        if resolution is None:
            raise ValueError("resolution required for shadow flybys")
        src = jnp.zeros((1, 1), jnp.float32)
        resolution = tuple(resolution)
    else:
        src = jnp.asarray(source_image)
        if src.dtype == jnp.uint8:
            src = src.astype(jnp.float32) / 255.0
        resolution = tuple(src.shape[:2])
    fov = tuple(float(f) for f in
                camera.fov_from_vertical(scene.vertical_fov, resolution))

    out = []
    for psi_y, psi_x, r_o, (bx, by, bz) in norm:
        out.append(_flyby_frame_dynamic(
            jnp.asarray(psi_y, jnp.float32),
            jnp.asarray(psi_x, jnp.float32),
            jnp.asarray(scene.M, jnp.float32),
            jnp.asarray(scene.a, jnp.float32),
            jnp.asarray(r_o, jnp.float32),
            jnp.asarray(bx, jnp.float32), jnp.asarray(by, jnp.float32),
            jnp.asarray(bz, jnp.float32), src,
            theta_obs=float(scene.theta_obs), resolution=resolution,
            fov=fov, lambda_max=float(lambda_max), max_steps=max_steps,
            shadow_only=shadow_only,
            loop_around=cfg.render_loop_around))
    return out


def render_param_sequence(scene: SceneConfig, frames, resolution,
                          max_steps: int = 20000):
    """Shadow frames over a sequence of (psi_y, psi_x, M, a) — camera AND
    metric parameters traced, so e.g. a spin ramp 0 -> 0.99 reuses ONE
    compiled program (the static pipeline would recompile per spin)."""
    if getattr(scene, "Q", 0.0):
        raise ValueError(
            "render_param_sequence traces (M, a) through TracedKerr, "
            "which is uncharged; charged sweeps are not supported — "
            "use render_sequence (static Kerr-Newman metric) instead")
    resolution = tuple(resolution)
    fov = tuple(float(f) for f in
                camera.fov_from_vertical(scene.vertical_fov, resolution))
    out = []
    for psi_y, psi_x, M, a in frames:
        out.append(_shadow_frame_param_dynamic(
            jnp.asarray(psi_y, jnp.float32),
            jnp.asarray(psi_x, jnp.float32),
            jnp.asarray(M, jnp.float32), jnp.asarray(a, jnp.float32),
            r_obs=float(scene.r_obs), theta_obs=float(scene.theta_obs),
            resolution=resolution, fov=fov, max_steps=max_steps,
            boost=tuple(float(b) for b in scene.boost)))
    return out
