"""Pinhole camera model with off-axis black hole (psi offset).

Conventions match the reference exactly (/root/reference/image_lens.py:1-2):
every pixel coordinate pair is (y, x); every FOV pair is
(horizontal, vertical); camera axes are +x right, +y down, +z forward
(image_lens.py:29-35).

Host-side scalar frame math (psi -> BH direction + tangent screen basis,
image_lens.py:21-69) runs in float64 NumPy at config time; the per-pixel
grids (alpha lookup, image_lens.py:133-152; screen-theta lookup,
image_lens.py:195-208) are batched jnp built from broadcasted index grids —
one fused XLA program instead of Python pixel loops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class PsiFrame(NamedTuple):
    d: np.ndarray     # BH direction in camera coords (3,)
    e_x: np.ndarray   # screen-tangent basis, aligns with +x image axis
    e_y: np.ndarray   # screen-tangent basis, aligns with +y image axis
    in_front: bool


def psi_to_bh_direction(psi):
    """psi = (pitch_up, yaw_right) [rad] -> BH unit direction in camera
    coords (image_lens.py:21-35). psi_y > 0 moves the BH up (-y)."""
    psi_y, psi_x = psi
    sin_pitch, cos_pitch = np.sin(psi_y), np.cos(psi_y)
    sin_yaw, cos_yaw = np.sin(psi_x), np.cos(psi_x)
    return np.array([sin_yaw * cos_pitch, -sin_pitch, cos_yaw * cos_pitch],
                    dtype=np.float64)


def psi_frame(psi) -> PsiFrame:
    """Gram-Schmidt tangent basis around the BH direction
    (image_lens.py:38-61); e_x/e_y align with the image axes at psi = 0."""
    d = psi_to_bh_direction(psi)
    in_front = bool(d[2] > 1e-12)

    cam_x = np.array([1.0, 0.0, 0.0])
    cam_y = np.array([0.0, 1.0, 0.0])

    e_x = cam_x - np.dot(cam_x, d) * d
    e_x_norm = np.linalg.norm(e_x)
    if e_x_norm < 1e-12:
        e_x = cam_y - np.dot(cam_y, d) * d
        e_x_norm = np.linalg.norm(e_x)
    e_x = e_x / max(e_x_norm, 1e-12)

    e_y = cam_y - np.dot(cam_y, d) * d - np.dot(cam_y, e_x) * e_x
    e_y_norm = np.linalg.norm(e_y)
    if e_y_norm < 1e-12:
        e_y = np.cross(d, e_x)
        e_y_norm = np.linalg.norm(e_y)
    e_y = e_y / max(e_y_norm, 1e-12)

    return PsiFrame(d, e_x, e_y, in_front)


def psi_to_cam_projection(psi):
    """BH direction projected onto the pinhole plane (image_lens.py:64-69).
    Returns (y_cam, x_cam, in_front)."""
    frame = psi_frame(psi)
    if not frame.in_front:
        return (np.nan, np.nan, False)
    d = frame.d
    return (float(d[1] / d[2]), float(d[0] / d[2]), True)


def focal_lengths(image_dimension, fov):
    """(fx, fy) of the pinhole model; (y, x) / (h, v) conventions."""
    height, width = image_dimension
    horizontal_fov, vertical_fov = fov
    fx = (width / 2) / np.tan(horizontal_fov / 2)
    fy = (height / 2) / np.tan(vertical_fov / 2)
    return fx, fy


def fov_from_vertical(vertical_fov, image_dimension):
    """(horizontal, vertical) FOV from the vertical FOV and aspect ratio
    (image_lens.py:461-463)."""
    height, width = image_dimension
    horizontal = 2.0 * np.arctan(np.tan(vertical_fov / 2) * width / height)
    return (horizontal, vertical_fov)


# ---- scalar conversions (API parity, image_lens.py:72-126) ----

def pixel_to_angles(pixel, image_dimension, fov, psi=(0.0, 0.0)):
    """(alpha, theta) of the camera ray through `pixel` = (y, x)."""
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    x_cam = (pixel[1] - width / 2) / fx
    y_cam = (pixel[0] - height / 2) / fy

    frame = psi_frame(psi)
    ray = np.array([x_cam, y_cam, 1.0])
    ray = ray / np.linalg.norm(ray)

    cos_alpha = np.clip(np.dot(ray, frame.d), -1.0, 1.0)
    alpha = float(np.arccos(cos_alpha))
    theta = float(np.arctan2(np.dot(ray, frame.e_x), np.dot(ray, frame.e_y)))
    return (alpha, theta)


def angles_to_pixel(angles, image_dimension, fov, clip=False, psi=(0.0, 0.0)):
    """Exact inverse of pixel_to_angles; returns (py, px) or (-1, -1) for
    rays behind the camera (when clip=False)."""
    alpha, theta = angles
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    frame = psi_frame(psi)

    ray = (np.cos(alpha) * frame.d
           + np.sin(alpha) * (np.sin(theta) * frame.e_x
                              + np.cos(theta) * frame.e_y))
    if ray[2] <= 1e-12:
        return (0, 0) if clip else (-1, -1)

    x = (ray[0] / ray[2]) * fx
    y = (ray[1] / ray[2]) * fy
    px = int(np.rint(x + width / 2))
    py = int(np.rint(y + height / 2))
    if clip:
        px = int(np.clip(px, 0, width - 1))
        py = int(np.clip(py, 0, height - 1))
    return (py, px)


# ---- relativistic aberration (observer at finite velocity) ----

def aberrate_view(vx, vy, vz, boost):
    """Special-relativistic aberration of unit VIEW directions (observer
    toward sky), moving-camera frame -> static frame. Batched jnp.

    `boost` = the camera's 3-velocity in units of c, in camera coords
    (+x right, +y down, +z forward); |boost| < 1. The photon propagates
    along -v, so the standard propagation-vector aberration

        k = (k'/gamma + (1 - 1/gamma)(bhat.k') bhat + beta) / (1 + beta.k')

    is applied to k' = -v'. Forward motion (boost = (0,0,b)) squeezes
    the forward sky toward the +z axis in the camera frame; equivalently
    this inverse map spreads camera directions outward in the static
    frame — the black-hole shadow appears SMALLER when flying toward it.

    New capability beyond the reference (which has a static observer
    only); composes with everything downstream because the tracer only
    ever sees the static-frame (alpha, theta).
    """
    bx, by, bz = (float(boost[0]), float(boost[1]), float(boost[2]))
    b2 = bx * bx + by * by + bz * bz
    if b2 >= 1.0:
        raise ValueError("|boost| must be < 1 (units of c)")
    if b2 == 0.0:
        return vx, vy, vz
    gamma = 1.0 / np.sqrt(1.0 - b2)
    # k' = -v' (propagation direction in the camera frame).
    kx, ky, kz = -vx, -vy, -vz
    bdotk = bx * kx + by * ky + bz * kz
    coef = (1.0 - 1.0 / gamma) / b2 * bdotk  # (1-1/g)(bhat.k')/|b| along bhat
    denom = 1.0 + bdotk
    kx = (kx / gamma + coef * bx + bx) / denom
    ky = (ky / gamma + coef * by + by) / denom
    kz = (kz / gamma + coef * bz + bz) / denom
    # Renormalize (pure roundoff; the map preserves unit length exactly).
    n = jnp.sqrt(kx * kx + ky * ky + kz * kz)
    return -kx / n, -ky / n, -kz / n


def aberrate_view_dynamic(vx, vy, vz, bx, by, bz):
    """aberrate_view with TRACED boost scalars (flyby sequences).

    Same propagation-vector map, but (bx, by, bz) are jnp scalars inside
    an enclosing jit, so one compiled program serves a whole boost ramp.
    Safe at b = 0 (the 0/0 in the bhat projection is guarded and the
    identity map is selected), so a ramp may start from rest. |b| >= 1
    cannot raise under trace; callers validate host-side.
    """
    dtype = vx.dtype
    bx = jnp.asarray(bx, dtype)
    by = jnp.asarray(by, dtype)
    bz = jnp.asarray(bz, dtype)
    b2 = bx * bx + by * by + bz * bz
    tiny = jnp.asarray(1e-30, dtype)
    gamma = 1.0 / jnp.sqrt(jnp.maximum(1.0 - b2, tiny))
    kx, ky, kz = -vx, -vy, -vz
    bdotk = bx * kx + by * ky + bz * kz
    coef = (1.0 - 1.0 / gamma) / jnp.maximum(b2, tiny) * bdotk
    denom = 1.0 + bdotk
    akx = (kx / gamma + coef * bx + bx) / denom
    aky = (ky / gamma + coef * by + by) / denom
    akz = (kz / gamma + coef * bz + bz) / denom
    n = jnp.sqrt(akx * akx + aky * aky + akz * akz)
    moving = b2 > 0.0
    return (jnp.where(moving, -akx / n, vx),
            jnp.where(moving, -aky / n, vy),
            jnp.where(moving, -akz / n, vz))


def doppler_lookup(image_dimension, fov, boost, dtype=jnp.float32,
                   pixel_offset=(0.0, 0.0)):
    """Per-pixel Doppler factor delta = nu_cam / nu_static, (H, W).

    delta = gamma (1 + beta . v_static) with v_static the static-frame
    view direction of the pixel (the aberrated one): looking along the
    motion gives the head-light blueshift sqrt((1+b)/(1-b)). Observed
    intensities scale as delta**4 (Liouville, I_nu/nu^3 invariant);
    blackbody temperatures scale as delta.
    """
    bx, by, bz = (float(boost[0]), float(boost[1]), float(boost[2]))
    b2 = bx * bx + by * by + bz * bz
    vx, vy, vz = _view_grids(image_dimension, fov, dtype, pixel_offset)
    if b2 == 0.0:
        return jnp.ones_like(vx * vy)
    gamma = 1.0 / np.sqrt(1.0 - b2)
    vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    return (gamma * (1.0 + bx * vx + by * vy + bz * vz)).astype(dtype)


def _view_grids(image_dimension, fov, dtype, pixel_offset=(0.0, 0.0)):
    """Broadcast unit view-direction component grids (vx, vy, vz)."""
    x_cam, y_cam = _cam_grids(image_dimension, fov, dtype, pixel_offset)
    denom = jnp.sqrt(1.0 + x_cam[None, :] ** 2 + y_cam[:, None] ** 2)
    vx = x_cam[None, :] / denom
    vy = y_cam[:, None] / denom
    vz = 1.0 / denom  # (H, W) via broadcast
    return vx, vy, vz


# ---- batched per-pixel grids (jnp) ----

def _cam_grids(image_dimension, fov, dtype, pixel_offset=(0.0, 0.0)):
    """Normalized camera-plane coordinate grids; `pixel_offset` = (dy, dx)
    subpixel shift in pixels (used by jittered AA supersampling)."""
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    oy, ox = pixel_offset
    x_cam = (jnp.arange(width, dtype=dtype) - width / 2 + ox) / fx
    y_cam = (jnp.arange(height, dtype=dtype) - height / 2 + oy) / fy
    return x_cam, y_cam


def build_alpha_lookup(image_dimension, fov, decimals=None, psi=(0.0, 0.0),
                       dtype=jnp.float32, pixel_offset=(0.0, 0.0),
                       boost=None):
    """Per-pixel viewing angle alpha to the BH direction, (H, W).

    Parity: image_lens.py:133-152 (one arccos per pixel on broadcasted
    camera grids; optional decimal rounding for binning; float32 out).
    `boost` (camera 3-velocity, units of c) aberrates each pixel's view
    direction into the static frame first (aberrate_view).
    """
    if boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = _view_grids(image_dimension, fov, dtype, pixel_offset)
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
        d = psi_frame(psi).d
        cos_alpha = vx * d[0] + vy * d[1] + vz * d[2]
    else:
        x_cam, y_cam = _cam_grids(image_dimension, fov, dtype, pixel_offset)
        d = psi_frame(psi).d
        denom = jnp.sqrt(1.0 + x_cam[None, :] ** 2 + y_cam[:, None] ** 2)
        cos_alpha = (x_cam[None, :] * d[0]
                     + y_cam[:, None] * d[1] + d[2]) / denom
    alpha = jnp.arccos(jnp.clip(cos_alpha, -1.0, 1.0))
    if decimals is not None:
        alpha = jnp.round(alpha, decimals)
    return alpha.astype(dtype)


def build_theta_lookup(image_dimension, fov, psi=(0.0, 0.0),
                       dtype=jnp.float32, pixel_offset=(0.0, 0.0),
                       boost=None):
    """Per-pixel screen azimuth theta about the BH direction, (H, W).

    Parity: the theta_pixel construction of image_lens.py:195-208 (and the
    identical theta_lookup in the renderer, image_lens.py:310-317).
    `boost` as in build_alpha_lookup.
    """
    frame = psi_frame(psi)
    e_x, e_y = frame.e_x, frame.e_y

    vx, vy, vz = _view_grids(image_dimension, fov, dtype, pixel_offset)
    if boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    theta = jnp.arctan2(
        vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
        vx * e_y[0] + vy * e_y[1] + vz * e_y[2],
    )
    return theta.astype(dtype)


def pixel_angles_at(py, px, image_dimension, fov, psi=(0.0, 0.0),
                    dtype=jnp.float32, pixel_offset=(0.0, 0.0),
                    boost=None):
    """Batched (alpha, theta) at arbitrary pixel coordinates.

    `py`/`px` are integer or float arrays of pixel row/column indices;
    returns (alpha, theta) arrays of the same shape. Same math — and the
    same operation order, so values match the grid builders exactly — as
    build_alpha_lookup / build_theta_lookup, evaluated at scattered
    pixels instead of the full (H, W) grid: the adaptive-AA refinement
    path traces extra subpixel samples only at edge pixels gathered by
    top_k. Scalar parity anchor: pixel_to_angles (image_lens.py:72-126).
    """
    height, width = image_dimension
    fx, fy = focal_lengths(image_dimension, fov)
    oy, ox = pixel_offset
    x_cam = (jnp.asarray(px).astype(dtype) - width / 2 + ox) / fx
    y_cam = (jnp.asarray(py).astype(dtype) - height / 2 + oy) / fy
    frame = psi_frame(psi)
    d, e_x, e_y = frame.d, frame.e_x, frame.e_y
    denom = jnp.sqrt(1.0 + x_cam ** 2 + y_cam ** 2)
    boosted = boost is not None and any(float(b) != 0.0 for b in boost)
    vx, vy, vz = x_cam / denom, y_cam / denom, 1.0 / denom
    if boosted:
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
        cos_alpha = vx * d[0] + vy * d[1] + vz * d[2]
    else:
        cos_alpha = (x_cam * d[0] + y_cam * d[1] + d[2]) / denom
    alpha = jnp.arccos(jnp.clip(cos_alpha, -1.0, 1.0))
    theta = jnp.arctan2(
        vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
        vx * e_y[0] + vy * e_y[1] + vz * e_y[2],
    )
    return alpha.astype(dtype), theta.astype(dtype)


def axis_refine_columns(image_dimension, fov, psi=(0.0, 0.0),
                        refine_frac=0.07, boost=None):
    """Boolean (W,) mask of columns near the BH's screen column, where
    tighter integrator tolerances are used (image_lens.py:210-216,
    Y_AXIS_REFINE_FRAC = 0.07).

    Under a camera boost, the band is computed in the STATIC frame
    (where the near-axis L -> 0 rays actually live): each column's
    center-row view direction is aberrated before measuring its
    distance to the BH direction's projection.
    """
    height, width = image_dimension
    fx, _fy = focal_lengths(image_dimension, fov)
    x_cam = (np.arange(width) - width / 2) / fx
    _bh_y, bh_x_cam, in_front = psi_to_cam_projection(psi)
    if not in_front:
        return np.zeros(width, dtype=bool)
    if boost is not None and any(float(b) != 0.0 for b in boost):
        # jnp throughout: this branch runs inside jitted pipelines
        # (pipeline._render_scene_fused), where a np.asarray() on the
        # traced aberration result would fail.
        denom = np.sqrt(1.0 + x_cam ** 2)
        vx = jnp.asarray(x_cam / denom)
        vy = jnp.zeros_like(vx)
        vz = jnp.asarray(1.0 / denom)
        wx, _wy, wz = aberrate_view(vx, vy, vz, boost)
        x_rel = wx / jnp.maximum(wz, 1e-12) - bh_x_cam
        x_abs_max = jnp.maximum(jnp.max(jnp.abs(x_rel)), 1e-12)
        return jnp.abs(x_rel) <= refine_frac * x_abs_max
    x_rel = x_cam - bh_x_cam
    x_abs_max = max(float(np.max(np.abs(x_rel))), 1e-12)
    return np.abs(x_rel) <= refine_frac * x_abs_max


# ---- traced-psi variants (animation / serving: no recompile per frame) ----

def psi_frame_dynamic(psi_y, psi_x):
    """psi_frame with traced scalars: returns (d, e_x, e_y) as jnp (3,)
    vectors. Identical math to the host version; used by the sequence
    renderer so a camera pan reuses one compiled program. Dot products
    are written as sums of products: a float32 dot may run in TF32 on
    a GPU."""
    sin_p, cos_p = jnp.sin(psi_y), jnp.cos(psi_y)
    sin_yw, cos_yw = jnp.sin(psi_x), jnp.cos(psi_x)
    d = jnp.stack([sin_yw * cos_p, -sin_p, cos_yw * cos_p])

    cam_x = jnp.array([1.0, 0.0, 0.0], d.dtype)
    cam_y = jnp.array([0.0, 1.0, 0.0], d.dtype)

    e_x = cam_x - jnp.sum(cam_x * d) * d
    nx = jnp.linalg.norm(e_x)
    e_x_alt = cam_y - jnp.sum(cam_y * d) * d
    e_x = jnp.where(nx < 1e-12, e_x_alt, e_x)
    e_x = e_x / jnp.maximum(jnp.linalg.norm(e_x), 1e-12)

    e_y = cam_y - jnp.sum(cam_y * d) * d - jnp.sum(cam_y * e_x) * e_x
    ny = jnp.linalg.norm(e_y)
    e_y = jnp.where(ny < 1e-12, jnp.cross(d, e_x), e_y)
    e_y = e_y / jnp.maximum(jnp.linalg.norm(e_y), 1e-12)
    return d, e_x, e_y


def build_angle_lookups_dynamic(image_dimension, fov, psi_y, psi_x,
                                dtype=jnp.float32, boost=None,
                                boost_dynamic=None):
    """(alpha, theta) per-pixel grids with traced psi scalars. `boost`
    (static per-sequence) aberrates the view as in build_alpha_lookup;
    `boost_dynamic` = traced (bx, by, bz) scalars instead (flyby
    sequences — one compiled program over a whole boost ramp)."""
    d, e_x, e_y = psi_frame_dynamic(jnp.asarray(psi_y, dtype),
                                    jnp.asarray(psi_x, dtype))
    vx, vy, vz = _view_grids(image_dimension, fov, dtype)
    if boost_dynamic is not None:
        vx, vy, vz = aberrate_view_dynamic(vx, vy, vz, *boost_dynamic)
    elif boost is not None and any(float(b) != 0.0 for b in boost):
        vx, vy, vz = aberrate_view(vx, vy, vz, boost)
    cos_alpha = vx * d[0] + vy * d[1] + vz * d[2]
    alpha = jnp.arccos(jnp.clip(cos_alpha, -1.0, 1.0))
    theta = jnp.arctan2(
        vx * e_x[0] + vy * e_x[1] + vz * e_x[2],
        vx * e_y[0] + vy * e_y[1] + vz * e_y[2])
    return alpha.astype(dtype), theta.astype(dtype)
