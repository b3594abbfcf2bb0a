"""Fused whole-trace Pallas kernel (Triton route) for the Kerr hot loop.

One program per 1-D block of `block` rays runs the *entire* adaptive
integration — initial conditions, every DP45 stage of every step, event
interpolation, the disk-crossing recorder — with the ray state held in
registers. Device memory sees one read of the screen-angle inputs and one
write of the final state. Each block's `lax.while_loop` exits as soon as
*its* rays finish, so blocks of easy far-field rays free their SM early
while photon-ring blocks keep integrating; the XLA path instead advances
the whole grid until its slowest lane is done.

The numerics are those of the XLA path: both call
ops.kerr_trace.dp45_integrate, which is shape-polymorphic over the ray
axis. float32 only; float64 stays on the XLA path. Tested against the XLA
path in tests/test_pallas.py (Triton interpret mode on the CPU, and a
CUDA lowering check).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from light_path_tracer_tpu.ops.kerr_trace import (
    dp45_integrate, finalize_angles, get_tols, _h_init_for,
    RUNNING, INVALID)
from light_path_tracer_tpu.ops.types import TraceResult

# Rays per program and warps per program (num_stages=1: the body is one
# register-resident loop with nothing to pipeline). One ray per thread,
# one warp per program: the finest early exit, and 76-80 registers a
# thread with no spills. Swept on an H100 over B in {32..256} x warps in
# {1, 2, 4}; PERF.md has the table.
BLOCK = 32
NUM_WARPS = 1


def _trace_block_kernel(alpha_ref, theta_ref, refine_ref, valid_ref,
                        plunge_ref, *out_refs, metric, r_obs, theta_obs,
                        lambda_max, max_steps, event_interp, tols,
                        disk_plane=None, max_disk_hits=2, method="dp45",
                        record_momentum=False):
    (r_out, th_out, phi_out, pr_out, pth_out,
     status_out, steps_out) = out_refs[:7]
    alphas = alpha_ref[...]
    thetas = theta_ref[...]
    refine = refine_ref[...] > 0.5
    valid = valid_ref[...] > 0.5
    dtype = alphas.dtype

    atol = jnp.where(refine, tols["atol_ref"], tols["atol"]).astype(dtype)
    rtol = jnp.where(refine, tols["rtol_ref"], tols["rtol"]).astype(dtype)

    y0, p_t, p_phi, invalid0 = metric.initial_conditions_5d(
        r_obs, alphas, thetas, theta_obs)
    status0 = jnp.where(invalid0 | ~valid, INVALID, RUNNING).astype(
        jnp.int32)
    # Certain-capture early-exit radii, precomputed by the wrapper (the
    # Bardeen formula needs acos, which the Triton route does not
    # lower); disabled in disk mode, where custom inner radii could
    # otherwise clip legitimate plane crossings.
    r_plunge = plunge_ref[...] if disk_plane is None else None

    result = dp45_integrate(
        metric, y0, p_t, p_phi, status0,
        atol=atol, rtol=rtol,
        h_min=jnp.asarray(tols["h_min"], dtype),
        tiny_err=tols["tiny_err"],
        r_capture=jnp.asarray(metric.capture_radius(), dtype),
        r_escape=jnp.asarray(r_obs * 2.0, dtype),
        lambda_max=lambda_max, h_init=_h_init_for(r_obs, dtype),
        max_steps=max_steps, event_interp=event_interp,
        disk_plane=disk_plane, max_disk_hits=max_disk_hits,
        r_plunge=r_plunge, method=method,
        record_momentum=record_momentum)
    if disk_plane is not None:
        y_f, status_f, _lam_f, steps, hits = result
        out_refs[7][...] = hits["n"]
        for slot in range(max_disk_hits):
            out_refs[8 + slot][...] = hits["r"][slot]
            out_refs[8 + max_disk_hits + slot][...] = hits["phi"][slot]
            if record_momentum:
                out_refs[8 + 2 * max_disk_hits + slot][...] = (
                    hits["pr"][slot])
                out_refs[8 + 3 * max_disk_hits + slot][...] = (
                    hits["pth"][slot])
    else:
        y_f, status_f, _lam_f, steps = result

    r_out[...] = y_f[0]
    th_out[...] = y_f[1]
    phi_out[...] = y_f[2]
    pr_out[...] = y_f[3]
    pth_out[...] = y_f[4]
    status_out[...] = status_f
    steps_out[...] = jnp.full(steps_out.shape, steps, jnp.int32)


def _run_blocks(kernel, n, alphas, thetas, refine, plunge, n_extra_i32,
                n_extra_f32, block, num_warps, interpret):
    """Pad the (N,) inputs to whole blocks (padding lanes are masked
    invalid and cost no integration steps), launch one program per block
    and return the unpadded outputs plus the summed per-block step count."""
    dtype = alphas.dtype
    n_pad = max(1, -(-n // block)) * block
    n_blocks = n_pad // block

    def pad(x, fill):
        return jnp.concatenate(
            [x, jnp.full((n_pad - n,), fill, x.dtype)]) if n_pad > n else x

    inputs = (pad(alphas, 0.1), pad(thetas, 0.0), pad(refine, 0.0),
              pad(jnp.ones((n,), dtype), 0.0), pad(plunge, 0.0))
    spec = pl.BlockSpec((block,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), dtype)
    i32 = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
    out_shape = ((f32,) * 5 + (i32,) * (2 + n_extra_i32)
                 + (f32,) * n_extra_f32)
    outs = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[spec] * len(inputs),
        out_specs=(spec,) * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        interpret=interpret,
        name="kerr_trace_block",
    )(*inputs)
    # n_steps = loop iterations summed over independently scheduled
    # blocks (every lane of a block carries its block's count) — the
    # cross-backend contract of ops/types.py.
    n_steps = jnp.sum(outs[6].reshape(n_blocks, block)[:, 0])
    return [o[:n] for o in outs], n_steps


def _check_f32(dtype):
    if dtype != jnp.float32:
        raise ValueError("pallas path is float32-only; got " + str(dtype))


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "lambda_max",
                     "max_steps", "event_interp", "block", "num_warps",
                     "interpret", "precision", "method"))
def trace_rays_kerr_pallas(metric, r_obs, alphas, thetas, theta_obs,
                           axis_refine, lambda_max: float,
                           max_steps: int = 200000,
                           event_interp: str = "hermite",
                           block: int = BLOCK,
                           num_warps: int = NUM_WARPS,
                           interpret: bool = False,
                           precision: str = "fast",
                           method: str = "dp45"):
    """Fused-kernel Kerr batch tracer; drop-in for trace_rays_kerr."""
    dtype = alphas.dtype
    _check_f32(dtype)
    n = alphas.shape[0]
    kernel = functools.partial(
        _trace_block_kernel, metric=metric, r_obs=float(r_obs),
        theta_obs=float(theta_obs), lambda_max=float(lambda_max),
        max_steps=max_steps, event_interp=event_interp,
        tols=get_tols(dtype, precision), method=method)
    plunge = metric.plunge_radii(
        float(r_obs), alphas, thetas, float(theta_obs)).astype(dtype)
    outs, n_steps = _run_blocks(
        kernel, n, alphas, thetas, axis_refine.astype(dtype), plunge,
        0, 0, block, num_warps, interpret)

    # Extraction outside the kernel (one cheap vectorized pass).
    _y0, p_t, p_phi, _inv = metric.initial_conditions_5d(
        float(r_obs), alphas, thetas, float(theta_obs))
    final_alpha, n_half, status_out = finalize_angles(
        metric, tuple(outs[:5]), p_t, p_phi, outs[5])
    return TraceResult(final_alpha, n_half, status_out, n_steps)


@functools.partial(
    jax.jit,
    static_argnames=("metric", "r_obs", "theta_obs", "lambda_max",
                     "max_steps", "disk_plane", "max_disk_hits", "block",
                     "num_warps", "interpret", "precision", "method",
                     "record_momentum"))
def trace_disk_rays_pallas(metric, r_obs, alphas, thetas, theta_obs,
                           lambda_max: float, max_steps: int,
                           disk_plane, max_disk_hits: int = 2,
                           block: int = BLOCK,
                           num_warps: int = NUM_WARPS,
                           interpret: bool = False,
                           precision: str = "fast",
                           method: str = "dp45",
                           record_momentum: bool = False):
    """Fused-kernel disk-mode tracer: DP45 + equatorial-crossing recording
    in one kernel. Returns the disk.DiskTraceResult tuple — the same
    contract as disk.trace_disk_rays."""
    dtype = alphas.dtype
    _check_f32(dtype)
    n = alphas.shape[0]
    kernel = functools.partial(
        _trace_block_kernel, metric=metric, r_obs=float(r_obs),
        theta_obs=float(theta_obs), lambda_max=float(lambda_max),
        max_steps=max_steps, event_interp="hermite",
        tols=get_tols(dtype, precision), disk_plane=disk_plane,
        max_disk_hits=max_disk_hits, method=method,
        record_momentum=record_momentum)
    zeros = jnp.zeros((n,), dtype)
    n_mom = 4 if record_momentum else 2
    outs, n_steps = _run_blocks(
        kernel, n, alphas, thetas, zeros, zeros, 1,
        n_mom * max_disk_hits, block, num_warps, interpret)

    k = max_disk_hits
    hit_r = tuple(outs[8:8 + k])
    hit_phi = tuple(outs[8 + k:8 + 2 * k])
    hit_pr = tuple(outs[8 + 2 * k:8 + 3 * k]) if record_momentum else ()
    hit_pth = tuple(outs[8 + 3 * k:8 + 4 * k]) if record_momentum else ()

    _y0, p_t, p_phi, _inv = metric.initial_conditions_5d(
        float(r_obs), alphas, thetas, float(theta_obs))
    final_alpha, n_half, status_out = finalize_angles(
        metric, tuple(outs[:5]), p_t, p_phi, outs[5])
    from light_path_tracer_tpu.disk import DiskTraceResult
    return DiskTraceResult(status_out, outs[7], hit_r, p_phi, n_steps,
                           final_alpha, n_half, hit_phi,
                           pr_hits=hit_pr, pth_hits=hit_pth)
