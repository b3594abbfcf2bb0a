"""Image-tile data-parallel ray tracing over a device mesh.

BASELINE.json config 5's pattern: the pixel grid is sharded row-wise across
the mesh's `tiles` axis with `shard_map`; each device runs its *own*
lock-step `lax.while_loop` over its tile, so a tile whose rays all finish
early exits early — no global per-iteration sync, no collective in the hot
loop. The only communication is XLA's implicit output gather (NVLink
between the cards of one host).

Single-device results are bitwise identical to the sharded results (tested
in tests/test_sharding.py on a virtual 8-device CPU mesh).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from light_path_tracer_tpu.parallel.mesh import shard_map_fn
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr
from light_path_tracer_tpu.ops.schwarzschild_trace import (
    trace_rays_schwarzschild)


def _pad_rows(grid, rows_to):
    pad = rows_to - grid.shape[0]
    if pad == 0:
        return grid
    return jnp.concatenate(
        [grid, jnp.broadcast_to(grid[-1:], (pad,) + grid.shape[1:])], axis=0)


def _mesh_sync(mesh, outputs):
    """Serialize sharded dispatches on CPU meshes.

    XLA:CPU's in-process collectives (including shard_map's implicit
    output gather) have a hard 40 s rendezvous timeout and ABORT the
    process when it expires. On an oversubscribed host (1 core, 8
    virtual devices) an asynchronously dispatched sharded program can
    starve one participant thread while the main thread is busy tracing
    the NEXT program — observed as `InProcessCommunicator::AllReduce …
    only 7 of 8 arrived` killing the test suite. Blocking on the
    outputs before returning removes the overlap; GPU meshes keep full
    async dispatch.
    """
    if mesh.devices.flat[0].platform == "cpu":
        jax.block_until_ready(outputs)
    return outputs


def trace_grid_sharded(metric, r_obs, alpha_grid, theta_grid=None,
                       theta_obs=np.pi / 2, refine_grid=None, *,
                       mesh: Mesh, lambda_max=None, max_steps=200000,
                       phi_max=50.0, h_max=0.05, backend="auto",
                       layout="stripes"):
    """Trace an (H, W) pixel grid sharded row-wise over `mesh`.

    layout: "bands" gives each device a contiguous row band; "stripes"
    (default) interleaves rows (row i -> device i mod n), which
    equidistributes the expensive photon-ring rows across devices
    (docs/scaling.md) — valid because no computation couples rows.
    Returns (final_alpha, n_half_orbits, status) grids of shape (H, W).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev

    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    def place(grid):
        return _pad_rows(grid, H_pad)[perm]

    alpha_p = place(alpha_grid)
    shard_map = shard_map_fn()
    if metric.is_spherically_symmetric:
        def per_tile(a):
            res = trace_rays_schwarzschild(
                metric, float(r_obs), a.ravel(),
                phi_max=phi_max, h_max=h_max)
            return (res.final_alpha.reshape(a.shape),
                    res.n_half_orbits.reshape(a.shape),
                    res.status.reshape(a.shape))

        f = shard_map(per_tile, mesh=mesh, in_specs=(P(axis, None),),
                      out_specs=(P(axis, None), P(axis, None),
                                 P(axis, None)))
        fa, nh, st = jax.jit(f)(alpha_p)
    else:
        if lambda_max is None:
            lambda_max = max(5000.0, 6.0 * float(r_obs))
        if theta_grid is None:
            theta_grid = jnp.zeros_like(alpha_grid)
        if refine_grid is None:
            refine_grid = jnp.zeros(alpha_grid.shape, bool)
        theta_p = place(theta_grid)
        refine_p = place(refine_grid)

        from light_path_tracer_tpu.ops.batch import _kerr_backend
        resolved = _kerr_backend(backend, alpha_grid.dtype)
        if resolved == "pallas":
            from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
                trace_rays_kerr_pallas as kerr_fn)
        else:
            kerr_fn = trace_rays_kerr

        def per_tile(a, t, rf):
            res = kerr_fn(
                metric, float(r_obs), a.ravel(), t.ravel(),
                float(theta_obs), rf.ravel(), float(lambda_max), max_steps)
            return (res.final_alpha.reshape(a.shape),
                    res.n_half_orbits.reshape(a.shape),
                    res.status.reshape(a.shape))

        f = shard_map(per_tile, mesh=mesh,
                      in_specs=(P(axis, None), P(axis, None), P(axis, None)),
                      out_specs=(P(axis, None), P(axis, None),
                                 P(axis, None)))
        fa, nh, st = jax.jit(f)(alpha_p, theta_p, refine_p)

    return _mesh_sync(
        mesh, (fa[inv_perm][:H], nh[inv_perm][:H], st[inv_perm][:H]))


def trace_disk_grid_sharded(metric, r_obs, alpha_grid, theta_grid,
                            theta_obs, disk, *, mesh: Mesh,
                            lambda_max=None, max_steps=200000,
                            backend="auto", layout="stripes",
                            record_momentum=False):
    """Disk-mode trace of an (H, W) grid sharded row-wise over `mesh`.

    Same tile-DP pattern as trace_grid_sharded (each device runs its own
    lock-step loop over its rows; only the output gather communicates),
    with the disk-crossing recorder active. Returns a
    disk.DiskTraceResult whose array fields are (H, W) grids (r_hits /
    phi_hits stay per-slot tuples of grids; n_steps sums over devices).
    """
    from light_path_tracer_tpu.disk import trace_disk_rays, DiskTraceResult

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    def place(grid):
        return _pad_rows(grid, H_pad)[perm]

    alpha_p, theta_p = place(alpha_grid), place(theta_grid)
    shard_map = shard_map_fn()

    per_tile, out_specs = disk_per_tile(metric, r_obs, theta_obs,
                                        lambda_max, max_steps, disk,
                                        backend, axis,
                                        record_momentum=record_momentum)
    spec = P(axis, None)
    f = shard_map(per_tile, mesh=mesh, in_specs=(spec, spec),
                  out_specs=out_specs)
    res = jax.jit(f)(alpha_p, theta_p)

    def unplace(grid):
        return grid[inv_perm][:H]

    return _mesh_sync(mesh, DiskTraceResult(
        unplace(res.status), unplace(res.n_hits),
        tuple(unplace(r) for r in res.r_hits), unplace(res.xi),
        jnp.sum(res.n_steps), unplace(res.final_alpha),
        unplace(res.n_half), tuple(unplace(p) for p in res.phi_hits),
        tuple(unplace(x) for x in res.xi_hits),
        tuple(unplace(p) for p in res.pr_hits),
        tuple(unplace(p) for p in res.pth_hits)))


def disk_slots(disk) -> range:
    return range(disk.max_hits)


def disk_per_tile(metric, r_obs, theta_obs, lambda_max, max_steps, disk,
                  backend, axis, record_momentum=False):
    """(per_tile fn, shard_map out_specs) for disk-mode tile DP — the
    ONE definition of the DiskTraceResult tile pytree, shared by the
    single-host (trace_disk_grid_sharded) and multi-host
    (multihost.trace_disk_grid_multihost) paths so the 9-field
    construction cannot diverge. Tilted/warped disks also carry
    per-crossing angular momentum (xi_hits) — dropping it would
    silently compute the Doppler about the wrong axis downstream.
    record_momentum adds the per-crossing (p_r, p_theta) slots the
    polarized-disk path needs (polarization.render_polarization
    mesh=).
    """
    from light_path_tracer_tpu.disk import trace_disk_rays, DiskTraceResult

    tilted = disk.tilt != 0.0 or disk.warp_radius is not None
    n_xi = disk.max_hits if tilted else 0
    n_mom = disk.max_hits if record_momentum else 0

    def per_tile(a, t):
        res = trace_disk_rays(
            metric, float(r_obs), a.ravel(), t.ravel(), float(theta_obs),
            float(lambda_max), max_steps, disk, backend=backend,
            record_momentum=record_momentum)
        return DiskTraceResult(
            res.status.reshape(a.shape),
            res.n_hits.reshape(a.shape),
            tuple(r.reshape(a.shape) for r in res.r_hits),
            res.xi.reshape(a.shape),
            # Scalar per-device step count -> (1, 1) so the gather can
            # concatenate it along the tile axis; summed after. NOTE:
            # includes the padded duplicate rows' work when H is not
            # divisible by the device count — telemetry, not physics.
            jnp.reshape(res.n_steps, (1, 1)),
            res.final_alpha.reshape(a.shape),
            res.n_half.reshape(a.shape),
            tuple(p.reshape(a.shape) for p in res.phi_hits),
            tuple(x.reshape(a.shape) for x in res.xi_hits),
            tuple(p.reshape(a.shape) for p in res.pr_hits),
            tuple(p.reshape(a.shape) for p in res.pth_hits))

    spec = P(axis, None)
    out_specs = DiskTraceResult(
        spec, spec, (spec,) * disk.max_hits, spec, spec, spec, spec,
        (spec,) * disk.max_hits, (spec,) * n_xi,
        (spec,) * n_mom, (spec,) * n_mom)
    return per_tile, out_specs


def trace_volumetric_grid_sharded(metric, r_obs, alpha_grid, theta_grid,
                                  theta_obs, emission_fn, *, mesh: Mesh,
                                  lambda_max=None, max_steps=200000,
                                  precision="fast", method="dp45",
                                  layout="stripes", absorption_fn=None,
                                  sat_window=0):
    """Volumetric trace of an (H, W) grid sharded row-wise over `mesh`.

    Same tile-DP pattern as trace_grid_sharded: each device integrates
    its own rows' path integrals (ops/kerr_trace.trace_rays_volumetric
    with the error-controlled emission component); only the output
    gather communicates. emission_fn (and absorption_fn, for the
    self-absorbed transfer mode) must be the cached objects from
    volumetric.make_transfer_fns (they are static args of the per-tile
    jit). Returns a VolumetricResult of (H, W) grids; n_steps sums over
    devices (includes padded duplicate rows' work when H is not
    divisible by the device count — telemetry, not physics).
    """
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_volumetric
    from light_path_tracer_tpu.ops.types import VolumetricResult

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    def place(grid):
        return _pad_rows(grid, H_pad)[perm]

    alpha_p, theta_p = place(alpha_grid), place(theta_grid)
    shard_map = shard_map_fn()

    def per_tile(a, t):
        res = trace_rays_volumetric(
            metric, float(r_obs), a.ravel(), t.ravel(),
            float(theta_obs), emission_fn, float(lambda_max),
            max_steps, precision=precision, method=method,
            absorption_fn=absorption_fn, sat_window=sat_window)
        return VolumetricResult(
            res.emission.reshape(a.shape),
            res.final_alpha.reshape(a.shape),
            res.n_half_orbits.reshape(a.shape),
            res.status.reshape(a.shape),
            jnp.reshape(res.n_steps, (1, 1)),
            res.optical_depth.reshape(a.shape))

    spec = P(axis, None)
    f = shard_map(per_tile, mesh=mesh, in_specs=(spec, spec),
                  out_specs=VolumetricResult(spec, spec, spec, spec,
                                             spec, spec))
    res = jax.jit(f)(alpha_p, theta_p)

    def unplace(grid):
        return grid[inv_perm][:H]

    return _mesh_sync(mesh, VolumetricResult(
        unplace(res.emission), unplace(res.final_alpha),
        unplace(res.n_half_orbits), unplace(res.status),
        jnp.sum(res.n_steps), unplace(res.optical_depth)))


def trace_surface_grid_sharded(metric, r_obs, alpha_grid, theta_grid,
                               theta_obs, r_surface, *, mesh: Mesh,
                               lambda_max=None, max_steps=200000,
                               precision="fast", method="dp45",
                               layout="stripes", record_time=False):
    """Stellar-surface trace of an (H, W) grid sharded row-wise over
    `mesh` (star.py tile DP — same pattern as the volumetric path:
    each device Hermite-localizes its own rows onto the r = r_surface
    sphere; only the output gather communicates). Returns a
    SurfaceResult of (H, W) grids; n_steps sums over devices."""
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_surface
    from light_path_tracer_tpu.ops.types import SurfaceResult

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    def place(grid):
        return _pad_rows(grid, H_pad)[perm]

    alpha_p, theta_p = place(alpha_grid), place(theta_grid)
    shard_map = shard_map_fn()

    def per_tile(a, t):
        res = trace_rays_surface(
            metric, float(r_obs), a.ravel(), t.ravel(),
            float(theta_obs), float(r_surface), float(lambda_max),
            max_steps, precision=precision, method=method,
            record_time=record_time)
        return SurfaceResult(
            *(f.reshape(a.shape) for f in res[:9]),
            jnp.reshape(res.n_steps, (1, 1)))

    spec = P(axis, None)
    f = shard_map(per_tile, mesh=mesh, in_specs=(spec, spec),
                  out_specs=SurfaceResult(*([spec] * 10)))
    res = jax.jit(f)(alpha_p, theta_p)

    def unplace(grid):
        return grid[inv_perm][:H]

    return _mesh_sync(mesh, SurfaceResult(*(unplace(f) for f in res[:9]),
                                          jnp.sum(res.n_steps)))


def trace_spectral_grid_sharded(metric, r_obs, alpha_grid, theta_grid,
                                theta_obs, transfer_fn, n_bands, *,
                                mesh: Mesh, lambda_max=None,
                                max_steps=200000, precision="fast",
                                method="dp45", layout="stripes",
                                sat_window=0, sat_monitor=None):
    """Multi-frequency radiative-transfer trace of an (H, W) grid
    sharded row-wise over `mesh` (volumetric.render_volumetric_spectrum
    / _movie tile DP). Returns a SpectralResult of (H, W) grids."""
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_spectral
    from light_path_tracer_tpu.ops.types import SpectralResult

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    def place(grid):
        return _pad_rows(grid, H_pad)[perm]

    alpha_p, theta_p = place(alpha_grid), place(theta_grid)
    shard_map = shard_map_fn()

    def per_tile(a, t):
        res = trace_rays_spectral(
            metric, float(r_obs), a.ravel(), t.ravel(),
            float(theta_obs), transfer_fn, n_bands, float(lambda_max),
            max_steps, precision=precision, method=method,
            sat_window=sat_window, sat_monitor=sat_monitor)
        return SpectralResult(
            tuple(e.reshape(a.shape) for e in res.emission),
            res.tau_hat.reshape(a.shape),
            res.final_alpha.reshape(a.shape),
            res.n_half_orbits.reshape(a.shape),
            res.status.reshape(a.shape),
            jnp.reshape(res.n_steps, (1, 1)))

    spec = P(axis, None)
    f = shard_map(per_tile, mesh=mesh, in_specs=(spec, spec),
                  out_specs=SpectralResult(
                      tuple(spec for _ in range(n_bands)),
                      spec, spec, spec, spec, spec))
    res = jax.jit(f)(alpha_p, theta_p)

    def unplace(grid):
        return grid[inv_perm][:H]

    return _mesh_sync(mesh, SpectralResult(
        tuple(unplace(e) for e in res.emission),
        unplace(res.tau_hat), unplace(res.final_alpha),
        unplace(res.n_half_orbits), unplace(res.status),
        jnp.sum(res.n_steps)))


def trace_aux_grid_sharded(metric, r_obs, alpha_grid, theta_grid,
                           theta_obs, transfer_fn, n_extras,
                           aux_grids, *, mesh: Mesh, lambda_max=None,
                           max_steps=200000, precision="fast",
                           method="dp45", layout="stripes",
                           sat_window=0, sat_monitor=()):
    """Coupled-extras trace with per-ray aux constants, sharded
    row-wise over `mesh` (polarized volumetric tile DP:
    polarization.render_polarized_volumetric mesh path). aux_grids is
    a tuple of (H, W) arrays sharded like the camera grids. Returns an
    ExtrasResult of (H, W) grids."""
    from light_path_tracer_tpu.ops.kerr_trace import trace_rays_aux
    from light_path_tracer_tpu.ops.types import ExtrasResult

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    def place(grid):
        return _pad_rows(grid, H_pad)[perm]

    alpha_p, theta_p = place(alpha_grid), place(theta_grid)
    aux_p = tuple(place(g) for g in aux_grids)
    shard_map = shard_map_fn()

    def per_tile(a, t, aux):
        res = trace_rays_aux(
            metric, float(r_obs), a.ravel(), t.ravel(),
            float(theta_obs), transfer_fn, n_extras,
            tuple(g.ravel() for g in aux), float(lambda_max),
            max_steps, precision=precision, method=method,
            sat_window=sat_window, sat_monitor=sat_monitor)
        return ExtrasResult(
            tuple(e.reshape(a.shape) for e in res.extras),
            res.final_alpha.reshape(a.shape),
            res.n_half_orbits.reshape(a.shape),
            res.status.reshape(a.shape),
            jnp.reshape(res.n_steps, (1, 1)))

    spec = P(axis, None)
    f = shard_map(per_tile, mesh=mesh,
                  in_specs=(spec, spec,
                            tuple(spec for _ in aux_grids)),
                  out_specs=ExtrasResult(
                      tuple(spec for _ in range(n_extras)),
                      spec, spec, spec, spec))
    res = jax.jit(f)(alpha_p, theta_p, aux_p)

    def unplace(grid):
        return grid[inv_perm][:H]

    return _mesh_sync(mesh, ExtrasResult(
        tuple(unplace(e) for e in res.extras),
        unplace(res.final_alpha), unplace(res.n_half_orbits),
        unplace(res.status), jnp.sum(res.n_steps)))
