"""Multi-host (multi-process) image-tile data parallelism.

Completes SURVEY.md §5's distributed-backend item: the reference's only
cross-worker mechanism is a single-host ProcessPoolExecutor row farm
(/root/reference/debugging_image_lense.py:530-592). The equivalent here
is `jax.distributed` + a global mesh over every GPU of every host:

  * within a host: the pixel grid is sharded row-wise exactly as the
    single-host path (parallel/tiles.py) — each card integrates its own
    rows in its own trace, no collective in the hot loop.
  * across hosts: only two things ever cross the network — the
    jax.distributed control plane at startup, and the final image
    gather (`process_allgather`), a few MB once per render. Ray tracing
    is embarrassingly parallel, so the network assumption is simply
    "reachable"; no bandwidth-critical collective exists.

One process per GPU: a JAX process reserves most of a card's memory when
it starts, so each worker process gets its own card
(CUDA_VISIBLE_DEVICES=<i>, or local_device_ids=[i]).

Tested without real hardware the standard way: two CPU processes x 4
virtual devices each, gloo collectives (tests/test_multihost.py), with
the result matching the single-process sharded render exactly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from light_path_tracer_tpu.parallel.mesh import shard_map_fn


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None,
                         timeout_s: float | None = None,
                         heartbeat_timeout_s: float | None = None):
    """Join (or start, for process 0) the jax.distributed control plane.

    Must run before any other JAX call in the process. Pass
    coordinator_address ("host:port"), num_processes and process_id
    explicitly: nothing on a plain GPU host tells JAX of a cluster.
    Idempotent: repeated calls are ignored.

    timeout_s bounds the wait for the full cluster to join (default:
    jax's own 300 s); a missing peer then fails HERE with a clear
    RuntimeError instead of hanging into the first collective.

    heartbeat_timeout_s bounds DETECTION OF A PEER DYING MID-RENDER
    (jax.distributed's heartbeat_timeout_seconds, default 100 s): a
    survivor blocked in a cross-process collective (the final image
    allgather — the hot loop itself is collective-free, so a render in
    flight runs its local shards to completion first) errors out with
    a clear distributed-runtime error within ~this window instead of
    hanging. CLI: --heartbeat-timeout. Pinned by
    tests/test_multihost.py::test_peer_death_mid_render_fails_survivor
    (2-process cluster, one killed between renders). docs/scaling.md
    "Multi-host failure behavior".
    """
    kwargs = {}
    if timeout_s is not None:
        kwargs["initialization_timeout"] = int(timeout_s)
    if heartbeat_timeout_s is not None:
        kwargs["heartbeat_timeout_seconds"] = int(heartbeat_timeout_s)
    try:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids, **kwargs)
        except TypeError:
            # Older jax without heartbeat_timeout_seconds: the knob
            # degrades to jax's built-in default rather than failing.
            kwargs.pop("heartbeat_timeout_seconds", None)
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids, **kwargs)
    except RuntimeError as exc:   # already initialized
        if "already" not in str(exc).lower():
            raise TimeoutError(
                f"jax.distributed initialization failed "
                f"(coordinator={coordinator_address!r}, "
                f"num_processes={num_processes}, "
                f"process_id={process_id}): {exc}. Check that every "
                f"process started with the same --coordinator and a "
                f"distinct --process-id, and that the coordinator port "
                f"is reachable.") from exc


def make_global_mesh(axis_name: str = "tiles") -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def trace_grid_multihost(metric, r_obs, alpha_grid, theta_grid=None,
                         theta_obs=np.pi / 2, refine_grid=None, *,
                         mesh: Mesh | None = None, lambda_max=None,
                         max_steps=200000, phi_max=50.0, h_max=0.05,
                         backend="auto", layout="stripes"):
    """Trace an (H, W) grid sharded over a *global* (multi-process) mesh.

    Every process passes the SAME full-grid numpy arrays (the camera
    grids are deterministic from the scene config, so each host builds
    them locally — nothing is scattered). Each process's devices
    integrate only their own rows; the assembled (H, W) results are
    returned as numpy arrays, identical on every process.

    Single-process with a local mesh degrades to exactly the
    parallel/tiles.py behavior.
    """
    if mesh is None:
        mesh = make_global_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    shard_map = shard_map_fn()

    alpha_grid = np.asarray(alpha_grid)
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev

    # Row permutation host-side in numpy (a gather on a multi-host global
    # array outside jit would not be addressable).
    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)

    sharding = NamedSharding(mesh, P(axis, None))

    def place(grid, dtype):
        g = np.asarray(grid, dtype)
        if H_pad > H:
            g = np.concatenate(
                [g, np.broadcast_to(g[-1:], (H_pad - H,) + g.shape[1:])])
        g = g[perm]
        return jax.make_array_from_callback(
            g.shape, sharding, lambda idx: g[idx])

    alpha_p = place(alpha_grid, alpha_grid.dtype)

    if metric.is_spherically_symmetric:
        from light_path_tracer_tpu.ops.schwarzschild_trace import (
            trace_rays_schwarzschild)

        def per_tile(a):
            res = trace_rays_schwarzschild(
                metric, float(r_obs), a.ravel(),
                phi_max=phi_max, h_max=h_max)
            return (res.final_alpha.reshape(a.shape),
                    res.n_half_orbits.reshape(a.shape),
                    res.status.reshape(a.shape))

        f = shard_map(per_tile, mesh=mesh, in_specs=(P(axis, None),),
                      out_specs=(P(axis, None),) * 3)
        fa, nh, st = jax.jit(f)(alpha_p)
    else:
        from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr
        if lambda_max is None:
            lambda_max = max(5000.0, 6.0 * float(r_obs))
        if theta_grid is None:
            theta_grid = np.zeros_like(alpha_grid)
        if refine_grid is None:
            refine_grid = np.zeros(alpha_grid.shape, bool)
        theta_p = place(theta_grid, alpha_grid.dtype)
        refine_p = place(refine_grid, bool)

        from light_path_tracer_tpu.ops.batch import _kerr_backend
        resolved = _kerr_backend(backend, jnp.dtype(alpha_grid.dtype))
        if resolved == "pallas":
            from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel import (
                trace_rays_kerr_pallas as kerr_fn)
        else:
            kerr_fn = trace_rays_kerr

        def per_tile(a, t, rf):
            res = kerr_fn(
                metric, float(r_obs), a.ravel(), t.ravel(),
                float(theta_obs), rf.ravel(), float(lambda_max),
                max_steps)
            return (res.final_alpha.reshape(a.shape),
                    res.n_half_orbits.reshape(a.shape),
                    res.status.reshape(a.shape))

        f = shard_map(per_tile, mesh=mesh,
                      in_specs=(P(axis, None),) * 3,
                      out_specs=(P(axis, None),) * 3)
        fa, nh, st = jax.jit(f)(alpha_p, theta_p, refine_p)

    if jax.process_count() > 1:
        # Final image gather: the only cross-host data movement.
        from jax.experimental import multihost_utils
        fa, nh, st = (np.asarray(multihost_utils.process_allgather(
            x, tiled=True)) for x in (fa, nh, st))
    else:
        fa, nh, st = (np.asarray(x) for x in (fa, nh, st))

    return fa[inv_perm][:H], nh[inv_perm][:H], st[inv_perm][:H]


def trace_disk_grid_multihost(metric, r_obs, alpha_grid, theta_grid,
                              theta_obs, disk, *, mesh: Mesh | None = None,
                              lambda_max=None, max_steps=200000,
                              backend="auto", layout="stripes"):
    """Disk-mode trace over a global (multi-process) mesh.

    Same recipe as trace_grid_multihost (every host builds the full
    camera grids locally, devices integrate their own rows, one final
    allgather) with the disk-crossing recorder active. Returns a
    disk.DiskTraceResult of host numpy arrays — (H, W) grids, identical
    on every process; n_steps sums over devices.
    """
    from light_path_tracer_tpu.disk import trace_disk_rays, DiskTraceResult

    if mesh is None:
        mesh = make_global_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    shard_map = shard_map_fn()
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    alpha_grid = np.asarray(alpha_grid)
    H, W = alpha_grid.shape
    H_pad = ((H + n_dev - 1) // n_dev) * n_dev
    if layout == "stripes":
        perm = np.argsort(np.arange(H_pad) % n_dev, kind="stable")
    else:
        perm = np.arange(H_pad)
    inv_perm = np.argsort(perm)
    sharding = NamedSharding(mesh, P(axis, None))

    def place(grid, dtype):
        g = np.asarray(grid, dtype)
        if H_pad > H:
            g = np.concatenate(
                [g, np.broadcast_to(g[-1:], (H_pad - H,) + g.shape[1:])])
        g = g[perm]
        return jax.make_array_from_callback(
            g.shape, sharding, lambda idx: g[idx])

    alpha_p = place(alpha_grid, alpha_grid.dtype)
    theta_p = place(theta_grid, alpha_grid.dtype)

    from light_path_tracer_tpu.parallel.tiles import disk_per_tile
    per_tile, out_specs = disk_per_tile(metric, r_obs, theta_obs,
                                        lambda_max, max_steps, disk,
                                        backend, axis)
    spec = P(axis, None)
    f = shard_map(per_tile, mesh=mesh, in_specs=(spec, spec),
                  out_specs=out_specs)
    res = jax.jit(f)(alpha_p, theta_p)

    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        gather = lambda x: np.asarray(
            multihost_utils.process_allgather(x, tiled=True))
    else:
        gather = np.asarray

    def unplace(grid):
        return gather(grid)[inv_perm][:H]

    return DiskTraceResult(
        unplace(res.status), unplace(res.n_hits),
        tuple(unplace(r) for r in res.r_hits), unplace(res.xi),
        int(np.sum(gather(res.n_steps))), unplace(res.final_alpha),
        unplace(res.n_half), tuple(unplace(p) for p in res.phi_hits),
        tuple(unplace(x) for x in res.xi_hits),
        tuple(unplace(p) for p in res.pr_hits),
        tuple(unplace(p) for p in res.pth_hits))
