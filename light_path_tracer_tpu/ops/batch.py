"""Chunked + difficulty-sorted batch tracing driver.

The reference bounds memory with 50k-ray chunks (image_lens.py:168-174,
251-258). Here chunking serves a different purpose: the lock-step
`lax.while_loop` in ops/kerr_trace.py runs every lane until the *slowest*
lane in the batch finishes, so we (a) split the batch into chunks to bound
each chunk's straggler blast radius, and (b) optionally sort rays by
expected difficulty (|alpha - alpha_crit|: photon-ring grazers integrate
longest, metrics.py:452's 200k-step bound exists for them) so stragglers
share chunks instead of stalling every chunk: a whole-batch form of
active-ray compaction.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from light_path_tracer_tpu.ops.types import TraceResult
from light_path_tracer_tpu.ops.schwarzschild_trace import (
    trace_rays_schwarzschild)
from light_path_tracer_tpu.ops.kerr_trace import trace_rays_kerr


def _pad_to(x, n, fill):
    pad = n - x.shape[0]
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])


def _kerr_backend(backend, dtype, metric=None):
    """Resolve 'auto' to the fused Pallas kernel on GPU float32.

    A metric can opt out of the kernel by setting supports_pallas = False
    (of the shipped families only CustomMetric does — its RHS is jax.grad
    of an arbitrary user callable); such metrics resolve to XLA and reject
    an explicit backend='pallas'."""
    if metric is not None and not getattr(metric, "supports_pallas",
                                          True):
        if backend == "pallas":
            raise ValueError(
                f"{type(metric).__name__} has no Pallas kernel "
                f"(autodiff RHS); use backend='xla' or 'auto'")
        return "xla"
    if backend != "auto":
        return backend
    import jax
    on_gpu = jax.default_backend() == "gpu"
    return "pallas" if (on_gpu and dtype == jnp.float32) else "xla"


def trace_batch(metric, r_obs, alphas, thetas=None, theta_obs=np.pi / 2,
                axis_refine=None, *, chunk_size=None, sort_by_difficulty=True,
                lambda_max=None, max_steps=200000, phi_max=50.0, h_max=0.05,
                backend="auto", integrator="dp45", event_interp="hermite",
                formulation="theta", precision="fast", progress=False,
                chunk_store=None):
    """Trace N rays through `metric`; returns TraceResult of shape (N,).

    Dispatches to the spherically-symmetric orbit tracer or the Kerr DP45
    tracer (the reference's trace_rays_batch split, metrics.py:831/1128).
    backend: 'auto' | 'xla' | 'pallas' — 'auto' picks the fused Pallas
    kernel on GPU float32, the pure-XLA path elsewhere.
    chunk_store: optional checkpoint.ChunkStore — persists each completed
    chunk of the chunked path so an interrupted precompute resumes.
    """
    n = int(alphas.shape[0])
    if n == 0:
        return TraceResult(
            jnp.zeros((0,), alphas.dtype), jnp.zeros((0,), jnp.int32),
            jnp.zeros((0,), jnp.int32), jnp.asarray(0, jnp.int32))

    if metric.is_spherically_symmetric:
        return trace_rays_schwarzschild(
            metric, float(r_obs), alphas, phi_max=phi_max, h_max=h_max)

    if thetas is None:
        thetas = jnp.zeros_like(alphas)
    if axis_refine is None:
        axis_refine = jnp.zeros(alphas.shape, bool)
    if lambda_max is None:
        lambda_max = max(5000.0, 6.0 * float(r_obs))

    if integrator == "rk4":
        from light_path_tracer_tpu.ops.kerr_rk4 import trace_rays_kerr_rk4
        kerr_fn = trace_rays_kerr_rk4
        kerr_kwargs = {}
    else:
        if integrator not in ("dp45", "dop853"):
            raise ValueError(f"unknown integrator {integrator!r}")
        resolved = _kerr_backend(backend, alphas.dtype, metric)
        kerr_kwargs = dict(event_interp=event_interp, precision=precision,
                           method=integrator)
        if formulation == "mu":
            # mu-form bulk + theta-form pole retrace, one jitted XLA
            # program (see trace_rays_kerr_hybrid).
            from light_path_tracer_tpu.ops.kerr_trace import (
                trace_rays_kerr_hybrid)
            kerr_fn = trace_rays_kerr_hybrid
        elif resolved == "pallas":
            from light_path_tracer_tpu.ops.pallas.kerr_trace_kernel \
                import trace_rays_kerr_pallas
            kerr_fn = trace_rays_kerr_pallas
        else:
            kerr_fn = trace_rays_kerr
            kerr_kwargs["formulation"] = formulation

    if chunk_size is None or chunk_size >= n:
        # No difficulty sort on the whole-grid path: the raster order of
        # a real image grid is already spatially difficulty-coherent.
        # Sorting stays on for the chunked path, where chunk boundaries
        # amplify its value.
        return kerr_fn(
            metric, float(r_obs), alphas, thetas, float(theta_obs),
            axis_refine, float(lambda_max), max_steps, **kerr_kwargs)

    if sort_by_difficulty:
        alpha_crit = metric.alpha_crit(float(r_obs), float(theta_obs))
        order = jnp.argsort(jnp.abs(alphas - alpha_crit))
        inv_order = jnp.argsort(order)
        a_s = alphas[order]
        t_s = thetas[order]
        ar_s = axis_refine[order]
    else:
        # No identity argsort/gather round-trips: at AA scale (16.6M
        # rays) they are pure overhead.
        inv_order = None
        a_s, t_s, ar_s = alphas, thetas, axis_refine

    n_pad = ((n + chunk_size - 1) // chunk_size) * chunk_size
    # Pad with easy far-field rays so padding lanes finish immediately.
    a_s = _pad_to(a_s, n_pad, np.pi / 2)
    t_s = _pad_to(t_s, n_pad, 0.0)
    ar_s = _pad_to(ar_s, n_pad, False)

    # Chunk progress: tqdm (progress=True) as the reference's precompute
    # loops show (image_lens.py:169-170, 252-253), or the legacy
    # harness's live ANSI bar with CPU/RSS telemetry (progress="live",
    # debugging_image_lense.py:175-229 parity).
    from light_path_tracer_tpu.utils.progress import chunk_iterator
    starts = chunk_iterator(range(0, n_pad, chunk_size), progress)

    fas, nhs, sts = [], [], []
    total_steps = jnp.asarray(0, jnp.int32)
    for start in starts:
        cached = chunk_store.get(start) if chunk_store is not None else None
        if cached is not None:
            res = cached
        else:
            res = kerr_fn(
                metric, float(r_obs),
                a_s[start:start + chunk_size],
                t_s[start:start + chunk_size],
                float(theta_obs), ar_s[start:start + chunk_size],
                float(lambda_max), max_steps, **kerr_kwargs)
            if chunk_store is not None:
                chunk_store.put(start, res)
        fas.append(res.final_alpha)
        nhs.append(res.n_half_orbits)
        sts.append(res.status)
        # Keep the step counter on device: forcing a host scalar here
        # would serialize every chunk on a device round-trip.
        total_steps = total_steps + res.n_steps

    fa = jnp.concatenate(fas)[:n]
    nh = jnp.concatenate(nhs)[:n]
    st = jnp.concatenate(sts)[:n]
    if inv_order is not None:
        fa, nh, st = fa[inv_order], nh[inv_order], st[inv_order]
    return TraceResult(fa, nh, st, total_steps)
