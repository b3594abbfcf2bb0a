"""Metric base protocol.

Parity surface: the reference `Metric` ABC (/root/reference/metrics.py:682-728)
exposes `geodesic_equations`, `initial_conditions`, `trace_ray`, `alpha_crit`,
`capture_radius`, `viewing_angle_to_impact_parameter` and the
`is_spherically_symmetric` class flag.

Design differences from the reference:
  * Metrics are small frozen dataclasses of Python floats — hashable, so they
    can close over jitted programs as static configuration. Scalar, config-time
    math (`alpha_crit`, impact parameters, horizon radii) runs host-side in
    float64 NumPy; only the per-ray hot paths are jnp.
  * The hot-path surface is *batched by construction*: `initial_conditions`
    and `rhs` take/return structure-of-arrays jnp values over N rays, instead
    of the reference's scalar-per-ray Numba kernels.
  * Public 8-D state convention matches the reference
    ([t, r, theta, phi, p_t, p_r, p_theta, p_phi], metrics.py:7-9); internal
    Kerr integrators use the reduced 5-D state with conserved (p_t, p_phi).
"""

from __future__ import annotations

import abc
import dataclasses


@dataclasses.dataclass(frozen=True)
class Metric(abc.ABC):
    """Base class for spacetime metrics (geometric units, G = c = 1)."""

    is_spherically_symmetric: bool = dataclasses.field(
        default=False, init=False, repr=False)

    @abc.abstractmethod
    def capture_radius(self) -> float:
        """Inner stopping radius for integration (host-side scalar)."""

    @abc.abstractmethod
    def alpha_crit(self, r_obs, theta_obs=None) -> float:
        """Critical viewing angle in radians (host-side scalar)."""

    @abc.abstractmethod
    def viewing_angle_to_impact_parameter(self, alpha, r_obs,
                                          theta_obs=None) -> float:
        """Convert viewing angle to impact parameter (host-side scalar)."""

    @abc.abstractmethod
    def geodesic_equations(self, lam, state8):
        """RHS of Hamilton's equations on the public 8-D state.

        Batched: `state8` is (..., 8); returns (..., 8). Used by the
        trajectory recorder and conservation tests (the analogue of the
        reference scipy path, metrics.py:763-790 / 946-1029).
        """

    @abc.abstractmethod
    def initial_conditions_8d(self, r_obs, alpha, theta=0.0, theta_obs=None):
        """Batched initial 8-D state for photons at viewing angle alpha."""

    # ---- single-ray convenience API (reference trace_ray parity) ----

    def trace_ray(self, r_obs, alpha, theta=0.0, theta_obs=None,
                  phi_max=50.0, axis_refine=False, dtype=None):
        """Trace one ray; returns (final_alpha, n_half_orbits, outcome).

        outcome is 'escaped' | 'captured' | 'invalid' — the reference's
        scalar API (metrics.py:705-713, 817-829, 1113-1126). This is a
        convenience wrapper over the batched tracers; production rendering
        always uses the batch path.
        """
        import math
        import jax
        import jax.numpy as jnp
        from light_path_tracer_tpu.ops.batch import trace_batch

        if theta_obs is None:
            theta_obs = math.pi / 2
        if dtype is None:
            dtype = (jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
        res = trace_batch(
            self, r_obs, jnp.asarray([alpha], dtype),
            jnp.asarray([theta], dtype), theta_obs,
            jnp.asarray([axis_refine], bool), phi_max=phi_max)
        status = int(res.status[0])
        outcome = {1: "escaped", -1: "captured", 0: "invalid"}[status]
        return (float(res.final_alpha[0]), int(res.n_half_orbits[0]),
                outcome)
