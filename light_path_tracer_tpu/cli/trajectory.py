"""`ray` / `plot` / `orbit` subcommands: single-geodesic demos,
trajectory overlays, timelike orbits."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from light_path_tracer_tpu.cli._shared import (
    _add_scene_args, _scene_from)


def cmd_ray(args) -> int:
    """Single-ray demo (main.py parity): trace, report, plot."""
    from light_path_tracer_tpu.trajectory import trace_ray_trajectory

    metric = _scene_from(args).metric()
    r_obs = args.r_obs * args.M
    alpha = np.radians(args.alpha_deg)
    traj, outcome = trace_ray_trajectory(metric, r_obs, alpha)
    b = metric.viewing_angle_to_impact_parameter(alpha, r_obs)
    print(f"Metric:             {type(metric).__name__}")
    print(f"Observer radius:    r_obs = {r_obs} M")
    print(f"Viewing angle:      alpha = {args.alpha_deg} deg")
    print(f"Impact parameter:   b = {b:.4f} M")
    print(f"Outcome:            {outcome.upper()}")

    if not args.no_plot and traj is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        n = int(traj.n_valid)
        r = np.asarray(traj.states[:n, 1])
        phi = np.asarray(traj.states[:n, 3])
        fig, ax = plt.subplots(figsize=(10, 10))
        circle = np.linspace(0, 2 * np.pi, 200)
        rh = metric.capture_radius()
        ax.fill(rh * np.cos(circle), rh * np.sin(circle), "k",
                label="Event horizon")
        if hasattr(metric, "R_PHOTON"):
            ax.plot(metric.R_PHOTON * np.cos(circle),
                    metric.R_PHOTON * np.sin(circle), "r--",
                    label="Photon sphere")
        color = "steelblue" if outcome == "escaped" else "crimson"
        ax.plot(r * np.cos(phi), r * np.sin(phi), color=color,
                linewidth=2, label=f"Photon path ({outcome})")
        ax.plot(r_obs, 0, "go", markersize=12, label="Observer")
        ax.set_aspect("equal")
        ax.legend(loc="upper left")
        ax.grid(True, alpha=0.3)
        plt.savefig(args.output, dpi=150)
        print(f"Saved: {args.output}")
    return 0

def cmd_plot(args) -> int:
    """Multi-angle trajectory overlay (geodesic_tracer.__main__ parity)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from light_path_tracer_tpu.trajectory import plot_trajectories

    metric = _scene_from(args).metric()
    r_obs = args.r_obs * args.M
    angles = [float(x) for x in args.angles.split(",")]
    ac = np.degrees(metric.alpha_crit(r_obs))
    print(f"Metric: {type(metric).__name__}; critical angle "
          f"{ac:.4f} deg")
    for alpha_deg in angles:
        alpha = np.radians(alpha_deg)
        b = metric.viewing_angle_to_impact_parameter(alpha, r_obs)
        fa, nh, outcome = metric.trace_ray(r_obs, alpha)
        print(f"  alpha = {alpha_deg:6.2f} deg -> b = {b:6.3f} M -> "
              f"{outcome.upper()}")
    fig, ax = plt.subplots(figsize=(12, 10))
    plot_trajectories(metric, r_obs, angles, ax=ax)
    plt.tight_layout()
    plt.savefig(args.output, dpi=150, bbox_inches="tight")
    print(f"Saved: {args.output}")
    return 0

def cmd_orbit(args) -> int:
    """Timelike bound orbit: integrate, report precession, plot rosette.

    Beyond-reference mode (the reference traces photons only) on the same
    8-D Hamiltonian recorder the `ray`/`plot` commands use.
    """
    import jax.numpy as jnp
    from light_path_tracer_tpu.models import make_metric
    from light_path_tracer_tpu import particles as pt

    if args.eps3:
        print("error: orbit integrals (BPT circular-orbit forms) are not "
              "derived for the Johannsen-Psaltis family; use --a/--Q "
              "metrics", file=sys.stderr)
        return 2
    metric = make_metric(args.M, args.a, args.Q, 0.0)
    prograde = not args.retrograde
    if args.r is not None:
        r0 = args.r * args.M
        E, L, omega = pt.circular_orbit(metric, r0, prograde)
        print(f"Circular orbit at r = {r0} M: E = {E:.9f}, L = {L:.6f}, "
              f"Omega = {omega:.8f} (period {2 * np.pi / abs(omega):.2f} M)")
    else:
        r_p, r_a = args.peri * args.M, args.apo * args.M
        E, L = pt.orbit_from_apsides(metric, r_p, r_a, prograde=prograde)
        r0 = r_p
        print(f"Bound orbit r_peri = {r_p} M, r_apo = {r_a} M: "
              f"E = {E:.9f}, L = {L:.6f}")

    inc = np.radians(args.inclination)
    state8, invalid = pt.timelike_initial_conditions(
        metric, jnp.asarray(r0, jnp.float64), E, L * np.cos(inc),
        p_theta=L * np.sin(inc))
    if bool(np.asarray(invalid)):
        print("error: requested start point is classically forbidden",
              file=sys.stderr)
        return 2
    traj = pt.integrate_orbit(metric, state8, n_steps=args.steps)
    n = int(np.asarray(traj.n_valid))
    states = np.asarray(traj.states[:n], np.float64)
    if int(np.asarray(traj.outcome)) == -1:
        print(f"Orbit PLUNGED through the horizon after "
              f"{states[-1, 0]:.1f} M of coordinate time "
              f"({n} accepted steps)")
    else:
        r_all = states[:, 1]
        # A (near-)circular orbit has no periapsis: numerical micro-
        # extrema would otherwise masquerade as precession.
        if np.ptp(r_all) > 1e-3 * np.mean(r_all):
            try:
                adv = pt.periapsis_precession(traj)
                pred = pt.weak_field_periapsis_advance(
                    args.M, args.a, float(np.min(r_all)),
                    float(np.max(r_all)), prograde=prograde)
                print(f"Periapsis advance per orbit: "
                      f"{np.degrees(np.mean(adv)):.4f} deg measured over "
                      f"{len(adv)} passages (leading-order GR: "
                      f"{np.degrees(pred):.4f} deg)")
            except ValueError:
                pass
        if inc != 0.0:
            try:
                drift, _ = pt.nodal_precession(traj)
                print(f"Ascending-node drift per orbit (Lense-Thirring): "
                      f"{np.degrees(np.mean(drift)):.4f} deg over "
                      f"{len(drift)} nodes")
            except ValueError:
                pass
        res = np.asarray(pt.hamiltonian(metric, jnp.asarray(states)))
        print(f"Hamiltonian residual |H + 1/2| <= "
              f"{np.max(np.abs(res + 0.5)):.2e} over {n} steps")

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        r, th, phi = states[:, 1], states[:, 2], states[:, 3]
        x = r * np.sin(th) * np.cos(phi)
        y = r * np.sin(th) * np.sin(phi)
        panels = 2 if inc != 0.0 else 1
        fig, axes = plt.subplots(1, panels,
                                 figsize=(7 * panels, 7), squeeze=False)
        ax = axes[0, 0]
        circle = np.linspace(0, 2 * np.pi, 200)
        rh = metric.capture_radius()
        ax.fill(rh * np.cos(circle), rh * np.sin(circle), "k",
                label="Event horizon")
        ax.plot(x, y, lw=0.8, color="steelblue", label="orbit")
        ax.plot(x[0], y[0], "go", label="start")
        ax.set_aspect("equal")
        ax.legend(loc="upper left")
        ax.grid(True, alpha=0.3)
        ax.set_title(f"{type(metric).__name__} timelike orbit "
                     f"(E={E:.4f}, L={L:.3f})")
        if inc != 0.0:
            ax2 = axes[0, 1]
            ax2.plot(states[:, 0], r * np.cos(th), lw=0.8)
            ax2.set_xlabel("coordinate time t [M]")
            ax2.set_ylabel("z = r cos(theta) [M]")
            ax2.set_title("vertical oscillation (nodal drift)")
            ax2.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(args.output, dpi=150)
        print(f"Saved: {args.output}")
    return 0


def register_ray(sub):
    p = sub.add_parser("ray", help="single-ray trace + trajectory plot")
    _add_scene_args(p)
    p.add_argument("--alpha-deg", type=float, default=8.0)
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--output", default="example_geodesic.png")
    p.set_defaults(fn=cmd_ray)


def register_plot(sub):
    p = sub.add_parser("plot", help="multi-angle trajectory overlay")
    _add_scene_args(p)
    p.add_argument("--angles", default="0,2,4,5,5.5,5.97,6.5,8,10,15")
    p.add_argument("--output", default="geodesic_trajectories.png")
    p.set_defaults(fn=cmd_plot)


def register_orbit(sub):
    p = sub.add_parser(
        "orbit", help="timelike (massive-particle) bound orbit: rosette "
                      "plot + measured periapsis/nodal precession")
    p.add_argument("--M", type=float, default=1.0, help="BH mass")
    p.add_argument("--a", type=float, default=0.0, help="BH spin")
    p.add_argument("--Q", type=float, default=0.0, help="BH charge")
    p.add_argument("--eps3", type=float, default=0.0,
                   help=argparse.SUPPRESS)  # rejected with a clear error
    p.add_argument("--r", type=float, default=None,
                   help="circular-orbit radius in units of M (overrides "
                        "--peri/--apo)")
    p.add_argument("--peri", type=float, default=8.0,
                   help="periapsis radius in units of M")
    p.add_argument("--apo", type=float, default=16.0,
                   help="apoapsis radius in units of M")
    p.add_argument("--retrograde", action="store_true",
                   help="orbit against the BH spin")
    p.add_argument("--inclination", type=float, default=0.0,
                   help="orbital inclination in deg (tilts L out of the "
                        "equator; nonzero shows Lense-Thirring node drag)")
    p.add_argument("--steps", type=int, default=6000,
                   help="adaptive-step budget (more steps = more orbits)")
    p.add_argument("--device", default="default",
                   choices=["default", "cpu", "cuda"])
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--output", default="orbit.png")
    # Precession accumulates phase over many orbits: always integrate in
    # f64 (main() enables x64 from this default).
    p.set_defaults(fn=cmd_orbit, dtype="float64")
