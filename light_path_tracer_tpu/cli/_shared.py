"""Shared CLI plumbing: flag groups, scene/config construction,
multihost helpers, report figures (split out of the former monolithic
cli.py in round 4 — one module per subcommand, no behavior change)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

def _add_scene_args(p):
    p.add_argument("--M", type=float, default=1.0, help="BH mass")
    p.add_argument("--a", type=float, default=0.0,
                   help="BH spin (|a| <= M, 0 = Schwarzschild)")
    p.add_argument("--Q", type=float, default=0.0,
                   help="BH charge (Reissner-Nordstrom; with --a != 0: "
                        "Kerr-Newman, needs a^2 + Q^2 <= M^2)")
    p.add_argument("--eps3", type=float, default=0.0,
                   help="Johannsen-Psaltis deformation parameter "
                        "(test-GR deformed Kerr; 0 = GR. Shadow/lens/"
                        "magnification modes; mutually exclusive with "
                        "--Q, not wired for disk orbital dynamics)")
    p.add_argument("--metric-py", default=None, metavar="FILE.py:ATTR",
                   help="user-defined spacetime: load a covariant-"
                        "components function (r, th) -> (g_tt, g_tphi, "
                        "g_rr, g_thth, g_phiphi) written in jax.numpy "
                        "from a local Python file (models.custom."
                        "CustomMetric; --M/--a declare the asymptotic "
                        "Kerr the far field approaches). Shadow/lens/"
                        "magnification/AA/ray/plot modes; mutually "
                        "exclusive with --Q/--eps3")
    p.add_argument("--r-obs", type=float, default=100.0,
                   help="Observer distance in units of M (default: 100)")
    p.add_argument("--psi-y", type=float, default=0.0,
                   help="BH vertical offset in deg (+ = top, - = bottom)")
    p.add_argument("--psi-x", type=float, default=0.0,
                   help="BH horizontal offset in deg (+ = right, - = left)")
    p.add_argument("--fov-v", type=float, default=40.0,
                   help="Vertical field of view in deg")
    p.add_argument("--theta-obs", type=float, default=90.0,
                   help="Observer inclination from the spin axis in deg "
                        "(default: 90 = equatorial)")
    p.add_argument("--boost", type=float, nargs=3, default=(0.0, 0.0, 0.0),
                   metavar=("BX", "BY", "BZ"),
                   help="camera 3-velocity in units of c (camera coords: "
                        "+x right, +y down, +z toward the BH); aberrates "
                        "the view and Doppler-shifts the disk")


def _add_render_args(p):
    p.add_argument("--device", default="default",
                   choices=["default", "cpu", "cuda"],
                   help="force the JAX platform (default: whatever the "
                        "environment provides). 'cpu' never touches an "
                        "accelerator; 'cuda' requires a GPU")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--chunk-size", type=int, default=0,
                   help="rays per chunk (0 = whole grid in one dispatch)")
    p.add_argument("--progress", default="off",
                   choices=["off", "bar", "live"],
                   help="chunked-trace progress: tqdm bar or the live "
                        "ANSI bar with CPU/RSS telemetry (needs "
                        "--chunk-size)")
    p.add_argument("--no-symmetry", action="store_true",
                   help="disable top/bottom mirror symmetry")
    p.add_argument("--loop-around", action="store_true",
                   help="wrap out-of-FOV source samples (legacy mode)")
    p.add_argument("--cache", action="store_true",
                   help="cache traced lookup tables in lookup_cache/")
    p.add_argument("--precision", default="fast",
                   choices=["fast", "precise", "gate"],
                   help="tolerance tier: fast (throughput), precise, or "
                        "gate (accuracy tier; with --bilinear it passes "
                        "the image-RMSE<1e-3 acceptance gate in f32)")
    p.add_argument("--integrator", default="dp45",
                   choices=["dp45", "dop853", "rk4"],
                   help="Kerr integrator (dp45 = reference-parity "
                        "adaptive default)")
    p.add_argument("--max-steps", type=int, default=200000,
                   help="adaptive-step budget per ray (reference "
                        "parity 200000; lower it for metrics whose "
                        "trapped rays never cross a capture sphere, "
                        "e.g. the Majumdar-Papapetrou binary example)")
    p.add_argument("--bilinear", action="store_true",
                   help="bilinear background-texture sampling (smoother "
                        "than the reference's nearest-texel gather)")


def _add_multihost_args(p):
    p.add_argument("--multihost", action="store_true",
                   help="run this render over a jax.distributed global "
                        "mesh (every chip of every process); start one "
                        "CLI process per host")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count (omit to auto-detect)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id, 0..N-1 (omit to "
                        "auto-detect)")
    p.add_argument("--init-timeout", type=float, default=60.0,
                   help="seconds to wait for the full cluster to join "
                        "before failing with a clear error")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   help="seconds before a peer process that died "
                        "mid-render is detected and the survivors "
                        "error out of their blocked collective "
                        "(default: jax's 100 s)")


def _multihost_mesh(args):
    """Global mesh for a --multihost run (initialize happened in main)."""
    from light_path_tracer_tpu.parallel.multihost import make_global_mesh
    import jax
    mesh = make_global_mesh()
    print(f"multihost: process {jax.process_index()}/"
          f"{jax.process_count()}, {mesh.devices.size} global devices")
    return mesh


def _is_proc0() -> bool:
    import jax
    return jax.process_index() == 0


def _visibility_report(image, fov, path, model, true_diameter=None):
    """Visibility-domain analysis of a rendered image (observables.py):
    save the |V| radial profile, print the first-null diameter."""
    from light_path_tracer_tpu import observables as obs
    # Null-location accuracy needs a finely sampled transform, but the
    # padded complex FFT grid is (pad*H x pad*W): keep it bounded
    # (~8k^2) so a 4k render doesn't OOM the analysis step.
    side = max(np.asarray(image).shape[:2])
    pad = max(2, min(8, 8192 // side))
    est, b_null, (baselines, amp) = obs.shadow_diameter(
        np.asarray(image), fov, model=model, pad=pad, n_bins=512)
    np.savez(path, baselines=np.asarray(baselines), amp=np.asarray(amp),
             b_null=b_null, diameter_rad=est, model=model)
    if np.isfinite(b_null):
        line = (f"  visibility: first null at {b_null:,.1f} wavelengths"
                f" -> {model}-model diameter {np.degrees(est):.4f} deg")
        if true_diameter is not None:
            line += f" (2*alpha_crit = {np.degrees(true_diameter):.4f})"
        print(line)
    else:
        print("  visibility: no null within the sampled baselines "
              "(featureless image or field of view too tight)")
    print(f"Saved: {path}")


def _scene_from(args):
    from light_path_tracer_tpu.utils.config import SceneConfig
    custom = None
    spec = getattr(args, "metric_py", None)
    if spec:
        if getattr(args, "Q", 0.0) or getattr(args, "eps3", 0.0):
            raise SystemExit(
                "error: --metric-py is mutually exclusive with "
                "--Q/--eps3 (the user metric defines the spacetime)")
        from light_path_tracer_tpu.models import load_user_metric
        custom = load_user_metric(spec, M=args.M, a=args.a)
        if (custom.M != args.M or custom.a != args.a) and (
                args.M != 1.0 or args.a != 0.0):
            print(f"note: {spec} is a CustomMetric instance with "
                  f"M={custom.M}, a={custom.a}; ignoring --M/--a")
    return SceneConfig(
        M=args.M, a=args.a, Q=getattr(args, "Q", 0.0),
        eps3=getattr(args, "eps3", 0.0),
        r_obs_mult=args.r_obs,
        psi_y=np.radians(args.psi_y), psi_x=np.radians(args.psi_x),
        vertical_fov_deg=args.fov_v,
        theta_obs=np.radians(getattr(args, "theta_obs", 90.0)),
        boost=tuple(getattr(args, "boost", (0.0, 0.0, 0.0))),
        custom_metric=custom)


def _reject_metric_py(args, mode: str) -> bool:
    """Modes whose physics needs the closed-form families (disk
    orbital dynamics, volumetric flow fields, stellar surfaces,
    recompilation-free sweeps) reject --metric-py with a clear error
    instead of silently tracing the wrong spacetime."""
    if getattr(args, "metric_py", None):
        print(f"error: --metric-py is not supported in {mode} mode "
              "(supported: shadow, lens, magnification, AA, ray, "
              "plot)", file=sys.stderr)
        return True
    return False


def _render_cfg_from(args):
    from light_path_tracer_tpu.utils.config import RenderConfig
    progress = getattr(args, "progress", "off")
    return RenderConfig(
        dtype=args.dtype,
        max_steps=getattr(args, "max_steps", 200000),
        chunk_size=args.chunk_size or None,
        use_tb_symmetry=not args.no_symmetry,
        render_loop_around=getattr(args, "loop_around", False),
        precision=getattr(args, "precision", "fast"),
        integrator=getattr(args, "integrator", "dp45"),
        sampling="bilinear" if getattr(args, "bilinear", False)
                 else "nearest",
        progress={"off": False, "bar": True, "live": "live"}[progress])



def _scene_metric_alpha_crit(scene):
    return scene.metric().alpha_crit(scene.r_obs, scene.theta_obs)


def _centroid_report(path, scene, size, emission, light_curve, spot_r):
    """GRAVITY-style astrometric wobble figure + console summary:
    photocenter track of the RAW per-frame emission
    (observables.centroid_track) next to the light curve. Shared by
    the volumetric --movie and disk --frames movie modes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from light_path_tracer_tpu import camera as _cam
    from light_path_tracer_tpu.observables import centroid_track
    fov = _cam.fov_from_vertical(scene.vertical_fov, (size, size))
    track = np.degrees(np.asarray(centroid_track(emission, fov)))
    lc = np.asarray(light_curve, np.float64)
    fig, axes = plt.subplots(1, 2, figsize=(9.6, 4.2))
    ph = np.arange(len(track)) / max(len(track), 1)
    sc = axes[0].scatter(track[:, 0] * 3600, -track[:, 1] * 3600,
                         c=ph, cmap="twilight", s=28)
    axes[0].plot(track[:, 0] * 3600, -track[:, 1] * 3600,
                 color="0.75", lw=0.8, zorder=0)
    axes[0].set_xlabel("x [arcsec]"), axes[0].set_ylabel("y [arcsec, up]")
    axes[0].set_title("photocenter track")
    axes[0].set_aspect("equal", adjustable="datalim")
    fig.colorbar(sc, ax=axes[0], label="orbital phase")
    axes[1].plot(ph, lc / max(lc.mean(), 1e-300), lw=1.6)
    axes[1].set_xlabel("orbital phase")
    axes[1].set_ylabel("flux / mean")
    axes[1].set_title("light curve")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    ext = np.ptp(track, axis=0) * 3600
    print(f"  centroid wobble: {ext[0]:.3f} x {ext[1]:.3f} "
          f"arcsec (spot orbit diameter "
          f"{np.degrees(2 * spot_r / scene.r_obs) * 3600:.3f} arcsec)")
    print(f"Saved: {path}")


