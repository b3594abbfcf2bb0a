"""`disk` subcommand: accretion-disk render, spectroscopy, hot-spot
animation, polarization, decomposition."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args, _centroid_report, _is_proc0, _multihost_mesh, _reject_metric_py, _render_cfg_from, _visibility_report)


def cmd_disk(args) -> int:
    """Accretion-disk render (BASELINE.json config 4)."""
    if _reject_metric_py(args, "disk"):
        return 2
    from light_path_tracer_tpu.utils.config import SceneConfig
    from light_path_tracer_tpu.disk import render_disk, DiskConfig

    polarized = (getattr(args, "polarization", None)
                 or getattr(args, "qu_loop", None))
    if getattr(args, "Q", 0.0) and polarized:
        print("  note: polarized rendering is Kerr-only; ignoring --Q")
    if getattr(args, "visibility", None) and (
            polarized or getattr(args, "line_profile", None)
            or getattr(args, "light_curve", None) or args.frames > 1):
        # Those branches return before the still-image visibility block.
        print("  note: --visibility applies to the still disk image "
              "only; ignoring")
    if getattr(args, "eps3", 0.0):
        print("  note: disk mode is not wired for --eps3 (orbital "
              "dynamics are Kerr/charged closed forms); ignoring")
    scene = SceneConfig(
        M=args.M, a=args.a, r_obs_mult=args.r_obs,
        Q=(0.0 if polarized else getattr(args, "Q", 0.0)),
        psi_y=np.radians(args.psi_y), psi_x=np.radians(args.psi_x),
        vertical_fov_deg=args.fov_v,
        theta_obs=np.radians(args.inclination),
        boost=tuple(getattr(args, "boost", (0.0, 0.0, 0.0))))
    cfg = _render_cfg_from(args)
    disk = DiskConfig(r_out=args.r_out,
                      emissivity_index=args.emissivity_q,
                      g_power=args.g_power,
                      opaque=not args.translucent,
                      prograde=not args.retrograde,
                      tilt=np.radians(args.tilt),
                      tilt_azimuth=np.radians(args.tilt_azimuth),
                      warp_radius=args.warp_radius or None,
                      spectrum=args.spectrum, t_peak=args.t_peak)

    if getattr(args, "polarization", None):
        # Polarized disk image via the Walker-Penrose constant
        # (polarization.py): EVPA ticks over the tone-mapped image.
        from light_path_tracer_tpu.polarization import (
            render_polarization, save_polarization_figure)
        evpa, pol_frac, intensity, stats = render_polarization(
            scene, (args.size, args.size), cfg, disk,
            field=args.b_field)
        save_polarization_figure(
            args.polarization, evpa, pol_frac, intensity,
            tick_step=max(args.size // 32, 4),
            title=f"a={args.a}, i={args.inclination} deg, "
                  f"{args.b_field} B-field")
        t = stats["timings"]
        print(f"Polarization: {args.size}x{args.size}, a={args.a}, "
              f"{args.b_field} field, "
              f"{stats['polarized_pixels']:,} polarized px, "
              f"trace {t.get('precompute', 0.0):.3f}s")
        print(f"Saved: {args.polarization}")
        return 0

    if getattr(args, "qu_loop", None):
        # Polarized hot-spot flare: integrated Stokes (Q, U) loop over
        # --orbits spot orbits (polarization.hotspot_qu_loop).
        import matplotlib.pyplot as plt
        from light_path_tracer_tpu.disk import HotSpot, keplerian_omega
        from light_path_tracer_tpu.polarization import hotspot_qu_loop
        spot = HotSpot(r0=args.spot_r0, amplitude=args.spot_amplitude)
        period = abs(2.0 * np.pi / keplerian_omega(
            args.M, args.a, args.spot_r0, not args.retrograde,
            Q=scene.Q))
        n = max(args.frames, 48)
        ts = np.linspace(0.0, period * args.orbits, n)
        t_arr, I, Q, U, stats = hotspot_qu_loop(
            scene, (args.size, args.size), ts, cfg, disk, spot,
            field=args.b_field)
        fig, axes = plt.subplots(1, 2, figsize=(11, 4.8))
        s = I.mean()
        axes[0].plot(Q / s, U / s, lw=1.6)
        axes[0].scatter(Q[0] / s, U[0] / s, color="k", zorder=3,
                        label="t=0")
        axes[0].set_xlabel("Q / <I>"), axes[0].set_ylabel("U / <I>")
        axes[0].set_title("Stokes loop"), axes[0].legend()
        axes[0].set_aspect("equal", adjustable="datalim")
        axes[1].plot(t_arr / period, I / s, label="I")
        axes[1].plot(t_arr / period, Q / s, label="Q")
        axes[1].plot(t_arr / period, U / s, label="U")
        axes[1].set_xlabel("time [orbits]"), axes[1].legend()
        axes[1].set_title(f"a={args.a}, i={args.inclination} deg, "
                          f"{args.b_field} field")
        fig.tight_layout()
        fig.savefig(args.qu_loop, dpi=130)
        np.savetxt(args.qu_loop.rsplit(".", 1)[0] + ".csv",
                   np.column_stack([t_arr, I, Q, U]), delimiter=",",
                   header="time_M,I,Q,U")
        tt = stats["timings"]
        print(f"Q-U loop: {n} samples over {args.orbits} orbit(s), "
              f"{args.b_field} field, ONE trace "
              f"{tt.get('precompute', 0.0):.3f}s")
        print(f"Saved: {args.qu_loop} (+ .csv)")
        return 0

    if getattr(args, "decompose", None):
        # Photon-ring decomposition: one trace, per-image-order layers
        # (disk.render_disk_decomposed) on a shared display scale.
        import matplotlib.pyplot as plt
        import jax.numpy as jnp
        from light_path_tracer_tpu.disk import (render_disk_decomposed,
                                                decomposed_display)
        if args.aa > 1:
            print("  note: --aa is not supported with --decompose; "
                  "ignoring")
        n_ord = max(args.orders, 2)
        layers, stats = render_disk_decomposed(
            scene, (args.size, args.size), cfg, disk, n_orders=n_ord)
        stack = jnp.concatenate([jnp.sum(layers, axis=0)[None], layers])
        disp = np.asarray(decomposed_display(stack, disk.tone_map))
        flux = np.asarray(stats["flux_per_order"])
        frac = flux / max(flux.sum(), 1e-300)
        fig, axes = plt.subplots(1, n_ord + 1,
                                 figsize=(3.3 * (n_ord + 1), 3.7))
        titles = ["composite"] + [
            f"n={k} ({frac[k]:.2%} of flux)" for k in range(n_ord)]
        for ax, im, title in zip(axes, disp, titles):
            if im.ndim == 3:
                ax.imshow(np.clip(im, 0.0, 1.0) ** (1.0 / 2.2),
                          origin="upper")
            else:
                ax.imshow(im, cmap="afmhot", origin="upper",
                          vmin=0.0, vmax=1.0)
            ax.set_title(title, fontsize=10)
            ax.axis("off")
        gammas = ", ".join(f"{g:.2f}" for g in stats["gamma_estimates"])
        fig.suptitle(f"image-order decomposition: a={args.a}, "
                     f"i={args.inclination} deg — measured "
                     f"demagnification exponent(s) {gammas} "
                     f"(Schwarzschild asymptote pi)", fontsize=11)
        fig.tight_layout()
        fig.savefig(args.decompose, dpi=120)
        t = stats["timings"]
        print(f"Decomposition: {args.size}x{args.size}, a={args.a}, "
              f"{n_ord} orders from ONE trace "
              f"{t.get('precompute', 0.0):.3f}s")
        for k in range(n_ord):
            mr = np.degrees(stats["mean_radius_rad"][k])
            print(f"  n={k}: flux {frac[k]:.2%}, "
                  f"{stats['pixels_per_order'][k]:,} px, "
                  f"mean radius {mr:.3f} deg")
        print(f"  alpha_crit {np.degrees(stats['alpha_crit']):.3f} deg; "
              f"flux ratios {[f'{r:.3g}' for r in stats['flux_ratios']]}")
        print(f"Saved: {args.decompose}")
        return 0

    if getattr(args, "line_profile", None):
        # Relativistic emission-line profile (spectra.line_profile):
        # double-horned diskline with the spin-dependent red wing.
        import matplotlib.pyplot as plt
        from light_path_tracer_tpu.spectra import line_profile
        energy, flux, stats = line_profile(
            scene, (args.size, args.size), cfg, disk,
            n_bins=args.line_bins, rest_energy=args.rest_energy,
            aa_samples=max(args.aa, 1))
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot(energy, flux / max(flux.max(), 1e-300), lw=1.8)
        ax.axvline(args.rest_energy, color="0.6", ls="--", lw=0.8)
        ax.set_xlabel(f"observed energy (rest = {args.rest_energy})")
        ax.set_ylabel("relative line flux")
        ax.set_title(f"disk line profile: a={args.a}, "
                     f"i={args.inclination} deg, "
                     f"r_isco={stats['r_isco']:.2f} M")
        fig.tight_layout()
        fig.savefig(args.line_profile, dpi=130)
        np.savetxt(args.line_profile.rsplit(".", 1)[0] + ".csv",
                   np.column_stack([energy, flux]), delimiter=",",
                   header="energy,flux")
        t = stats["timings"]
        seen = energy[flux > 0.01 * flux.max()]
        print(f"Line profile: a={args.a}, i={args.inclination} deg, "
              f"{stats['disk_pixels']:,} disk px, "
              f"E/E0 range {seen.min() / args.rest_energy:.3f}"
              f"-{seen.max() / args.rest_energy:.3f}, "
              f"trace {t.get('precompute', 0.0):.3f}s")
        print(f"Saved: {args.line_profile} (+ .csv)")
        return 0

    if getattr(args, "light_curve", None):
        # Hot-spot orbit light curve (spectra.hotspot_light_curve):
        # one trace, flux(t) over --orbits orbits.
        import matplotlib.pyplot as plt
        from light_path_tracer_tpu.disk import HotSpot, keplerian_omega
        from light_path_tracer_tpu.spectra import hotspot_light_curve
        spot = HotSpot(r0=args.spot_r0, amplitude=args.spot_amplitude)
        period = abs(2.0 * np.pi / keplerian_omega(
            args.M, args.a, args.spot_r0, not args.retrograde,
            Q=scene.Q))
        n = max(args.frames, 32)
        ts = np.linspace(0.0, period * args.orbits, n)
        t_arr, flux, stats = hotspot_light_curve(
            scene, (args.size, args.size), ts, cfg, disk, spot,
            light_travel_delay=getattr(args, "light_travel_delay",
                                       False))
        if getattr(args, "light_travel_delay", False):
            print(f"  light-travel delay: {stats['delay_spread']:.1f} M "
                  f"spread across the disk image")
        fig, ax = plt.subplots(figsize=(7, 4.5))
        ax.plot(t_arr / period, flux / flux.mean(), lw=1.8)
        ax.set_xlabel("time [spot orbits]")
        ax.set_ylabel("flux / mean")
        ax.set_title(f"hot-spot light curve: a={args.a}, "
                     f"i={args.inclination} deg, r0={args.spot_r0} M "
                     f"(P={period:.1f} M)")
        fig.tight_layout()
        fig.savefig(args.light_curve, dpi=130)
        np.savetxt(args.light_curve.rsplit(".", 1)[0] + ".csv",
                   np.column_stack([t_arr, flux]), delimiter=",",
                   header="time_M,flux")
        t = stats["timings"]
        print(f"Light curve: {n} samples over {args.orbits} orbit(s), "
              f"modulation x{flux.max() / flux.min():.2f}, ONE trace "
              f"{t.get('precompute', 0.0):.3f}s + "
              f"render {t.get('render', 0.0):.3f}s")
        print(f"Saved: {args.light_curve} (+ .csv)")
        return 0

    if args.frames > 1:
        # Hot-spot orbit animation: ONE trace, args.frames re-renders.
        from PIL import Image
        import matplotlib.cm as cm
        from light_path_tracer_tpu.disk import (render_disk_frames,
                                                HotSpot, keplerian_omega)
        spot = HotSpot(r0=args.spot_r0, amplitude=args.spot_amplitude)
        period = abs(2.0 * np.pi / keplerian_omega(
            args.M, args.a, args.spot_r0, not args.retrograde,
            Q=scene.Q))
        times = [period * args.orbits * i / args.frames
                 for i in range(args.frames)]
        frames, stats = render_disk_frames(
            scene, (args.size, args.size), times, cfg, disk, spot)
        frames = np.asarray(frames)
        if args.spectrum == "blackbody":
            colored = np.clip(frames, 0.0, 1.0) ** (1.0 / 2.2)
        else:
            colored = cm.afmhot(frames)[..., :3]
        pils = [Image.fromarray((np.clip(f, 0, 1)[..., :3] * 255)
                                .astype(np.uint8)) for f in colored]
        out = args.output
        if out.endswith(".png"):
            out = out[:-4] + ".gif"
        pils[0].save(out, save_all=True, append_images=pils[1:],
                     duration=int(1000 / args.fps), loop=0)
        t = stats["timings"]
        print(f"Hot-spot orbit: {args.frames} frames "
              f"({args.orbits} orbit(s), period {period:.1f} M), "
              f"ONE trace {t.get('precompute', 0.0):.3f}s + "
              f"render {t.get('render', 0.0):.3f}s")
        print(f"Saved: {out}")
        if getattr(args, "centroid", None):
            emission = np.asarray(stats["emission"], np.float64)
            _centroid_report(args.centroid, scene, args.size, emission,
                             emission.sum(axis=(1, 2)), args.spot_r0)
        return 0

    if getattr(args, "multihost", False):
        from light_path_tracer_tpu.disk import render_disk_multihost
        for flag, note in (("disk2", "--disk2"),):
            if getattr(args, flag, False):
                print(f"  note: {note} is not supported with "
                      f"--multihost; ignoring")
        if args.aa > 1:
            print("  note: --aa is not supported with --multihost disk; "
                  "ignoring")
        img, stats = render_disk_multihost(
            scene, (args.size, args.size), cfg, disk,
            mesh=_multihost_mesh(args))
    elif getattr(args, "disk2", False):
        # Second independent disk plane, traced in the SAME integration
        # (multi-plane recorder, ops/kerr_trace.py extra_disks).
        from light_path_tracer_tpu.disk import render_multi_disk
        if args.aa > 1:
            print("  note: --aa is not supported with --disk2; ignoring")
        disk2 = DiskConfig(
            r_in=args.disk2_r_in or None, r_out=args.disk2_r_out,
            emissivity_index=args.emissivity_q, g_power=args.g_power,
            opaque=not args.disk2_translucent,
            prograde=not args.retrograde,
            tilt=np.radians(args.disk2_tilt),
            tilt_azimuth=np.radians(args.disk2_tilt_azimuth),
            spectrum=args.spectrum, t_peak=args.t_peak)
        img, stats = render_multi_disk(scene, (args.size, args.size),
                                       cfg, [disk, disk2])
        print(f"  two disks: per-plane pixels "
              f"{stats['disk_pixels_per_plane']}")
    elif args.aa > 1:
        from light_path_tracer_tpu.disk import render_disk_aa
        img, stats = render_disk_aa(scene, (args.size, args.size), cfg,
                                    disk, aa_samples=args.aa)
    else:
        img, stats = render_disk(scene, (args.size, args.size), cfg, disk)
    if _is_proc0():
        from light_path_tracer_tpu.utils.save import save_cmap_png, save_png
        if args.spectrum == "blackbody":
            # Physically colored (linear sRGB): gamma-encode for the
            # PNG on the host (a device-f32 pow differs from this
            # float64 pow in the last ulp, which could flip a truncated
            # texel).
            save_png(args.output,
                     np.clip(np.asarray(img), 0.0, 1.0) ** (1.0 / 2.2))
        else:
            save_cmap_png(args.output, img, "afmhot")
    t = stats["timings"]
    print(f"Accretion disk: {args.size}x{args.size}, a={args.a}, "
          f"inclination {args.inclination} deg, "
          f"r_isco={stats['r_isco']:.3f} M")
    print(f"  disk pixels: {stats['disk_pixels']:,}, "
          f"captured: {stats['captured']:,}")
    print(f"  precompute {t.get('precompute', 0.0):.3f}s "
          f"({stats['traced_rays'] / max(t.get('precompute', 1e-12), 1e-12):,.0f} rays/s)")
    print(f"Saved: {args.output}")
    if getattr(args, "visibility", None) and _is_proc0():
        from light_path_tracer_tpu import camera as _cam
        fov = _cam.fov_from_vertical(scene.vertical_fov,
                                     (args.size, args.size))
        _visibility_report(np.asarray(img), fov, args.visibility,
                           model="ring")
    return 0


def register(sub):
    p = sub.add_parser("disk", help="accretion-disk render (redshift + "
                                    "Doppler beaming)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--inclination", type=float, default=80.0,
                   help="observer inclination from the spin axis in deg")
    p.add_argument("--r-out", type=float, default=20.0)
    p.add_argument("--emissivity-q", type=float, default=3.0)
    p.add_argument("--g-power", type=float, default=3.0)
    p.add_argument("--translucent", action="store_true")
    p.add_argument("--retrograde", action="store_true",
                   help="retrograde disk orbits (ISCO moves out, "
                        "Doppler limb swaps)")
    p.add_argument("--tilt", type=float, default=0.0,
                   help="disk tilt from the equator [deg] (XLA path; "
                        "emitter model approximate for tilted Kerr)")
    p.add_argument("--tilt-azimuth", type=float, default=0.0,
                   help="azimuth of the tilted disk's line of nodes [deg]")
    p.add_argument("--warp-radius", type=float, default=0.0,
                   help="Bardeen-Petterson warp radius [M]: inner disk "
                        "aligns with the equator, outer keeps --tilt "
                        "(0 = flat tilted plane)")
    p.add_argument("--spectrum", default="powerlaw",
                   choices=["powerlaw", "blackbody"],
                   help="powerlaw: grayscale g^p r^-q (afmhot colormap); "
                        "blackbody: physical Planck colors at "
                        "T_obs = g T(r)")
    p.add_argument("--t-peak", type=float, default=9000.0,
                   help="blackbody peak disk temperature [K]")
    p.add_argument("--frames", type=int, default=1,
                   help=">1: hot-spot orbit animation (GIF) — one trace, "
                        "N re-rendered frames")
    p.add_argument("--orbits", type=float, default=1.0,
                   help="number of spot orbits across the animation")
    p.add_argument("--spot-r0", type=float, default=6.0,
                   help="hot-spot orbit radius [M]")
    p.add_argument("--spot-amplitude", type=float, default=6.0)
    p.add_argument("--centroid", default=None, metavar="PLOT.png",
                   help="with --frames: also save the GRAVITY-style "
                        "astrometric photocenter track + light curve "
                        "(observables.centroid_track on the raw "
                        "per-frame emission)")
    p.add_argument("--fps", type=float, default=12.0)
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel (disk edges / "
                        "photon ring)")
    p.add_argument("--decompose", default=None, metavar="PANEL.png",
                   help="photon-ring decomposition: split the disk "
                        "image by image order (direct / first lensed / "
                        "photon subrings) from ONE trace; saves a "
                        "shared-scale panel and prints per-order "
                        "fluxes + the measured Lyapunov "
                        "demagnification (disk.render_disk_decomposed)")
    p.add_argument("--orders", type=int, default=3,
                   help="image orders for --decompose (>= 2)")
    p.add_argument("--polarization", default=None, metavar="PLOT.png",
                   help="polarized disk image (Walker-Penrose "
                        "transport): EVPA ticks over the disk render "
                        "(polarization.py; requires a BH-centered "
                        "camera)")
    p.add_argument("--b-field", default="toroidal",
                   choices=["vertical", "toroidal", "radial"],
                   help="magnetic-field geometry for --polarization")
    p.add_argument("--qu-loop", default=None, metavar="PLOT.png",
                   help="polarized hot-spot flare: integrated Stokes "
                        "(Q, U) loop over --orbits orbits "
                        "(polarization.hotspot_qu_loop)")
    p.add_argument("--line-profile", default=None, metavar="PLOT.png",
                   help="compute the relativistic emission-line profile "
                        "(flux vs observed energy; the Fe K-alpha "
                        "diskline shape) instead of an image; saves a "
                        "plot + CSV (spectra.line_profile)")
    p.add_argument("--rest-energy", type=float, default=6.4,
                   help="line rest energy for --line-profile (6.4 = "
                        "Fe K-alpha in keV; 1.0 = profile in g)")
    p.add_argument("--line-bins", type=int, default=200,
                   help="energy bins for --line-profile")
    p.add_argument("--light-travel-delay", action="store_true",
                   help="with --light-curve: evaluate the spot at each "
                        "pixel's RETARDED time (per-crossing coordinate"
                        "-time recording) instead of the equal-time "
                        "approximation — light-echo skew included")
    p.add_argument("--light-curve", default=None, metavar="PLOT.png",
                   help="compute the orbiting hot-spot light curve "
                        "(flux vs time over --orbits orbits, >=32 "
                        "samples or --frames) instead of an image; "
                        "saves a plot + CSV (spectra.hotspot_light_curve)")
    p.add_argument("--disk2", action="store_true",
                   help="add a second independent disk plane, traced in "
                        "the same integration (multi-plane recorder)")
    p.add_argument("--disk2-r-in", type=float, default=0.0,
                   help="second disk inner radius [M] (0 = ISCO)")
    p.add_argument("--disk2-r-out", type=float, default=30.0)
    p.add_argument("--disk2-tilt", type=float, default=25.0,
                   help="second disk tilt from the equator [deg]")
    p.add_argument("--disk2-tilt-azimuth", type=float, default=0.0)
    p.add_argument("--disk2-translucent", action="store_true")
    p.add_argument("--output", default="accretion_disk.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="also analyze the disk image in the visibility "
                        "domain (observables.py): save the azimuthally "
                        "averaged |V| profile as PATH (.npz) and print "
                        "the ring diameter recovered from the first "
                        "null")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_disk)
