"""`lens` subcommand: the flagship lensed render + its map-level
modes (magnification, shear, caustics, microlens, time delay,
find-images)."""

from __future__ import annotations

import time

import numpy as np

from light_path_tracer_tpu.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args, _is_proc0, _multihost_mesh, _render_cfg_from, _scene_from)


def cmd_lens(args) -> int:
    """Lensed background-image render (image_lens.main parity)."""
    import matplotlib.image as mpimg
    from light_path_tracer_tpu.pipeline import (
        render_scene, print_benchmark_summary)
    from light_path_tracer_tpu import camera

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)

    q_arg = getattr(args, "Q", 0.0)
    kind = ("Kerr-Newman" if args.a != 0 and q_arg != 0
            else "Kerr" if args.a != 0
            else "Reissner-Nordstrom" if q_arg != 0
            else "Schwarzschild")
    print(f"Metric: {kind} (M={args.M}, a={args.a}"
          + (f", Q={args.Q}" if getattr(args, "Q", 0.0) else "") + ")")

    if getattr(args, "magnification", None):
        # Magnification-map product: no source image involved.
        from light_path_tracer_tpu.pipeline import render_magnification
        mu, mstats = render_magnification(
            scene, (args.size, args.size), cfg)
        from light_path_tracer_tpu.render import magnification_display
        mpimg.imsave(args.magnification, magnification_display(mu))
        tt = mstats["timings"]
        print(f"Magnification map {args.size}x{args.size}: "
              f"|mu|_max={mstats['mu_abs_max']:.1f}, "
              f"{mstats['negative_parity_pixels']} odd-parity px, "
              f"{mstats['shadow_pixels']} shadow px "
              f"(precompute {tt.get('precompute', 0.0):.3f}s, "
              f"render {tt.get('render', 0.0):.3f}s)")
        print(f"Saved: {args.magnification}")
        return 0

    if getattr(args, "shear", None):
        # Weak-lensing decomposition maps (kappa/gamma/omega).
        from light_path_tracer_tpu.pipeline import render_shear
        maps, sstats = render_shear(scene, (args.size, args.size), cfg)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, 2, figsize=(9, 8))
        panels = (("kappa", "convergence kappa", "RdBu_r", True),
                  ("gamma", "shear |gamma|", "inferno", False),
                  ("gamma1", "gamma_1", "RdBu_r", True),
                  ("omega", "rotation omega (frame dragging)",
                   "RdBu_r", True))
        for ax, (key, title, cmap, sym) in zip(axes.ravel(), panels):
            v = np.asarray(maps[key])
            fin = np.isfinite(v)
            lim = (np.percentile(np.abs(v[fin]), 99.0)
                   if fin.any() else 1.0) or 1.0
            kw = ({"vmin": -lim, "vmax": lim} if sym
                  else {"vmin": 0.0, "vmax": lim})
            im = ax.imshow(v, cmap=cmap, origin="lower", **kw)
            ax.set_title(title, fontsize=10)
            ax.set_xticks([]), ax.set_yticks([])
            fig.colorbar(im, ax=ax, fraction=0.046)
        fig.tight_layout()
        fig.savefig(args.shear, dpi=110)
        plt.close(fig)
        tt = sstats["timings"]
        print(f"Shear decomposition {args.size}x{args.size}: "
              f"gamma_max={sstats['gamma_max']:.2f}, "
              f"|omega|_max={sstats['omega_abs_max']:.2e}, "
              f"{sstats['shadow_pixels']} shadow px "
              f"(precompute {tt.get('precompute', 0.0):.3f}s, "
              f"render {tt.get('render', 0.0):.3f}s)")
        print(f"Saved: {args.shear}")
        return 0

    if getattr(args, "caustics", None):
        # Source-plane (caustic) map: inverse ray shooting.
        from light_path_tracer_tpu.pipeline import render_caustics
        amap, extent, cstats = render_caustics(
            scene, (args.size, args.size), cfg,
            bins=args.caustic_bins)
        amap_np = np.asarray(amap)
        disp = np.log10(1.0 + np.maximum(amap_np, 0.0))
        lim = np.percentile(disp, 99.5) or 1.0
        import matplotlib.cm as cm
        mpimg.imsave(args.caustics,
                     cm.inferno(np.clip(disp / lim, 0.0, 1.0)))
        tt = cstats["timings"]
        print(f"Caustic map {args.caustic_bins}x{args.caustic_bins} "
              f"(traced {args.size}x{args.size}, beta_max "
              f"{np.degrees(cstats['beta_max']):.2f} deg): "
              f"A_max={cstats['A_max']:.1f}, far-field median "
              f"A={cstats['A_far_field']:.3f} "
              f"(precompute {tt.get('precompute', 0.0):.3f}s, "
              f"render {tt.get('render', 0.0):.3f}s)")
        print(f"Saved: {args.caustics}")
        return 0

    if getattr(args, "time_delay", None):
        # Fermat arrival-time map (time-delay cosmography).
        from light_path_tracer_tpu.pipeline import render_time_delay
        tau, tstats = render_time_delay(
            scene, (args.size, args.size), cfg)
        tau_np = np.asarray(tau)
        disp = np.log10(1.0 + np.nan_to_num(tau_np, nan=0.0))
        lim = np.nanpercentile(disp, 99.5) or 1.0
        import matplotlib.cm as cm
        rgba = cm.viridis(np.clip(disp / lim, 0.0, 1.0))
        rgba[~np.isfinite(tau_np)] = (0.0, 0.0, 0.0, 1.0)
        mpimg.imsave(args.time_delay, rgba)
        tt = tstats["timings"]
        print(f"Arrival-time map {args.size}x{args.size}: "
              f"tau_max={tstats['tau_max']:.2f} M, "
              f"{tstats['shadow_pixels']} shadow px "
              f"(precompute {tt.get('precompute', 0.0):.3f}s, "
              f"render {tt.get('render', 0.0):.3f}s)")
        print(f"Saved: {args.time_delay}")
        return 0

    if getattr(args, "find_images", None):
        # Strong-lensing image-position solver (images.py).
        from light_path_tracer_tpu.images import (find_point_images,
                                                  format_image_table)
        try:
            bx_deg, by_deg = (float(v) for v in
                              args.find_images.split(","))
        except ValueError:
            print("--find-images expects BX,BY in degrees "
                  f"(got {args.find_images!r})")
            return 2
        beta = (np.radians(bx_deg), np.radians(by_deg))
        imgs, istats = find_point_images(
            scene, beta, resolution=(args.size, args.size), cfg=cfg)
        tt = istats["timings"]
        print(f"Images of point source at beta = ({bx_deg:.4f}, "
              f"{by_deg:.4f}) deg ({args.size}x{args.size} grid):")
        print(format_image_table(imgs, istats))
        print(f"  (precompute {tt.get('precompute', 0.0):.3f}s, "
              f"refine {tt.get('refine', 0.0):.3f}s, "
              f"products {tt.get('products', 0.0):.3f}s)")
        return 0

    if getattr(args, "microlens", None):
        # Microlensing light curve of a source crossing the lens.
        from light_path_tracer_tpu.pipeline import (
            render_microlens_curve)
        u_axis, curve, mlstats = render_microlens_curve(
            scene, (args.size, args.size), cfg,
            impact_u=args.track_impact, span_u=args.track_span,
            n_points=args.track_points,
            source_radius_u=args.source_radius)
        curve_np = np.asarray(curve)
        xs = np.linspace(-args.track_span, args.track_span,
                         args.track_points)
        if args.microlens.endswith(".png"):
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(7, 4))
            ax.plot(xs, curve_np, lw=2)
            ref = (u_axis ** 2 + 2) / (
                u_axis * np.sqrt(u_axis ** 2 + 4))
            ax.plot(xs, ref, "--", lw=1,
                    label="point-lens Paczynski")
            ax.set_xlabel(r"track position [$\theta_E$]")
            ax.set_ylabel("total magnification A")
            ax.legend()
            fig.savefig(args.microlens, dpi=120,
                        bbox_inches="tight")
            plt.close(fig)
        else:
            with open(args.microlens, "w") as fh:
                fh.write("track_pos_thetaE,u,A\n")
                for x, uu, aa in zip(xs, u_axis, curve_np):
                    fh.write(f"{x:.6f},{uu:.6f},{aa:.8f}\n")
        print(f"Microlensing curve ({args.track_points} points, "
              f"impact u0={args.track_impact}, source radius "
              f"{args.source_radius} theta_E, theta_E = "
              f"{np.degrees(mlstats['theta_E']):.3f} deg): "
              f"A_peak={mlstats['A_peak']:.4f}, baseline "
              f"{mlstats['A_baseline']:.4f}")
        print(f"Saved: {args.microlens}")
        return 0

    t0 = time.perf_counter()
    img = mpimg.imread(args.image)
    load_time = time.perf_counter() - t0
    height, width = img.shape[:2]
    print(f"Image: {width}x{height}")

    r_obs = scene.r_obs
    metric = scene.metric()
    alpha_crit = metric.alpha_crit(r_obs)
    print(f"r_obs = {r_obs:.1f} M, "
          f"alpha_crit = {np.degrees(alpha_crit):.4f} deg")

    bh_y, bh_x, in_front = camera.psi_to_cam_projection(scene.psi)
    fov = camera.fov_from_vertical(scene.vertical_fov, (height, width))
    in_fov = (in_front and abs(bh_y) <= np.tan(fov[1] / 2)
              and abs(bh_x) <= np.tan(fov[0] / 2))
    status = ("behind observer" if not in_front
              else ("inside FOV" if in_fov else "outside FOV"))
    print(f"BH screen offset: psi_y={args.psi_y:.4f} deg, "
          f"psi_x={args.psi_x:.4f} deg ({status})")

    ring_tables = None
    if getattr(args, "multihost", False):
        from light_path_tracer_tpu.aa import render_scene_aa
        for flag, note in (("disk", "--disk"), ("cache", "--cache"),
                           ("rings", "--rings"),
                           ("adaptive", "--adaptive")):
            if getattr(args, flag, False):
                print(f"  note: {note} is not supported with "
                      f"--multihost; ignoring")
        result, astats = render_scene_aa(
            scene, img, cfg, aa_samples=max(getattr(args, "aa", 1), 1),
            mesh=_multihost_mesh(args))
        astats["timings"]["load_image"] = (
            astats["timings"].get("load_image", 0.0) + load_time)
        timings = astats["timings"]
        total, traced = astats["total_rays"], astats["traced_rays"]
    elif getattr(args, "disk", False):
        if args.cache:
            print("  note: --cache is not supported with --disk "
                  "(composite re-traces); ignoring")
        if getattr(args, "rings", False):
            print("  note: --rings is not supported with --disk; "
                  "ignoring")
        from light_path_tracer_tpu.disk import (
            render_scene_with_disk, DiskConfig)
        disk = DiskConfig(r_out=args.r_out,
                          emissivity_index=args.emissivity_q,
                          g_power=args.g_power,
                          opaque=not args.translucent,
                          spectrum=args.spectrum, t_peak=args.t_peak)
        if getattr(args, "adaptive", False):
            print("  note: --adaptive is not supported with --disk "
                  "(the composite needs every pixel's crossing record); "
                  "using stacked uniform AA")
        if getattr(args, "aa", 1) > 1:
            from light_path_tracer_tpu.disk import render_scene_with_disk_aa
            # Per-pass display encoding BEFORE the average — exact AA
            # in display space (see render_scene_with_disk_aa docs).
            result, stats = render_scene_with_disk_aa(
                scene, img, cfg, disk, disk_gain=args.disk_gain,
                aa_samples=args.aa, display_encode=True)
        else:
            result, stats = render_scene_with_disk(
                scene, img, cfg, disk, disk_gain=args.disk_gain)
        if args.spectrum == "blackbody" and not stats.get(
                "display_encoded"):
            # Display-encode the linear-light disk pixels so the
            # composite matches cmd_disk / showcase output (the
            # background texture is already display-encoded; only the
            # disk layer is physical linear radiance).
            from light_path_tracer_tpu.disk import composite_gamma_encode
            result = composite_gamma_encode(result, stats["disk_mask"])
        stats["timings"]["load_image"] = (
            stats["timings"].get("load_image", 0.0) + load_time)
        timings = stats["timings"]
        total, traced = stats["total_rays"], stats["traced_rays"]
        print(f"  disk pixels: {stats['disk_pixels']:,}, "
              f"captured: {stats['captured']:,}, "
              f"r_isco={stats['r_isco']:.3f} M")
    elif args.cache:
        if getattr(args, "aa", 1) > 1:
            print("  note: --aa is not supported with --cache "
                  "(the cache stores one non-jittered lookup); ignoring")
        from light_path_tracer_tpu.checkpoint import cached_precompute
        from light_path_tracer_tpu.utils.timing import StageTimer
        from light_path_tracer_tpu.render import render_lensed_image
        import jax.numpy as jnp

        timer = StageTimer()
        timer.timings["load_image"] = load_time
        src = jnp.asarray(img)
        if src.dtype == jnp.uint8:
            src = src.astype(jnp.float32) / 255.0
        with timer.stage("build_lookup") as out:
            alpha_lookup = camera.build_alpha_lookup(
                (height, width), fov, psi=scene.psi)
            out.append(alpha_lookup)
        with timer.stage("precompute") as out:
            pre, hit = cached_precompute(scene, cfg, (height, width), fov)
            out.append(pre.final_alpha)
        print(f"  lookup cache {'HIT' if hit else 'MISS'}")
        with timer.stage("render") as out:
            theta_lookup = (camera.build_theta_lookup(
                (height, width), fov, psi=scene.psi,
                boost=scene.boost) if scene.boosted else None)
            lensed = render_lensed_image(
                src, alpha_lookup, pre.final_alpha, pre.winding,
                alpha_crit, fov, cfg.render_loop_around, psi=scene.psi,
                theta_lookup=theta_lookup, sampling=cfg.sampling)
            out.append(lensed)
        timings = timer.finish()
        result, total, traced = lensed, pre.total_rays, pre.traced_rays
        ring_tables = (pre.final_alpha, pre.winding)
    elif getattr(args, "aa", 1) > 1:
        if getattr(args, "adaptive", False):
            from light_path_tracer_tpu.adaptive import (
                render_scene_adaptive)
            result, astats = render_scene_adaptive(
                scene, img, cfg, aa_samples=args.aa,
                refine_frac=args.refine_frac)
            print(f"  adaptive AA: {astats['refined_pixels']:,} pixels "
                  f"refined ({astats['edge_pixels']:,} discrete-edge), "
                  f"{astats['total_rays']:,} rays vs "
                  f"{astats['uniform_aa_rays']:,} uniform")
        else:
            from light_path_tracer_tpu.aa import render_scene_aa
            result, astats = render_scene_aa(scene, img, cfg,
                                             aa_samples=args.aa)
        astats["timings"]["load_image"] = (
            astats["timings"].get("load_image", 0.0) + load_time)
        timings = astats["timings"]
        total, traced = astats["total_rays"], astats["traced_rays"]
        if getattr(args, "rings", False):
            print("  note: --rings is not supported with --aa; ignoring")
    else:
        out = render_scene(scene, img, cfg)
        out.timings["load_image"] += load_time
        timings = out.timings
        result = out.image
        total, traced = out.precompute.total_rays, out.precompute.traced_rays
        ring_tables = (out.precompute.final_alpha, out.precompute.winding)

    if getattr(args, "rings", False) and ring_tables is not None:
        # Decomposition reuses THIS render's lookup tables — no second
        # trace (review finding: the old path re-rendered everything).
        import os
        from light_path_tracer_tpu.pipeline import lensed_ring_layers
        layers, order_pixels = lensed_ring_layers(
            ring_tables[0], ring_tables[1], result,
            max_order=args.max_order)
        stem, ext = os.path.splitext(args.output)
        for layer, label in zip(np.asarray(layers), order_pixels):
            mpimg.imsave(f"{stem}_{label.replace('_', '')}{ext}",
                         np.clip(layer, 0.0, 1.0))
        for label, count in order_pixels.items():
            print(f"  {label:<12} {count:>10,} px")

    t0 = time.perf_counter()
    if _is_proc0():
        # On-device uint8 quantization: 4x less readback, the same
        # pixels (utils/save.py).
        from light_path_tracer_tpu.utils.save import save_png
        save_png(args.output, result)
    timings["save_image"] = time.perf_counter() - t0
    timings["total"] = timings.get("total", 0.0) + timings["save_image"]

    print_benchmark_summary((height, width), alpha_crit, total, traced,
                            timings)
    print(f"Saved: {args.output}")
    return 0


def register(sub):
    p = sub.add_parser("lens", help="lensed background-image render")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--image", default="image.jpg")
    p.add_argument("--output", default="lensed_image.png")
    p.add_argument("--disk", action="store_true",
                   help="composite an accretion disk into the lensed "
                        "render (one trace per pixel; --theta-obs sets "
                        "the inclination)")
    p.add_argument("--r-out", type=float, default=20.0)
    p.add_argument("--emissivity-q", type=float, default=3.0)
    p.add_argument("--g-power", type=float, default=3.0)
    p.add_argument("--translucent", action="store_true")
    p.add_argument("--spectrum", default="blackbody",
                   choices=["powerlaw", "blackbody"])
    p.add_argument("--t-peak", type=float, default=9000.0)
    p.add_argument("--disk-gain", type=float, default=1.0,
                   help="disk brightness relative to the background")
    p.add_argument("--aa", type=int, default=1,
                   help="composite AA samples per pixel (with --disk)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive AA: refine only edge pixels (shadow "
                        "boundary, photon rings, high-contrast bands) "
                        "at --aa samples; ~aa x fewer rays than uniform "
                        "AA (adaptive.py)")
    p.add_argument("--refine-frac", type=float, default=0.05,
                   help="adaptive-AA refinement budget (fraction of "
                        "pixels, top_k by edge score)")
    p.add_argument("--rings", action="store_true",
                   help="also write the lensed image split by photon-"
                        "ring order (direct / 1st lensed / n-th ring)")
    p.add_argument("--max-order", type=int, default=3)
    p.add_argument("--magnification", metavar="PATH",
                   help="instead of lensing an image, write the signed "
                        "magnification map of the celestial lens map "
                        "(critical curves at |mu| -> inf, mu < 0 = "
                        "parity-flipped images, NaN shadow black); "
                        "--size sets the grid, no --image needed")
    p.add_argument("--size", type=int, default=512,
                   help="grid size for --magnification/--caustics/"
                        "--microlens")
    p.add_argument("--shear", metavar="PATH",
                   help="write the weak-lensing decomposition of the "
                        "traced lens map (2x2 panel: convergence "
                        "kappa, shear |gamma|, gamma_1, rotation "
                        "omega; omega != 0 is frame dragging — a "
                        "direct map-level spin observable); --size "
                        "sets the grid, no --image needed")
    p.add_argument("--caustics", metavar="PATH",
                   help="instead of lensing an image, write the "
                        "SOURCE-plane magnification (caustic) map by "
                        "inverse ray shooting (total A over all "
                        "images; ridges = caustics); --size sets the "
                        "traced grid, no --image needed")
    p.add_argument("--caustic-bins", type=int, default=256,
                   help="source-plane bins per axis for --caustics")
    p.add_argument("--microlens", metavar="PATH",
                   help="write a microlensing light curve (CSV, or a "
                        "plot if PATH ends .png) of a finite source "
                        "crossing the lens at --track-impact; "
                        "weak-field Schwarzschild reproduces the "
                        "Paczynski curve")
    p.add_argument("--track-impact", type=float, default=1.0,
                   help="microlens track impact parameter u0 in "
                        "Einstein angles theta_E = sqrt(4M/r_obs)")
    p.add_argument("--track-span", type=float, default=4.0,
                   help="microlens track half-length in theta_E")
    p.add_argument("--track-points", type=int, default=81,
                   help="points along the microlens track")
    p.add_argument("--source-radius", type=float, default=0.3,
                   help="source angular radius in theta_E")
    p.add_argument("--time-delay", metavar="PATH",
                   help="write the Fermat arrival-time map (coordinate "
                        "time traced through the metric, plane-wave "
                        "referenced; tau differences between pixels "
                        "imaging the same source = the time-delay-"
                        "cosmography observable). float64 recommended")
    p.add_argument("--find-images", metavar="BX,BY",
                   help="solve for ALL images of a point source at "
                        "gnomonic sky position (BX, BY) degrees about "
                        "the BH: prints positions, signed "
                        "magnifications/parities, winding orders, and "
                        "relative time delays (Newton-refined on the "
                        "traced lens map; --size sets the coarse "
                        "grid, no --image needed). "
                        "--dtype float64 recommended for delays")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_lens)
