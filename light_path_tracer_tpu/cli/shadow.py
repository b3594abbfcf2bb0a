"""`shadow` subcommand: analytic / integrated shadow, AA, rings,
visibility-domain analysis."""

from __future__ import annotations

import numpy as np

from light_path_tracer_tpu.cli._shared import (
    _add_multihost_args, _add_render_args, _add_scene_args, _is_proc0, _multihost_mesh, _render_cfg_from, _scene_from, _scene_metric_alpha_crit, _visibility_report)


def cmd_shadow(args) -> int:
    """Shadow render (black_hole_shadow.py parity + integrated mode)."""
    import os
    from light_path_tracer_tpu.pipeline import render_shadow, render_rings
    from light_path_tracer_tpu.utils.save import save_cmap_png, save_png

    scene = _scene_from(args)
    cfg = _render_cfg_from(args)

    if args.rings:
        if getattr(args, "visibility", None):
            print("  note: --visibility is not supported with --rings; "
                  "ignoring")
        masks, composite, stats = render_rings(
            scene, (args.size, args.size), cfg, max_order=args.max_order)
        save_png(args.output, np.asarray(composite))
        stem, ext = os.path.splitext(args.output)
        labels = ([f"order{k}" for k in range(args.max_order)]
                  + [f"order{args.max_order}plus", "shadow"])
        for mask, label in zip(np.asarray(masks), labels):
            save_cmap_png(f"{stem}_{label}{ext}", mask.astype(np.float32),
                          "gray")
        t = stats["timings"]
        print(f"Photon-ring decomposition: {args.size}x{args.size}, "
              f"a={scene.a}, precompute {t.get('precompute', 0.0):.3f}s")
        for label, count in stats["order_pixels"].items():
            print(f"  {label:<12} {count:>10,} px")
        print(f"Saved: {args.output} (+ {len(labels)} per-order masks)")
        return 0

    if getattr(args, "multihost", False):
        from light_path_tracer_tpu.aa import render_shadow_aa
        if args.analytic:
            print("  note: --multihost shadow is the integrated mode; "
                  "ignoring --analytic")
        if getattr(args, "adaptive", False):
            print("  note: --adaptive is not supported with --multihost "
                  "(scattered refine sets defeat row sharding); using "
                  "uniform AA")
        img, stats = render_shadow_aa(scene, (args.size, args.size), cfg,
                                      aa_samples=max(args.aa, 1),
                                      mesh=_multihost_mesh(args))
        stats.setdefault("alpha_crit", _scene_metric_alpha_crit(scene))
    elif getattr(args, "aa", 1) > 1:
        if args.analytic:
            print("  note: --aa applies to the integrated shadow; "
                  "ignoring --analytic")
        if getattr(args, "adaptive", False):
            from light_path_tracer_tpu.adaptive import (
                render_shadow_adaptive)
            img, stats = render_shadow_adaptive(
                scene, (args.size, args.size), cfg, aa_samples=args.aa,
                refine_frac=args.refine_frac)
            print(f"  adaptive AA: {stats['refined_pixels']:,} pixels "
                  f"refined, {stats['total_rays']:,} rays vs "
                  f"{stats['uniform_aa_rays']:,} uniform")
        else:
            from light_path_tracer_tpu.aa import render_shadow_aa
            img, stats = render_shadow_aa(scene, (args.size, args.size),
                                          cfg, aa_samples=args.aa)
        stats.setdefault("alpha_crit", _scene_metric_alpha_crit(scene))
    else:
        img, stats = render_shadow(scene, (args.size, args.size), cfg,
                                   analytic=args.analytic)
    if _is_proc0():
        # uint8 colormap-index readback (1 B/px vs 4) + host-side
        # lookup table: the pixels of a float cmap="gray" save.
        save_cmap_png(args.output, img, "gray")
    t = stats["timings"]
    mode = ("analytic threshold" if args.analytic
            else (f"integrated, {stats['aa_samples']}x AA"
                  if stats.get("aa_samples", 1) > 1 else "integrated"))
    # AA timings report one fused precompute+render stage.
    trace_t = t.get("precompute", t.get("precompute+render", 0.0))
    print(f"Shadow ({mode}): {args.size}x{args.size}, "
          f"alpha_crit={np.degrees(stats['alpha_crit']):.4f} deg, "
          f"precompute {trace_t:.3f}s, "
          f"render {t.get('render', 0.0):.3f}s")
    if stats.get("traced_rays"):
        print(f"  {stats['traced_rays'] / max(trace_t, 1e-12):,.0f} rays/s")
    print(f"Saved: {args.output}")
    if getattr(args, "visibility", None) and _is_proc0():
        from light_path_tracer_tpu import camera as _cam
        fov = _cam.fov_from_vertical(scene.vertical_fov,
                                     (args.size, args.size))
        # The silhouette (bright disk on dark sky) is the compact
        # source whose null encodes the shadow diameter.
        _visibility_report(1.0 - np.asarray(img), fov, args.visibility,
                           model="disk",
                           true_diameter=2.0 * stats["alpha_crit"])
    return 0


def register(sub):
    p = sub.add_parser("shadow", help="black-hole shadow render")
    p.add_argument("--aa", type=int, default=1,
                   help="jittered AA samples per pixel (smooth shadow "
                        "boundary)")
    p.add_argument("--adaptive", action="store_true",
                   help="adaptive AA: refine only shadow-boundary / "
                        "photon-ring pixels at --aa samples "
                        "(adaptive.py)")
    p.add_argument("--refine-frac", type=float, default=0.05,
                   help="adaptive-AA refinement budget (fraction of "
                        "pixels, top_k by edge score)")
    _add_scene_args(p)
    _add_render_args(p)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--analytic", action="store_true",
                   help="zero-integration threshold test vs alpha_crit")
    p.add_argument("--rings", action="store_true",
                   help="photon-ring decomposition: composite colored by "
                        "winding order + one mask image per order")
    p.add_argument("--max-order", type=int, default=3,
                   help="highest photon-ring order to separate")
    p.add_argument("--output", default="black_hole_shadow.png")
    p.add_argument("--visibility", metavar="PATH",
                   help="also analyze the shadow silhouette in the "
                        "visibility domain (observables.py): save the "
                        "azimuthally averaged |V| profile as PATH "
                        "(.npz) and print the diameter recovered from "
                        "the first null vs the true 2*alpha_crit")
    _add_multihost_args(p)
    p.set_defaults(fn=cmd_shadow)
