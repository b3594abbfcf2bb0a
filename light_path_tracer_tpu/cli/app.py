"""Parser assembly + entry point (the former cli.py tail)."""

from __future__ import annotations

import argparse
import sys

from light_path_tracer_tpu.cli import (animate, disk, lens, pano,
                                       request, shadow, star,
                                       trajectory, volumetric)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="light_path_tracer_tpu",
        description="General-relativistic ray tracer (JAX, GPU)")
    sub = parser.add_subparsers(dest="command")
    # Registration order = help-listing order (reference parity kept
    # from the monolithic cli.py).
    lens.register(sub)
    shadow.register(sub)
    disk.register(sub)
    volumetric.register(sub)
    star.register(sub)
    pano.register(sub)
    animate.register(sub)
    trajectory.register_ray(sub)
    request.register(sub)
    trajectory.register_plot(sub)
    trajectory.register_orbit(sub)
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    import jax
    restore = {}
    device = getattr(args, "device", "default")
    if device != "default":
        # Must run before any backend initialization.
        restore["jax_platforms"] = jax.config.jax_platforms
        jax.config.update("jax_platforms", device)
    if getattr(args, "dtype", "float32") == "float64":
        # Without this, jnp silently truncates every float64 request
        # to float32 and --dtype float64 would be a no-op.
        restore["jax_enable_x64"] = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)
    if getattr(args, "multihost", False):
        # Must run before ANY other JAX call in this process.
        from light_path_tracer_tpu.parallel.multihost import (
            initialize_multihost)
        initialize_multihost(
            heartbeat_timeout_s=args.heartbeat_timeout,
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            timeout_s=args.init_timeout)
    from light_path_tracer_tpu.utils.cache import enable_compilation_cache
    # The persistent-cache settings are process-global too; snapshot
    # them BEFORE enabling so the finally below restores them (a leaked
    # jax_compilation_cache_dir made pytest write — and once segfault
    # in — the on-disk cache long after main() returned).
    for key in ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs"):
        try:
            restore[key] = getattr(jax.config, key)
        except AttributeError:
            pass
    enable_compilation_cache()
    try:
        if not getattr(args, "fn", None):
            parser.print_help()
            return 2
        try:
            return args.fn(args)
        except ModuleNotFoundError as e:
            pkg = (e.name or "").split(".")[0]
            if pkg not in ("matplotlib", "PIL", "tqdm"):
                raise
            print(f"error: this mode needs {pkg}, part of the optional "
                  f"viz extra: pip install 'light-path-tracer-tpu[viz]'",
                  file=sys.stderr)
            return 2
    finally:
        # All captured settings are process-global; restore them so
        # in-process callers (tests, notebooks) can invoke main()
        # repeatedly with different flags. (The already-initialized
        # backend persists — only the CONFIG is restored.)
        for key, val in restore.items():
            jax.config.update(key, val)


if __name__ == "__main__":
    sys.exit(main())
