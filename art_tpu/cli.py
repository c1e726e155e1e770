"""Command-line renderer.

Replaces the reference's hardcoded ``switch(10)`` entry point
(src/main.cu:1307-1323, with its missing-break fallthrough quirk) with an
explicit scene selector, while preserving the I/O contract: PPM P3 on
stdout, diagnostics on stderr, so ``art-render --scene cornell_box > out.ppm``
behaves like the reference binary.
"""

from __future__ import annotations

import argparse
import sys

from art_tpu.core.cache import enable_compile_cache

enable_compile_cache()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="art-render", description="wavefront path tracer"
    )
    parser.add_argument("--scene", default="three_spheres")
    parser.add_argument("--list-scenes", action="store_true")
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--spp", type=int, default=None)
    parser.add_argument("--max-depth", type=int, default=50)
    parser.add_argument("--gamma", type=float, default=2.2)
    parser.add_argument("--seed", type=int, default=1984)
    parser.add_argument("--out", default="-", help="output path ('-' = stdout)")
    parser.add_argument(
        "--clamp", action="store_true",
        help="clamp PPM values to [0,255] (reference default: no clamp)",
    )
    parser.add_argument(
        "--png", default=None, help="also write a PNG copy to this path"
    )
    parser.add_argument(
        "--checkpoint", default=None,
        help="npz path: save progress per dispatch and resume matching renders",
    )
    parser.add_argument(
        "--sharded", action="store_true", help="render across all visible devices"
    )
    parser.add_argument(
        "--platform", default=None, choices=("cpu", "gpu"),
        help="force a JAX backend (default: auto)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
        try:
            jax.devices()
        except RuntimeError as e:
            print(
                f"error: --platform {args.platform}: no such backend here ({e})",
                file=sys.stderr,
            )
            return 2

    from art_tpu.models import SCENES, build_scene, scene_defaults
    from art_tpu.render.renderer import RenderConfig, render_scene
    from art_tpu.utils.ppm import write_png, write_ppm

    if args.list_scenes:
        print("\n".join(sorted(SCENES)))
        return 0

    if args.scene not in SCENES:
        print(
            f"error: unknown scene {args.scene!r}; use --list-scenes",
            file=sys.stderr,
        )
        return 2
    for flag, val in (("--nx", args.nx), ("--ny", args.ny), ("--spp", args.spp)):
        if val is not None and val <= 0:
            print(f"error: {flag} must be a positive integer", file=sys.stderr)
            return 2

    defaults = scene_defaults(args.scene)
    nx = args.nx if args.nx is not None else defaults["nx"]
    ny = args.ny if args.ny is not None else defaults["ny"]
    spp = args.spp if args.spp is not None else defaults["spp"]

    scene = build_scene(args.scene, nx, ny)
    cfg = RenderConfig(
        nx=nx, ny=ny, spp=spp, max_depth=args.max_depth,
        gamma=args.gamma, seed=args.seed,
    )
    print(
        f"Rendering {args.scene} at {nx}x{ny} spp={spp} depth={args.max_depth}",
        file=sys.stderr,
    )
    if args.sharded:
        from art_tpu.parallel import render_scene_sharded

        fb, stats = render_scene_sharded(
            scene, cfg, checkpoint_path=args.checkpoint
        )
    else:
        fb, stats = render_scene(
            scene, cfg, verbose=args.verbose, checkpoint_path=args.checkpoint
        )
    print(
        f"took {stats['seconds']:.3f} seconds. "
        f"{stats['mrays_per_sec']:.2f} Mrays/s",
        file=sys.stderr,
    )

    if args.out == "-":
        write_ppm(fb, sys.stdout, clamp=args.clamp)
    else:
        with open(args.out, "w") as f:
            write_ppm(fb, f, clamp=args.clamp)

    if args.png:
        write_png(fb, args.png)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
