"""Build and render a scene that exists nowhere in the reference.

Demonstrates the full scene DSL (docs/API.md): motion blur, hollow glass,
emissive quads, checker/marble textures, nested Translate/RotateY
transforms, a smoke medium with a Group boundary, and the renderer API.

    python examples/custom_scene.py [--out scene.ppm] [--spp 64] [--platform cpu]
"""

import argparse
import os
import sys

# Make `python examples/custom_scene.py` work from any cwd without an
# installed package: the repo root (this file's parent's parent) hosts
# art_tpu/.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from art_tpu.render.renderer import RenderConfig, render_scene
from art_tpu.scene.builder import SceneBuilder
from art_tpu.scene.materials import (
    Dielectric,
    DiffuseLight,
    Lambertian,
    Metal,
)
from art_tpu.scene.objects import (
    Box,
    ConstantMedium,
    Group,
    Quad,
    RotateY,
    Sphere,
    Translate,
)
from art_tpu.scene.textures import Checker, NoiseTexture, SolidColor
from art_tpu.utils.ppm import write_png, write_ppm


def build(aspect: float):
    ground = Lambertian(
        Checker(2.0, SolidColor((0.05, 0.05, 0.08)), SolidColor((0.9, 0.9, 0.9)))
    )
    marble = Lambertian(NoiseTexture(2.0))
    mirror = Metal((0.9, 0.9, 0.95), fuzz=0.02)

    # hollow glass shell: outer r=1.0, inner r=-0.9 (negative = inward normals)
    glass_shell = Group(
        Sphere((0.0, 1.0, 0.0), 1.0, Dielectric(1.5)),
        Sphere((0.0, 1.0, 0.0), -0.9, Dielectric(1.5)),
    )

    # a rotated, translated mirrored box column
    column = Translate(RotateY(Box((-0.5, 0.0, -0.5), (0.5, 2.4, 0.5), mirror), 25.0), (3.0, 0.0, -1.0))

    # smoke inside a two-box Group boundary (general medium path)
    smoke = ConstantMedium(
        Group(
            Box((-4.5, 0.0, -1.0), (-2.5, 1.4, 1.0), Lambertian((1, 1, 1))),
            Box((-3.9, 1.4, -0.4), (-3.1, 2.2, 0.4), Lambertian((1, 1, 1))),
        ),
        density=0.6,
        tex_or_color=(0.75, 0.75, 0.8),
    )

    # motion-blurred marble ball arcing over the glass
    mover = Sphere((-1.2, 2.6, 1.4), 0.35, marble, center2=(-0.6, 3.0, 1.4))

    light = DiffuseLight((6.0, 5.6, 5.2))

    return (
        SceneBuilder()
        .set_name("example_custom")
        .add(
            Sphere((0.0, -1000.0, 0.0), 1000.0, ground),
            glass_shell,
            column,
            smoke,
            mover,
            Quad((-2.0, 5.0, -2.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), light, inward=True),
            Sphere((-2.2, 0.7, 2.2), 0.7, marble),
        )
        .set_background((0.02, 0.02, 0.04))
        .set_camera(
            lookfrom=(7.5, 3.2, 7.5),
            lookat=(-0.3, 1.1, 0.0),
            vup=(0, 1, 0),
            vfov_degrees=32.0,
            aspect=aspect,
            aperture=0.08,
            focus_dist=10.5,
            time0=0.0,
            time1=1.0,
        )
        .compile()
    )


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nx", type=int, default=480)
    ap.add_argument("--ny", type=int, default=270)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="-")
    ap.add_argument("--png", default=None)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"))
    args = ap.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    scene = build(args.nx / args.ny)
    fb, stats = render_scene(
        scene, RenderConfig(nx=args.nx, ny=args.ny, spp=args.spp), verbose=True
    )

    if args.png:
        write_png(fb, args.png)
        print(f"wrote {args.png}", file=sys.stderr)
    if args.out == "-":
        write_ppm(fb, sys.stdout)
    else:
        with open(args.out, "w") as f:
            write_ppm(fb, f)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
