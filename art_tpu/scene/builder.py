"""Scene compiler: DSL object graph -> flat SoA SceneTables.

The replacement for the reference's device-side world construction
(``create_world_*<<<1,1>>>`` kernels building object graphs with device
``new``, reference src/main.cu:160-635): the scene is built on host, all
instancing transforms are baked (translate/rotate_y chains are affine), and
geometry/materials/textures flatten into integer-tagged tables.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from art_tpu.core.camera import Camera, make_camera
from art_tpu.scene import materials as M
from art_tpu.scene import objects as O
from art_tpu.scene import textures as X
from art_tpu.scene.tables import MatType, SceneTables, TexType, empty_tables
from art_tpu.utils.images import ImageAtlas, asset_path, load_image_rgb


def _rot_y(theta: float, p: np.ndarray) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array(
        [c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]], np.float64
    )


@dataclasses.dataclass
class _Xform:
    """Accumulated affine map: world = R_y(theta) * local + offset."""

    theta: float = 0.0
    offset: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float64)
    )

    def apply_point(self, p) -> np.ndarray:
        return _rot_y(self.theta, np.asarray(p, np.float64)) + self.offset

    def apply_vector(self, v) -> np.ndarray:
        return _rot_y(self.theta, np.asarray(v, np.float64))


@dataclasses.dataclass(frozen=True)
class CompiledScene:
    tables: SceneTables
    camera: Camera
    background: tuple
    gradient_bg: bool
    name: str = "scene"


class SceneBuilder:
    def __init__(self):
        self._objects: list[O.SceneObject] = []
        self._camera: Camera | None = None
        self._background = (0.0, 0.0, 0.0)
        self._gradient_bg = False
        self._name = "scene"

    # ---- construction API ----
    def add(self, *objs: O.SceneObject) -> "SceneBuilder":
        self._objects.extend(objs)
        return self

    def set_camera(self, **kwargs) -> "SceneBuilder":
        self._camera = make_camera(**kwargs)
        return self

    def set_background(self, color=(0, 0, 0), gradient: bool = False) -> "SceneBuilder":
        self._background = tuple(float(c) for c in color)
        self._gradient_bg = bool(gradient)
        return self

    def set_name(self, name: str) -> "SceneBuilder":
        self._name = name
        return self

    # ---- compilation ----
    def compile(self) -> CompiledScene:
        if self._camera is None:
            raise ValueError("scene has no camera; call set_camera(...)")

        comp = _Compiler()
        for obj in self._objects:
            comp.visit(obj, _Xform(), material_override=None)
        tables = comp.finish()
        return CompiledScene(
            tables=tables,
            camera=self._camera,
            background=self._background,
            gradient_bg=self._gradient_bg,
            name=self._name,
        )


class _Compiler:
    def __init__(self):
        self.spheres: list[tuple] = []  # (c0, vel, radius, mat_id)
        self.quads: list[tuple] = []  # (q, u, v, mat_id, inward)
        self.boxes: list[tuple] = []  # (bmin, bmax, cos, sin, off, mat_id)
        self.media: list[tuple] = []  # (kind, params..., neg_inv_density, mat_id)
        # kind-2 (general) medium boundary primitives, tagged by medium idx
        self.gb_sph: list[tuple] = []  # (med, c0, vel, radius)
        self.gb_quad: list[tuple] = []  # (med, q, u, v)
        self.gb_box: list[tuple] = []  # (med, bmin, bmax, cos, sin, off)
        self._in_boundary = False
        self.mats: list[dict] = []
        self.texs: list[dict] = []
        self.images: list[np.ndarray] = []
        self._mat_ids: dict[int, int] = {}
        self._tex_ids: dict[int, int] = {}
        self._img_ids: dict[int, int] = {}
        # value-dedup maps: identical parameter rows share one table row so
        # the per-ray lookup tables stay small enough for the one-hot row
        # fetch of ops/gather.py (e.g. bouncing_spheres builds 488 material
        # instances from ~10 distinct parameter sets)
        self._mat_rows: dict[tuple, int] = {}
        self._tex_rows: dict[tuple, int] = {}
        # The _mat_ids/_tex_ids/_img_ids caches key on id(obj); a temporary
        # object (e.g. the Isotropic phase material built per medium) that
        # gets garbage-collected lets a LATER object reuse the same id and
        # silently inherit the wrong table row.  Pin every keyed object for
        # the compiler's lifetime.
        self._keepalive: list = []

    # -- textures --
    def tex_id(self, tex: X.Texture) -> int:
        key = id(tex)
        if key in self._tex_ids:
            return self._tex_ids[key]
        self._keepalive.append(tex)
        row = dict(
            type=int(TexType.SOLID),
            rgb=(0.0, 0.0, 0.0),
            rgb2=(0.0, 0.0, 0.0),
            params=[0.0] * 8,
            child=(0, 0),
            img=0,
        )

        if isinstance(tex, X.SolidColor):
            row["type"] = int(TexType.SOLID)
            row["rgb"] = tuple(np.asarray(tex.albedo, np.float64))
        elif isinstance(tex, X.Checker):
            row["type"] = int(TexType.CHECKER)
            row["params"][0] = 1.0 / tex.scale  # inv_scale (src/texture.cuh:33)
            row["child"] = (self.tex_id(tex.even), self.tex_id(tex.odd))
        elif isinstance(tex, X.ImageTexture):
            row["type"] = int(TexType.IMAGE)
            row["img"] = self.img_id(tex.image)
        elif isinstance(tex, X.NoiseTexture):
            row["type"] = int(TexType.NOISE)
            row["params"][0] = float(tex.scale)
        elif isinstance(tex, X.NoodleTexture):
            row["type"] = int(TexType.NOODLE)
            d = np.asarray(tex.direction, np.float64)
            d = d / np.linalg.norm(d)
            row["params"][:7] = [
                float(tex.stripes_k),
                float(tex.wiggle_amp),
                float(tex.wiggle_freq),
                float(tex.octaves),
                *d.tolist(),
            ]
            row["rgb"] = tuple(np.asarray(tex.noodle, np.float64))
            row["rgb2"] = tuple(np.asarray(tex.gap, np.float64))
        elif isinstance(tex, X.FeltTexture):
            row["type"] = int(TexType.FELT)
            row["rgb"] = tuple(np.asarray(tex.base, np.float64))
            row["params"][:4] = [
                float(tex.mottling_scale),
                float(tex.mottling_amt),
                float(tex.fiber_scale),
                float(tex.fiber_amt),
            ]
        elif isinstance(tex, X.UVOffset):
            row["type"] = int(TexType.UV_OFFSET)
            row["params"][0] = float(tex.u_offset_turns)
            row["params"][1] = float(tex.v_offset)
            row["child"] = (self.tex_id(tex.base), 0)
        else:
            raise TypeError(f"unknown texture type: {type(tex)!r}")

        content = (
            row["type"], row["rgb"], row["rgb2"], tuple(row["params"]),
            row["child"], row["img"],
        )
        if content in self._tex_rows:
            idx = self._tex_rows[content]
        else:
            idx = len(self.texs)
            self.texs.append(row)
            self._tex_rows[content] = idx
        self._tex_ids[key] = idx
        return idx

    def img_id(self, image) -> int:
        if isinstance(image, str):
            name = image
            if name in self._img_ids:
                return self._img_ids[name]
            idx = len(self.images)
            self.images.append(load_image_rgb(asset_path(name)))
            self._img_ids[name] = idx
            return idx
        key = id(image)
        if key in self._img_ids:
            return self._img_ids[key]
        self._keepalive.append(image)
        idx = len(self.images)
        self.images.append(np.asarray(image, np.uint8))
        self._img_ids[key] = idx
        return idx

    # -- materials --
    def mat_id(self, mat: M.Material) -> int:
        key = id(mat)
        if key in self._mat_ids:
            return self._mat_ids[key]
        self._keepalive.append(mat)
        row = dict(type=0, tex=0, rgb=(0.0, 0.0, 0.0), fuzz=0.0, ref_idx=1.0)
        if isinstance(mat, M.Lambertian):
            row["type"] = int(MatType.LAMBERTIAN)
            row["tex"] = self.tex_id(mat.texture)
        elif isinstance(mat, M.Metal):
            row["type"] = int(MatType.METAL)
            row["rgb"] = tuple(np.asarray(mat.albedo, np.float64))
            row["fuzz"] = min(float(mat.fuzz), 1.0)  # src/material.cuh:97
        elif isinstance(mat, M.Dielectric):
            row["type"] = int(MatType.DIELECTRIC)
            row["ref_idx"] = float(mat.ref_idx)
        elif isinstance(mat, M.DiffuseLight):
            row["type"] = int(MatType.DIFFUSE_LIGHT)
            row["tex"] = self.tex_id(mat.texture)
        elif isinstance(mat, M.Isotropic):
            row["type"] = int(MatType.ISOTROPIC)
            row["tex"] = self.tex_id(mat.texture)
        else:
            raise TypeError(f"unknown material type: {type(mat)!r}")

        content = (row["type"], row["tex"], row["rgb"], row["fuzz"], row["ref_idx"])
        if content in self._mat_rows:
            idx = self._mat_rows[content]
        else:
            idx = len(self.mats)
            self.mats.append(row)
            self._mat_rows[content] = idx
        self._mat_ids[key] = idx
        return idx

    # -- objects --
    def _prim_mat(self, mat) -> int:
        """Material id for a primitive; boundary geometry is never shaded
        (the medium's phase function provides the material,
        src/constant_medium.cuh:24-28), so skip interning — a unique
        boundary material would otherwise widen mat/tex tables with dead
        rows, and a material-less boundary primitive would raise."""
        if self._in_boundary:
            return 0
        return self.mat_id(mat)

    def visit(self, obj: O.SceneObject, xf: _Xform, material_override):
        if isinstance(obj, O.Translate):
            off = xf.offset + xf.apply_vector(obj.offset)
            self.visit(obj.obj, _Xform(xf.theta, off), material_override)
        elif isinstance(obj, O.RotateY):
            theta = xf.theta + math.radians(obj.degrees)
            self.visit(obj.obj, _Xform(theta, xf.offset), material_override)
        elif isinstance(obj, O.WithMaterial):
            # Outermost override wins: the reference's with_material
            # (src/hittable.cuh:154-178) rewrites rec.mat_ptr AFTER the
            # inner hit returns, so an outer wrapper's material replaces
            # whatever an inner with_material set.
            self.visit(
                obj.obj, xf,
                material_override if material_override is not None
                else obj.material,
            )
        elif isinstance(obj, O.Sphere):
            mat = material_override or obj.material
            c0 = xf.apply_point(obj.center)
            if obj.center2 is not None:
                c1 = xf.apply_point(obj.center2)
                vel = c1 - c0
            else:
                vel = np.zeros(3)
            self.spheres.append((c0, vel, float(obj.radius), self._prim_mat(mat)))
        elif isinstance(obj, O.Quad):
            mat = material_override or obj.material
            q = xf.apply_point(obj.q)
            u = xf.apply_vector(obj.u)
            v = xf.apply_vector(obj.v)
            self.quads.append((q, u, v, self._prim_mat(mat), bool(obj.inward)))
        elif isinstance(obj, O.Box):
            mat = material_override or obj.material
            a = np.asarray(obj.a, np.float64)
            b = np.asarray(obj.b, np.float64)
            bmin = np.minimum(a, b)
            bmax = np.maximum(a, b)
            self.boxes.append(
                (bmin, bmax, math.cos(xf.theta), math.sin(xf.theta),
                 xf.offset.copy(), self._prim_mat(mat))
            )
        elif isinstance(obj, O.Group):
            for child in obj.children:
                self.visit(child, xf, material_override)
        elif isinstance(obj, O.ConstantMedium):
            if self._in_boundary:
                raise TypeError(
                    "a ConstantMedium boundary cannot contain another "
                    "ConstantMedium (the reference's boundary->hit chain "
                    "has no such nesting either, src/constant_medium.cuh:38-44)"
                )
            self._visit_medium(obj, xf)
        else:
            raise TypeError(f"unknown scene object: {type(obj)!r}")

    def _visit_medium(self, med: O.ConstantMedium, xf: _Xform):
        # Resolve the boundary subtree to a single transformed Sphere or Box.
        node = med.boundary
        inner = _Xform(xf.theta, xf.offset.copy())
        while isinstance(node, (O.Translate, O.RotateY, O.WithMaterial)):
            if isinstance(node, O.Translate):
                inner = _Xform(
                    inner.theta, inner.offset + inner.apply_vector(node.offset)
                )
                node = node.obj
            elif isinstance(node, O.RotateY):
                inner = _Xform(inner.theta + math.radians(node.degrees), inner.offset)
                node = node.obj
            else:
                node = node.obj  # material override is irrelevant to a boundary

        phase_mat = M.Isotropic(med.texture)
        mat_id = self.mat_id(phase_mat)
        nid = -1.0 / med.density  # src/constant_medium.cuh:25

        if isinstance(node, O.Sphere) and node.center2 is None:
            # Analytic static-sphere fast path.  A MOVING sphere boundary
            # must go through the general (kind-2) tables below — they carry
            # per-ray time and the velocity row; this branch would freeze
            # the medium at the t=0 center.
            c = inner.apply_point(node.center)
            self.media.append(
                dict(kind=0, center=c, radius=abs(float(node.radius)),
                     bmin=np.zeros(3), bmax=np.ones(3), cos=1.0, sin=0.0,
                     off=np.zeros(3), nid=nid, mat=mat_id)
            )
        elif isinstance(node, O.Box):
            a = np.asarray(node.a, np.float64)
            b = np.asarray(node.b, np.float64)
            self.media.append(
                dict(kind=1, center=np.zeros(3), radius=1.0,
                     bmin=np.minimum(a, b), bmax=np.maximum(a, b),
                     cos=math.cos(inner.theta), sin=math.sin(inner.theta),
                     off=inner.offset.copy(), nid=nid, mat=mat_id)
            )
        else:
            # General boundary (reference src/constant_medium.cuh:16-34
            # accepts any hittable): compile the subtree's primitives into
            # the per-medium gb tables; apply_media_p runs the reference's
            # first-hit/second-hit traversal over them brute-force.
            med_idx = len(self.media)
            saved = (self.spheres, self.quads, self.boxes)
            self.spheres, self.quads, self.boxes = [], [], []
            self._in_boundary = True
            try:
                self.visit(med.boundary, xf, None)
                bnd_sph, bnd_quad, bnd_box = self.spheres, self.quads, self.boxes
            finally:
                self.spheres, self.quads, self.boxes = saved
                self._in_boundary = False
            if not (bnd_sph or bnd_quad or bnd_box):
                raise TypeError(
                    "ConstantMedium boundary contains no geometry "
                    f"({type(med.boundary).__name__})"
                )
            for c0, vel, radius, _m in bnd_sph:
                self.gb_sph.append((med_idx, c0, vel, radius))
            for q, u, v, _m, _inward in bnd_quad:
                self.gb_quad.append((med_idx, q, u, v))
            for bmin, bmax, cos_t, sin_t, off, _m in bnd_box:
                self.gb_box.append((med_idx, bmin, bmax, cos_t, sin_t, off))
            self.media.append(
                dict(kind=2, center=np.zeros(3), radius=1.0,
                     bmin=np.zeros(3), bmax=np.ones(3), cos=1.0, sin=0.0,
                     off=np.zeros(3), nid=nid, mat=mat_id)
            )

    # -- table assembly --
    def finish(self) -> SceneTables:
        t = empty_tables()
        f32 = np.float32

        if not self.mats:
            # Scenes must have at least one material row for gathers.
            self.mat_id(M.Lambertian((0.5, 0.5, 0.5)))

        if self.spheres:
            c0 = np.stack([s[0] for s in self.spheres]).astype(f32)
            vel = np.stack([s[1] for s in self.spheres]).astype(f32)
            t.update(
                sph_center=jnp.asarray(c0),
                sph_vel=jnp.asarray(vel),
                sph_radius=jnp.asarray([s[2] for s in self.spheres], f32),
                sph_mat=jnp.asarray([s[3] for s in self.spheres], np.int32),
                n_spheres=len(self.spheres),
                has_moving=bool(np.any(vel != 0.0)),
            )

        if self.quads:
            qs = np.stack([q[0] for q in self.quads]).astype(np.float64)
            us = np.stack([q[1] for q in self.quads]).astype(np.float64)
            vs = np.stack([q[2] for q in self.quads]).astype(np.float64)
            inward = np.asarray([q[4] for q in self.quads])
            n = np.cross(us, vs)
            nn = np.sum(n * n, axis=-1, keepdims=True)
            normal = n / np.sqrt(nn)
            normal = np.where(inward[:, None], -normal, normal)  # src/quad.cuh:35
            d = np.sum(normal * qs, axis=-1)
            w = n / nn  # src/quad.cuh:38
            avec = np.cross(vs, w)  # alpha = dot(avec, p) - dot(avec, q)
            bvec = np.cross(w, us)
            t.update(
                quad_q=jnp.asarray(qs, f32),
                quad_u=jnp.asarray(us, f32),
                quad_v=jnp.asarray(vs, f32),
                quad_w=jnp.asarray(w, f32),
                quad_n=jnp.asarray(normal, f32),
                quad_d=jnp.asarray(d, f32),
                quad_mat=jnp.asarray([q[3] for q in self.quads], np.int32),
                quad_avec=jnp.asarray(avec, f32),
                quad_bvec=jnp.asarray(bvec, f32),
                quad_ca=jnp.asarray(np.sum(avec * qs, axis=-1), f32),
                quad_cb=jnp.asarray(np.sum(bvec * qs, axis=-1), f32),
                n_quads=len(self.quads),
            )

        if self.boxes:
            sins = np.asarray([b[3] for b in self.boxes], f32)
            coss = np.asarray([b[2] for b in self.boxes], f32)
            t.update(
                box_min=jnp.asarray(np.stack([b[0] for b in self.boxes]), f32),
                box_max=jnp.asarray(np.stack([b[1] for b in self.boxes]), f32),
                box_cos=jnp.asarray(coss),
                box_sin=jnp.asarray(sins),
                box_off=jnp.asarray(np.stack([b[4] for b in self.boxes]), f32),
                box_mat=jnp.asarray([b[5] for b in self.boxes], np.int32),
                n_boxes=len(self.boxes),
                # a 180-degree rotation has sin == 0 but cos == -1, so the
                # gate must consider both components
                has_rotated_boxes=bool(np.any((sins != 0.0) | (coss != 1.0))),
            )

        if self.media:
            t.update(
                med_kind=jnp.asarray([m["kind"] for m in self.media], np.int32),
                med_center=jnp.asarray(np.stack([m["center"] for m in self.media]), f32),
                med_radius=jnp.asarray([m["radius"] for m in self.media], f32),
                med_min=jnp.asarray(np.stack([m["bmin"] for m in self.media]), f32),
                med_max=jnp.asarray(np.stack([m["bmax"] for m in self.media]), f32),
                med_cos=jnp.asarray([m["cos"] for m in self.media], f32),
                med_sin=jnp.asarray([m["sin"] for m in self.media], f32),
                med_off=jnp.asarray(np.stack([m["off"] for m in self.media]), f32),
                med_neg_inv_density=jnp.asarray([m["nid"] for m in self.media], f32),
                med_mat=jnp.asarray([m["mat"] for m in self.media], np.int32),
                n_media=len(self.media),
                med_kinds=tuple(int(m["kind"]) for m in self.media),
            )

        if self.gb_sph:
            t.update(
                gb_sph=jnp.asarray(
                    [[*g[1], *g[2], g[3]] for g in self.gb_sph], f32
                ),
                gb_sph_meds=tuple(int(g[0]) for g in self.gb_sph),
            )
        if self.gb_quad:
            rows = []
            for _m, q, u, v in self.gb_quad:
                q = np.asarray(q, np.float64)
                u = np.asarray(u, np.float64)
                v = np.asarray(v, np.float64)
                n = np.cross(u, v)
                nn = float(np.dot(n, n))
                normal = n / math.sqrt(nn)
                rows.append([*q, *u, *v, *(n / nn), *normal,
                             float(np.dot(normal, q))])
            t.update(
                gb_quad=jnp.asarray(rows, f32),
                gb_quad_meds=tuple(int(g[0]) for g in self.gb_quad),
            )
        if self.gb_box:
            t.update(
                gb_box=jnp.asarray(
                    [[*g[1], *g[2], g[3], g[4], *g[5]] for g in self.gb_box],
                    f32,
                ),
                gb_box_meds=tuple(int(g[0]) for g in self.gb_box),
            )

        t.update(
            mat_type=jnp.asarray([m["type"] for m in self.mats], np.int32),
            mat_tex=jnp.asarray([m["tex"] for m in self.mats], np.int32),
            mat_rgb=jnp.asarray([m["rgb"] for m in self.mats], f32),
            mat_fuzz=jnp.asarray([m["fuzz"] for m in self.mats], f32),
            mat_ref_idx=jnp.asarray([m["ref_idx"] for m in self.mats], f32),
        )
        if self.texs:
            t.update(
                tex_type=jnp.asarray([x["type"] for x in self.texs], np.int32),
                tex_rgb=jnp.asarray([x["rgb"] for x in self.texs], f32),
                tex_rgb2=jnp.asarray([x["rgb2"] for x in self.texs], f32),
                tex_params=jnp.asarray([x["params"] for x in self.texs], f32),
                tex_child=jnp.asarray([x["child"] for x in self.texs], np.int32),
                tex_img=jnp.asarray([x["img"] for x in self.texs], np.int32),
                tex_types_present=tuple(sorted({x["type"] for x in self.texs})),
            )
        if self.images:
            t.update(atlas=ImageAtlas.pack(self.images))

        # Row-packed lookup tables (single fetch per bounce, ops/gather.py).
        mat_packed = np.zeros((len(self.mats), 8), f32)
        for i, m in enumerate(self.mats):
            mat_packed[i] = [
                m["type"], m["tex"], m["fuzz"], m["ref_idx"], *m["rgb"], 0.0
            ]
        t["mat_packed"] = jnp.asarray(mat_packed)

        if self.texs:
            tex_packed = np.zeros((len(self.texs), 18), f32)
            for i, x in enumerate(self.texs):
                tex_packed[i] = [
                    x["type"], *x["params"], *x["child"], x["img"],
                    *x["rgb"], *x["rgb2"],
                ]
            t["tex_packed"] = jnp.asarray(tex_packed)

        if self.quads:
            qa = np.zeros((len(self.quads), 16), np.float64)
            for i, (q, u, v, mid, _inward) in enumerate(self.quads):
                # w and normal recomputed the same way as the main table
                n = np.cross(u, v)
                nn = float(np.dot(n, n))
                normal = n / np.sqrt(nn)
                if _inward:
                    normal = -normal
                qa[i] = [*q, *u, *v, *(n / nn), *normal, mid]
            t["quad_attr_packed"] = jnp.asarray(qa, f32)

        if self.boxes:
            t["box_packed"] = jnp.asarray(_pack_boxes(self.boxes), f32)

        tables = SceneTables(**t)
        if tables.n_spheres >= 2:
            # Flattened escape-link sphere BVH for the opt-in per-ray
            # descent path (ART_TPU_BVH=1) — same split rule as the
            # reference's device build (src/bvh.cuh:29-84).
            from art_tpu.ops.bvh import (
                build_bvh,
                pack_bvh,
                sphere_world_bounds,
            )

            bmin, bmax = sphere_world_bounds(
                np.asarray(tables.sph_center),
                np.asarray(tables.sph_vel) if tables.has_moving
                else np.zeros_like(np.asarray(tables.sph_center)),
                np.asarray(tables.sph_radius),
            )
            tree = build_bvh(bmin, bmax)
            tables = dataclasses.replace(
                tables,
                sph_bvh=jnp.asarray(pack_bvh(tree)),
                n_sph_bvh_nodes=tree.n_nodes,
            )
        return tables


def _pack_boxes(boxes) -> np.ndarray:
    """(B, 12) winner-attribute rows [min(3) max(3) cos sin off(3) mat].

    Without rotated boxes the offsets fold into world-space min/max
    (off = 0), so the attribute pass skips the local-frame translation."""
    out = np.zeros((len(boxes), 12), np.float32)
    rotated = any(
        np.float32(b[3]) != 0.0 or np.float32(b[2]) != 1.0 for b in boxes
    )
    for i, (bmin, bmax, cos_t, sin_t, off, mid) in enumerate(boxes):
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        off = np.asarray(off, np.float32)
        if rotated:
            out[i, 0:3], out[i, 3:6], out[i, 8:11] = bmin, bmax, off
        else:
            out[i, 0:3], out[i, 3:6] = bmin + off, bmax + off
        out[i, 6], out[i, 7], out[i, 11] = cos_t, sin_t, mid
    return out
