"""ECS-lite world: entities, components, dirty-tracked extraction.

Counterpart of ``bevyray_tpu/scene/world.py``. The host side (entities,
components, the flattening into NumPy tables) is the same code; extraction
puts the tables on a torch ``device`` and caches them keyed on the world's
revision, so an unchanged scene costs no host work per frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..bvh import build_scene_bvh, build_triangle_bvh
from ..core.types import (CameraState, SceneBuffers, make_materials_np,
                          make_sphere_walk, make_spheres_np, make_triangles_np,
                          pad_to, resolve_device, upload_scalars)
from ..core.vec import Vec3
from .components import (PerspectiveProjection, RaytracedCamera, RaytracedMesh,
                         RaytracedSphere, StandardMaterial, Transform,
                         srgb_to_linear_np)


class World:
    """Holds sphere entities, mesh entities and a single raytraced camera."""

    def __init__(self) -> None:
        self._transforms: List[Transform] = []
        self._spheres: List[RaytracedSphere] = []
        self._materials: List[StandardMaterial] = []
        self._alive: List[bool] = []
        self._meshes: List[tuple] = []   # (Transform, RaytracedMesh, material, alive)
        # Raster-only entities (the reference's visible cube, main.rs:76-85):
        # input of the raster layer, never raytraced.
        self._raster: List[tuple] = []   # (Transform, RaytracedMesh, material, alive)
        self.camera_transform: Transform = Transform.from_xyz(
            0.0, 0.0, 5.0).looking_at((0.0, 0.0, 0.0))
        self.projection = PerspectiveProjection()
        self.camera = RaytracedCamera()
        self._revision = 0
        self._extract_cache: Dict = {}

    # -- mutation ---------------------------------------------------------------
    def spawn_sphere(self, transform: Transform, sphere: RaytracedSphere,
                     material: StandardMaterial) -> int:
        if not (np.isfinite(sphere.radius)
                and all(np.isfinite(v) for v in transform.translation)):
            raise ValueError(
                f"sphere center {transform.translation} / radius "
                f"{sphere.radius} must be finite (negative radii are legal — "
                "the hollow-glass trick — NaN/inf silently poisons the whole "
                "frame)")
        eid = len(self._spheres)
        self._transforms.append(transform)
        self._spheres.append(sphere)
        self._materials.append(material)
        self._alive.append(True)
        self._touch()
        return eid

    def spawn_mesh(self, transform: Transform, mesh: RaytracedMesh,
                   material: StandardMaterial) -> int:
        """Triangle-mesh entity; mesh ids live apart from sphere ids."""
        mid = len(self._meshes)
        self._meshes.append((transform, mesh, material, True))
        self._touch()
        return mid

    def spawn_raster_mesh(self, transform: Transform, mesh: RaytracedMesh,
                          material: StandardMaterial) -> int:
        """Raster-only entity (the reference's visible cube); invisible to
        the raytracer."""
        rid = len(self._raster)
        self._raster.append((transform, mesh, material, True))
        self._touch()
        return rid

    def despawn_raster_mesh(self, rid: int) -> None:
        t, m, mat, _ = self._raster[rid]
        self._raster[rid] = (t, m, mat, False)
        self._touch()

    def despawn_mesh(self, mid: int) -> None:
        t, m, mat, _ = self._meshes[mid]
        self._meshes[mid] = (t, m, mat, False)
        self._touch()

    def despawn(self, eid: int) -> None:
        self._alive[eid] = False
        self._touch()

    def set_translation(self, eid: int, xyz) -> None:
        self._transforms[eid] = Transform(
            translation=tuple(float(v) for v in xyz),
            forward=self._transforms[eid].forward, up=self._transforms[eid].up)
        self._touch()

    def set_material(self, eid: int, material: StandardMaterial) -> None:
        self._materials[eid] = material
        self._touch()

    def set_radius(self, eid: int, radius: float) -> None:
        self._spheres[eid] = RaytracedSphere(radius=radius)
        self._touch()

    def set_camera(self, transform: Transform,
                   projection: Optional[PerspectiveProjection] = None,
                   camera: Optional[RaytracedCamera] = None) -> None:
        self.camera_transform = transform
        if projection is not None:
            self.projection = projection
        if camera is not None:
            self.camera = camera
        # Camera state is rebuilt per frame anyway; no revision bump.

    def _touch(self) -> None:
        self._revision += 1

    @property
    def revision(self) -> int:
        return self._revision

    @property
    def n_spheres(self) -> int:
        return sum(self._alive)

    @property
    def n_raster(self) -> int:
        return sum(1 for *_, alive in self._raster if alive)

    # -- extraction --------------------------------------------------------------
    def extract_host(self):
        """Live spheres as host arrays: (centers [N,3], radii [N], material
        table [N,11], material ids [N]) — one material record per sphere, as
        the reference duplicates them (extract.rs:301-310)."""
        centers, radii, rows = [], [], []
        for t, s, m, alive in zip(self._transforms, self._spheres,
                                  self._materials, self._alive):
            if not alive:
                continue
            centers.append(t.translation)
            radii.append(s.radius)
            rows.append((*m.base_color, m.metallic, m.perceptual_roughness,
                         m.reflectance, m.ior, m.specular_transmission,
                         *m.emissive))
        n = len(radii)
        centers = np.asarray(centers, np.float32).reshape(n, 3)
        radii = np.asarray(radii, np.float32)
        if n:
            # float64 math and one f32 cast, bit-equal to the per-record
            # StandardMaterial.to_record.
            raw = np.asarray(rows, np.float64)
            raw[:, :3] = srgb_to_linear_np(raw[:, :3])
            mat_table = raw.astype(np.float32)
        else:
            mat_table = np.zeros((0, 11), np.float32)
        mat_ids = np.arange(n, dtype=np.int32)
        return centers, radii, mat_table, mat_ids

    def extract_meshes_host(self, first_material_id: int):
        """Live meshes as world-space corner arrays plus material records."""
        a, b, c, mids, mats = [], [], [], [], []
        next_mid = first_material_id
        for t, mesh, mat, alive in self._meshes:
            if not alive:
                continue
            v = t.apply_points(np.asarray(mesh.vertices, np.float32))
            f = np.asarray(mesh.indices, np.int32)
            a.append(v[f[:, 0]])
            b.append(v[f[:, 1]])
            c.append(v[f[:, 2]])
            mids.append(np.full(f.shape[0], next_mid, np.int32))
            mats.append(mat.to_record())
            next_mid += 1
        if not a:
            return None
        return (np.concatenate(a), np.concatenate(b), np.concatenate(c),
                np.concatenate(mids), np.stack(mats, 0))

    def extract_raster_host(self):
        """Live raster-only entities as world-space corner arrays plus
        per-triangle [linear base color, metallic, perceptual_roughness,
        reflectance] rows (what the raster layer's ambient shading reads),
        or None when there are none."""
        a, b, c, colors = [], [], [], []
        for t, mesh, mat, alive in self._raster:
            if not alive:
                continue
            v = t.apply_points(np.asarray(mesh.vertices, np.float32))
            f = np.asarray(mesh.indices, np.int32)
            a.append(v[f[:, 0]])
            b.append(v[f[:, 1]])
            c.append(v[f[:, 2]])
            colors.append(np.tile(mat.to_record()[:6], (f.shape[0], 1)))
        if not a:
            return None
        return (np.concatenate(a), np.concatenate(b), np.concatenate(c),
                np.concatenate(colors))

    def extract(self, capacity: Optional[int] = None, with_bvh: bool = True,
                bvh_leaf_size: int = 1, device=None) -> SceneBuffers:
        """Build (or fetch cached) scene tables on ``device`` (None: the CUDA
        card; without one it raises, see :func:`resolve_device`).

        ``with_bvh``: also build the sphere BVH and, for meshes, the triangle
        BVH on the host (:mod:`..bvh`), and lay the sphere BVH out for the
        CUDA walk (``sphere_walk``). ``bvh_leaf_size``: max prims per BVH
        leaf (obvhs multi-prim leaves; must match the renderer's
        ``config.bvh_leaf_size`` when the bvh backend is used).
        """
        device = resolve_device(device)
        key = (self._revision, capacity, with_bvh, bvh_leaf_size, device)
        cached = self._extract_cache.get("scene")
        if cached is not None and cached[0] == key:
            return cached[1]

        centers, radii, mat_table, mat_ids = self.extract_host()
        cap = capacity or pad_to(max(len(radii), 1))
        spheres = make_spheres_np(centers, radii, mat_ids, cap, device=device)

        triangles = None
        tri_bvh = None
        mesh_data = self.extract_meshes_host(first_material_id=len(radii))
        if mesh_data is not None:
            va, vb, vc, tri_mids, tri_mats = mesh_data
            triangles = make_triangles_np(va, vb, vc, tri_mids, device=device)
            mat_table = np.concatenate([mat_table, tri_mats], axis=0)
            if with_bvh:
                tri_bvh = build_triangle_bvh(va, vb, vc,
                                             max_leaf_size=bvh_leaf_size,
                                             device=device)

        materials = make_materials_np(
            mat_table, pad_to(max(mat_table.shape[0], cap, 1)), device=device)

        bvh = None
        if with_bvh and len(radii) > 0:
            bvh = build_scene_bvh(centers, radii, max_leaf_size=bvh_leaf_size,
                                  device=device)

        scene = SceneBuffers(spheres=spheres, materials=materials, bvh=bvh,
                             triangles=triangles, tri_bvh=tri_bvh,
                             sphere_walk=None if bvh is None
                             else make_sphere_walk(spheres, bvh))
        self._extract_cache["scene"] = (key, scene)
        return scene

    def camera_state(self, aspect: Optional[float] = None,
                     device=None) -> CameraState:
        """Per-frame camera uniforms (extract.rs:118-157) as 0-d f32 tensors
        on ``device`` (None: the CUDA card, as in :meth:`extract`)."""
        device = resolve_device(device)
        t = self.camera_transform
        p = self.projection
        fwd = np.asarray(t.forward, np.float64)
        upv = np.asarray(t.up, np.float64)
        nf, nu = np.linalg.norm(fwd), np.linalg.norm(upv)
        if not (np.all(np.isfinite(fwd)) and nf > 1e-12
                and np.all(np.isfinite(upv)) and nu > 1e-12
                and np.linalg.norm(np.cross(fwd / nf, upv / nu)) > 1e-9):
            raise ValueError(
                "camera basis is degenerate (zero, non-finite, or forward "
                "parallel to up) — looking_at() a point equal to the camera "
                "position, or along the up axis, produces no usable basis")

        # One upload; each leaf keeps its value on the host (camera_key).
        v = upload_scalars(np.array(
            [*t.translation, *t.forward, *t.up, p.fov, p.near, p.far,
             aspect if aspect is not None else p.aspect_ratio,
             self.camera.aperture, self.camera.focus_distance], np.float32),
            device)
        return CameraState(Vec3(*v[0:3]), Vec3(*v[3:6]), Vec3(*v[6:9]),
                           *v[9:])
