"""Scene tables, camera uniforms and the static render configuration.

Counterpart of ``bevyray_tpu/core/types.py``: the same three logical tables
(spheres, materials, triangles) as structure-of-arrays tensors padded to lane
multiples, and the same ``RenderConfig`` fields, defaults and validation, so a
configuration written for the JAX package means the same thing here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .vec import Vec3

LANE = 128  # scene tables are padded to a multiple of this (the JAX package's).


class Spheres(NamedTuple):
    """Analytic sphere table (reference ``Model``: extract.rs:213-218)."""

    cx: torch.Tensor          # [S] f32 centers
    cy: torch.Tensor
    cz: torch.Tensor
    radius: torch.Tensor      # [S] f32
    material_id: torch.Tensor  # [S] i32
    valid: torch.Tensor       # [S] bool — False for padding lanes

    @property
    def capacity(self) -> int:
        return self.cx.shape[0]

    def center(self) -> Vec3:
        return Vec3(self.cx, self.cy, self.cz)


class Materials(NamedTuple):
    """Material table (reference ``RaytraceMaterial``: extract.rs:181-189)."""

    base_r: torch.Tensor
    base_g: torch.Tensor
    base_b: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    reflectance: torch.Tensor
    ior: torch.Tensor
    specular_transmission: torch.Tensor
    emissive_r: torch.Tensor
    emissive_g: torch.Tensor
    emissive_b: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.base_r.shape[0]

    def base_color(self) -> Vec3:
        return Vec3(self.base_r, self.base_g, self.base_b)


class Triangles(NamedTuple):
    """World-space triangle table (extension), SoA of vertex components."""

    ax: torch.Tensor
    ay: torch.Tensor
    az: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    bz: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    material_id: torch.Tensor  # i32
    valid: torch.Tensor        # bool

    @property
    def capacity(self) -> int:
        return self.ax.shape[0]


class BvhNodes(NamedTuple):
    """Flattened BVH2 (reference ``BVHNode``: extract.rs:229-237, wgsl:79-87).

    ``index`` is the first model index when ``count > 0`` (leaf), else the first of
    two adjacent children. ``n_nodes`` is the live prefix length (arrays are padded).
    """

    min_x: torch.Tensor
    min_y: torch.Tensor
    min_z: torch.Tensor
    max_x: torch.Tensor
    max_y: torch.Tensor
    max_z: torch.Tensor
    index: torch.Tensor    # i32
    count: torch.Tensor    # i32
    n_nodes: torch.Tensor  # 0-d i32
    # Multi-prim leaves (obvhs model_count, wgsl:311): leaf k's ORIGINAL prim
    # id is prim_ids[index + k] — an indirection instead of the reference's
    # model-array reorder, so primitive tables stay in extraction order.
    # None for 1-prim-leaf trees, where index is the prim id directly.
    prim_ids: Optional[torch.Tensor] = None  # i32, padded


class SphereWalk(NamedTuple):
    """The sphere BVH laid out for the CUDA walk (``kernels/cuda/csrc/
    wavefront.cu`` K3), built from ``bvh`` and ``spheres`` by
    :func:`make_sphere_walk`; the port's own, with no JAX counterpart.

    ``nodes`` is int32 ``[n_nodes, 16]``: for an inner node (count 0) the
    float32 bits of its children's boxes, ``clamp(index, 0, n - 1)`` then
    ``clamp(index + 1, 0, n - 1)`` (min xyz, max xyz each); for a leaf
    (count > 0) the bits of its first slot's sphere row ``(cx, cy, cz, r)``
    and 8 zeros; then ``(count, index, the first slot's prim id, 0)``. A
    node of negative count holds its inner layout, which the walk never
    reads. ``rows`` (float32 ``[slots, 4]``) and ``prims`` (int32
    ``[slots]``) give each leaf slot's sphere row and prim id: slot ``s``
    is ``prim_ids[s]`` clamped to the sphere table, or sphere ``s`` when
    the tree has no ``prim_ids``. A leaf's slot ``k`` is ``clamp(index +
    k, 0, slots - 1)``, so its first is ``clamp(index, 0, slots - 1)``, as
    the plain walk resolves them."""

    nodes: torch.Tensor   # [n_nodes, 16] i32
    rows: torch.Tensor    # [slots, 4] f32
    prims: torch.Tensor   # [slots] i32


class SceneBuffers(NamedTuple):
    """The device scene, field for field the JAX package's layout, and
    ``sphere_walk``, the port's layout of ``bvh`` for its CUDA walk, built
    with it (:func:`make_sphere_walk`; a scene whose ``spheres`` or ``bvh``
    is replaced or edited needs a new one). ``bvh``, ``sphere_walk`` and
    ``tri_bvh`` are None for a scene extracted without a BVH."""

    spheres: Spheres
    materials: Materials
    bvh: Optional[BvhNodes] = None
    triangles: Optional[Triangles] = None
    tri_bvh: Optional[BvhNodes] = None
    sphere_walk: Optional[SphereWalk] = None


class CameraState(NamedTuple):
    """Per-frame camera uniforms (reference ``CameraExtract``: extract.rs:83-97),
    each a 0-d float32 tensor."""

    position: Vec3
    direction: Vec3   # unit forward
    up: Vec3          # unit up
    fov: torch.Tensor      # vertical fov, radians
    near: torch.Tensor
    far: torch.Tensor
    aspect: torch.Tensor   # width / height
    aperture: torch.Tensor       # thin-lens diameter; 0 = pinhole
    focus_distance: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings, field for field the JAX package's.

    Mirrors ``RaytracedCamera { level, sample_count, bounces }`` (mod.rs:86-91)
    plus the framebuffer size. The ``pallas_*`` knobs keep their names: on the
    JAX package they pick value-identical schedules of its TPU kernel, and the
    port's fused renderer maps them onto the one path it has
    (:class:`..engine.fused_renderer.FusedRenderer`).
    """

    width: int
    height: int
    samples_per_pixel: int = 4   # main.rs:68
    bounces: int = 4             # main.rs:69
    level: int = 2               # Raytracing::FallbackRaytraced (main.rs:67)
    sphere_chunk: int = 512      # spheres per inner block in the brute path
    intersect_backend: str = "auto"  # "auto" | "brute" | "bvh"
    defocus: bool = False        # thin-lens blur (uses cam.aperture/focus_distance)
    diffuse_sampling: str = "reference"  # "reference" | "cosine"
    pallas_intersect: str = "auto"   # "auto" | "grouped" | "candidates"
    pallas_primary: str = "auto"     # "auto" | "split" | "off"
    # Sphere-test discriminant handling: True lets sqrt(disc < 0) = NaN fail
    # both accept compares instead of an explicit disc >= 0 test — the same
    # accept set either way.
    pallas_fast_disc: bool = True
    pallas_cand_size: int = 0
    pallas_grouping: str = "kd"      # "kd" | "morton" sphere-table order
    bvh_leaf_size: int = 1

    def __post_init__(self):
        if self.width < 1 or self.height < 1:
            raise ValueError(f"frame size {self.width}x{self.height} must be "
                             "at least 1x1")
        if self.samples_per_pixel < 1:
            raise ValueError(f"samples_per_pixel {self.samples_per_pixel} "
                             "must be >= 1")
        if self.bounces < 0:
            raise ValueError(f"bounces {self.bounces} must be >= 0")
        if self.level not in (0, 1, 2, 3):
            raise ValueError(f"level {self.level} must be one of 0..3 "
                             "(Raytracing enum)")
        if self.sphere_chunk < 1:
            raise ValueError(f"sphere_chunk {self.sphere_chunk} must be >= 1")
        if self.bvh_leaf_size < 1:
            raise ValueError(f"bvh_leaf_size {self.bvh_leaf_size} must be "
                             ">= 1")
        if self.pallas_cand_size % 8 or self.pallas_cand_size < 0:
            raise ValueError(f"pallas_cand_size {self.pallas_cand_size} must "
                             "be a non-negative multiple of 8 (0 = auto)")
        for field, allowed in (("intersect_backend", ("auto", "brute", "bvh")),
                               ("diffuse_sampling", ("reference", "cosine")),
                               ("pallas_intersect",
                                ("auto", "grouped", "candidates")),
                               ("pallas_primary", ("auto", "split", "off")),
                               ("pallas_grouping", ("kd", "morton"))):
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"{field}={v!r} must be one of {allowed}")

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when it is None. The port's entry points
    run on the card unless the caller asks for the CPU: without a card, None
    raises instead of falling back."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device=\"cpu\" to run its plain PyTorch versions on the CPU")
    return torch.device("cuda")


def upload(array: np.ndarray, device) -> torch.Tensor:
    """``array`` as a tensor on ``device``; on the CPU it shares the array's
    memory. On a card the copy is queued from pinned memory: a copy from
    pageable memory would wait for all the work queued on the card before
    it, as JAX's transfer of a host array does not. The tensor keeps
    ``array`` as its host copy (:func:`host_array`), which must not change
    after."""
    if device is None or torch.device(device).type != "cuda":
        return torch.as_tensor(array, device=device)
    t = torch.from_numpy(np.ascontiguousarray(array)).pin_memory()
    t = t.to(device, non_blocking=True)
    t.host_copy = array
    return t


def host_array(t: torch.Tensor) -> np.ndarray:
    """The values of ``t`` on the host: the array it was uploaded from
    (:func:`upload`) if it has one, else a copy, which on a card waits for
    all the work queued there."""
    host = getattr(t, "host_copy", None)
    return host if host is not None else t.detach().cpu().numpy()


def upload_scalars(values: np.ndarray, device) -> list:
    """0-d tensors on ``device`` holding ``values`` (a 1-d array), from one
    :func:`upload`; each keeps its own value as its host copy."""
    row = upload(values, device)
    out = [row[i] for i in range(values.shape[0])]
    if row.device.type == "cuda":
        for v, host in zip(out, values):
            v.host_copy = host
    return out


def camera_leaves(cam: "CameraState") -> tuple:
    """The camera's 0-d tensors in the JAX package's ``jax.tree.leaves``
    order."""
    return (*cam.position, *cam.direction, *cam.up, *cam[3:])


def camera_key(cam: "CameraState") -> tuple:
    """Every value of the camera as Python floats, in
    :func:`camera_leaves` order (the accumulating renderers' reset key, also
    saved in an adaptive checkpoint): from their host copies where every
    leaf has one (:func:`upload_scalars`), else from one copy."""
    leaves = camera_leaves(cam)
    hosts = [getattr(v, "host_copy", None) for v in leaves]
    if all(h is not None for h in hosts):
        return tuple(float(h) for h in hosts)
    return tuple(torch.stack([torch.as_tensor(v, dtype=torch.float32)
                              for v in leaves]).cpu().tolist())


def host_camera(cam: "CameraState") -> "CameraState":
    """``cam`` with Python floats for leaves (:func:`camera_key`), for the
    host code that reads camera values."""
    k = camera_key(cam)
    return CameraState(Vec3(*k[0:3]), Vec3(*k[3:6]), Vec3(*k[6:9]), *k[9:])


def pad_to(n: int, multiple: int = LANE) -> int:
    return int(-(-n // multiple) * multiple)


def make_spheres_np(centers: np.ndarray, radii: np.ndarray,
                    material_ids: np.ndarray, capacity: Optional[int] = None,
                    device=None) -> Spheres:
    """Padded sphere table from host arrays. Padding lanes get ``valid=False``
    and are parked far away with zero radius so arithmetic on them stays finite."""
    n = centers.shape[0]
    cap = capacity or pad_to(max(n, 1))
    if cap < n:
        raise ValueError(f"capacity {cap} < sphere count {n}")

    def pad(a, fill, dtype):
        out = np.full((cap,), fill, dtype)
        out[:n] = a.astype(dtype)
        return upload(out, device)

    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return Spheres(
        cx=pad(centers[:, 0], 1e6, np.float32),
        cy=pad(centers[:, 1], 1e6, np.float32),
        cz=pad(centers[:, 2], 1e6, np.float32),
        radius=pad(radii, 0.0, np.float32),
        material_id=pad(material_ids, 0, np.int32),
        valid=upload(valid, device),
    )


def make_triangles_np(verts_a: np.ndarray, verts_b: np.ndarray,
                      verts_c: np.ndarray, material_ids: np.ndarray,
                      capacity: Optional[int] = None, device=None) -> Triangles:
    """[T,3] per-corner world-space vertex arrays -> padded triangle table."""
    n = verts_a.shape[0]
    cap = capacity or pad_to(max(n, 1))
    if cap < n:
        raise ValueError(f"capacity {cap} < triangle count {n}")

    def pad_f(a):
        out = np.full((cap,), 1e6, np.float32)
        out[:n] = a.astype(np.float32)
        return upload(out, device)

    mid = np.zeros((cap,), np.int32)
    mid[:n] = material_ids.astype(np.int32)
    valid = np.zeros((cap,), bool)
    valid[:n] = True
    return Triangles(
        *(pad_f(v[:, k]) for v in (verts_a, verts_b, verts_c) for k in range(3)),
        material_id=upload(mid, device), valid=upload(valid, device))


def make_materials_np(table: np.ndarray, capacity: Optional[int] = None,
                      device=None) -> Materials:
    """``table``: [M, 11] float32 columns (base_r,g,b, metallic, roughness,
    reflectance, ior, specular_transmission, emissive_r,g,b)."""
    m = table.shape[0]
    cap = capacity or pad_to(max(m, 1))
    out = np.zeros((cap, 11), np.float32)
    out[:m] = table.astype(np.float32)
    return Materials(*(upload(out[:, i].copy(), device) for i in range(11)))


def make_sphere_walk(spheres: Spheres, bvh: BvhNodes) -> SphereWalk:
    """The :class:`SphereWalk` of ``bvh`` over ``spheres``, on their device,
    by torch operations (a few kernels on a card): build it once with the
    tables, as :meth:`..scene.world.World.extract` does."""
    n = bvh.min_x.shape[0]
    dev = bvh.min_x.device
    cap = spheres.cx.shape[0]
    index = bvh.index.long()
    ids = bvh.prim_ids
    if ids is None or ids.numel() == 0:
        prims = torch.arange(cap, dtype=torch.int32, device=dev)
    else:
        prims = ids.long().clamp(0, cap - 1).to(torch.int32)
    rows = torch.stack([spheres.cx, spheres.cy, spheres.cz, spheres.radius],
                       dim=1)[prims.long()]
    box = torch.stack([bvh.min_x, bvh.min_y, bvh.min_z, bvh.max_x, bvh.max_y,
                       bvh.max_z], dim=1)
    inner = torch.cat([box[index.clamp(0, n - 1)],
                       box[(index + 1).clamp(0, n - 1)]], dim=1)
    first = index.clamp(0, prims.shape[0] - 1)
    leaf = torch.cat([rows[first], torch.zeros((n, 8), dtype=torch.float32,
                                               device=dev)], dim=1)
    geometry = torch.where((bvh.count > 0)[:, None], leaf, inner)
    meta = torch.stack([bvh.count.to(torch.int32), bvh.index.to(torch.int32),
                        prims[first], torch.zeros_like(prims[first])], dim=1)
    nodes = torch.cat([geometry.view(torch.int32), meta], dim=1)
    return SphereWalk(nodes.contiguous(), rows.contiguous(),
                      prims.contiguous())


def scene_from_numpy(scene, cam, device=None):
    """The JAX package's ``SceneBuffers`` and ``CameraState``, given with numpy
    leaves (``np.asarray`` of each), as the port's ``(SceneBuffers,
    CameraState)`` on ``device`` (None: the CUDA card, see
    :func:`resolve_device`).

    Field names and layouts are the same in both packages, so each leaf is
    carried over as it is, the BVH tables (``n_nodes`` a scalar, ``prim_ids``
    only for multi-prim leaves) among them; a sphere BVH gets its
    ``sphere_walk`` (:func:`make_sphere_walk`).
    """
    device = resolve_device(device)

    def t(v):
        return torch.as_tensor(np.array(v), device=device)

    def table(cls, src):
        return None if src is None else cls(
            *(None if getattr(src, f) is None else t(getattr(src, f))
              for f in cls._fields))

    def vec(v):
        return Vec3(t(v.x), t(v.y), t(v.z))

    spheres, bvh = table(Spheres, scene.spheres), table(BvhNodes, scene.bvh)
    buffers = SceneBuffers(spheres=spheres,
                           materials=table(Materials, scene.materials),
                           bvh=bvh,
                           triangles=table(Triangles, scene.triangles),
                           tri_bvh=table(BvhNodes, scene.tri_bvh),
                           sphere_walk=None if bvh is None
                           else make_sphere_walk(spheres, bvh))
    camera = CameraState(
        position=vec(cam.position), direction=vec(cam.direction),
        up=vec(cam.up),
        **{f: t(getattr(cam, f)) for f in CameraState._fields[3:]})
    return buffers, camera
