"""Scene inspection and picking — headless analogs of the reference's editor glue.

A copy of ``bevyray_tpu/app/inspector.py`` against the port's ``World``
(host-side NumPy; the same strings and ids). The reference ships an egui
world inspector, mouse picking, and transform gizmos (main.rs:34-45,243-271
— SURVEY.md C14). On a headless box the equivalents are programmatic:

- :func:`describe` — the inspector: a table of every entity and its components;
- :func:`pick` — mouse picking: pixel → entity id via an analytic ray cast against
  the *true* spheres (the reference needs a picking-mesh radius sync hack,
  main.rs:265-271; we cast against the analytic spheres directly so there is
  nothing to sync);
- transforms are edited through ``World.set_translation`` / ``set_radius`` /
  ``set_material`` (the gizmo analog), which dirty-track extraction.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..scene.world import World


def pick(world: World, px: float, py: float, width: int, height: int) -> Optional[int]:
    """Entity id of the sphere under pixel (px, py), or None.

    Uses the same camera model as rendering (raytrace.wgsl:139-156, no jitter) and
    the same near-root-only hit semantics, so picking always agrees with the image.
    """
    t = world.camera_transform
    p = world.projection
    aspect = width / height

    ndc_x = ((px + 0.5) / width) * 2.0 - 1.0
    ndc_y = 1.0 - ((py + 0.5) / height) * 2.0
    fwd = np.asarray(t.forward, np.float64)
    up = np.asarray(t.up, np.float64)
    right = np.cross(fwd, up)
    scale = math.tan(p.fov * 0.5)
    d = fwd + ndc_x * aspect * scale * right + ndc_y * scale * up
    d /= np.linalg.norm(d)
    o = np.asarray(t.translation, np.float64)

    centers, radii, _, _ = world.extract_host()
    if len(radii) == 0:
        return None
    oc = centers.astype(np.float64) - o
    h = oc @ d
    c = (oc * oc).sum(1) - radii.astype(np.float64) ** 2
    disc = h * h - c
    ok = disc >= 0
    tt = np.where(ok, h - np.sqrt(np.maximum(disc, 0.0)), -1.0)
    ok &= tt > 1e-3
    if not ok.any():
        return None
    tt = np.where(ok, tt, np.inf)
    # Map back to entity ids (extract_host skips despawned entities).
    live = [i for i, alive in enumerate(world._alive) if alive]
    return live[int(np.argmin(tt))]


def describe(world: World) -> str:
    """Human-readable entity/component table (the world-inspector analog)."""
    lines = [f"World: {world.n_spheres} live spheres, revision {world.revision}"]
    t, p, c = world.camera_transform, world.projection, world.camera
    lines.append(
        f"Camera: pos={t.translation} fwd={tuple(round(v, 3) for v in t.forward)} "
        f"fov={p.fov:.3f} near={p.near} far={p.far} level={c.level.name} "
        f"spp={c.sample_count} bounces={c.bounces}")
    for eid, (tr, sp, mat, alive) in enumerate(
            zip(world._transforms, world._spheres, world._materials, world._alive)):
        if not alive:
            continue
        kind = ("metal" if mat.metallic > 0.5
                else "glass" if mat.specular_transmission > 0.5 else "diffuse")
        lines.append(
            f"  [{eid}] sphere r={sp.radius:g} at {tr.translation} "
            f"{kind} base={tuple(round(v, 3) for v in mat.base_color)} "
            f"rough={mat.perceptual_roughness:g}")
    return "\n".join(lines)
