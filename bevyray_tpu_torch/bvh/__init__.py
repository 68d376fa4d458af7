"""BVH subsystem: host-side PLOC builder (C++ with NumPy fallback) + flattener.

Counterpart of ``bevyray_tpu/bvh``; replaces the reference's ``obvhs`` Rust
crate (extract.rs:12,316-321). The flat tables go to a torch device.
"""

from .build import (build_bvh_from_aabbs, build_scene_bvh,  # noqa: F401
                    build_triangle_bvh)
