"""bevyray_tpu_torch — the PyTorch + CUDA port of bevyray_tpu for one NVIDIA H100.

The JAX package ``bevyray_tpu`` stays the reference; this package imports
torch and never jax. Public surface so far:

    from bevyray_tpu_torch import (Renderer, FusedRenderer,
                                   ProgressiveRenderer, AdaptiveRenderer,
                                   RenderConfig, World, rtiow, Transform,
                                   StandardMaterial, ...)

Views are in ``engine.views``, sharded frames in ``parallel.sharding``, the
BVH in ``bvh``, the denoiser in ``engine.denoise``; the command line is
``python -m bevyray_tpu_torch.app.cli`` (script ``bevyray-tpu-torch``).
"""

from .core.types import CameraState, RenderConfig, SceneBuffers
from .core.vec import Vec3
from .engine.adaptive import AdaptiveRenderer
from .engine.film import ProgressiveRenderer
from .engine.fused_renderer import FusedRenderer
from .engine.renderer import FrameResult, Renderer
from .scene.components import (PerspectiveProjection, RaytracedCamera,
                               RaytracedMesh, RaytracedSphere, Raytracing,
                               StandardMaterial, Transform, cube_mesh)
from .scene.world import World
from .scene import rtiow

__all__ = [
    "AdaptiveRenderer", "CameraState", "FrameResult", "FusedRenderer",
    "PerspectiveProjection", "ProgressiveRenderer", "RaytracedCamera",
    "RaytracedMesh", "RaytracedSphere", "Raytracing", "RenderConfig",
    "Renderer", "SceneBuffers", "StandardMaterial", "Transform", "Vec3", "World",
    "cube_mesh", "rtiow",
]

__version__ = "0.1.0"
