"""Multi-view rendering, the analog of the reference's per-view render-graph
node.

Counterpart of ``bevyray_tpu/engine/views.py``. The reference's
``ViewNodeRunner`` runs the raytrace node once per camera (mod.rs:53-60,
SURVEY.md C9). A ``ViewSet`` renders any number of cameras over one scene,
with one renderer per config shared by the views that use it, and each
view's own raster layer for the hybrid levels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..core.types import CameraState, RenderConfig, SceneBuffers
from ..core.vec import Vec3
from .renderer import FrameResult, Renderer


@dataclasses.dataclass
class View:
    """One camera's render setup: config, camera state and an optional
    raster layer."""

    name: str
    config: RenderConfig
    camera: CameraState
    raster_color: Optional[Vec3] = None
    raster_depth: Optional[torch.Tensor] = None


class ViewSet:
    """Render every view against one scene; view ``i`` takes frame seed
    ``seed + i``. ``renderer_cls`` builds the renderer of a config (the
    wavefront :class:`.renderer.Renderer` by default; any class with
    ``render(scene, cam, seed, raster_color=, raster_depth=)``)."""

    def __init__(self, views: List[View], renderer_cls=Renderer):
        self.views = views
        self._renderers: Dict[RenderConfig, object] = {}
        self._renderer_cls = renderer_cls

    def _renderer(self, config: RenderConfig):
        r = self._renderers.get(config)
        if r is None:
            r = self._renderer_cls(config)
            self._renderers[config] = r
        return r

    def render_all(self, scene: SceneBuffers, seed: int
                   ) -> List[Tuple[str, FrameResult]]:
        return [(v.name, self._renderer(v.config).render(
                    scene, v.camera, seed=seed + i,
                    raster_color=v.raster_color, raster_depth=v.raster_depth))
                for i, v in enumerate(self.views)]
