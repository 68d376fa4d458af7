"""Entry ``wavefront``: ``Renderer`` (the CLI's default backend) at its
defaults: the "auto" intersect backend, the exact draws, its only ones. It
has no per-camera host work."""

from __future__ import annotations

from bevyray_tpu_torch import Renderer

DRAWS = "exact"


class Entry:
    def __init__(self, config, scene, device):
        self.renderer = Renderer(config)
        self.scene(scene)

    def scene(self, scene):
        self.buffers = scene

    def camera(self, cam, pose):
        pass

    def render(self, cam, raster_color, raster_depth, seed):
        return self.renderer.render(self.buffers, cam, seed, raster_color,
                                    raster_depth)

    def check(self):
        pass
