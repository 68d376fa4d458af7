"""Entry ``fused``: ``FusedRenderer`` at its defaults, the fast draws on the
card. Per camera the app's host work is the phase split's shortlists
(``FusedRenderer.shortlists``, cached for one camera); per scene its kernel
tables (``FusedRenderer.prepare``)."""

from __future__ import annotations

from bevyray_tpu_torch import FusedRenderer

DRAWS = "fast"


class Entry:
    def __init__(self, config, scene, device):
        # The card's default resolves to the fast draws; the plain version
        # on the CPU (the harness's tests) is asked for them.
        self.renderer = FusedRenderer(
            config, exact_rng=None if device.type == "cuda" else False)
        self.scene(scene)

    def scene(self, scene):
        self.buffers = scene
        self.kscene = self.renderer.prepare(scene)

    def camera(self, cam, pose):
        self.renderer.shortlists(self.kscene, cam)

    def render(self, cam, raster_color, raster_depth, seed):
        return self.renderer.render(self.buffers, cam, seed, raster_color,
                                    raster_depth)

    def check(self):
        if self.renderer.last_exact_rng is not False:
            raise RuntimeError("the fused entry did not run the fast draws")
