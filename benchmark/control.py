"""The control and the faults the comparison has been shown to catch.

Each is a wrapper of a cell's entry, as ``harness.run_cell(wrap_entry=...)``
takes it; none is used by the benchmark's own runs.

- :class:`ControlEntry`: the reference put in the program's place, traced in
  bfloat16, the precision below the configuration's float32.
- :class:`StaleEntry`: a step that returns its state unchanged (every frame
  is the first one rendered).
- :class:`HalfSamplesEntry`: half of the batch left out, the mean taken
  over the rest (a frame of half the samples a pixel).
- :class:`AlteredEntry`: an answer altered where it is produced (one pixel
  of every frame's image).

The exchange between chips does not exist in a one-chip cell.
"""

from __future__ import annotations

import dataclasses

import torch


class ControlEntry:
    def __init__(self, entry, ctx):
        from reference import path_tracer

        self.entry, self.ctx = entry, ctx
        self.render_reference = path_tracer.render
        self.pose = None

    def scene(self, buffers):
        pass

    def camera(self, cam, pose):
        self.pose = pose

    def render(self, cam, raster_color, raster_depth, seed):
        from bevyray_tpu_torch import FrameResult

        c = self.ctx["config"]
        width, height = c["resolution"]
        image, depth, segments = self.render_reference(
            self.ctx["arrays"](), self.pose, width, height,
            c["samples_per_pixel"], c["bounces"], c["level"], seed,
            self.ctx["draws"], dtype=torch.bfloat16, device=self.ctx["device"])
        dev = self.ctx["device"]
        return FrameResult(
            image=torch.as_tensor(image, device=dev).reshape(height, width, 3),
            rt_depth=torch.as_tensor(depth, device=dev).reshape(height, width),
            rays_traced=torch.tensor(segments, dtype=torch.int64, device=dev))

    def check(self):
        pass


class _Wrapper:
    def __init__(self, entry, ctx):
        self.entry, self.ctx = entry, ctx

    def scene(self, buffers):
        self.entry.scene(buffers)

    def camera(self, cam, pose):
        self.entry.camera(cam, pose)

    def check(self):
        self.entry.check()


class StaleEntry(_Wrapper):
    first = None

    def render(self, *args):
        frame = self.entry.render(*args)
        if self.first is None:
            self.first = frame
        return self.first


class HalfSamplesEntry(_Wrapper):
    def __init__(self, entry, ctx):
        super().__init__(entry, ctx)
        rc = ctx["rconfig"]
        half = dataclasses.replace(
            rc, samples_per_pixel=max(1, rc.samples_per_pixel // 2))
        self.half = ctx["make_entry"](half)

    def scene(self, buffers):
        self.half.scene(buffers)

    def camera(self, cam, pose):
        self.half.camera(cam, pose)

    def render(self, *args):
        return self.half.render(*args)

    def check(self):
        self.half.check()


class AlteredEntry(_Wrapper):
    def render(self, *args):
        frame = self.entry.render(*args)
        image = frame.image.clone()
        image[0, 0, 0] += 0.25
        return frame._replace(image=image)


FAULTS = {"stale": StaleEntry, "half_samples": HalfSamplesEntry,
          "altered": AlteredEntry}
