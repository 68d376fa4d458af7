"""Frame results.

Counterpart of the result record of ``bevyray_tpu/engine/renderer.py``. The
wavefront ``Renderer`` of that module is not ported yet (ROADMAP §A item 7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FrameResult(NamedTuple):
    image: torch.Tensor        # [H, W, 3] f32 — final composited, gamma-space
    rt_depth: torch.Tensor     # [H, W] f32 — sample-averaged first-hit distance
    rays_traced: torch.Tensor  # 0-d int64 — path segments traced this frame
