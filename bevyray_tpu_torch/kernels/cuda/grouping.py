"""Host-side kd ordering of the sphere table.

Counterpart of ``bevyray_tpu/kernels/pallas/grouping.py`` (NumPy only). The
prepared table's group AABBs are unions over consecutive runs of this order;
``kd_order`` builds equal-size spatially tight clusters by recursive
widest-axis median splits aligned to the ``gc``-sphere group grid.
Oversized spheres (r > 0.25 x scene extent) lead the order, padding trails it.
The order is a pure permutation: hit results do not depend on it, except
that exact ties between two spheres go to the one earlier in the order.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ...core.types import host_array, upload

__all__ = ["kd_order", "cached_order"]

# Split rule: "median" (the JAX package's shipped rule) or "sah".
KD_RULE = "median"


def kd_order(cx, cy, cz, radius, valid, gc: int,
             rule: str | None = None) -> np.ndarray:
    """Permutation of the sphere table into equal-size spatially-tight
    clusters aligned to the ``gc``-sphere group grid."""
    rule = KD_RULE if rule is None else rule
    if rule not in ("median", "sah"):
        raise ValueError(f"kd_order rule {rule!r} must be 'median' or 'sah'")
    cx, cy, cz = (np.asarray(v, np.float32) for v in (cx, cy, cz))
    r = np.abs(np.asarray(radius, np.float32))
    live = np.asarray(valid, bool) & (r > 0)
    c = np.stack([cx, cy, cz], axis=1)
    ext = float((c[live].max(0) - c[live].min(0)).max()) if live.any() else 1.0
    big = live & (r > 0.25 * max(ext, 1e-6))
    out = list(np.flatnonzero(big))
    rest = np.flatnonzero(live & ~big)

    def sa(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 0] * d[..., 2])

    def split(idx, offset):
        # ``offset`` = global position of idx[0] in the final order; cuts are
        # aligned to the gc grid so every group is a whole cluster.
        room = (-offset) % gc or gc      # slots left in the current group
        if len(idx) <= room:
            out.extend(idx)
            return
        n = len(idx)
        if rule == "sah":
            cuts = np.arange(room, n, gc)
            best = None
            for ax in range(3):
                order_ax = idx[np.argsort(c[idx, ax], kind="stable")]
                lo = c[order_ax] - r[order_ax, None]
                hi = c[order_ax] + r[order_ax, None]
                pre_mn = np.minimum.accumulate(lo, 0)
                pre_mx = np.maximum.accumulate(hi, 0)
                suf_mn = np.minimum.accumulate(lo[::-1], 0)[::-1]
                suf_mx = np.maximum.accumulate(hi[::-1], 0)[::-1]
                cost = (cuts * sa(pre_mn[cuts - 1], pre_mx[cuts - 1])
                        + (n - cuts) * sa(suf_mn[cuts], suf_mx[cuts]))
                k = int(cost.argmin())
                if best is None or cost[k] < best[0]:
                    best = (float(cost[k]), order_ax, int(cuts[k]))
            _, order, cut = best
        else:
            ax = int(np.ptp(c[idx], axis=0).argmax())
            order = idx[np.argsort(c[idx, ax], kind="stable")]
            half = n // 2
            cut = (room + max(0, (half - room) // gc) * gc
                   if half >= room else room)
        split(order[:cut], offset)
        split(order[cut:], offset + cut)

    split(rest, len(out))
    out.extend(np.flatnonzero(~live))
    perm = np.asarray(out, np.int32)
    if perm.shape[0] != c.shape[0]:
        raise AssertionError("kd_order lost or duplicated a sphere")
    return perm


# Keyed LRU so per-frame callers don't re-sort; ``leaves`` rides in each entry
# to keep the id()-based key unique while cached.
_ORDER_CACHE: "OrderedDict" = OrderedDict()
_ORDER_CACHE_MAX = 8


def cached_order(scene, cand_size: int = 0) -> torch.Tensor:
    """The kd permutation of ``scene``'s sphere table as an int64 tensor on
    the table's device (with its host copy), built from the table's host
    copies (:func:`...core.types.host_array`) and LRU-cached on the sphere
    tensors' identities and the group size."""
    from .megakernel import auto_cand_size

    sp = scene.spheres
    key = (tuple(id(x) for x in sp), int(cand_size), KD_RULE)
    hit = _ORDER_CACHE.get(key)
    if hit is not None:
        _ORDER_CACHE.move_to_end(key)
        return hit[0]
    gc = cand_size or auto_cand_size(sp.cx.shape[0])
    host = [host_array(x) for x in (sp.cx, sp.cy, sp.cz, sp.radius, sp.valid)]
    order = upload(kd_order(*host, gc).astype(np.int64), sp.cx.device)
    _ORDER_CACHE[key] = (order, tuple(sp))
    while len(_ORDER_CACHE) > _ORDER_CACHE_MAX:
        _ORDER_CACHE.popitem(last=False)
    return order
