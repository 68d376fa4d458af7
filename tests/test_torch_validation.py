"""Twins of the JAX package's input checks and kd-order tests, held by
both packages on the same inputs (CPU, seconds):

- ``RenderConfig``'s field checks (``tests/test_validation.py:10-29``);
- ``World.spawn_sphere``'s finiteness check (``:32``);
- ``World.camera_state``'s degenerate-camera check (``:49``, ``:60``);
- the kd order's "sah" rule: the same permutation as JAX's, with the
  invariants of ``tests/test_kd_grouping.py:65``, and a rule flip on a
  live ``FusedRenderer`` that misses its prepared-scene cache
  (``tests/test_kd_grouping.py:100``; the key of ``grouping.py:104``).
"""

import numpy as np
import pytest

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.kernels.pallas import grouping as jgrouping
from bevyray_tpu_torch.kernels.cuda import grouping

PACKAGES = {"jax": jb, "port": bt}


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("kwargs,match", [
    (dict(width=0, height=64), "frame size"),
    (dict(width=64, height=-1), "frame size"),
    (dict(width=64, height=64, samples_per_pixel=0), "samples_per_pixel"),
    (dict(width=64, height=64, bounces=-1), "bounces"),
    (dict(width=64, height=64, level=4), "level"),
    (dict(width=64, height=64, sphere_chunk=0), "sphere_chunk"),
    (dict(width=64, height=64, intersect_backend="gpu"), "intersect_backend"),
    (dict(width=64, height=64, diffuse_sampling="uniform"),
     "diffuse_sampling"),
    (dict(width=64, height=64, pallas_intersect="bvh"), "pallas_intersect"),
    (dict(width=64, height=64, pallas_primary="on"), "pallas_primary"),
])
def test_bad_config_raises(pkg, kwargs, match):
    with pytest.raises(ValueError, match=match):
        PACKAGES[pkg].RenderConfig(**kwargs)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_good_config_constructs(pkg):
    PACKAGES[pkg].RenderConfig(width=64, height=64, samples_per_pixel=1,
                               bounces=0, level=0)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_bad_sphere_raises(pkg):
    p = PACKAGES[pkg]
    w = p.World()
    with pytest.raises(ValueError, match="finite"):
        w.spawn_sphere(p.Transform.from_xyz(0.0, float("nan"), 0.0),
                       p.RaytracedSphere(1.0), p.StandardMaterial())
    with pytest.raises(ValueError, match="finite"):
        w.spawn_sphere(p.Transform.from_xyz(0.0, 0.0, 0.0),
                       p.RaytracedSphere(float("inf")), p.StandardMaterial())
    # a negative radius (hollow glass) stays legal
    w.spawn_sphere(p.Transform.from_xyz(0.0, 0.0, 0.0),
                   p.RaytracedSphere(-0.5), p.StandardMaterial())
    assert w.n_spheres == 1


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("origin,target", [
    ((1.0, 2.0, 3.0), (1.0, 2.0, 3.0)),   # at its own position
    ((0.0, 0.0, 0.0), (0.0, 5.0, 0.0)),   # forward parallel to the up axis
])
def test_degenerate_camera_raises(pkg, origin, target):
    """A camera basis that cannot be built raises."""
    p = PACKAGES[pkg]
    w = p.World()
    w.camera_transform = p.Transform.from_xyz(*origin).looking_at(target)
    kw = {} if pkg == "jax" else dict(device="cpu")
    with pytest.raises(ValueError, match="degenerate"):
        w.camera_state(aspect=1.0, **kw)


def _scene_arrays(world):
    sp = world.extract(with_bvh=False).spheres
    return tuple(np.asarray(x) for x in (sp.cx, sp.cy, sp.cz, sp.radius,
                                         sp.valid))


@pytest.mark.parametrize("gc", [16, 32])
def test_kd_sah_rule_matches_jax(gc):
    """rule="sah": JAX's permutation to the element, and deterministic."""
    cx, cy, cz, radius, valid = _scene_arrays(jb.rtiow.final_scene(seed=11))
    sah = grouping.kd_order(cx, cy, cz, radius, valid, gc, rule="sah")
    np.testing.assert_array_equal(
        sah, jgrouping.kd_order(cx, cy, cz, radius, valid, gc, rule="sah"))
    np.testing.assert_array_equal(
        sah, grouping.kd_order(cx, cy, cz, radius, valid, gc, rule="sah"))


def test_kd_sah_rule_is_an_aligned_quarantined_permutation():
    """The invariants of tests/test_kd_grouping.py:65 at its group size 16:
    a permutation with the big spheres first and the padding last, whose
    total group surface area is no larger than the median rule's."""
    cx, cy, cz, radius, valid = _scene_arrays(jb.rtiow.final_scene(seed=11))
    gc = 16
    sah = grouping.kd_order(cx, cy, cz, radius, valid, gc, rule="sah")
    med = grouping.kd_order(cx, cy, cz, radius, valid, gc)
    n = cx.shape[0]
    assert sorted(sah.tolist()) == list(range(n))
    r = np.abs(radius)
    live = valid & (r > 0)
    c = np.stack([cx, cy, cz])
    ext = (c[:, live].max(1) - c[:, live].min(1)).max()
    big = live & (r > 0.25 * ext)
    n_big, n_live = int(big.sum()), int(live.sum())
    assert big[sah[:n_big]].all()
    assert not live[sah[n_live:]].any()

    def sa_total(order):
        k = n // gc
        co, rr, lv = c[:, order], r[order], live[order]
        mins = np.where(lv, co - rr, np.inf)[:, :k * gc].reshape(3, k, gc)
        maxs = np.where(lv, co + rr, -np.inf)[:, :k * gc].reshape(3, k, gc)
        d = np.clip(maxs.max(2) - mins.min(2), 0, None)
        s = d[0] * d[1] + d[1] * d[2] + d[0] * d[2]
        return float(np.where(np.isfinite(s), s, 0.0)[1:].sum())

    assert sa_total(sah) <= sa_total(med)


def test_kd_rule_flip_misses_prepared_scene_cache(monkeypatch):
    """Flipping ``grouping.KD_RULE`` on a live ``FusedRenderer`` prepares
    the scene again (another permutation of the table); flipping back
    gives the median rule's table again."""
    world = bt.rtiow.final_scene(seed=11)
    scene = world.extract(with_bvh=False, device="cpu")
    cfg = bt.RenderConfig(width=64, height=64, samples_per_pixel=1,
                          bounces=1, level=3, pallas_cand_size=16)
    r = bt.FusedRenderer(cfg, exact_rng=True)
    assert grouping.KD_RULE == "median"   # the shipped default
    med = r.prepare(scene).sph.clone()
    monkeypatch.setattr(grouping, "KD_RULE", "sah")
    sah = r.prepare(scene).sph
    assert not np.array_equal(med.numpy(), sah.numpy())
    monkeypatch.setattr(grouping, "KD_RULE", "median")
    np.testing.assert_array_equal(r.prepare(scene).sph.numpy(), med.numpy())
