"""The wavefront renderer's ray tests (``kernels/intersect.py``,
``kernels/traverse.py``, kernels in ``kernels/cuda/csrc/wavefront.cu``) and
its masked bounce loop (``engine/renderer.py`` ``trace_sample``) against
the JAX package on the CPU.

- each wrapper on CPU tensors equals its plain version to the bit and the
  JAX package's counterpart (``bevyray_tpu.kernels.intersect`` /
  ``traverse``) on the same numpy inputs: the same index, t within the
  rounding of the near root (rtol 1e-5, as ``test_torch_renderer.py`` and
  ``test_torch_bvh.py`` hold them);
- an ``active`` mask gives the plain test's values on the active lanes and
  INF / -1 on the others, and a CPU call launches nothing;
- the masked ``trace_sample`` against JAX's at the bars of
  ``tests/test_pallas.py:24-28`` (color atol 5e-5, depth atol 1e-3,
  segments equal), dense and BVH, spheres and a mesh;
- the fused kernel's plain version (``render_tiles_reference``) runs with
  every wavefront wrapper patched to raise.

The tests marked ``cuda`` run on the card (``JAX_PLATFORMS=cpu python -m
pytest tests/test_torch_wavefront.py -m cuda``): each kernel against its
plain version on the same CUDA tensors, and ``Renderer`` frames whose
host work never waits for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu as jb
import bevyray_tpu_torch as bt
from bevyray_tpu.bvh import build as jbuild
from bevyray_tpu.core.types import make_spheres_np as jmake_spheres
from bevyray_tpu.core.types import make_triangles_np as jmake_triangles
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.engine import renderer as jrenderer
from bevyray_tpu.kernels import intersect as jint
from bevyray_tpu.kernels import traverse as jtraverse
from bevyray_tpu_torch.bvh import build as pbuild
from bevyray_tpu_torch.core.constants import INF
from bevyray_tpu_torch.core.types import (make_spheres_np, make_triangles_np,
                                          scene_from_numpy)
from bevyray_tpu_torch.core.vec import Vec3
from bevyray_tpu_torch.engine import renderer as prenderer
from bevyray_tpu_torch.kernels import intersect, traverse
from bevyray_tpu_torch.kernels.cuda import megakernel, wavefront

torch.set_num_threads(2)

N_RAYS = 1024
SIZE = dict(width=20, height=16, samples_per_pixel=1, bounces=3)


def _scene(n, seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 1.5, n).astype(np.float32)
    return centers, radii


def _tris(n, seed):
    rng = np.random.RandomState(seed)
    va = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    vb = va + rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    vc = va + rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    return va, vb, vc


def _rays(n, seed, axis_aligned=False):
    """Rays from the scene's box; every fourth one along an axis (zero
    direction components, so inf in 1 / d)."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d *= rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)   # not unit
    if axis_aligned:
        axis = rng.randint(0, 3, n)
        d[::4] = 0.0
        d[np.arange(0, n, 4), axis[::4]] = rng.choice([-1.0, 1.0], n)[::4]
    return o, d


def _pvec(a, device="cpu"):
    return Vec3(*(torch.as_tensor(a[:, i], device=device) for i in range(3)))


def _jvec(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _case(kind, device="cpu"):
    """(port wrapper call, port plain call, JAX call), each taking (o, d,
    active) numpy rays / a bool mask, for one ray test over a random
    table."""
    if kind in ("spheres", "bvh1", "bvh4"):
        centers, radii = _scene(300, seed=11)
        ps = make_spheres_np(centers, radii, np.arange(300), device=device)
        js = jmake_spheres(centers, radii, np.arange(300))
        if kind == "spheres":
            return ((intersect.intersect_spheres, (ps,), {}),
                    intersect.intersect_spheres_reference,
                    lambda o, d: jint.intersect_spheres(o, d, js))
        leaf = int(kind[-1])
        pbvh = pbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf,
                                      device=device)
        jbvh = jbuild.build_scene_bvh(centers, radii, max_leaf_size=leaf)
        return ((traverse.intersect_bvh, (ps, pbvh),
                 dict(max_leaf_size=leaf)),
                traverse.intersect_bvh_reference,
                lambda o, d: jtraverse.intersect_bvh(o, d, js, jbvh,
                                                     max_leaf_size=leaf))
    va, vb, vc = _tris(200, seed=13)
    pt = make_triangles_np(va, vb, vc, np.zeros(200, np.int32),
                           device=device)
    jt = jmake_triangles(va, vb, vc, np.zeros(200, np.int32))
    if kind == "triangles":
        return ((intersect.intersect_triangles, (pt,), {}),
                intersect.intersect_triangles_reference,
                lambda o, d: jint.intersect_triangles(o, d, jt))
    pbvh = pbuild.build_triangle_bvh(va, vb, vc, device=device)
    jbvh = jbuild.build_triangle_bvh(va, vb, vc)
    return ((traverse.intersect_bvh_triangles, (pt, pbvh), {}),
            traverse.intersect_bvh_triangles_reference,
            lambda o, d: jtraverse.intersect_bvh_triangles(o, d, jt, jbvh))


KINDS = ["spheres", "triangles", "bvh1", "bvh4", "bvh_triangles"]


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_equals_plain_and_jax(kind):
    (wrapper, args, kw), reference, jax_call = _case(kind)
    o, d = _rays(N_RAYS, seed=3, axis_aligned=True)
    before = wrapper.launches
    got = wrapper(_pvec(o), _pvec(d), *args, **kw)
    assert wrapper.launches == before   # nothing launches on the CPU
    want = reference(_pvec(o), _pvec(d), *args, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    jt, ji = (np.asarray(x) for x in jax_call(_jvec(o), _jvec(d)))
    np.testing.assert_array_equal(got[1].numpy(), ji)
    np.testing.assert_allclose(got[0].numpy(), jt, rtol=1e-5)
    assert (ji >= 0).sum() > 50


@pytest.mark.parametrize("kind", KINDS)
def test_active_lanes_get_the_plain_values(kind):
    (wrapper, args, kw), reference, _ = _case(kind)
    o, d = _rays(N_RAYS, seed=4)
    active = torch.as_tensor(np.random.RandomState(5).rand(N_RAYS) < 0.4)
    got_t, got_i = wrapper(_pvec(o), _pvec(d), *args, **kw, active=active)
    lanes = active.numpy()
    sub_t, sub_i = reference(_pvec(o[lanes]), _pvec(d[lanes]), *args, **kw)
    assert torch.equal(got_t[active], sub_t)
    assert torch.equal(got_i[active], sub_i)
    assert bool((got_t[~active] == INF).all())
    assert bool((got_i[~active] == -1).all())
    assert int((sub_i >= 0).sum()) > 10
    none = wrapper(_pvec(o), _pvec(d), *args, **kw,
                   active=torch.zeros(N_RAYS, dtype=torch.bool))
    assert bool((none[0] == INF).all()) and bool((none[1] == -1).all())


def test_wrappers_take_cpu_or_cuda_tensors_only():
    (wrapper, args, kw), _, _ = _case("spheres")
    o, d = _rays(8, seed=1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        wrapper(_pvec(o, "meta"), _pvec(d, "meta"), *args, **kw)


def _both(world, backend="brute"):
    js = world.extract(with_bvh=backend == "bvh")
    jcam = world.camera_state(aspect=SIZE["width"] / SIZE["height"])
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    return js, jcam, ps, pcam


def _mesh(pkg):
    """A blue sphere and a yellow cube mesh (tests/test_triangles.py)."""
    w = pkg.World()
    w.set_camera(pkg.Transform.from_xyz(0, 0.5, 6).looking_at((0, 0.5, 0)))
    w.spawn_sphere(pkg.Transform.from_xyz(-1.5, 0.5, 0),
                   pkg.RaytracedSphere(0.5),
                   pkg.StandardMaterial(base_color=(0, 0, 1)))
    w.spawn_mesh(pkg.Transform.from_xyz(1.2, 0.5, 0), pkg.cube_mesh(1.0),
                 pkg.StandardMaterial(base_color=(1, 1, 0)))
    return w


@pytest.mark.parametrize("scene,backend", [
    ("final", "brute"), ("final", "bvh"), ("mesh", "brute"),
    ("mesh", "bvh")])
def test_masked_trace_sample_matches_jax(scene, backend):
    """One sample of every pixel through the masked loop against JAX's
    ``while_loop``: color atol 5e-5, depth atol 1e-3, segments equal."""
    make = ((lambda pkg: pkg.rtiow.final_scene(seed=42, grid=4))
            if scene == "final" else _mesh)
    js, jcam, ps, pcam = _both(make(jb), backend)
    jcfg = jb.RenderConfig(**SIZE, level=3, intersect_backend=backend)
    pcfg = bt.RenderConfig(**SIZE, level=3, intersect_backend=backend)
    ju, jv = jrenderer.pixel_uv(pcfg.width, pcfg.height)
    pu, pv = prenderer.pixel_uv(pcfg.width, pcfg.height)
    n = pcfg.n_pixels
    jcolor, jdepth, jsegs = jax.jit(
        lambda s, c: jrenderer.trace_sample(
            s, c, jcfg, jnp.arange(n, dtype=jnp.uint32), ju, jv,
            jnp.uint32(2), jnp.uint32(7)))(js, jcam)
    color, depth, segs = prenderer.trace_sample(
        ps, pcam, pcfg, torch.arange(n), pu, pv, 2, 7)
    for g, w in zip(color, jcolor):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-5)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=1e-3)
    assert segs.dtype == torch.int64
    assert int(segs) == int(jsegs) > n


def test_plain_render_tiles_calls_no_wavefront_wrapper(monkeypatch):
    """The fused kernel's plain version on a mesh scene with every
    wavefront wrapper (and the launch under them) patched to raise."""
    def boom(*args, **kwargs):
        raise AssertionError("a wavefront ray test was called")

    for mod, name in ((intersect, "intersect_spheres"),
                      (intersect, "intersect_triangles"),
                      (traverse, "intersect_bvh"),
                      (traverse, "intersect_bvh_triangles"),
                      (wavefront, "launch")):
        monkeypatch.setattr(mod, name, boom)
    world = _mesh(bt)
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    cfg = bt.RenderConfig(width=16, height=16, samples_per_pixel=1,
                          bounces=2, level=3)
    kscene = bt.FusedRenderer(cfg, exact_rng=True).prepare(scene)
    r, g, b, depth, segs = megakernel.render_tiles_reference(
        kscene, cam, cfg, 3, exact_rng=True)
    assert int(segs) > 0 and bool(torch.isfinite(r).all())


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_kernel_equals_plain(kind):
    """Each kernel against its plain version on the same CUDA tensors,
    every lane and under a mask: t to the bit, the same index."""
    dev = _card()
    (wrapper, args, kw), reference, _ = _case(kind, device=dev)
    o, d = _rays(1 << 14, seed=6, axis_aligned=True)
    po, pd = _pvec(o, dev), _pvec(d, dev)
    active = torch.as_tensor(np.random.RandomState(7).rand(1 << 14) < 0.5,
                             device=dev)
    for mask in (None, active):
        before = wrapper.launches
        got = wrapper(po, pd, *args, **kw, active=mask)
        assert wrapper.launches == before + 1 and got[0].is_cuda
        want = intersect.on_active(reference, mask, po, pd, *args, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["brute", "bvh", "mesh"])
def test_cuda_renderer_frame_never_waits_for_the_card(case):
    """A ``Renderer`` frame (after a warm-up) under torch's sync debug
    mode "error": any call that waits for the card raises."""
    dev = _card()
    world = (_mesh(bt) if case == "mesh"
             else bt.rtiow.final_scene(seed=42, grid=4))
    scene = world.extract(with_bvh=True, device=dev)
    cam = world.camera_state(aspect=1.0, device=dev)
    backend = "bvh" if case != "brute" else "brute"
    renderer = bt.Renderer(bt.RenderConfig(width=64, height=64,
                                           samples_per_pixel=2, bounces=3,
                                           intersect_backend=backend))
    renderer.render(scene, cam, seed=0)
    torch.cuda.synchronize()
    before = traverse.intersect_bvh.launches + intersect.intersect_spheres.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        frame = renderer.render(scene, cam, seed=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (traverse.intersect_bvh.launches
            + intersect.intersect_spheres.launches) > before
    assert bool(torch.isfinite(frame.image).all())
    assert int(frame.rays_traced) > 0
