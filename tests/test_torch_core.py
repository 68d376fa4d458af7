"""The port's core and shading building blocks against the JAX package's, on
the CPU: the same inputs, made with a numpy seed, go through both.

Bars: the PCG words and their floats are bit-equal; the ball sampler is held
to rtol 2e-6 because torch-CPU and XLA-CPU log/cos/sin/exp may differ by an
ulp; shading, sky and compositing to atol 1e-6."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevyray_tpu.core import rng as jrng
from bevyray_tpu.core.vec import Vec3 as JVec3
from bevyray_tpu.kernels import composite as jcomposite
from bevyray_tpu.kernels import shade as jshade
from bevyray_tpu.kernels.intersect import HitInfo as JHitInfo
from bevyray_tpu.kernels.intersect import MaterialLanes as JMaterialLanes
from bevyray_tpu_torch.core import rng
from bevyray_tpu_torch.core.vec import Vec3
from bevyray_tpu_torch.kernels import composite, shade
from bevyray_tpu_torch.kernels.intersect import HitInfo, MaterialLanes

torch.set_num_threads(2)

N_WORDS = 1 << 17   # >= 1e5 random u32 words
N_LANES = 4096


def _words(seed, n=N_WORDS):
    return np.random.RandomState(seed).randint(0, 2**32, size=n,
                                               dtype=np.uint64).astype(np.uint32)


def _t(a):
    """numpy u32 words -> the port's int64 carrier; floats/bools as they are."""
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _u32(t):
    return t.numpy().astype(np.uint32)


def test_pcg_step_bit_equal():
    w = _words(0)
    np.testing.assert_array_equal(_u32(rng.pcg_step(_t(w))),
                                  np.asarray(jrng.pcg_step(jnp.asarray(w))))


def test_to_float01_bit_equal():
    w = _words(1)
    w[:4] = [0, 0xFFFFFFFF, 0xFFFFFF80, 0x80000000]   # rounding edges
    got = rng.to_float01(_t(w)).numpy()
    want = np.asarray(jrng.to_float01(jnp.asarray(w)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.max() <= 1.0


def test_stream_init_and_draw_bit_equal():
    pix, smp, seed, slot = _words(2), _words(3), _words(4), _words(5)
    slot = slot % 64
    got_s = rng.stream_init(_t(pix), _t(smp), _t(seed))
    want_s = jrng.stream_init(jnp.asarray(pix), jnp.asarray(smp),
                              jnp.asarray(seed))
    np.testing.assert_array_equal(_u32(got_s), np.asarray(want_s))
    got = rng.draw(got_s, _t(slot)).numpy()
    want = np.asarray(jrng.draw(want_s, jnp.asarray(slot)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # Python-int slots and seeds, as the renderers pass them.
    got = rng.draw(rng.stream_init(_t(pix), 3, 0xDEADBEEF), 17).numpy()
    want = np.asarray(jrng.draw(jrng.stream_init(
        jnp.asarray(pix), np.uint32(3), np.uint32(0xDEADBEEF)), np.uint32(17)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_unit_ball_from_uniforms_close():
    u = np.random.RandomState(6).rand(5, N_WORDS).astype(np.float32)
    u[:, :3] = 0.0   # the clamps
    got = rng.unit_ball_from_uniforms(*(torch.as_tensor(x) for x in u))
    want = jrng.unit_ball_from_uniforms(*(jnp.asarray(x) for x in u))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-6)
    r = torch.sqrt(got.length_squared())
    assert float(r.max()) <= 1.0 + 1e-6


def _lanes(seed, n=N_LANES):
    """Random shading inputs as numpy arrays: unit normals, directions,
    materials that take every branch, draws and balls."""
    r = np.random.RandomState(seed)
    f = lambda *s: r.rand(*s).astype(np.float32)
    nrm = r.randn(3, n).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    d = r.randn(3, n).astype(np.float32)
    kind = r.randint(0, 3, n)
    return dict(
        d=d, n=nrm, front=r.rand(n) < 0.5,
        base=f(3, n), emissive=f(3, n),
        metallic=np.where(kind == 0, 1.0, f(n) * (kind == 2)).astype(np.float32),
        roughness=f(n), ior=(1.0 + f(n)).astype(np.float32),
        trans=(kind == 1).astype(np.float32),
        u=f(3, n), ball1=(f(3, n) * 2 - 1), ball2=(f(3, n) * 2 - 1))


def _scatter_inputs(L, vec, arr, hit_cls, mat_cls):
    nrm = vec(*(arr(x) for x in L["n"]))
    hit = hit_cls(t=arr(np.ones_like(L["roughness"])),
                  miss=arr(np.zeros_like(L["front"])),
                  position=nrm, normal=nrm, material_id=arr(np.zeros(
                      L["front"].shape, np.int32)),
                  front_face=arr(L["front"]))
    mat = mat_cls(base_color=vec(*(arr(x) for x in L["base"])),
                  metallic=arr(L["metallic"]), roughness=arr(L["roughness"]),
                  ior=arr(L["ior"]), specular_transmission=arr(L["trans"]),
                  emissive=vec(*(arr(x) for x in L["emissive"])))
    return (vec(*(arr(x) for x in L["d"])), hit, mat,
            *(arr(x) for x in L["u"]), vec(*(arr(x) for x in L["ball1"])),
            vec(*(arr(x) for x in L["ball2"])))


@pytest.mark.parametrize("mode", ["reference", "cosine"])
def test_scatter_matches(mode):
    L = _lanes(7)
    got = shade.scatter(*_scatter_inputs(L, Vec3, torch.as_tensor, HitInfo,
                                         MaterialLanes), diffuse_mode=mode)
    want = jshade.scatter(*_scatter_inputs(L, JVec3, jnp.asarray, JHitInfo,
                                           JMaterialLanes), diffuse_mode=mode)
    for g, w in zip(got.direction + got.attenuation,
                    want.direction + want.attenuation):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_array_equal(got.absorbed.numpy(),
                                  np.asarray(want.absorbed))
    assert 0 < int(got.absorbed.sum()) < N_LANES


def test_background_gradient_and_gamma():
    r = np.random.RandomState(8)
    d = r.randn(3, N_LANES).astype(np.float32)
    c = (r.randn(3, N_LANES) * 2).astype(np.float32)   # negatives clamp to 0
    for fn, jfn, x in ((composite.background_gradient,
                        jcomposite.background_gradient, d),
                       (composite.linear_to_gamma, jcomposite.linear_to_gamma,
                        c)):
        got = fn(Vec3(*(torch.as_tensor(v) for v in x)))
        want = jfn(JVec3(*(jnp.asarray(v) for v in x)))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_composite_levels(level):
    r = np.random.RandomState(9 + level)
    rt, raster = r.rand(2, 3, N_LANES).astype(np.float32)
    depth = (r.rand(N_LANES) * 150).astype(np.float32)
    rdepth = r.rand(N_LANES).astype(np.float32)
    near, far = np.float32(0.1), np.float32(100.0)
    got = composite.composite(
        level, Vec3(*map(torch.as_tensor, rt)), torch.as_tensor(depth),
        torch.tensor(near), torch.tensor(far),
        Vec3(*map(torch.as_tensor, raster)), torch.as_tensor(rdepth))
    want = jcomposite.composite(
        level, JVec3(*map(jnp.asarray, rt)), jnp.asarray(depth),
        jnp.float32(near), jnp.float32(far),
        JVec3(*map(jnp.asarray, raster)), jnp.asarray(rdepth))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import bevyray_tpu_torch as bt\n"
            "from bevyray_tpu_torch.kernels.cuda import build, megakernel, wavefront\n"
            "from bevyray_tpu_torch import bvh\n"
            "from bevyray_tpu_torch.bvh import native\n"
            "from bevyray_tpu_torch.kernels import traverse\n"
            "from bevyray_tpu_torch.engine import denoise\n"
            "from bevyray_tpu_torch.app import cli, inspector\n"
            "from bevyray_tpu_torch.utils import png, profiling\n"
            "from bevyray_tpu_torch.testing import oracle, rng_np\n"
            "assert 'bevyray_tpu' not in sys.modules\n"
            "print(bt.FusedRenderer.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "FusedRenderer"
