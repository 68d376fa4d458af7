"""The fast draw path (:mod:`bevyray_tpu_torch.kernels.cuda.fast_rng`) against
the JAX kernel's (``megakernel.py`` :375-571), and the port's word stream
against the statistics of a uniform one.

The JAX helpers reinterpret bits with ``pltpu.bitcast``, which lowers only
inside a Pallas kernel, so they run through an interpret-mode
``pallas_call`` as tests/test_rng.py runs ``_fast_ball_zphi``. There XLA
fuses the kernel body and contracts multiply-adds, so the bar is 2 ulp (of
``_fast_pow2``'s pre-cast float for its bit trick); the count that is not
bit-equal is printed. Evaluated op by op instead (no fusion, so no
contraction; ``pltpu.bitcast`` as ``lax.bitcast_convert_type``, the TPU's
``rsqrt`` as the ``1 / sqrt`` the port computes), every helper and every
layout's draws are bit-equal to the port's.

The TPU's hardware stream cannot run off the chip, so the port's keyed
stream is held to the statistics of a uniform stream and the fast frame to
JAX's XLA renderer statistically, as tests/test_pallas.py holds JAX's fast
path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import bevyray_tpu_torch as bt
from bevyray_tpu import RenderConfig as JRenderConfig
from bevyray_tpu import Renderer as JRenderer
from bevyray_tpu import rtiow as jrtiow
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.core import rng
from bevyray_tpu_torch.core.types import scene_from_numpy
from bevyray_tpu_torch.kernels.cuda import fast_rng as fr

torch.set_num_threads(2)

SHAPE = (1024, 128)          # 2^17 inputs; (TILE_SUB, 128) rows for JAX
N = SHAPE[0] * SHAPE[1]


def _inputs(kind, seed=0):
    """2^17 float32 inputs over a helper's range: uniforms in (0, 1), the
    ball's clamped log range down to 1e-30, pow2's exponents, sinpi's
    [-1, 1]."""
    g = np.random.default_rng(seed)
    if kind == "unit":
        return g.random(SHAPE, dtype=np.float32)
    if kind == "log":    # half (0, 1), half log-uniform in [1e-30, 1)
        u = g.random(SHAPE, dtype=np.float32)
        u[::2] = np.float32(10.0) ** (-30.0 * g.random((SHAPE[0] // 2,
                                                        SHAPE[1])))
        return np.maximum(u, np.float32(1e-30))
    if kind == "exp":    # log2(u) / 3 over the ball's u
        return (g.random(SHAPE, dtype=np.float32) * np.float32(-33.3))
    return g.random(SHAPE, dtype=np.float32) * 2 - 1      # "sym"


HELPERS = {   # name: (JAX helper, port helper, input kinds)
    "log2": (jmk._fast_log2, fr.fast_log2, ("log",)),
    "pow2": (jmk._fast_pow2, fr.fast_pow2, ("exp",)),
    "sinpi": (jmk._fast_sinpi, fr.fast_sinpi, ("sym",)),
    "sin2pi": (jmk._fast_sin2pi, fr.fast_sin2pi, ("unit",)),
    "cos2pi": (jmk._fast_cos2pi, fr.fast_cos2pi, ("unit",)),
    "ball": (jmk._fast_ball, fr.fast_ball, ("unit",) * 5),
    "ball_zphi": (jmk._fast_ball_zphi, fr.fast_ball_zphi, ("unit",) * 3),
}


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def _pallas(fn, args):
    """``fn`` on ``args`` (numpy arrays of SHAPE) inside an interpret-mode
    pallas_call, each output as numpy."""
    from jax.experimental import pallas as pl

    n_out = len(_as_list(jax.eval_shape(fn, *args)))

    def kern(*refs):
        outs = _as_list(fn(*(r[...] for r in refs[:len(args)])))
        for ref, out in zip(refs[len(args):], outs):
            ref[...] = out

    spec = jax.ShapeDtypeStruct(SHAPE, jnp.float32)
    outs = pl.pallas_call(kern, out_shape=(spec,) * n_out,
                          interpret=True)(*map(jnp.asarray, args))
    return [np.asarray(o) for o in outs]


@pytest.fixture
def op_by_op(monkeypatch):
    """JAX helpers evaluated eagerly, one XLA op at a time: no fusion, so no
    multiply-add contraction."""
    monkeypatch.setattr(jmk.pltpu, "bitcast",
                        lambda x, t: jax.lax.bitcast_convert_type(x, t))
    monkeypatch.setattr(jax.lax, "rsqrt", lambda x: 1.0 / jnp.sqrt(x))

    def run(fn, args):
        return [np.asarray(o) for o in _as_list(fn(*map(jnp.asarray, args)))]
    return run


def _port(fn, args):
    return [o.numpy() for o in _as_list(fn(*map(torch.from_numpy, args)))]


def _ulps(a, b):
    """|a - b| in float32 ulps (same-sign values: the bit distance)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", list(HELPERS))
def test_fast_math_matches_jax_op_by_op(name, op_by_op):
    jfn, pfn, kinds = HELPERS[name]
    args = [_inputs(k, seed=i) for i, k in enumerate(kinds)]
    for want, got in zip(op_by_op(jfn, args), _port(pfn, args)):
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("name", list(HELPERS))
def test_fast_math_matches_jax_in_pallas(name):
    """In the fused interpret-mode kernel: within 2 ulp where XLA contracts
    (for pow2, 2 ulp of the float whose bits it returns). The balls compound
    those roundings and the TPU's rsqrt, so their bar is 2e-6 absolute plus
    2e-5 relative (the helpers' ~1e-4 approximation error is far larger)."""
    jfn, pfn, kinds = HELPERS[name]
    args = [_inputs(k, seed=i) for i, k in enumerate(kinds)]
    for want, got in zip(_pallas(jfn, args), _port(pfn, args)):
        off = int((got.view(np.int32) != want.view(np.int32)).sum())
        print(f"{name}: {off} of {N} not bit-equal")
        assert np.isfinite(got).all()
        if name.startswith("ball"):
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
        elif name == "pow2":
            # The float v = 2^23 * (...) whose int32 cast these bits are.
            v = got.view(np.int32).astype(np.float32)
            ulp = np.spacing(v).astype(np.int64)
            assert (_ulps(got, want) <= 2 * ulp).all()
        else:
            assert _ulps(got, want).max() <= 2


def _words(n_rows, seed):
    """n_rows rows of (TILE_SUB, 128) random int32 words, stacked as the
    JAX provider's ``_raw_block`` returns them."""
    g = np.random.default_rng(seed)
    return g.integers(-2 ** 31, 2 ** 31, (n_rows * 32, 128), dtype=np.int64
                      ).astype(np.int32)


def _jax_scatter(words, layout, monkeypatch, fused):
    """``HwRngProvider.scatter_draws`` on ``words`` (its ``_raw_block``
    patched to return them; ``object.__new__`` skips ``prng_seed``)."""
    monkeypatch.setattr(jmk, "HW_DRAWS_COMPACT", layout != 13)
    monkeypatch.setattr(jmk, "HW_DRAWS_ZPHI", layout == 6)
    held = {}
    monkeypatch.setattr(jmk.HwRngProvider, "_raw_block",
                        staticmethod(lambda n_rows: held["words"]))

    def fn(w):
        held["words"] = w
        provider = object.__new__(jmk.HwRngProvider)
        u_metal, u_trans, u_reflect, b1, b2 = provider.scatter_draws(0)
        return (u_metal, u_trans, u_reflect, *b1, *b2)

    if not fused:
        return [np.asarray(o) for o in fn(jnp.asarray(words))]
    from jax.experimental import pallas as pl

    def kern(w_ref, *outs):
        for ref, out in zip(outs, fn(w_ref[...])):
            ref[...] = out

    spec = jax.ShapeDtypeStruct((32, 128), jnp.float32)
    return [np.asarray(o) for o in pl.pallas_call(
        kern, out_shape=(spec,) * 9, interpret=True)(jnp.asarray(words))]


def _port_scatter(words, layout):
    rows = [torch.from_numpy(words[k * 32:(k + 1) * 32])
            for k in range(layout)]
    u_metal, u_trans, u_reflect, b1, b2 = fr.scatter_draws(rows, layout)
    return [t.numpy() for t in (u_metal, u_trans, u_reflect, *b1, *b2)]


@pytest.mark.parametrize("layout", [6, 9, 13])
def test_scatter_draws_match_jax(layout, monkeypatch, op_by_op):
    """The three layouts on the same int32 words: bit-equal op by op; in the
    interpret-mode kernel the uniforms are bit-equal (bit operations and an
    exact subtraction) and the balls hold the helpers' bar."""
    words = _words(layout, seed=layout)
    got = _port_scatter(words, layout)
    for g, w in zip(got, _jax_scatter(words, layout, monkeypatch, False)):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    fused = _jax_scatter(words, layout, monkeypatch, True)
    for g, w in zip(got[:3], fused[:3]):
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    np.testing.assert_allclose(np.stack(got[3:]), np.stack(fused[3:]),
                               rtol=2e-5, atol=2e-6)


def test_mant_uniform_and_u18_match_jax():
    """The jitter/lens uniforms (top 23 bits) and the repacked spares, on
    words that include both signs and the extremes."""
    from jax.experimental import pallas as pl

    words = _words(2, seed=1)
    words[0, :4] = [0, -1, 2 ** 31 - 1, -2 ** 31]

    def kern(w_ref, u_ref, s_ref):
        w = w_ref[...]
        u_ref[...] = jmk.HwRngProvider._mant_uniform(w)
        spare = w & np.int32(0x1FF)
        v = jax.lax.shift_left(spare[:32], np.int32(9)) | spare[32:]
        mant = jax.lax.shift_left(v, np.int32(5)) | np.int32(0x3F800000)
        s_ref[...] = jmk.pltpu.bitcast(mant, jnp.float32) - 1.0

    u, s = pl.pallas_call(kern, out_shape=(
        jax.ShapeDtypeStruct((64, 128), jnp.float32),
        jax.ShapeDtypeStruct((32, 128), jnp.float32)),
        interpret=True)(jnp.asarray(words))
    w = torch.from_numpy(words)
    np.testing.assert_array_equal(fr.mant_uniform(w).numpy(), np.asarray(u))
    np.testing.assert_array_equal(fr.u18(w[:32], w[32:]).numpy(),
                                  np.asarray(s))
    # u32 words carried in int64 (the port's stream) give the same values.
    w64 = w.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(fr.mant_uniform(w64), fr.mant_uniform(w))
    assert float(fr.mant_uniform(w).min()) >= 0.0
    assert float(fr.mant_uniform(w).max()) < 1.0


def _stream_words(pixels=4096, samples=16, rows=16, seed=7):
    """[pixel, sample, row] words of the port's stream: 2^20 keys."""
    pix = torch.arange(pixels, dtype=torch.int64)[:, None]
    smp = torch.arange(samples, dtype=torch.int64)[None, :]
    stream = rng.stream_init(pix, smp, seed)
    return torch.stack([fr.fast_word(stream, r) for r in range(rows)], -1)


def test_word_stream_statistics():
    """Per-bit frequency within 4 sigma, a 256-bin chi-square of the 23-bit
    uniforms with p > 1e-4, and |correlation| < 5e-3 between adjacent rows,
    neighbouring pixels and consecutive samples, over 2^20 keys."""
    w = _stream_words()
    n = w.numel()
    assert n == 2 ** 20
    ones = torch.stack([((w >> b) & 1).sum() for b in range(32)]).double()
    z = (ones - n / 2) / (n / 4) ** 0.5
    assert float(z.abs().max()) < 4.0, z
    u = fr.mant_uniform(w).double()
    counts = torch.bincount((u.reshape(-1) * 256).long(), minlength=256)
    p = stats.chisquare(counts.numpy()).pvalue
    assert p > 1e-4, p

    def corr(a, b):
        a, b = a.reshape(-1) - a.mean(), b.reshape(-1) - b.mean()
        return float((a * b).sum() / (a.norm() * b.norm()))

    for name, a, b in (("rows", u[..., :-1], u[..., 1:]),
                       ("pixels", u[:-1], u[1:]),
                       ("samples", u[:, :-1], u[:, 1:])):
        assert abs(corr(a, b)) < 5e-3, name


def test_fast_ball_zphi_statistics_on_the_port_stream():
    """Twin of tests/test_rng.py::test_fast_ball_zphi_statistics with the
    port's words: bounce 0's first ball of the z/phi layout."""
    w = _stream_words(pixels=8192, samples=16, rows=6).reshape(-1, 6)
    ball = fr.scatter_draws([w[:, k] for k in range(6)], 6)[3]
    p = torch.stack(list(ball), -1).double().numpy()
    r = np.linalg.norm(p, axis=-1)
    assert r.max() <= 1.0 + 2e-3
    assert abs(r.mean() - 0.75) < 5e-3
    assert np.abs(p.mean(0)).max() < 5e-3
    assert abs(np.median(r) - 0.5 ** (1 / 3)) < 5e-3
    d = p / r[:, None]
    assert np.abs((d ** 2).mean(0) - 1.0 / 3.0).max() < 5e-3


def test_fast_frame_matches_xla_renderer_statistically():
    """Twin of tests/test_pallas.py::test_pallas_fast_rng_statistical: the
    port's fast frame (its plain version) against JAX's XLA renderer, same
    estimator, other random streams."""
    jw = jrtiow.material_test_scene()
    js, jcam = jw.extract(with_bvh=False), jw.camera_state(aspect=1.0)
    size = dict(width=16, height=16, samples_per_pixel=32, bounces=5,
                level=3)
    want = np.asarray(JRenderer(JRenderConfig(**size)).render(
        js, jcam, seed=5).image)
    ps, pcam = scene_from_numpy(jax.tree.map(np.asarray, js),
                                jax.tree.map(np.asarray, jcam), device="cpu")
    got = bt.FusedRenderer(bt.RenderConfig(**size), exact_rng=False).render(
        ps, pcam, seed=5).image.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).mean() < 0.02
    assert abs(got.mean() - want.mean()) < 0.01
