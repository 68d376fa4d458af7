"""The port's à-trous denoiser (``engine/denoise.py``) against the JAX
package's, on the CPU, and twins of tests/test_denoise.py.

Bar: the filtered image within atol 1e-5 of JAX's on the same image and
depth, for 0-4 iterations, on a frame where every iteration runs and on a
narrow one where the stride rule ends the filter early; the replicate-edge
shift bit-equal to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu.engine import denoise as jdenoise
from bevyray_tpu_torch.engine import denoise
from bevyray_tpu_torch.engine.denoise import atrous_denoise

torch.set_num_threads(2)


def _inputs(h, w, seed):
    rng = np.random.RandomState(seed)
    image = rng.rand(h, w, 3).astype(np.float32)
    depth = rng.uniform(1.0, 20.0, (h, w)).astype(np.float32)
    depth[:, w // 2:] += 30.0    # a depth edge
    return image, depth


@pytest.mark.parametrize("shape", [(48, 40), (40, 12)])
@pytest.mark.parametrize("iterations", [0, 1, 2, 3, 4])
def test_atrous_matches_jax(shape, iterations):
    """(40, 12) stops after stride 4: 2 * 8 >= 12."""
    image, depth = _inputs(*shape, seed=iterations)
    got = atrous_denoise(torch.as_tensor(image), torch.as_tensor(depth),
                         iterations=iterations)
    want = jdenoise.atrous_denoise(jnp.asarray(image), jnp.asarray(depth),
                                   iterations=iterations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if iterations == 0:
        np.testing.assert_array_equal(got.numpy(), image)
    # The CLI's cached factory: JAX's jits the filter, the port's binds it.
    want = jdenoise.jitted_denoise(iterations, 0.25, 0.5)(image, depth)
    got = denoise.jitted_denoise(iterations, 0.25, 0.5)(
        torch.as_tensor(image), torch.as_tensor(depth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_stride_rule_ends_the_filter():
    """Iterations past the stride rule change nothing, as in JAX."""
    image, depth = _inputs(40, 12, seed=7)
    three = atrous_denoise(image, depth, iterations=3)
    assert torch.equal(atrous_denoise(image, depth, iterations=6), three)
    assert not torch.equal(atrous_denoise(image, depth, iterations=2), three)


@pytest.mark.parametrize("dy,dx", [(2, 0), (-4, 0), (0, 1), (0, -2),
                                   (-1, 8), (8, -8)])
def test_shift_replicates_the_border_like_jax(dy, dx):
    image, _ = _inputs(12, 10, seed=1)
    got = denoise._shift2d(torch.as_tensor(image), dy, dx)
    want = jdenoise._shift2d(jnp.asarray(image), dy, dx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _renders(spp_lo=2, spp_hi=64, size=64):
    world = bt.rtiow.material_test_scene()
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=1.0, device="cpu")
    lo = bt.Renderer(bt.RenderConfig(width=size, height=size,
                                     samples_per_pixel=spp_lo, bounces=4,
                                     level=3)).render(scene, cam, seed=3)
    hi = bt.Renderer(bt.RenderConfig(width=size, height=size,
                                     samples_per_pixel=spp_hi, bounces=4,
                                     level=3)).render(scene, cam, seed=9)
    return lo, hi


def test_zero_iterations_is_identity():
    lo, _ = _renders(spp_hi=2)
    out = atrous_denoise(lo.image, lo.rt_depth, iterations=0)
    assert torch.equal(out, lo.image)


def test_denoise_reduces_error_vs_converged_reference():
    lo, hi = _renders()
    ref = hi.image.numpy()
    raw = lo.image.numpy()
    den = atrous_denoise(lo.image, lo.rt_depth, iterations=3).numpy()
    mse_raw = float(np.mean((raw - ref) ** 2))
    mse_den = float(np.mean((den - ref) ** 2))
    assert mse_den < 0.5 * mse_raw, (mse_raw, mse_den)


def test_depth_edges_survive():
    rng = np.random.default_rng(0)
    h = w = 64
    img = np.zeros((h, w, 3), np.float32)
    img[:, : w // 2] = 0.2
    img[:, w // 2:] = 0.8
    noisy = img + rng.normal(0, 0.1, img.shape).astype(np.float32)
    depth = np.full((h, w), 5.0, np.float32)
    depth[:, w // 2:] = 50.0
    out = atrous_denoise(noisy, depth, iterations=3, sigma_color=10.0,
                         sigma_depth=0.5).numpy()
    assert out[:, : w // 2 - 8].std() < 0.25 * noisy[:, : w // 2 - 8].std()
    left = out[:, w // 2 - 2].mean()
    right = out[:, w // 2 + 1].mean()
    assert right - left > 0.5


@pytest.mark.cuda
def test_cuda_denoise_matches_the_cpu():
    """On the card: the filter on CUDA tensors against the CPU's, to 1e-5
    (exp may differ by an ulp between the two)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    image, depth = _inputs(72, 128, seed=3)
    got = atrous_denoise(torch.as_tensor(image, device="cuda"),
                         torch.as_tensor(depth, device="cuda"), iterations=3)
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(),
                               atrous_denoise(image, depth,
                                              iterations=3).numpy(),
                               atol=1e-5)
