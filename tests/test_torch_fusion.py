"""Invariances of the fast draw path and of block fusion, on the port's plain
version (CPU), and the fuse rule against the JAX kernel's.

Draws and words are keyed by (pixel, sample, slot), so the fast frame is
the same in every (primary, intersect) mode and under every fuse, two
passes of 8 spp sum to one of 16, and a lane whose sample target is 0
leaves exact zero sums. The plain version computes per lane, so fusion
cannot change its values: here the fuse tests pin the rule that picks it
(the same value as JAX's ``_resolve_fuse`` for the same frame) and its
report; the kernel's fused grid is held to the plain version on the card
(the ``cuda`` case below and chip_smoke.py phase 7)."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu.kernels.pallas import megakernel as jmk
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda import primary

torch.set_num_threads(2)

MODES = [("off", "grouped"), ("split", "grouped"), ("off", "candidates"),
         ("split", "candidates")]


def _grid4(width, height, spp=2, bounces=4, **options):
    world = bt.rtiow.final_scene(seed=42, grid=4)
    scene = world.extract(with_bvh=False, device="cpu")
    cam = world.camera_state(aspect=width / height, device="cpu")
    cfg = bt.RenderConfig(width, height, spp, bounces, level=3, **options)
    return world, scene, cam, cfg


def _frame(kscene, cam, cfg, seed=11, exact_rng=False, **kwargs):
    sl, slmeta = primary.device_shortlists_for(kscene, cam, cfg,
                                               cfg.samples_per_pixel)
    return mk.render_tiles(kscene, cam, cfg, seed, exact_rng=exact_rng,
                           sl=sl, slmeta=slmeta, **kwargs), sl


def test_fast_frame_is_the_same_in_every_mode():
    _, scene, cam, cfg = _grid4(64, 64)
    kscene = mk.prepare_kernel_scene(scene)
    frames = {}
    for mode in MODES:
        mcfg = dataclasses.replace(cfg, pallas_primary=mode[0],
                                   pallas_intersect=mode[1])
        frames[mode], sl = _frame(kscene, cam, mcfg)
        assert mk.kernel_mode(kscene, mcfg, sl) == mode
    base = frames[MODES[0]]
    assert int(base[4]) > 0 and bool(torch.isfinite(base[0]).all())
    for mode in MODES[1:]:
        for got, want in zip(frames[mode], base):
            assert torch.equal(got, want), mode


@pytest.mark.parametrize("exact_rng", [True, False], ids=["exact", "fast"])
def test_every_fuse_gives_the_same_frame(exact_rng, monkeypatch):
    """Fuse 1/2/4/8 at a tile count that 4 and 8 do not divide (3 blocks):
    the fuse each explicit value resolves to, and equal frames and segment
    counts through ``FusedRenderer``, which reports the fuse it ran."""
    _, scene, cam, cfg = _grid4(192, 64, pallas_primary="split",
                                pallas_intersect="candidates")
    frames = {}
    for want in (1, 2, 4, 8):
        monkeypatch.setattr(mk, "PHASE_FUSE", want)
        renderer = bt.FusedRenderer(cfg, exact_rng=exact_rng)
        frames[want] = renderer.render(scene, cam, seed=3)
        assert renderer.last_mode == ("split", "candidates")
        assert renderer.last_fuse == want
    for f in (2, 4, 8):
        assert torch.equal(frames[f].image, frames[1].image)
        assert torch.equal(frames[f].rt_depth, frames[1].rt_depth)
        assert int(frames[f].rays_traced) == int(frames[1].rays_traced) > 0


def test_two_half_passes_equal_one_full_pass_on_the_fast_path():
    """2 x 8 spp at sample offsets 0 and 8 against 16 spp: the same samples
    summed in another order (within 1e-5), the same segments."""
    _, scene, cam, cfg = _grid4(64, 64, spp=16)
    kscene = mk.prepare_kernel_scene(scene)
    half = dataclasses.replace(cfg, samples_per_pixel=8)
    full, _ = _frame(kscene, cam, cfg, normalize=False)
    a, _ = _frame(kscene, cam, half, normalize=False)
    b, _ = _frame(kscene, cam, half, normalize=False, sample_offset=8)
    for x, y, z in zip(a[:4], b[:4], full[:4]):
        np.testing.assert_allclose((x + y).numpy(), z.numpy(), atol=1e-5,
                                   rtol=1e-6)
    assert int(a[4]) + int(b[4]) == int(full[4])


def test_films_take_the_draw_path_of_their_device():
    """The films pass no draw path, so the kernel resolves it for the film's
    device: on CPU tensors the exact streams, the 2 x 8 spp film equal to
    the exact 16 spp frame (a film on the card draws from the fast path;
    chip_smoke.py phase 5 checks its launches)."""
    _, scene, cam, cfg = _grid4(64, 64, spp=16)
    renderer = bt.FusedRenderer(cfg)
    frame = renderer.render(scene, cam, seed=9)
    assert renderer.last_exact_rng is True
    exact = bt.FusedRenderer(cfg, exact_rng=True).render(scene, cam, seed=9)
    assert torch.equal(frame.image, exact.image)
    prog = bt.ProgressiveRenderer(dataclasses.replace(cfg, samples_per_pixel=8),
                                  backend="pallas", device="cpu")
    prog.step(scene, cam, seed=9)
    film = prog.step(scene, cam, seed=9)
    np.testing.assert_allclose(film.image.numpy(), frame.image.numpy(),
                               atol=1e-5)
    assert int(film.rays_traced) == int(frame.rays_traced)
    assert mk.resolve_exact_rng(None, torch.device("cuda", 0)) is False


def test_zero_targets_leave_zero_sums_on_the_fast_path():
    _, scene, cam, cfg = _grid4(96, 64, spp=4)
    kscene = mk.prepare_kernel_scene(scene)
    targets = torch.from_numpy(np.random.default_rng(4).integers(
        0, 6, 96 * 64).astype(np.int32))
    spp_map = mk.shuffle_blocks(targets, cfg, fill=0)
    out, _ = _frame(kscene, cam, cfg, normalize=False, spp_map=spp_map)
    idle = spp_map.reshape(-1) == 0
    for x in out[:4]:
        assert float(x[idle].abs().max()) == 0.0
        assert float(x[~idle].abs().max()) > 0.0
    traced = torch.clamp(targets.long(), max=4)
    assert int(out[4]) >= int(traced.sum())


def test_fuse_rule_matches_jax(monkeypatch):
    """``resolve_fuse`` against JAX's ``_resolve_fuse`` over tile counts,
    spp, the split, table sizes and the emissive layout, for "auto" and
    every explicit value; the plane counts against ``_st_layout``."""
    for emissive in (False, True):
        assert mk.st_planes(emissive) == len(jmk._st_layout(emissive))
    grid = itertools.product((1, 3, 8, 11, 24, 510, 1020), (1, 2, 4, 8, 16, 32),
                             (False, True), (64, 128, 512, 2048, 4096),
                             (False, True))
    for want in ("auto", 1, 2, 4, 8):
        monkeypatch.setattr(mk, "PHASE_FUSE", want)
        monkeypatch.setattr(jmk, "PHASE_FUSE", want)
        for tiles, spp, split, s, emissive in grid if want == "auto" else (
                itertools.product((3, 510), (2, 16), (False, True), (512,),
                                  (False, True))):
            planes = len(jmk._st_layout(emissive))
            assert mk.resolve_fuse(tiles, spp, split, s, planes) == \
                jmk._resolve_fuse(tiles, spp, split, s, planes)
    monkeypatch.setattr(mk, "PHASE_FUSE", "auto")
    # The headline: 510 blocks, 16 spp, the split, 512 padded spheres and
    # the 10-plane layout of a scene that does not emit.
    assert mk.resolve_fuse(510, 16, True, 512, mk.st_planes(False)) == 4
    assert mk.resolve_fuse(510, 16, True, 512, mk.st_planes(True)) == 2


def test_emissive_probe_and_headline_fuse():
    """``scene_has_emissive`` on the night scene (lamps) and the final
    scene, carried on the prepared scene, and the fuse at the headline's
    shapes (its plain version on a cut frame would cost minutes, so the
    rule is read through ``kernel_fuse``)."""
    night = bt.rtiow.night_scene().extract(with_bvh=False, device="cpu")
    world = bt.rtiow.final_scene(seed=42)
    final = world.extract(with_bvh=False, device="cpu")
    assert mk.scene_has_emissive(night) and not mk.scene_has_emissive(final)
    assert mk.prepare_kernel_scene(night).has_emissive is True
    headline = bt.RenderConfig(1920, 1080, 16, 4, level=3)
    renderer = bt.FusedRenderer(headline)
    kscene = renderer.prepare(final)
    assert kscene.has_emissive is False
    cam = world.camera_state(aspect=1920 / 1080, device="cpu")
    sl, _ = renderer.shortlists(kscene, cam)
    assert mk.kernel_mode(kscene, headline, sl) == ("split", "candidates")
    assert mk.kernel_fuse(kscene, headline, sl) == 4
    assert mk.kernel_fuse(kscene._replace(has_emissive=True), headline,
                          sl) == 2
    assert mk.kernel_fuse(kscene, headline, None) == 1


def test_cpu_fast_path_takes_the_plain_version():
    """``exact_rng=False`` on CPU tensors runs the plain fast version and
    never builds or launches the kernel."""
    from bevyray_tpu_torch.kernels.cuda import build

    _, scene, cam, cfg = _grid4(32, 32)
    kscene = mk.prepare_kernel_scene(scene)
    launches = mk.render_tiles.launches
    got = mk.render_tiles(kscene, cam, cfg, 1, exact_rng=False)
    want = mk.render_tiles_reference(kscene, cam, cfg, 1, exact_rng=False)
    assert mk.render_tiles.launches == launches and build._extension is None
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    exact = mk.render_tiles(kscene, cam, cfg, 1, exact_rng=True)
    assert not torch.equal(exact[0], got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [6, 9, 13])
@pytest.mark.parametrize("mode", MODES, ids=["/".join(m) for m in MODES])
def test_fast_kernel_matches_plain_version_on_card(mode, layout, monkeypatch):
    """On the card: the fast kernel against its fast plain version on the
    same CUDA tensors, every mode and layout, and every fuse of the split
    (chip_smoke.py phase 7 runs the same checks): to the bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs this check there")
    from bevyray_tpu_torch.kernels.cuda import fast_rng

    monkeypatch.setattr(fast_rng, "HW_DRAWS_COMPACT", layout != 13)
    monkeypatch.setattr(fast_rng, "HW_DRAWS_ZPHI", layout == 6)
    world = bt.rtiow.final_scene(seed=42)
    dev = torch.device("cuda", 0)
    cfg = bt.RenderConfig(192, 128, 4, 4, level=3, pallas_primary=mode[0],
                          pallas_intersect=mode[1])
    kscene = mk.prepare_kernel_scene(world.extract(with_bvh=False, device=dev))
    cam = world.camera_state(aspect=1.5, device=dev)
    sl, slmeta = primary.device_shortlists_for(kscene, cam, cfg, 4)
    want = mk.render_tiles_reference(kscene, cam, cfg, 7, exact_rng=False,
                                     sl=sl, slmeta=slmeta)
    for fuse in ((1, 2, 4, 8) if sl is not None else (1,)):
        monkeypatch.setattr(mk, "PHASE_FUSE", fuse)
        got = mk.render_tiles(kscene, cam, cfg, 7, exact_rng=False, sl=sl,
                              slmeta=slmeta)
        for g, w in zip(got, want):
            assert torch.equal(g, w), fuse
