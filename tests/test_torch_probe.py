"""The fused kernel's probe instances (``csrc/megakernel.cu``, ``kProbe``):
which modes have one, the mode of the book's final render (Ray Tracing in
One Weekend v4, 14.1: 1200x675, 500 spp, depth 50, thin lens) that the
off/grouped instance measures, and on the card each instance's outputs
against the default instance's and its clock sums; the check that refuses
sums a long run has wrapped. The book's frame is the benchmark's
(``chip_smoke.book_inputs``). This file imports no JAX, so its ``cuda``
tests run on a machine without it."""

import dataclasses

import pytest
import torch

import bevyray_tpu_torch as bt
from bevyray_tpu_torch.kernels.cuda import build
from bevyray_tpu_torch.kernels.cuda import megakernel as mk
from bevyray_tpu_torch.kernels.cuda import primary
from chip_smoke import BOOK_MODE, book_inputs

torch.set_num_threads(2)

_, BOOK, _ = book_inputs()
MODES = [(p, i) for p in ("split", "off") for i in ("candidates", "grouped")]


def inputs(config, device):
    world, _, _ = book_inputs()
    scene = world.extract(with_bvh=False, device=device)
    cam = world.camera_state(aspect=config.width / config.height,
                             device=device)
    return scene, cam


def forced(mode, **frame):
    return bt.RenderConfig(**frame, level=3, defocus=True,
                           pallas_primary=mode[0], pallas_intersect=mode[1])


def test_book_frame_takes_the_unsplit_full_walk():
    """At the book's settings the split's gate declines (500 spp is over
    MAX_SPLIT_SPP) and 512 padded spheres are under the unsplit candidate
    walk's 1025: ``FusedRenderer`` at its defaults runs off/grouped at fuse
    1, a mode with a probe instance."""
    scene, cam = inputs(BOOK, "cpu")
    renderer = bt.FusedRenderer(BOOK)
    kscene = renderer.prepare(scene)
    sl, slmeta = renderer.shortlists(kscene, cam)
    assert sl is None and slmeta is None
    assert kscene.sph.shape[1] == 512
    mode = mk.kernel_mode(kscene, BOOK, sl)
    assert mode == BOOK_MODE == ("off", "grouped") and mode in mk.PROBE_MODES
    assert mk.kernel_fuse(kscene, BOOK, sl) == 1


def test_book_frame_is_the_books_published_render():
    """The benchmark's configuration gives the book's settings uncut:
    1200x675, 500 samples a pixel, max_depth 50 as 49 bounces, traced
    alone, with the lens on."""
    assert (BOOK.width, BOOK.height) == (1200, 675)
    assert (BOOK.samples_per_pixel, BOOK.bounces) == (500, 49)
    assert BOOK.level == 3 and BOOK.defocus


@pytest.mark.parametrize("run", [2 ** 32 - 2 ** 20 - 1, 2 ** 32 - 2 ** 20,
                                 2 ** 32, 2 ** 33 + 5])
def test_probe_clocks_refused_once_a_thread_could_wrap(run):
    """A thread's stage sums are 32-bit: the probe's clocks are refused
    once the longest block's run comes within 2^20 cycles of 2^32, and
    kept below that."""
    clocks = dict.fromkeys(mk.PROBE_SLOTS, 1)
    clocks.update(max_cycles=run, max_ns=2 * 10 ** 9)
    if run < mk.PROBE_WRAP_CYCLES:
        mk.check_probe_clocks(clocks)
    else:
        with pytest.raises(RuntimeError, match="2\\^32"):
            mk.check_probe_clocks(clocks)


@pytest.mark.parametrize("mode", MODES, ids="/".join)
def test_probe_runs_only_its_modes(mode):
    """A mode without a probe instance is refused before anything else; a
    mode with one gets as far as the device, where CPU tensors are refused,
    and the extension is not built."""
    config = forced(mode, width=64, height=64, samples_per_pixel=2,
                    bounces=4)
    scene, cam = inputs(config, "cpu")
    kscene = mk.prepare_kernel_scene(scene)
    sl, slmeta = primary.device_shortlists_for(kscene, cam, config, 2)
    assert mk.kernel_mode(kscene, config, sl) == mode
    match = "CUDA tensors" if mode in mk.PROBE_MODES else "no probe instance"
    with pytest.raises(ValueError, match=match):
        mk.render_tiles_probe(kscene, cam, config, 1, sl=sl, slmeta=slmeta)
    assert build._extension is None


@pytest.mark.cuda
@pytest.mark.parametrize("mode", mk.PROBE_MODES, ids="/".join)
def test_cuda_probe_instance_matches_the_default_instance(mode):
    """On the card, the book's camera and lens with 50-deep paths at 192x128:
    each probe instance bit-equal to the default instance and to the plain
    version, with equal segments; its stages' clocks positive, the walks
    inside the segment iterations, and the shortlist walk, the slab tests
    and the items' staging counted only where the split and the candidate
    walk run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 9 runs the probe "
                    "there")
    dev = torch.device("cuda", 0)
    config = forced(mode, width=192, height=128, samples_per_pixel=4,
                    bounces=49)
    scene, cam = inputs(config, dev)
    kscene = mk.prepare_kernel_scene(scene)
    sl, slmeta = primary.device_shortlists_for(kscene, cam, config, 4)
    assert mk.kernel_mode(kscene, config, sl) == mode
    run = dict(sl=sl, slmeta=slmeta)
    want = mk.render_tiles(kscene, cam, config, 7, exact_rng=False, **run)
    got, clk = mk.render_tiles_probe(kscene, cam, config, 7, **run)
    plain = mk.render_tiles_reference(kscene, cam, config, 7,
                                      exact_rng=False, **run)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, p)
    assert clk["segments"] == int(want[4])
    assert clk["launch_segments"] == [int(want[4])]
    assert 0 < clk["issues"] <= clk["segments"]
    for slot in ("total", "fetch", "segment", "walk"):
        assert clk[slot] > 0, slot
    assert clk["segment"] > clk["walk0"] + clk["walk"]
    assert clk["total"] > clk["segment"]
    split = mode == ("split", "candidates")
    assert (clk["walk0"] > 0) == split
    assert (clk["slab_tests"] > 0) == split
    # Only the split takes work items (and stages them); the full walk takes
    # each pixel from the launch's counter.
    assert (clk["stage"] > 0) == split
    # The blocks' runs: a clock between the H100's idle and top clocks,
    # the blocks' summed runs no shorter than the longest, and the longest
    # in cycles below the wrap and within 1% of its nanoseconds at that
    # clock.
    ghz = clk["block_cycles"] / clk["block_ns"]
    assert 0.3 < ghz < 2.1
    assert 0 < clk["max_ns"] <= clk["block_ns"]
    assert clk["max_cycles"] < mk.PROBE_WRAP_CYCLES
    assert abs(clk["max_cycles"] / (clk["max_ns"] * ghz) - 1) < 0.01


@pytest.mark.cuda
def test_cuda_book_frame_probed_at_the_renderers_defaults():
    """On the card, the book's frame cut to 128x72 with 40 samples a pixel
    (still over MAX_SPLIT_SPP): ``FusedRenderer`` at its defaults runs
    off/grouped on the fast draws, in a pilot and a main launch, and the
    probe on the same inputs gives the default instance's bits; its
    segments are the main launch's count, and the pilot's count is the plain
    version's for the pilot's samples, the two adding up to the frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py phase 9(d) runs the "
                    "book's frame there")
    dev = torch.device("cuda", 0)
    config = dataclasses.replace(BOOK, width=128, height=72,
                                 samples_per_pixel=40)
    scene, cam = inputs(config, dev)
    renderer = bt.FusedRenderer(config)
    frame = renderer.render(scene, cam, 11)
    assert renderer.last_mode == BOOK_MODE
    assert renderer.last_exact_rng is False
    kscene = renderer.prepare(scene)
    want = mk.render_tiles(kscene, cam, config, 11)
    got, clk = mk.render_tiles_probe(kscene, cam, config, 11)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert mk.pilot_samples(BOOK_MODE, 40) == mk.PILOT_SPP
    pilot = mk.render_tiles_reference(
        kscene, cam, dataclasses.replace(config,
                                         samples_per_pixel=mk.PILOT_SPP),
        11, normalize=False, exact_rng=False)
    assert clk["launch_segments"] == [int(pilot[4]), clk["segments"]]
    assert sum(clk["launch_segments"]) == int(want[4])
    assert int(want[4]) == int(frame.rays_traced)
    assert clk["walk0"] == 0 and clk["slab_tests"] == 0
