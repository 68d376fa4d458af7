"""The book's final render (``scenes/rtiow_book.py``, configuration
``rtiow-book-final``, cell ``book-final-still``): its camera and lens over
the frozen final scene's arrays, and the cell on the CPU at a small size
over MAX_SPLIT_SPP samples a pixel, so that the program takes the unsplit
full walk as on the card, with the book's 49 bounces and lens kept."""

import math
import time

import numpy as np
import pytest

import control
import harness
from scenes import rtiow_book, rtiow_final

# Over the split's 32 samples a pixel, as the book's 500: the fused
# renderer's gate declines the split here too, at a size the CPU renders.
SMALL = {"resolution": [32, 18], "samples_per_pixel": 40}
SEED = 2 ** 31 + 977


def test_book_camera_over_the_final_scene():
    book, final = rtiow_book.build(42), rtiow_final.build(42)
    assert book["eye"] == (13.0, 2.0, 3.0)
    assert book["target"] == (0.0, 0.0, 0.0)
    assert book["fov"] == math.radians(20.0)
    assert np.float32(book["aperture"]) == np.float32(
        2.0 * 10.0 * math.tan(math.radians(0.3)))
    assert np.float32(book["aperture"]) == np.float32(0.104720712)
    assert book["focus_distance"] == 10.0
    assert (book["near"], book["far"]) == (final["near"], final["far"])
    for key in ("centers", "radii", "materials"):
        assert book[key].dtype == final[key].dtype
        assert book[key].tobytes() == final[key].tobytes()
    (t, v, i, m), = book["raster_meshes"]
    (ft, fv, fi, fm), = final["raster_meshes"]
    assert t == ft and v.tobytes() == fv.tobytes()
    assert i.tobytes() == fi.tobytes() and m.tobytes() == fm.tobytes()


def test_book_config_is_the_books_settings_uncut():
    """The book's frame at its published settings, nothing cut: 1200x675,
    500 samples a pixel (over the split's limit, so the program takes the
    unsplit full walk), max_depth 50 as 49 bounces, traced alone."""
    from bevyray_tpu_torch.kernels.cuda.megakernel import MAX_SPLIT_SPP

    config = harness.load_json(harness.HERE / "configs"
                               / "rtiow-book-final.json")
    assert config["resolution"] == [1200, 675]
    assert config["samples_per_pixel"] == 500 > MAX_SPLIT_SPP
    assert config["bounces"] == 49 and config["level"] == 3
    assert config["reduced"] == []
    assert config["scene"] == "rtiow_book"


class ModeEntry:
    """The fused entry, keeping each frame's (primary, intersect) mode."""

    modes = []

    def __init__(self, entry, ctx):
        self.entry = entry

    def scene(self, buffers):
        self.entry.scene(buffers)

    def camera(self, cam, pose):
        self.entry.camera(cam, pose)

    def render(self, *args):
        frame = self.entry.render(*args)
        self.modes.append(self.entry.renderer.last_mode)
        return frame

    def check(self):
        self.entry.check()


def run(wrap_entry):
    return harness.run_cell("book-final-still", SEED, 0.5, False,
                            time.perf_counter(), device="cpu",
                            overrides=SMALL, wrap_entry=wrap_entry)


def test_book_cell_is_correct_on_the_unsplit_walk():
    ModeEntry.modes = []
    result = run(ModeEntry)
    assert set(ModeEntry.modes) == {("off", "grouped")}
    assert result["correct"] is True
    assert result["checks"]["mismatch_share"]["value"] == 0
    assert result["checks"]["rays_gap"]["value"] == 0


@pytest.mark.parametrize("wrap", ["control", "half_samples"])
def test_book_cell_catches_the_control_and_a_fault(wrap):
    entry = (control.ControlEntry if wrap == "control"
             else control.FAULTS[wrap])
    assert run(entry)["correct"] is False


# Two frames in a 1.0 s window: the fused kernel's unsplit full walk, its
# tail and a fill (the device's records as the profiler names them).
BOOK_DEVICE = [("void render_kernel<false, false, true, false>(RenderArgs)",
                0.05, 0.45),
               ("resolve_kernel(Frame)", 0.45, 0.46),
               ("Memset (Device)", 0.47, 0.48),
               ("void render_kernel<false, false, true, false>(RenderArgs)",
                0.50, 0.95)]


def read_book_kernel_ms(records):
    return harness.load_module("metrics", "book_kernel_ms").read(records)


def test_book_kernel_ms_reads_the_fused_kernels_time_a_frame():
    records = {"window_s": 1.0, "frames": 2, "device": BOOK_DEVICE,
               "spans": []}
    assert read_book_kernel_ms(records) == pytest.approx((0.40 + 0.45) * 500)
    # Clipped to the window: a launch running on past its end counts up to it.
    late = BOOK_DEVICE + [("void render_kernel<false, false, true, false>"
                           "(RenderArgs)", 0.98, 1.30)]
    assert read_book_kernel_ms(dict(records, device=late)) == pytest.approx(
        (0.40 + 0.45 + 0.02) * 500)


def test_book_kernel_ms_absent_where_no_fused_kernel_ran():
    wavefront = [("dense_kernel(Params)", 0.0, 0.4),
                 ("shade_kernel(Params)", 0.4, 0.5)]
    for device in (wavefront, []):
        records = {"window_s": 1.0, "frames": 2, "device": device,
                   "spans": []}
        assert read_book_kernel_ms(records) is None
    assert read_book_kernel_ms({"window_s": 1.0, "frames": 2}) is None
