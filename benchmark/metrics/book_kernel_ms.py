"""book_kernel_ms: device time a frame of the fused kernel in the book's
final render (ms; the profiler's records of ``render_kernel``,
csrc/megakernel.cu, which that frame launches as its unsplit full walk)."""

from timeline import kernel_ms_per_frame

KERNELS = ("render_kernel",)


def read(records: dict):
    return kernel_ms_per_frame(records, KERNELS)
