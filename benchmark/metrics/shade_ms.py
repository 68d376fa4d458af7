"""shade_ms: device time a frame of the wavefront renderer's ray generation
and shading (ms; the profiler's records of csrc/bounce.cu's kernels)."""

from timeline import kernel_ms_per_frame

KERNELS = ("raygen_kernel", "shade_kernel")


def read(records: dict):
    return kernel_ms_per_frame(records, KERNELS)
