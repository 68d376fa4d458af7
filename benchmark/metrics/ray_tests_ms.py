"""ray_tests_ms: device time a frame of the wavefront renderer's ray tests
(ms; the profiler's records of csrc/wavefront.cu's dense test and walks)."""

from timeline import kernel_ms_per_frame

KERNELS = ("dense_kernel", "walk_spheres_kernel", "walk_triangles_kernel")


def read(records: dict):
    return kernel_ms_per_frame(records, KERNELS)
