"""Build the port's CUDA kernels into one PyTorch extension, at first use.

``extension()`` compiles ``csrc/megakernel.cu`` (the fused kernel),
``csrc/wavefront.cu`` (the wavefront renderer's ray tests),
``csrc/bounce.cu`` (its ray generation and shading) and
``csrc/binding.cpp`` with ``torch.utils.cpp_extension.load`` for ``sm_90a``
into ``build/torch_ext/`` at the repository root, and loads the result;
later calls in the process return the loaded module, and later processes
reuse the build while its sources are unchanged. Only ``binding.cpp``
includes PyTorch's headers, which keeps the nvcc part of the build short;
the ``.cu`` files share ``csrc/common.cuh``, and the fused kernel and the
bounce kernels ``csrc/shade.cuh``. Contraction into multiply-adds is off
(``--fmad=false``) and fast math is never used, so the kernel rounds like the
plain version. A failed build raises.
"""

from __future__ import annotations

from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false"]

_extension = None


def extension():
    """The loaded extension module, built on the first call."""
    global _extension
    if _extension is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _extension = load(
            name="bevyray_tpu_torch_cuda",
            sources=[str(_CSRC / name) for name in (
                "megakernel.cu", "wavefront.cu", "bounce.cu",
                "binding.cpp")],
            build_directory=str(BUILD_DIR), extra_cuda_cflags=CUDA_FLAGS,
            extra_cflags=["-O2"])
    return _extension
