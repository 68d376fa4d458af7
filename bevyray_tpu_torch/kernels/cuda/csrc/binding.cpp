// Python binding of the fused path-tracing kernel (megakernel.cu). The one
// source that includes PyTorch's headers: it checks the tensors, launches on
// PyTorch's current stream and checks the launch.

#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

void launch_render_tiles(const float* cam, const float* sph, int n_spheres,
                         const float* attr, int attr_stride, float* out_r,
                         float* out_g, float* out_b, float* out_depth,
                         long long* segments, int n_lanes, int nbx, int width,
                         int height, int spp, int bounces, unsigned int seed,
                         float inv_spp, int level, int defocus, int cosine,
                         cudaStream_t stream);

namespace {

constexpr int64_t kNCam = 24;
constexpr int64_t kNAttr = 13;
constexpr int64_t kTile = 64 * 64;

void check_f32(const torch::Tensor& t, const torch::Tensor& like, const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), name,
              " must be a CUDA tensor on the scene's device");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void render_tiles(const torch::Tensor& cam, const torch::Tensor& sph,
                  const torch::Tensor& attr, torch::Tensor out_r,
                  torch::Tensor out_g, torch::Tensor out_b,
                  torch::Tensor out_depth, torch::Tensor segments, int64_t nbx,
                  int64_t width, int64_t height, int64_t spp, int64_t bounces,
                  int64_t seed, double inv_spp, int64_t level, bool defocus,
                  bool cosine) {
  check_f32(sph, sph, "sph");
  check_f32(cam, sph, "cam");
  check_f32(attr, sph, "attr");
  TORCH_CHECK(cam.numel() == kNCam, "cam must hold ", kNCam, " floats");
  TORCH_CHECK(sph.dim() == 2 && sph.size(0) == 4 && sph.size(1) > 0,
              "sph must be (4, S)");
  TORCH_CHECK(attr.dim() == 2 && attr.size(0) == kNAttr && attr.size(1) >= sph.size(1),
              "attr must be (13, >= S)");
  const int64_t n_lanes = out_r.numel();
  TORCH_CHECK(n_lanes > 0 && n_lanes % kTile == 0, "outputs must cover whole 64x64 blocks");
  TORCH_CHECK(n_lanes / kTile == nbx * ((height + 63) / 64) && nbx == (width + 63) / 64,
              "outputs must cover the frame's block grid");
  for (const auto* out : {&out_r, &out_g, &out_b, &out_depth}) {
    check_f32(*out, sph, "outputs");
    TORCH_CHECK(out->numel() == n_lanes, "outputs must have equal sizes");
  }
  TORCH_CHECK(segments.is_cuda() && segments.device() == sph.device() &&
                  segments.scalar_type() == torch::kInt64 && segments.numel() == 1,
              "segments must be one int64 on the scene's device");
  TORCH_CHECK(spp >= 1 && bounces >= 0, "spp must be >= 1 and bounces >= 0");

  const c10::cuda::CUDAGuard guard(sph.device());
  launch_render_tiles(cam.data_ptr<float>(), sph.data_ptr<float>(),
                      static_cast<int>(sph.size(1)), attr.data_ptr<float>(),
                      static_cast<int>(attr.size(1)), out_r.data_ptr<float>(),
                      out_g.data_ptr<float>(), out_b.data_ptr<float>(),
                      out_depth.data_ptr<float>(),
                      reinterpret_cast<long long*>(segments.data_ptr<int64_t>()),
                      static_cast<int>(n_lanes), static_cast<int>(nbx),
                      static_cast<int>(width), static_cast<int>(height),
                      static_cast<int>(spp), static_cast<int>(bounces),
                      static_cast<unsigned int>(seed & 0xFFFFFFFF),
                      static_cast<float>(inv_spp), static_cast<int>(level),
                      defocus ? 1 : 0, cosine ? 1 : 0,
                      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("render_tiles", &render_tiles,
        "Trace a frame into block-ordered r/g/b/depth and add its segment count");
}
