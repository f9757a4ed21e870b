// Light-major Disney BRDF (K2): one thread per ray, its L lights in a
// loop, every plane read in place.
//
// Replaces the Pallas kernel of hrt_tpu/ops/shade_pallas.py
// (`_brdf_light_major`, body `_make_kernel`).  The TPU kernel skips an
// (8, 128) group of rays when none of them is relevant.  On the card the
// pass is bound by the bytes it moves and by its wrapper: its work is a
// few hundred flops per relevant element against 18 per-ray floats, and
// the first port (6f624a9) first stacked the 18 per-ray planes (12 of
// them strided rows of the frame's attribute gather) into a contiguous
// copy every frame, then read all 18 again for every light and redid
// the view-only Disney terms per light.  Here:
// - the wrapper passes each plane as (pointer, element stride) in one
//   argument block (`BrdfArgs`, by value), so nothing is copied; a ray's
//   12 material floats lie in one row of the gather and share its cache
//   lines;
// - a thread reads its ray's `relevant` bytes first and, with none set,
//   writes zeros and reads nothing more;
// - otherwise it reads the ray's 18 floats once, computes the view terms
//   once (disney.cuh `view_terms`) and loops over the lights, writing
//   each light's three output planes with neighbouring threads on
//   neighbouring addresses (the (3, L * N) light-major layout).
// Irrelevant elements (sky, back-facing or below the light threshold)
// write zero.
#include <cuda_runtime.h>

#include "disney.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 21;

}  // namespace

// The argument block: planes 0-17 the per-ray planes of N floats in the
// order of hrt_tpu/ops/shade_pallas.py (color xyz, subsurface, metallic,
// roughness, specular, specular_tint, anisotropic, sheen_tint, clearcoat,
// clearcoat_gloss, normal xyz, view xyz), planes 18-20 the light
// direction's xyz over the L * N light-major elements; element i of
// plane k at plane[k] + i * stride[k].  `relevant` the L * N bytes (at
// relevant_stride), `out` 3 contiguous planes of L * N floats.
struct BrdfArgs {
  const float* plane[kPlanes];
  long long stride[kPlanes];
  const unsigned char* relevant;
  long long relevant_stride;
  float* out;
  int n;
  int num_lights;
};

namespace {

__global__ void __launch_bounds__(kThreads)
brdf_light_major_kernel(const BrdfArgs a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  const long long n = a.n;
  const long long total = n * a.num_lights;
  bool any = false;
  for (int l = 0; l < a.num_lights; ++l)
    any |= a.relevant[(l * n + r) * a.relevant_stride] != 0;
  if (!any) {
    for (int l = 0; l < a.num_lights; ++l) {
      const long long e = l * n + r;
      a.out[e] = 0.0f;
      a.out[total + e] = 0.0f;
      a.out[2 * total + e] = 0.0f;
    }
    return;
  }
  const auto at = [&](int k, long long i) {
    return __ldg(a.plane[k] + i * a.stride[k]);
  };
  disney::Mat m;
  m.color = {at(0, r), at(1, r), at(2, r)};
  m.subsurface = at(3, r);
  m.metallic = at(4, r);
  m.roughness = at(5, r);
  m.specular = at(6, r);
  m.specular_tint = at(7, r);
  m.anisotropic = at(8, r);
  m.sheen_tint = at(9, r);
  m.clearcoat = at(10, r);
  m.clearcoat_gloss = at(11, r);
  const disney::ViewTerms w = disney::view_terms(
      m, {at(12, r), at(13, r), at(14, r)}, {at(15, r), at(16, r), at(17, r)});
  for (int l = 0; l < a.num_lights; ++l) {
    const long long e = l * n + r;
    disney::Vec f = {0.0f, 0.0f, 0.0f};
    if (a.relevant[e * a.relevant_stride])
      f = disney::brdf(m, w, {at(18, e), at(19, e), at(20, e)});
    a.out[e] = f.x;
    a.out[total + e] = f.y;
    a.out[2 * total + e] = f.z;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int hrt_brdf_light_major(BrdfArgs args, void* stream) {
  if (args.n <= 0 || args.num_lights <= 0) return 0;
  const int blocks = (args.n + kThreads - 1) / kThreads;
  brdf_light_major_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
