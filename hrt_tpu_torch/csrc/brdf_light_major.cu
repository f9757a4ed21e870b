// Light-major Disney BRDF: one thread per (light, ray) element of an
// L x N batch.
//
// Replaces the Pallas kernel of hrt_tpu/ops/shade_pallas.py
// (`_brdf_light_major`, body `_make_kernel`).  The TPU kernel skips an
// (8, 128) group of rays when none of them is relevant; here the skip is
// a per-thread branch on the element's own `relevant` byte.  On the card
// the pass is bound by arithmetic per byte: each element reads 18
// per-ray floats (shared by the L lights, so mostly L2 hits) plus four
// of its own and writes three, against a few hundred flops of Disney
// terms.  The simple design keeps every term in registers (disney.cuh),
// reads each plane with neighbouring threads on neighbouring addresses,
// and does no work for irrelevant elements (sky, back-facing or below
// the light threshold), which write zero.
#include <cuda_runtime.h>

#include "disney.cuh"

namespace {

constexpr int kThreads = 256;

// shared: 18 planes of n floats, in the order of hrt_tpu/ops/
// shade_pallas.py: color xyz, subsurface, metallic, roughness, specular,
// specular_tint, anisotropic, sheen_tint, clearcoat, clearcoat_gloss,
// normal xyz, view xyz.  light: 3 planes of `total` = L * n floats.
__global__ void __launch_bounds__(kThreads)
brdf_light_major_kernel(const float* __restrict__ shared,
                        const float* __restrict__ light,
                        const unsigned char* __restrict__ relevant, int n,
                        int total, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  disney::Vec f = {0.0f, 0.0f, 0.0f};
  if (relevant[i]) {
    const int r = i % n;
    const float* p = shared + r;
    const size_t s = static_cast<size_t>(n);
    disney::Mat m;
    m.color = {p[0], p[s], p[2 * s]};
    m.subsurface = p[3 * s];
    m.metallic = p[4 * s];
    m.roughness = p[5 * s];
    m.specular = p[6 * s];
    m.specular_tint = p[7 * s];
    m.anisotropic = p[8 * s];
    m.sheen_tint = p[9 * s];
    m.clearcoat = p[10 * s];
    m.clearcoat_gloss = p[11 * s];
    const disney::Vec nrm = {p[12 * s], p[13 * s], p[14 * s]};
    const disney::Vec view = {p[15 * s], p[16 * s], p[17 * s]};
    const size_t t = static_cast<size_t>(total);
    const disney::Vec l = {light[i], light[t + i], light[2 * t + i]};
    f = disney::brdf(m, nrm, view, l);
  }
  const size_t t = static_cast<size_t>(total);
  out[i] = f.x;
  out[t + i] = f.y;
  out[2 * t + i] = f.z;
}

}  // namespace

// out: 3 planes of `total` floats.  Returns cudaGetLastError() after the
// launch.
extern "C" int hrt_brdf_light_major(const float* shared, const float* light,
                                    const unsigned char* relevant, int n,
                                    int total, float* out, void* stream) {
  if (total <= 0) return 0;
  const int blocks = (total + kThreads - 1) / kThreads;
  brdf_light_major_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      shared, light, relevant, n, total, out);
  return static_cast<int>(cudaGetLastError());
}
