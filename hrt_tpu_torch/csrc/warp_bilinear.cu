// Bilinear reprojection warp (K6): one thread per output pixel.
//
// Replaces the Pallas kernel of hrt_tpu/ops/warp_pallas.py
// (`warp_bilinear`, body `_make_kernel`, planner `_plan`).  That kernel
// stages a +-margin source window per 128x128 output tile into VMEM,
// because the TPU's HBM gathers are latency-bound per row, and flags
// every pixel whose motion leaves the window invalid.  The card gathers
// through L1 and L2 and has no use for the window, so this kernel
// computes the unbounded function of the JAX package's gather path,
// hrt_tpu/ops/denoise.py `_bilinear`, at every output pixel: taps at the
// clamped corner (clip(floor(py), 0, Hs-1), clip(floor(px), 0, Ws-1))
// and its right, lower and diagonal neighbours, each edge-clamped as
// `_shift` clamps them; weights from the unclamped fractions; the four
// products summed in `_bilinear`'s order; valid = 0 <= px <= Ws-1 and
// 0 <= py <= Hs-1.  Out-of-bounds pixels keep the clamped taps' value,
// as `_bilinear` does (SVGF reads it before it masks).
//
// Bound: memory.  Each pixel reads two coordinates and four C-float tap
// rows and writes C floats and one validity byte; neighbouring pixels
// share taps, so the source comes from DRAM about once.  SVGF's history
// fetch (1080p, C = 10) moves 184.6 MB, 55 us at 3.35 TB/s; the temporal
// upscaler's (3840x2160, C = 3) 273.7 MB, 82 us.  The design reads the
// coordinate planes with neighbouring threads on neighbouring addresses
// and loops over the C contiguous floats of each tap; its row-strided
// output writes are merged in L2.
//
// floor(p) is clamped as a float before its conversion to int: px can
// reach ~1e10 where the projection clamps depth to 1e-6, and a float to
// int conversion out of range is undefined here, while XLA saturates.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ img, int hs, int ws, int c,
                     const float* __restrict__ px,
                     const float* __restrict__ py, int n,
                     float* __restrict__ val,
                     unsigned char* __restrict__ valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = px[i];
  const float y = py[i];
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  const float xmax = static_cast<float>(ws - 1);
  const float ymax = static_cast<float>(hs - 1);
  // fmaxf returns 0 for a NaN coordinate, so every tap stays in the image.
  const int xi = static_cast<int>(fminf(fmaxf(x0, 0.0f), xmax));
  const int yi = static_cast<int>(fminf(fmaxf(y0, 0.0f), ymax));
  const int xr = min(xi + 1, ws - 1);
  const int yd = min(yi + 1, hs - 1);
  const float w00 = (1.0f - fx) * (1.0f - fy);
  const float w10 = fx * (1.0f - fy);
  const float w01 = (1.0f - fx) * fy;
  const float w11 = fx * fy;
  const size_t cs = static_cast<size_t>(c);
  const float* a = img + (static_cast<size_t>(yi) * ws + xi) * cs;
  const float* b = img + (static_cast<size_t>(yi) * ws + xr) * cs;
  const float* d = img + (static_cast<size_t>(yd) * ws + xi) * cs;
  const float* e = img + (static_cast<size_t>(yd) * ws + xr) * cs;
  float* out = val + static_cast<size_t>(i) * cs;
  for (int k = 0; k < c; ++k) {
    out[k] = a[k] * w00 + b[k] * w10 + d[k] * w01 + e[k] * w11;
  }
  valid[i] = (x >= 0.0f) & (x <= xmax) & (y >= 0.0f) & (y <= ymax);
}

}  // namespace

// img: (hs, ws, c) float32, row-major.  px, py: n floats (the output
// grid, row-major).  val: n * c floats; valid: n bytes (0 or 1).
// Returns cudaGetLastError() after the launch.
extern "C" int hrt_warp_bilinear(const float* img, int hs, int ws, int c,
                                 const float* px, const float* py, int n,
                                 float* val, unsigned char* valid,
                                 void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  warp_bilinear_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      img, hs, ws, c, px, py, n, val, valid);
  return static_cast<int>(cudaGetLastError());
}
