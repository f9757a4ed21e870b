// Bilinear reprojection warp (K6): a block per tile of output pixels,
// threads over the tile's output floats.
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
// upscaler's (3840x2160, C = 3) 273.7 MB, 82 us.
//
// Design: a block owns kTile consecutive output pixels, whose C-float
// outputs are one contiguous span of `val`.  Phase 1, a thread per
// pixel: read px, py (coalesced), compute the four clamped tap offsets
// and weights into shared memory, write the validity byte (coalesced).
// Phase 2, the threads over the span, four consecutive floats each:
// float e is channel e % C of tile pixel e / C, so a warp writes 512
// contiguous bytes with 16-byte stores, and its tap reads are runs of C
// neighbouring channels of neighbouring source pixels.  (A thread per
// pixel looping over C puts a warp's stores and loads C floats apart,
// using a few bytes of each sector it touches.)  The image is read
// through its strides, so the upscaler's history, which its last
// convolution leaves channels-first in memory, is warped where it lies
// instead of being copied first.  The work is a gather of a few
// neighbouring rows at data-dependent addresses that L1 and L2 already
// serve: there is no tile of the source to stage ahead, so no
// shared-memory ring or TMA.
//
// floor(p) is clamped as a float before its conversion to int: px can
// reach ~1e10 where the projection clamps depth to 1e-6, and a float to
// int conversion out of range is undefined here, while XLA saturates.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;  // output pixels per block: one per thread

// img is read at y * sy + x * sx + k * sc (strides in floats).
__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ img, int hs, int ws, int c,
                     int sy, int sx, int sc, const float* __restrict__ px,
                     const float* __restrict__ py, int n,
                     float* __restrict__ val,
                     unsigned char* __restrict__ valid) {
  __shared__ int4 s_off[kTile];    // tap offsets into img, in floats
  __shared__ float4 s_w[kTile];    // w00, w10, w01, w11
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, n - p0);
  const int p = threadIdx.x;
  if (p < np) {
    const int i = p0 + p;
    const float x = px[i];
    const float y = py[i];
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = x - x0;
    const float fy = y - y0;
    const float xmax = static_cast<float>(ws - 1);
    const float ymax = static_cast<float>(hs - 1);
    // fmaxf returns 0 for a NaN coordinate, so every tap stays in the
    // image.
    const int xi = static_cast<int>(fminf(fmaxf(x0, 0.0f), xmax));
    const int yi = static_cast<int>(fminf(fmaxf(y0, 0.0f), ymax));
    const int xr = min(xi + 1, ws - 1);
    const int yd = min(yi + 1, hs - 1);
    s_off[p] = make_int4(yi * sy + xi * sx, yi * sy + xr * sx,
                         yd * sy + xi * sx, yd * sy + xr * sx);
    s_w[p] = make_float4((1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                         (1.0f - fx) * fy, fx * fy);
    valid[i] = (x >= 0.0f) & (x <= xmax) & (y >= 0.0f) & (y <= ymax);
  }
  __syncthreads();
  // The tile's span of np * c floats starts at p0 * c floats, a multiple
  // of 4 (kTile is), so a thread's four floats are one aligned float4
  // unless the ragged last tile ends inside them.
  const int m = np * c;
  float* out = val + static_cast<size_t>(p0) * c;
  for (int e = 4 * threadIdx.x; e < m; e += 4 * kThreads) {
    int q = e / c;
    int k = e - q * c;
    int4 o = s_off[q];
    float4 w = s_w[q];
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e + j < m) {
        const float* src = img + k * sc;
        r[j] = __ldg(src + o.x) * w.x + __ldg(src + o.y) * w.y +
               __ldg(src + o.z) * w.z + __ldg(src + o.w) * w.w;
      }
      if (++k == c) {  // the next float is the next pixel's channel 0
        k = 0;
        ++q;
        if (j < 3 && e + j + 1 < m) {
          o = s_off[q];
          w = s_w[q];
        }
      }
    }
    if (e + 4 <= m) {
      *reinterpret_cast<float4*>(out + e) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
      for (int j = 0; e + j < m; ++j) out[e + j] = r[j];
    }
  }
}

}  // namespace

// img: an (hs, ws, c) float32 view with strides (sy, sx, sc) in floats,
// every offset under 2^31.  px, py: n floats (the output grid,
// row-major).  val: n * c floats, 16-byte aligned; valid: n bytes (0 or
// 1).  Returns cudaGetLastError() after the launch.
extern "C" int hrt_warp_bilinear(const float* img, int hs, int ws, int c,
                                 int sy, int sx, int sc, const float* px,
                                 const float* py, int n, float* val,
                                 unsigned char* valid, void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || sy < 0 || sx < 0 || sc < 0 ||
      static_cast<long long>(hs - 1) * sy +
              static_cast<long long>(ws - 1) * sx +
              static_cast<long long>(c - 1) * sc >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(val) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int blocks = (n + kTile - 1) / kTile;
  warp_bilinear_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      img, hs, ws, c, sy, sx, sc, px, py, n, val, valid);
  return static_cast<int>(cudaGetLastError());
}
