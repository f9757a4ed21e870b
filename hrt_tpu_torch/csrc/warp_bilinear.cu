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
//
// The backward (`hrt_warp_bilinear_backward`) is the adjoint of the
// fetch with respect to the image, the gradient that autodiff of
// `_bilinear` gives (the recurrent fine-tune of
// scripts/train_upscaler.py differentiates through the warp; the
// coordinates come from the G-buffer and get none): each output
// pixel's grad_val[p, k] goes into its four clamped taps' channel k,
// weighted by w00, w10, w01, w11.  It reuses the forward's taps and
// weights (`bilinear_taps`), clamp included.  Several pixels share a
// tap, and at the edges one pixel's clamped taps coincide, so the adds
// are float atomicAdds into a zeroed, contiguous (Hs, Ws, C) buffer;
// their order, and so the sum's last bits, change from run to run.
// Bound: memory, grad_val and the coordinates read once and grad_img
// written once (the trainer's 256x256 C = 3 history: 2.1 MB, 0.63 us at
// 3.35 TB/s; the 3840x2160 one 265 MB, 79 us); the zero fill the
// atomics need is this design's cost on top.  The layout
// is the forward's: a tile's taps in shared memory, then the threads
// over its contiguous grad_val floats, one each, so the reads coalesce
// and a warp's adds land on runs of neighbouring channels of
// neighbouring source pixels.  Every pixel clamped onto an edge tap
// adds there, so those adds serialise: on an H100 this runs ~140-175x
// its bound when many pixels leave the image.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;  // output pixels per block: one per thread

// The four taps of a fetch at (x, y): their offsets (the image's
// strides sy, sx in floats) and weights w00, w10, w01, w11.
__device__ __forceinline__ void bilinear_taps(float x, float y, int hs,
                                              int ws, int sy, int sx,
                                              int4* off, float4* w) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  // fmaxf returns 0 for a NaN coordinate, so every tap stays in the
  // image.
  const int xi = static_cast<int>(fminf(fmaxf(x0, 0.0f),
                                        static_cast<float>(ws - 1)));
  const int yi = static_cast<int>(fminf(fmaxf(y0, 0.0f),
                                        static_cast<float>(hs - 1)));
  const int xr = min(xi + 1, ws - 1);
  const int yd = min(yi + 1, hs - 1);
  *off = make_int4(yi * sy + xi * sx, yi * sy + xr * sx,
                   yd * sy + xi * sx, yd * sy + xr * sx);
  *w = make_float4((1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                   (1.0f - fx) * fy, fx * fy);
}

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
    bilinear_taps(x, y, hs, ws, sy, sx, &s_off[p], &s_w[p]);
    valid[i] = (x >= 0.0f) & (x <= static_cast<float>(ws - 1)) &
               (y >= 0.0f) & (y <= static_cast<float>(hs - 1));
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

// grad_img (contiguous, zeroed) += the adjoint of the fetch applied to
// grad_val (contiguous (n, c)).
__global__ void __launch_bounds__(kThreads)
warp_bilinear_backward_kernel(const float* __restrict__ grad_val, int hs,
                              int ws, int c, const float* __restrict__ px,
                              const float* __restrict__ py, int n,
                              float* __restrict__ grad_img) {
  __shared__ int4 s_off[kTile];
  __shared__ float4 s_w[kTile];
  const int p0 = blockIdx.x * kTile;
  const int np = min(kTile, n - p0);
  const int p = threadIdx.x;
  if (p < np) {
    bilinear_taps(px[p0 + p], py[p0 + p], hs, ws, ws * c, c, &s_off[p],
                  &s_w[p]);
  }
  __syncthreads();
  const int m = np * c;
  const float* g = grad_val + static_cast<size_t>(p0) * c;
  for (int e = threadIdx.x; e < m; e += kThreads) {
    const int q = e / c;
    const int k = e - q * c;
    const int4 o = s_off[q];
    const float4 w = s_w[q];
    const float v = g[e];
    atomicAdd(grad_img + o.x + k, v * w.x);
    atomicAdd(grad_img + o.y + k, v * w.y);
    atomicAdd(grad_img + o.z + k, v * w.z);
    atomicAdd(grad_img + o.w + k, v * w.w);
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

// grad_val: n * c floats (the output grid row-major, channels last);
// px, py: n floats; grad_img: hs * ws * c floats, zeroed by the caller,
// every offset under 2^31.  Adds the adjoint of hrt_warp_bilinear with
// respect to the image into grad_img.  Returns cudaGetLastError() after
// the launch.
extern "C" int hrt_warp_bilinear_backward(const float* grad_val, int hs,
                                          int ws, int c, const float* px,
                                          const float* py, int n,
                                          float* grad_img, void* stream) {
  if (n <= 0) return 0;
  if (c < 1 || hs < 1 || ws < 1 ||
      static_cast<long long>(hs) * ws * c >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int blocks = (n + kTile - 1) / kTile;
  warp_bilinear_backward_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      grad_val, hs, ws, c, px, py, n, grad_img);
  return static_cast<int>(cudaGetLastError());
}
