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
// products summed in `_bilinear`'s order, each operation rounded on its
// own (`tap_sum`), so that the result equals the plain version's bit
// for bit; valid = 0 <= px <= Ws-1 and
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
// weighted by w00, w10, w01, w11, with the forward's taps and weights
// (`bilinear_corner`), clamp included.  The adds are float atomics into
// a zeroed, contiguous (Hs, Ws, C) buffer, so their order, and the
// sum's last bits, change from run to run.
// Bound: memory, grad_val and the coordinates read once and grad_img
// written once (the trainer's 256x256 C = 3 history: 2.1 MB, 0.63 us at
// 3.35 TB/s; the 3840x2160 one 265 MB, 79 us); the zero fill the adds
// need is this design's cost on top.
// What holds a scatter back here is adds to one address, which
// serialise in L2: every sky pixel's G-buffer position is the world
// origin, so all of them project onto the same four taps, and every
// pixel that leaves the image clamps onto an edge tap (up to ~1.3M
// adds on one tap at 4K).  The design takes those adds apart in four
// steps, a thread per output pixel over its C channels, kBwdChunk at a
// pass, a block per 32 x 8 tile of output pixels:
// 1. A product v * w that is exactly +-0 is not added.  This is exact:
//    grad_img starts at +0, no sum of floats that starts at +0 reaches
//    -0, and x + (+-0) == x for every other x.  The test is on the
//    product, so a NaN or Inf gradient still adds (NaN * 0 is NaN),
//    where the plain adjoint puts it.  The trainer masks the gradient
//    of every sky and off-image pixel to 0 (`reproject_history`), so
//    there this step drops all of the coincident adds.
// 2. A pixel clamped onto an edge has coincident taps (xr == xi or
//    yd == yi): their products are summed in the thread first.
// 3. A warp merges equal taps: per tap slot, __match_any_sync on the
//    tap's pixel index groups the lanes that add there, a tree of
//    shuffles in lane-rank order sums each group's products (__fns
//    finds a rank's lane), and the group's lowest lane adds once.  A
//    warp whose groups are all single lanes skips the tree.
// 4. A block with a group of kWindowGroup lanes or more (a sky or an
//    edge cluster) whose taps fall in a window of at most kWindowFloats
//    floats of the image sums the groups there with shared-memory
//    atomics, then adds each nonzero float of the window to grad_img
//    once.  Any other block adds each group's sum to grad_img directly:
//    with fewer lanes on a tap, the window's barriers cost more than
//    the adds they save.
// kWindowFloats = 0 leaves step 4 out (the warp-level design).  The
// block's warps share a barrier only for step 4's decision, and 64
// registers a thread (kBwdMinBlocks) keep four blocks on an SM.  What
// is left above the bound is not the adds (the kernel without them
// takes most of its time, PERF.md) but each block's chain of dependent
// loads, warp votes and barriers, with 32 warps an SM to cover it.
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 128;  // output pixels per block: one per thread

// The clamped corner (xi, yi) of a fetch at (x, y), its right and lower
// neighbours (xr, yd), edge-clamped, and the weights w00, w10, w01, w11.
__device__ __forceinline__ void bilinear_corner(float x, float y, int hs,
                                                int ws, int* xi, int* yi,
                                                int* xr, int* yd,
                                                float4* w) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;
  // fmaxf returns 0 for a NaN coordinate, so every tap stays in the
  // image.
  *xi = static_cast<int>(fminf(fmaxf(x0, 0.0f),
                               static_cast<float>(ws - 1)));
  *yi = static_cast<int>(fminf(fmaxf(y0, 0.0f),
                               static_cast<float>(hs - 1)));
  *xr = min(*xi + 1, ws - 1);
  *yd = min(*yi + 1, hs - 1);
  *w = make_float4((1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                   (1.0f - fx) * fy, fx * fy);
}

// The four taps of a fetch at (x, y): their offsets (the image's
// strides sy, sx in floats) and weights w00, w10, w01, w11.
__device__ __forceinline__ void bilinear_taps(float x, float y, int hs,
                                              int ws, int sy, int sx,
                                              int4* off, float4* w) {
  int xi, yi, xr, yd;
  bilinear_corner(x, y, hs, ws, &xi, &yi, &xr, &yd, w);
  *off = make_int4(yi * sy + xi * sx, yi * sy + xr * sx,
                   yd * sy + xi * sx, yd * sy + xr * sx);
}

// The weighted sum of the four taps at src + o.{x,y,z,w}, rounded as
// the plain version (ops/warp_kernel.py `warp_bilinear_plain`) rounds
// it: each product, then ((p00 + p10) + p01) + p11, one rounding an
// operation.  The intrinsics keep nvcc from contracting a product and
// an add into an FMA, which rounds once and so differs in the last bit
// from the plain version; the recurrent fine-tune carries such bits
// through 16 frames into its gradients.
__device__ __forceinline__ float tap_sum(const float* src, int4 o,
                                         float4 w) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__ldg(src + o.x), w.x),
                                       __fmul_rn(__ldg(src + o.y), w.y)),
                             __fmul_rn(__ldg(src + o.z), w.z)),
                   __fmul_rn(__ldg(src + o.w), w.w));
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
        r[j] = tap_sum(img + k * sc, o, w);
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

// Every add of the backward to grad_img, in one place (the probe's
// no_adds ablation, scripts/torch_k6_backward_probe.py, drops them here).
__device__ __forceinline__ void add_global(float* dst, float v) {
  atomicAdd(dst, v);
}

constexpr int kBwdW = 32;  // a block's tile of output pixels: a warp a row
constexpr int kBwdH = 8;
constexpr int kBwdThreads = kBwdW * kBwdH;  // one output pixel a thread
constexpr int kBwdChunk = 3;      // channels summed per pass
constexpr int kBwdMinBlocks = 4;  // blocks an SM: at most 64 registers
constexpr int kWindowFloats = 4096;  // the block's window: 16 KB
constexpr int kWindowGroup = 8;   // lanes on one tap that call for it
constexpr unsigned kFull = 0xffffffffu;

// grad_img (contiguous, zeroed) += the adjoint of the fetch applied to
// grad_val (contiguous (ho, wo, c)); block (bx, by) takes the output
// tile of kBwdW x kBwdH pixels at (bx * kBwdW, by * kBwdH).
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
warp_bilinear_backward_kernel(const float* __restrict__ grad_val, int hs,
                              int ws, int c, const float* __restrict__ px,
                              const float* __restrict__ py, int ho, int wo,
                              float* __restrict__ grad_img) {
  __shared__ float s_win[kWindowFloats > 0 ? kWindowFloats : 1];
  __shared__ int s_box[kBwdThreads / 32][4];
  const int lane = threadIdx.x & 31;
  const int ox = blockIdx.x * kBwdW + threadIdx.x % kBwdW;
  const int oy = blockIdx.y * kBwdH + threadIdx.x / kBwdW;
  const bool in = ox < wo && oy < ho;
  const int i = in ? oy * wo + ox : 0;
  int tx[4], ty[4];  // slot j's tap: x from bit 0 of j, y from bit 1
  float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool live[4] = {false, false, false, false};
  const float* g = grad_val + static_cast<size_t>(i) * c;
  {
    int xi = 0, yi = 0, xr = 0, yd = 0;
    if (in) {
      bilinear_corner(px[i], py[i], hs, ws, &xi, &yi, &xr, &yd, &w);
      // A coincident tap (clamped onto the edge) is folded into slot 0
      // or 2 (step 2); live[j] says which slots still add.
      live[0] = true;
      live[1] = xr != xi;
      live[2] = yd != yi;
      live[3] = live[1] && live[2];
    }
    tx[0] = tx[2] = xi;
    tx[1] = tx[3] = xr;
    ty[0] = ty[1] = yi;
    ty[2] = ty[3] = yd;
  }
  const float wj[4] = {w.x, w.y, w.z, w.w};

  // The products of channels k0 .. k0 + kBwdChunk - 1, coincident taps
  // folded; on[j]: slot j has a product that is not +-0 (step 1).
  auto products = [&](int k0, float (&p)[4][kBwdChunk], bool (&on)[4]) {
#pragma unroll
    for (int k = 0; k < kBwdChunk; ++k) {
      const float v = (in && k0 + k < c) ? __ldg(g + k0 + k) : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j][k] = v * wj[j];
      if (!live[1]) {
        p[0][k] += p[1][k];
        p[2][k] += p[3][k];
      }
      if (!live[2]) {
        p[0][k] += p[2][k];
        p[1][k] += p[3][k];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < kBwdChunk; ++k)
        any |= (k0 + k < c) && p[j][k] != 0.0f;
      on[j] = live[j] && any;
    }
  };

  float p[4][kBwdChunk];  // the chunk of channels at hand
  bool on[4];             // slot j adds in this chunk
  products(0, p, on);
  bool adds[4];           // slot j adds in some chunk
#pragma unroll
  for (int j = 0; j < 4; ++j) adds[j] = on[j];
  for (int k0 = kBwdChunk; k0 < c; k0 += kBwdChunk) {
    float q[4][kBwdChunk];
    bool more[4];
    products(k0, q, more);
#pragma unroll
    for (int j = 0; j < 4; ++j) adds[j] |= more[j];
  }

  // Step 3's groups, per slot: the lanes that add at one tap (a lane
  // that adds nothing keys on a value no tap has).  `shared`: one of
  // this lane's taps takes adds from kWindowGroup lanes of the warp.
  unsigned grp[4];
  bool shared = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    grp[j] = 1u << lane;
    if (__any_sync(kFull, adds[j])) {
      const int key = adds[j] ? ty[j] * ws + tx[j] : -1 - lane;
      grp[j] = __match_any_sync(kFull, key);
      shared |= adds[j] && __popc(grp[j]) >= kWindowGroup;
    }
  }

  // Step 4's window: the box of the block's taps that add, taken when
  // some warp of the block has kWindowGroup lanes on one tap and the
  // box fits.  The warp merge alone serves fewer shared taps better.
  int bx0 = 0, by0 = 0, ww = 0, wh = 0;
  bool window = false;
  if (kWindowFloats > 0) {
    // x0, -x1, y0, -y1: minima all, so one reduction takes them.
    int box[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (adds[j]) {
        box[0] = min(box[0], tx[j]);
        box[1] = min(box[1], -tx[j]);
        box[2] = min(box[2], ty[j]);
        box[3] = min(box[3], -ty[j]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) box[e] = __reduce_min_sync(kFull, box[e]);
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_box[threadIdx.x / 32][e] = box[e];
    }
    shared = __syncthreads_or(shared);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      for (int wp = 0; wp < kBwdThreads / 32; ++wp)
        box[e] = min(box[e], s_box[wp][e]);
    }
    if (box[0] == INT_MAX) return;  // the whole block adds nothing
    bx0 = box[0];
    by0 = box[2];
    ww = 1 - box[1] - bx0;
    wh = 1 - box[3] - by0;
    const long long floats = static_cast<long long>(ww) * wh * c;
    window = shared && floats <= kWindowFloats;
    if (window) {
      for (int e = threadIdx.x; e < floats; e += kBwdThreads)
        s_win[e] = 0.0f;
      __syncthreads();
    }
  }

  for (int k0 = 0; k0 < c; k0 += kBwdChunk) {
    if (k0 > 0) products(k0, p, on);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!__any_sync(kFull, adds[j])) continue;
      // Step 3: sum each group's products in a tree over the lanes'
      // ranks in the group; its lowest lane adds the sum.
      const int size = __popc(grp[j]);
      const int most = __reduce_max_sync(kFull, size);
      bool lead = adds[j];
      if (most > 1) {
        const int rank = __popc(grp[j] & ((1u << lane) - 1u));
        for (int s = 1; s < most; s <<= 1) {
          const bool take = (rank & (2 * s - 1)) == 0 && rank + s < size;
          const int src = take ? static_cast<int>(__fns(grp[j], lane, s + 1))
                               : lane;
#pragma unroll
          for (int k = 0; k < kBwdChunk; ++k) {
            const float q = __shfl_sync(kFull, p[j][k], src);
            if (take) p[j][k] += q;
          }
        }
        lead = lead && rank == 0;
      }
      if (!lead) continue;
      if (window) {
        float* dst = s_win + ((ty[j] - by0) * ww + (tx[j] - bx0)) * c + k0;
#pragma unroll
        for (int k = 0; k < kBwdChunk; ++k) {
          if (k0 + k < c && p[j][k] != 0.0f) atomicAdd(dst + k, p[j][k]);
        }
      } else {
        float* dst = grad_img + (static_cast<size_t>(ty[j]) * ws + tx[j]) * c +
                     k0;
#pragma unroll
        for (int k = 0; k < kBwdChunk; ++k) {
          if (k0 + k < c && p[j][k] != 0.0f) add_global(dst + k, p[j][k]);
        }
      }
    }
  }

  if (window) {
    // Window row r, a warp's, is a run of ww * c floats of grad_img.
    __syncthreads();
    const int row = ww * c;
    for (int r = threadIdx.x / 32; r < wh; r += kBwdThreads / 32) {
      float* dst = grad_img + (static_cast<size_t>(by0 + r) * ws + bx0) * c;
      for (int e = lane; e < row; e += 32) {
        const float v = s_win[r * row + e];
        if (v != 0.0f) add_global(dst + e, v);
      }
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

// grad_val: ho * wo * c floats (the output grid row-major, channels
// last); px, py: ho * wo floats; grad_img: hs * ws * c floats, zeroed by
// the caller, every offset under 2^31.  Adds the adjoint of
// hrt_warp_bilinear with respect to the image into grad_img.  Returns
// cudaGetLastError() after the launch.
extern "C" int hrt_warp_bilinear_backward(const float* grad_val, int hs,
                                          int ws, int c, const float* px,
                                          const float* py, int ho, int wo,
                                          float* grad_img, void* stream) {
  if (ho <= 0 || wo <= 0) return 0;
  if (c < 1 || hs < 1 || ws < 1 ||
      static_cast<long long>(hs) * ws * c >= (1LL << 31) ||
      static_cast<long long>(ho) * wo * c >= (1LL << 31))
    return cudaErrorInvalidValue;
  const dim3 blocks((wo + kBwdW - 1) / kBwdW, (ho + kBwdH - 1) / kBwdH);
  warp_bilinear_backward_kernel<<<blocks, kBwdThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      grad_val, hs, ws, c, px, py, ho, wo, grad_img);
  return static_cast<int>(cudaGetLastError());
}
