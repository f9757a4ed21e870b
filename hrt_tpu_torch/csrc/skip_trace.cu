// Binary skip-link walk (K3), a warp of 32 rays walking together: closest
// hit and any hit.
//
// Replaces the Pallas kernel of hrt_tpu/ops/traversal_pallas.py
// (`_trace_tiles`, body `_make_kernel`).  The TPU kernel walks a tile of
// rays with one scalar cursor over the skip-link table (FlatBVH, DFS
// preorder): the whole tile descends (cursor + 1) when any ray hits an
// internal node, else jumps the subtree (skip link), and every hit leaf
// runs K Möller-Trumbore tests for the whole tile.  Each ray's own walk
// is
//
//   cur = 0; while cur < m_real:
//     internal node hit  -> cur + 1
//     leaf hit           -> K tests at pool slot leaf_code - 1, then skip
//     miss               -> skip
//
// and here each thread keeps that walk's cursor, so every ray visits
// exactly the nodes and leaves of its own walk, in its order: the result
// is the per-ray walk's (traversal_skip.trace_plain), whatever the boxes.
// A warp steps its lanes together: each step takes the smallest cursor of
// the warp's live lanes (__reduce_min_sync), and the lanes at it test that
// node while the others wait.  The cursors only grow and the table is in
// preorder, so the warp visits the union of its rays' nodes once each.
// Any-hit mode retires a ray at its first hit; a ray with t_max < 0 is
// dead from the start, and a warp leaves once all its rays are done.
//
// What bounds it on this card: the triangle tests.  On the culled frame's
// LBVH (flat-slab leaves; ops/traversal_skip.py `visit_counts`) a primary
// ray enters ~530 leaves of 32 triangles and ~1,140 nodes, ~17,000
// Möller-Trumbore tests, nearly all misses, and the rays of a warp
// (consecutive pixels) enter nearly the same leaves.  The design:
// - The warp walks as one packet, so a node's 32-byte record (two 16-byte
//   loads, skip_common.cuh `skip_rec_test`, instead of the TPU lane
//   layout's eight 4-byte loads 512 bytes apart) is one address for the
//   whole warp.
// - At a leaf that any lane hits, lane k copies triangle k (three 16-byte
//   loads, coalesced) into the warp's slice of shared memory, 32 at a
//   time; the lanes that hit then read the triangles from there, the same
//   address across the warp (a broadcast), instead of each lane issuing
//   the leaf's 96 loads through L1.
// - Each test is skip_common.cuh `moller_scaled`: no division until a
//   triangle passes every range test, and the u range first.
// - Closest mode unrolls the leaf loop by 4.  Any-hit mode asks for 12
//   blocks an SM, which caps it at 40 registers (a 4-byte spill), so a
//   512x384 shadow batch runs in one wave.  PERF.md has both kernels'
//   times with and without these two settings.
// A warp whose lanes walk apart instead (each lane at its own node) has
// divergent loads, and its steps mix node tests with leaf loops.
//
// Slab test: walk_common.cuh (shared with K1, K4, K5); the record read
// and the triangle test: skip_common.cuh (K3's own).
#include <cuda_runtime.h>

#include "skip_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool CLOSEST>
__global__ void __launch_bounds__(kThreads, CLOSEST ? 1 : 12)
skip_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmax, int n,
                  const int4* __restrict__ rec,
                  const float4* __restrict__ tris, int m_real,
                  int leaf_size, float t_min, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out,
                  unsigned char* __restrict__ occ_out) {
  __shared__ float4 s_tris[kWarps][32 * 3];
  float4* st = s_tris[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  // Every lane of the warp takes part in its votes; lanes past n are dead.
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = min(i, n - 1);
  Ray r;
  hrt::set_ray(r, ox[j], oy[j], oz[j], dx[j], dy[j], dz[j]);
  float t = tmax[j];
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  int cur = (i < n && t >= 0.0f) ? 0 : m_real;  // t_max < 0: dead
  while (true) {
    const int w = __reduce_min_sync(kFull, cur);
    if (w >= m_real) break;
    const bool here = cur == w;
    int code, skip;
    const bool hit =
        hrt::skip_rec_test(rec, w, r, t_min, t, code, skip) && here;
    if (here) cur = (hit && code == 0) ? w + 1 : skip;
    if (code == 0 || !__any_sync(kFull, hit)) continue;
    // A leaf that some lane hits: its triangles, 32 at a time.
    const int start = code - 1;
    bool testing = hit;
    for (int k0 = 0; k0 < leaf_size; k0 += 32) {
      const int kn = min(32, leaf_size - k0);
      __syncwarp();  // the last chunk's reads are done
      if (lane < kn) {
        const float4* src = tris + static_cast<size_t>(start + k0 + lane) * 3;
        st[3 * lane] = __ldg(src);
        st[3 * lane + 1] = __ldg(src + 1);
        st[3 * lane + 2] = __ldg(src + 2);
      }
      __syncwarp();
      if (testing) {
#pragma unroll (CLOSEST ? 4 : 1)
        for (int k = 0; k < kn; ++k) {
          float th, uh, vh;
          if (hrt::moller_scaled(st[3 * k], st[3 * k + 1], st[3 * k + 2], r,
                                 t_min, t, th, uh, vh)) {
            best = start + k0 + k;
            if (!CLOSEST) {  // any hit: the first hit retires the ray
              testing = false;
              cur = m_real;
              break;
            }
            t = th;
            bu = uh;
            bv = vh;
          }
        }
      }
      if (!CLOSEST && !__any_sync(kFull, testing)) break;
    }
  }
  if (i >= n) return;
  if (CLOSEST) {
    t_out[i] = t;
    tri_out[i] = best;
    u_out[i] = bu;
    v_out[i] = bv;
  } else {
    occ_out[i] = best >= 0 ? 1 : 0;
  }
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (leaf-pool id, -1 on a
// miss), u and v; any-hit mode writes occ (1 where blocked).  The unused
// outputs may be null.  `rec` is the (m_real, 8) int32 node record table
// (16-byte aligned), `tris` the (T, 12) float32 pool.  Returns
// cudaGetLastError() after the launch.
extern "C" int hrt_skip_trace(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const float* tmax, int n, const int* rec,
                              const float* tris, int m_real, int leaf_size,
                              float t_min, int closest, float* t_out,
                              int* tri_out, float* u_out, float* v_out,
                              unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (m_real < 1 || leaf_size < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(rec) % 16 != 0 ||
      reinterpret_cast<size_t>(tris) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(rec);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (closest) {
    skip_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, r4, t4, m_real, leaf_size, t_min,
        t_out, tri_out, u_out, v_out, occ_out);
  } else {
    skip_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, r4, t4, m_real, leaf_size, t_min,
        t_out, tri_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
