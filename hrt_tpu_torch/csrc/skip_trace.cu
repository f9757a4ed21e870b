// Binary skip-link walk (K3), one thread per ray: closest hit and any hit.
//
// Replaces the Pallas kernel of hrt_tpu/ops/traversal_pallas.py
// (`_trace_tiles`, body `_make_kernel`).  The TPU kernel walks a tile of
// rays with one scalar cursor over the skip-link table (FlatBVH, DFS
// preorder): the whole tile descends (cursor + 1) when any ray hits an
// internal node, else jumps the subtree (skip link), and every hit leaf
// runs K Möller-Trumbore tests for the whole tile.  Here each ray walks
// alone with its own cursor, with the same table and the same order, so
// a ray tests the same leaves the packet walk tests for it whenever its
// closest hit is among them:
//
//   cur = 0; while cur < m_real:
//     internal node hit  -> cur + 1
//     leaf hit           -> K tests at pool slot leaf_code - 1, then skip
//     miss               -> skip
//
// No stack: the cursor, the ray with its slab-test terms, the live t and
// the best hit stay in registers.  Any-hit mode retires the ray at its
// first hit; a ray with t_max < 0 is dead and costs nothing.
//
// What bounds it on this card: latency.  Each step's next cursor depends
// on the node just loaded; a node costs eight 4-byte loads 512 bytes
// apart (the FlatBVH keeps word c of node i at (i / 128) * 1024 +
// c * 128 + i % 128, a TPU lane layout); the threads of a warp sit at
// different cursors once their paths part; and the skip-link order is
// fixed left-first, so a closest hit tightens t later than a walk that
// visits the nearer child first would.  The tables are small (168 KB for
// the culled 257-instance grid, 2.1 MB for a 33,125-instance TLAS), so
// they stay in the 50 MB L2: bandwidth is not the limit.  The design
// answers with read-only loads (__ldg), no stack at all, dead rays that
// leave at once, and rays in pixel order, so the threads of a warp
// mostly walk the same nodes.  A later PR could store each node as one
// 32-byte record (two 16-byte loads instead of eight 4-byte ones).
//
// Slab test, node reads and Möller-Trumbore: walk_common.cuh, shared with
// K1, K4 and K5.
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;

template <bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
skip_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmax, int n,
                  const int* __restrict__ nodes,
                  const float4* __restrict__ tris, int m_real,
                  int leaf_size, float t_min, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out,
                  unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  hrt::set_ray(r, ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]);
  float t = tmax[i];
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  if (t >= 0.0f) {  // t_max < 0 marks a dead ray
    int cur = 0;
    while (cur < m_real) {
      int code, skip;
      const bool hit = hrt::skip_node_test(nodes, cur, r, t_min, t, code,
                                           skip);
      if (hit && code == 0) {  // internal: descend
        ++cur;
        continue;
      }
      // Any hit: the first hit retires the ray.
      if (hit && hrt::leaf_hits<CLOSEST>(tris, code - 1, leaf_size, r,
                                         t_min, t, best, bu, bv) &&
          !CLOSEST)
        break;
      cur = skip;
    }
  }
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
// outputs may be null.  `nodes` is the (Mp / 128, 8, 128) skip-link table
// (float32 words, rows 6-7 int32 bits) over `m_real` nodes, `tris` the
// (T, 12) float32 pool.  Returns cudaGetLastError() after the launch.
extern "C" int hrt_skip_trace(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const float* tmax, int n, const float* nodes,
                              const float* tris, int m_real, int leaf_size,
                              float t_min, int closest, float* t_out,
                              int* tri_out, float* u_out, float* v_out,
                              unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (m_real < 1 || leaf_size < 1) return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nd = reinterpret_cast<const int*>(nodes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (closest) {
    skip_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, nd, t4, m_real, leaf_size, t_min,
        t_out, tri_out, u_out, v_out, occ_out);
  } else {
    skip_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, nd, t4, m_real, leaf_size, t_min,
        t_out, tri_out, u_out, v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
