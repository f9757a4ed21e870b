// BVH8 walk, one thread per ray: closest hit and any hit.
//
// Replaces the Pallas kernel of hrt_tpu/ops/traversal_wide8.py
// (`_trace_tiles_wide8`, body `_make_kernel`, exact node-test mode).
// The TPU kernel walks a 1024-ray tile with one scalar stack and pays a
// vector->scalar crossing per decision; on the GPU each ray walks alone,
// so the walk is bound by dependent global loads (a node's 8 child
// records, then K triangles per hit leaf) and by warp divergence when
// neighbouring rays take different paths.  The simple design here keeps
// the loads few and wide: one child is two 16-byte loads of its 8
// record words, one triangle three 16-byte loads of the (T, 12) v0|e1|e2
// table, all through the read-only cache; the node's internal-hit mask
// rides one stack entry (base << 8 | mask) per tree level, so the stack
// is depth + 1 entries, sized on the host.  Rays keep their pixel order,
// so neighbours in a warp are neighbours on screen and mostly walk the
// same nodes.
//
// Record decode, slab test and Möller-Trumbore: walk_common.cuh, shared
// with K3, K4 and K5.
#include <cuda_runtime.h>

#include "walk_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;

template <int STACK, bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
bvh8_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                  const float* __restrict__ oz, const float* __restrict__ dx,
                  const float* __restrict__ dy, const float* __restrict__ dz,
                  const float* __restrict__ tmax, int n,
                  const int* __restrict__ rec,
                  const float4* __restrict__ tris, int leaf_size,
                  float t_min, float* __restrict__ t_out,
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
    int stack[STACK];
    stack[0] = 1;   // root: base 0, one internal child of rank 0
    int sp = 1;
    while (sp > 0) {
      const int e = stack[--sp];
      const int mask = e & 255;
      const int base_e = e >> 8;
      const int low = mask & -mask;
      const int rem = mask ^ low;
      if (rem) stack[sp++] = (base_e << 8) | rem;
      const int cur = base_e + __ffs(low) - 1;
      const int* node = hrt::node_ptr(rec, cur);
      const int first_child = __ldg(node + 7);
      int int_mask = 0;
      for (int j = 0; j < 8; ++j) {
        bool hit;
        const int meta = hrt::child_test(node, j, r, t_min, t, hit);
        if (meta == 0) break;  // empties are last
        if (!hit) continue;
        if (meta < 0) {
          int_mask |= 1 << (-meta - 1);
          continue;
        }
        // Any hit: the first hit retires the ray.
        if (hrt::leaf_hits<CLOSEST>(tris, meta - 1, leaf_size, r, t_min, t,
                                    best, bu, bv) && !CLOSEST)
          goto done;
      }
      if (int_mask) stack[sp++] = (first_child << 8) | int_mask;
    }
  }
done:
  if (CLOSEST) {
    t_out[i] = t;
    tri_out[i] = best;
    u_out[i] = bu;
    v_out[i] = bv;
  } else {
    occ_out[i] = best >= 0 ? 1 : 0;
  }
}

template <int STACK>
void launch(bool closest, int blocks, cudaStream_t s, const float* ox,
            const float* oy, const float* oz, const float* dx,
            const float* dy, const float* dz, const float* tmax, int n,
            const int* rec, const float4* tris, int leaf_size, float t_min,
            float* t_out, int* tri_out, float* u_out, float* v_out,
            unsigned char* occ_out) {
  if (closest) {
    bvh8_trace_kernel<STACK, true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, leaf_size, t_min,
        t_out, tri_out, u_out, v_out, occ_out);
  } else {
    bvh8_trace_kernel<STACK, false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, leaf_size, t_min,
        t_out, tri_out, u_out, v_out, occ_out);
  }
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (leaf-pool id, -1 on a
// miss), u and v; any-hit mode writes occ (1 where blocked).  The
// unused outputs may be null.  `stack_size` is the wide tree's depth + 1
// (at most 32).  Returns cudaGetLastError() after the launch.
extern "C" int hrt_bvh8_trace(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const float* tmax, int n, const int* records,
                              const float* tris, int leaf_size, float t_min,
                              int stack_size, int closest, float* t_out,
                              int* tri_out, float* u_out, float* v_out,
                              unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (stack_size < 1 || stack_size > 32) return cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (stack_size <= 8) {
    launch<8>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n,
              records, t4, leaf_size, t_min, t_out, tri_out, u_out, v_out,
              occ_out);
  } else if (stack_size <= 16) {
    launch<16>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n,
               records, t4, leaf_size, t_min, t_out, tri_out, u_out, v_out,
               occ_out);
  } else {
    launch<32>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax, n,
               records, t4, leaf_size, t_min, t_out, tri_out, u_out, v_out,
               occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
