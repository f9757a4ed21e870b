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
// Record layout (hrt_tpu_torch/ops/wide8.py): child j of wide node q is
// the 8 int32 words at (q / 16) * 1024 + j * 128 + (q % 16) * 8: six box
// floats as bits, the meta word (> 0 leaf tri_start + 1, < 0 internal of
// rank -(meta + 1), 0 empty), and on slot 0 the id of the node's first
// internal child.  Slots are leaf-first, then internal, then empty.
#include <cuda_runtime.h>

namespace {

constexpr int kRowWords = 1024;   // 16 nodes x 8 slots x 8 words
constexpr int kSlotWords = 128;
constexpr int kThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz, oix, oiy, oiz;
};

__device__ __forceinline__ float safe_inv(float c) {
  const float tiny = 1e-20f;
  float s = fabsf(c) < tiny ? (c < 0.0f ? -tiny : tiny) : c;
  return 1.0f / s;
}

// Möller-Trumbore, term for term as hrt_tpu/ops/traversal_pallas.py
// `_moller`: |det| > 1e-12, u, v >= 0, u + v <= 1, t_min < t < t_limit.
__device__ __forceinline__ bool moller(const float4* tri, const Ray& r,
                                       float t_min, float t_limit,
                                       float& t, float& u, float& v) {
  const float4 a = __ldg(tri);
  const float4 b = __ldg(tri + 1);
  const float4 c = __ldg(tri + 2);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = ok ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min &&
         t < t_limit;
}

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
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = safe_inv(r.dx); r.iy = safe_inv(r.dy); r.iz = safe_inv(r.dz);
  r.oix = r.ox * r.ix; r.oiy = r.oy * r.iy; r.oiz = r.oz * r.iz;
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
      const int* node = rec + (cur >> 4) * kRowWords + (cur & 15) * 8;
      const int first_child = __ldg(node + 7);
      int int_mask = 0;
      for (int j = 0; j < 8; ++j) {
        const int4* w = reinterpret_cast<const int4*>(node + j * kSlotWords);
        const int4 w0 = __ldg(w);
        const int4 w1 = __ldg(w + 1);
        const int meta = w1.z;
        if (meta == 0) break;  // empties are last
        const float tx0 = __int_as_float(w0.x) * r.ix - r.oix;
        const float ty0 = __int_as_float(w0.y) * r.iy - r.oiy;
        const float tz0 = __int_as_float(w0.z) * r.iz - r.oiz;
        const float tx1 = __int_as_float(w0.w) * r.ix - r.oix;
        const float ty1 = __int_as_float(w1.x) * r.iy - r.oiy;
        const float tz1 = __int_as_float(w1.y) * r.iz - r.oiz;
        const float t_near =
            fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                  fmaxf(fminf(tz0, tz1), t_min));
        const float t_far =
            fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                  fminf(fmaxf(tz0, tz1), t));
        if (!(t_near <= t_far)) continue;
        if (meta < 0) {
          int_mask |= 1 << (-meta - 1);
          continue;
        }
        const float4* tp = tris + static_cast<size_t>(meta - 1) * 3;
        for (int k = 0; k < leaf_size; ++k) {
          float th, uh, vh;
          if (moller(tp + 3 * k, r, t_min, t, th, uh, vh)) {
            best = meta - 1 + k;
            if (!CLOSEST) goto done;  // any hit: first hit retires the ray
            t = th; bu = uh; bv = vh;
          }
        }
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
