// BVH8 walk (K1): a warp walks its 32 rays as one packet, closest hits
// nearest child first, any hits in slot order.
//
// Replaces the Pallas kernel of hrt_tpu/ops/traversal_wide8.py
// (`_trace_tiles_wide8`, body `_make_kernel`, exact node-test mode).
// The TPU kernel walks a 1024-ray tile with one scalar stack and pays a
// vector->scalar crossing per decision.  Here a warp reads a wide node
// as one 256-byte record (`Accel.w8_rec`, the (R, 8, 128) table
// repacked node by node: child j of node q at 64 q + 8 j words) instead
// of eight 32-byte records 512 bytes apart, and tests triangles with
// `moller_scaled` (no division until a triangle passes).
//
// What bounds it on this card: the walks are short (bench frame, per
// live ray: ~1.4 wide nodes, ~10 child boxes, ~0.6 leaves and ~20
// triangle tests for a primary ray, ~2 / ~14 / ~1.5 / ~43 for a shadow
// ray; traversal_wide8.visit_counts, PERF.md), a 512x384 batch is about
// one wave, so the warps with the longest walks set the time, and the
// wrapper's host cost per call is as long as the kernel.  The first
// port (6f624a9) walked a thread per ray in slot order (slots are
// leaf-first, so a closest ray tested every hit leaf of a node before
// it went nearer), read each child as two 16-byte loads 512 bytes from
// its sibling, and ran each 32-triangle leaf loop, with a division per
// test, as its lane reached it while the warp waited.
//
// The packet (`bvh8_packet_kernel`), K4's closest walk without the
// instance level; primary rays and the bench frame's shadow rays (from
// neighbouring pixels toward one light) are coherent.
// - Each item (a wide node or a leaf) carries the mask of the lanes that
//   hit its box; the others wait.  Lanes 0-15 copy a node's 256 bytes
//   into shared memory with one 16-byte load each and every lane
//   slab-tests the 8 child boxes from there.
// - Closest: hit children are ordered by the packet's entry distance
//   (the smallest of its lanes', __reduce_min_sync); any hit keeps the
//   slot order, leaves first.  The first is walked next, the others go
//   on the warp's stack in shared memory, last first, each with its box
//   and mask.  Popping an entry tests its box again against each lane's
//   live t, so a lane drops a subtree that its nearer hits have passed.
// - A leaf's triangles are staged in shared memory 32 at a time.  When
//   many lanes hit the leaf, each tests them all, reading them back as
//   broadcasts; when fewer than kLanesOverTriangles do, the lanes go
//   over the triangles instead, one ray at a time, so a leaf that one
//   ray enters costs one test per lane and a warp reduction rather than
//   32 tests in a row.  In any-hit mode a lane's first hit retires it
//   from every later mask.
// Each lane tests the boxes and triangles of a per-ray walk in the
// packet's order, so its closest hit equals the plain walk's up to
// equal-t ties.  A node visit keeps up to 7 of its children, so the
// stack holds at most 7 entries per wide level
// (traversal_wide8.stack_entries), sized on the host and templated
// 32 / 256.  Tried and not kept (PERF.md): any hit as a thread per ray
// with Aila & Laine's while-while leaves, 64-thread blocks, a
// launch-bounds register cap, the leaf loop not unrolled.
//
// A ray with t_max < 0 is dead from the start.  Slab test: walk_common
// .cuh; the staging, the entry-distance slab test and the triangle test:
// skip_common.cuh.
#include <cuda_runtime.h>

#include "skip_common.cuh"

namespace {

using hrt::Ray;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// A packet item or stack entry's target: payload << 1 | kind.
constexpr int kNode = 0, kLeaf = 1;
// Below this many live lanes a leaf's triangles go over the lanes.
constexpr int kLanesOverTriangles = 16;

// A leaf chunk with few live lanes: the lanes go over its kn <= 32
// staged triangles instead, lane k testing triangle k, one live ray
// after another (broadcast from its lane); a closest ray takes the
// smallest hit t (ties to the lower slot, as a walk in slot order
// keeps the first), an any-hit ray retires on any hit.  Each ray costs
// one test and a warp reduction instead of kn tests.
template <bool CLOSEST>
__device__ __forceinline__ void leaf_by_triangles(
    const float4* st, int kn, unsigned live, int lane, int first_id,
    const Ray& r, float t_min, float& t, int& best, float& bu, float& bv,
    bool& blocked) {
  while (live) {
    const int src = __ffs(live) - 1;
    live &= live - 1;
    Ray q;
    q.ox = __shfl_sync(kFull, r.ox, src);
    q.oy = __shfl_sync(kFull, r.oy, src);
    q.oz = __shfl_sync(kFull, r.oz, src);
    q.dx = __shfl_sync(kFull, r.dx, src);
    q.dy = __shfl_sync(kFull, r.dy, src);
    q.dz = __shfl_sync(kFull, r.dz, src);
    const float tq = __shfl_sync(kFull, t, src);
    float th, uh, vh;
    const bool h = lane < kn &&
                   hrt::moller_scaled(st[3 * lane], st[3 * lane + 1],
                                      st[3 * lane + 2], q, t_min, tq, th, uh,
                                      vh);
    if (!CLOSEST) {
      if (__any_sync(kFull, h) && lane == src) blocked = true;
      continue;
    }
    // th > t_min > 0, so its bits order like the floats.
    const unsigned key = h ? __float_as_uint(th) : 0xffffffffu;
    const unsigned kmin = __reduce_min_sync(kFull, key);
    if (kmin == 0xffffffffu) continue;
    const int win = __ffs(__ballot_sync(kFull, key == kmin)) - 1;
    const float wu = __shfl_sync(kFull, uh, win);
    const float wv = __shfl_sync(kFull, vh, win);
    if (lane == src) {
      best = first_id + win;
      t = __uint_as_float(kmin);
      bu = wu;
      bv = wv;
    }
  }
}

template <int STACK, bool CLOSEST>
__global__ void __launch_bounds__(kThreads)
bvh8_packet_kernel(const float* __restrict__ ox,
                   const float* __restrict__ oy,
                   const float* __restrict__ oz,
                   const float* __restrict__ dx,
                   const float* __restrict__ dy,
                   const float* __restrict__ dz,
                   const float* __restrict__ tmax, int n,
                   const int4* __restrict__ rec,
                   const float4* __restrict__ tris, int leaf_size,
                   float t_min, float* __restrict__ t_out,
                   int* __restrict__ tri_out, float* __restrict__ u_out,
                   float* __restrict__ v_out,
                   unsigned char* __restrict__ occ_out) {
  // A stack entry: the child's box words 0-5 and (target, lane mask).
  __shared__ int4 s_stack[kWarps][STACK][2];
  __shared__ int4 s_node[kWarps][16];
  __shared__ float4 s_tris[kWarps][32 * 3];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  int4(*stk)[2] = s_stack[warp];
  int4* sn = s_node[warp];
  float4* st = s_tris[warp];
  // Every lane of the warp takes part in its votes; lanes past n are dead.
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int jr = min(i, n - 1);
  Ray r;
  hrt::set_ray(r, ox[jr], oy[jr], oz[jr], dx[jr], dy[jr], dz[jr]);
  float t = tmax[jr];
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  bool blocked = false;
  // Warp-uniform state: the item (from the root), its lanes, the stack
  // depth.
  int kind = kNode, val = 0;
  unsigned mask = __ballot_sync(kFull, i < n && t >= 0.0f);
  int sp = 0;
  while (true) {
    const bool mine = ((mask >> lane) & 1u) && !blocked;
    bool pop = true;
    if (mask && kind == kLeaf) {
      for (int k0 = 0; k0 < leaf_size; k0 += 32) {
        const int kn = min(32, leaf_size - k0);
        hrt::stage_tris(st, tris, val + k0, kn, lane);
        // A hit in an earlier chunk retires an any-hit lane.
        const unsigned live = __ballot_sync(kFull, mine && !blocked);
        if (__popc(live) < kLanesOverTriangles) {
          leaf_by_triangles<CLOSEST>(st, kn, live, lane, val + k0, r, t_min,
                                     t, best, bu, bv, blocked);
        } else if (mine && !blocked) {
#pragma unroll 4
          for (int k = 0; k < kn; ++k) {
            float th, uh, vh;
            if (hrt::moller_scaled(st[3 * k], st[3 * k + 1], st[3 * k + 2], r,
                                   t_min, t, th, uh, vh)) {
              if (!CLOSEST) {
                blocked = true;
                break;
              }
              best = val + k0 + k;
              t = th;
              bu = uh;
              bv = vh;
            }
          }
        }
      }
    } else if (mask) {  // visit wide node val
      __syncwarp();  // the last node's reads are done
      if (lane < 16) sn[lane] = __ldg(rec + 16 * val + lane);
      __syncwarp();
      const int first_child = sn[1].w;  // slot 0, word 7
      unsigned m[8], key[8];
      int cnt = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int4 a = sn[2 * c], b = sn[2 * c + 1];
        float tn = 0.0f;
        const bool hit =
            b.z != 0 && mine &&
            hrt::slab_entry(__int_as_float(a.x), __int_as_float(a.y),
                            __int_as_float(a.z), __int_as_float(a.w),
                            __int_as_float(b.x), __int_as_float(b.y), r,
                            t_min, t, tn);
        m[c] = __ballot_sync(kFull, hit);
        // t_near >= t_min > 0, so its bits order like the floats.  Any
        // hit keeps the slot order.
        key[c] = CLOSEST ? __reduce_min_sync(
                               kFull, hit ? __float_as_uint(tn) : 0xffffffffu)
                         : c;
        cnt += m[c] != 0u;
      }
      if (cnt) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (!m[c]) continue;
          int rank = 0;
#pragma unroll
          for (int o = 0; o < 8; ++o)
            rank += m[o] && (key[o] < key[c] || (key[o] == key[c] && o < c));
          const int4 a = sn[2 * c], b = sn[2 * c + 1];
          const int target = b.z < 0 ? ((first_child - b.z - 1) << 1) | kNode
                                     : ((b.z - 1) << 1) | kLeaf;
          if (rank == 0) {  // the first: walked next
            kind = target & 1;
            val = target >> 1;
            mask = m[c];
          } else if (lane == 0) {  // the last deepest on the stack
            const int slot = sp + cnt - 1 - rank;
            stk[slot][0] = a;
            stk[slot][1] = make_int4(b.x, b.y, target, static_cast<int>(m[c]));
          }
        }
        __syncwarp();
        sp += cnt - 1;
        pop = false;
      }
    }
    if (!pop) continue;
    if (sp == 0) break;
    --sp;
    const int4 a = stk[sp][0], b = stk[sp][1];
    kind = b.z & 1;
    val = b.z >> 1;
    // The box again, against each lane's live t.
    float tn;
    mask = __ballot_sync(
        kFull, ((static_cast<unsigned>(b.w) >> lane) & 1u) && !blocked &&
                   hrt::slab_entry(__int_as_float(a.x), __int_as_float(a.y),
                                   __int_as_float(a.z), __int_as_float(a.w),
                                   __int_as_float(b.x), __int_as_float(b.y),
                                   r, t_min, t, tn));
  }
  if (i >= n) return;
  if (!CLOSEST) {
    occ_out[i] = blocked ? 1 : 0;
    return;
  }
  t_out[i] = t;
  tri_out[i] = best;
  u_out[i] = bu;
  v_out[i] = bv;
}

template <int STACK>
void launch_packet(bool closest, int blocks, cudaStream_t s, const float* ox,
                   const float* oy, const float* oz, const float* dx,
                   const float* dy, const float* dz, const float* tmax, int n,
                   const int4* rec, const float4* tris, int leaf_size,
                   float t_min, float* t_out, int* tri_out, float* u_out,
                   float* v_out, unsigned char* occ_out) {
  if (closest)
    bvh8_packet_kernel<STACK, true><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, leaf_size, t_min, t_out,
        tri_out, u_out, v_out, occ_out);
  else
    bvh8_packet_kernel<STACK, false><<<blocks, kThreads, 0, s>>>(
        ox, oy, oz, dx, dy, dz, tmax, n, rec, tris, leaf_size, t_min, t_out,
        tri_out, u_out, v_out, occ_out);
}

}  // namespace

// Closest mode writes t (t_max on a miss), tri (leaf-pool id, -1 on a
// miss), u and v; any-hit mode writes occ (1 where blocked).  The unused
// outputs may be null.  `records` is the table as (nodes, 64) int32 node
// records (node q's 8 child records of 8 words at 64 q; 16-byte
// aligned), `tris` the (T, 12) float32 v0|e1|e2|pad rows (16-byte
// aligned), `stack_size` the walk's stack bound for the tree's depth
// (traversal_wide8.stack_entries, at most 256).  Returns
// cudaGetLastError() after the launch.
extern "C" int hrt_bvh8_trace(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const float* tmax, int n, const int* records,
                              const float* tris, int leaf_size, float t_min,
                              int stack_size, int closest, float* t_out,
                              int* tri_out, float* u_out, float* v_out,
                              unsigned char* occ_out, void* stream) {
  if (n <= 0) return 0;
  if (stack_size < 1 || stack_size > 256 || leaf_size < 1)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<size_t>(records) % 16 != 0 ||
      reinterpret_cast<size_t>(tris) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* r4 = reinterpret_cast<const int4*>(records);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (stack_size <= 32) {
    launch_packet<32>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax,
                      n, r4, t4, leaf_size, t_min, t_out, tri_out, u_out,
                      v_out, occ_out);
  } else {
    launch_packet<256>(closest != 0, blocks, s, ox, oy, oz, dx, dy, dz, tmax,
                       n, r4, t4, leaf_size, t_min, t_out, tri_out, u_out,
                       v_out, occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hrt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
