// Ball query by warps, shared by sa.cu and group.cu.
//
// Membership must be exact: the squared distance is
// max((c2 + p2) - 2*cross, 0) with c2, p2 and cross summed in the order
// ((x*x + y*y) + z*z), each product and sum rounded on its own (no FMA), the
// arithmetic of ops/point_ops.py:square_distance, compared with
// r2 = float32(radius^2). A warp scans a range of the cloud in chunks of 32
// points; __ballot_sync/__popc give each in-ball point its slot in index order,
// and the scan stops once ns points are found. warp_ball_query scans the whole
// cloud with one warp (group.cu); sa.cu gives several warps a range each and
// merges their lists in range order, which is index order again. Short rows
// repeat the first hit; an empty ball uses point 0.

#pragma once

#include <cuda_runtime.h>

namespace ptt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// The first ns points of pts[j_begin, j_end) ((n, 3) row-major, device or shared
// memory) inside the ball of center (cx, cy, cz), c2 = sq_norm(center), go to
// row[0, ...) in index order. Every lane of the warp calls it with the same
// arguments; row must be visible to the whole warp (shared memory). Returns the
// number of slots filled (<= ns) and ends with __syncwarp.
__device__ __forceinline__ int warp_scan_ball(const float* __restrict__ pts, int j_begin, int j_end,
                                              float cx, float cy, float cz, float c2, float r2,
                                              int ns, int* row, int lane) {
  int count = 0;
  for (int j0 = j_begin; j0 < j_end && count < ns; j0 += 32) {
    const int j = j0 + lane;
    bool in = false;
    if (j < j_end) {
      const float* p = pts + static_cast<size_t>(j) * 3;
      const float px = p[0], py = p[1], pz = p[2];
      const float cross =
          __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)), __fmul_rn(cz, pz));
      const float d2 =
          fmaxf(__fsub_rn(__fadd_rn(c2, sq_norm(px, py, pz)), __fmul_rn(2.0f, cross)), 0.0f);
      in = d2 < r2;
    }
    const unsigned hits = __ballot_sync(kFullMask, in);
    if (in) {
      const int slot = count + __popc(hits & ((1u << lane) - 1u));
      if (slot < ns) row[slot] = j;
    }
    count += __popc(hits);
  }
  __syncwarp();
  return count < ns ? count : ns;
}

// Fills row[0, ns) with the neighbours of center c among the n points of pts.
// Every lane of the warp calls it with the same arguments. Ends with __syncwarp.
__device__ __forceinline__ void warp_ball_query(const float* __restrict__ pts, int n,
                                                const float* __restrict__ c, float r2, int ns,
                                                int* row, int lane) {
  const float cx = c[0], cy = c[1], cz = c[2];
  const int used = warp_scan_ball(pts, 0, n, cx, cy, cz, sq_norm(cx, cy, cz), r2, ns, row, lane);
  const int pad = used > 0 ? row[0] : 0;
  for (int s = used + lane; s < ns; s += 32) row[s] = pad;
  __syncwarp();
}

}  // namespace ptt
