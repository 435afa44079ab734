// The port's one ball query, shared by sa.cu and group.cu.
//
// Membership must be exact: the squared distance is
// max((c2 + p2) - 2*cross, 0) with c2, p2 and cross summed in the order
// ((x*x + y*y) + z*z), each product and sum rounded on its own (no FMA), the
// arithmetic of ops/point_ops.py:square_distance, compared with
// r2 = float32(radius^2). A warp scans a range of the cloud in chunks of 32
// points; __ballot_sync/__popc give each in-ball point its slot in index order,
// and the scan stops once ns points are found. (Testing 2, 4 or 8 chunks before
// looking at the count changed nothing on an H100: the scan is bound by the
// instructions it executes, not by the chain from one chunk to the next.)
// block_ball_query runs a tile of centers with every warp of the block over a
// cloud held in shared memory: the warps are dealt out evenly over the centers,
// several warps of one center scan a contiguous range of the cloud each, and
// their lists are merged in range order, which is index order again, so the
// result is the single scan's. Short rows repeat the first hit; an empty ball
// uses point 0.

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

// The neighbour table of a tile of tm centers by the whole block of kWarps warps.
// pts is the cloud (n, 3) in shared memory, already visible to the block; ctr
// points at the tile's first center in device memory, of which the first
// tm_valid exist. With tm >= kWarps a warp scans the whole cloud for one center
// at a time; with fewer centers kWarps / tm warps share a center, each over a
// range of the cloud. Scratch in shared memory: `hits`, lists * ns ints, and
// `cnt`, lists ints, for lists = tm * max(1, kWarps / tm) (block_query_lists).
// nbr[t * ns + s] receives slot s of center t for every r = t * ns + s below
// nbr_rows; rows of centers that do not exist get 0. Every thread of the block
// calls it with the same arguments; it ends with __syncthreads.
__host__ __device__ inline int block_query_lists(int tm, int warps) {
  return tm * (tm >= warps ? 1 : warps / tm);
}

template <int kWarps>
__device__ __forceinline__ void block_ball_query(const float* __restrict__ pts, int n,
                                                 const float* __restrict__ ctr, int tm, int tm_valid,
                                                 float r2, int ns, int* hits, int* cnt, int* nbr,
                                                 int nbr_rows) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wpc = tm >= kWarps ? 1 : kWarps / tm;
  const int groups = kWarps / wpc;
  const int range = (((n + wpc - 1) / wpc) + 31) & ~31;
  for (int t0 = 0; t0 < tm; t0 += groups) {
    const int t = t0 + warp / wpc;
    const int part = warp % wpc;
    if (warp / wpc < groups && t < tm) {
      int count = 0;
      if (t < tm_valid) {
        const float* c = ctr + static_cast<size_t>(t) * 3;
        const float cx = c[0], cy = c[1], cz = c[2];
        count = warp_scan_ball(pts, min(n, part * range), min(n, (part + 1) * range), cx, cy, cz,
                               sq_norm(cx, cy, cz), r2, ns, hits + (t * wpc + part) * ns, lane);
      }
      if (lane == 0) cnt[t * wpc + part] = count;
    }
  }
  __syncthreads();
  // merge: slot s of center t is the s-th hit of its lists taken in range order
  for (int r = threadIdx.x; r < nbr_rows; r += kWarps * 32) {
    const int t = r / ns;
    int v = 0;
    if (t < tm_valid) {
      int first = -1, rem = r - t * ns;
      bool found = false;
      for (int w = 0; w < wpc; ++w) {
        const int c = cnt[t * wpc + w];
        const int* list = hits + (t * wpc + w) * ns;
        if (first < 0 && c > 0) first = list[0];
        if (!found) {
          if (rem < c) {
            v = list[rem];
            found = true;
          } else {
            rem -= c;
          }
        }
      }
      if (!found) v = first >= 0 ? first : 0;
    }
    nbr[r] = v;
  }
  __syncthreads();
}

}  // namespace ptt
