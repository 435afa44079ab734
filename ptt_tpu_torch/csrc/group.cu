// Grouped first linear layer of a training set-abstraction stage on Hopper
// (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels ptt_tpu/ops/pallas_group.py:_fwd_kernel and
// _bwd_kernel. Training cannot fuse a whole SA stage as eval does (sa.cu):
// BatchNorm needs the batch statistics of every layer, so layer 0's output
// D (B, ns, M, H) has to exist. What these kernels fuse is the ball query and
// the neighbourhood gather of layer 0, which is linear and commutes with the
// gather: the caller computes Z = [xyz / r | feats] @ W1 over the N source
// points and O = -(center / r) @ W1_xyz per center (ops/group.py, full float32
// matmuls), and D[b, s, m] = Z[b, idx[b, m, s]] + O[b, m].
//
// Forward (group_fwd_kernel). D is written slot-major, the layout BatchNorm and
// the neighbourhood max (over axis 1) take as it is. The TPU kernel gathered Z
// with a one-hot matmul split into bf16 hi/lo passes to suit its matrix unit;
// here rows are gathered by index.
// What bounds it: bytes. D is 4 * B * ns * M * H bytes (201 MB at the first
// backbone stage at B = 48, far more than the 50 MB L2), written once; Z and O
// are a sixteenth of it and are read from L2. So the design is built around
// the stores:
//  * A block takes a tile of 8 centers of one batch row, a warp each. The cloud
//    goes to shared memory once and ball_query.cuh's block_ball_query, the
//    query sa.cu uses, finds the tile's neighbour table.
//  * A thread owns one (center, 16-byte column) of the tile for all slots: O is
//    read once into registers, no index needs a division, Z rows come by 16-byte
//    ld.global.nc loads, 4 slots in flight, and each sum leaves by a 16-byte
//    streaming store (st.global.cs), a warp's 32 stores covering 512 contiguous
//    bytes of D. Streaming keeps D, which nothing reads again before it has left
//    the cache, from evicting Z, which every block of the batch row reads again.
//  * Six blocks share an SM (the register bound of the launch), so one block's
//    ball query runs under the others' stores; no pipeline inside the block is
//    needed for that. The grid is thousands of small blocks, which fills the
//    card at every stage, the two of 64 centers a row included.
// D is one float32 addition per element, Z[b, idx] + O, so it equals the plain
// version bit for bit.
// Tried and dropped, times of the 7 calls of a B = 48 train step on an H100
// (PERF.md): the first design, a warp per center scanning the cloud from device
// memory, 4-byte stores and a division per element, 0.66 ms; tiles of 16 and 32
// centers and 8 loads in flight at three blocks an SM, 0.39 and 0.42 ms for
// 0.39 (with six blocks an SM the tile of 8 gives 0.35); a slot's tile staged
// in shared memory and written by the bulk-copy engine (cp.async.bulk from a
// ring of three tiles, one thread issuing), 0.49-0.55 ms: its ring costs the
// blocks an SM that hide the ball query, and a block barrier a slot.
// Not designed for: ptt_waymo.yaml's 8192-point stage 0, where a block's cloud
// takes 98 KB (2 blocks an SM) and a warp scans far into it before its ball
// fills. There the forward takes 1.38 ms against a 0.28 ms bytes bound on an
// H100, and 0.64 ms on a heavy-duplication cloud whose balls fill at once
// (PERF.md): the scan, then the cloud's load per tile of 8 centers.
//
// The forward also stores the neighbour table idx (B, M, ns) int32 for the
// backward, 16 bytes a store (ns is a multiple of 4). The TPU kernel recomputes
// the ball query in its backward; on this card 4 * B * M * ns bytes (3.1 MB at
// the first stage) are cheaper to keep than a second scan over the cloud.
//
// Backward: dZ[b, j] = sum of dD[b, s, m] over every (m, s) with
// idx[b, m, s] == j. Pad slots hold the first hit (or point 0 for an empty
// ball), so their gradient reaches that point as in the TPU kernel
// (pallas_group.py:118-145). What bounds it: bytes. Every dD row is read once
// (the same 201 MB), dZ is written once. Segments are uneven: resampling repeats
// points, FPS then picks centers on the copies, and thousands of rows can share
// one first hit, so the work is cut into chunks of at most 32 rows whatever the
// duplication.
//
// Deterministic, two runs give equal bits: a float atomicAdd scatter would sum
// in another order on every run; here the order depends on idx and the launch
// geometry only. It is the order ops/group.py:group_backward_ordered writes out:
//   1. a point's rows in ascending e = m * ns + s;
//   2. cut into chunks of 32 consecutive rows;
//   3. a chunk is summed by one warp, lanes across H in 16-byte columns (H is a
//      multiple of 4, at least 64); where a row is narrower than the warp
//      (H = 64: 16 lanes) the warp takes S = 2 rows per load, sub-sum u adds
//      rows u, u + S, ... in order, and the sub-sums are added pairwise (u and
//      u + S/2, halving);
//   4. a point's chunks are cut into 8 contiguous ranges of ceil(chunks / 8),
//      each range is added in order from zero, and the ranges' sums are added
//      in order.
// Two kernels build and use that order, a third handles the rare long segments:
//   group_csr_kernel, one block of 16 warps per batch row. The row's M * ns
//     entries are cut into R contiguous ranges, each with its own counters in
//     shared memory: R = 16 while R counters a point fit (N up to 3227), fewer
//     for larger clouds (8 up to 5809, 4 up to 9682, so ptt_waymo.yaml's 8192
//     points take 4; 2 up to 14523, 1 up to 19364, where the refusal is). The
//     block counts the references of each range to every point (shared-memory
//     integer atomics, order-free), turns the counts into per-(range, point)
//     offsets and scans the per-point totals, and then warp r < R fills range
//     r into the CSR table at its own offsets in ascending e (__match_any_sync
//     ranks the lanes that share a point). Ranges are contiguous and
//     ascending, so each segment comes out sorted by e without a sort,
//     whichever warp ran first, and for any R: R changes how the table is
//     built, not the table or the order of the sums. The table holds dD row numbers s * M + m, so the summing loop has
//     no division. Chunk descriptors are written one thread per chunk (a
//     binary search of the chunk scan), so a point with hundreds of chunks
//     costs no more than hundreds of points.
//   group_sum_kernel, a warp per chunk over a grid that strides the row's real
//     chunk count: 8 rows of 16-byte loads in flight per lane. A point with a
//     single chunk (almost all) gets its dZ row written here, a point with no
//     reference its zeros; only chunks of longer segments go to `partial`.
//   group_combine_kernel walks the list of multi-chunk points, a block per
//     point, a warp per range of its chunks: a segment of 9540 rows (seen at
//     the first backbone stage) is 299 chunks, 38 dependent rounds of loads
//     for a warp instead of 299.
// Why all warps fill and only long segments combine: with one filling warp and
// every chunk sent through `partial`, the CSR build took a third and the
// combine a tenth of the backward's time on an H100 (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "ball_query.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCsrThreads = 512;
constexpr int kCsrWarps = kCsrThreads / 32;  // the most ranges of a batch row's entries: a filling warp each
constexpr int kChunk = 32;                 // rows per chunk of a segment in the backward
constexpr int kInFlight = 8;               // loads a lane issues before it adds them
constexpr int kCombineBlocks = 8;          // blocks per batch row that walk the multi-chunk points
constexpr int kTile = kWarps;              // centers of a forward block: a warp's ball query each
constexpr int kFwdInFlight = 4;            // Z loads a thread starts before it stores their sums
constexpr int kFwdBlocksPerSm = 6;         // forward blocks an SM should hold (bounds the registers)
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(ptt::kFullMask, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Shared memory of a forward block: the tile's neighbour table (first: read as
// int4), the query's hit lists and counts (one list a center), the cloud.
__host__ __device__ inline size_t fwd_smem_bytes(int n, int ns) {
  return (2 * static_cast<size_t>(kTile) * ns + kTile + 3 * static_cast<size_t>(n)) * sizeof(int);
}

// One block per (batch row, tile of kTile centers); hv = H / 4 16-byte columns a row.
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
group_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ ctr,
                 const float* __restrict__ z, const float* __restrict__ off,
                 float* __restrict__ out, int* __restrict__ idx, int n, int m_total, int ns,
                 int hv, float r2) {
  extern __shared__ __align__(16) int fwd_smem[];
  int* nbr = fwd_smem;                                // kTile x ns
  int* hits = nbr + kTile * ns;                       // kTile lists of ns
  int* cnt = hits + kTile * ns;                       // kTile
  float* pts = reinterpret_cast<float*>(cnt + kTile);  // n x 3
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int tm = min(kTile, m_total - m0);  // centers of this tile that exist
  const size_t row0 = static_cast<size_t>(b) * m_total + m0;  // the tile's first center

  const float* cloud = xyz + static_cast<size_t>(b) * n * 3;
  for (int e = threadIdx.x; e < 3 * n; e += kThreads) pts[e] = __ldg(cloud + e);
  __syncthreads();
  ptt::block_ball_query<kWarps>(pts, n, ctr + row0 * 3, kTile, tm, r2, ns, hits, cnt, nbr, kTile * ns);

  int4* idx4 = reinterpret_cast<int4*>(idx + row0 * ns);
  for (int e = threadIdx.x; e < (tm * ns) >> 2; e += kThreads) idx4[e] = reinterpret_cast<const int4*>(nbr)[e];

  const float4* zb = reinterpret_cast<const float4*>(z) + static_cast<size_t>(b) * n * hv;
  const float4* ob = reinterpret_cast<const float4*>(off) + row0 * hv;
  float4* db = reinterpret_cast<float4*>(out) + (static_cast<size_t>(b) * ns * m_total + m0) * hv;
  const size_t slot_stride = static_cast<size_t>(m_total) * hv;
  // e = center * hv + column. Where a tile has fewer (center, column) pairs than
  // the block has threads (H = 64: 128), the threads form groups that deal the
  // slots out among them, kFwdInFlight at a time, so that none is idle.
  const int tile_pairs = kTile * hv;
  const int groups = tile_pairs < kThreads ? kThreads / tile_pairs : 1;
  const int g = groups > 1 ? threadIdx.x / tile_pairs : 0;
  const int step = groups > 1 ? tile_pairs : kThreads;
  for (int e = threadIdx.x - g * tile_pairs; e < tm * hv && g < groups; e += step) {
    const int t = e / hv;
    const int col = e - t * hv;
    const int* row = nbr + t * ns;
    const float4 o = __ldg(ob + e);
    float4* dst = db + e;
    for (int s0 = g * kFwdInFlight; s0 < ns; s0 += groups * kFwdInFlight) {  // ns is a multiple of kFwdInFlight
      float4 v[kFwdInFlight];
#pragma unroll
      for (int u = 0; u < kFwdInFlight; ++u) v[u] = __ldg(zb + static_cast<size_t>(row[s0 + u]) * hv + col);
#pragma unroll
      for (int u = 0; u < kFwdInFlight; ++u) __stcs(dst + (s0 + u) * slot_stride, add4(v[u], o));
    }
  }
}

// Exclusive scan of data[0, n) in place by the whole block; data[n] gets the
// total. warp_tot holds one int per warp. Every thread of the block calls it.
__device__ void block_exclusive_scan(int* data, int n, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int j0 = min(n, static_cast<int>(threadIdx.x) * per);
  const int j1 = min(n, j0 + per);
  int local = 0;
  for (int j = j0; j < j1; ++j) local += data[j];
  const int incl = warp_inclusive_scan(local, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int run = incl - local;
  for (int w = 0; w < warp; ++w) run += warp_tot[w];
  for (int j = j0; j < j1; ++j) {
    const int x = data[j];
    data[j] = run;
    run += x;
  }
  if (threadIdx.x == blockDim.x - 1) data[n] = run;
  __syncthreads();
}

// chunk descriptor: x = first CSR entry, y = point << 8 | rows << 1 | single
__device__ __forceinline__ int2 pack_chunk(int k0, int j, int len, bool single) {
  return make_int2(k0, (j << 8) | (len << 1) | (single ? 1 : 0));
}

__global__ void __launch_bounds__(kCsrThreads)
group_csr_kernel(const int* __restrict__ idx, int* __restrict__ rows, int* __restrict__ chunk_start,
                 int2* __restrict__ chunks, int* __restrict__ multi, int n, int m_total, int ns,
                 int max_chunks, int ranges) {
  extern __shared__ int sm[];
  int* cnt = sm;                      // ranges x n: references of range r to point j, then offsets
  int* start = cnt + ranges * n;      // n + 1: per-point totals, then their exclusive scan
  int* cstart = start + n + 1;        // n + 1: chunks per point, then their exclusive scan
  int* warp_tot = cstart + n + 1;     // kCsrWarps
  int* n_multi = warp_tot + kCsrWarps;  // 1
  const int b = blockIdx.x;
  const int entries = m_total * ns;
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int range = (((entries + ranges - 1) / ranges) + 31) & ~31;
  const int e_begin = min(entries, warp * range);
  const int e_end = warp < ranges ? min(entries, e_begin + range) : e_begin;  // warps past R fill nothing
  int* mine = cnt + min(warp, ranges - 1) * n;

  for (int e = threadIdx.x; e < ranges * n; e += kCsrThreads) cnt[e] = 0;
  if (threadIdx.x == 0) *n_multi = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += kCsrThreads) atomicAdd(cnt + (e / range) * n + ib[e], 1);
  __syncthreads();
  // per point: offsets of the ranges within its segment, the total, the chunks
  for (int j = threadIdx.x; j < n; j += kCsrThreads) {
    int run = 0;
    for (int r = 0; r < ranges; ++r) {
      const int x = cnt[r * n + j];
      cnt[r * n + j] = run;
      run += x;
    }
    start[j] = run;
    cstart[j] = run > kChunk ? (run + kChunk - 1) / kChunk : 1;  // a point without rows: one empty chunk
  }
  __syncthreads();
  block_exclusive_scan(start, n, warp_tot);
  block_exclusive_scan(cstart, n, warp_tot);

  // ordered fill of this warp's range: entries in ascending e, lanes sharing a
  // point ranked by lane
  int* rb = rows + static_cast<size_t>(b) * entries;
  for (int e0 = e_begin; e0 < e_end; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < e_end;
    const int j = live ? ib[e] : -1 - lane;  // dead lanes get keys of their own
    const unsigned peers = __match_any_sync(ptt::kFullMask, j);
    if (live) {
      const int m = e / ns;
      rb[start[j] + mine[j] + __popc(peers & ((1u << lane) - 1u))] = (e - m * ns) * m_total + m;
    }
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) mine[j] += __popc(peers);
    __syncwarp();
  }

  // chunk descriptors, one thread per chunk; the points with several chunks
  int* cb = chunk_start + static_cast<size_t>(b) * (n + 1);
  int2* kb = chunks + static_cast<size_t>(b) * max_chunks;
  int* mb = multi + static_cast<size_t>(b) * (n + 1);
  const int total = cstart[n];
  for (int c = threadIdx.x; c < total; c += kCsrThreads) {
    int lo = 0, hi = n - 1;  // the point j with cstart[j] <= c < cstart[j + 1]
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (cstart[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const int k0 = start[lo] + (c - cstart[lo]) * kChunk;
    kb[c] = pack_chunk(k0, lo, min(kChunk, start[lo + 1] - k0), cstart[lo + 1] - cstart[lo] == 1);
  }
  for (int j = threadIdx.x; j <= n; j += kCsrThreads) cb[j] = cstart[j];
  for (int j = threadIdx.x; j < n; j += kCsrThreads) {
    if (cstart[j + 1] - cstart[j] > 1) mb[1 + atomicAdd(n_multi, 1)] = j;  // any order: points are independent
  }
  __syncthreads();
  if (threadIdx.x == 0) mb[0] = *n_multi;
}

__device__ __forceinline__ void add_to(float4& a, const float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
__device__ __forceinline__ float4 shfl_down_v(const float4 v, int d) {
  return make_float4(__shfl_down_sync(ptt::kFullMask, v.x, d), __shfl_down_sync(ptt::kFullMask, v.y, d),
                     __shfl_down_sync(ptt::kFullMask, v.z, d), __shfl_down_sync(ptt::kFullMask, v.w, d));
}
__device__ __forceinline__ void zero(float4& a) { a = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// A warp per chunk: the chunk's dD rows summed in CSR order, lanes across a
// row's hv = H / 4 16-byte columns, `sub` = 2 rows per load when hv = 16.
using V = float4;

__global__ void __launch_bounds__(kThreads)
group_sum_kernel(const float* __restrict__ dd, const int* __restrict__ rows,
                 const int* __restrict__ chunk_start, const int2* __restrict__ chunks,
                 float* __restrict__ partial, float* __restrict__ dz, int n, int entries, int hv,
                 int sub, int max_chunks) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n_chunks = chunk_start[static_cast<size_t>(b) * (n + 1) + n];
  const V* ddb = reinterpret_cast<const V*>(dd) + static_cast<size_t>(b) * entries * hv;
  const int* rb = rows + static_cast<size_t>(b) * entries;
  const int u = sub > 1 ? lane / hv : 0;        // which of the `sub` rows of a load
  const int lane_col = sub > 1 ? lane - u * hv : lane;
  for (int c = blockIdx.x * kWarps + (threadIdx.x >> 5); c < n_chunks; c += gridDim.x * kWarps) {
    const int2 d = chunks[static_cast<size_t>(b) * max_chunks + c];
    const int len = (d.y >> 1) & 127;
    const int e_lane = lane < len ? rb[d.x + lane] : 0;
    V* dst = (d.y & 1) ? reinterpret_cast<V*>(dz) + (static_cast<size_t>(b) * n + (d.y >> 8)) * hv
                       : reinterpret_cast<V*>(partial) + (static_cast<size_t>(b) * max_chunks + c) * hv;
    const int steps = (len + sub - 1) / sub;
    for (int p0 = 0; p0 < hv; p0 += 32) {
      const int col = p0 + lane_col;
      const bool active = u < sub && col < hv;
      V acc;
      zero(acc);
      for (int q0 = 0; q0 < steps; q0 += kInFlight) {
        V v[kInFlight];
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          const int t = (q0 + i) * sub + u;
          const int e = __shfl_sync(ptt::kFullMask, e_lane, t & 31);
          zero(v[i]);
          if (active && t < len) v[i] = __ldg(ddb + static_cast<size_t>(e) * hv + col);
        }
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) add_to(acc, v[i]);
      }
      for (int o = sub >> 1; o > 0; o >>= 1) add_to(acc, shfl_down_v(acc, o * hv));
      if (u == 0 && col < hv) dst[col] = acc;
    }
  }
}

// A block per point with several chunks: its chunks are cut into kWarps
// contiguous ranges of ceil(chunks / kWarps), a warp adds its range's partial
// sums in order, and the ranges' sums are added in order (a range without
// chunks adds zeros). The longest chain of dependent loads is an eighth of the
// segment's chunks.
__global__ void __launch_bounds__(kThreads)
group_combine_kernel(const float* __restrict__ partial, const int* __restrict__ chunk_start,
                     const int* __restrict__ multi, float* __restrict__ dz, int n, int hv,
                     int max_chunks) {
  extern __shared__ V range_sum[];  // kWarps x hv
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* mb = multi + static_cast<size_t>(b) * (n + 1);
  const int* cb = chunk_start + static_cast<size_t>(b) * (n + 1);
  const V* pb = reinterpret_cast<const V*>(partial) + static_cast<size_t>(b) * max_chunks * hv;
  const int n_multi = mb[0];
  for (int i = blockIdx.x; i < n_multi; i += gridDim.x) {
    const int j = mb[1 + i];
    const int c0 = cb[j], c1 = cb[j + 1];
    const int per = (c1 - c0 + kWarps - 1) / kWarps;
    const int r0 = min(c1, c0 + warp * per), r1 = min(c1, r0 + per);
    for (int col = lane; col < hv; col += 32) {
      V acc;
      zero(acc);
      for (int q0 = r0; q0 < r1; q0 += kInFlight) {
        V v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          zero(v[u]);
          if (q0 + u < r1) v[u] = pb[static_cast<size_t>(q0 + u) * hv + col];
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) add_to(acc, v[u]);
      }
      range_sum[warp * hv + col] = acc;
    }
    __syncthreads();
    V* dst = reinterpret_cast<V*>(dz) + (static_cast<size_t>(b) * n + j) * hv;
    for (int col = threadIdx.x; col < hv; col += kThreads) {
      V acc = range_sum[col];
      for (int w = 1; w < kWarps; ++w) add_to(acc, range_sum[w * hv + col]);
      dst[col] = acc;
    }
    __syncthreads();
  }
}

// The backward's scratch layout, known here only: the CSR build's shared memory
// for R ranges, the ranges it takes for a cloud of n points (the most, up to
// kCsrWarps, whose counters fit a block; 0 when not even one range fits), the
// tables' sizes and the number of chunks a batch row can have (every point
// ends a chunk, and a point without rows has an empty one).
size_t csr_smem_bytes(int n, int ranges) {
  return (static_cast<size_t>(ranges) * n + 2 * (static_cast<size_t>(n) + 1) + kCsrWarps + 1) * sizeof(int);
}

int csr_ranges(int n) {
  int ranges = kCsrWarps;
  while (ranges > 0 && csr_smem_bytes(n, ranges) > kMaxSmem) ranges >>= 1;
  return ranges;
}

int backward_max_chunks(int n, int m_total, int ns) { return (m_total * ns + kChunk - 1) / kChunk + n; }

// int32 words of the tables: chunks (2 per chunk), rows, chunk_start, multi
long long scratch_ints_total(int batch, int n, int m_total, int ns) {
  return static_cast<long long>(batch) *
         (2LL * backward_max_chunks(n, m_total, ns) + static_cast<long long>(m_total) * ns + 2LL * (n + 1));
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// rows a warp takes per load of hv 16-byte columns: the largest power of two
// with sub * hv <= 32
int rows_per_load(int hv) {
  int sub = 1;
  while (sub * 2 * hv <= 32) sub *= 2;
  return sub;
}

cudaError_t launch_sums(const float* dd, const int* rows, const int* chunk_start, const int2* chunks,
                        const int* multi, float* partial, float* dz, int batch, int n, int entries,
                        int h, int max_chunks, cudaStream_t st) {
  const int hv = h / 4;
  const int sub = rows_per_load(hv);
  // about 4 chunks a warp at the largest chunk count
  const int sum_blocks = max(1, min(64, (max_chunks + 4 * kWarps - 1) / (4 * kWarps)));
  group_sum_kernel<<<dim3(sum_blocks, batch), kThreads, 0, st>>>(
      dd, rows, chunk_start, chunks, partial, dz, n, entries, hv, sub, max_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(kWarps) * h * sizeof(float);
  if ((err = set_smem(reinterpret_cast<const void*>(group_combine_kernel), smem)) != cudaSuccess) return err;
  group_combine_kernel<<<dim3(kCombineBlocks, batch), kThreads, smem, st>>>(partial, chunk_start, multi,
                                                                              dz, n, hv, max_chunks);
  return cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3), ctr (B, M, 3), z (B, N, H), off (B, M, H) float32 in; out
// (B, ns, M, H) float32 and idx (B, M, ns) int32 out; all contiguous on the
// device, z, off, out and idx 16-byte aligned. H and ns are multiples of 4 and
// the cloud fits a block's shared memory beside the tile's tables; any other
// call is refused with cudaErrorInvalidValue. Launches on `stream`; returns the
// cudaError_t of the launch (0 = ok).
extern "C" int group_forward(const float* xyz, const float* ctr, const float* z, const float* off,
                             float* out, int* idx, int batch, int n, int m_total, int ns, int h,
                             float r2, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (batch < 1 || n < 1 || m_total < 1 || ns < kFwdInFlight || ns % kFwdInFlight != 0 || h < 4 || h % 4 != 0 ||
      fwd_smem_bytes(n, ns) > kMaxSmem || !aligned(z) || !aligned(off) || !aligned(out) || !aligned(idx)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = fwd_smem_bytes(n, ns);
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(group_fwd_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m_total + kTile - 1) / kTile, batch);
  group_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, ctr, z, off, out, idx, n, m_total, ns, h / 4, r2);
  return cudaGetLastError();
}

// Sizes of group_backward's scratch for `batch` rows of N source points and
// M * ns entries: *scratch_ints int32 of tables and *max_chunks rows of H floats
// of partial sums per batch row. Returns 0, or -1 if the CSR build's shared
// memory for one range exceeds what the current device gives one block (N
// above 19364 on an H100) or a chunk descriptor cannot hold N (-2 if the
// device cannot be queried).
extern "C" int group_backward_scratch(int batch, int n, int m_total, int ns, long long* scratch_ints,
                                      int* max_chunks) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -2;
  const int ranges = csr_ranges(n);
  if (ranges == 0 || csr_smem_bytes(n, ranges) > static_cast<size_t>(limit) || n >= (1 << 23)) return -1;
  *max_chunks = backward_max_chunks(n, m_total, ns);
  *scratch_ints = scratch_ints_total(batch, n, m_total, ns);
  return 0;
}

// The constants of the backward's summation order (the header note's steps
// 2-4) for rows of h floats: rows per chunk, ranges a point's chunks are cut
// into, rows a warp takes per load. Returns 0.
extern "C" int group_backward_order(int h, int* chunk, int* ranges, int* sub) {
  *chunk = kChunk;
  *ranges = kWarps;
  *sub = rows_per_load(h / 4);
  return 0;
}

// The ranges of a batch row's entries the CSR build takes for a cloud of n
// points (0 when it refuses n). Returns 0.
extern "C" int group_csr_ranges(int n, int* ranges) {
  *ranges = csr_ranges(n);
  return 0;
}

// dd (B, ns, M, H) float32 and idx (B, M, ns) int32 in; dz (B, N, H) float32
// out; H is a multiple of 4 and at least 64 (a row is 16 or more 16-byte
// columns), dd, partial and dz are 16-byte aligned; any other call is refused
// with cudaErrorInvalidValue. Scratch, sized by group_backward_scratch: `scratch` int32 (8-byte
// aligned), cut here into rows (B, M * ns), chunk_start (B, N + 1), multi
// (B, N + 1) and chunks (B, max_chunks) int2; partial (B, max_chunks, H) float32.
// All contiguous on the device. Launches three kernels on `stream`; returns the
// cudaError_t of the launches (0 = ok).
extern "C" int group_backward(const float* dd, const int* idx, int* scratch, float* partial, float* dz,
                              int batch, int n, int m_total, int ns, int h, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (batch < 1 || n < 1 || m_total < 1 || ns < 1 || h < 64 || h % 4 != 0 || !aligned(dd) ||
      !aligned(partial) || !aligned(dz)) {
    return cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int max_chunks = backward_max_chunks(n, m_total, ns);
  const size_t b = static_cast<size_t>(batch);
  auto* kb = reinterpret_cast<int2*>(scratch);  // first: int2 needs the 8-byte boundary
  int* rows = scratch + 2 * b * max_chunks;
  int* chunk_start = rows + b * m_total * ns;
  int* multi = chunk_start + b * (n + 1);
  const int ranges = csr_ranges(n);
  if (ranges == 0) return cudaErrorInvalidValue;
  const size_t smem = csr_smem_bytes(n, ranges);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(group_csr_kernel), smem);
  if (err != cudaSuccess) return err;
  group_csr_kernel<<<batch, kCsrThreads, smem, st>>>(idx, rows, chunk_start, kb, multi, n, m_total, ns,
                                                     max_chunks, ranges);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_sums(dd, rows, chunk_start, kb, multi, partial, dz, batch, n, m_total * ns, h, max_chunks, st);
}
