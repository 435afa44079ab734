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
// Forward (group_fwd_kernel). One block per (batch row, tile of 8 centers), a
// warp per center runs ball_query.cuh's exact ball query. D is written
// slot-major, the layout BatchNorm and the neighbourhood max (over axis 1) take
// as it is; for one slot a block's centers are 8 * H contiguous floats, stored
// coalesced along H. The TPU kernel gathered Z with a one-hot matmul split into
// bf16 hi/lo passes to suit its matrix unit; here rows are gathered by index.
// What bounds it: bytes. D is 4 * B * ns * M * H bytes (201 MB at the first
// backbone stage at B = 48), written once; Z and O are read from L2.
//
// The forward also stores the neighbour table idx (B, M, ns) int32 for the
// backward. The TPU kernel recomputes the ball query in its backward; on this
// card 4 * B * M * ns bytes (3.1 MB at the first stage) are cheaper to keep
// than a second scan over the cloud.
//
// Backward: dZ[b, j] = sum of dD[b, s, m] over every (m, s) with
// idx[b, m, s] == j. Pad slots hold the first hit (or point 0 for an empty
// ball), so their gradient reaches that point as in the TPU kernel
// (pallas_group.py:118-145). A float atomicAdd scatter would sum in another
// order on every run; this one is deterministic, two runs give equal bits:
//   group_csr_kernel, one block per batch row: count the references of every
//     source point (shared-memory integer atomics, order-free), exclusive scan,
//     then one warp fills the CSR table of row ids e = m * ns + s in ascending
//     e (__match_any_sync ranks the lanes that share a point, so each segment
//     comes out sorted without a sort) and cuts each segment into chunks of at
//     most 32 rows;
//   group_partial_kernel, one warp per chunk: sums its dD rows in CSR order,
//     lanes across H (coalesced loads);
//   group_combine_kernel, one warp per (batch row, source point): adds its
//     chunks' sums in order.
// Segments are uneven: resampling repeats points, FPS then picks centers on
// the copies, and thousands of rows can share one first hit. Summed by one
// warp per point, such a segment took 3.2 ms at the first backbone stage on an
// H100 (PERF.md); in chunks every warp sums at most 32 rows.
// What bounds it: bytes. Every dD row is read once (the same 201 MB), dZ is
// written once; the CSR build reads idx from shared memory and is latency
// bound in its single filling warp.

#include <cuda_runtime.h>

#include "ball_query.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCsrThreads = 512;
constexpr int kCols = 8;     // columns per lane and pass in the backward sums
constexpr int kChunk = 32;   // rows per chunk of a segment in the backward

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(ptt::kFullMask, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
group_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ ctr,
                 const float* __restrict__ z, const float* __restrict__ off,
                 float* __restrict__ out, int* __restrict__ idx, int n, int m_total, int ns,
                 int h, float r2) {
  extern __shared__ int nbr[];  // kWarps x ns
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kWarps;
  const int tm = min(kWarps, m_total - m0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp < tm) {
    const int m = m0 + warp;
    int* row = nbr + warp * ns;
    ptt::warp_ball_query(xyz + static_cast<size_t>(b) * n * 3, n,
                         ctr + (static_cast<size_t>(b) * m_total + m) * 3, r2, ns, row, lane);
    for (int s = lane; s < ns; s += 32) idx[(static_cast<size_t>(b) * m_total + m) * ns + s] = row[s];
  }
  __syncthreads();

  const float* zb = z + static_cast<size_t>(b) * n * h;
  const float* ob = off + (static_cast<size_t>(b) * m_total + m0) * h;
  for (int s = 0; s < ns; ++s) {
    float* dst = out + ((static_cast<size_t>(b) * ns + s) * m_total + m0) * h;
    for (int e = threadIdx.x; e < tm * h; e += kThreads) {
      const int t = e / h;
      const int col = e - t * h;
      dst[e] = zb[static_cast<size_t>(nbr[t * ns + s]) * h + col] + ob[e];
    }
  }
}

__global__ void __launch_bounds__(kCsrThreads)
group_csr_kernel(const int* __restrict__ idx, int* __restrict__ rows, int* __restrict__ chunk_start,
                 int2* __restrict__ chunks, int n, int entries, int max_chunks) {
  extern __shared__ int sm[];
  int* start = sm;              // n + 1: counts, then their exclusive scan
  int* cursor = start + n + 1;  // n: rows placed so far per point
  int* sidx = cursor + n;       // entries: this batch row's idx
  const int b = blockIdx.x;
  const int* ib = idx + static_cast<size_t>(b) * entries;
  const int lane = threadIdx.x & 31;

  for (int j = threadIdx.x; j <= n; j += blockDim.x) start[j] = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) cursor[j] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < entries; e += blockDim.x) {
    const int j = ib[e];
    sidx[e] = j;
    atomicAdd(start + j, 1);
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  // exclusive scan of the counts, 32 points per round
  int carry = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const int x = j < n ? start[j] : 0;
    const int v = warp_inclusive_scan(x, lane);
    if (j < n) start[j] = carry + v - x;
    carry += __shfl_sync(ptt::kFullMask, v, 31);
  }
  if (lane == 0) start[n] = carry;
  __syncwarp();

  // ordered fill: entries in ascending e, lanes sharing a point ranked by lane
  int* rb = rows + static_cast<size_t>(b) * entries;
  for (int e0 = 0; e0 < entries; e0 += 32) {
    const int e = e0 + lane;
    const bool live = e < entries;
    const int j = live ? sidx[e] : -1 - lane;  // dead lanes get keys of their own
    const unsigned peers = __match_any_sync(ptt::kFullMask, j);
    if (live) rb[start[j] + cursor[j] + __popc(peers & ((1u << lane) - 1u))] = e;
    __syncwarp();
    if (live && lane == __ffs(peers) - 1) cursor[j] += __popc(peers);
    __syncwarp();
  }

  // cut every segment into chunks of at most kChunk rows, numbered point by point
  int* cb = chunk_start + static_cast<size_t>(b) * (n + 1);
  int2* kb = chunks + static_cast<size_t>(b) * max_chunks;
  carry = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const int k0 = j < n ? start[j] : 0;
    const int k1 = j < n ? start[j + 1] : 0;
    const int x = (k1 - k0 + kChunk - 1) / kChunk;
    const int v = warp_inclusive_scan(x, lane);
    const int c0 = carry + v - x;
    if (j < n) {
      cb[j] = c0;
      for (int c = 0; c < x; ++c) kb[c0 + c] = make_int2(k0 + c * kChunk, min(k1, k0 + (c + 1) * kChunk));
    }
    carry += __shfl_sync(ptt::kFullMask, v, 31);
  }
  if (lane == 0) cb[n] = carry;
}

// one warp per chunk: the chunk's dD rows summed in CSR order, lanes across H
__global__ void __launch_bounds__(kThreads)
group_partial_kernel(const float* __restrict__ dd, const int* __restrict__ rows,
                     const int* __restrict__ chunk_start, const int2* __restrict__ chunks,
                     float* __restrict__ partial, int batch, int n, int m_total, int ns, int h,
                     int max_chunks) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(batch) * max_chunks) return;
  const int b = static_cast<int>(w / max_chunks);
  const int c = static_cast<int>(w - static_cast<long long>(b) * max_chunks);
  if (c >= chunk_start[static_cast<size_t>(b) * (n + 1) + n]) return;
  const int lane = threadIdx.x & 31;
  const int2 k = chunks[static_cast<size_t>(b) * max_chunks + c];
  const int len = k.y - k.x;  // 1 .. kChunk
  const int e_lane = lane < len ? rows[static_cast<size_t>(b) * m_total * ns + k.x + lane] : 0;
  const float* ddb = dd + static_cast<size_t>(b) * ns * m_total * h;
  float* dst = partial + (static_cast<size_t>(b) * max_chunks + c) * h;
  for (int c0 = 0; c0 < h; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const int e = __shfl_sync(ptt::kFullMask, e_lane, t);
      const int m = e / ns;
      const float* src = ddb + (static_cast<size_t>(e - m * ns) * m_total + m) * h;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int col = c0 + lane + 32 * i;
        if (col < h) acc[i] += src[col];
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const int col = c0 + lane + 32 * i;
      if (col < h) dst[col] = acc[i];
    }
  }
}

// one warp per (batch row, source point): its chunks' partial sums in order
__global__ void __launch_bounds__(kThreads)
group_combine_kernel(const float* __restrict__ partial, const int* __restrict__ chunk_start,
                     float* __restrict__ dz, int batch, int n, int h, int max_chunks) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= static_cast<long long>(batch) * n) return;
  const int lane = threadIdx.x & 31;
  const int b = static_cast<int>(w / n);
  const int j = static_cast<int>(w - static_cast<long long>(b) * n);
  const int* cb = chunk_start + static_cast<size_t>(b) * (n + 1);
  const int c1 = cb[j + 1];
  const float* pb = partial + static_cast<size_t>(b) * max_chunks * h;
  float* dst = dz + (static_cast<size_t>(b) * n + j) * h;
  for (int col = lane; col < h; col += 32) {
    float acc = 0.0f;
    for (int c = cb[j]; c < c1; ++c) acc += pb[static_cast<size_t>(c) * h + col];
    dst[col] = acc;
  }
}

// The backward's scratch layout, known here only: the CSR build's shared memory
// and the number of chunks a batch row can have (every point may end a chunk).
size_t csr_smem_bytes(int n, int m_total, int ns) {
  return (2 * static_cast<size_t>(n) + 1 + static_cast<size_t>(m_total) * ns) * sizeof(int);
}

int backward_max_chunks(int n, int m_total, int ns) { return (m_total * ns + kChunk - 1) / kChunk + n; }

cudaError_t set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// xyz (B, N, 3), ctr (B, M, 3), z (B, N, H), off (B, M, H) float32 in; out
// (B, ns, M, H) float32 and idx (B, M, ns) int32 out; all contiguous on the
// device. Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int group_forward(const float* xyz, const float* ctr, const float* z, const float* off,
                             float* out, int* idx, int batch, int n, int m_total, int ns, int h,
                             float r2, void* stream) {
  if (batch < 1 || n < 1 || m_total < 1 || ns < 1 || h < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kWarps) * ns * sizeof(int);
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(group_fwd_kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m_total + kWarps - 1) / kWarps, batch);
  group_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, ctr, z, off, out, idx, n, m_total, ns, h, r2);
  return cudaGetLastError();
}

// max_chunks of group_backward's scratch for N source points and M * ns rows
// per batch row, or -1 if the CSR build's shared memory exceeds what the current
// device gives one block (-2 if the device cannot be queried).
extern "C" int group_backward_chunks(int n, int m_total, int ns) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -2;
  if (csr_smem_bytes(n, m_total, ns) > static_cast<size_t>(limit)) return -1;
  return backward_max_chunks(n, m_total, ns);
}

// dd (B, ns, M, H) float32 and idx (B, M, ns) int32 in; dz (B, N, H) float32
// out. Scratch: rows (B, M * ns) int32, chunk_start (B, N + 1) int32, chunks
// (B, max_chunks) int2 and partial (B, max_chunks, H) float32, with max_chunks
// from group_backward_chunks. All contiguous on the device. Launches three
// kernels on `stream`; returns the cudaError_t of the launches (0 = ok).
extern "C" int group_backward(const float* dd, const int* idx, int* rows, int* chunk_start, void* chunks,
                              float* partial, float* dz, int batch, int n, int m_total, int ns, int h,
                              void* stream) {
  if (batch < 1 || n < 1 || m_total < 1 || ns < 1 || h < 1) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int entries = m_total * ns;
  const int max_chunks = backward_max_chunks(n, m_total, ns);
  const size_t smem = csr_smem_bytes(n, m_total, ns);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(group_csr_kernel), smem);
  if (err != cudaSuccess) return err;
  auto* kb = static_cast<int2*>(chunks);
  group_csr_kernel<<<batch, kCsrThreads, smem, st>>>(idx, rows, chunk_start, kb, n, entries, max_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long chunk_warps = static_cast<long long>(batch) * max_chunks;
  group_partial_kernel<<<static_cast<unsigned>((chunk_warps + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      dd, rows, chunk_start, kb, partial, batch, n, m_total, ns, h, max_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long point_warps = static_cast<long long>(batch) * n;
  group_combine_kernel<<<static_cast<unsigned>((point_warps + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      partial, chunk_start, dz, batch, n, h, max_chunks);
  return cudaGetLastError();
}
