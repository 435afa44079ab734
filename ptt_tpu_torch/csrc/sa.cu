// Fused eval-mode set-abstraction stage on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptt_tpu/ops/pallas_sa.py:_sa_kernel. One
// launch does ball query, the neighbourhood gather of the first layer's
// activations, the BatchNorm-folded tail MLP and the max over the neighbourhood;
// the grouped (B, M, ns, C) tensor never reaches device memory.
//
// The first layer is linear and commutes with the gather, so the caller
// computes Z = [xyz | feats] @ W1' over the N source points and the per-center
// offset O = b1 - center @ W1'_xyz outside (ops/sa.py); here layer 0 is
// relu(Z[neighbour] + O[center]). The TPU kernel gathered with a one-hot matmul
// split into bf16 hi/lo passes to suit its matrix unit; here the gather is by
// index.
//
// What bounds it: operations. Per row (center, slot) the tail layers cost
// sum(K*C) multiply-adds (16 K at the first backbone stage, 131 K at vote
// aggregation), run in float32 on CUDA cores; the inputs are a few MB and stay
// in L2. The design keeps every activation in shared memory: a block owns
// kRows = 64 rows (64 / ns centers), ping-pongs two kRows x width buffers
// between layers, and the last layer feeds a per-center running max, so its
// output is never stored. Weights are read through L1/L2 (__ldg): a 256 x 256
// float32 layer is 256 KB, more than a block's 227 KB of shared memory. Each
// thread keeps an 8-row x 4-column tile of outputs in registers; a later
// redesign would move the tail to wgmma on tensor cores.
//
// Membership must be exact: the squared distance is
// max((c2 + p2) - 2*cross, 0) with c2, p2 and cross summed in the order
// ((x*x + y*y) + z*z), each product and sum rounded on its own (no FMA), the
// arithmetic of ops/point_ops.py:square_distance, compared with
// r2 = float32(radius^2). A warp scans the cloud in chunks of 32 points per
// center; __ballot_sync/__popc give each in-ball point its slot in index order,
// and the scan stops once ns points are found. Short rows repeat the first hit;
// an empty ball uses point 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows (center, slot) per block
constexpr int kRowsPerThread = 8;
constexpr int kColsPerThread = 4;
constexpr int kMaxTail = 4;
constexpr unsigned kFullMask = 0xffffffffu;

static_assert(kRows == (kThreads / 32) * kRowsPerThread, "one warp per 8-row slab");

struct Tail {
  const float* w[kMaxTail];  // (c[l], c[l + 1]) row-major, BatchNorm folded
  const float* b[kMaxTail];  // (c[l + 1],)
  int c[kMaxTail + 1];       // c[0] = H1, c[l + 1] = width of tail layer l
  int n;                     // number of tail layers (0 = layer 0 is the output)
};

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// max over the rows of one center, into cmax (all values are >= 0 after the
// ReLU, so their int bit patterns order like the floats)
__device__ __forceinline__ void max_into(float* cmax, int center, int col, int width, float v) {
  atomicMax(reinterpret_cast<int*>(cmax) + center * width + col, __float_as_int(v));
}

__global__ void __launch_bounds__(kThreads)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ ctr,
          const float* __restrict__ z, const float* __restrict__ off, const Tail tail,
          float* __restrict__ out, int* __restrict__ idx_out, int n, int m_total, int ns,
          int tm, int width, float r2) {
  extern __shared__ float smem[];
  float* buf0 = smem;                                     // kRows x width
  float* buf1 = buf0 + kRows * width;                     // kRows x width
  int* nbr = reinterpret_cast<int*>(buf1 + kRows * width);  // kRows
  float* cmax = reinterpret_cast<float*>(nbr + kRows);    // tm x c_out

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * tm;
  const int rows = tm * ns;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h1 = tail.c[0];
  const int c_out = tail.c[tail.n];

  for (int e = threadIdx.x; e < tm * c_out; e += blockDim.x) cmax[e] = 0.0f;

  // 1. ball query, one warp per center
  for (int t = warp; t < tm; t += kThreads / 32) {
    int* row = nbr + t * ns;
    const int m = m0 + t;
    if (m >= m_total) {
      for (int s = lane; s < ns; s += 32) row[s] = 0;
      continue;
    }
    const float* c = ctr + (static_cast<size_t>(b) * m_total + m) * 3;
    const float cx = c[0], cy = c[1], cz = c[2];
    const float c2 = sq_norm(cx, cy, cz);
    int count = 0;
    for (int j0 = 0; j0 < n && count < ns; j0 += 32) {
      const int j = j0 + lane;
      bool in = false;
      if (j < n) {
        const float* p = xyz + (static_cast<size_t>(b) * n + j) * 3;
        const float px = p[0], py = p[1], pz = p[2];
        const float cross =
            __fadd_rn(__fadd_rn(__fmul_rn(cx, px), __fmul_rn(cy, py)), __fmul_rn(cz, pz));
        const float d2 = fmaxf(__fsub_rn(__fadd_rn(c2, sq_norm(px, py, pz)), __fmul_rn(2.0f, cross)), 0.0f);
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
    const int used = count < ns ? count : ns;
    const int pad = used > 0 ? row[0] : 0;
    for (int s = used + lane; s < ns; s += 32) row[s] = pad;
  }
  __syncthreads();

  if (idx_out != nullptr) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int m = m0 + r / ns;
      if (m < m_total) idx_out[(static_cast<size_t>(b) * m_total + m) * ns + r % ns] = nbr[r];
    }
  }

  // 2. layer 0: relu(Z[neighbour] + O[center])
  for (int e = threadIdx.x; e < rows * h1; e += blockDim.x) {
    const int r = e / h1;
    const int col = e - r * h1;
    int m = m0 + r / ns;
    if (m >= m_total) m = m_total - 1;
    const float v = z[(static_cast<size_t>(b) * n + nbr[r]) * h1 + col] +
                    off[(static_cast<size_t>(b) * m_total + m) * h1 + col];
    buf0[r * width + col] = fmaxf(v, 0.0f);
  }
  __syncthreads();

  if (tail.n == 0) {
    for (int e = threadIdx.x; e < tm * h1; e += blockDim.x) {
      const int t = e / h1;
      const int col = e - t * h1;
      float v = 0.0f;
      for (int s = 0; s < ns; ++s) v = fmaxf(v, buf0[(t * ns + s) * width + col]);
      cmax[e] = v;
    }
  }

  // 3. tail layers: thread (warp, lane) owns rows warp*8 .. warp*8+7 and
  //    columns c0 + lane + 32*j, j < 4
  float* src = buf0;
  float* dst = buf1;
  const int r0 = warp * kRowsPerThread;
  for (int l = 0; l < tail.n; ++l) {
    const int k_in = tail.c[l];
    const int c_l = tail.c[l + 1];
    const float* __restrict__ w = tail.w[l];
    const float* __restrict__ bias = tail.b[l];
    const bool last = l == tail.n - 1;
    for (int c0 = 0; c0 < c_l; c0 += 32 * kColsPerThread) {
      float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

      for (int k = 0; k < k_in; ++k) {
        float wv[kColsPerThread];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          const int col = c0 + lane + 32 * j;
          wv[j] = col < c_l ? __ldg(w + static_cast<size_t>(k) * c_l + col) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float a = src[(r0 + i) * width + k];
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = c0 + lane + 32 * j;
        if (col >= c_l) continue;
        const float bj = __ldg(bias + col);
        int center = -1;
        float run = 0.0f;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = r0 + i;
          if (r >= rows) break;
          const float v = fmaxf(acc[i][j] + bj, 0.0f);
          if (!last) {
            dst[r * width + col] = v;
          } else if (r / ns != center) {
            if (center >= 0) max_into(cmax, center, col, c_l, run);
            center = r / ns;
            run = v;
          } else {
            run = fmaxf(run, v);
          }
        }
        if (last && center >= 0) max_into(cmax, center, col, c_l, run);
      }
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  // 4. write the per-center maxima
  for (int e = threadIdx.x; e < tm * c_out; e += blockDim.x) {
    const int t = e / c_out;
    const int m = m0 + t;
    if (m < m_total) out[(static_cast<size_t>(b) * m_total + m) * c_out + (e - t * c_out)] = cmax[e];
  }
}

}  // namespace

// xyz (B, N, 3), ctr (B, M, 3), z (B, N, H1), off (B, M, H1), out (B, M, C_out),
// all float32 and contiguous on the device. w[l] (widths[l], widths[l + 1]) and
// b[l] (widths[l + 1],) are device pointers held in host arrays of n_tail
// entries. idx_out (B, M, ns) int32 receives the neighbour table when it is not
// null. Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int sa_forward(const float* xyz, const float* ctr, const float* z, const float* off,
                          int n_tail, const float* const* w, const float* const* b,
                          const int* widths, float* out, int* idx_out, int batch, int n,
                          int m_total, int ns, float r2, void* stream) {
  if (batch < 1 || n < 1 || m_total < 1 || ns < 1 || ns > kRows || n_tail < 0 ||
      n_tail > kMaxTail) {
    return cudaErrorInvalidValue;
  }
  Tail tail;
  tail.n = n_tail;
  tail.c[0] = widths[0];
  for (int l = 0; l < n_tail; ++l) {
    tail.w[l] = w[l];
    tail.b[l] = b[l];
    tail.c[l + 1] = widths[l + 1];
  }
  // activations stored in the ping-pong buffers: layer 0 and every tail layer
  // but the last
  int width = widths[0];
  for (int l = 1; l < n_tail; ++l) width = widths[l] > width ? widths[l] : width;
  const int tm = kRows / ns;
  const size_t smem =
      (2 * static_cast<size_t>(kRows) * width + kRows + static_cast<size_t>(tm) * widths[n_tail]) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m_total + tm - 1) / tm, batch);
  sa_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      xyz, ctr, z, off, tail, out, idx_out, n, m_total, ns, tm, width, r2);
  return cudaGetLastError();
}
