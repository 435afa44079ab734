// Farthest point sampling on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptt_tpu/ops/pallas_fps.py:_fps_kernel.
// Semantics: start at index 0; each round takes the point whose running minimum
// squared distance to the chosen set is largest, ties to the lowest index.
//
// What bounds it: latency, not bytes or operations. A round depends on the
// previous round's choice, so npoint rounds run one after another, and each
// round is a block-wide argmax with two barriers. The whole cloud and the
// running minimum live in shared memory (16 B a point: 16 KB at N = 1024), so
// after one read of the input no round touches device memory. One block per
// batch row; the Siamese pair call gives 2B blocks, which leaves most of the
// 132 SMs idle at small B (a later redesign would split a row over a cluster).
// fps_chain_probe times this design's chain of rounds alone: what its per-point
// work adds to. It is no bound of the function; a round with one barrier, or a
// smaller block with more points a thread, has a shorter chain.
//
// Bit-exactness: the distance is ((dx*dx + dy*dy) + dz*dz) with every product
// and sum rounded on its own (__fmul_rn/__fadd_rn stop nvcc contracting them
// into FMAs), the order of the plain PyTorch version in ops/point_ops.py.
// Resampling with replacement puts duplicate points in every cloud, so exact
// ties are routine; the reduction keeps the lowest index among equal maxima.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;

// larger value wins; of two equal values, the lower index
__device__ __forceinline__ void keep_better(float& best_v, int& best_i, float v, int i) {
  if (v > best_v || (v == best_v && i < best_i)) {
    best_v = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(kFullMask, v, off);
    const int oi = __shfl_down_sync(kFullMask, i, off);
    keep_better(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint) {
  extern __shared__ float4 pts[];  // (x, y, z, running min squared distance)
  __shared__ float warp_v[kMaxThreads / 32];
  __shared__ int warp_i[kMaxThreads / 32];
  __shared__ int chosen;

  const float* src = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* dst = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    pts[i] = make_float4(src[3 * i], src[3 * i + 1], src[3 * i + 2], 1e10f);
  }
  if (threadIdx.x == 0) dst[0] = 0;
  __syncthreads();

  int cur = 0;
  for (int k = 1; k < npoint; ++k) {
    const float cx = pts[cur].x, cy = pts[cur].y, cz = pts[cur].z;
    float best_v = -1.0f;  // every running minimum is >= 0
    int best_i = n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float4 p = pts[i];
      const float dx = __fsub_rn(p.x, cx);
      const float dy = __fsub_rn(p.y, cy);
      const float dz = __fsub_rn(p.z, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      const float m = fminf(p.w, d);
      pts[i].w = m;
      keep_better(best_v, best_i, m, i);
    }
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < n_warps ? warp_v[lane] : -1.0f;
      best_i = lane < n_warps ? warp_i[lane] : n;
      warp_argmax(best_v, best_i);
      if (lane == 0) {
        chosen = best_i;
        dst[k] = best_i;
      }
    }
    __syncthreads();
    cur = chosen;
  }
}

// The chain of one round without its per-point work: a warp argmax, a barrier,
// the first warp's argmax over the warps' results, a barrier, the read of the
// choice, each round depending on the one before. Its time per round is the
// least a round of fps_kernel can take at the same block size, whatever N.
__global__ void __launch_bounds__(kMaxThreads) fps_chain_kernel(int* __restrict__ out, int rounds) {
  __shared__ float warp_v[kMaxThreads / 32];
  __shared__ int warp_i[kMaxThreads / 32];
  __shared__ int chosen;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int cur = 0;
  for (int k = 1; k < rounds; ++k) {
    float best_v = static_cast<float>((cur + threadIdx.x) & 1023);
    int best_i = threadIdx.x;
    warp_argmax(best_v, best_i);
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < n_warps ? warp_v[lane] : -1.0f;
      best_i = lane < n_warps ? warp_i[lane] : blockDim.x;
      warp_argmax(best_v, best_i);
      if (lane == 0) chosen = best_i;
    }
    __syncthreads();
    cur = chosen;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = cur;
}

}  // namespace

// The block size fps_forward gives a cloud of n points.
static int fps_threads(int n) {
  const int threads = ((n + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

// Runs the dependent chain of `npoint` rounds (fps_chain_kernel) in `batch`
// blocks of the size fps_forward uses for n points; out (batch,) int32. For
// timing the chain of fps_forward's present design. Returns the launch's cudaError_t.
extern "C" int fps_chain_probe(int* out, int batch, int n, int npoint, void* stream) {
  if (batch < 1 || n < 1 || npoint < 1) return cudaErrorInvalidValue;
  fps_chain_kernel<<<batch, fps_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(out, npoint);
  return cudaGetLastError();
}

// xyz (B, N, 3) float32 and out (B, npoint) int32, both contiguous on the
// device; launches on `stream`. Returns the cudaError_t of the launch (0 = ok).
extern "C" int fps_forward(const float* xyz, int* out, int batch, int n, int npoint, void* stream) {
  if (batch < 1 || n < 1 || npoint < 1 || npoint > n) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(n) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<<<batch, fps_threads(n), smem, static_cast<cudaStream_t>(stream)>>>(xyz, out, n, npoint);
  return cudaGetLastError();
}
