// Farthest point sampling on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptt_tpu/ops/pallas_fps.py:_fps_kernel.
// Semantics: start at index 0; each round takes the point whose running minimum
// squared distance to the chosen set is largest, ties to the lowest index.
//
// What bounds it: latency, not bytes or operations. Round k needs round k - 1's
// choice, so npoint rounds run one after another in one block per batch row,
// and a round is a chain: read the chosen point, update the distances, find the
// argmax over the row. The design shortens that chain:
//
//  * A thread keeps its 4 (or 16) points and their running minima in registers
//    for the whole kernel (point i = p * threads + thread: slot p of a thread is
//    ascending in i). Shared memory holds the coordinates only for the one
//    broadcast read of the chosen point a round (16 B a point, one load).
//  * A warp's argmax is two instructions. Every running minimum is a float in
//    [+0, 1e10], and the bits of non-negative floats order as unsigned
//    integers: redux.sync.max on the bits gives the warp's largest value,
//    redux.sync.min on the index of the lanes that hold it (the others pass
//    0xffffffff) its lowest index. A thread first reduces its own points in
//    ascending index with a strict compare, so its candidate is its lowest.
//  * One barrier a round. Each warp writes its (bits, index) into a slot of the
//    buffer the round's parity selects; after one __syncthreads every warp
//    reads all slots and reduces them itself with the same two instructions, so
//    no second barrier publishes a choice. Two buffers suffice: a warp reaches
//    round k + 2's write only after every warp has left round k + 1's barrier
//    and so has read round k's slots. With one warp a row there is no barrier.
//  * Forms, chosen by N (FPS_FORMS below): 1 warp a row of 4 points a thread
//    up to 128 points, 8 warps up to 1024, 16 up to 2048, and 16 warps of 16
//    points a thread up to 8192 (ptt_waymo.yaml's search cloud, and its
//    2048-point template padded to it in the pair call); larger clouds are
//    refused. A form's cloud copy lies in dynamic shared
//    memory (128 KB at 8192 points). Slots past N hold a running minimum of 0
//    and an index above every real one, so they never win.
//
// Tried and dropped, times of (16, 1024, 3) -> 512 on an H100 (PERF.md): the
// first design (the cloud and the minima in shared memory, 16 warps, a
// five-level shuffle argmax of (value, index) pairs in every warp, a second one
// in warp 0 and two barriers a round), 0.338 ms for this one's 0.104; 4 warps of
// 8 points a thread, which a count of scheduler slots favours, 0.132, and 2 of
// 16, 0.168: the distance chain of a thread's points does not hide its own
// latency, more warps do; every thread reading all warps' results as 64-bit
// keys (bits above the complemented index) and taking their largest itself
// instead of the second redux pair, 0.135; a ballot and the lowest holder lane
// (a thread's points consecutive, so that lane order is index order) instead
// of the redux on the index, 0.148 (redux 44 cycles; ballot 17, but find-first
// and the shuffle that broadcasts the index cost more than they save). Not
// taken: a row split over a thread-block cluster; an exchange through another
// SM's shared memory costs more than the block barrier it would replace, and
// the chain, not the SM's rate, is what bounds the kernel.
// At 8192 points, (16, 8192, 3) -> 2048 (ptt_waymo.yaml's pair call) on an
// H100 (PERF.md, python3 -m ptt_tpu_torch.variants): 16 warps of 16 points a
// thread 1.472 ms, 32 warps of 8 points 1.525 (its 32-warp barrier costs more
// than the longer distance chain of 16 points); a cluster form is not tried
// (the note above; every row is a block of its own, 16 of 132 SMs).
//
// Bit-exactness: the distance is ((dx*dx + dy*dy) + dz*dz) with every product
// and sum rounded on its own (__fmul_rn/__fadd_rn stop nvcc contracting them
// into FMAs), the order of the plain PyTorch version in ops/point_ops.py.
// Resampling with replacement puts duplicate points in every cloud, so exact
// ties are routine; the reduction keeps the lowest index among equal maxima.
//
// fps_probe times dependent chains of the primitives a round is made of (float
// add, shuffle, redux, ballot, shared-memory load and store-load, barrier), in
// cycles by the SM's clock, and that clock: the least-cycle constants of the
// latency bound are set under its readings.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;

// (largest N, warps a row, points a thread) of each form, in order of N
#define FPS_FORMS(X) X(128, 1, 4) X(1024, 8, 4) X(2048, 16, 4) X(8192, 16, 16)

// the warp's largest `bits` and the lowest `index` among the lanes that hold it
__device__ __forceinline__ void warp_argmax(unsigned& bits, unsigned& index) {
  const unsigned top = __reduce_max_sync(kFullMask, bits);
  index = __reduce_min_sync(kFullMask, bits == top ? index : kNoIndex);
  bits = top;
}

template <int kWarps, int kPts>
__global__ void __launch_bounds__(kWarps * 32)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint) {
  constexpr int kThreads = kWarps * 32;
  extern __shared__ float4 pts[];          // kThreads * kPts (x, y, z, -): read once a round, the chosen point
  __shared__ uint2 slot[2][kWarps];        // a warp's (bits, index), buffer by the round's parity

  const float* src = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  int* dst = out + static_cast<size_t>(blockIdx.x) * npoint;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float px[kPts], py[kPts], pz[kPts], md[kPts];
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const int i = p * kThreads + threadIdx.x;
    const bool real = i < n;
    px[p] = real ? src[3 * i] : 0.0f;
    py[p] = real ? src[3 * i + 1] : 0.0f;
    pz[p] = real ? src[3 * i + 2] : 0.0f;
    md[p] = real ? 1e10f : 0.0f;  // a slot past N stays at 0 and never wins
    pts[i] = make_float4(px[p], py[p], pz[p], 0.0f);
  }
  if (threadIdx.x == 0) dst[0] = 0;
  __syncthreads();

  unsigned cur = 0;
  for (int k = 1; k < npoint; ++k) {
    const float4 c = pts[cur];
    unsigned bits = 0, index = 0;
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      const float dx = __fsub_rn(px[p], c.x);
      const float dy = __fsub_rn(py[p], c.y);
      const float dz = __fsub_rn(pz[p], c.z);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      md[p] = fminf(md[p], d);
      const unsigned b = __float_as_uint(md[p]);
      if (p == 0 || b > bits) {  // strict: of equal values the lower slot, the lower index
        bits = b;
        index = p * kThreads + threadIdx.x;
      }
    }
    warp_argmax(bits, index);
    if (kWarps > 1) {
      if (lane == 0) slot[k & 1][warp] = make_uint2(bits, index);
      __syncthreads();
      const uint2 v = slot[k & 1][lane & (kWarps - 1)];
      bits = v.x;
      index = v.y;
      warp_argmax(bits, index);
    }
    cur = index;
    if (threadIdx.x == 0) dst[k] = static_cast<int>(cur);
  }
}

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
// the clock once `dep` is known: the chain before it cannot move past the read
__device__ __forceinline__ long long clock_after(unsigned dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(dep) : "memory");
  return t;
}

constexpr int kProbeSteps = 7;

// Cycles of `iters` dependent steps of each primitive, one chain after the
// other, as thread 0 sees them: out[0] float add, [1] shuffle, [2] redux,
// [3] ballot with the compare that makes its predicate, [4] shared-memory load
// (a pointer chase), [5] shared-memory store then load of the same word,
// [6] __syncthreads of the block. out[7] and out[8] are the kernel's cycles and
// nanoseconds (%globaltimer), which give the SM's clock; out[9] carries the
// chains' results so that none is dead code.
__global__ void __launch_bounds__(512) fps_probe_kernel(long long* __restrict__ out, int iters) {
  __shared__ int chase[32];
  __shared__ unsigned word[512];
  const int lane = threadIdx.x & 31;
  chase[lane] = (lane + 1) & 31;
  word[threadIdx.x] = threadIdx.x;
  __syncthreads();
  long long cycles[kProbeSteps];
  unsigned sink = 0;
  long long ns0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns0)::"memory");
  const long long start = clock_now();

  long long t0 = clock_now();
  float x = static_cast<float>(t0 & 1);
#pragma unroll 16
  for (int i = 0; i < iters; ++i) x = __fadd_rn(x, 1.0f);
  cycles[0] = clock_after(__float_as_uint(x)) - t0;
  sink += __float_as_uint(x);

  t0 = clock_now();
  unsigned v = static_cast<unsigned>(t0 & 1) + lane;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) v = __shfl_xor_sync(kFullMask, v, 1);
  cycles[1] = clock_after(v) - t0;
  sink += v;

  t0 = clock_now();
  v = static_cast<unsigned>(t0 & 1) + lane;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) v = __reduce_max_sync(kFullMask, v);
  cycles[2] = clock_after(v) - t0;
  sink += v;

  t0 = clock_now();
  v = static_cast<unsigned>(t0 & 1) + lane;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) v = __ballot_sync(kFullMask, v != 0);
  cycles[3] = clock_after(v) - t0;
  sink += v;

  t0 = clock_now();
  int j = (static_cast<int>(t0 & 1) + lane) & 31;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) j = reinterpret_cast<volatile int*>(chase)[j];
  cycles[4] = clock_after(j) - t0;
  sink += j;

  t0 = clock_now();
  v = static_cast<unsigned>(t0 & 1) + lane;
  volatile unsigned* mine = word + threadIdx.x;
#pragma unroll 16
  for (int i = 0; i < iters; ++i) {
    *mine = v;
    v = *mine + 1u;
  }
  cycles[5] = clock_after(v) - t0;
  sink += v;

  t0 = clock_now();
#pragma unroll 16
  for (int i = 0; i < iters; ++i) __syncthreads();
  cycles[6] = clock_now() - t0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kProbeSteps; ++i) out[i] = cycles[i];
    long long ns1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns1)::"memory");
    out[kProbeSteps] = clock_now() - start;
    out[kProbeSteps + 1] = ns1 - ns0;
    out[kProbeSteps + 2] = sink;
  }
}

template <int kWarps, int kPts>
cudaError_t launch(const float* xyz, int* out, int batch, int n, int npoint, cudaStream_t st) {
  constexpr size_t smem = sizeof(float4) * kWarps * 32 * kPts;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fps_kernel<kWarps, kPts>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fps_kernel<kWarps, kPts><<<batch, kWarps * 32, smem, st>>>(xyz, out, n, npoint);
  return cudaGetLastError();
}

}  // namespace

// The form fps_forward runs a cloud of n points in: *warps a row and *pts points
// a thread. Returns 0, or -1 when n is beyond the largest form.
extern "C" int fps_form(int n, int* warps, int* pts) {
#define FPS_FORM(limit, w, p) \
  if (n <= (limit)) {         \
    *warps = (w);             \
    *pts = (p);               \
    return 0;                 \
  }
  FPS_FORMS(FPS_FORM)
#undef FPS_FORM
  *warps = 0;
  *pts = 0;
  return -1;
}

// Times the primitives of a round in one block of `threads` threads (a multiple
// of 32, at most 512): out (10,) int64 receives the cycles of `iters` dependent
// steps of each (fps_probe_kernel). Returns the launch's cudaError_t.
extern "C" int fps_probe(long long* out, int iters, int threads, void* stream) {
  if (iters < 1 || threads < 32 || threads > 512 || threads % 32 != 0) return cudaErrorInvalidValue;
  fps_probe_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return cudaGetLastError();
}

// xyz (B, N, 3) float32 and out (B, npoint) int32, both contiguous on the
// device, N at most 8192; launches on `stream`. Returns the cudaError_t of the
// launch (0 = ok).
extern "C" int fps_forward(const float* xyz, int* out, int batch, int n, int npoint, void* stream) {
  if (batch < 1 || n < 1 || npoint < 1 || npoint > n) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
#define FPS_LAUNCH(limit, w, p) \
  if (n <= (limit)) return launch<w, p>(xyz, out, batch, n, npoint, st);
  FPS_FORMS(FPS_LAUNCH)
#undef FPS_LAUNCH
  return cudaErrorInvalidValue;
}
