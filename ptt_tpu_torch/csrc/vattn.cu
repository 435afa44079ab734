// kNN vector attention of the transformer blocks' eval forward on Hopper
// (sm_90a): the input of fc_gamma before it, the softmax and the weighted sum
// of the neighbours after it.
//
// Replaces no TPU kernel. The JAX package leaves this glue to XLA, which fuses
// it into the passes around it; on the card it ran as about ten PyTorch passes
// over (B, N, k, d) float32 tensors (two gathers, q - k, + pos, v + pos, the
// division, the softmax, the product and the sum), some 19 tensors' worth of
// bytes a layer, and in a multi-head layer also a copy of fc_gamma's permuted
// input and of its output, which kept fc_gamma.0 off csrc/tf32x3.cu. For a
// query (b, n), its neighbours idx[b, n, 0..k) among the batch row's N_ref
// points and a channel c < d:
//
//   vattn_in_kernel:  A[b, n, j, c] = (q[b, n, c] - kproj[b, idx[b, n, j], c]) + pos[b, n, j, c]
//   (the caller's fc_gamma, row-wise over the last axis: logits = fc_gamma(A), on csrc/tf32x3.cu)
//   vattn_out_kernel: res[b, n, c] = sum_j softmax_j(logits[b, n, j, c] / s)
//                                          * (vproj[b, idx[b, n, j], c] + pos[b, n, j, c])
//
// with s = sqrt(scale): d_model in TransformerBlock, head_dim in
// MulHeadTransformerLayer. A head is a run of consecutive channels and each
// channel's softmax is its own, so one kernel serves every head count: A in
// (B, N, k, d) is the memory of the (B * N * k * H, head_dim) rows a shared
// fc_gamma reads, and res comes out in (B, N, H * head_dim) order.
//
// What bounds them: bytes, at well under one operation a byte. The least bytes
// of a call of both, Q = B * N queries (ops/vattn.py, benchmark/counts/vattn.py):
//   vattn_in:  pos and A, Q k d floats each; q and kproj, Q d each; idx, Q k ints;
//   vattn_out: logits and pos, Q k d floats each; vproj and res, Q d each; idx.
// That is 4 (4 Q k d + 4 Q d + 2 Q k) bytes: at ptt_waymo's centroid layer
// (Q = 2048, k = 16, d = 512) 285 MB, 85 us at 3.35 TB/s. What the design does
// about it:
//  * A thread owns one (query, 16-byte column) for all k neighbours: the query's
//    neighbour indices are read once a neighbour by the warp (one broadcast
//    load), q or the running sums stay in registers, and no division is made per
//    element. Consecutive threads take consecutive columns, so each 16-byte load
//    and store of a warp covers 512 contiguous bytes.
//  * kproj and vproj, (B, N_ref, d) and 4 MB at the largest call, are read by
//    every query that names a point: 16-byte ld.global.nc loads, which L2 serves.
//    pos and logits are read once, by streaming loads (ld.global.cs), and A and
//    attn leave by streaming stores (st.global.cs), so that the tensor-sized
//    streams do not evict the projections.
//  * vattn_in keeps 4 neighbours' loads in flight a thread. vattn_out keeps its
//    k <= 16 logits in registers: the max, expf of the difference and the sum,
//    then each e_j / sum times (v + pos), added in neighbour order, each
//    neighbour's loads made before its division. (Every configuration searches
//    16 neighbours; a call with more takes the plain path, ops/vattn.py.)
//  * The logits are scaled by the reciprocal of s, not divided by it: that is
//    what the plain path does on the card (PyTorch's CUDA division by a Python
//    scalar multiplies by its float32 reciprocal), and the divisions were the
//    kernel's largest compute. The four calls of the cells' frame steps took
//    0.186 ms in the first design (divided by s, a neighbour's loads after its
//    division), 0.171 with the loads first, 0.146 with times 1 / s (PERF.md).
//    Tried and dropped: loading the next 4 neighbours' v and pos ahead
//    (0.195 ms), dividing by the sum once at the end (no faster).
// Arithmetic: A is one subtraction then one addition, each rounded (__fsub_rn,
// __fadd_rn), in the plain path's order, so it equals the plain version bit for
// bit. The softmax divides each e_j by the sum, as torch.softmax does: attn came
// out equal to the plain version on the card; the weighted sum runs in another
// order than PyTorch's reduction (within 1e-6 relative,
// tests/test_torch_port_vattn.py; the CPU's plain version divides by s).
//
// Shapes: 1 <= k <= 16, d a multiple of 4, idx in [0, N_ref) (a kNN's, not
// checked here), float32 tensors contiguous and 16-byte aligned, idx int32; the
// entry points refuse any other call, as ops/vattn.py does before them. No host
// synchronisation and no allocation: both launch into a CUDA graph's capture.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // neighbours whose loads a vattn_in thread has in flight together
constexpr int kMaxK = 16;  // neighbours a query: vattn_out keeps each one's logits in registers

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 div4(float4 a, float4 b) {
  return make_float4(__fdiv_rn(a.x, b.x), __fdiv_rn(a.y, b.y), __fdiv_rn(a.z, b.z), __fdiv_rn(a.w, b.w));
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z), fmaxf(a.w, b.w));
}

__device__ __forceinline__ float4 exp4(float4 a) { return make_float4(expf(a.x), expf(a.y), expf(a.z), expf(a.w)); }

// One thread per (query, 16-byte column): queries = B * N, dv = d / 4 columns.
__global__ void __launch_bounds__(kThreads)
vattn_in_kernel(const float4* __restrict__ q, const float4* __restrict__ kproj, const int* __restrict__ idx,
                const float4* __restrict__ pos, float4* __restrict__ out, int queries, int n, int n_ref, int k,
                int dv) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(queries) * dv) return;
  const int qi = static_cast<int>(e / dv);
  const int col = static_cast<int>(e - static_cast<long long>(qi) * dv);
  const float4 qv = __ldg(q + e);
  const float4* kb = kproj + static_cast<size_t>(qi / n) * n_ref * dv + col;
  const int* nbr = idx + static_cast<size_t>(qi) * k;
  const size_t row0 = static_cast<size_t>(qi) * k;  // the query's first row of pos and A
  for (int j0 = 0; j0 < k; j0 += kInFlight) {
    float4 kv[kInFlight], pv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (j0 + u < k) {
        kv[u] = __ldg(kb + static_cast<size_t>(__ldg(nbr + j0 + u)) * dv);
        pv[u] = __ldcs(pos + (row0 + j0 + u) * dv + col);
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (j0 + u < k) __stcs(out + (row0 + j0 + u) * dv + col, add4(sub4(qv, kv[u]), pv[u]));
    }
  }
}

// As vattn_in_kernel's threads; kMaxK >= k slots of logits in registers. attn may be null.
__global__ void __launch_bounds__(kThreads)
vattn_out_kernel(const float4* __restrict__ logits, const float4* __restrict__ vproj, const int* __restrict__ idx,
                 const float4* __restrict__ pos, float4* __restrict__ res, float4* __restrict__ attn, int queries,
                 int n, int n_ref, int k, int dv, float s) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<long long>(queries) * dv) return;
  const int qi = static_cast<int>(e / dv);
  const int col = static_cast<int>(e - static_cast<long long>(qi) * dv);
  const float4* vb = vproj + static_cast<size_t>(qi / n) * n_ref * dv + col;
  const int* nbr = idx + static_cast<size_t>(qi) * k;
  const size_t row0 = static_cast<size_t>(qi) * k;
  const float r = __frcp_rn(s);  // 1 / s rounded to nearest, as PyTorch's CUDA division by a scalar takes it
  const float4 rv = make_float4(r, r, r, r);
  float4 w[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) w[j] = __ldcs(logits + (row0 + j) * dv + col);
  }
  float4 mx = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      w[j] = mul4(w[j], rv);
      mx = max4(mx, w[j]);
    }
  }
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      w[j] = exp4(sub4(w[j], mx));
      sum = add4(sum, w[j]);
    }
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < k) {
      const float4 v = add4(__ldg(vb + static_cast<size_t>(__ldg(nbr + j)) * dv), __ldcs(pos + (row0 + j) * dv + col));
      const float4 a = div4(w[j], sum);
      if (attn != nullptr) __stcs(attn + (row0 + j) * dv + col, a);
      acc = add4(acc, mul4(a, v));
    }
  }
  res[e] = acc;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of a launch over batch * n queries of d / 4 columns, or 0 for a call the kernels refuse.
int grid_of(int batch, int n, int n_ref, int k, int d) {
  if (batch < 1 || n < 1 || n_ref < 1 || k < 1 || k > kMaxK || d < 4 || d % 4 != 0) return 0;
  const long long threads = static_cast<long long>(batch) * n * (d / 4);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  return blocks > INT_MAX || static_cast<long long>(batch) * n > INT_MAX ? 0 : static_cast<int>(blocks);
}

}  // namespace

// q (batch, n, d), kproj (batch, n_ref, d), pos and out (batch, n, k, d) float32,
// idx (batch, n, k) int32, all contiguous on the device, the float32 ones 16-byte
// aligned; 1 <= k <= 16, d a multiple of 4. Any other call is refused with
// cudaErrorInvalidValue. Launches one kernel on `stream`; returns the
// cudaError_t of the launch (0 = ok).
extern "C" int vattn_in(const float* q, const float* kproj, const int* idx, const float* pos, float* out, int batch,
                        int n, int n_ref, int k, int d, void* stream) {
  const int blocks = grid_of(batch, n, n_ref, k, d);
  if (blocks == 0 || !aligned16(q) || !aligned16(kproj) || !aligned16(pos) || !aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  vattn_in_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(kproj), idx,
      reinterpret_cast<const float4*>(pos), reinterpret_cast<float4*>(out), batch * n, n, n_ref, k, d / 4);
  return cudaGetLastError();
}

// logits and pos (batch, n, k, d), vproj (batch, n_ref, d) float32, idx (batch,
// n, k) int32, res (batch, n, d) and, unless null, attn (batch, n, k, d) float32
// outputs, as vattn_in; s = sqrt(scale) > 0. Launches one kernel on `stream`;
// returns the cudaError_t of the launch (0 = ok).
extern "C" int vattn_out(const float* logits, const float* vproj, const int* idx, const float* pos, float* res,
                         float* attn, int batch, int n, int n_ref, int k, int d, float s, void* stream) {
  const int blocks = grid_of(batch, n, n_ref, k, d);
  if (blocks == 0 || !(s > 0.f) || !aligned16(logits) || !aligned16(vproj) || !aligned16(pos) || !aligned16(res) ||
      !aligned16(attn)) {
    return cudaErrorInvalidValue;
  }
  vattn_out_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(logits), reinterpret_cast<const float4*>(vproj), idx,
      reinterpret_cast<const float4*>(pos), reinterpret_cast<float4*>(res), reinterpret_cast<float4*>(attn),
      batch * n, n, n_ref, k, d / 4, s);
  return cudaGetLastError();
}
