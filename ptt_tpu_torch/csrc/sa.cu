// Fused eval-mode set-abstraction stage on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ptt_tpu/ops/pallas_sa.py:_sa_kernel. One call
// of sa_forward does ball query, the neighbourhood gather of the first layer's
// activations, the BatchNorm-folded tail MLP and the max over the neighbourhood;
// the grouped (B, M, ns, C) tensor never reaches device memory.
//
// Two launches. sa_pre_kernel computes what the main kernel gathers and
// multiplies with: layer 0 is linear and commutes with the gather, so it is
// Z = [xyz | feats] @ W1' over the N source points and the per-center offset
// O = b1 - center @ W1'_xyz (full float32 on the CUDA cores: the xyz terms
// cancel), and in sa_kernel layer 0 is relu(Z[neighbour] + O[center]), gathered
// by index with 16-byte loads; and it splits the tail weights into TF32 parts
// in the layout the tensor cores read (below). sa_kernel is launched with
// programmatic stream serialization: its ball query needs none of that and
// runs beside sa_pre_kernel; it waits (griddepcontrol.wait) before the gather.
//
// What bounds it: operations. Per row (center, slot) the tail layers cost
// sum(K*C) multiply-adds (12 K at the first backbone stage, 131 K at vote
// aggregation); the inputs are a few MB and stay in L2. On CUDA cores with the
// weights read through L1 the tail took 89% of the kernel's time (1.88 of
// 2.11 ms for the 7 calls of a frame step, H100), so the design is built
// around the tail:
//
//  * The tail runs on the tensor cores at float32 accuracy. A single TF32 pass
//    keeps ~3 decimal digits, too few for the 1e-4 gate and for the argmax
//    that follows the network. Each operand is split, x = hi + lo with
//    hi = tf32(x) (round to nearest, by Veltkamp's splitting on the float32
//    pipe) and lo = tf32(x - hi) (x - hi is exact; its low 13 bits are masked),
//    and a_lo*w_hi + a_hi*w_lo + a_hi*w_hi is accumulated in float32, small
//    terms first ("3xTF32"). The dropped a_lo*w_lo term is ~2^-22 of the
//    product.
//  * The instruction is wgmma.m64n128k8 (TF32): a warpgroup of 4 warps holds 64
//    rows x 128 columns of accumulators (64 registers a thread). A comes from
//    registers: warp w of the warpgroup loads and splits rows 16 w .. 16 w + 15
//    of the activations from padded shared memory, each element once in the
//    whole block. B comes from shared memory through a descriptor and must be
//    K-major for TF32, which the (K, C) row-major weights are not; so
//    sa_pre_kernel writes them once per call, already split, as slabs of
//    32 (k) x 128 (n) hi and lo tiles in wgmma's unswizzled core-matrix layout
//    (8 n x 4 k values of 128 bytes, k fastest), and a slab is 32 KB that
//    cp.async copies to shared memory as it is. (mma.sync.m16n8k8 with the
//    weights split at fragment load ran the 7 calls in 0.71 ms, its tail at
//    ~11 cycles per mma and scheduler; wgmma 0.42 ms.)
//  * Slabs go through a ring of kStages = 2 buffers, the next slab loading
//    while the current one multiplies; the stream of slabs runs on across
//    column passes and layers. Within a slab the A fragment of the next K-step
//    is loaded and split while the current step's three wgmma run
//    (wgmma.wait_group 1 frees the other register set).
//  * Every block streams all weights from L2, and with the arithmetic on the
//    tensor cores that stream bounds the kernel (2.9 TB/s over all SMs at
//    128-row blocks). So blocks are as large as shared memory and the grid
//    allow: 256, 128 or 64 rows (4, 2 or 1 warpgroups). A warp reads no rows
//    of the activations but its own 16, so a layer of a single 128-column pass
//    writes its output over its input and one rows x (width + 4) buffer serves
//    the whole MLP (the pad spreads an A fragment's 8 rows x 4 columns over all
//    32 banks); only a stored layer wider than 128 needs a second buffer.
//  * The ball query uses the whole block (ball_query.cuh block_ball_query,
//    shared with group.cu): the cloud is copied to shared memory once
//    (coalesced, 16 bytes a load) into the first activation buffer, which is
//    sized for whichever is larger, the block's activations or the cloud
//    (a 2048-point cloud is 24 KB; a 64-row block of 64-wide layers holds
//    17 KB), so that every block size takes every cloud that fits beside the
//    weight ring; the block's warps are dealt out evenly over
//    its centers, each scanning a contiguous range of the cloud into a list of
//    its own; the lists are merged in range order, which is index order, so the
//    result is the single scan's: first ns hits, pads repeat the first hit, an
//    empty ball uses point 0. Membership is the header's FMA-free arithmetic
//    against float32(r^2).
//  * The last layer's max over a center's rows never touches an atomic: at
//    ns = 16, 32 or 64 a center is 1, 2 or 4 whole warps of rows; a thread
//    takes the max of its two rows, shuffles reduce over the fragment's 8 row
//    groups, and the warps' maxima meet in shared memory.
//
// Shapes: ns is 16, 32 or 64, there is at least one tail layer, every width is
// a multiple of 8 (the K of one wgmma), N is a multiple of 4 (16-byte loads of
// the cloud) and a block of 64 rows, its cloud included, fits in shared memory
// (N up to ~13,000 at 64-wide layers); the entry point refuses any other call,
// as ops/sa.py does before it.

#include <cuda_runtime.h>

#include <cstdint>

#include "ball_query.cuh"

namespace {

constexpr int kPassCols = 128;   // columns of a pass: the N of one wgmma
constexpr int kSlabK = 32;       // weight rows per slab: 4 wgmma K-steps of 8
constexpr int kTileFloats = kSlabK * kPassCols;  // one (hi or lo) tile of a slab, 16 KB
constexpr int kSlabFloats = 2 * kTileFloats;     // hi tile, then lo tile
constexpr int kStages = 2;       // slabs in the ring
constexpr int kActPad = 4;       // activation row stride = width + 4 floats
constexpr int kBufAlign = 256;   // floats: buffers start 1 KB apart, as the weight ring's tiles need
constexpr int kMaxTail = 4;
constexpr size_t kMaxSmem = 227 * 1024;
// A tile holds its 32 x 128 values as 8 x 16 core matrices of 8 columns (n) x
// 4 rows (k), 128 bytes each, k fastest: the K-major, unswizzled layout wgmma
// reads B from. Core matrices next to each other in n are 128 bytes apart, in
// k 2048 bytes apart.
constexpr int kCoreBytesN = 128;
constexpr int kCoreBytesK = 16 * kCoreBytesN;

struct Tail {
  const float* w[kMaxTail];  // (c[l], c[l + 1]) row-major, BatchNorm folded
  const float* b[kMaxTail];  // (c[l + 1],)
  int c[kMaxTail + 1];       // c[0] = H1, c[l + 1] = width of tail layer l; multiples of 8
  int n;                     // number of tail layers, at least 1
};

// slabs of a layer with k_in inputs and c_l outputs
__host__ __device__ inline int layer_slabs(int k_in, int c_l) {
  return ((c_l + kPassCols - 1) / kPassCols) * ((k_in + kSlabK - 1) / kSlabK);
}

// x = hi + lo, both exact in TF32's 10-bit mantissa up to the masked bits of lo
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);  // 2^13 + 1: Veltkamp's splitting
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h)) & 0xffffe000u;
}

// Slab `slab` of the tail weights, split and laid out as sa_kernel reads it;
// slabs are numbered in the order they are multiplied (layer, column pass,
// K-slab). Rows and columns past a layer's edge are zeros. One block of 256
// threads per slab.
__device__ void prep_slab(const Tail& tail, int slab, float* __restrict__ wprep) {
  int q = slab, l = 0;
  while (q >= layer_slabs(tail.c[l], tail.c[l + 1])) q -= layer_slabs(tail.c[l], tail.c[l + 1]), ++l;
  const int k_in = tail.c[l], c_l = tail.c[l + 1];
  const int k_slabs = (k_in + kSlabK - 1) / kSlabK;
  const int c0 = (q / k_slabs) * kPassCols, k0 = (q % k_slabs) * kSlabK;
  float* hi_tile = wprep + static_cast<size_t>(slab) * kSlabFloats;
  for (int e = threadIdx.x; e < kTileFloats; e += 256) {
    const int k = e / kPassCols, nn = e % kPassCols;
    const float x = k0 + k < k_in && c0 + nn < c_l ? tail.w[l][static_cast<size_t>(k0 + k) * c_l + c0 + nn] : 0.0f;
    uint32_t hi, lo;
    split_tf32(x, hi, lo);
    const int at = ((k / 4) * kCoreBytesK + (nn / 8) * kCoreBytesN) / 4 + (nn % 8) * 4 + k % 4;
    hi_tile[at] = __uint_as_float(hi);
    hi_tile[kTileFloats + at] = __uint_as_float(lo);
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Starts the copy of slab q of wprep into `stage` (nothing past the last slab).
// Always commits a group, so that group counts stay uniform.
template <int kThreads>
__device__ __forceinline__ void issue_slab(const float* __restrict__ wprep, int q, int n_slabs, float* stage) {
  if (q < n_slabs) {
    const float* src = wprep + static_cast<size_t>(q) * kSlabFloats;
    for (int e = threadIdx.x; e < kSlabFloats / 4; e += kThreads) cp_async16(stage + 4 * e, src + 4 * e);
  }
  cp_async_commit();
}

// wgmma: the descriptor of a K-major, unswizzled B operand of 8 (k) x 128 (n)
// TF32 values at `tile`: start address, the byte offsets between core matrices
// along k (leading) and along n (stride), each in units of 16 bytes.
__device__ __forceinline__ uint64_t b_descriptor(const float* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kCoreBytesK >> 4) << 16) |
         (static_cast<uint64_t>(kCoreBytesN >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x 128 of the warpgroup, 64 registers a thread) += a (64 x 8, registers)
// * b (8 x 128, shared memory), TF32 operands, float32 accumulate, asynchronous
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// the split A fragment of one K-step: rows g and g + 8 of the warp's 16, columns t4 and t4 + 4
__device__ __forceinline__ void load_a(const float* a, int lda, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(a[0], hi[0], lo[0]);
  split_tf32(a[8 * lda], hi[1], lo[1]);
  split_tf32(a[4], hi[2], lo[2]);
  split_tf32(a[8 * lda + 4], hi[3], lo[3]);
}

// kWarpGroups warpgroups of 64 rows each: blocks of 64, 128 or 256 rows.
template <int kWarpGroups>
__global__ void __launch_bounds__(kWarpGroups * 128)
sa_kernel(const float* __restrict__ xyz, const float* __restrict__ ctr,
          const float* __restrict__ z, const float* __restrict__ off, const Tail tail,
          const float* __restrict__ wprep, int n_slabs, float* __restrict__ out,
          int* __restrict__ idx_out, int n, int m_total, int ns, int tm, int width,
          int two_bufs, int buf0_floats, float r2) {
  constexpr int kWarps = kWarpGroups * 4;
  constexpr int kThreads = kWarps * 32;
  constexpr int kRows = kWarpGroups * 64;  // rows (center, slot) per block
  extern __shared__ __align__(128) float smem[];
  const int lda = width + kActPad;
  float* buf0 = smem;                // kRows x lda, or the cloud (3 n) if larger; holds the cloud first
  float* buf1 = buf0 + buf0_floats;  // kRows x lda, only if a stored layer has several passes
  float* ring = buf1 + (two_bufs ? kRows * lda : 0);  // kStages x kSlabFloats
  float* wmax = ring + kStages * kSlabFloats;         // kWarps x kPassCols
  int* nbr = reinterpret_cast<int*>(wmax + kWarps * kPassCols);    // kRows
  int* cnt = nbr + kRows;                                          // one per hit list
  int* hits = cnt + kRows;                                         // lists of ns slots

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * tm;
  const int rows = tm * ns;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row group of the fragments
  const int t4 = lane & 3;  // thread within the group
  const int h1 = tail.c[0];
  const int c_out = tail.c[tail.n];

  // 1. ball query: the cloud into shared memory (N is a multiple of 4, so every
  //    batch row starts at a 16-byte boundary), then ball_query.cuh's query by
  //    the whole block (nbr rows past the tile's last center get 0)
  for (int e = threadIdx.x; e < (n * 3) >> 2; e += kThreads) {
    reinterpret_cast<float4*>(buf0)[e] =
        __ldg(reinterpret_cast<const float4*>(xyz + static_cast<size_t>(b) * n * 3) + e);
  }
  const float* pts = buf0;
  __syncthreads();
  ptt::block_ball_query<kWarps>(pts, n, ctr + (static_cast<size_t>(b) * m_total + m0) * 3, tm,
                                min(tm, m_total - m0), r2, ns, hits, cnt, nbr, kRows);

  // Everything above reads the caller's inputs only and may run beside
  // sa_pre_kernel; z, off and wprep are its outputs.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  issue_slab<kThreads>(wprep, 0, n_slabs, ring);  // the first weight slab loads under the gather

  if (idx_out != nullptr) {
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int m = m0 + r / ns;
      if (m < m_total) idx_out[(static_cast<size_t>(b) * m_total + m) * ns + r % ns] = nbr[r];
    }
  }

  // 2. layer 0: relu(Z[neighbour] + O[center]), 16 bytes a load; rows past the
  //    block's last center repeat valid data and are never written out
  {
    const int h4 = h1 >> 2;
    constexpr int kGather = 4;  // loads a thread issues before it uses them
    for (int e0 = threadIdx.x; e0 < kRows * h4; e0 += kGather * kThreads) {
      float4 zv[kGather], ov[kGather];
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        const int e = e0 + i * kThreads;
        if (e >= kRows * h4) break;
        const int r = e / h4;
        const int c4 = e - r * h4;
        const int m = min(m0 + r / ns, m_total - 1);
        zv[i] = __ldg(reinterpret_cast<const float4*>(z + (static_cast<size_t>(b) * n + nbr[r]) * h1) + c4);
        ov[i] = __ldg(reinterpret_cast<const float4*>(off + (static_cast<size_t>(b) * m_total + m) * h1) + c4);
      }
#pragma unroll
      for (int i = 0; i < kGather; ++i) {
        const int e = e0 + i * kThreads;
        if (e >= kRows * h4) break;
        const int r = e / h4;
        *reinterpret_cast<float4*>(buf0 + r * lda + 4 * (e - r * h4)) =
            make_float4(fmaxf(zv[i].x + ov[i].x, 0.0f), fmaxf(zv[i].y + ov[i].y, 0.0f),
                        fmaxf(zv[i].z + ov[i].z, 0.0f), fmaxf(zv[i].w + ov[i].w, 0.0f));
      }
    }
  }
  // (the first slab's barrier below also publishes buf0)

  // 3. tail layers on the tensor cores: a warpgroup holds 64 rows, warp w of it
  //    rows 16 w .. 16 w + 15, of each 128-column pass. A warp reads no rows
  //    but its own, so a layer of a single pass writes its output over its
  //    input; only a stored layer of several passes needs the second buffer.
  const int row0 = 16 * warp;  // first row of this warp in the block
  float* src = buf0;
  int slab = 0;
  for (int l = 0; l < tail.n; ++l) {
    const int k_in = tail.c[l];
    const int c_l = tail.c[l + 1];
    const float* __restrict__ bias = tail.b[l];
    const bool to_max = l == tail.n - 1;  // the last layer is never stored
    float* dst = c_l <= kPassCols ? src : (src == buf0 ? buf1 : buf0);
    for (int c0 = 0; c0 < c_l; c0 += kPassCols) {
      const int cp = min(kPassCols, c_l - c0);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

      for (int k0 = 0; k0 < k_in; k0 += kSlabK, ++slab) {
        cp_async_wait<0>();  // this thread's part of slab `slab` has landed
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... and the tensor cores may read it
        __syncthreads();     // ... everyone's has, and slab - 1 is no longer read
        issue_slab<kThreads>(wprep, slab + 1, n_slabs, ring + ((slab + 1) % kStages) * kSlabFloats);
        const float* hi_tile = ring + (slab % kStages) * kSlabFloats;
        const float* lo_tile = hi_tile + kTileFloats;
        const int steps = min(kSlabK, k_in - k0) >> 3;
        const float* a = src + (row0 + g) * lda + k0 + t4;
        uint32_t a_hi[2][4], a_lo[2][4];
        load_a(a, lda, a_hi[0], a_lo[0]);
#pragma unroll
        for (int s = 0; s < kSlabK / 8; ++s) {
          if (s < steps) {
            const uint64_t b_hi = b_descriptor(hi_tile + s * (2 * kCoreBytesK / 4));
            const uint64_t b_lo = b_descriptor(lo_tile + s * (2 * kCoreBytesK / 4));
            wgmma_fence();
            wgmma_tf32(acc, a_lo[s & 1], b_hi);  // small terms first
            wgmma_tf32(acc, a_hi[s & 1], b_lo);
            wgmma_tf32(acc, a_hi[s & 1], b_hi);
            wgmma_commit();
            if (s + 1 < steps) {
              wgmma_wait<1>();  // step s - 1 is done with the other register set
              load_a(a + 8 * (s + 1), lda, a_hi[(s + 1) & 1], a_lo[(s + 1) & 1]);
            }
          }
        }
        wgmma_wait<0>();  // the slab's buffer and the registers are free
      }

      // epilogue of the pass: bias, ReLU, then the next layer's input or the
      // warp's maximum per column; thread holds rows row0 + g and + 8,
      // columns 8 j + 2 t4 and + 1
#pragma unroll
      for (int j = 0; j < kPassCols / 8; ++j) {
        if (8 * j >= cp) continue;
        const int col = c0 + 8 * j + 2 * t4;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        if (!to_max) {
          float* d = dst + (row0 + g) * lda + col;
          *reinterpret_cast<float2*>(d) =
              make_float2(fmaxf(acc[4 * j] + b0, 0.0f), fmaxf(acc[4 * j + 1] + b1, 0.0f));
          *reinterpret_cast<float2*>(d + 8 * lda) =
              make_float2(fmaxf(acc[4 * j + 2] + b0, 0.0f), fmaxf(acc[4 * j + 3] + b1, 0.0f));
        } else {
          float v0 = fmaxf(fmaxf(acc[4 * j], acc[4 * j + 2]) + b0, 0.0f);
          float v1 = fmaxf(fmaxf(acc[4 * j + 1], acc[4 * j + 3]) + b1, 0.0f);
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            v0 = fmaxf(v0, __shfl_xor_sync(ptt::kFullMask, v0, o));
            v1 = fmaxf(v1, __shfl_xor_sync(ptt::kFullMask, v1, o));
          }
          if (g == 0) *reinterpret_cast<float2*>(wmax + warp * kPassCols + 8 * j + 2 * t4) = make_float2(v0, v1);
        }
      }
      if (to_max) {  // a center's rows are ns / 16 whole warps: the max over their maxima
        __syncthreads();
        const int per = ns >> 4;
        for (int e = threadIdx.x; e < tm * cp; e += kThreads) {
          const int t = e / cp;
          const int col = e - t * cp;
          const int m = m0 + t;
          if (m >= m_total) continue;
          float v = wmax[t * per * kPassCols + col];
          for (int w = 1; w < per; ++w) v = fmaxf(v, wmax[(t * per + w) * kPassCols + col]);
          out[(static_cast<size_t>(b) * m_total + m) * c_out + c0 + col] = v;
        }
        // (the next pass writes wmax only after its slabs' barriers)
      }
    }
    src = dst;
  }
  cp_async_wait<0>();
}

// What sa_kernel needs before it starts, in one launch. The first blocks compute
// layer 0 ahead of the gather: Z[b, j] = [xyz / r | feats][b, j] @ W1 over the
// source points and O[b, m] = b1 - (center / r)[b, m] @ W1_xyz per center, in
// full float32 on the CUDA cores (the xyz terms of Z[j] + O[m] cancel down to
// the offset, which a TF32 product would lose): tiles of 32 rows x 32 columns,
// 2 x 2 outputs a thread, K in steps of 16 through shared memory, the next
// step's values loading while this one multiplies. The products are small (a
// few hundred tiles), so a tile's chain of K-steps is the kernel's time: small
// tiles keep it short. The last n_slabs blocks (blockIdx.y = 0) split the tail weights
// (prep_slab). Its first instruction lets sa_kernel, launched behind it with
// programmatic stream serialization, start its ball query meanwhile.
constexpr int kL0Tile = 32;
constexpr int kL0K = 16;
constexpr int kL0Out = 2;  // outputs a thread per row and per column: 16 x 16 threads

__global__ void __launch_bounds__(256)
sa_pre_kernel(const float* __restrict__ xyz, const float* __restrict__ ctr,
              const float* __restrict__ feats, const float* __restrict__ w1,
              const float* __restrict__ b1, float* __restrict__ z, float* __restrict__ off,
              int z_rows, int o_rows, int c_feat, int h, float r, int use_xyz,
              const Tail tail, float* __restrict__ wprep, int n_slabs) {
  __shared__ float a_s[kL0K][kL0Tile + 1];
  __shared__ float b_s[kL0K][kL0Tile];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int z_blocks = (z_rows + kL0Tile - 1) / kL0Tile;
  const int l0_blocks = z_blocks + (o_rows + kL0Tile - 1) / kL0Tile;
  if (static_cast<int>(blockIdx.x) >= l0_blocks) {
    if (blockIdx.y == 0) prep_slab(tail, blockIdx.x - l0_blocks, wprep);
    return;
  }
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool is_z = static_cast<int>(blockIdx.x) < z_blocks;
  const int r0 = (is_z ? blockIdx.x : blockIdx.x - z_blocks) * kL0Tile;
  const int n_rows = is_z ? z_rows : o_rows;
  const int col0 = blockIdx.y * kL0Tile + tx * kL0Out;
  float acc[kL0Out][kL0Out];
#pragma unroll
  for (int i = 0; i < kL0Out; ++i)
#pragma unroll
    for (int j = 0; j < kL0Out; ++j) acc[i][j] = 0.0f;

  if (use_xyz) {
    const float* p3 = is_z ? xyz : ctr;
    float wx[3][kL0Out];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < kL0Out; ++j) wx[k][j] = col0 + j < h ? __fdiv_rn(w1[k * h + col0 + j], r) : 0.0f;
#pragma unroll
    for (int i = 0; i < kL0Out; ++i) {
      const int row = r0 + ty * kL0Out + i;
      if (row >= n_rows) continue;
      const float x = p3[static_cast<size_t>(row) * 3], y = p3[static_cast<size_t>(row) * 3 + 1],
                  zc = p3[static_cast<size_t>(row) * 3 + 2];
#pragma unroll
      for (int j = 0; j < kL0Out; ++j) acc[i][j] = x * wx[0][j] + y * wx[1][j] + zc * wx[2][j];
    }
  }
  if (is_z && c_feat > 0) {
    const float* wf = w1 + (use_xyz ? 3 : 0) * h;
    constexpr int kFetch = kL0K * kL0Tile / 256;  // values of each operand a thread moves per step
    float a_next[kFetch], b_next[kFetch];
    const auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < kFetch; ++q) {
        const int e = threadIdx.x + 256 * q;
        const int row = r0 + e / kL0K, k = k0 + e % kL0K;
        a_next[q] = row < n_rows && k < c_feat ? feats[static_cast<size_t>(row) * c_feat + k] : 0.0f;
        const int kb = k0 + e / kL0Tile, col = blockIdx.y * kL0Tile + e % kL0Tile;
        b_next[q] = kb < c_feat && col < h ? wf[static_cast<size_t>(kb) * h + col] : 0.0f;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < c_feat; k0 += kL0K) {
#pragma unroll
      for (int q = 0; q < kFetch; ++q) {
        const int e = threadIdx.x + 256 * q;
        a_s[e % kL0K][e / kL0K] = a_next[q];
        b_s[e / kL0Tile][e % kL0Tile] = b_next[q];
      }
      __syncthreads();
      if (k0 + kL0K < c_feat) fetch(k0 + kL0K);
#pragma unroll
      for (int k = 0; k < kL0K; ++k) {
        float a[kL0Out], bv[kL0Out];
#pragma unroll
        for (int i = 0; i < kL0Out; ++i) a[i] = a_s[k][ty * kL0Out + i];
#pragma unroll
        for (int j = 0; j < kL0Out; ++j) bv[j] = b_s[k][tx * kL0Out + j];
#pragma unroll
        for (int i = 0; i < kL0Out; ++i)
#pragma unroll
          for (int j = 0; j < kL0Out; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* dst = is_z ? z : off;
#pragma unroll
  for (int i = 0; i < kL0Out; ++i) {
    const int row = r0 + ty * kL0Out + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < kL0Out; ++j) {
      const int col = col0 + j;
      if (col >= h) continue;
      dst[static_cast<size_t>(row) * h + col] = is_z ? acc[i][j] : b1[col] - acc[i][j];
    }
  }
}

// Shared memory of a block of kWarpGroups * 64 rows, and the launch itself.
struct Plan {
  int width, n_slabs, two_bufs;
};

// the first activation buffer: the block's rows, or the cloud of n points if larger
template <int kWarpGroups>
int buf0_floats(const Plan& plan, int n) {
  const int rows = kWarpGroups * 64 * (plan.width + kActPad);
  const int cloud = (3 * n + kBufAlign - 1) / kBufAlign * kBufAlign;
  return rows > cloud ? rows : cloud;
}

template <int kWarpGroups>
size_t smem_bytes(const Plan& plan, int ns, int n) {
  constexpr int kRows = kWarpGroups * 64;
  constexpr int kWarps = kWarpGroups * 4;
  const int lists = ptt::block_query_lists(kRows / ns, kWarps);
  const size_t bufs = buf0_floats<kWarpGroups>(plan, n) + (plan.two_bufs ? kRows * (plan.width + kActPad) : 0);
  return (bufs + kStages * kSlabFloats + kWarps * kPassCols + 2 * kRows + static_cast<size_t>(lists) * ns) *
         sizeof(float);
}

template <int kWarpGroups>
cudaError_t launch(const Plan& plan, const float* xyz, const float* ctr, const float* z, const float* off,
                   const Tail& tail, const float* wprep, float* out, int* idx_out, int batch, int n,
                   int m_total, int ns, float r2, cudaStream_t stream) {
  const size_t smem = smem_bytes<kWarpGroups>(plan, ns, n);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sa_kernel<kWarpGroups>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int tm = kWarpGroups * 64 / ns;
  const dim3 grid((m_total + tm - 1) / tm, batch);
  // may start while sa_pre_kernel, the launch before it on the stream, still
  // runs; the kernel waits for it where it first needs its results
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kWarpGroups * 128);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, sa_kernel<kWarpGroups>, xyz, ctr, z, off, tail, wprep, plan.n_slabs, out,
                            idx_out, n, m_total, ns, tm, plan.width, plan.two_bufs,
                            buf0_floats<kWarpGroups>(plan, n), r2);
}

int total_slabs(int n_tail, const int* widths) {
  int slabs = 0;
  for (int l = 0; l < n_tail; ++l) slabs += layer_slabs(widths[l], widths[l + 1]);
  return slabs;
}

Plan make_plan(int n_tail, const int* widths) {
  Plan plan;
  plan.n_slabs = total_slabs(n_tail, widths);
  // activations kept in shared memory: layer 0 and every tail layer but the last
  plan.width = widths[0];
  plan.two_bufs = 0;
  for (int l = 1; l < n_tail; ++l) {
    plan.width = widths[l] > plan.width ? widths[l] : plan.width;
    plan.two_bufs |= widths[l] > kPassCols;
  }
  return plan;
}

}  // namespace

// Floats of sa_forward's `wprep` scratch for tail layers of these widths.
extern "C" int sa_prep_floats(int n_tail, const int* widths) { return total_slabs(n_tail, widths) * kSlabFloats; }

// Shared memory in bytes of a 64-row block (the smallest) for a call with a
// cloud of n points, ns slots and these widths (as sa_forward takes them);
// sa_forward refuses a call for which it exceeds 227 KB.
extern "C" int sa_smem_bytes(int n, int ns, int n_tail, const int* widths) {
  return static_cast<int>(smem_bytes<1>(make_plan(n_tail, widths), ns, n));
}

// xyz (B, N, 3), ctr (B, M, 3), feats (B, N, c_feat) or null, out (B, M, C_out),
// all float32 and contiguous on the device. w1 ((3 if use_xyz) + c_feat, h1) and
// b1 (h1,) are layer 0 with BatchNorm folded, r the radius its xyz rows are
// divided by (1 when they are not normalised). z (B, N, widths[0]) and off
// (B, M, widths[0]) are scratch for layer 0 over the points and the centers,
// wprep (sa_prep_floats floats) for the split tail weights. w[l] (widths[l],
// widths[l + 1]) and b[l] (widths[l + 1],) are device pointers held in host
// arrays of n_tail >= 1 entries; widths[0] = h1, every width is a multiple of
// 8, ns is 16, 32 or 64, n is a multiple of 4 and a 64-row block with its cloud
// fits in shared memory (smem_bytes<1>); any other call is refused with
// cudaErrorInvalidValue. xyz, z, off, out and wprep are 16-byte
// aligned. idx_out (B, M, ns) int32 receives the neighbour table when it is
// not null. Launches two kernels on `stream`; returns the cudaError_t of the
// launches (0 = ok).
extern "C" int sa_forward(const float* xyz, const float* ctr, const float* feats, int c_feat,
                          const float* w1, const float* b1, int h1, float r, int use_xyz, float* z,
                          float* off, float* wprep, int n_tail, const float* const* w,
                          const float* const* b, const int* widths, float* out, int* idx_out,
                          int batch, int n, int m_total, int ns, float r2, void* stream) {
  if (batch < 1 || n < 1 || n % 4 != 0 || m_total < 1 || (ns != 16 && ns != 32 && ns != 64) || n_tail < 1 ||
      n_tail > kMaxTail || h1 != widths[0] || c_feat < 0 || (c_feat > 0) != (feats != nullptr) ||
      (!use_xyz && c_feat == 0) || reinterpret_cast<uintptr_t>(xyz) % 16 != 0) {
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
  for (int l = 0; l <= n_tail; ++l) {
    if (widths[l] < 8 || widths[l] % 8 != 0) return cudaErrorInvalidValue;
  }
  const Plan plan = make_plan(n_tail, widths);
  if (smem_bytes<1>(plan, ns, n) > kMaxSmem) return cudaErrorInvalidValue;  // no block takes the cloud
  const auto st = static_cast<cudaStream_t>(stream);
  const int z_rows = batch * n, o_rows = batch * m_total;
  const dim3 pre_grid((z_rows + kL0Tile - 1) / kL0Tile + (o_rows + kL0Tile - 1) / kL0Tile + plan.n_slabs,
                      (widths[0] + kL0Tile - 1) / kL0Tile);
  sa_pre_kernel<<<pre_grid, 256, 0, st>>>(xyz, ctr, feats, w1, b1, z, off, z_rows, o_rows, c_feat, h1,
                                         r, use_xyz, tail, wprep, plan.n_slabs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Every block streams all weights from L2, which bounds the kernel once the
  // arithmetic is on the tensor cores: the largest block that fits in shared
  // memory and still gives three quarters of the SMs a block.
  int sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return cudaErrorUnknown;
  }
  const long long block_rows = static_cast<long long>(batch) * m_total * ns;
  if (smem_bytes<4>(plan, ns, n) <= kMaxSmem && 4 * block_rows >= 3LL * sms * 256) {
    return launch<4>(plan, xyz, ctr, z, off, tail, wprep, out, idx_out, batch, n, m_total, ns, r2, st);
  }
  if (smem_bytes<2>(plan, ns, n) <= kMaxSmem && 4 * block_rows >= 3LL * sms * 128) {
    return launch<2>(plan, xyz, ctr, z, off, tail, wprep, out, idx_out, batch, n, m_total, ns, r2, st);
  }
  return launch<1>(plan, xyz, ctr, z, off, tail, wprep, out, idx_out, batch, n, m_total, ns, r2, st);
}
