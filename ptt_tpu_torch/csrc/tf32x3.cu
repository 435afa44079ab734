// Float32 linear layer on the tensor cores at float32 accuracy (sm_90a):
// out = relu?((a @ w^T) * scale + shift), scale and shift per output column.
//
// Replaces no TPU kernel. The JAX package leaves these matrix products to XLA
// (jnp.dot in its Dense layers); on the card they went to cuBLAS's float32
// GEMM on the CUDA cores, capped at 67 TFLOP/s. The tracker's eval forward
// makes eight large ones a frame step (the transformer blocks' fc_delta.2,
// fc_gamma.0 and fc_gamma.2 at 16384 and 8192 x 512 x 512, the similarity
// MLP's layers 1-2 at 65536 x 256 x 256), and each is followed by a bias, or
// by eval BatchNorm and a ReLU, which here happen in the product's epilogue.
//
// What bounds it: operations. The product is csrc/sa.cu's three-pass TF32
// split, lo*hi + hi*lo + hi*hi (x = hi + lo, split_tf32 below), the small
// terms first: float32 accuracy at a third of dense TF32's 495 TFLOP/s, 165.
// At 512 x 512 a row costs 2 K N = 524,288 operations against 4 KB read and
// written, 128 a byte, above the card's ridge of 165 / 3.35 = 49 a byte; at
// 256 x 256, 64 a byte: the 65536-row calls are near the ridge (38 us of
// bytes against 52 us of operations). What the design does about it:
//
//  * Two launches. tf32x3_split_kernel splits the weight, per call and on the
//    device (weights loaded in place show in the next replay of a captured
//    graph; there is no host cache), into hi and lo tiles of 32 (k) x 128 (n)
//    in the unswizzled K-major core-matrix layout wgmma reads B from (sa.cu's
//    slabs: 8 n x 4 k values of 128 bytes, k fastest), and computes scale and
//    shift: 1 and the bias, or gamma / sqrt(var + eps) and beta - mean * scale
//    of eval BatchNorm. tf32x3_gemm_kernel is launched behind it with
//    programmatic stream serialization and waits (griddepcontrol.wait) before
//    it reads them.
//  * A persistent block per SM walks output tiles of 128 rows x 128 columns,
//    columns fastest, so that blocks running together share rows of `a` in
//    L2. One thread of a producer warp keeps a ring of 4 stages full, each a
//    32 KB hi/lo slab (bulk copies) and a 128 x 32 tile of `a` (one TMA
//    tensor copy, 128-byte swizzle, rows past M as zeros), counted on an
//    mbarrier. (A row a copy, 128 small bulk copies a stage, ran 2.4x slower;
//    cp.async by the producer warp 1.3x: the copies of `a` were the limit.)
//  * Two consumer warpgroups of 64 rows each. A warp loads its 16 rows of the
//    stage's four K-steps from shared memory, conflict-free through the
//    swizzle, and splits them in registers (A from registers: nothing split
//    is stored), then issues the stage's 12 wgmma.m64n128k8.tf32 in one
//    group and hands the stage back (an mbarrier arrive per warp) once they
//    are done. The tensor cores accumulate each stage into its own registers
//    from zero, and the CUDA cores add that into the tile's sum, rounding to
//    nearest: the tensor cores' float32 accumulation rounds toward zero, and
//    over K = 512 in one chain its error grew to 3.6e-6 of the product
//    (8.9x cuBLAS float32's); a stage of 32 at a time reads 2.6e-7 (cuBLAS
//    4.1e-7).
//  * The epilogue applies relu?(acc * scale + shift) (not fused: the same
//    roundings as the plain version) and stores 16 bytes a thread: a thread
//    and its neighbour swap half their fragment, so that each holds four
//    consecutive columns of one row.
//
// Shapes: K a multiple of 32, N a multiple of 128, M >= 1 (rows past M read
// as zeros and are not stored), all pointers 16-byte aligned; the entry point
// refuses any other call, as ops/linear.py does before it.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudaGetDriverEntryPoint, no libcuda link
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpGroups = 2;
constexpr int kBM = 64 * kWarpGroups;                // rows of an output tile
constexpr int kBN = 128;                             // columns of an output tile: the N of one wgmma
constexpr int kBK = 32;                              // K of a stage: 4 wgmma K-steps of 8
constexpr int kStages = 4;
constexpr int kTileFloats = kBK * kBN;               // a hi or lo tile of a slab, 16 KB
constexpr int kSlabFloats = 2 * kTileFloats;         // hi tile, then lo tile
constexpr int kStageFloats = kSlabFloats + kBM * kBK;   // slab, then the tile of `a`: both 1 KB aligned
constexpr int kSlabCopies = 4;                       // bulk copies of 8 KB a slab
constexpr int kConsumers = 128 * kWarpGroups;
constexpr int kThreads = kConsumers + 32;            // and one producer warp
constexpr size_t kSmemBytes = static_cast<size_t>(kStages) * kStageFloats * 4 + 2 * kStages * sizeof(uint64_t);
constexpr int kCoreBytesN = 128;                     // core matrices next to each other in n
constexpr int kCoreBytesK = 16 * kCoreBytesN;        // ... and in k
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kStageBytes = kStageFloats * 4;   // what lands in a stage, rows past M as zeros
static_assert(kStageBytes % 1024 == 0 && kSlabFloats * 4 % 1024 == 0, "the swizzled tile of `a` needs 1 KB alignment");
static_assert(kBK * 4 == 128, "a row of the tile of `a` is one 128-byte swizzle span");

// x = hi + lo, both exact in TF32's 10-bit mantissa up to the masked bits of lo
// (csrc/sa.cu's rule: Veltkamp's splitting, hi rounded to nearest)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float c = __fmul_rn(x, 8193.0f);  // 2^13 + 1
  const float h = __fsub_rn(c, __fsub_rn(c, x));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h)) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete. A wait that never ends traps,
// so that a fault shows as a failed launch and not as a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 28)) __trap();
  }
}

// the box of `map` at (c0, c1) (innermost coordinate first) to dst, counted on `bar` as it lands
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// bytes (a multiple of 16) from src to dst, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// wgmma: the descriptor of a K-major, unswizzled B operand of 8 (k) x 128 (n)
// TF32 values at `tile`: start address, the byte offsets between core matrices
// along k (leading) and along n (stride), each in units of 16 bytes.
__device__ __forceinline__ uint64_t b_descriptor(const float* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4) | (static_cast<uint64_t>(kCoreBytesK >> 4) << 16) |
         (static_cast<uint64_t>(kCoreBytesN >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x 128 of the warpgroup, 64 registers a thread) = a (64 x 8, registers)
// * b (8 x 128, shared memory) + (add ? d : 0), TF32 operands, float32
// accumulate, asynchronous
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b_desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(add));
}

// The split A fragment of K-step st: rows g and g + 8 of the warp's 16 (`row`
// is row g's start), columns 8 st + t4 and + 4. The TMA wrote the tile with
// the 128-byte swizzle, 16-byte chunk c of row r at chunk c ^ (r % 8), and
// r % 8 = g: so the 8 rows of a load meet 8 distinct chunks, all 32 banks.
__device__ __forceinline__ void load_a(const float* row, int g, int t4, int st, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* c0 = row + (((2 * st) ^ g) << 2) + t4;
  const float* c1 = row + (((2 * st + 1) ^ g) << 2) + t4;
  split_tf32(c0[0], hi[0], lo[0]);
  split_tf32(c0[8 * kBK], hi[1], lo[1]);
  split_tf32(c1[0], hi[2], lo[2]);
  split_tf32(c1[8 * kBK], hi[3], lo[3]);
}

// A block of 256 threads per 32 (k) x 32 (n) part of a slab (blockIdx.x: the
// K-slab, blockIdx.y: 32 columns). w is the layer's (n, k) row-major weight:
// the block reads it a column's 32 k at a time into shared memory, then
// writes each group of 4 k, where its 32 columns are 128 consecutive floats
// of the slab (column c at 4 c + k % 4), split. Slabs are stored column tile
// by column tile, K-slabs in order. The first K-slab's blocks also write
// their columns' scale and shift (affine[0:n] and affine[n:2n]).
constexpr int kSplitN = 32;

__global__ void __launch_bounds__(256)
tf32x3_split_kernel(const float* __restrict__ w, const float* __restrict__ bias, const float* __restrict__ bn_w,
                    const float* __restrict__ bn_b, const float* __restrict__ bn_mean,
                    const float* __restrict__ bn_var, float eps, float* __restrict__ wprep,
                    float* __restrict__ affine, int k, int n) {
  __shared__ float part[kSplitN][kBK + 1];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int kt = blockIdx.x, c0 = blockIdx.y * kSplitN;
  for (int e = threadIdx.x; e < kSplitN * kBK; e += 256) {
    part[e / kBK][e % kBK] = __ldg(w + static_cast<size_t>(c0 + e / kBK) * k + kt * kBK + e % kBK);
  }
  __syncthreads();
  float* hi_tile = wprep + (static_cast<size_t>(c0 / kBN) * gridDim.x + kt) * kSlabFloats + 4 * (c0 % kBN);
  for (int e = threadIdx.x; e < kSplitN * kBK; e += 256) {
    const int kg = e / (4 * kSplitN), q = e % (4 * kSplitN);  // group of 4 k; 4 x column + k % 4
    uint32_t hi, lo;
    split_tf32(part[q / 4][4 * kg + q % 4], hi, lo);
    const int at = kg * (kCoreBytesK / 4) + q;
    hi_tile[at] = __uint_as_float(hi);
    hi_tile[kTileFloats + at] = __uint_as_float(lo);
  }
  if (kt == 0 && threadIdx.x < kSplitN) {
    const int c = c0 + threadIdx.x;
    float scale = 1.0f, shift = bias != nullptr ? bias[c] : 0.0f;
    if (bn_w != nullptr) {
      scale = __fdiv_rn(bn_w[c], __fsqrt_rn(__fadd_rn(bn_var[c], eps)));
      shift = __fsub_rn(bn_b[c], __fmul_rn(bn_mean[c], scale));
    }
    affine[c] = scale;
    affine[n + c] = shift;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap a_map, const float* __restrict__ wprep,
                   const float* __restrict__ affine, float* __restrict__ out, int m, int k, int n, int relu) {
  extern __shared__ __align__(1024) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageFloats);  // a stage has landed
  uint64_t* empty = full + kStages;                                             // ... and is free again
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // wprep and affine are tf32x3_split_kernel's, launched just before
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int k_slabs = k / kBK;
  const int n_ct = n / kBN;
  const int n_tiles = (m + kBM - 1) / kBM * n_ct;

  if (warp == kConsumers / 32) {  // the producer warp: one lane issues every copy
    if (lane != 0) return;
    int it = 0;  // stages filled so far, over every tile of this block
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int row0 = tile / n_ct * kBM;
      const int ct = tile % n_ct;
      for (int kt = 0; kt < k_slabs; ++kt, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        float* stage = smem + s * kStageFloats;
        mbar_expect_tx(&full[s], kStageBytes);
        const float* slab = wprep + (static_cast<size_t>(ct) * k_slabs + kt) * kSlabFloats;
        constexpr int kChunk = kSlabFloats / kSlabCopies;
        for (int q = 0; q < kSlabCopies; ++q) bulk_copy(stage + q * kChunk, slab + q * kChunk, kChunk * 4, &full[s]);
        tma_load_2d(stage + kSlabFloats, &a_map, kt * kBK, row0, &full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of the tile, warp w
  // of it 16 of those; a thread rows r and r + 8, columns 8 j + 2 t4 and + 1
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = 64 * (warp >> 2) + 16 * (warp & 3) + g;
  const bool odd = t4 & 1;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile / n_ct * kBM;
    const int ct = tile % n_ct;
    float acc[64];   // the tile's sum: each stage's part added on the CUDA cores
    float part[64];  // one stage's sum, on the tensor cores
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    for (int kt = 0; kt < k_slabs; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const float* hi_tile = smem + s * kStageFloats;
      const float* lo_tile = hi_tile + kTileFloats;
      const float* ap = hi_tile + kSlabFloats + r * kBK;
      uint32_t a_hi[kBK / 8][4], a_lo[kBK / 8][4];  // the stage's four K-steps, split
#pragma unroll
      for (int st = 0; st < kBK / 8; ++st) load_a(ap, g, t4, st, a_hi[st], a_lo[st]);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kBK / 8; ++st) {
        const uint64_t b_hi = b_descriptor(hi_tile + st * (2 * kCoreBytesK / 4));
        const uint64_t b_lo = b_descriptor(lo_tile + st * (2 * kCoreBytesK / 4));
        wgmma_tf32(part, a_lo[st], b_hi, st > 0);  // small terms first
        wgmma_tf32(part, a_hi[st], b_lo, 1);
        wgmma_tf32(part, a_hi[st], b_hi, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // the stage's products are done: its buffers are free
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }

    // epilogue: the even thread of a pair stores row r, the odd one row r + 8,
    // each four consecutive columns
    const int row = row0 + r + (odd ? 8 : 0);
    const float* scale = affine + ct * kBN;
    const float* shift = affine + n + ct * kBN;
    float* dst = out + static_cast<size_t>(row) * n + ct * kBN;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float give0 = odd ? acc[4 * j] : acc[4 * j + 2];
      const float give1 = odd ? acc[4 * j + 1] : acc[4 * j + 3];
      const float got0 = __shfl_xor_sync(kFullMask, give0, 1);
      const float got1 = __shfl_xor_sync(kFullMask, give1, 1);
      const int col = 8 * j + 2 * (t4 & 2);
      float v[4] = {odd ? got0 : acc[4 * j], odd ? got1 : acc[4 * j + 1], odd ? acc[4 * j + 2] : got0,
                    odd ? acc[4 * j + 3] : got1};
      const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + col));
      const float4 sh = __ldg(reinterpret_cast<const float4*>(shift + col));
      v[0] = __fadd_rn(__fmul_rn(v[0], sc.x), sh.x);
      v[1] = __fadd_rn(__fmul_rn(v[1], sc.y), sh.y);
      v[2] = __fadd_rn(__fmul_rn(v[2], sc.z), sh.z);
      v[3] = __fadd_rn(__fmul_rn(v[3], sc.w), sh.w);
      if (relu) {  // as torch.relu: a NaN stays NaN
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = v[q] < 0.0f ? 0.0f : v[q];
      }
      if (row < m) *reinterpret_cast<float4*>(dst + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The tensor map of `a` (m, k) row-major for tf32x3_gemm_kernel: boxes of kBM
// rows x kBK values, 128-byte swizzle, rows past m read as zeros.
cudaError_t map_rows(CUtensorMap* map, const float* a, int m, int k) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return cudaErrorUnknown;
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * sizeof(float)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a), dims, strides, box, steps,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Floats of tf32x3_linear's `wprep` scratch for a (k, n) weight.
extern "C" int tf32x3_prep_floats(int k, int n) { return (k / kBK) * (n / kBN) * kSlabFloats; }

// a (m, k) and out (m, n) row-major, w (n, k) row-major (torch.nn.Linear's
// layout), all float32 and contiguous on the device. Either bias (n,) or the
// four eval BatchNorm vectors bn_w, bn_b, bn_mean, bn_var (n,) with eps, or
// neither. wprep (tf32x3_prep_floats floats) and affine (2 n floats) are
// scratch. k is a multiple of 32 and n of 128, every pointer 16-byte aligned;
// any other call is refused with cudaErrorInvalidValue. relu != 0 applies a
// ReLU last. Launches two kernels on `stream`; returns the cudaError_t of the
// launches (0 = ok).
extern "C" int tf32x3_linear(const float* a, const float* w, const float* bias, const float* bn_w,
                             const float* bn_b, const float* bn_mean, const float* bn_var, float eps, float* wprep,
                             float* affine, float* out, int m, int k, int n, int relu, void* stream) {
  const bool bn = bn_w != nullptr;
  if (m < 1 || k < kBK || k % kBK != 0 || n < kBN || n % kBN != 0 || (bn && bias != nullptr) ||
      bn != (bn_b != nullptr) || bn != (bn_mean != nullptr) || bn != (bn_var != nullptr) || !aligned16(a) ||
      !aligned16(w) || !aligned16(wprep) || !aligned16(affine) || !aligned16(out)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap a_map;
  cudaError_t err = map_rows(&a_map, a, m, k);
  if (err != cudaSuccess) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  tf32x3_split_kernel<<<dim3(k / kBK, n / kSplitN), 256, 0, st>>>(w, bias, bn_w, bn_b, bn_mean, bn_var, eps, wprep,
                                                              affine, k, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tf32x3_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  int sms = 0, dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return cudaErrorUnknown;
  }
  const int tiles = (m + kBM - 1) / kBM * (n / kBN);
  // may start while the split kernel still runs; it waits for it before reading its outputs
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles < sms ? tiles : sms);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = kSmemBytes;
  config.stream = st;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, tf32x3_gemm_kernel, a_map, static_cast<const float*>(wprep),
                            static_cast<const float*>(affine), out, m, k, n, relu);
}
