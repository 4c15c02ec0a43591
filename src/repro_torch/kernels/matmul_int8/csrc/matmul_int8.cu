// W8A8 GEMM for Hopper (sm_90a): out = (x_q @ w_q) * x_scale[:, None] * w_scale[None, :]
// x_q (M, K) and w_q (K, N) row-major int8, f32 scales, f32 or bf16 out.
//
// Replaces the TPU kernel src/repro/kernels/matmul_int8/kernel.py:
// _matmul_kernel / matmul_int8 (Pallas grid (M/bm, N/bn, K/bk) with an int32
// VMEM accumulator carried across the sequential K grid axis).
//
// What bounds it on an H100: at the executor's decode shapes (M = 128
// tokens against K x N weights of 1 MB to 620 MB) every weight byte is used
// by only M = 128 rows, about 256 int8 operations per byte, under the ~590
// per byte at which the int8 tensor cores (1,979 TOP/s) become the limit:
// those GEMMs are bound by reading w_q once. The prefill GEMMs (M = 32,768)
// do thousands of operations per byte and are bound by the tensor cores.
//
// Design:
//   * the (BM, BN, BK) the MIP's mapping chose (via core/gpu_bridge.py) is
//     the CTA's output tile and its K step; a loop over K in BK steps
//     replaces the TPU's sequential K grid axis;
//   * int8 tensor cores: mma.sync m16n8k32 (s8 x s8 -> s32) serves every
//     tile of the set, bm 16 and 32 included. The warps tile (BM, BN) with
//     a (BM / kWarpsM) x 32 output block each, int32 accumulators in
//     registers; at most 128 registers a thread, so two 256-thread CTAs
//     share an SM (at 128^3 each holds 96 KB of shared memory);
//   * a ring of kStages = 3 shared-memory stages filled by 16-byte
//     cp.async.cg, so two K steps are in flight while the tensor cores work
//     on the third. A chunk past M, N or K is zero-filled by the copy itself
//     (src-size 0), adding 0 to the int32 sums; no padding anywhere. When an
//     operand's rows are not 16-byte aligned (base pointer or row length),
//     the same kernel loads it byte by byte, masked, into the same stage;
//   * x tiles reach the A fragments with ldmatrix.x4 (one row of 16 k per
//     lane quad, exactly the m16n8k32 A layout at 8 bits);
//   * w is stored (K, N), N-major, but the B fragment wants 4 consecutive k
//     of one column per 32-bit word. A lane reads four words (4 columns)
//     from 4 consecutive k rows and transposes the 4 x 4 bytes with 8
//     __byte_perm, giving one B word for each of 4 n8 tiles. The 32
//     columns of a warp are thus dealt to its 4 n8 tiles as column c ->
//     tile c % 4, position c / 4, which the epilogue undoes: lane quad t
//     ends up holding 8 consecutive columns 8t .. 8t+7 of its rows;
//   * shared memory is XOR-swizzled in 16-byte chunks, no padding (SwzX,
//     SwzW below): ldmatrix's 8 rows hit 8 distinct chunks of a 128-byte
//     line, and the 4 k rows 4 apart that a warp reads at once hit 4
//     distinct chunk pairs. Both are conflict-free for BK, BN in
//     {32, 64, 128}, and so are the cp.async writes (a line's chunks are
//     only permuted). Each lane's fragment addresses are a few bases plus
//     compile-time offsets;
//   * exact split-K when ceil(M/BM) * ceil(N/BN) tiles leave SMs idle: the
//     K steps are dealt to gridDim.z CTAs per tile (split count from
//     kernel.py: split_k). Each stores its int32 partial tile with plain
//     16-byte stores into its own slot of an int32 workspace the wrapper
//     allocates; a second kernel, launched by the same entry point as a
//     programmatic dependent (scheduled while the GEMM runs), sums the
//     slots in split order and runs the GEMM's own epilogue (store_row)
//     over the whole card.
//     Integer sums are exact, so the result is bit-equal to the unsplit
//     one and deterministic. (int32
//     atomics into one zeroed sum, tried first, were slower at path A's
//     shapes than the GEMM they reduced: the L2 takes them one element at
//     a time; a last CTA summing the slots alone would pull
//     (split - 1) x 64 KB through one SM);
//   * the epilogue multiplies (float(acc) * x_scale[m]) * w_scale[n] in the
//     plain version's order, with round-to-nearest and no contraction, and
//     stores float32 or bfloat16, vectorised where the row allows.
// wgmma (m64nNk32, both operands K-major at 8 bits) is left for the
// compute-bound prefill GEMMs; it cannot serve bm 16 or 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;  // kernel.py: STAGES

// Warps per CTA: BN / 32 along N, up to 8 in all, at least 32 rows each
// where BM allows.
template <int BM, int BN>
struct Layout {
  static constexpr int kWarpsN = BN / 32;
  static constexpr int kWarpsM = BM / 32 < 1 ? 1
                                 : (BM / 32 > 8 / kWarpsN ? 8 / kWarpsN : BM / 32);
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kWM = BM / kWarpsM;  // rows per warp: 16, 32 or 64
  static constexpr int kMT = kWM / 16;      // m16 tiles per warp
};

template <int BM, int BN, int BK>
constexpr int smem_bytes() { return kStages * (BM * BK + BK * BN); }

// Byte offset of 16-byte chunk c of row r in an x tile of CPR chunks per
// row: chunks are XOR-swizzled within their row by (line & (CPR - 1)),
// `line` the 128-byte line of the unswizzled chunk. The 8 rows an
// ldmatrix phase reads land on 8 distinct chunks of a line, and rows 16
// apart keep the same pattern, so an m16 tile further on is a constant
// 16 * BK bytes away.
template <int CPR>
struct SwzX {
  static __device__ __forceinline__ int at(int r, int c) {
    const int l = r * CPR + c;
    return ((l >> 3) << 7) | (((l & 7) ^ ((l >> 3) & (CPR - 1))) << 4);
  }
};

// The same for w tiles ([k][n], CPR chunks along n), swizzled by
// 2 * ((k / 4) % 4): the 4 k rows 4 apart that a warp reads at once land
// on 4 distinct chunk pairs, and k rows 16 apart keep the same pattern.
template <int CPR>
struct SwzW {
  static __device__ __forceinline__ int at(int k, int c) {
    const int l = k * CPR + c;
    return ((l >> 3) << 7) | (((l & 7) ^ ((k >> 1) & 6)) << 4);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of row `row` from column `col` on, bytes past `len` (or a row
// past `rows`) zero: the masked synchronous load of unaligned operands.
__device__ __forceinline__ uint4 load16_masked(const int8_t* p, int row,
                                               int rows, int col, int len) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  if (row < rows) {
    const int8_t* src = p + (size_t)row * len;
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (col + e < len)
        v[e >> 2] |= uint32_t(uint8_t(src[col + e])) << (8 * (e & 3));
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One operand tile of one K step into shared memory: ROWS rows of CPR
// 16-byte chunks, row r and chunk c from p[(r0 + r) * ld + c0 + 16 c],
// masked at (rows, len); Swz places a chunk. Thread tid always takes chunk
// column tid % CPR, of rows tid / CPR + i * (NT / CPR). Aligned rows take
// unrolled cp.async copies (len % 16 == 0, so a chunk is all in or all
// out), the rest a rolled loop of masked loads, kept out of the hot path.
template <int ROWS, int CPR, int NT, class Swz>
__device__ __forceinline__ void load_tile(uint8_t* dst, const int8_t* p,
                                          int r0, int rows, int c0, int len,
                                          bool vec, int tid) {
  constexpr int kStep = NT / CPR;  // rows per pass
  constexpr int kPasses = (ROWS + kStep - 1) / kStep;
  const int r = tid / CPR, cc = tid % CPR;
  const int gc = c0 + 16 * cc;
  if (vec) {
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const bool col_in = gc < len;
    const int8_t* src = p + (size_t)(r0 + r) * len + gc;
    const size_t step = (size_t)kStep * len;
#pragma unroll
    for (int i = 0; i < kPasses; ++i, src += step) {
      if (kPasses * kStep > ROWS && r + i * kStep >= ROWS) break;
      const bool in = col_in && r0 + r + i * kStep < rows;
      cp_async16(base + Swz::at(r + i * kStep, cc), in ? src : p, in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = r; i < ROWS; i += kStep)
      *reinterpret_cast<uint4*>(dst + Swz::at(i, cc)) =
          load16_masked(p, r0 + i, rows, gc, len);
  }
}

// One K step into one stage: the x tile [BM][BK] and the w tile [BK][BN].
template <int BM, int BN, int BK, int NT>
__device__ __forceinline__ void load_stage(uint8_t* sa, uint8_t* sb,
                                           const int8_t* x, const int8_t* w,
                                           int M, int N, int K, int m0, int n0,
                                           int k0, bool x_vec, bool w_vec,
                                           int tid) {
  load_tile<BM, BK / 16, NT, SwzX<BK / 16>>(sa, x, m0, M, k0, K, x_vec, tid);
  load_tile<BK, BN / 16, NT, SwzW<BN / 16>>(sb, w, k0, K, n0, N, w_vec, tid);
}

// 4 x 4 byte transpose: out[e] = {v0.byte e, v1.byte e, v2.byte e, v3.byte e}.
__device__ __forceinline__ void transpose4x4(const uint32_t (&v)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
  const uint32_t t1 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t t2 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// The epilogue of one row: W (8 or 4) int32 sums at columns gn .. gn+W-1,
// scaled and stored in the plain version's order. The GEMM stores 8 per
// lane, the split-K reduce pass 4 per thread.
template <int W>
__device__ __forceinline__ void store_row(const int (&v)[W], int gm, int gn,
                                          int N, float sx,
                                          const float* __restrict__ ws,
                                          void* __restrict__ out, int out_bf16,
                                          bool out_vec) {
  static_assert(W == 4 || W == 8, "a row segment is 4 or 8 columns");
  float f[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    f[j] = gn + j < N ? __fmul_rn(__fmul_rn(__int2float_rn(v[j]), sx), ws[gn + j])
                      : 0.f;
  const size_t base = (size_t)gm * N + gn;
  const bool full = out_vec && gn + W <= N;
  if (out_bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + base;
    if (full) {
      uint32_t p[W / 2];
#pragma unroll
      for (int j = 0; j < W / 2; ++j) {
        const __nv_bfloat162 h =
            __halves2bfloat162(__float2bfloat16_rn(f[2 * j]),
                               __float2bfloat16_rn(f[2 * j + 1]));
        p[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      if constexpr (W == 8)
        *reinterpret_cast<uint4*>(o) = make_uint4(p[0], p[1], p[2], p[3]);
      else
        *reinterpret_cast<uint2*>(o) = make_uint2(p[0], p[1]);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (gn + j < N) o[j] = __float2bfloat16_rn(f[j]);
    }
  } else {
    float* o = static_cast<float*>(out) + base;
    if (full) {
#pragma unroll
      for (int j = 0; j < W / 4; ++j)
        reinterpret_cast<float4*>(o)[j] =
            make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < W; ++j)
        if (gn + j < N) o[j] = f[j];
    }
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Layout<BM, BN>::kThreads,
                                  512 / Layout<BM, BN>::kThreads)
matmul_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   void* __restrict__ out, int* __restrict__ acc_ws, int M,
                   int N, int K, int out_bf16, int x_vec, int w_vec,
                   int out_vec) {
  using L = Layout<BM, BN>;
  constexpr int NT = L::kThreads, MT = L::kMT;
  constexpr int XC = BK / 16, WC = BN / 16;
  constexpr int X_BYTES = BM * BK, STAGE_BYTES = BM * BK + BK * BN;
  extern __shared__ __align__(128) uint8_t smem[];

  // a split-K reduce pass launched after this grid may start scheduling
  // now; it still waits for this grid's completion before reading
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / L::kWarpsN) * L::kWM;
  const int wn0 = (warp % L::kWarpsN) * 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // this CTA's share of the K steps: split-K deals them to gridDim.z CTAs,
  // floor or ceil of steps / gridDim.z each (none empty: gridDim.z <= steps)
  const int steps = (K + BK - 1) / BK;
  const int s0 = (int)((long long)blockIdx.z * steps / gridDim.z);
  const int nsteps =
      (int)((long long)(blockIdx.z + 1) * steps / gridDim.z) - s0;

  // Per-lane fragment addresses within a stage: the B words at k = 4t + r
  // (a k step of 16 m further is 256 * WC * m bytes on), the ldmatrix rows
  // of m16 tile 0 at K sub-step kk (tile i is 16 * BK * i bytes on)
  const uint32_t smem_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  uint32_t b_off[4], a_off[BK / 32];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    b_off[r] = SwzW<WC>::at(4 * t + r, (wn0 >> 4) + (g >> 2)) + 4 * (g & 3);
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk)
    a_off[kk] = SwzX<XC>::at(wm0 + (lane & 15), 2 * kk + (lane >> 4));

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][e][r] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps)
      load_stage<BM, BN, BK, NT>(smem + s * STAGE_BYTES,
                                 smem + s * STAGE_BYTES + X_BYTES, x, w, M, N,
                                 K, m0, n0, (s0 + s) * BK, x_vec, w_vec, tid);
    cp_async_commit();
  }

  for (int it = 0; it < nsteps; ++it) {
    cp_async_wait<kStages - 2>();  // step `it` has landed
    __syncthreads();               // ... for every thread; step it-1 is done
    const int nxt = it + kStages - 1;
    if (nxt < nsteps) {
      uint8_t* st = smem + (nxt % kStages) * STAGE_BYTES;
      load_stage<BM, BN, BK, NT>(st, st + X_BYTES, x, w, M, N, K, m0, n0,
                                 (s0 + nxt) * BK, x_vec, w_vec, tid);
    }
    cp_async_commit();

    const uint32_t sa = smem_base + (it % kStages) * STAGE_BYTES;
    const uint32_t sb = sa + X_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      // B fragments of the warp's 4 n8 tiles: lane (g, t) reads columns
      // wn0 + 4g .. 4g+3 at k = 32kk + 16h + 4t + r, r = 0..3
      uint32_t b[4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4], o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[r] = ld_shared_u32(sb + b_off[r] + 256 * WC * (2 * kk + h));
        transpose4x4(v, o);
#pragma unroll
        for (int e = 0; e < 4; ++e) b[e][h] = o[e];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, sa + a_off[kk] + i * 16 * BK);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_s8(acc[i][e], a, b[e][0], b[e][1]);
      }
    }
  }
  cp_async_wait<0>();

  // Lane (g, t) holds, for each m16 tile i and row half hf, row
  // wm0 + 16i + g + 8hf at columns wn0 + 8t + j: j = 4 * (r & 1) + e for
  // accumulator acc[i][e][r] with r >> 1 == hf.
  int* part = gridDim.z > 1 ? acc_ws + (size_t)blockIdx.z * M * N : nullptr;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gm = m0 + wm0 + 16 * i + g + 8 * hf;
      if (gm >= M) continue;
      const int gn = n0 + wn0 + 8 * t;
      int v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = acc[i][j & 3][2 * hf + (j >> 2)];
      if (part == nullptr) {
        store_row(v, gm, gn, N, xs[gm], ws, out, out_bf16, out_vec);
      } else if (N % 4 == 0 && gn + 8 <= N) {  // this split's int32 partial
        int4* p = reinterpret_cast<int4*>(part + (size_t)gm * N + gn);
        p[0] = make_int4(v[0], v[1], v[2], v[3]);
        p[1] = make_int4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gn + j < N) part[(size_t)gm * N + gn + j] = v[j];
      }
    }
}

// Split-K, second pass: out[m][n] = the int32 partials of the splits
// summed in split order (exact), then the GEMM's own epilogue
// (`store_row`). A thread takes 4 consecutive columns of a row, with
// 16-byte loads of each split's partial when N % 4 == 0; rows are strided
// over gridDim.y.
__global__ void __launch_bounds__(256)
split_k_reduce_kernel(const int* __restrict__ parts, int splits,
                      const float* __restrict__ xs,
                      const float* __restrict__ ws, void* __restrict__ out,
                      int M, int N, int out_bf16, int out_vec) {
  // launched as a programmatic dependent of the GEMM: every partial is
  // written and visible once the GEMM grid has completed
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (n >= N) return;
  const size_t plane = (size_t)M * N;
  const bool vec = N % 4 == 0;  // then n + 4 <= N as well
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const int* p = parts + (size_t)m * N + n;
    int v[4] = {0, 0, 0, 0};
    if (vec) {
#pragma unroll 4
      for (int z = 0; z < splits; ++z) {
        const int4 q = __ldcg(reinterpret_cast<const int4*>(p + z * plane));
        v[0] += q.x; v[1] += q.y; v[2] += q.z; v[3] += q.w;
      }
    } else {
      for (int z = 0; z < splits; ++z)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) v[j] += __ldcg(p + z * plane + j);
    }
    store_row(v, m, n, N, xs[m], ws, out, out_bf16, out_vec);
  }
}

using KernelFn = void (*)(const int8_t*, const int8_t*, const float*,
                          const float*, void*, int*, int, int, int, int, int,
                          int, int);

struct Pick {
  KernelFn fn;
  int smem;     // dynamic shared memory of a launch
  int threads;  // per CTA
};

template <int BM, int BN, int BK>
Pick make() {
  return {matmul_int8_kernel<BM, BN, BK>, smem_bytes<BM, BN, BK>(),
          Layout<BM, BN>::kThreads};
}

template <int BM, int BN>
Pick pick_bk(int bk) {
  switch (bk) {
    case 32: return make<BM, BN, 32>();
    case 64: return make<BM, BN, 64>();
    case 128: return make<BM, BN, 128>();
  }
  return {nullptr, 0, 0};
}

template <int BM>
Pick pick_bn(int bn, int bk) {
  switch (bn) {
    case 32: return pick_bk<BM, 32>(bk);
    case 64: return pick_bk<BM, 64>(bk);
    case 128: return pick_bk<BM, 128>(bk);
  }
  return {nullptr, 0, 0};
}

// The kernel a (bm, bk, bn) launch runs; fn is null outside the tile set.
Pick pick(int bm, int bk, int bn) {
  switch (bm) {
    case 16: return pick_bn<16>(bn, bk);
    case 32: return pick_bn<32>(bn, bk);
    case 64: return pick_bn<64>(bn, bk);
    case 128: return pick_bn<128>(bn, bk);
  }
  return {nullptr, 0, 0};
}

// Past 48 KB a launch needs the opt-in, which CUDA keeps per device: set
// it on every such launch rather than cache it for the process.
cudaError_t opt_in(const Pick& p) {
  if (p.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              p.smem);
}

}  // namespace

// Tile set: bm in {16, 32, 64, 128}, bn in {32, 64, 128}, bk in {32, 64, 128}
// (kernel.py: BM_TILES, BN_TILES, BK_TILES). `split` CTAs share each output
// tile's K steps (1 <= split <= ceil(K / bk)); for split > 1, `workspace`
// holds split * M * N int32 (any contents: every slot is written before
// it is read) and a second kernel sums them. Returns the launches'
// cudaGetLastError(), or cudaErrorInvalidValue for a tile outside the set,
// a bad split or a missing workspace.
extern "C" int matmul_int8_launch(const void* x, const void* w, const void* xs,
                                  const void* ws, void* out, void* workspace,
                                  int M, int N, int K, int bm, int bk, int bn,
                                  int split, int out_bf16, void* stream) {
  const Pick p = pick(bm, bk, bn);
  const int steps = (K + bk - 1) / bk;
  if (p.fn == nullptr || split < 1 || split > (steps > 1 ? steps : 1) ||
      (split > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = opt_in(p);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies need every row of the operand to start 16-byte aligned:
  // the base pointer (a view may carry any offset) and the row length
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 16 == 0;
  const bool w_vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
  const bool out_vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       N % (out_bf16 ? 8 : 4) == 0;
  int* parts = split > 1 ? static_cast<int*>(workspace) : nullptr;
  dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm, split);
  p.fn<<<grid, p.threads, p.smem, s>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws), out, parts,
      M, N, K, out_bf16, x_vec, w_vec, out_vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  // programmatic dependent launch: the reduce pass is scheduled while the
  // GEMM runs, so the second launch adds no gap of its own
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + 1023) / 1024, M < 65535 ? M : 65535);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, split_k_reduce_kernel,
                         static_cast<const int*>(parts), split,
                         static_cast<const float*>(xs),
                         static_cast<const float*>(ws), out, M, N, out_bf16,
                         (int)out_vec);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// What one (bm, bk, bn) launch runs with: threads per CTA, registers and
// local memory (spills) per thread, shared memory per CTA (static plus the
// dynamic bytes the launch passes) and resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int matmul_int8_occupancy(int bm, int bk, int bn, int* ctas_per_sm,
                                     int* threads, int* regs, int* local_bytes,
                                     int* smem) {
  const Pick p = pick(bm, bk, bn);
  if (p.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(p);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, p.fn);
  if (e != cudaSuccess) return e;
  *threads = p.threads;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem = (int)(attr.sharedSizeBytes + p.smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, p.fn,
                                                       p.threads, p.smem);
}
