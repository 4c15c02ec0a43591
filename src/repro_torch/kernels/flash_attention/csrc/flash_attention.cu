// Online-softmax (flash) attention for Hopper (sm_90a), over q, k, v laid
// out as (B, L, H, hd), contiguous, output in the input type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel / flash_attention_bh (Pallas grid (BH, Lq/bq, Lk/bk) with
// f32 running max, sum and accumulator in VMEM scratch, a -1e30 causal mask,
// causal skip of KV blocks past the frontier, output acc / max(l, 1e-20)).
// The reference folds (B, L, H, hd) into (B*H, L, hd) with a transpose;
// both kernels here read the same (b*H + h) rows through strides instead,
// so the fold costs no copy. Two kernels share one entry point: a launch
// with block_q = 1 runs the decode kernel, block_q in {16, 32, 64} the
// prefill kernel.
//
// What bounds it on an H100: the executor's decode step (B*H = 4096 rows,
// one query against a 512-entry f32 cache, hd = 128) does 2 flops per K/V
// element it reads, far under the card's ~20 f32 flops per byte, so it is
// bound by reading K and V once (2.15 GB). Prefill does 4 * hd flops per
// (query, visible key) pair against 4 * hd elements per row moved: bound by
// the tensor cores' rate at long L (causal L 4096: 137 GFLOP, 0.14 ms at
// the bf16 peak) and by the bytes only at short L (L 264: 2.2 GFLOP).
//
// Decode kernel (block_q = 1), written to stream K and V:
//   * one CTA of 4 warps per (b*H + h, query row); chunk c of U = bk / 32
//     consecutive keys goes to warp c % 4. Each warp keeps its own running
//     max m, sum l and accumulator in registers; no K or V tile passes
//     through shared memory;
//   * lane t owns output columns 4t .. 4t+3 (hd <= 128): q's row, scaled by
//     sm_scale * log2(e) so the softmax runs on exp2f, and the accumulator
//     stay in registers; a key's K and V rows arrive as one 4-element vector
//     per lane (16 bytes in f32, 8 in bf16) with a streaming hint (__ldcs:
//     each byte is read once);
//   * register prefetch: a warp holds two chunks, A and B, and issues the
//     loads of the next chunk into one before it computes on the other, so
//     2U keys (bk / 16) per warp, bk / 4 per CTA, are in flight;
//   * a key's score is a warp-shuffle sum of the lanes' partial dots (the U
//     sums of a chunk interleaved), then the online-softmax update: one
//     rescale per chunk, p = exp2(s - m) per key. Causal keys j > i score
//     -1e30 as in the reference; chunks wholly past the frontier are
//     skipped, keys past Lk get p = 0 exactly;
//   * at the end the 4 warps' (m, l, acc) meet in 16 * (hd + 2) bytes of
//     shared memory; thread d < hd merges column d and writes
//     acc / max(l, 1e-20). A warp with no key keeps m = -1e30, l = 0 and
//     weighs exactly 0 (or 1 times zeros when no warp has a key), so
//     Lk < 4 chunks cannot turn the merge into NaN;
//   * the vector loads need q, k and v 4-element aligned and hd % 4 == 0
//     (then every row stride H * hd is too); otherwise the same kernel
//     loads element by element, masked at hd.
// With a few KB of shared memory per CTA, registers set the occupancy
// (chip_smoke.py prints both). No split-KV pass: path A has 4,096 rows.
//
// Prefill kernel (block_q in {16, 32, 64}), on the tensor cores:
//   * one CTA of BQ / 16 warps per (b*H + h, q tile of BQ rows); warp w owns
//     query rows 16w .. 16w+15 of the tile. A loop over KV tiles of BK keys
//     replaces the TPU's sequential KV grid axis. The score tile S = q.K^T
//     (16 x BK per warp) and the output accumulator (16 x hd) stay in
//     registers as mma.sync fragments; the online softmax runs per row in
//     registers (a 4-lane shuffle for the max and, at the end, the sum;
//     ex2.approx on scores scaled by sm_scale * log2(e)) and rescales the
//     accumulator there. No score passes through shared memory;
//   * bfloat16: q.K^T on mma.sync m16n8k16 (bf16 in, f32 sums: exact
//     products). P.V splits p into p_hi = bf16(p) and p_lo = bf16(p - p_hi)
//     and issues both against each V fragment, keeping p to ~16 bits:
//     bf16(p) alone reads ~2e-3 from the f32 oracle, over the executor's
//     tolerance. The score accumulator of one key pair of n8 tiles is the
//     A operand of P.V as it stands (FA2's register reuse);
//   * float32: both products on mma.sync m16n8k8 TF32. q.K^T is 3xTF32
//     (hi.hi + hi.lo + lo.hi, hi the top 10 mantissa bits, lo the rest,
//     each cut to TF32 by the MMA): single-pass TF32 there misses the
//     tolerance's half on large
//     scores (inputs x30: ~1.5e-3), the split keeps ~21 bits. P.V is one
//     TF32 pass (~2.5e-4), p and V rounded to nearest, ties away (as
//     cvt.rna, in two integer operations: sm_90a expands the cvt into a
//     compare-and-select sequence). The accumulator of m16n8k8 (lane t
//     holds keys 2t, 2t+1) is not the A layout (keys t, t+4); the k slots
//     are permuted instead, slot t <-> key 2t and slot t+4 <-> key 2t+1, so
//     the V fragment reads rows 2t and 2t+1 and P needs no shuffle;
//   * shared memory: the q tile, then a ring of two KV slots, K_j in one
//     and V_j in the other, all in the input type with hd zero-padded to
//     HD (64 or 128, the MMAs' k). Tiles arrive by 16-byte cp.async: V_j's
//     copy overlaps q.K_j^T and the softmax, K_{j+1}'s copy overlaps P.V_j,
//     two barriers per KV tile. Rows are 16-byte chunks XOR-swizzled by
//     (row % 8), no padding, so every ldmatrix phase (and the float32 V
//     fragment's scalar loads) hits 32 distinct banks. Operands that are not
//     16-byte aligned (an offset view, or hd * bytes not a multiple of 16)
//     take masked synchronous loads into the same layout;
//   * masks as the reference: causal in-range masked scores are -1e30 (so a
//     fully masked row cannot make NaN), KV tiles wholly past the tile's
//     last query are skipped, and a warp skips a tile wholly past its own
//     last row; keys past Lk get p = 0 exactly; rows past Lq are not
//     stored; output acc / max(l, 1e-20). Causal q tiles run heaviest
//     first, so the grid's last wave is the light ones.
// Registers bound the occupancy with shared memory (chip_smoke.py prints
// both at every tile); the bridge picks a tile that leaves two CTAs per SM.
// wgmma and TMA are later work.
//
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // decode CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 128;
constexpr int kSlots = 2;      // prefill KV ring: K in one slot, V in the other
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---- prefill kernel -------------------------------------------------------

// Dynamic shared memory of the prefill kernel: q [BQ][HD], then the ring's
// K slot [BK][HD] and V slot [BK][HD], in the input type.
template <int BQ, int BK, int HD, typename T>
constexpr size_t prefill_smem_bytes() {
  return sizeof(T) * (size_t)HD * (BQ + kSlots * BK);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// float32 -> TF32, round to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives, in two integer operations: sm_90a expands the cvt
// into a compare-and-select sequence), as a 32-bit pattern
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the two TF32 halves of a float32 held as bits: hi keeps the top 10
// mantissa bits and lo = x - hi is exact in f32; the MMA reads lo's top
// 10 bits (TF32 operands drop the low 13), so x = hi + lo to ~21 bits
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// 2^x on the SFU (ex2.approx: ~2 ulp; results under 2^-126 flush to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) -> bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi.a, b - hi.b),
// a in the low half as the MMA fragments want the lower column
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 16 bytes of one row from element c0 on, elements at or past hd (or the
// whole chunk when the row is out of range) zero: the masked load.
template <typename T>
__device__ __forceinline__ uint4 load_chunk_masked(const T* rowp, int c0,
                                                   int hd, bool row_in) {
  using Bits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                         uint16_t>::type;
  constexpr int kCE = 16 / sizeof(T);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row_in) {
    const Bits* p = reinterpret_cast<const Bits*>(rowp);
#pragma unroll
    for (int e = 0; e < kCE; ++e)
      if (c0 + e < hd)
        w[e * sizeof(T) / 4] |= uint32_t(p[c0 + e])
                                << (8 * ((e * sizeof(T)) % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows r0 .. r0+ROWS-1 of one (b*H + h) stream into a tile [ROWS][HD] at
// dst: row r's 16-byte chunk c lands at r * RB + ((c ^ (r % 8)) * 16). Rows
// at or past nrows and columns at or past hd are zero. Aligned operands
// take cp.async (hd * bytes % 16 == 0: a chunk is all in or all out), the
// rest a rolled loop of masked loads.
template <int ROWS, int HD, int NT, typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          size_t stride, int r0, int nrows,
                                          int hd, bool vec, int tid) {
  constexpr int kCE = 16 / sizeof(T);   // elements per chunk
  constexpr int kCPR = HD / kCE;         // chunks per row: 8 .. 32
  constexpr int kRB = HD * (int)sizeof(T);
  constexpr int kN = ROWS * kCPR / NT;   // chunks per thread
  static_assert(kN * NT == ROWS * kCPR, "the tile splits evenly");
  if (vec) {
    const uint32_t base = smem_u32(dst);
#pragma unroll 4
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * NT, r = idx / kCPR, c = idx % kCPR;
      const bool in = r0 + r < nrows && c * kCE < hd;
      const T* p = in ? src + (size_t)(r0 + r) * stride + c * kCE : src;
      cp_async16(base + r * kRB + ((c ^ (r & 7)) << 4), p, in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * NT, r = idx / kCPR, c = idx % kCPR;
      *reinterpret_cast<uint4*>(dst + r * kRB + ((c ^ (r & 7)) << 4)) =
          load_chunk_masked(src + (size_t)(r0 + r) * stride, c * kCE, hd,
                            r0 + r < nrows);
    }
  }
}

template <int BQ, int BK, int HD, typename T>
__global__ void __launch_bounds__(2 * BQ)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int Lq, int Lk, int hd, float sm_scale, int causal) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = 2 * BQ;               // BQ / 16 warps
  constexpr int RB = HD * (int)sizeof(T);  // bytes per shared row
  constexpr int NS = BK / 8;               // n8 tiles of S (keys)
  constexpr int NO = HD / 8;               // n8 tiles of O (columns)
  constexpr int KS = RB / 32;              // k steps of q.K^T: 2 chunks each
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* k_s = q_s + BQ * RB;
  unsigned char* v_s = k_s + BK * RB;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragments' row and column
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                        : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const int qw = q0 + 16 * warp;           // this warp's first query row
  const size_t row = (size_t)H * hd;       // elements between positions
  const T* qb = q + ((size_t)b * Lq * H + h) * hd;
  const T* kb = k + ((size_t)b * Lk * H + h) * hd;
  const T* vb = v + ((size_t)b * Lk * H + h) * hd;
  T* ob = o + ((size_t)b * Lq * H + h) * hd;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const bool vec = (hd * sizeof(T)) % 16 == 0 && bases % 16 == 0;

  // causal: keys at or past q0 + BQ are masked for every row of this tile
  const int kv_end = causal ? min(Lk, q0 + BQ) : Lk;
  const int ntiles = (kv_end + BK - 1) / BK;
  load_tile<BQ, HD, NT, T>(q_s, qb, row, q0, Lq, hd, vec, tid);
  if (ntiles > 0) load_tile<BK, HD, NT, T>(k_s, kb, row, 0, Lk, hd, vec, tid);
  cp_async_commit();

  // ldmatrix lane addresses: a base plus compile-time offsets, the chunk
  // XOR-swizzled by the row's (row % 8). q rows (and V's keys) are
  // lane % 16 with chunk 2j + lane / 16, K keys 8 * (lane / 16) + lane % 8
  // with chunk 2j + (lane / 8) % 2; as j only moves bits 1-2 of the chunk,
  // (2j + x) ^ r = (x ^ r) ^ 2j: a per-lane offset XOR (j % 4) << 5 bytes
  const int r8 = lane & 7;
  const uint32_t xq = ((lane >> 4) ^ r8) << 4;
  const uint32_t xk = (((lane >> 3) & 1) ^ r8) << 4;
  const uint32_t aq = smem_u32(q_s) + (16 * warp + (lane & 15)) * RB;
  const uint32_t ak = smem_u32(k_s) + (8 * (lane >> 4) + r8) * RB;
  // V: bf16 by ldmatrix.trans (keys 8 * ((lane / 8) % 2) + lane % 8, as
  // q's chunks); float32 by scalar loads of rows 2t and 2t + 1, column
  // 8n + g: chunk 2n + g / 4, swizzled by 2t (row 2t + 1: one more, bit 4
  // of the byte offset), word g % 4
  const uint32_t av = kF32 ? smem_u32(v_s) + 2 * t * RB
                           : smem_u32(v_s) + (8 * ((lane >> 3) & 1) + r8) * RB;
  const uint32_t xv = (t << 5) | ((g >> 2) << 4) | ((g & 3) << 2);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // rows g and g + 8 of the warp
  float l0 = 0.f, l1 = 0.f;          // this lane's share of the row sums
  const float sl2 = sm_scale * kLog2e;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    cp_async_wait_all();
    __syncthreads();  // K_it (and q) in; every warp is done with V_{it-1}
    load_tile<BK, HD, NT, T>(v_s, vb, row, k0, Lk, hd, vec, tid);
    cp_async_commit();
    // causal: a warp whose rows all precede the tile's first key skips it
    const bool active = !causal || k0 <= qw + 15;
    float s[NS][4];
    if (active) {
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t co = (kk >> 2) * 128;
        uint32_t a[4];
        ldmatrix_x4(a, aq + co + (xq ^ ((kk & 3) << 5)));
        if constexpr (kF32) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t bb[4], kh[4], kl[4];
            ldmatrix_x4(bb, ak + np * 16 * RB + co + (xk ^ ((kk & 3) << 5)));
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(bb[e], kh[e], kl[e]);
            mma_tf32(s[2 * np], al, kh[0], kh[1]);
            mma_tf32(s[2 * np], ah, kl[0], kl[1]);
            mma_tf32(s[2 * np], ah, kh[0], kh[1]);
            mma_tf32(s[2 * np + 1], al, kh[2], kh[3]);
            mma_tf32(s[2 * np + 1], ah, kl[2], kl[3]);
            mma_tf32(s[2 * np + 1], ah, kh[2], kh[3]);
          }
        } else {
#pragma unroll
          for (int np = 0; np < NS / 2; ++np) {
            uint32_t bb[4];
            ldmatrix_x4(bb, ak + np * 16 * RB + co + (xk ^ ((kk & 3) << 5)));
            mma_bf16(s[2 * np], a, bb[0], bb[1]);
            mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
          }
        }
      }
      // scale into the log2 domain; mask the ragged tail and the diagonal
      if (k0 + BK > Lk || (causal && k0 + BK - 1 > qw)) {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = k0 + 8 * n + 2 * t + (e & 1);
            const int i = qw + g + 8 * (e >> 1);
            s[n][e] = j >= Lk ? -INFINITY                     // p = 0 exactly
                      : causal && j > i ? kNegInf : s[n][e] * sl2;
          }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= sl2;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = fast_exp2(m0 - mx0), alpha1 = fast_exp2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= alpha0;
      l1 *= alpha1;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = fast_exp2(s[n][0] - mx0);
        s[n][1] = fast_exp2(s[n][1] - mx0);
        s[n][2] = fast_exp2(s[n][2] - mx1);
        s[n][3] = fast_exp2(s[n][3] - mx1);
        l0 += s[n][0] + s[n][1];
        l1 += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha0;
        acc[n][1] *= alpha0;
        acc[n][2] *= alpha1;
        acc[n][3] *= alpha1;
      }
    }
    cp_async_wait_all();
    __syncthreads();  // V_it in; every warp is done with K_it
    if (it + 1 < ntiles)
      load_tile<BK, HD, NT, T>(k_s, kb, row, k0 + BK, Lk, hd, vec, tid);
    cp_async_commit();
    if (active) {
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {  // 8 keys: slot t <-> key 2t
          const uint32_t a[4] = {tf32(s[kk][0]), tf32(s[kk][2]),
                                 tf32(s[kk][1]), tf32(s[kk][3])};
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const uint32_t at = av + kk * 8 * RB + (n >> 2) * 128 +
                                (xv ^ ((n & 3) << 5));
            mma_tf32(acc[n], a, tf32(ld_shared_f32(at)),
                     tf32(ld_shared_f32((at + RB) ^ 16)));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {  // 16 keys
          uint32_t ph[4], pl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, av + kk * 16 * RB + (np >> 2) * 128 +
                                      (xq ^ ((np & 3) << 5)));
            mma_bf16(acc[2 * np], pl, bb[0], bb[1]);
            mma_bf16(acc[2 * np], ph, bb[0], bb[1]);
            mma_bf16(acc[2 * np + 1], pl, bb[2], bb[3]);
            mma_bf16(acc[2 * np + 1], ph, bb[2], bb[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float r0 = 1.f / fmaxf(l0, 1e-20f), r1 = 1.f / fmaxf(l1, 1e-20f);
  const int i0 = qw + g, i1 = i0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = 8 * n + 2 * t;
    if (i0 < Lq) {
      if (c < hd) ob[(size_t)i0 * row + c] = from_f32<T>(acc[n][0] * r0);
      if (c + 1 < hd) ob[(size_t)i0 * row + c + 1] = from_f32<T>(acc[n][1] * r0);
    }
    if (i1 < Lq) {
      if (c < hd) ob[(size_t)i1 * row + c] = from_f32<T>(acc[n][2] * r1);
      if (c + 1 < hd) ob[(size_t)i1 * row + c + 1] = from_f32<T>(acc[n][3] * r1);
    }
  }
}

// ---- decode kernel --------------------------------------------------------

// Four consecutive elements of one row, as the decode kernel's lanes hold
// them: loaded raw (so the load stays in flight until first use), widened
// to f32 at use.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using Raw = float4;
  __device__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  // n: valid elements from p (the row ends at hd); vec: one 16-byte load
  __device__ static Raw load(const float* p, int n, bool vec) {
    if (vec) return __ldcs(reinterpret_cast<const float4*>(p));
    Raw r = zero();
    if (n > 0) r.x = __ldcs(p);
    if (n > 1) r.y = __ldcs(p + 1);
    if (n > 2) r.z = __ldcs(p + 2);
    if (n > 3) r.w = __ldcs(p + 3);
    return r;
  }
  __device__ static void unpack(Raw r, float (&x)[4]) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using Raw = uint2;  // element e in bits 16 * (e % 2) of word e / 2
  __device__ static Raw zero() { return make_uint2(0u, 0u); }
  __device__ static Raw load(const __nv_bfloat16* p, int n, bool vec) {
    if (vec) return __ldcs(reinterpret_cast<const uint2*>(p));
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    unsigned int e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) e[i] = __ldcs(u + i);
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  __device__ static void unpack(Raw r, float (&x)[4]) {
    x[0] = __uint_as_float(r.x << 16);
    x[1] = __uint_as_float(r.x & 0xffff0000u);
    x[2] = __uint_as_float(r.y << 16);
    x[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};

// Loads of one chunk (keys j0 .. j0+U-1) of K and V; keys at or past
// kv_end, and lanes past hd, get zeros and touch no memory.
template <int U, typename T>
__device__ __forceinline__ void issue_chunk(
    const T* kb, const T* vb, size_t row, int j0, int kv_end, int c0, int n,
    bool vec, typename Vec4<T>::Raw (&kr)[U], typename Vec4<T>::Raw (&vr)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u;
    if (j < kv_end && n > 0) {
      kr[u] = Vec4<T>::load(kb + (size_t)j * row + c0, n, vec);
      vr[u] = Vec4<T>::load(vb + (size_t)j * row + c0, n, vec);
    } else {
      kr[u] = Vec4<T>::zero();
      vr[u] = Vec4<T>::zero();
    }
  }
}

// Online-softmax update of one warp's (m, l, acc) with one chunk; scores
// are in the log2 domain (q carries sm_scale * log2(e)).
template <int U, typename T>
__device__ __forceinline__ void consume_chunk(
    const float (&qr)[4], const typename Vec4<T>::Raw (&kr)[U],
    const typename Vec4<T>::Raw (&vr)[U], int j0, int i, int Lk, int causal,
    float& m, float& l, float (&acc)[4]) {
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float x[4];
    Vec4<T>::unpack(kr[u], x);
    s[u] = qr[0] * x[0];
#pragma unroll
    for (int e = 1; e < 4; ++e) s[u] = fmaf(qr[e], x[e], s[u]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
  float mx = m;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u;
    if (j >= Lk) s[u] = -INFINITY;             // ragged tail: p = 0
    else if (causal && j > i) s[u] = kNegInf;  // the reference's mask
    mx = fmaxf(mx, s[u]);
  }
  const float alpha = exp2f(m - mx);
  l *= alpha;
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] *= alpha;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float p = exp2f(s[u] - mx);
    float x[4];
    Vec4<T>::unpack(vr[u], x);
    l += p;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(p, x[e], acc[e]);
  }
  m = mx;
}

// Dynamic shared memory of the decode kernel: each warp's acc[hd], then
// m[kWarps] and l[kWarps], all f32, for the final merge.
size_t decode_smem_bytes(int hd) {
  return sizeof(float) * ((size_t)kWarps * hd + 2 * kWarps);
}

template <int U, typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int H,
                    int Lq, int Lk, int hd, float sm_scale, int causal) {
  using Raw = typename Vec4<T>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);
  float* m_s = acc_s + kWarps * hd;
  float* l_s = m_s + kWarps;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int i = blockIdx.y;  // the query row
  const size_t row = (size_t)H * hd;
  const T* qb = q + (((size_t)b * Lq + i) * H + h) * hd;
  const T* kb = k + ((size_t)b * Lk * H + h) * hd;
  const T* vb = v + ((size_t)b * Lk * H + h) * hd;
  T* ob = o + (((size_t)b * Lq + i) * H + h) * hd;
  // 4-element vectors: every row start is aligned when the bases are and
  // hd % 4 == 0 (the row stride H * hd then is a multiple of 4)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  const bool vec = hd % 4 == 0 && bases % (4 * sizeof(T)) == 0;
  const int c0 = 4 * lane;
  const int n = min(4, hd - c0);  // this lane's columns; <= 0: none

  float qr[4];
  Vec4<T>::unpack(n > 0 ? Vec4<T>::load(qb + c0, n, vec) : Vec4<T>::zero(), qr);
  const float qscale = sm_scale * kLog2e;
#pragma unroll
  for (int e = 0; e < 4; ++e) qr[e] *= qscale;
  float m = kNegInf, l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  // causal: keys past row i are masked for it; chunks wholly past the
  // frontier are never read
  const int kv_end = causal ? min(Lk, i + 1) : Lk;
  const int nchunks = (kv_end + U - 1) / U;
  Raw ka[U], va[U], kn[U], vn[U];
  int c = warp;
  if (c < nchunks)
    issue_chunk<U, T>(kb, vb, row, c * U, kv_end, c0, n, vec, ka, va);
  while (c < nchunks) {
    const int c1 = c + kWarps;
    if (c1 < nchunks)
      issue_chunk<U, T>(kb, vb, row, c1 * U, kv_end, c0, n, vec, kn, vn);
    consume_chunk<U, T>(qr, ka, va, c * U, i, Lk, causal, m, l, acc);
    if (c1 >= nchunks) break;
    const int c2 = c1 + kWarps;
    if (c2 < nchunks)
      issue_chunk<U, T>(kb, vb, row, c2 * U, kv_end, c0, n, vec, ka, va);
    consume_chunk<U, T>(qr, kn, vn, c1 * U, i, Lk, causal, m, l, acc);
    c = c2;
  }

#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < n) acc_s[warp * hd + c0 + e] = acc[e];
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (tid < hd) {
    float mx = m_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = exp2f(m_s[w] - mx);
      lsum = fmaf(l_s[w], sc, lsum);
      out = fmaf(acc_s[w * hd + tid], sc, out);
    }
    ob[tid] = from_f32<T>(out / fmaxf(lsum, 1e-20f));
  }
}

// Every kernel of the entry point has this signature; `Pick` is one
// instantiation with the block size and dynamic shared memory it launches
// with.
template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, int, int, int,
                          int, float, int);

template <typename T>
struct Pick {
  KernelFn<T> fn;
  size_t bytes;
  int threads;
};

// hd pads to 64 or 128 in shared memory: the two head-dim instances
template <int BQ, int BK, typename T>
Pick<T> pick_hd(int hd) {
  if (hd <= 64)
    return {flash_prefill_kernel<BQ, BK, 64, T>,
            prefill_smem_bytes<BQ, BK, 64, T>(), 2 * BQ};
  return {flash_prefill_kernel<BQ, BK, 128, T>,
          prefill_smem_bytes<BQ, BK, 128, T>(), 2 * BQ};
}

template <int BQ, typename T>
Pick<T> pick_bk(int bk, int hd) {
  switch (bk) {
    case 32: return pick_hd<BQ, 32, T>(hd);
    case 64: return pick_hd<BQ, 64, T>(hd);
    case 128: return pick_hd<BQ, 128, T>(hd);
  }
  return {nullptr, 0, 0};
}

// The kernel a (block_q, block_k) launch runs; fn is null outside the set.
template <typename T>
Pick<T> pick(int bq, int bk, int hd) {
  switch (bq) {
    case 1:
      switch (bk) {  // U = bk / 32 keys per chunk
        case 32: return {flash_decode_kernel<1, T>, decode_smem_bytes(hd), kThreads};
        case 64: return {flash_decode_kernel<2, T>, decode_smem_bytes(hd), kThreads};
        case 128: return {flash_decode_kernel<4, T>, decode_smem_bytes(hd), kThreads};
      }
      break;
    case 16: return pick_bk<16, T>(bk, hd);
    case 32: return pick_bk<32, T>(bk, hd);
    case 64: return pick_bk<64, T>(bk, hd);
  }
  return {nullptr, 0, 0};
}

// Past 48 KB a launch needs the opt-in, which CUDA keeps per device: set
// it on every such launch rather than cache it for the process.
template <typename T>
cudaError_t opt_in(const Pick<T>& p) {
  if (p.bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.bytes);
}

template <typename T>
cudaError_t launch(int bq, int bk, const void* q, const void* k,
                   const void* v, void* o, int B, int H, int Lq, int Lk,
                   int hd, float sm_scale, int causal, cudaStream_t stream) {
  const Pick<T> p = pick<T>(bq, bk, hd);
  if (p.fn == nullptr) return cudaErrorInvalidValue;
  const cudaError_t e = opt_in(p);
  if (e != cudaSuccess) return e;
  const KernelFn<T> fn = p.fn;
  dim3 grid(B * H, (Lq + bq - 1) / bq);
  fn<<<grid, p.threads, p.bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, hd, sm_scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int bq, int bk, int hd, int* ctas_per_sm, int* regs,
                      int* smem) {
  const Pick<T> p = pick<T>(bq, bk, hd);
  if (p.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(p);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, p.fn);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *smem = (int)(attr.sharedSizeBytes + p.bytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, p.fn,
                                                       p.threads, p.bytes);
}

}  // namespace

// Tile set: bq in {1, 16, 32, 64}, bk in {32, 64, 128}, hd <= 128
// (kernel.py: BQ_TILES, BK_TILES, MAX_HEAD_DIM); bq = 1 runs the decode
// kernel. Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue
// for a tile outside the set or a grid past 65,535 query tiles.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Lq, int Lk, int hd, float sm_scale,
                                      int causal, int bq, int bk, int is_bf16,
                                      void* stream) {
  if (hd < 1 || hd > kMaxHeadDim || bq < 1 || (Lq + bq - 1) / bq > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(bq, bk, q, k, v, o, B, H, Lq, Lk, hd,
                                 sm_scale, causal, s);
  return launch<float>(bq, bk, q, k, v, o, B, H, Lq, Lk, hd, sm_scale, causal,
                       s);
}

// What one (bq, bk, hd, dtype) launch runs with: registers per thread,
// shared memory per CTA (static plus the dynamic bytes the launch passes)
// and resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int flash_attention_occupancy(int bq, int bk, int hd, int is_bf16,
                                         int* ctas_per_sm, int* regs,
                                         int* smem_bytes) {
  if (hd < 1 || hd > kMaxHeadDim) return cudaErrorInvalidValue;
  if (is_bf16)
    return occupancy<__nv_bfloat16>(bq, bk, hd, ctas_per_sm, regs, smem_bytes);
  return occupancy<float>(bq, bk, hd, ctas_per_sm, regs, smem_bytes);
}
