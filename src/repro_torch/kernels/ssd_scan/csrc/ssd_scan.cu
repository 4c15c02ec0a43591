// SSD intra-chunk step (Mamba2 state-space duality) for Hopper (sm_90a):
//
//   y[t] = sum_{tau <= t} (C_t . B_tau) * exp(max(s_t - s_tau, -60)) * dt_tau * x_tau
//
// per (batch, chunk, head) cell, over c, b (B, NC, Q, H, N), s, dt
// (B, NC, Q, H) and x (B, NC, Q, H, P), read in place through element
// strides; y is written in x's type, the arithmetic is float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:
// _ssd_kernel / ssd_intra_chunk_bh (Pallas grid (B*NC*H,), one whole
// (Q, Q) cell per grid step in VMEM). The reference folds
// (B, NC, Q, H, .) into (B*NC*H, Q, .) with a transpose and a full copy;
// this kernel takes the strides of whatever layout it is handed, so the
// fold costs nothing and the flattened layout is the case H = NC = 1.
//
// What bounds it on an H100: per cell it reads 2QN + 2Q + QP and writes QP
// elements and does 2(N + P) * Q(Q + 1) / 2 flops: at Q = 256, N = 128,
// P = 64 about 32 flops per float32 byte (16 per bf16 byte), under the
// tensor cores' ~148 TF32 (~295 bf16) flops per byte of HBM. So on the
// tensor cores it is bound by bytes: one prefill_32k layer of one sequence
// (8,192 cells, float32) moves 3.24 GB, 0.97 ms at 3.35 TB/s.
//
// Design:
//   * one CTA of 4 warps per (cell, query tile of BT = 16, 32 or 64 rows);
//     the grid is one-dimensional with a cell's query tiles adjacent and
//     its heaviest (last) tile first, so the tiles of a cell, which read
//     the same keys, run together and meet those keys in L2. Warp w owns
//     query rows 16 (w % (BT/16)) .. +15 of the tile and key group
//     w / (BT/16): BT = 64 is 4 row groups of one key group, 32 two of
//     two, 16 one row group of four key groups. `gpu_bridge.
//     select_ssd_block` picks BT: small tiles put more CTAs on one cell;
//   * the causal key range [0, min(Q, t0 + BT)) streams through a ring of
//     two slots of 64 keys (B [64][N'], X [64][P'] in the input type, then
//     s and dt of those keys in f32), N and P zero-padded to N', P' in
//     {64, 128}. A slot's 64 keys split into 64 / BT runs of BT keys, run
//     k for key group k.
//     B and X arrive by 16-byte cp.async, the copy of slot j + 1 overlapping
//     the products on slot j, one barrier per slot; s and dt of slot j + 1
//     are one scalar load per thread, held in a register over the products
//     and stored after them. Rows are 16-byte chunks XOR-swizzled by
//     (row % 8), so every ldmatrix phase (and the float32 X fragment's
//     scalar loads) hits 32 distinct banks. Operands that are not 16-byte
//     aligned (an offset or strided view, N * bytes or P * bytes not a
//     multiple of 16) take masked element loads into the same layout in the
//     same kernel: ragged N, P and Q never leave it;
//   * the tile's C rows come in once through the second slot and stay in
//     registers as the A fragments of S = C . B^T for the whole key loop;
//   * both products on the tensor cores with mma.sync, f32 accumulators in
//     registers: S (16 x BT per warp and slot) = C . B^T, then on S in
//     registers W = S * exp(max(s_t - s_tau, -60)) * dt_tau (multiplied
//     in the reference's order; the decay is ex2 of s * log2(e), scaled as
//     s is loaded, so the difference and the clip are taken in f32 in the
//     log2 domain; exactly 0 for tau > t, selected only in runs that reach
//     past a warp's first row), then y += W . X. Neither S, W nor the
//     decay reaches shared memory or HBM. float32: m16n8k8 TF32, one pass
//     for each product, every operand (C, B, W, X) rounded to nearest
//     (ties away) into TF32; W's accumulator layout is the A operand with
//     the k slots permuted (slot t <-> key 2t, slot t + 4 <-> key 2t + 1),
//     so the X fragment reads rows 2t and 2t + 1 and W needs no shuffle. A
//     CPU emulation of these roundings (tests/test_torch_ssd_numerics.py)
//     reads 4.2e-4 relative Frobenius error from the f32 oracle at path
//     B's cell (Q 256, N 128, P 64), a fifth of the executor's 2e-3, so no
//     split is needed: unlike attention, no exp amplifies an error in S.
//     bfloat16: m16n8k16, C.B^T exact products; W is split into bf16 hi
//     and lo = W - hi and both are issued against each X fragment
//     (ldmatrix.trans), which keeps W to ~16 bits: 1.3e-4 in the same
//     emulation, where bf16(W) alone reads 2.6e-3, over the tolerance;
//   * key groups (BT < 64): each warp sums its own keys; at the end the
//     partial y tiles meet in shared memory (the ring's bytes) and key
//     group 0 adds them in the fixed order 1, 2, 3, so runs are
//     deterministic. A warp skips a key run wholly past its last row or
//     past Q; query rows past Q are not stored.
// Registers and shared memory set the occupancy (chip_smoke.py prints both
// at every instance). wgmma, TMA and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int KT = 64;         // keys of one ring slot
constexpr int kSlots = 2;
constexpr int kMaxDim = 128;   // largest N and P
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegClip2 = -60.f * kLog2e;  // the reference's clip, log2

// Element strides of (batch, chunk, t, head) for c, b, s, dt, x and y; the
// last dim of c, b, x and y (n or p) is contiguous.
enum { kC, kB, kS, kDT, kX, kY, kTensors };
struct Strides {
  long long v[kTensors][4];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One ring slot: B [KT][NP] and X [KT][PP] in the input type, then s [KT]
// and dt [KT] in f32. The ring is kSlots of them; nothing else is dynamic.
template <int NP, int PP, typename T>
__host__ __device__ constexpr int slot_bytes() {
  return KT * (NP + PP) * (int)sizeof(T) + 2 * KT * (int)sizeof(float);
}

template <int NP, int PP, typename T>
constexpr size_t ring_bytes() {
  return (size_t)kSlots * slot_bytes<NP, PP, T>();
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

// float32 bits -> TF32, round to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives, in two integer operations)
__device__ __forceinline__ uint32_t tf32u(uint32_t u) {
  return (u + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ uint32_t tf32(float x) {
  return tf32u(__float_as_uint(x));
}

// 2^x on the SFU (ex2.approx: ~2 ulp; results under 2^-126 flush to 0,
// and the clip keeps every result above 2^-87)
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

// 16 bytes of one row from element c0 on, elements at or past n (or the
// whole chunk when the row is out of range) zero: the masked load.
template <typename T>
__device__ __forceinline__ uint4 load_chunk_masked(const T* rowp, int c0,
                                                   int n, bool row_in) {
  using Bits = typename std::conditional<sizeof(T) == 4, uint32_t,
                                         uint16_t>::type;
  constexpr int kCE = 16 / sizeof(T);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (row_in) {
    const Bits* p = reinterpret_cast<const Bits*>(rowp);
#pragma unroll
    for (int e = 0; e < kCE; ++e)
      if (c0 + e < n)
        w[e * sizeof(T) / 4] |= uint32_t(p[c0 + e])
                                << (8 * ((e * sizeof(T)) % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows r0 .. r0+ROWS-1 of one cell's operand (rows `stride` elements
// apart) into a tile [ROWS][D] at dst: row r's 16-byte chunk c lands at
// r * D * sizeof(T) + ((c ^ (r % 8)) * 16). Rows at or past r_end and
// columns at or past n are zero. Aligned operands take cp.async (n * bytes
// % 16 == 0: a chunk is all in or all out), the rest masked loads.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src,
                                          long long stride, int r0, int r_end,
                                          int n, bool vec, int tid) {
  constexpr int kCE = 16 / sizeof(T);   // elements per chunk
  constexpr int kCPR = D / kCE;          // chunks per row: 8 .. 32
  constexpr int kRB = D * (int)sizeof(T);
  constexpr int kN = ROWS * kCPR / kThreads;
  static_assert(kN * kThreads == ROWS * kCPR, "the tile splits evenly");
  if (vec) {
    const uint32_t base = smem_u32(dst);
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, r = idx / kCPR, c = idx % kCPR;
      const bool in = r0 + r < r_end && c * kCE < n;
      const T* p = in ? src + (long long)(r0 + r) * stride + c * kCE : src;
      cp_async16(base + r * kRB + ((c ^ (r & 7)) << 4), p, in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < kN; ++i) {
      const int idx = tid + i * kThreads, r = idx / kCPR, c = idx % kCPR;
      const bool in = r0 + r < r_end;
      *reinterpret_cast<uint4*>(dst + r * kRB + ((c ^ (r & 7)) << 4)) =
          load_chunk_masked(in ? src + (long long)(r0 + r) * stride : src,
                            c * kCE, n, in);
    }
  }
}

// BT: query rows of the CTA; NP, PP: N and P zero-padded (64 or 128).
template <int BT, int NP, int PP, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ c, const T* __restrict__ b,
                const T* __restrict__ s, const T* __restrict__ dt,
                const T* __restrict__ x, T* __restrict__ y, int NC, int Q,
                int H, int N, int P, int vec, Strides st) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int WR = BT / 16;            // row groups of 16 query rows
  constexpr int KG = kWarps / WR;        // key groups
  constexpr int KW = KT / KG;            // keys of a key group per slot
  constexpr int NS = KW / 8;             // n8 tiles of a warp's S
  constexpr int NO = PP / 8;             // n8 tiles of y
  constexpr int RBN = NP * (int)sizeof(T);  // bytes of a B (and C) row
  constexpr int RBP = PP * (int)sizeof(T);  // bytes of an X row
  constexpr int KS = RBN / 32;           // k steps of C.B^T, 2 chunks each
  constexpr int SLOT = slot_bytes<NP, PP, T>();
  constexpr int SDT = KT * (RBN + RBP);  // s and dt within a slot
  static_assert(KW == BT && NS % 2 == 0, "a key group takes BT keys");
  static_assert(BT * RBN <= SLOT, "the C tile fits a slot");
  static_assert((KG - 1) * WR * NO * 128 * 4 <= kSlots * SLOT,
                "the key groups' partial sums fit the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  // slot i % 2 of the ring (an offset, not an array: no local memory)
  auto slot = [&](int i) { return smem + (i & 1) * SLOT; };

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragments' row and column
  const int rg = warp % WR, kg = warp / WR;
  const int nqt = (Q + BT - 1) / BT;
  const int cell = (int)(blockIdx.x / (unsigned)nqt);
  const int qt = nqt - 1 - (int)(blockIdx.x % (unsigned)nqt);
  const int h = cell % H;
  const int bc = cell / H;
  const int ci = bc % NC;
  const int bi = bc / NC;
  const int t0 = qt * BT;
  const int qw = t0 + 16 * rg;             // this warp's first query row

  auto base = [&](int k) {
    return bi * st.v[k][0] + ci * st.v[k][1] + h * st.v[k][3];
  };
  const T* cb = c + base(kC);
  const T* bb = b + base(kB);
  const T* sb = s + base(kS);
  const T* db = dt + base(kDT);
  const T* xb = x + base(kX);
  T* yb = y + base(kY);
  const long long tc = st.v[kC][2], tb = st.v[kB][2], ts = st.v[kS][2],
                  td = st.v[kDT][2], tx = st.v[kX][2], ty = st.v[kY][2];

  // causal: keys at or past t0 + BT are masked for every row of the tile
  const int k_end = min(Q, t0 + BT);
  const int nsteps = (k_end + KT - 1) / KT;
  // s * log2(e) (threads 0 .. KT-1) or dt (the rest) of key k0 + tid % KT:
  // the decay runs on exp2
  auto sdt = [&](int k0) {
    const int j = k0 + (tid & (KT - 1));
    if (j >= k_end) return 0.f;
    return tid < KT ? to_f32(sb[j * ts]) * kLog2e : to_f32(db[j * td]);
  };

  // prologue: the C tile into slot 1, the first keys into slot 0
  load_rows<BT, NP, T>(slot(1), cb, tc, t0, Q, N, vec, tid);
  load_rows<KT, NP, T>(slot(0), bb, tb, 0, k_end, N, vec, tid);
  load_rows<KT, PP, T>(slot(0) + KT * RBN, xb, tx, 0, k_end, P, vec, tid);
  cp_async_commit();
  reinterpret_cast<float*>(slot(0) + SDT)[tid] = sdt(0);
  const float sq0 = qw + g < Q ? to_f32(sb[(qw + g) * ts]) * kLog2e : 0.f;
  const float sq1 = qw + g + 8 < Q ? to_f32(sb[(qw + g + 8) * ts]) * kLog2e
                                   : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // ldmatrix lane addresses, the chunk XOR-swizzled by the row's (row % 8)
  // (as flash_attention.cu's prefill kernel): C rows lane % 16 with chunk
  // 2j + lane / 16, B keys 8 * (lane / 16) + lane % 8 with chunk
  // 2j + (lane / 8) % 2; as j only moves bits 1-2 of the chunk,
  // (2j + x) ^ r = (x ^ r) ^ 2j: a per-lane offset XOR (j % 4) << 5 bytes
  const int r8 = lane & 7;
  const uint32_t xq = ((lane >> 4) ^ r8) << 4;
  const uint32_t xk = (((lane >> 3) & 1) ^ r8) << 4;
  uint32_t cf[KS][4];  // the C tile's A fragments, this warp's 16 rows
  {
    const uint32_t aq = smem_u32(slot(1)) + (16 * rg + (lane & 15)) * RBN;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(cf[kk], aq + (kk >> 2) * 128 + (xq ^ ((kk & 3) << 5)));
      if constexpr (kF32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) cf[kk][e] = tf32u(cf[kk][e]);
      }
    }
  }
  // offsets in a slot: this key group's B rows; its X rows, float32 by
  // scalar loads of rows 2t and 2t + 1, column 8n + g (chunk 2n + g / 4,
  // swizzled by 2t; row 2t + 1: one more, bit 4 of the byte offset, word
  // g % 4), bf16 by ldmatrix.trans (keys 8 * ((lane / 8) % 2) + lane % 8,
  // as C's chunks)
  const uint32_t ob = (kg * KW + 8 * (lane >> 4) + r8) * RBN;
  const uint32_t ox = KT * RBN + (kF32 ? (kg * KW + 2 * t) * RBP
                                       : (kg * KW + 8 * ((lane >> 3) & 1) + r8) * RBP);
  const uint32_t xv = (t << 5) | ((g >> 2) << 4) | ((g & 3) << 2);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int k0 = it * KT;
    if (it > 0) cp_async_wait_all();
    // slot it % 2 is in; every warp is done with the other slot (at it = 0:
    // with the C tile in it)
    __syncthreads();
    unsigned char* const next = slot(it + 1);
    float pend = 0.f;
    if (it + 1 < nsteps) {
      load_rows<KT, NP, T>(next, bb, tb, k0 + KT, k_end, N, vec, tid);
      load_rows<KT, PP, T>(next + KT * RBN, xb, tx, k0 + KT, k_end, P, vec,
                           tid);
      pend = sdt(k0 + KT);
    }
    cp_async_commit();
    const uint32_t cur = smem_u32(slot(it));
    const float* sdt_cur = reinterpret_cast<const float*>(slot(it) + SDT);
    const int kw0 = k0 + kg * KW;          // this key group's first key
    // skip keys past Q, or wholly past this warp's last row
    if (kw0 < k_end && kw0 <= qw + 15) {
      float sc[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t co = (kk >> 2) * 128;
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, cur + ob + np * 16 * RBN + co + (xk ^ ((kk & 3) << 5)));
          if constexpr (kF32) {
            mma_tf32(sc[2 * np], cf[kk], tf32u(bf[0]), tf32u(bf[1]));
            mma_tf32(sc[2 * np + 1], cf[kk], tf32u(bf[2]), tf32u(bf[3]));
          } else {
            mma_bf16(sc[2 * np], cf[kk], bf[0], bf[1]);
            mma_bf16(sc[2 * np + 1], cf[kk], bf[2], bf[3]);
          }
        }
      }
      // W = S * exp(max(s_t - s_tau, -60)) * dt_tau; exactly 0 for tau > t,
      // which only a run reaching past the warp's first row has
      auto weigh = [&](auto masked) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int jl = kg * KW + 8 * n + 2 * t;  // key within the slot
          const float2 sk = *reinterpret_cast<const float2*>(sdt_cur + jl);
          const float2 dk = *reinterpret_cast<const float2*>(sdt_cur + KT + jl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float seg = ((e >> 1) ? sq1 : sq0) - ((e & 1) ? sk.y : sk.x);
            const float w = __fmul_rn(
                __fmul_rn(sc[n][e], fast_exp2(fmaxf(seg, kNegClip2))),
                (e & 1) ? dk.y : dk.x);
            if constexpr (decltype(masked)::value)
              sc[n][e] = k0 + jl + (e & 1) <= qw + g + 8 * (e >> 1) ? w : 0.f;
            else
              sc[n][e] = w;
          }
        }
      };
      if (kw0 + KW - 1 > qw) weigh(std::true_type{});
      else weigh(std::false_type{});
      // y += W . X
      if constexpr (kF32) {
#pragma unroll
        for (int kk = 0; kk < NS; ++kk) {  // 8 keys: slot t <-> key 2t
          const uint32_t a[4] = {tf32(sc[kk][0]), tf32(sc[kk][2]),
                                 tf32(sc[kk][1]), tf32(sc[kk][3])};
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            const uint32_t at = cur + ox + kk * 8 * RBP + (n >> 2) * 128 +
                                (xv ^ ((n & 3) << 5));
            mma_tf32(acc[n], a, tf32(ld_shared_f32(at)),
                     tf32(ld_shared_f32((at + RBP) ^ 16)));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {  // 16 keys
          uint32_t wh[4], wl[4];
          split_bf16(sc[2 * kk][0], sc[2 * kk][1], wh[0], wl[0]);
          split_bf16(sc[2 * kk][2], sc[2 * kk][3], wh[1], wl[1]);
          split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], wh[2], wl[2]);
          split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], wh[3], wl[3]);
#pragma unroll
          for (int np = 0; np < NO / 2; ++np) {
            uint32_t xf[4];
            ldmatrix_x4_trans(xf, cur + ox + kk * 16 * RBP + (np >> 2) * 128 +
                                      (xq ^ ((np & 3) << 5)));
            mma_bf16(acc[2 * np], wl, xf[0], xf[1]);
            mma_bf16(acc[2 * np], wh, xf[0], xf[1]);
            mma_bf16(acc[2 * np + 1], wl, xf[2], xf[3]);
            mma_bf16(acc[2 * np + 1], wh, xf[2], xf[3]);
          }
        }
      }
    }
    if (it + 1 < nsteps) reinterpret_cast<float*>(next + SDT)[tid] = pend;
  }

  if constexpr (KG > 1) {
    // the key groups' partial tiles meet in the ring's bytes; group 0 adds
    // groups 1, 2, 3 in that order
    cp_async_wait_all();
    __syncthreads();  // every warp is done with the ring
    float* red = reinterpret_cast<float*>(smem);
    if (kg > 0) {
      float* r = red + ((kg - 1) * WR + rg) * (NO * 4 * 32);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) r[(n * 4 + e) * 32 + lane] = acc[n][e];
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int q = 1; q < KG; ++q) {
      const float* r = red + ((q - 1) * WR + rg) * (NO * 4 * 32);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += r[(n * 4 + e) * 32 + lane];
    }
  }

  const int i0 = qw + g, i1 = i0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int p = 8 * n + 2 * t;
    if (i0 < Q) {
      if (p < P) yb[i0 * ty + p] = from_f32<T>(acc[n][0]);
      if (p + 1 < P) yb[i0 * ty + p + 1] = from_f32<T>(acc[n][1]);
    }
    if (i1 < Q) {
      if (p < P) yb[i1 * ty + p] = from_f32<T>(acc[n][2]);
      if (p + 1 < P) yb[i1 * ty + p + 1] = from_f32<T>(acc[n][3]);
    }
  }
}

// Every instance has this signature; `Pick` is one instance with the
// dynamic shared memory it launches with.
template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, const T*, const T*,
                          T*, int, int, int, int, int, int, Strides);

template <typename T>
struct Pick {
  KernelFn<T> fn;
  size_t bytes;
};

// N and P pad to 64 or 128 in shared memory: four instances per BT
template <int BT, typename T>
Pick<T> pick_np(int N, int P) {
  if (N <= 64) {
    if (P <= 64) return {ssd_scan_kernel<BT, 64, 64, T>, ring_bytes<64, 64, T>()};
    return {ssd_scan_kernel<BT, 64, 128, T>, ring_bytes<64, 128, T>()};
  }
  if (P <= 64) return {ssd_scan_kernel<BT, 128, 64, T>, ring_bytes<128, 64, T>()};
  return {ssd_scan_kernel<BT, 128, 128, T>, ring_bytes<128, 128, T>()};
}

// The instance a (bt, N, P) launch runs; fn is null outside the set.
template <typename T>
Pick<T> pick(int bt, int N, int P) {
  switch (bt) {
    case 16: return pick_np<16, T>(N, P);
    case 32: return pick_np<32, T>(N, P);
    case 64: return pick_np<64, T>(N, P);
  }
  return {nullptr, 0};
}

// Past 48 KB a launch needs the opt-in, which CUDA keeps per device: set
// it on every such launch rather than cache it for the process.
template <typename T>
cudaError_t opt_in(const Pick<T>& p) {
  if (p.bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p.bytes);
}

// One operand of rows of `d` contiguous elements may take 16-byte copies:
// its base and every stride that moves (an extent past 1) are 16-byte
// multiples, and so is a row.
bool aligned16(const void* p, const long long (&sv)[4], const int (&ext)[4],
               int d, int el) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0 || (d * el) % 16 != 0)
    return false;
  for (int k = 0; k < 4; ++k)
    if (ext[k] > 1 && (sv[k] * el) % 16 != 0) return false;
  return true;
}

template <typename T>
cudaError_t launch(int bt, const void* c, const void* b, const void* s,
                   const void* dt, const void* x, void* y, int B, int NC,
                   int Q, int H, int N, int P, const Strides& st,
                   cudaStream_t stream) {
  const Pick<T> p = pick<T>(bt, N, P);
  if (p.fn == nullptr) return cudaErrorInvalidValue;
  const long long ctas = (long long)B * NC * H * ((Q + bt - 1) / bt);
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = opt_in(p);
  if (e != cudaSuccess) return e;
  const int ext[4] = {B, NC, Q, H};
  const int el = (int)sizeof(T);
  const int vec = aligned16(c, st.v[kC], ext, N, el) &&
                  aligned16(b, st.v[kB], ext, N, el) &&
                  aligned16(x, st.v[kX], ext, P, el);
  const KernelFn<T> fn = p.fn;
  fn<<<(unsigned)ctas, kThreads, p.bytes, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(s), static_cast<const T*>(dt),
      static_cast<const T*>(x), static_cast<T*>(y), NC, Q, H, N, P, vec, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int bt, int N, int P, int* ctas_per_sm, int* regs,
                      int* smem, int* local) {
  const Pick<T> p = pick<T>(bt, N, P);
  if (p.fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(p);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, p.fn);
  if (e != cudaSuccess) return e;
  *regs = attr.numRegs;
  *smem = (int)(attr.sharedSizeBytes + p.bytes);
  *local = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, p.fn,
                                                       kThreads, p.bytes);
}

}  // namespace

// strides: 24 int64 element strides, (batch, chunk, t, head) for c, b, s,
// dt, x, y in that order. bt in {16, 32, 64} (kernel.py: BT_TILES),
// 1 <= N, P <= 128 (MAX_DIM), Q >= 1 and B * NC * H * ceil(Q / bt) CTAs
// in 1 .. 2**31 - 1. Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for sizes outside that range.
extern "C" int ssd_scan_launch(const void* c, const void* b, const void* s,
                               const void* dt, const void* x, void* y, int B,
                               int NC, int Q, int H, int N, int P,
                               const void* strides, int is_bf16, int bt,
                               void* stream) {
  if (N < 1 || N > kMaxDim || P < 1 || P > kMaxDim || Q < 1 || B < 1 ||
      NC < 1 || H < 1)
    return cudaErrorInvalidValue;
  Strides st;
  const long long* src = static_cast<const long long*>(strides);
  for (int k = 0; k < kTensors; ++k)
    for (int d = 0; d < 4; ++d) st.v[k][d] = src[k * 4 + d];
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(bt, c, b, s, dt, x, y, B, NC, Q, H, N, P,
                                 st, stream_);
  return launch<float>(bt, c, b, s, dt, x, y, B, NC, Q, H, N, P, st, stream_);
}

// What one (bt, N, P, dtype) launch runs with: registers per thread,
// shared memory per CTA (static plus the dynamic bytes the launch passes),
// local memory per thread and resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int ssd_scan_occupancy(int bt, int N, int P, int is_bf16,
                                  int* ctas_per_sm, int* regs,
                                  int* smem_bytes, int* local_bytes) {
  if (N < 1 || N > kMaxDim || P < 1 || P > kMaxDim)
    return cudaErrorInvalidValue;
  if (is_bf16)
    return occupancy<__nv_bfloat16>(bt, N, P, ctas_per_sm, regs, smem_bytes,
                                    local_bytes);
  return occupancy<float>(bt, N, P, ctas_per_sm, regs, smem_bytes,
                          local_bytes);
}
