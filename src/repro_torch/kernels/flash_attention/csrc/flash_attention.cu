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
// tiled one.
//
// What bounds it on an H100: the executor's decode step (B*H = 4096 rows,
// one query against a 512-entry f32 cache, hd = 128) does 2 flops per K/V
// element it reads, far under the card's ~20 f32 flops per byte, so it is
// bound by reading K and V once (2.15 GB). Causal prefill at long L does
// O(L) work per byte and turns bound by arithmetic.
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
// Tiled kernel (block_q in {16, 32, 64}), simple first:
//   * one CTA of 128 threads per (b*H + h, q-tile of BQ rows); a loop over
//     KV tiles of BK rows replaces the TPU's sequential KV grid axis;
//   * the q tile is held in shared memory as f32, K and V tiles in the
//     input type (K rows padded by one 32-bit word so the 32 threads of a
//     warp, each on its own key, hit 32 different banks);
//   * scores S = (q . k) * scale go to shared memory; one warp per row
//     takes the running max, rescales and sums p = exp(s - m) in f32;
//   * thread d owns output column d of every q row in registers and adds
//     p @ V with the rescale alpha = exp(m_prev - m_new);
//   * causal: KV tiles wholly past the last query of the tile are skipped,
//     in-range masked scores are -1e30 as in the reference; keys past Lk
//     (a ragged tail) get p = 0 exactly, and query rows past Lq are not
//     stored, so no length has to divide the tiles.
// Pipelined loads (cp.async / TMA) and tensor cores for the tiled kernel
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory layout, in this order: Qs[BQ*hd] f32, Ss[BQ*BK] f32,
// m[BQ], l[BQ], alpha[BQ] f32, Ks[BK*(hd+pad)] T, Vs[BK*hd] T.
template <int BQ, int BK, typename T>
size_t smem_bytes(int hd) {
  constexpr int pad = 4 / sizeof(T);
  return sizeof(float) * ((size_t)BQ * hd + BQ * BK + 3 * BQ) +
         sizeof(T) * ((size_t)BK * (hd + pad) + (size_t)BK * hd);
}

template <int BQ, int BK, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Lq, int Lk, int hd, float sm_scale, int causal) {
  constexpr int pad = 4 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ss = Qs + BQ * hd;
  float* m_s = Ss + BQ * BK;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  T* Ks = reinterpret_cast<T*>(a_s + BQ);
  const int ldk = hd + pad;
  T* Vs = Ks + BK * ldk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const size_t row = (size_t)H * hd;  // elements between positions l, l+1
  const T* qb = q + ((size_t)b * Lq * H + h) * hd;
  const T* kb = k + ((size_t)b * Lk * H + h) * hd;
  const T* vb = v + ((size_t)b * Lk * H + h) * hd;
  T* ob = o + ((size_t)b * Lq * H + h) * hd;

  for (int idx = tid; idx < BQ * hd; idx += kThreads) {
    const int i = idx / hd, d = idx % hd;
    Qs[idx] = (q0 + i < Lq) ? to_f32(qb[(size_t)(q0 + i) * row + d]) : 0.f;
  }
  for (int i = tid; i < BQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  float acc[BQ];
#pragma unroll
  for (int i = 0; i < BQ; ++i) acc[i] = 0.f;

  // causal: keys at or past q0 + BQ are masked for every row of this tile
  const int kv_end = causal ? min(Lk, q0 + BQ) : Lk;
  __syncthreads();

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    for (int idx = tid; idx < BK * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd;
      const bool in = k0 + j < Lk;
      Ks[j * ldk + d] = in ? kb[(size_t)(k0 + j) * row + d] : from_f32<T>(0.f);
      Vs[j * hd + d] = in ? vb[(size_t)(k0 + j) * row + d] : from_f32<T>(0.f);
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BK; idx += kThreads) {
      const int i = idx / BK, j = idx % BK;
      float s = -INFINITY;  // key past Lk: p = 0 below
      if (k0 + j < Lk) {
        const float* qi = Qs + i * hd;
        const T* kj = Ks + j * ldk;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qi[d], to_f32(kj[d]), dot);
        s = dot * sm_scale;
        if (causal && q0 + i < k0 + j) s = kNegInf;
      }
      Ss[idx] = s;
    }
    __syncthreads();

    for (int i = warp; i < BQ; i += kThreads / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, Ss[i * BK + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float s = Ss[i * BK + j];
        const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
        Ss[i * BK + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

    if (tid < hd) {
#pragma unroll
      for (int i = 0; i < BQ; ++i) acc[i] *= a_s[i];
      for (int j = 0; j < BK; ++j) {
        const float vj = to_f32(Vs[j * hd + tid]);
#pragma unroll
        for (int i = 0; i < BQ; ++i) acc[i] = fmaf(Ss[i * BK + j], vj, acc[i]);
      }
    }
    __syncthreads();
  }

  if (tid < hd) {
#pragma unroll
    for (int i = 0; i < BQ; ++i)
      if (q0 + i < Lq)
        ob[(size_t)(q0 + i) * row + tid] = from_f32<T>(acc[i] / fmaxf(l_s[i], 1e-20f));
  }
}

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
// instantiation with the dynamic shared memory it launches with.
template <typename T>
using KernelFn = void (*)(const T*, const T*, const T*, T*, int, int, int,
                          int, float, int);

template <typename T>
struct Pick {
  KernelFn<T> fn;
  size_t bytes;
};

template <int BQ, typename T>
Pick<T> pick_bk(int bk, int hd) {
  switch (bk) {
    case 32: return {flash_attention_kernel<BQ, 32, T>, smem_bytes<BQ, 32, T>(hd)};
    case 64: return {flash_attention_kernel<BQ, 64, T>, smem_bytes<BQ, 64, T>(hd)};
    case 128: return {flash_attention_kernel<BQ, 128, T>, smem_bytes<BQ, 128, T>(hd)};
  }
  return {nullptr, 0};
}

// The kernel a (block_q, block_k) launch runs; fn is null outside the set.
template <typename T>
Pick<T> pick(int bq, int bk, int hd) {
  switch (bq) {
    case 1:
      switch (bk) {  // U = bk / 32 keys per chunk
        case 32: return {flash_decode_kernel<1, T>, decode_smem_bytes(hd)};
        case 64: return {flash_decode_kernel<2, T>, decode_smem_bytes(hd)};
        case 128: return {flash_decode_kernel<4, T>, decode_smem_bytes(hd)};
      }
      break;
    case 16: return pick_bk<16, T>(bk, hd);
    case 32: return pick_bk<32, T>(bk, hd);
    case 64: return pick_bk<64, T>(bk, hd);
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
  fn<<<grid, kThreads, p.bytes, stream>>>(
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
                                                       kThreads, p.bytes);
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
  if (hd < 1 || hd > kThreads || bq < 1 || (Lq + bq - 1) / bq > 65535)
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
  if (hd < 1 || hd > kThreads) return cudaErrorInvalidValue;
  if (is_bf16)
    return occupancy<__nv_bfloat16>(bq, bk, hd, ctas_per_sm, regs, smem_bytes);
  return occupancy<float>(bq, bk, hd, ctas_per_sm, regs, smem_bytes);
}
