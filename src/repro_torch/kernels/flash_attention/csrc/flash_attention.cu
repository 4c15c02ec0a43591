// Online-softmax (flash) attention for Hopper (sm_90a), over q, k, v laid
// out as (B, L, H, hd), contiguous, output in the input type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel / flash_attention_bh (Pallas grid (BH, Lq/bq, Lk/bk) with
// f32 running max, sum and accumulator in VMEM scratch, a -1e30 causal mask,
// causal skip of KV blocks past the frontier, output acc / max(l, 1e-20)).
// The reference folds (B, L, H, hd) into (B*H, L, hd) with a transpose;
// this kernel reads the same (b*H + h) rows through strides instead, so the
// fold costs no copy.
//
// What bounds it on an H100: the executor's decode step (B*H = 4096 rows,
// one query against a 512-entry f32 cache, hd = 128) does 2 flops per K/V
// element it reads, far under the card's ~20 f32 flops per byte, so it is
// bound by reading K and V once (2.15 GB). Causal prefill at long L does
// O(L) work per byte and turns bound by arithmetic.
//
// Design, simple first:
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
// Pipelined loads (cp.async / TMA) and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's mask value

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

template <int BQ, int BK, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Lq, int Lk, int hd, float sm_scale, int causal,
                   cudaStream_t stream) {
  auto kern = flash_attention_kernel<BQ, BK, T>;
  const size_t bytes = smem_bytes<BQ, BK, T>(hd);
  // past 48 KB a launch needs the opt-in, which CUDA keeps per device: set
  // it on every such launch rather than cache it for the process
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk, hd, sm_scale,
      causal);
  return cudaGetLastError();
}

template <int BQ, typename T>
cudaError_t dispatch_bk(int bk, const void* q, const void* k, const void* v,
                        void* o, int B, int H, int Lq, int Lk, int hd,
                        float sc, int causal, cudaStream_t s) {
  switch (bk) {
    case 32: return launch<BQ, 32, T>(q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
    case 64: return launch<BQ, 64, T>(q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
    case 128: return launch<BQ, 128, T>(q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_bq(int bq, int bk, const void* q, const void* k,
                        const void* v, void* o, int B, int H, int Lq, int Lk,
                        int hd, float sc, int causal, cudaStream_t s) {
  switch (bq) {
    case 1: return dispatch_bk<1, T>(bk, q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
    case 16: return dispatch_bk<16, T>(bk, q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
    case 32: return dispatch_bk<32, T>(bk, q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
    case 64: return dispatch_bk<64, T>(bk, q, k, v, o, B, H, Lq, Lk, hd, sc, causal, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Tile set: bq in {1, 16, 32, 64}, bk in {32, 64, 128}, hd <= 128
// (kernel.py: BQ_TILES, BK_TILES, MAX_HEAD_DIM). Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a tile outside the set.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Lq, int Lk, int hd, float sm_scale,
                                      int causal, int bq, int bk, int is_bf16,
                                      void* stream) {
  if (hd < 1 || hd > kThreads) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_bq<__nv_bfloat16>(bq, bk, q, k, v, o, B, H, Lq, Lk, hd,
                                      sm_scale, causal, s);
  return dispatch_bq<float>(bq, bk, q, k, v, o, B, H, Lq, Lk, hd, sm_scale,
                            causal, s);
}
