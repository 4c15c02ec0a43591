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
// elements but does 2(N + P) * Q(Q + 1) / 2 flops, about 120 flops per f32
// byte at Q = 256, N = 128, P = 64, far over the card's ~20 f32 flops per
// byte. So it is bound by arithmetic, at the float32 rate of the CUDA cores
// (67 TFLOP/s) while the products are plain FMA.
//
// Design, simple first:
//   * one CTA of 256 threads (16 x 16) per (cell, tile of BT = 64 query
//     rows); a loop over the key tiles tau0 <= t0 replaces the TPU's whole
//     (Q, Q) block, so nothing crosses CTAs and key tiles past the causal
//     frontier are never read;
//   * the query tile of C and its s values are staged in shared memory as
//     f32 once; each key tile stages B, X, s and dt (rows padded by one
//     word so the 16 threads reading 16 rows hit 16 banks);
//   * each thread computes a 4 x 4 block of the (BT, BT) score tile
//     (C_t . B_tau) in registers, then weights it in place by
//     exp(max(s_t - s_tau, -60)) * dt_tau, with s_t - s_tau taken in f32
//     from the loaded s values as the reference does, and writes exactly 0
//     for tau > t; neither the scores nor the decay ever reach HBM;
//   * the thread then adds W @ X to a 4 x ceil(P / 16) block of y held in
//     f32 registers (output columns strided by 16 so stores coalesce);
//   * rows and keys past Q load as zeros and query rows past Q are not
//     stored, so Q = 24 or any Q works; N and P run 1..128 and the loops
//     over them are exact, so neither need be a tile multiple.
// Tensor cores (mma.sync / wgmma) and cp.async / TMA pipelining are later
// work; shared memory above 48 KB takes the opt-in on every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int BT = 64;         // query rows of a CTA, and rows of a key tile
constexpr int RT = BT / 16;    // score rows and columns of one thread
constexpr int kMaxDim = 128;   // largest N and P
constexpr float kNegClip = -60.f;

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

// Shared memory, in floats and in this order: Cs[BT][N+1], Bs[BT][N+1],
// Xs[BT][P], Ws[BT][BT+1], s of the query rows[BT], s and dt of the key
// rows[BT] each.
size_t smem_bytes(int N, int P) {
  return sizeof(float) *
         ((size_t)2 * BT * (N + 1) + (size_t)BT * P + BT * (BT + 1) + 3 * BT);
}

// PJ: output columns of one thread, ceil(P / 16) rounded up to 2, 4 or 8.
template <int PJ, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ c, const T* __restrict__ b,
                const T* __restrict__ s, const T* __restrict__ dt,
                const T* __restrict__ x, T* __restrict__ y, int NC, int Q,
                int H, int N, int P, Strides st) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  constexpr int ldw = BT + 1;
  float* Cs = smem;
  float* Bs = Cs + BT * ldn;
  float* Xs = Bs + BT * ldn;
  float* Ws = Xs + BT * P;
  float* sq = Ws + BT * ldw;
  float* sk = sq + BT;
  float* dk = sk + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int cell = blockIdx.x;
  const int h = cell % H;
  const int bc = cell / H;
  const int ci = bc % NC;
  const int bi = bc / NC;
  const int t0 = blockIdx.y * BT;

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
                  td = st.v[kDT][2], tx_ = st.v[kX][2], ty_ = st.v[kY][2];

  for (int idx = tid; idx < BT * N; idx += kThreads) {
    const int i = idx / N, n = idx % N;
    Cs[i * ldn + n] = (t0 + i < Q) ? to_f32(cb[(t0 + i) * tc + n]) : 0.f;
  }
  for (int i = tid; i < BT; i += kThreads)
    sq[i] = (t0 + i < Q) ? to_f32(sb[(t0 + i) * ts]) : 0.f;

  float acc[RT][PJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;

  // causal: keys at or past t0 + BT are masked for every row of the tile
  const int k_end = min(Q, t0 + BT);
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous key tile is consumed (and Cs is stored)
    for (int idx = tid; idx < BT * N; idx += kThreads) {
      const int j = idx / N, n = idx % N;
      Bs[j * ldn + n] = (k0 + j < Q) ? to_f32(bb[(k0 + j) * tb + n]) : 0.f;
    }
    for (int idx = tid; idx < BT * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      Xs[idx] = (k0 + j < Q) ? to_f32(xb[(k0 + j) * tx_ + p]) : 0.f;
    }
    for (int j = tid; j < BT; j += kThreads) {
      const bool in = k0 + j < Q;
      sk[j] = in ? to_f32(sb[(k0 + j) * ts]) : 0.f;
      dk[j] = in ? to_f32(db[(k0 + j) * td]) : 0.f;
    }
    __syncthreads();

    // W[t][tau] = (C_t . B_tau) * exp(max(s_t - s_tau, -60)) * dt_tau
    float dot[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) dot[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float av[RT], bv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) av[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
      for (int j = 0; j < RT; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) dot[i][j] = fmaf(av[i], bv[j], dot[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int col = tx + 16 * j;
        float w = 0.f;  // tau > t: exactly 0, as in the reference
        if (k0 + col <= t0 + r) {
          const float seg = sq[r] - sk[col];
          w = __fmul_rn(__fmul_rn(dot[i][j], expf(fmaxf(seg, kNegClip))), dk[col]);
        }
        Ws[r * ldw + col] = w;
      }
    }
    __syncthreads();

    // y[t] += sum_tau W[t][tau] * x[tau]
    const int kn = min(BT, k_end - k0);
    for (int j = 0; j < kn; ++j) {
      float wv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) wv[i] = Ws[(ty + 16 * i) * ldw + j];
#pragma unroll
      for (int q = 0; q < PJ; ++q) {
        const int p = tx + 16 * q;
        const float xv = (p < P) ? Xs[j * P + p] : 0.f;
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][q] = fmaf(wv[i], xv, acc[i][q]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= Q) continue;
#pragma unroll
    for (int q = 0; q < PJ; ++q) {
      const int p = tx + 16 * q;
      if (p < P) yb[t * ty_ + p] = from_f32<T>(acc[i][q]);
    }
  }
}

template <int PJ, typename T>
cudaError_t launch(const void* c, const void* b, const void* s, const void* dt,
                   const void* x, void* y, int B, int NC, int Q, int H, int N,
                   int P, const Strides& st, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<PJ, T>;
  const size_t bytes = smem_bytes(N, P);
  // past 48 KB a launch needs the opt-in, which CUDA keeps per device: set
  // it on every such launch rather than cache it for the process
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)((long long)B * NC * H), (Q + BT - 1) / BT);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(c), static_cast<const T*>(b),
      static_cast<const T*>(s), static_cast<const T*>(dt),
      static_cast<const T*>(x), static_cast<T*>(y), NC, Q, H, N, P, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const void* c, const void* b, const void* s,
                       const void* dt, const void* x, void* y, int B, int NC,
                       int Q, int H, int N, int P, const Strides& st,
                       cudaStream_t stream) {
  if (P <= 32) return launch<2, T>(c, b, s, dt, x, y, B, NC, Q, H, N, P, st, stream);
  if (P <= 64) return launch<4, T>(c, b, s, dt, x, y, B, NC, Q, H, N, P, st, stream);
  return launch<8, T>(c, b, s, dt, x, y, B, NC, Q, H, N, P, st, stream);
}

}  // namespace

// strides: 24 int64 element strides, (batch, chunk, t, head) for c, b, s,
// dt, x, y in that order. 1 <= N, P <= 128 (kernel.py: MAX_DIM), Q >= 1 and
// B * NC * H in 1 .. 2**31 - 1. Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for sizes outside that range.
extern "C" int ssd_scan_launch(const void* c, const void* b, const void* s,
                               const void* dt, const void* x, void* y, int B,
                               int NC, int Q, int H, int N, int P,
                               const void* strides, int is_bf16,
                               void* stream) {
  const long long cells = (long long)B * NC * H;
  if (N < 1 || N > kMaxDim || P < 1 || P > kMaxDim || Q < 1 || cells < 1 ||
      cells > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Strides st;
  const long long* src = static_cast<const long long*>(strides);
  for (int k = 0; k < kTensors; ++k)
    for (int d = 0; d < 4; ++d) st.v[k][d] = src[k * 4 + d];
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_p<__nv_bfloat16>(c, b, s, dt, x, y, B, NC, Q, H, N, P, st,
                                     stream_);
  return dispatch_p<float>(c, b, s, dt, x, y, B, NC, Q, H, N, P, st, stream_);
}
