// W8A8 GEMM for Hopper (sm_90a): out = (x_q @ w_q) * x_scale[:, None] * w_scale[None, :]
//
// Replaces the TPU kernel src/repro/kernels/matmul_int8/kernel.py:
// _matmul_kernel / matmul_int8 (Pallas grid (M/bm, N/bn, K/bk) with an int32
// VMEM accumulator carried across the sequential K grid axis).
//
// What bounds it on an H100: at the executor's decode shapes (M = 128
// tokens against K x N weights of 16 MB to 620 MB) every weight byte is
// used by only M = 128 rows, about 256 int8 operations per byte, well under
// the ~590 operations per byte where the int8 tensor cores would become the
// limit. So the kernel is bound by reading w_q once from device memory.
//
// Design, simple first:
//   * one CTA of 256 threads per (BM x BN) output tile; a loop over K in BK
//     steps replaces the TPU's sequential K grid axis (CTAs run in parallel
//     and in no order, so nothing is carried between them);
//   * the int8 x tile is staged in shared memory as [m][k], the w tile
//     transposed to [n][k], so 4 consecutive k of either operand form one
//     32-bit word for __dp4a; rows are padded by 4 bytes so the 16 threads
//     of a half-warp hit 16 different banks;
//   * each thread owns a (BM/16) x (BN/16) micro-tile of int32 accumulators
//     in registers (strided by 16 so global stores coalesce);
//   * ragged M, N and K edges are masked on load (zero fill adds 0 to the
//     int32 sums) and on store, so no padding is needed;
//   * the epilogue multiplies (float(acc) * x_scale[m]) * w_scale[n] in the
//     plain version's order, with round-to-nearest and no contraction, and
//     stores float32 or bfloat16.
// Tensor cores (mma.sync / wgmma) and TMA pipelining are later work: this
// kernel runs on the int32 dp4a path of the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
matmul_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   void* __restrict__ out, int M, int N, int K, int out_bf16,
                   int x_vec, int w_vec) {
  static_assert(BM % 16 == 0 && BN % 16 == 0 && BK % 16 == 0, "tile");
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LD = BK + 4;  // padded row length in bytes (stays 4-aligned)
  __shared__ __align__(16) int8_t As[BM * LD];
  __shared__ __align__(16) int8_t Bs[BN * LD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: BM rows of BK bytes, in 16-byte chunks
    for (int c = tid; c < BM * (BK / 16); c += kThreads) {
      const int r = c / (BK / 16);
      const int kc = (c % (BK / 16)) * 16;
      const int gm = m0 + r;
      const int gk = k0 + kc;
      int* dst = reinterpret_cast<int*>(&As[r * LD + kc]);
      if (x_vec && gm < M && gk + 16 <= K) {
        const int4 v = *reinterpret_cast<const int4*>(x + (size_t)gm * K + gk);
        dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
      } else {
        for (int e = 0; e < 16; ++e)
          As[r * LD + kc + e] =
              (gm < M && gk + e < K) ? x[(size_t)gm * K + gk + e] : int8_t(0);
      }
    }
    // w tile: BK rows of BN bytes, stored transposed as Bs[n][k]
    for (int c = tid; c < BK * (BN / 16); c += kThreads) {
      const int r = c / (BN / 16);
      const int nc = (c % (BN / 16)) * 16;
      const int gk = k0 + r;
      const int gn = n0 + nc;
      int4 chunk;
      int8_t* v = reinterpret_cast<int8_t*>(&chunk);
      if (w_vec && gk < K && gn + 16 <= N) {
        chunk = *reinterpret_cast<const int4*>(w + (size_t)gk * N + gn);
      } else {
        for (int e = 0; e < 16; ++e)
          v[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e] : int8_t(0);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) Bs[(nc + e) * LD + r] = v[e];
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const int*>(&As[(ty + 16 * i) * LD + kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const int*>(&Bs[(tx + 16 * j) * LD + kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    const float sx = xs[gm];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sx), ws[gn]);
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[(size_t)gm * N + gn] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[(size_t)gm * N + gn] = v;
    }
  }
}

template <int BM, int BN, int BK>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* xs,
                   const float* ws, void* out, int M, int N, int K,
                   int out_bf16, cudaStream_t stream) {
  // 16-byte loads need every row of the operand to start 16-byte aligned:
  // the base pointer (a view may carry any offset) and the row length
  const bool x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 16 == 0;
  const bool w_vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_int8_kernel<BM, BN, BK><<<grid, kThreads, 0, stream>>>(
      x, w, xs, ws, out, M, N, K, out_bf16, x_vec, w_vec);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t dispatch_bk(int bk, const int8_t* x, const int8_t* w,
                        const float* xs, const float* ws, void* out, int M,
                        int N, int K, int out_bf16, cudaStream_t s) {
  switch (bk) {
    case 32: return launch<BM, BN, 32>(x, w, xs, ws, out, M, N, K, out_bf16, s);
    case 64: return launch<BM, BN, 64>(x, w, xs, ws, out, M, N, K, out_bf16, s);
    case 128: return launch<BM, BN, 128>(x, w, xs, ws, out, M, N, K, out_bf16, s);
  }
  return cudaErrorInvalidValue;
}

template <int BM>
cudaError_t dispatch_bn(int bn, int bk, const int8_t* x, const int8_t* w,
                        const float* xs, const float* ws, void* out, int M,
                        int N, int K, int out_bf16, cudaStream_t s) {
  switch (bn) {
    case 32: return dispatch_bk<BM, 32>(bk, x, w, xs, ws, out, M, N, K, out_bf16, s);
    case 64: return dispatch_bk<BM, 64>(bk, x, w, xs, ws, out, M, N, K, out_bf16, s);
    case 128: return dispatch_bk<BM, 128>(bk, x, w, xs, ws, out, M, N, K, out_bf16, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Tile set: bm in {16, 32, 64, 128}, bn in {32, 64, 128}, bk in {32, 64, 128}
// (kernel.py: BM_TILES, BN_TILES, BK_TILES). Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a tile outside the set.
extern "C" int matmul_int8_launch(const void* x, const void* w, const void* xs,
                                  const void* ws, void* out, int M, int N,
                                  int K, int bm, int bk, int bn, int out_bf16,
                                  void* stream) {
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sx = static_cast<const float*>(xs);
  const float* sw = static_cast<const float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16: return dispatch_bn<16>(bn, bk, xq, wq, sx, sw, out, M, N, K, out_bf16, s);
    case 32: return dispatch_bn<32>(bn, bk, xq, wq, sx, sw, out, M, N, K, out_bf16, s);
    case 64: return dispatch_bn<64>(bn, bk, xq, wq, sx, sw, out, M, N, K, out_bf16, s);
    case 128: return dispatch_bn<128>(bn, bk, xq, wq, sx, sw, out, M, N, K, out_bf16, s);
  }
  return cudaErrorInvalidValue;
}
