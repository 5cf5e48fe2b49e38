// Fused SwiGLU matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/swiglu_matmul.py::swiglu_matmul
// (body `_kernel`): out = silu(x @ wg) * (x @ wu) for x [M, D] and wg, wu
// [D, F], two f32 accumulators, the epilogue g / (1 + exp(-g)) * u fused and
// cast once to the input type, so the [M, F] gate and up products never reach
// device memory.
//
// What bounds it on this card: in decode (M = 8 slot rows, D = 2048,
// F = 5632) it does 8 operations per weight element read, far below the
// card's ~295 operations per byte in bf16: it is bound by the bytes of wg and
// wu (46 MB in bf16).  In prefill (M = prompt length, hundreds of rows) it is
// bound by operations.  This first kernel computes in f32 on the CUDA cores,
// so at prefill shapes it runs far from the bf16 tensor-core bound; a
// wgmma/TMA design is later work.
//
// What the design does about it: each block computes one [BM, BN] tile of
// both products from one shared x tile and the matching wg and wu tiles, so x
// is loaded once for both GEMMs (as in the TPU kernel) and every weight
// element is read from device memory once per row tile.  Each thread keeps a
// TM x TN register block of both accumulators.  Small M (decode) takes a
// narrow tile (BM = 16, BN = 32) so that F / 32 = 176 blocks cover the 132
// SMs and stream the weights in parallel; large M takes 64 x 64 tiles.  Loads
// from device memory are coalesced along the contiguous axis (D for x, F for
// the weights); ragged edges are masked, so any M, D, F are accepted.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) swiglu_kernel(
    const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
    T* __restrict__ out, int M, int D, int F) {
  constexpr int NTX = BN / TN;  // threads along F
  constexpr int NTY = BM / TM;  // threads along M
  constexpr int NT = NTX * NTY;
  __shared__ float xs[BK][BM + 1];  // x tile, transposed; padded against bank conflicts
  __shared__ float gs[BK][BN];
  __shared__ float us[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % NTX, ty = tid / NTX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float accg[TM][TN], accu[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) accg[i][j] = accu[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, kk = i % BK;  // consecutive threads: consecutive k
      const int m = m0 + r, kd = k0 + kk;
      xs[kk][r] = (m < M && kd < D) ? to_f32(x[(long long)m * D + kd]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, c = i % BN;  // consecutive threads: consecutive f
      const int kd = k0 + kk, n = n0 + c;
      const bool in = kd < D && n < F;
      const long long g = (long long)kd * F + n;
      gs[kk][c] = in ? to_f32(wg[g]) : 0.f;
      us[kk][c] = in ? to_f32(wu[g]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bg[TN], bu[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + NTY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bg[j] = gs[kk][tx + NTX * j];
        bu[j] = us[kk][tx + NTX * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          accg[i][j] = fmaf(a[i], bg[j], accg[i][j]);
          accu[i][j] = fmaf(a[i], bu[j], accu[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + NTY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + NTX * j;
      if (n >= F) continue;
      const float g = accg[i][j];
      store(out + (long long)m * F + n, g / (1.f + expf(-g)) * accu[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x, const void* wg, const void* wu, void* out, int M, int D, int F,
           cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(out), M, D, F);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_m(const void* x, const void* wg, const void* wu, void* out, int M, int D, int F,
               cudaStream_t stream) {
  if (M <= 16) return launch<T, 16, 32, 32, 2, 1>(x, wg, wu, out, M, D, F, stream);
  return launch<T, 64, 64, 16, 4, 4>(x, wg, wu, out, M, D, F, stream);
}

}  // namespace

// x: [M, D]; wg, wu: [D, F]; out: [M, F]; contiguous; dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int swiglu_matmul_fwd(const void* x, const void* wg, const void* wu, void* out,
                                 int M, int D, int F, int dtype, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_m<float>(x, wg, wu, out, M, D, F, s);
  if (dtype == 1) return dispatch_m<__nv_bfloat16>(x, wg, wu, out, M, D, F, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* swiglu_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
