// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`): softmax(q k^T * scale) v over [BH, S, D] with an online
// (streaming) softmax, an optional causal mask offset by Sk - Sq, the finite
// -1e30 mask value, f32 running max / denominator / accumulator, and the
// output cast to the input type.
//
// What bounds it on this card: at the serving path's prefill shapes (32 heads,
// S up to 1024, D = 64) the work is ~4*S*S*D/2 operations per head against
// 4*S*D elements moved, i.e. hundreds of operations per byte: it is bound by
// operations.  This first kernel computes in f32 on the CUDA cores (no tensor
// cores), so it runs far from the bf16 tensor-core bound; a wgmma/TMA design
// is later work.
//
// What the design does about it: the TPU kernel's sequential KV grid axis
// (scratch carried across grid steps) becomes a loop inside one thread block
// per (bh, 64-row q tile).  Q stays in shared memory for the whole loop; each
// 64-key K/V tile is staged once in shared memory and reused by all 64 query
// rows, so device memory is read ~once per q tile.  Scores and P·V are
// register-blocked (each of the 256 threads owns a 4 x 4 score block and a
// 4 x D/16 accumulator block) so every shared-memory load feeds several FMAs.
// KV tiles lying wholly above the causal diagonal are skipped (the TPU
// kernel's docstring allows it): every key in them is masked for every row of
// the block, so they add exactly zero.  Sequence ends that are not a multiple
// of the tile are masked inside the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per staged K/V tile
constexpr int NT = 256;   // threads per block, a 16 x 16 grid
constexpr float NEG_INF = -1e30f;  // the reference's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
constexpr size_t smem_floats() {
  // q [BQ][DMAX], k [BK][DMAX+1], v [BK][DMAX], p [BQ][BK+1], m/l/alpha [BQ]
  return (size_t)BQ * DMAX + (size_t)BK * (DMAX + 1) + (size_t)BK * DMAX +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int D, float scale, int causal) {
  constexpr int DC = DMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][DMAX]
  float* ks = qs + BQ * DMAX;              // [BK][DMAX + 1], padded: no bank conflicts
  float* vs = ks + BK * (DMAX + 1);        // [BK][DMAX]
  float* ps = vs + BK * DMAX;              // [BQ][BK + 1]
  float* row_m = ps + BQ * (BK + 1);       // running max
  float* row_l = row_m + BQ;               // running denominator
  float* row_alpha = row_l + BQ;           // this tile's rescale factor

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const long long qbase = (long long)bh * Sq * D;
  const long long kbase = (long long)bh * Sk * D;
  const int off = Sk - Sq;  // aligns the diagonals when Sq != Sk

  for (int i = tid; i < BQ * DMAX; i += NT) {
    const int r = i / DMAX, d = i % DMAX;
    qs[i] = (q0 + r < Sq && d < D) ? to_f32(q[qbase + (long long)(q0 + r) * D + d]) : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal && off >= 0) {
    // keys past the block's last row (shifted by off) are masked for every row
    const int last_row = min(q0 + BQ, Sq) - 1;
    n_tiles = min(n_tiles, (last_row + off) / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of ks / vs / ps are done
    for (int i = tid; i < BK * DMAX; i += NT) {
      const int r = i / DMAX, d = i % DMAX;
      const bool in = (k0 + r < Sk) && d < D;
      const long long g = kbase + (long long)(k0 + r) * D + d;
      ks[r * (DMAX + 1) + d] = in ? to_f32(k[g]) : 0.f;
      vs[r * DMAX + d] = in ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DMAX + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * (DMAX + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = s[i][j] * scale;
        if (causal && kpos > q0 + r + off) val = NEG_INF;
        if (kpos >= Sk) val = -INFINITY;  // past the end: not a key at all
        ps[r * (BK + 1) + c] = val;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8 w .. 8 w + 7
#pragma unroll
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* prow = ps + r * (BK + 1);
      const float x0 = prow[lane], x1 = prow[lane + 32];
      const float m_prev = row_m[r];
      const float m_cur = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_cur), p1 = expf(x1 - m_cur);
      const float sum = warp_sum(p0 + p1);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], b[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) b[j] = vs[kk * DMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();  // final row_l visible to every thread

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = row_l[r];
    T* orow = o + qbase + (long long)(q0 + r) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] / l);
    }
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
           int sk, int d, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<DMAX>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DMAX><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq,
               int sk, int d, float scale, int causal, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, bh, sq, sk, d, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: [bh, sq, d]; k, v: [bh, sk, d]; contiguous; dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int sq, int sk, int d, float scale,
                                   int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
