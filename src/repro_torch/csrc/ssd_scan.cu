// Chunked Mamba-2 SSD scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (body
// `_kernel`): for each (batch·head) sequence of x [S, P], dt [S], A (a
// scalar), B, C [S, N], the selective-scan recurrence
//     h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// in its chunked dual form.  Per chunk of Q positions, with cs = cumsum(dt·A):
//     y   = (C B^T ∘ L)(dt·x) + exp(cs) ∘ (C h^T),   L_ij = exp(cs_i - cs_j), i >= j
//     h  <- exp(cs_Q) h + (x ∘ w)^T B,               w_j = exp(cs_Q - cs_j) dt_j
// with the f32 state h [P, N] carried from chunk to chunk.  y is written in
// x's dtype; the final state, on request, in f32.
//
// What bounds it on this card: at the serving path's prefill shape
// (BH = 32 heads, S = 1024, P = 64, N = 128, bf16) it moves ~26 MB (x, dt, B
// and C after the group broadcast, y, the final state): ~7.9 us at 3.35 TB/s.
// Its chunked form does ~1.3 GFLOP at Q = 32, ~1.3 us at the bf16 tensor-core
// peak, so it is bound by bytes.  This first kernel computes in f32 on the
// CUDA cores (~20 us for those operations at the 67 TFLOP/s f32 peak) and
// reads B and C once per P-tile; tensor cores (wgmma) for C·B^T and
// (C·B^T∘L)·x, and TMA loads, are later work.
//
// What the design does about it:
// - The TPU kernel carries h in VMEM across a sequential chunk axis of its
//   grid.  CUDA blocks run in no order, so one block walks all chunks of its
//   sequence in order, with h in registers (and a copy in shared memory).
// - Filling the card: rows p of h evolve independently; only cs, L and C·B^T
//   are shared across p.  The grid is (bh, P-tile of 16 rows): 32 heads × 4
//   tiles = 128 blocks on the 132 SMs at a batch-1 prefill, at the cost of
//   computing C·B^T once per P-tile.
// - Chunk length Q = 32 (one warp-wide scan for cs): per position the
//   chunked form costs Q·N for C·B^T plus P·N for each of C·h and the state
//   update, so a short chunk does less work than the TPU's 256; the chunks
//   are sequential anyway inside the block.
// - Each chunk's x, dt, B and C are loaded from device memory into registers
//   while the previous chunk computes, then stored to shared memory (f32,
//   rows padded by 4 floats against bank conflicts; ~60 KB of dynamic
//   shared memory at N = 128).
// - Every exponent is of a non-positive number (cs_i - cs_j for i >= j, cs,
//   cs_Q - cs_j), so nothing overflows.  Positions past S are masked inside
//   the kernel with dt = 0, which leaves y and h unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int Q = 32;     // chunk length: one warp-wide scan
constexpr int PT = 16;    // rows of h (head dim p) per block
constexpr int NT = 256;   // threads per block
constexpr int NMAX = 128; // largest state width N
constexpr int BC_PER_THREAD = Q * NMAX / NT;  // B (and C) elements a thread stages
constexpr int X_PER_THREAD = Q * PT / NT;
constexpr int H_PER_THREAD = PT / (NT / 128); // rows of h a thread owns (8)
static_assert(Q == 32, "the chunk's cumsum is one warp-wide scan");
static_assert(PT == 16 && NT == 256, "thread mappings below assume 16 rows and 256 threads");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One chunk's operands, staged in registers on their way to shared memory.
struct Staged {
  float b[BC_PER_THREAD], c[BC_PER_THREAD], x[X_PER_THREAD], dt;
};

template <typename T>
__device__ __forceinline__ void load_chunk(Staged& st, const T* __restrict__ x,
                                           const float* __restrict__ dt,
                                           const T* __restrict__ B, const T* __restrict__ C,
                                           long long bh, int t0, int p0, int S, int P, int N) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < BC_PER_THREAD; ++k) {
    const int e = tid + NT * k;
    const int r = e / N, col = e - r * N;
    const bool in = e < Q * N && t0 + r < S;
    const long long g = (bh * S + t0 + r) * N + col;
    st.b[k] = in ? to_f32(B[g]) : 0.f;
    st.c[k] = in ? to_f32(C[g]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < X_PER_THREAD; ++k) {
    const int e = tid + NT * k;
    const int r = e / PT, p = p0 + e % PT;
    st.x[k] = (t0 + r < S && p < P) ? to_f32(x[(bh * S + t0 + r) * P + p]) : 0.f;
  }
  st.dt = (tid < Q && t0 + tid < S) ? dt[bh * S + t0 + tid] : 0.f;
}

// grid (BH, ceil(P / PT)), NT threads, dynamic shared memory (smem_floats(N) floats)
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, const T* __restrict__ C, T* __restrict__ y,
    float* __restrict__ h_out, int S, int P, int N) {
  extern __shared__ float4 smem4[];
  const int NS = N + 4;  // padded row of B, C and h
  float* Bs = reinterpret_cast<float*>(smem4);  // [Q][NS]
  float* Cs = Bs + Q * NS;                       // [Q][NS]
  float* hs = Cs + Q * NS;                       // [2][PT][NS]: h before / after a chunk
  float* xs = hs + 2 * PT * NS;                  // [Q][PT]
  float* xw = xs + Q * PT;                       // [Q][PT]: x_j * w_j
  float* Ss = xw + Q * PT;                       // [Q][Q+1]: (C B^T ∘ L)_ij dt_j
  float* cs = Ss + Q * (Q + 1);                  // [Q]
  float* ecs = cs + Q;                           // [Q]: exp(cs_i)
  float* wv = ecs + Q;                           // [Q]: exp(cs_Q - cs_j) dt_j
  float* dts = wv + Q;                           // [Q]
  float* etot = dts + Q;                         // [1]: exp(cs_Q)

  const int tid = threadIdx.x;
  const long long bh = blockIdx.x;
  const int p0 = blockIdx.y * PT;
  const float a = A[bh];
  const int nchunks = (S + Q - 1) / Q;

  // C·B^T and y: row i of the chunk; C·B^T columns tj + 8m, y rows p0 + pp, + 8
  const int i = tid >> 3, tj = tid & 7, pp = tid & 7;
  // state: thread owns h[pg*8 + k][n] for k < 8
  const int n = tid & 127, pg = tid >> 7;
  float hr[H_PER_THREAD];
#pragma unroll
  for (int k = 0; k < H_PER_THREAD; ++k) hr[k] = 0.f;
  for (int e = tid; e < PT * NS; e += NT) hs[e] = 0.f;

  Staged st;
  load_chunk(st, x, dt, B, C, bh, 0, p0, S, P, N);

  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Q;
    const float* hcur = hs + (c & 1) * PT * NS;
    float* hnext = hs + ((c + 1) & 1) * PT * NS;

    // 1. staged operands -> shared memory
#pragma unroll
    for (int k = 0; k < BC_PER_THREAD; ++k) {
      const int e = tid + NT * k;
      if (e < Q * N) {
        const int r = e / N, col = e - r * N;
        Bs[r * NS + col] = st.b[k];
        Cs[r * NS + col] = st.c[k];
      }
    }
#pragma unroll
    for (int k = 0; k < X_PER_THREAD; ++k) xs[tid + NT * k] = st.x[k];
    if (tid < Q) dts[tid] = st.dt;
    __syncthreads();

    // 2. the next chunk's loads are in flight while this one computes
    if (c + 1 < nchunks) load_chunk(st, x, dt, B, C, bh, t0 + Q, p0, S, P, N);

    // 3. cs = cumsum(dt·A) in warp 0; C·B^T for this thread's 4 entries
    if (tid < 32) {
      const float d = dts[tid];
      float v = d * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += u;
      }
      const float total = __shfl_sync(0xffffffffu, v, 31);
      cs[tid] = v;
      ecs[tid] = expf(v);
      wv[tid] = expf(total - v) * d;
      if (tid == 0) etot[0] = expf(total);
    }
    float cb[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const float4* ci = reinterpret_cast<const float4*>(Cs + i * NS);
#pragma unroll 4
      for (int n4 = 0; n4 < N / 4; ++n4) {
        const float4 cv = ci[n4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          cb[m] = dot4(cv, reinterpret_cast<const float4*>(Bs + (tj + 8 * m) * NS)[n4], cb[m]);
      }
    }
    __syncthreads();

    // 4. S_ij = (C B^T)_ij exp(cs_i - cs_j) dt_j below the diagonal; x·w
    {
      const float csi = cs[i];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = tj + 8 * m;
        Ss[i * (Q + 1) + j] = j <= i ? cb[m] * expf(csi - cs[j]) * dts[j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < X_PER_THREAD; ++k) {
        const int e = tid + NT * k;
        xw[e] = xs[e] * wv[e / PT];
      }
    }
    __syncthreads();

    // 5. y_i = sum_j S_ij x_j + exp(cs_i) C_i · h  (h as it was before the chunk)
    {
      float y0 = 0.f, y1 = 0.f;
#pragma unroll 8
      for (int j = 0; j < Q; ++j) {
        const float s = Ss[i * (Q + 1) + j];
        y0 = fmaf(s, xs[j * PT + pp], y0);
        y1 = fmaf(s, xs[j * PT + pp + 8], y1);
      }
      float o0 = 0.f, o1 = 0.f;
      const float4* ci = reinterpret_cast<const float4*>(Cs + i * NS);
      const float4* h0 = reinterpret_cast<const float4*>(hcur + pp * NS);
      const float4* h1 = reinterpret_cast<const float4*>(hcur + (pp + 8) * NS);
#pragma unroll 4
      for (int n4 = 0; n4 < N / 4; ++n4) {
        const float4 cv = ci[n4];
        o0 = dot4(cv, h0[n4], o0);
        o1 = dot4(cv, h1[n4], o1);
      }
      const float e = ecs[i];
      const int t = t0 + i;
      if (t < S) {
        T* yrow = y + (bh * S + t) * P;
        if (p0 + pp < P) store(yrow + p0 + pp, fmaf(e, o0, y0));
        if (p0 + pp + 8 < P) store(yrow + p0 + pp + 8, fmaf(e, o1, y1));
      }
    }

    // 6. h <- exp(cs_Q) h + sum_j (x_j w_j) B_j, into the other h buffer
    if (n < N) {
      const float et = etot[0];
#pragma unroll
      for (int k = 0; k < H_PER_THREAD; ++k) hr[k] *= et;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float b = Bs[j * NS + n];
        const float4 w0 = reinterpret_cast<const float4*>(xw + j * PT + pg * 8)[0];
        const float4 w1 = reinterpret_cast<const float4*>(xw + j * PT + pg * 8)[1];
        hr[0] = fmaf(w0.x, b, hr[0]);
        hr[1] = fmaf(w0.y, b, hr[1]);
        hr[2] = fmaf(w0.z, b, hr[2]);
        hr[3] = fmaf(w0.w, b, hr[3]);
        hr[4] = fmaf(w1.x, b, hr[4]);
        hr[5] = fmaf(w1.y, b, hr[5]);
        hr[6] = fmaf(w1.z, b, hr[6]);
        hr[7] = fmaf(w1.w, b, hr[7]);
      }
#pragma unroll
      for (int k = 0; k < H_PER_THREAD; ++k) hnext[(pg * 8 + k) * NS + n] = hr[k];
    }
    __syncthreads();
  }

  if (h_out != nullptr && n < N) {
#pragma unroll
    for (int k = 0; k < H_PER_THREAD; ++k) {
      const int p = p0 + pg * 8 + k;
      if (p < P) h_out[(bh * P + p) * N + n] = hr[k];
    }
  }
}

size_t smem_bytes(int N) {
  const int NS = N + 4;
  return sizeof(float) * (size_t)(2 * Q * NS + 2 * PT * NS + 2 * Q * PT + Q * (Q + 1) + 4 * Q + 4);
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* h_out, int BH, int S, int P, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BH, (P + PT - 1) / PT);
  ssd_scan_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(h_out), S, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [BH, S, P]; dt: [BH, S] f32; A: [BH] f32; B, C: [BH, S, N]; y: [BH, S, P];
// h_out: [BH, P, N] f32 or null; all contiguous; x, B, C, y of one dtype
// (0 = f32, 1 = bf16); N a multiple of 4, at most 128.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* h_out, int BH, int S, int P, int N,
                            int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0 || N > NMAX || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, dt, A, B, C, y, h_out, BH, S, P, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dt, A, B, C, y, h_out, BH, S, P, N, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
