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
// x's dtype; the final state, on request, in f32.  Two forward variants, one
// C entry point each; the wrapper (kernels/ssd_scan.py::select_variant) picks
// one from (P, N, dtype); the backward of the first is the third entry.  Every exponent is of a non-positive number (cs_i - cs_j
// for i >= j, cs, cs_Q - cs_j), so nothing overflows; positions past S are
// masked with dt = 0, which leaves y and h unchanged.
//
// What bounds it on this card: at mamba2-370m's prefill (32 heads, S = 1024,
// P = 64, N = 128, one group, bf16) the scan needs the bytes of x, y, B and C
// of the one group, dt and the final state: 10.1 MB in the mixer's layout,
// ~3.0 us at 3.35 TB/s (26 MB, ~7.9 us, on flat [BH, S, *] operands with B and
// C per head).  Its chunked form does ~1.3 GFLOP, ~1.3 us at the bf16
// tensor-core peak: it is bound by bytes.
//
// 1. `wgmma` (entry ssd_scan_wgmma_fwd): bf16, P = 64, N a multiple of 16 up
//    to 128, on the mixer's own layout by strides (x [batch, S, H, P], dt
//    [batch, S, H], B and C [batch, S, G, N], head h reading group h / (H/G)),
//    so the model's conv-output views go in uncopied.  The TPU kernel's
//    sequential chunk axis becomes three kernels that are parallel over
//    chunks of Q = 64 (one wgmma M tile), with only the f32 state recurrence
//    sequential, on PyTorch's stream:
//    - chunk_state, grid (chunk, batch·H): cs by two warp scans; s_c =
//      (x∘w)^T B on wgmma m64n(64|128)k16 (A from registers, B MN-major);
//    - state_pass, grid (blocks of P·N, batch·H): h_{c+1} = exp(cs_Q) h_c + s_c,
//      loads of 16 chunks in flight before their chain of FMAs; it leaves the
//      state each chunk starts from in the scratch, and the final state;
//    - chunk_scan, grid (chunk, batch·H): y^T = exp(cs) ∘ (h C^T) + x^T S^T
//      with S = C B^T ∘ L ∘ dt, computed transposed so that h enters as
//      register A fragments and S, split, takes the B tile's shared memory.
//      (Untransposed, with S in registers and h split into K-major shared
//      memory, a CTA needed 75 KB: 3 CTAs an SM, 1.3 waves of 512 CTAs.
//      Transposed it needs 42 KB: 4 an SM, one wave.)
//    x, B and C tiles come by 4-D TMA (128-byte swizzle, zero fill past S)
//    on an mbarrier; the scratch keeps each state in the wgmma accumulator's
//    register order, so phase 3 reads h as its A fragments with coalesced
//    loads.  At the path shape that is 32 × 16 = 512 CTAs a phase, against
//    128 blocks walking 32 chunks in series before.  Numerics: C·B^T reads
//    bf16 inputs and is exact on the tensor cores; the f32 operands x∘w, S
//    and h enter as bf16 pairs hi + lo (two MMAs into one f32 accumulator),
//    since a single bf16 or TF32 rounding misses the y or state tolerance
//    (PERF.md).  Phases 2 and 3 are launched with programmatic dependent
//    launch: each starts while the one before drains, and waits
//    (griddepcontrol.wait) only where it reads that phase's results.  One
//    call of the wrapper counts as one launch of the variant.
// 2. `ssd_scan_kernel` (entry ssd_scan_fwd, `cuda_core`): f32, and every
//    other shape (N a multiple of 4 up to 128), on flat contiguous [BH, S, *]
//    operands.  The TPU grid's sequential chunk axis as a loop inside one
//    block per (bh, 16-row P tile): 32 heads × 4 tiles = 128 blocks at a
//    batch-1 prefill; chunks of 32 (one warp-wide scan for cs); h in registers
//    and double-buffered shared memory; the next chunk's operands prefetched
//    into registers; f32 products on the CUDA cores.
//
// 3. `wgmma_bwd` (entry ssd_scan_wgmma_bwd): the backward of `wgmma`, on the
//    same layout.  The Pallas kernel has no VJP (the reference trains through
//    _ssd_chunked, which XLA differentiates), so this replaces no TPU kernel:
//    it computes what jax.vjp of _ssd_chunked gives, (dx, ddt, dA, dB, dC) at
//    the cotangents dy and dh_final, where kernels/ssd_scan.py::ssd_scan_vjp
//    (its plain version) computes it in eager PyTorch.  Six kernels, one
//    count: the forward's chunk_state and state_pass recompute the
//    chunk-start states h0 (recomputed rather than saved: a saved scratch
//    would keep 67 MB a layer and microbatch alive at mamba2's train shape
//    without remat; recomputed, one backward's scratch is alive at a time);
//    chunk_state<REV> and state_pass_bwd carry the state cotangent dh1 from
//    the last chunk to the first; chunk_grad computes every gradient of one
//    (chunk, head) in ~116 m64n64k16 products (f32 operands as hi + lo
//    pairs, as in the forward; ref.ssd_scan_bwd_phases emulates it); and
//    grad_reduce sums dB and dC over the heads of a group and dA over
//    chunks, in a fixed order: no float atomics, so two launches give the
//    same bits.  What bounds it: at mamba2's train layout (B 4, S 1024, H 32,
//    N 128, one group) the bytes of x, dy, dx, B, C, dB, dC, dt and ddt, 55.6
//    MB, ~16.6 us at 3.35 TB/s (kernels/ssd_scan.py::work_bwd); the products,
//    ~15.2 GFLOP, ~15.4 us at the bf16 peak: bytes, by a little.  The per-head dB and dC partials
//    (2 x 67 MB written and read there) and the recomputed states are this
//    design's own traffic beyond that bound.
//
// -Xptxas -v (sm_90a, nvcc 12.8), no spills: ssd_chunk_scan_kernel 128 / 113
// registers (N > 64 / N <= 64; launch bounds of 4 CTAs an SM), 42,760 /
// 34,568 bytes of dynamic shared memory; ssd_chunk_state_kernel 122 / 90
// registers, 26,376 / 18,184 bytes; ssd_state_pass_kernel 141 registers;
// ssd_scan_kernel 214 registers, ~60 KB of dynamic shared memory.  The
// backward: ssd_chunk_grad_kernel 255 registers with 24 bytes spilled / 202
// (N > 64 / N <= 64), 121,640 / 88,872 bytes of dynamic shared memory (one /
// two CTAs an SM); ssd_state_pass_bwd_kernel 144, ssd_grad_reduce_kernel 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// ------------------------------------------------------------------------- //
// wgmma variant: three chunk-parallel phases on the tensor cores
// ------------------------------------------------------------------------- //
namespace tc {
using bf16 = __nv_bfloat16;

constexpr int Q = 64;                  // chunk length: one wgmma M tile
constexpr int P = 64;                  // head dim: one 128-byte swizzle atom of bf16
constexpr int ATOM = 64;               // bf16 columns of one swizzle atom
constexpr int TILE = Q * ATOM;         // elements of one [64, 64] atom
constexpr int TILE_BYTES = TILE * 2;   // 8 KB
constexpr int NT = 128;                // one warpgroup per chunk
constexpr int PASS_NT = 256;           // state_pass threads per block
constexpr int PASS_CH = 16;            // chunks whose loads state_pass starts at once

// Element strides of the mixer's layout: x [batch, S, H, P], dt [batch, S, H],
// A [batch, H], B and C [batch, S, G, N], y [batch, S, H, P]; the last dim of
// x, B, C and y is contiguous.
struct Layout {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, a_b, a_h, bc_b, bc_s, bc_g, y_b, y_s, y_h;
};

// element offset of (row r, column c) in a [64, 64] bf16 atom written by TMA
// with 128-byte swizzle: the 16-byte chunk index is XORed with r % 8
__device__ __forceinline__ int swz(int r, int c) {
  return r * ATOM + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// v0, v1 -> bf16 pairs hi = bf16(v), lo = bf16(v - hi): hi + lo keeps ~16
// bits of each f32 operand, which the y and state tolerances need
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = hopper::pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

// one mbarrier for the CTA's TMA loads, initialised before any thread uses it
__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// cs = cumsum(dt·A) over the chunk (dt = 0 past S), and dt, into shared
// memory: two warp-wide scans, the second offset by the first's total.
__device__ __forceinline__ void chunk_cumsum(float* cs, float* dts, const float* __restrict__ dt,
                                             const Layout& L, int b, int h, int t0, int S,
                                             float a) {
  const int tid = threadIdx.x;
  if (tid < Q) {
    const int t = t0 + tid;
    const float d = t < S ? dt[b * L.dt_b + t * L.dt_s + h * L.dt_h] : 0.f;
    float v = d * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if ((tid & 31) >= o) v += u;
    }
    cs[tid] = v;
    dts[tid] = d;
  }
  __syncthreads();
  if (tid >= 32 && tid < Q) cs[tid] += cs[31];
  __syncthreads();
}

// The [P, 64 NA] f32 state of one (bh, chunk) in states[] is kept in the
// order of the wgmma accumulator that phase 1 computes it in: float4 g of
// thread t at (g NT + t), holding that thread's values 4g .. 4g + 3.  Value v
// of thread t (warp w, lane l) is element (16 w + l / 4 + 8 ((v / 2) % 2),
// 8 (v / 4) + 2 (l % 4) + v % 2), and the values of k16 step kk along the
// columns (v in [8 kk, 8 kk + 8)) are exactly the A fragment of that step
// (FA3's identity), so phase 3 reads its A operand h_start as it was
// written: coalesced, with no transpose.  Phase 2 is elementwise.

// Phase 1, grid (chunk, batch·H): the chunk's own contribution to the state,
//   s_c = (x ∘ w)^T B,  w_j = exp(cs_Q - cs_j) dt_j   ([P, N], f32),
// into states[bh, c], and its decay exp(cs_Q) into decay[bh, c].  A is
// (x∘w)^T, built in registers from the swizzled x tile as hi + lo halves;
// B is the chunk's B tile, MN-major.
//
// With REV (the backward's phase 1) the same kernel computes r_c =
// (dy ∘ exp(cs))^T C from the dy and C maps, and writes no decay.
template <int NA, bool REV = false>
__global__ void __launch_bounds__(NT) ssd_chunk_state_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
    const float* __restrict__ dt, const float* __restrict__ A, float* __restrict__ states,
    float* __restrict__ decay, const Layout L, int S, int H, int G, int nch) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* sx = reinterpret_cast<bf16*>(smem_raw + pad);  // [Q][P]
  bf16* sb = sx + TILE;                                // NA atoms [Q][64]
  float* w = reinterpret_cast<float*>(sb + NA * TILE);  // [Q]
  float* cs = w + Q;                                   // [Q]
  float* dts = cs + Q;                                 // [Q]
  uint64_t* bar = reinterpret_cast<uint64_t*>(dts + Q);

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int t0 = c * Q, tid = threadIdx.x;
  hopper::griddep_launch_dependents();
  init_barrier(bar);
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, (1 + NA) * TILE_BYTES);
    hopper::tma_load_4d(sx, &xmap, bar, 0, h, t0, b);
#pragma unroll
    for (int a = 0; a < NA; ++a) hopper::tma_load_4d(sb + a * TILE, &bmap, bar, a * ATOM, g, t0, b);
  }
  chunk_cumsum(cs, dts, dt, L, b, h, t0, S, A[b * L.a_b + h * L.a_h]);
  if (tid < Q) w[tid] = REV ? expf(cs[tid]) : expf(cs[Q - 1] - cs[tid]) * dts[tid];
  if (!REV && tid == 0) decay[(long long)bh * nch + c] = expf(cs[Q - 1]);
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  // A fragments of (x∘w)^T [p, j] for the four k16 steps along j: register r
  // of step kk holds rows p0 + 8 (r & 1), columns 16 kk + 8 (r >> 1) + 2 (lane % 4) + {0, 1}
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = warp * 16 + (lane >> 2);
  uint32_t ahi[4][4], alo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + 8 * (r & 1);
      const int j = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
      split2(__bfloat162float(sx[swz(j, p)]) * w[j], __bfloat162float(sx[swz(j + 1, p)]) * w[j + 1],
             ahi[kk][r], alo[kk][r]);
    }
  }
  float acc[32 * NA];
#pragma unroll
  for (int i = 0; i < 32 * NA; ++i) acc[i] = 0.f;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // B: MN-major [j rows][n], atoms 8 KB apart (LBO), 8-row groups 1024 B apart (SBO)
    const uint64_t db = hopper::wgmma_desc(sb + kk * 16 * ATOM, TILE_BYTES, 1024);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (NA == 2) {
        hopper::wgmma_m64n128k16_rs<1>(acc, half ? alo[kk] : ahi[kk], db, 1);
      } else {
        hopper::wgmma_m64n64k16_rs<1>(acc, half ? alo[kk] : ahi[kk], db, 1);
      }
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();

  float4* out = reinterpret_cast<float4*>(states + ((long long)bh * nch + c) * P * ATOM * NA);
#pragma unroll
  for (int q = 0; q < 8 * NA; ++q)
    out[q * NT + tid] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

// Phase 2, grid (P·64 NA / 4 / PASS_NT, batch·H): the only sequential part.
//   h_0 = 0,  h_{c+1} = decay_c h_c + s_c
// over the chunks, float4 by float4; states[bh, c] (c >= 1) is overwritten
// with h_c, the state chunk c starts from, and h_nch goes to h_out
// ([batch·H, P, N], natural order) if asked.  Each group of PASS_CH chunks
// starts all its loads before the chain of FMAs.
__global__ void __launch_bounds__(PASS_NT) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay, float* __restrict__ h_out,
    int PN4, int N, int nch) {
  const int e = blockIdx.x * PASS_NT + threadIdx.x;
  const long long bh = blockIdx.y;
  hopper::griddep_launch_dependents();
  hopper::griddep_wait();  // phase 1's states and decays
  if (e >= PN4) return;
  float4* st = reinterpret_cast<float4*>(states) + bh * nch * PN4 + e;
  const float* dec = decay + bh * nch;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nch; c0 += PASS_CH) {
    float4 s[PASS_CH];
    float d[PASS_CH];
#pragma unroll
    for (int k = 0; k < PASS_CH; ++k) {
      if (c0 + k < nch) {
        s[k] = st[(long long)(c0 + k) * PN4];
        d[k] = dec[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_CH; ++k) {
      if (c0 + k < nch) {
        if (c0 + k > 0) st[(long long)(c0 + k) * PN4] = h;
        h.x = fmaf(d[k], h.x, s[k].x);
        h.y = fmaf(d[k], h.y, s[k].y);
        h.z = fmaf(d[k], h.z, s[k].z);
        h.w = fmaf(d[k], h.w, s[k].w);
      }
    }
  }
  if (h_out == nullptr) return;
  // float4 g of thread t: (row p0, columns n, n + 1) and (row p0 + 8, the same)
  const int t = e % NT, q = e / NT;
  const int p0 = 16 * (t >> 5) + ((t & 31) >> 2), n = 8 * q + 2 * (t & 3);
  if (n < N) {
    float* o = h_out + bh * P * N;
    *reinterpret_cast<float2*>(o + p0 * N + n) = make_float2(h.x, h.y);
    *reinterpret_cast<float2*>(o + (p0 + 8) * N + n) = make_float2(h.z, h.w);
  }
}

// Phase 3, grid (chunk, batch·H): the chunk's output, computed transposed,
//   y^T = exp(cs) ∘ (h_start C^T) + x^T (C B^T ∘ L ∘ dt)^T,   L_ij = exp(cs_i - cs_j), j <= i
// so that every f32 operand has a cheap home: C B^T (both K-major, shared
// memory) gives S = C B^T ∘ L ∘ dt in registers, which is split into hi + lo
// and stored K-major into the B tile's place (dead once C B^T is done);
// h_start enters as register A fragments, split from phase 2's f32 in
// fragment order (coalesced loads); x^T is the x tile read MN-major.  y^T
// goes through shared memory (C's place) to coalesced 16-byte stores.
template <int NA>
__global__ void __launch_bounds__(NT, 4) ssd_chunk_scan_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap cmap, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ states, bf16* __restrict__ y,
    const Layout L, int S, int H, int G, int nch) {
  constexpr int NB = NA > 2 ? NA : 2;  // the B tile's atoms, later S hi and S lo
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* sc = reinterpret_cast<bf16*>(smem_raw + pad);  // NA atoms [Q][64] of C; then y [Q][P]
  bf16* sb = sc + NA * TILE;                           // NA atoms of B; then S hi, S lo [Q][Q]
  bf16* sx = sb + NB * TILE;                           // [Q][P]
  float* cs = reinterpret_cast<float*>(sx + TILE);     // [Q]
  float* dts = cs + Q;                                 // [Q]
  float* ecs = dts + Q;                                // [Q]: exp(cs)
  uint64_t* bar = reinterpret_cast<uint64_t*>(ecs + Q);

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int t0 = c * Q, tid = threadIdx.x;
  init_barrier(bar);
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, (2 * NA + 1) * TILE_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      hopper::tma_load_4d(sc + a * TILE, &cmap, bar, a * ATOM, g, t0, b);
      hopper::tma_load_4d(sb + a * TILE, &bmap, bar, a * ATOM, g, t0, b);
    }
    hopper::tma_load_4d(sx, &xmap, bar, 0, h, t0, b);
  }
  chunk_cumsum(cs, dts, dt, L, b, h, t0, S, A[b * L.a_b + h * L.a_h]);
  if (tid < Q) ecs[tid] = expf(cs[tid]);
  // all of the above overlaps phase 2; then the start state (chunk 0 starts
  // from 0) is in flight while the tiles land and C B^T runs
  hopper::griddep_wait();
  const float4* hs =
      reinterpret_cast<const float4*>(states + ((long long)bh * nch + c) * P * ATOM * NA) + tid;
  float4 hf[NA][8];  // atom a's float4s; the second atom's are loaded once S is out
  if (c > 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) hf[0][k] = hs[k * NT];
  }
  hopper::mbar_wait(bar, 0);

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  {
    float cb[32];
    hopper::wgmma_fence();
    // C B^T [i, j]: K-major tiles, a k16 step is 32 bytes inside a 128-byte row
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      const int o = (kk >> 2) * TILE + (kk & 3) * 16;
      hopper::wgmma_m64n64k16_ss<0, 0>(cb, hopper::wgmma_desc(sc + o, 16, 1024),
                                       hopper::wgmma_desc(sb + o, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    __syncthreads();  // every warp's reads of the B tile are done

    // S from C B^T, split into hi and lo, into the B tile's place: value v
    // of a thread is row i = r0 + 8 ((v / 2) % 2), column
    // j = 8 (v / 4) + 2 (lane % 4) + v % 2
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int i = r0 + 8 * ((v >> 1) & 1);
      const int j = 8 * (v >> 2) + 2 * (lane & 3);
      const float csi = cs[i];
      const float s0 = j <= i ? cb[v] * expf(csi - cs[j]) * dts[j] : 0.f;
      const float s1 = j + 1 <= i ? cb[v + 1] * expf(csi - cs[j + 1]) * dts[j + 1] : 0.f;
      uint32_t hi, lo;
      split2(s0, s1, hi, lo);
      *reinterpret_cast<uint32_t*>(sb + swz(i, j)) = hi;
      *reinterpret_cast<uint32_t*>(sb + TILE + swz(i, j)) = lo;
    }
  }
  hopper::fence_proxy_async();

  // y^T [p, i]; its value v is (row p = r0 + 8 ((v / 2) % 2), column
  // i = 8 (v / 4) + 2 (lane % 4) + v % 2)
  float yt[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yt[i] = 0.f;
  if (c > 0) {
#pragma unroll
    for (int a = 1; a < NA; ++a)
#pragma unroll
      for (int k = 0; k < 8; ++k) hf[a][k] = hs[(8 * a + k) * NT];
    // h_start C^T, 64 columns of n (one C atom) at a time; the A fragment
    // of k16 step k is the thread's float4s 2k and 2k + 1 of the atom
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      uint32_t hhi[4][4], hlo[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 f0 = hf[a][2 * k], f1 = hf[a][2 * k + 1];
        split2(f0.x, f0.y, hhi[k][0], hlo[k][0]);
        split2(f0.z, f0.w, hhi[k][1], hlo[k][1]);
        split2(f1.x, f1.y, hhi[k][2], hlo[k][2]);
        split2(f1.z, f1.w, hhi[k][3], hlo[k][3]);
      }
      hopper::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t db = hopper::wgmma_desc(sc + a * TILE + k * 16, 16, 1024);
        hopper::wgmma_m64n64k16_rs<0>(yt, hhi[k], db, 1);
        hopper::wgmma_m64n64k16_rs<0>(yt, hlo[k], db, 1);
      }
      hopper::wgmma_commit();
    }
    hopper::wgmma_wait<0>();
    // column i takes exp(cs_i)
#pragma unroll
    for (int v = 0; v < 32; ++v) yt[v] *= ecs[8 * (v >> 2) + 2 * (lane & 3) + (v & 1)];
  }
  __syncthreads();  // S is in shared memory
  hopper::wgmma_fence();
  // x^T S^T [p, i]: A = x^T, the x tile MN-major (a k16 step is 16 rows of j);
  // B = S^T, i.e. S [i rows][j] K-major
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = hopper::wgmma_desc(sx + kk * 16 * ATOM, TILE_BYTES, 1024);
    hopper::wgmma_m64n64k16_ss<1, 0>(yt, da, hopper::wgmma_desc(sb + kk * 16, 16, 1024), 1);
    hopper::wgmma_m64n64k16_ss<1, 0>(yt, da, hopper::wgmma_desc(sb + TILE + kk * 16, 16, 1024),
                                     1);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  __syncthreads();  // every warp's reads of C are done

  // y^T -> y [i][p] in C's place (swizzled), then 16-byte rows out
  bf16* sy = sc;
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int p = r0 + 8 * ((v >> 1) & 1);
    const int i = 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
    sy[swz(i, p)] = __float2bfloat16_rn(yt[v]);
  }
  __syncthreads();
#pragma unroll
  for (int e = tid; e < Q * P / 8; e += NT) {
    const int i = e >> 3, ch = e & 7;
    const int t = t0 + i;
    if (t < S)
      *reinterpret_cast<uint4*>(y + b * L.y_b + t * L.y_s + h * L.y_h + ch * 8) =
          *reinterpret_cast<const uint4*>(sy + swz(i, ch * 8));
  }
}

// ------------------------------------------------------------------------- //
// wgmma_bwd: the backward of the wgmma variant (kernels/ssd_scan.py's
// _SSDScan.backward), six kernels on PyTorch's stream:
//   1-2. the forward's chunk_state and state_pass again: h0, the state each
//        chunk starts from (recomputed, not saved: one layer's scratch is
//        alive at a time);
//   3.   chunk_state<REV>: r_c = (dy ∘ exp(cs))^T C per chunk;
//   4.   state_pass_bwd: dh1, the cotangent of each chunk's end state, from
//        the last chunk to the first (dh1(c-1) = exp(T_c) dh1(c) + r_c);
//   5.   chunk_grad, grid (chunk, batch·H): every gradient of one head's chunk;
//   6.   grad_reduce: dB and dC over the heads of a group, dA over chunks.
// ------------------------------------------------------------------------- //

// Phase 4, grid (P·64 NA / 4 / PASS_NT, batch·H): the backward's only
// sequential part, the forward's state pass run from the last chunk:
//   dh1(nch - 1) = dh_final (or 0),  dh1(c - 1) = decay_c dh1(c) + r_c;
// dstates[bh, c] holds r_c on entry and dh1(c) on exit, in the
// accumulator's register order.  dh_final is [batch·H, P, N], natural order.
__global__ void __launch_bounds__(PASS_NT) ssd_state_pass_bwd_kernel(
    float* __restrict__ dstates, const float* __restrict__ decay,
    const float* __restrict__ dh_final, int PN4, int N, int nch) {
  const int e = blockIdx.x * PASS_NT + threadIdx.x;
  const long long bh = blockIdx.y;
  hopper::griddep_launch_dependents();
  hopper::griddep_wait();  // phase 3's r_c
  if (e >= PN4) return;
  float4* st = reinterpret_cast<float4*>(dstates) + bh * nch * PN4 + e;
  const float* dec = decay + bh * nch;
  float4 dh = make_float4(0.f, 0.f, 0.f, 0.f);
  if (dh_final != nullptr) {
    // float4 g of thread t: (row p0, columns n, n + 1) and (row p0 + 8, the same)
    const int t = e % NT, q = e / NT;
    const int p0 = 16 * (t >> 5) + ((t & 31) >> 2), n = 8 * q + 2 * (t & 3);
    if (n < N) {
      const float* s = dh_final + bh * P * N;
      dh = make_float4(s[p0 * N + n], s[p0 * N + n + 1], s[(p0 + 8) * N + n],
                       s[(p0 + 8) * N + n + 1]);
    }
  }
  for (int c1 = nch - 1; c1 >= 0; c1 -= PASS_CH) {
    float4 r[PASS_CH];
    float d[PASS_CH];
#pragma unroll
    for (int k = 0; k < PASS_CH; ++k) {
      if (c1 - k >= 0) {
        r[k] = st[(long long)(c1 - k) * PN4];
        d[k] = dec[c1 - k];
      }
    }
#pragma unroll
    for (int k = 0; k < PASS_CH; ++k) {
      if (c1 - k >= 0) {
        st[(long long)(c1 - k) * PN4] = dh;
        dh.x = fmaf(d[k], dh.x, r[k].x);
        dh.y = fmaf(d[k], dh.y, r[k].y);
        dh.z = fmaf(d[k], dh.z, r[k].z);
        dh.w = fmaf(d[k], dh.w, r[k].w);
      }
    }
  }
}

// This warp's share of the column sums of a [64, 64] accumulator (rows
// 16 warp .. 16 warp + 15) into red[warp * Q + column].
__device__ __forceinline__ void col_partials(const float (&v)[32], float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float s = v[4 * q + b] + v[4 * q + 2 + b];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[warp * Q + 8 * q + 2 * lane + b] = s;
    }
  }
}

// The row sums of a [64, 64] accumulator (each row lies in one warp) into out[row].
__device__ __forceinline__ void row_sums(const float (&v)[32], float* out) {
  const int lane = threadIdx.x & 31;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    s0 += v[4 * q] + v[4 * q + 1];
    s1 += v[4 * q + 2] + v[4 * q + 3];
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if ((lane & 3) == 0) {
    const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
    out[r0] = s0;
    out[r0 + 8] = s1;
  }
}

// One (bh, chunk) state in the scratch's register order (src: its float4s,
// offset by the thread; null for zero) into bf16 hi and lo tiles [P rows]
// [64 NA columns] (NA swizzled atoms each), whose wgmma reads are K-major A
// (M = p, K = n) or MN-major B (K = p, N = n).  Returns Σ src ∘ other over
// the thread's values (other null: 0).
template <int NA>
__device__ __forceinline__ float stage_state(const float4* src, const float4* other, bf16* hi,
                                             bf16* lo) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  float dot = 0.f;
#pragma unroll
  for (int q = 0; q < 8 * NA; ++q) {
    const float4 f = src != nullptr ? src[q * NT] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (other != nullptr) {
      const float4 o = other[q * NT];
      dot = fmaf(f.x, o.x, fmaf(f.y, o.y, fmaf(f.z, o.z, fmaf(f.w, o.w, dot))));
    }
    const int n = 8 * q + 2 * (lane & 3);
    const int off = (n >> 6) * TILE;
    uint32_t h, l;
    split2(f.x, f.y, h, l);
    *reinterpret_cast<uint32_t*>(hi + off + swz(r0, n & 63)) = h;
    *reinterpret_cast<uint32_t*>(lo + off + swz(r0, n & 63)) = l;
    split2(f.z, f.w, h, l);
    *reinterpret_cast<uint32_t*>(hi + off + swz(r0 + 8, n & 63)) = h;
    *reinterpret_cast<uint32_t*>(lo + off + swz(r0 + 8, n & 63)) = l;
  }
  return dot;
}

// Rows i of an [i, 64 NA] accumulator (atom a's columns in acc[a]) into
// part[row0 + i H][n] (f32; row0 is (t0, h)'s row of [batch·S·H, N]), rows
// past S and columns past N left out.
template <int NA>
__device__ __forceinline__ void store_rows(const float (&acc)[NA][32], float* __restrict__ part,
                                           long long row0, int H, int N, int rows) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int i = r0 + 8 * ((v >> 1) & 1);
      const int n = 64 * a + 8 * (v >> 2) + 2 * (lane & 3);
      if (i < rows && n < N)
        *reinterpret_cast<float2*>(part + (row0 + (long long)i * H) * N + n) =
            make_float2(acc[a][v], acc[a][v + 1]);
    }
  }
}

// Phase 5, grid (chunk, batch·H): one head's chunk, every product a 64-row
// wgmma m64n64k16 from shared memory (each f32 operand as bf16 hi and lo
// tiles, two products into one f32 accumulator), in this order:
//   (a) CB = C B^T, G = dy x^T [i, j] -> K = CB ∘ L, dCB = L ∘ G ∘ dt_j (both
//       split into tiles), M = CB ∘ dCB: its row sums and column sums;
//   (b) dC = exp(cs_i) (dy h0) + dCB B [i, n], into part_c;
//   (c) h0 C^T [p, i] -> Σ_p dy_ip (h0 C^T)_pi, the inter-chunk dcs;
//   (d) dB = dt_j exp(T - cs_j) (x dh1) + dCB^T C [j, n], into part_b;
//   (e) dh1 B^T and du^T = dy^T K + exp(T - cs_j) dh1 B^T [p, j] -> W_j,
//       dx = dt du (bf16, through shared memory to 16-byte rows), x·du;
//   (f) dcs = rowsum M - colsum M + exp(cs) (...) - W, d T onto the last
//       position, da = reverse cumsum (two warp scans), ddt = x·du + A da,
//       and this chunk's share of dA, Σ_j dt_j da_j, into part_a.
// Sums across warps are taken in a fixed order: the bits do not depend on
// scheduling.
template <int NA>
__global__ void __launch_bounds__(NT, 1) ssd_chunk_grad_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
    const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap cmap,
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ states,
    const float* __restrict__ dstates, bf16* __restrict__ dx, float* __restrict__ ddt,
    float* __restrict__ part_b, float* __restrict__ part_c, float* __restrict__ part_a,
    const Layout L, int S, int H, int G, int N, int nch) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* sx = reinterpret_cast<bf16*>(smem_raw + pad);  // [Q][P]
  bf16* sdy = sx + TILE;                               // [Q][P]
  bf16* sb = sdy + TILE;                               // NA atoms [Q][64]
  bf16* sc = sb + NA * TILE;                           // NA atoms [Q][64]
  bf16* shi = sc + NA * TILE;                          // h0, then dh1 [P][64 NA]: hi
  bf16* slo = shi + NA * TILE;                         // and lo
  bf16* skhi = slo + NA * TILE;                        // K [i][j] hi; then dx [j][p]
  bf16* sklo = skhi + TILE;                            // K lo
  bf16* sdhi = sklo + TILE;                            // dCB [i][j] hi
  bf16* sdlo = sdhi + TILE;                            // dCB lo
  float* cs = reinterpret_cast<float*>(sdlo + TILE);   // [Q]
  float* dts = cs + Q;                                 // [Q]
  float* ecs = dts + Q;                                // [Q]: exp(cs)
  float* wexp = ecs + Q;                               // [Q]: exp(T - cs)
  float* rowm = wexp + Q;                              // [Q]: row sums of M
  float* red = rowm + Q;                               // [4 sums][4 warps][Q]
  float* dcs = red + 16 * Q;                           // [Q]
  float* tmp = dcs + Q;                                // [Q]
  float* scr = tmp + Q;                                // [8]
  uint64_t* bar = reinterpret_cast<uint64_t*>(scr + 8);

  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int t0 = c * Q, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int rows = min(Q, S - t0);
  hopper::griddep_launch_dependents();
  init_barrier(bar);
  if (tid == 0) {
    hopper::mbar_expect_tx(bar, (2 + 2 * NA) * TILE_BYTES);
    hopper::tma_load_4d(sx, &xmap, bar, 0, h, t0, b);
    hopper::tma_load_4d(sdy, &dymap, bar, 0, h, t0, b);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      hopper::tma_load_4d(sb + a * TILE, &bmap, bar, a * ATOM, g, t0, b);
      hopper::tma_load_4d(sc + a * TILE, &cmap, bar, a * ATOM, g, t0, b);
    }
  }
  const float a_h = A[b * L.a_b + h * L.a_h];
  chunk_cumsum(cs, dts, dt, L, b, h, t0, S, a_h);
  if (tid < Q) {
    ecs[tid] = expf(cs[tid]);
    wexp[tid] = expf(cs[Q - 1] - cs[tid]);
  }
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  // (a) value v of a [64, 64] accumulator is row r0 + 8 ((v / 2) % 2),
  // column 8 (v / 4) + 2 (lane % 4) + v % 2
  {
    float cb[32], gx[32], m[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      const int o = (kk >> 2) * TILE + (kk & 3) * 16;
      hopper::wgmma_m64n64k16_ss<0, 0>(cb, hopper::wgmma_desc(sc + o, 16, 1024),
                                       hopper::wgmma_desc(sb + o, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_m64n64k16_ss<0, 0>(gx, hopper::wgmma_desc(sdy + kk * 16, 16, 1024),
                                       hopper::wgmma_desc(sx + kk * 16, 16, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int i = r0 + 8 * ((v >> 1) & 1);
      const int j = 8 * (v >> 2) + 2 * (lane & 3);
      const float csi = cs[i];
      const float l0 = j <= i ? expf(csi - cs[j]) : 0.f;
      const float l1 = j + 1 <= i ? expf(csi - cs[j + 1]) : 0.f;
      const float d0 = l0 * gx[v] * dts[j], d1 = l1 * gx[v + 1] * dts[j + 1];
      m[v] = cb[v] * d0;
      m[v + 1] = cb[v + 1] * d1;
      uint32_t hi, lo;
      split2(cb[v] * l0, cb[v + 1] * l1, hi, lo);
      *reinterpret_cast<uint32_t*>(skhi + swz(i, j)) = hi;
      *reinterpret_cast<uint32_t*>(sklo + swz(i, j)) = lo;
      split2(d0, d1, hi, lo);
      *reinterpret_cast<uint32_t*>(sdhi + swz(i, j)) = hi;
      *reinterpret_cast<uint32_t*>(sdlo + swz(i, j)) = lo;
    }
    row_sums(m, rowm);
    col_partials(m, red);
  }
  // phases 1-4 have written the states by now; h0 is zero in chunk 0
  hopper::griddep_wait();
  const long long soff = ((long long)bh * nch + c) * P * ATOM * NA;
  const float4* h0src = c > 0 ? reinterpret_cast<const float4*>(states + soff) + tid : nullptr;
  stage_state<NA>(h0src, nullptr, shi, slo);
  hopper::fence_proxy_async();
  __syncthreads();

  const long long row0 = ((long long)b * S + t0) * H + h;  // (t0, h)'s row of [batch·S·H, *]
  float acc[NA][32];
  // (b) dC [i, n]: A = dy (K-major), B = h0 (MN-major); then A = dCB
  // (K-major), B = the B tile (MN-major)
  hopper::wgmma_fence();
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::wgmma_desc(sdy + kk * 16, 16, 1024);
      const int o = a * TILE + kk * 16 * ATOM;
      hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], da, hopper::wgmma_desc(shi + o, TILE_BYTES, 1024),
                                       kk > 0);
      hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], da, hopper::wgmma_desc(slo + o, TILE_BYTES, 1024),
                                       1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[a][v] *= ecs[r0 + 8 * ((v >> 1) & 1)];
  hopper::wgmma_fence();
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hopper::wgmma_desc(sb + a * TILE + kk * 16 * ATOM, TILE_BYTES, 1024);
      hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], hopper::wgmma_desc(sdhi + kk * 16, 16, 1024), db,
                                       1);
      hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], hopper::wgmma_desc(sdlo + kk * 16, 16, 1024), db,
                                       1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  store_rows<NA>(acc, part_c, row0, H, N, rows);

  // (c) h0 C^T [p, i]: A = h0 (K-major), B = the C tile (K-major)
  {
    float hc[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      const int o = (kk >> 2) * TILE + (kk & 3) * 16;
      const uint64_t db = hopper::wgmma_desc(sc + o, 16, 1024);
      hopper::wgmma_m64n64k16_ss<0, 0>(hc, hopper::wgmma_desc(shi + o, 16, 1024), db, kk > 0);
      hopper::wgmma_m64n64k16_ss<0, 0>(hc, hopper::wgmma_desc(slo + o, 16, 1024), db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < 32; ++v)
      hc[v] *= __bfloat162float(sdy[swz(8 * (v >> 2) + 2 * (lane & 3) + (v & 1),
                                        r0 + 8 * ((v >> 1) & 1))]);
    col_partials(hc, red + 4 * Q);
  }
  __syncthreads();  // every warp's reads of h0 are done
  // dh1 in h0's place, and this thread's share of Σ dh1 ∘ h0 (d T's state term)
  const float hdot = stage_state<NA>(reinterpret_cast<const float4*>(dstates + soff) + tid,
                                     h0src, shi, slo);
  hopper::fence_proxy_async();
  __syncthreads();

  // (d) dB [j, n]: A = x (K-major), B = dh1 (MN-major); then A = dCB^T (the
  // dCB tiles MN-major), B = the C tile (MN-major)
  hopper::wgmma_fence();
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::wgmma_desc(sx + kk * 16, 16, 1024);
      const int o = a * TILE + kk * 16 * ATOM;
      hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], da, hopper::wgmma_desc(shi + o, TILE_BYTES, 1024),
                                       kk > 0);
      hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], da, hopper::wgmma_desc(slo + o, TILE_BYTES, 1024),
                                       1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int j = r0 + 8 * ((v >> 1) & 1);
      acc[a][v] *= dts[j] * wexp[j];
    }
  hopper::wgmma_fence();
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hopper::wgmma_desc(sc + a * TILE + kk * 16 * ATOM, TILE_BYTES, 1024);
      hopper::wgmma_m64n64k16_ss<1, 1>(
          acc[a], hopper::wgmma_desc(sdhi + kk * 16 * ATOM, TILE_BYTES, 1024), db, 1);
      hopper::wgmma_m64n64k16_ss<1, 1>(
          acc[a], hopper::wgmma_desc(sdlo + kk * 16 * ATOM, TILE_BYTES, 1024), db, 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  store_rows<NA>(acc, part_b, row0, H, N, rows);

  // (e) dh1 B^T [p, j]: A = dh1 (K-major), B = the B tile (K-major);
  // dy^T K [p, j]: A = dy^T (the dy tile MN-major), B = K (MN-major)
  {
    float hb[32], du[32], t[32], xv[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NA; ++kk) {
      const int o = (kk >> 2) * TILE + (kk & 3) * 16;
      const uint64_t db = hopper::wgmma_desc(sb + o, 16, 1024);
      hopper::wgmma_m64n64k16_ss<0, 0>(hb, hopper::wgmma_desc(shi + o, 16, 1024), db, kk > 0);
      hopper::wgmma_m64n64k16_ss<0, 0>(hb, hopper::wgmma_desc(slo + o, 16, 1024), db, 1);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::wgmma_desc(sdy + kk * 16 * ATOM, TILE_BYTES, 1024);
      hopper::wgmma_m64n64k16_ss<1, 1>(
          du, da, hopper::wgmma_desc(skhi + kk * 16 * ATOM, TILE_BYTES, 1024), kk > 0);
      hopper::wgmma_m64n64k16_ss<1, 1>(
          du, da, hopper::wgmma_desc(sklo + kk * 16 * ATOM, TILE_BYTES, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int j = 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
      xv[v] = __bfloat162float(sx[swz(j, r0 + 8 * ((v >> 1) & 1))]);
      t[v] = hb[v] * xv[v];
      du[v] = fmaf(wexp[j], hb[v], du[v]);
    }
    col_partials(t, red + 8 * Q);  // Σ_p x_jp (dh1 B^T)_pj
#pragma unroll
    for (int v = 0; v < 32; ++v) t[v] = du[v] * xv[v];
    col_partials(t, red + 12 * Q);  // Σ_p x_jp du_jp
    __syncthreads();  // every warp's reads of K are done: dx takes its place
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int j = 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
      skhi[swz(j, r0 + 8 * ((v >> 1) & 1))] = __float2bfloat16_rn(dts[j] * du[v]);
    }
  }
  {
    float s = hdot;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) scr[warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int e = tid; e < Q * P / 8; e += NT) {
    const int i = e >> 3, ch = e & 7;
    if (i < rows)
      *reinterpret_cast<uint4*>(dx + (row0 + (long long)i * H) * P + ch * 8) =
          *reinterpret_cast<const uint4*>(skhi + swz(i, ch * 8));
  }

  // (f) dcs, d T, da, ddt and dA's share; red[(4 k + w) Q + j] is sum k of warp w
  if (tid < Q) {
    const int j = tid;
    const float colm = red[j] + red[Q + j] + red[2 * Q + j] + red[3 * Q + j];
    const float inter = red[4 * Q + j] + red[5 * Q + j] + red[6 * Q + j] + red[7 * Q + j];
    const float xhb = red[8 * Q + j] + red[9 * Q + j] + red[10 * Q + j] + red[11 * Q + j];
    const float W = dts[j] * wexp[j] * xhb;
    dcs[j] = rowm[j] - colm + ecs[j] * inter - W;
    tmp[j] = W;
  }
  __syncthreads();
  if (tid < 32) {
    float s = tmp[tid] + tmp[tid + 32];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (tid == 0) dcs[Q - 1] += s + expf(cs[Q - 1]) * (scr[0] + scr[1] + scr[2] + scr[3]);
  }
  __syncthreads();
  // da_j = Σ_{i >= j} dcs_i: thread k scans position Q - 1 - k
  if (tid < Q) {
    float v = dcs[Q - 1 - tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    tmp[tid] = v;
  }
  __syncthreads();
  if (tid < Q) {
    const int j = Q - 1 - tid;
    const float da = tid >= 32 ? tmp[tid] + tmp[31] : tmp[tid];
    const float xdu = red[12 * Q + j] + red[13 * Q + j] + red[14 * Q + j] + red[15 * Q + j];
    if (j < rows) ddt[row0 + (long long)j * H] = fmaf(a_h, da, xdu);
    float s = dts[j] * da;  // dt = 0 past S
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) scr[4 + warp] = s;
  }
  __syncthreads();
  if (tid == 0) part_a[(long long)bh * nch + c] = scr[4] + scr[5];
}

// Phase 6: dB and dC [batch·S·G rows, N] in bf16, each the sum over the
// R = H / G heads of its group in order (part rows row·R + r); the blocks
// past sum_blocks take dA [batch·H], the sum over chunks in order.
__global__ void __launch_bounds__(PASS_NT) ssd_grad_reduce_kernel(
    const float* __restrict__ part_b, const float* __restrict__ part_c,
    const float* __restrict__ part_a, bf16* __restrict__ dB, bf16* __restrict__ dC,
    float* __restrict__ dA, long long rows, int R, int N4, int BH, int nch, int sum_blocks) {
  hopper::griddep_wait();  // phase 5's partials
  if ((int)blockIdx.x < sum_blocks) {
    const long long e = (long long)blockIdx.x * PASS_NT + threadIdx.x;
    if (e >= rows * N4) return;
    const long long row = e / N4;
    const int n4 = (int)(e % N4);
    const float4* pb = reinterpret_cast<const float4*>(part_b) + row * R * N4 + n4;
    const float4* pc = reinterpret_cast<const float4*>(part_c) + row * R * N4 + n4;
    float4 sb = pb[0], sc = pc[0];
    for (int r = 1; r < R; ++r) {
      const float4 u = pb[(long long)r * N4], v = pc[(long long)r * N4];
      sb.x += u.x;
      sb.y += u.y;
      sb.z += u.z;
      sb.w += u.w;
      sc.x += v.x;
      sc.y += v.y;
      sc.z += v.z;
      sc.w += v.w;
    }
    *reinterpret_cast<uint2*>(dB + e * 4) =
        make_uint2(hopper::pack_bf16(sb.x, sb.y), hopper::pack_bf16(sb.z, sb.w));
    *reinterpret_cast<uint2*>(dC + e * 4) =
        make_uint2(hopper::pack_bf16(sc.x, sc.y), hopper::pack_bf16(sc.z, sc.w));
  } else {
    const int i = (blockIdx.x - sum_blocks) * PASS_NT + threadIdx.x;
    if (i >= BH) return;
    const float* p = part_a + (long long)i * nch;
    float s = p[0];
    for (int c = 1; c < nch; ++c) s += p[c];
    dA[i] = s;
  }
}

template <int NA>
constexpr size_t grad_smem() {
  return (size_t)(2 + 4 * NA + 4) * TILE_BYTES + (23 * Q + 8) * sizeof(float) + 8 + 1024;
}

template <int NA>
constexpr size_t state_smem() {
  return (size_t)(1 + NA) * TILE_BYTES + 3 * Q * sizeof(float) + 8 + 1024;
}
template <int NA>
constexpr size_t scan_smem() {
  return (size_t)(NA + (NA > 2 ? NA : 2) + 1) * TILE_BYTES + 3 * Q * sizeof(float) + 8 + 1024;
}

template <int NA>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* h_out, void* states, void* decay, int batch, int S, int H, int G, int N,
           const Layout& L, cudaStream_t stream) {
  CUtensorMap xm, bm, cm;
  const int box[4] = {ATOM, 1, Q, 1};
  const long long xd[4] = {P, H, S, batch};
  const long long xs[3] = {2 * L.x_h, 2 * L.x_s, 2 * L.x_b};
  const long long bd[4] = {N, G, S, batch};
  const long long bs[3] = {2 * L.bc_g, 2 * L.bc_s, 2 * L.bc_b};
  if (!hopper::make_map_bf16_4d(&xm, x, xd, xs, box) ||
      !hopper::make_map_bf16_4d(&bm, B, bd, bs, box) ||
      !hopper::make_map_bf16_4d(&cm, C, bd, bs, box))
    return (int)cudaErrorInvalidValue;
  static bool attributes_set = false;  // per instantiation, once per process
  cudaError_t err = cudaSuccess;
  if (!attributes_set) {
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<NA>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_smem<NA>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<NA>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_smem<NA>());
    if (err != cudaSuccess) return (int)err;
    attributes_set = true;
  }
  const int nch = (S + Q - 1) / Q;
  const dim3 grid(nch, batch * H);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  ssd_chunk_state_kernel<NA><<<grid, NT, state_smem<NA>(), stream>>>(xm, bm, dtf, Af, st, dec, L,
                                                                     S, H, G, nch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // phases 2 and 3 start while the phase before them drains (griddep_wait)
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const int PN4 = P * ATOM * NA / 4;
  cfg.gridDim = dim3((PN4 + PASS_NT - 1) / PASS_NT, batch * H);
  cfg.blockDim = dim3(PASS_NT);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, ssd_state_pass_kernel, st, static_cast<const float*>(dec),
                           static_cast<float*>(h_out), PN4, N, nch);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = scan_smem<NA>();
  err = cudaLaunchKernelEx(&cfg, ssd_chunk_scan_kernel<NA>, xm, bm, cm, dtf, Af,
                           static_cast<const float*>(st), static_cast<bf16*>(y), L, S, H, G, nch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward's six kernels (see wgmma_bwd above).  Phases 2, 4, 5 and 6
// start by programmatic dependent launch while the phase before drains;
// phase 3 follows phase 2 in stream order.
template <int NA>
int launch_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
               const void* dy, const void* dh_final, void* dx, void* ddt, void* dA, void* dB,
               void* dC, void* states, void* dstates, void* decay, void* part_b, void* part_c,
               void* part_a, int batch, int S, int H, int G, int N, const Layout& L,
               const long long (&dys)[3], cudaStream_t stream) {
  CUtensorMap xm, dym, bm, cm;
  const int box[4] = {ATOM, 1, Q, 1};
  const long long xd[4] = {P, H, S, batch};
  const long long xs[3] = {2 * L.x_h, 2 * L.x_s, 2 * L.x_b};
  const long long dyst[3] = {2 * dys[2], 2 * dys[1], 2 * dys[0]};
  const long long bd[4] = {N, G, S, batch};
  const long long bs[3] = {2 * L.bc_g, 2 * L.bc_s, 2 * L.bc_b};
  if (!hopper::make_map_bf16_4d(&xm, x, xd, xs, box) ||
      !hopper::make_map_bf16_4d(&dym, dy, xd, dyst, box) ||
      !hopper::make_map_bf16_4d(&bm, B, bd, bs, box) ||
      !hopper::make_map_bf16_4d(&cm, C, bd, bs, box))
    return (int)cudaErrorInvalidValue;
  static bool attributes_set = false;  // per instantiation, once per process
  cudaError_t err = cudaSuccess;
  if (!attributes_set) {
    err = cudaFuncSetAttribute(ssd_chunk_state_kernel<NA, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)state_smem<NA>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_state_kernel<NA, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)state_smem<NA>());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_grad_kernel<NA>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)grad_smem<NA>());
    if (err != cudaSuccess) return (int)err;
    attributes_set = true;
  }
  const int nch = (S + Q - 1) / Q;
  const dim3 grid(nch, batch * H);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* dst = static_cast<float*>(dstates);
  float* dec = static_cast<float*>(decay);
  const int PN4 = P * ATOM * NA / 4;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  // 1-2: h0
  ssd_chunk_state_kernel<NA, false><<<grid, NT, state_smem<NA>(), stream>>>(xm, bm, dtf, Af, st,
                                                                            dec, L, S, H, G, nch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cfg.gridDim = dim3((PN4 + PASS_NT - 1) / PASS_NT, batch * H);
  cfg.blockDim = dim3(PASS_NT);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, ssd_state_pass_kernel, st, static_cast<const float*>(dec),
                           static_cast<float*>(nullptr), PN4, N, nch);
  if (err != cudaSuccess) return (int)err;
  // 3-4: dh1
  ssd_chunk_state_kernel<NA, true><<<grid, NT, state_smem<NA>(), stream>>>(dym, cm, dtf, Af, dst,
                                                                           dec, L, S, H, G, nch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, ssd_state_pass_bwd_kernel, dst, static_cast<const float*>(dec),
                           static_cast<const float*>(dh_final), PN4, N, nch);
  if (err != cudaSuccess) return (int)err;
  // 5: the chunks' gradients
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = grad_smem<NA>();
  err = cudaLaunchKernelEx(&cfg, ssd_chunk_grad_kernel<NA>, xm, dym, bm, cm, dtf, Af,
                           static_cast<const float*>(st), static_cast<const float*>(dst),
                           static_cast<bf16*>(dx), static_cast<float*>(ddt),
                           static_cast<float*>(part_b), static_cast<float*>(part_c),
                           static_cast<float*>(part_a), L, S, H, G, N, nch);
  if (err != cudaSuccess) return (int)err;
  // 6: the sums over heads and chunks
  const long long rows = (long long)batch * S * G;
  const int N4 = N / 4;
  const int sum_blocks = (int)((rows * N4 + PASS_NT - 1) / PASS_NT);
  cfg.gridDim = dim3(sum_blocks + (batch * H + PASS_NT - 1) / PASS_NT);
  cfg.blockDim = dim3(PASS_NT);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, ssd_grad_reduce_kernel, static_cast<const float*>(part_b),
                           static_cast<const float*>(part_c), static_cast<const float*>(part_a),
                           static_cast<bf16*>(dB), static_cast<bf16*>(dC), static_cast<float*>(dA),
                           rows, H / G, N4, batch * H, nch, sum_blocks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
}  // namespace tc

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

// The wgmma variant, on the mixer's layout (bf16 x, B, C and y; f32 dt, A):
// x [batch, S, H, P], dt [batch, S, H], A [batch, H], B and C [batch, S, G, N],
// y [batch, S, H, P]; head h reads group h / (H / G).  `strides` holds 14
// element strides: x (batch, S, H), dt (batch, S, H), A (batch, H), B and C
// (batch, S, G; the same for both), y (batch, S, H).  The last dim of x, B, C
// and y is contiguous, x, B and C start on 16 bytes and their strides are
// multiples of 8 elements (TMA).  states [batch·H, ceil(S / 64), P·64] (P·128
// for N > 64) and decay [batch·H, ceil(S / 64)] are f32 scratch; h_out [batch, H, P, N] f32
// or null.  P = 64; N a multiple of 16 up to 128.  Enqueues three kernels on
// `stream`; returns cudaGetLastError() after them (0 on success).
extern "C" int ssd_scan_wgmma_fwd(const void* x, const void* dt, const void* A, const void* B,
                                  const void* C, void* y, void* h_out, void* states, void* decay,
                                  int batch, int S, int H, int G, int P, int N,
                                  const long long* strides, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P != tc::P || N < 16 ||
      N > NMAX || N % 16 != 0 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  const tc::Layout L = {t[0], t[1], t[2], t[3], t[4],  t[5],  t[6],
                        t[7], t[8], t[9], t[10], t[11], t[12], t[13]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= tc::ATOM)
    return tc::launch<1>(x, dt, A, B, C, y, h_out, states, decay, batch, S, H, G, N, L, s);
  return tc::launch<2>(x, dt, A, B, C, y, h_out, states, decay, batch, S, H, G, N, L, s);
}

// The wgmma variant's backward (wgmma_bwd), on the forward's layout: x, dt,
// A, B, C as ssd_scan_wgmma_fwd takes them, dy [batch, S, H, P] bf16 (its
// own strides), dh_final [batch, H, P, N] f32 contiguous or null (zero).
// `strides` holds 14 element strides: x (batch, S, H), dt (batch, S, H), A
// (batch, H), B and C (batch, S, G), dy (batch, S, H); dy's last dim is
// contiguous, it starts on 16 bytes and its strides are multiples of 8
// elements (TMA).  Outputs, contiguous: dx [batch, S, H, P] bf16, ddt
// [batch, S, H] f32, dA [batch, H] f32, dB and dC [batch, S, G, N] bf16.
// f32 scratch: states and dstates [batch·H, ceil(S / 64), P·64] (P·128 for
// N > 64), decay and part_a [batch·H, ceil(S / 64)], part_b and part_c
// [batch, S, H, N].  P = 64; N a multiple of 16 up to 128.  Enqueues six
// kernels on `stream`; returns cudaGetLastError() after them (0 on success).
extern "C" int ssd_scan_wgmma_bwd(const void* x, const void* dt, const void* A, const void* B,
                                  const void* C, const void* dy, const void* dh_final, void* dx,
                                  void* ddt, void* dA, void* dB, void* dC, void* states,
                                  void* dstates, void* decay, void* part_b, void* part_c,
                                  void* part_a, int batch, int S, int H, int G, int P, int N,
                                  const long long* strides, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P != tc::P || N < 16 ||
      N > NMAX || N % 16 != 0 || strides == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long* t = strides;
  const tc::Layout L = {t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9], t[10],
                        0,    0,    0};
  const long long dys[3] = {t[11], t[12], t[13]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= tc::ATOM)
    return tc::launch_bwd<1>(x, dt, A, B, C, dy, dh_final, dx, ddt, dA, dB, dC, states, dstates,
                             decay, part_b, part_c, part_a, batch, S, H, G, N, L, dys, s);
  return tc::launch_bwd<2>(x, dt, A, B, C, dy, dh_final, dx, ddt, dA, dB, dC, states, dstates,
                           decay, part_b, part_c, part_a, batch, S, H, G, N, L, dys, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
