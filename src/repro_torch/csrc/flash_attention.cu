// Flash attention for Hopper (sm_90a), forward and backward, plain C
// interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`): softmax(q k^T * scale) v for q, k [BH, S, D] and v [BH, S,
// Dv] (Dv = D on the dense path; MLA's prefill has D = 192, Dv = 128: 128
// latent-expanded dims plus the 64-wide rope key, against a 128-wide value)
// with an online (streaming) softmax, an optional causal mask offset by Sk - Sq, the finite
// -1e30 mask value, f32 running max / denominator / accumulator, and the
// output cast to the input type.  Two forward kernels, one C entry point
// each, and the backward of the tensor-core one; the wrapper
// (kernels/flash_attention.py::select_variant, select_bwd_variant) picks.
//
// What bounds it on this card: at the serving path's prefill shapes (32 heads,
// S up to 1024, D = 64) the work is ~4*S*S*D/2 operations per head against
// 4*S*D elements moved, i.e. hundreds of operations per byte: it is bound by
// operations, so the bf16 path belongs on the tensor cores.  Both kernels
// turn the TPU kernel's sequential KV grid axis (scratch carried across grid
// steps) into a loop inside one CTA per (bh, q tile), skip KV tiles wholly
// above the causal diagonal (every key in them is masked for every row of
// the tile, so they add exactly zero; the TPU kernel's docstring allows it)
// and mask ragged sequence ends themselves.
//
// 1. `flash_mma_kernel` (entry flash_attention_mma_fwd): bf16, D a multiple
//    of 16 up to 192 and Dv a multiple of 16 up to 128, padded in shared
//    memory to one of four tiles: 32/32, 64/64, 128/128 or 192/128 (Q·Kᵀ runs
//    over the first, the accumulator is the second wide).  FA2's
//    layout: 128-row q tiles (8 warps of 16 rows; 32 heads x 8 tiles = 256
//    CTAs at S = 1024), Q·Kᵀ and P·V on mma.sync m16n8k16 with operands from
//    swizzled shared memory by ldmatrix (V through its transposing form), K/V
//    tiles of 64 keys double-buffered by cp.async.  The scores stay in
//    registers: the online softmax runs on them in f32 (scale·log2(e) folded
//    into one multiply, exp2f), and P, rounded to bf16, goes from the score
//    registers into P·V's A fragments without touching shared memory.  Only
//    tiles that reach past the diagonal or Sk are masked.  Causal q tiles do
//    unequal work, so the grid launches the last (longest) q tiles first.
//    Given an lse buffer (training), each row's owner writes the logsumexp
//    of its scaled scores in natural log, ln 2 (m + log2 l) from its final
//    running max m (log2 units) and denominator l; serving passes none.
//    Why mma.sync and not wgmma (FA3's layout): this kernel comes within
//    10% of PyTorch's own flash backend (FA2) at S = 1024, and it takes
//    under a tenth of a TinyLlama prefill's device time in a step whose wall
//    the host sets (H100, chip_smoke.py; PERF.md): a faster attention would
//    not show end to end, and a 128-row q tile runs only 8.5 KV tiles on
//    average at the path's S <= 1024, short for a producer-consumer
//    pipeline to amortise.
//    At D = 192 (MLA) the 128-row Q tile and the double-buffered K and V
//    tiles take 128 KB of shared memory (one CTA an SM; 16 heads x 8 q tiles
//    = 128 CTAs at S = 1024).  Q's fragments, 48 registers a thread there,
//    are not held across KV tiles: each tile reloads them from shared memory
//    by ldmatrix (12 more ldmatrix.x4 a warp against the 80 it issues for K
//    and V), so the scores, the 128-wide accumulator and the fragments of K
//    and V fit in registers with no spill.
// 2. `flash_fwd_kernel` (entry flash_attention_fwd): f32, and bf16 with other
//    head dims.  CUDA cores, f32: one block per (bh, 64-row q tile) holds Q in
//    shared memory and stages each 64-key K/V tile there once; scores and
//    P·V are register-blocked (each of the 256 threads owns a 4 x 4 score
//    block and a 4 x Dv/16 accumulator block).  Tiles 32/32, 64/64, 128/128
//    and 192/128 as above; any D up to 192 and Dv up to 128.
// 3. The backward of (1) (entry flash_attention_mma_bwd; the TPU kernel has
//    no VJP, its model trains through plain jnp): FA2's, from the forward's
//    O and lse, on the same tiles, shapes and masks.  It is bound by
//    operations: five products over the pairs the mask leaves (S = Q Kᵀ, dP
//    = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K), 2.5x the forward's, against
//    q, k, v, o, dO and the three gradients moved once.  Three kernels:
//    `flash_delta_kernel` (delta = rowsum(dO ⊙ O), f32, one warp a row), then
//    `flash_mma_dkdv_kernel` (one CTA per 128 keys; each warp holds 16 keys
//    and walks the q tiles that see them, from the causal diagonal on, Q, dO,
//    lse and delta double-buffered by cp.async; recomputes S and dP, forms P
//    = exp2(S·scale·log2 e - lse·log2 e) and dS = P ⊙ (dP - delta) in f32 in
//    the score registers, and accumulates dV += Pᵀ dO and dK += dSᵀ Q with P
//    and dS rounded to bf16 straight into the A fragments) and
//    `flash_mma_dq_kernel` (one CTA per 128 query rows, the forward's walk
//    over K/V tiles: recomputes S, dP and dS, dQ += dS K).  No sum crosses
//    CTAs and no float atomic is used, so dq, dk and dv are the same bits
//    from run to run (a killed and resumed training run must equal the
//    uninterrupted one); the price is that S and dP are computed twice, 7
//    products against FA2's 5 (whose dQ is summed by atomics).  A masked
//    pair has dS = 0, as autograd through the reference's `where` gives it,
//    and P = 0, or the forward's uniform 1/Sk in a row that sees no key.
//    Register pressure grows with the accumulators: dK and dV (each warp's 16
//    keys x D, x Dv in f32) take 64 registers at 64/64 and 160 at 192/128,
//    so the q step shrinks with the tile (64 rows at 32/32 and 64/64, 32 at
//    128/128, 16 at 192/128) and the dQ kernel walks 32-key tiles at 192/128;
//    K's and Q's fragments are reloaded from shared memory per step, never
//    held across steps.
//
// -Xptxas -v (sm_90a, nvcc 12.8), no spills: flash_mma_kernel 117 / 127 / 215
// / 195 registers for the 32/32, 64/64, 128/128 and 192/128 tiles, with 24 /
// 48 / 96 / 128 KB of dynamic shared memory; flash_fwd_kernel 64 / 80 / 104-106
// / 116; flash_mma_dkdv_kernel 154 / 242 / 250 / 255 with 33 / 65 / 96.5 /
// 100.25 KB; flash_mma_dq_kernel 124 / 166 / 228 / 249 with 32 / 64 / 128 /
// 120 KB; flash_delta_kernel 24 (H100; PERF.md).  Past 128 registers a thread
// the backward runs one CTA of 8 warps an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

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

template <int DMAX, int DVMAX>
constexpr size_t smem_floats() {
  // q [BQ][DMAX], k [BK][DMAX+1], v [BK][DVMAX], p [BQ][BK+1], m/l/alpha [BQ]
  return (size_t)BQ * DMAX + (size_t)BK * (DMAX + 1) + (size_t)BK * DVMAX +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int DMAX, int DVMAX>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int D, int Dv, float scale, int causal) {
  constexpr int DC = DVMAX / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [BQ][DMAX]
  float* ks = qs + BQ * DMAX;              // [BK][DMAX + 1], padded: no bank conflicts
  float* vs = ks + BK * (DMAX + 1);        // [BK][DVMAX]
  float* ps = vs + BK * DVMAX;             // [BQ][BK + 1]
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
  const long long vbase = (long long)bh * Sk * Dv;
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
    if constexpr (DMAX == DVMAX) {  // one staging loop for K and V
      for (int i = tid; i < BK * DMAX; i += NT) {
        const int r = i / DMAX, d = i % DMAX;
        const bool row = k0 + r < Sk;
        ks[r * (DMAX + 1) + d] =
            row && d < D ? to_f32(k[kbase + (long long)(k0 + r) * D + d]) : 0.f;
        vs[i] = row && d < Dv ? to_f32(v[vbase + (long long)(k0 + r) * Dv + d]) : 0.f;
      }
    } else {
      for (int i = tid; i < BK * DMAX; i += NT) {
        const int r = i / DMAX, d = i % DMAX;
        const bool in = (k0 + r < Sk) && d < D;
        ks[r * (DMAX + 1) + d] = in ? to_f32(k[kbase + (long long)(k0 + r) * D + d]) : 0.f;
      }
      for (int i = tid; i < BK * DVMAX; i += NT) {
        const int r = i / DVMAX, d = i % DVMAX;
        const bool in = (k0 + r < Sk) && d < Dv;
        vs[i] = in ? to_f32(v[vbase + (long long)(k0 + r) * Dv + d]) : 0.f;
      }
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
      for (int j = 0; j < DC; ++j) b[j] = vs[kk * DVMAX + tx + 16 * j];
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
    T* orow = o + (long long)bh * Sq * Dv + (long long)(q0 + r) * Dv;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < Dv) store(orow + d, acc[i][j] / l);
    }
  }
}

template <typename T, int DMAX, int DVMAX>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq,
           int sk, int d, int dv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<DMAX, DVMAX>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DMAX, DVMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd_kernel<T, DMAX, DVMAX><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, d, dv, scale, causal);
  return (int)cudaGetLastError();
}

// the tile is chosen by the wider of the two head dims: 32/32, 64/64,
// 128/128, and 192/128 past 128 (Dv <= 128 is checked by the entry point)
template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq,
               int sk, int d, int dv, float scale, int causal, cudaStream_t stream) {
  const int w = d > dv ? d : dv;
  if (w <= 32) return launch<T, 32, 32>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 64) return launch<T, 64, 64>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 128) return launch<T, 128, 128>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 192) return launch<T, 192, 128>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------- //
// bf16 on the tensor cores: mma.sync m16n8k16, ldmatrix, cp.async (FA2's layout)
// ------------------------------------------------------------------------- //
namespace tc {
using bf16 = __nv_bfloat16;
constexpr int BQ = 128;   // query rows per CTA: 8 warps of 16
constexpr int BKV = 64;   // keys per K/V tile
constexpr int NTH = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// DP: q/k head dim padded to 32, 64, 128 or 192; DVP: v's, to 32, 64 or 128
template <int DP, int DVP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * DP + 2 * BKV * DP + 2 * BKV * DVP) * 2;  // q, then k and v double-buffered
}

template <int DP, int DVP>
__global__ void __launch_bounds__(NTH) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int D, int Dv,
    float scale_log2, int causal) {
  constexpr int CPR = DP / 8;    // 16-byte chunks a q/k row
  constexpr int CPRV = DVP / 8;  // ... a v row
  constexpr int KT = DP / 16;    // k16 steps of Q·Kᵀ over the head dim
  constexpr int NJ = BKV / 8;    // n8 score tiles of a KV tile
  constexpr int ND = DVP / 8;    // n8 output tiles
  constexpr bool QREG = KT <= 8;  // Q's fragments held in registers across KV tiles
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BQ * DP;        // [2][BKV * DP]
  bf16* vs = ks + 2 * BKV * DP;   // [2][BKV * DVP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest (last) q tiles launch first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* qg = q + (long long)bh * Sq * D;
  const bf16* kg = k + (long long)bh * Sk * D;
  const bf16* vg = v + (long long)bh * Sk * Dv;
  const int off = Sk - Sq;  // aligns the diagonals when Sq != Sk

  // rows [row0, row0 + n) of a [*, D] matrix into a swizzled [n, DP] tile;
  // rows past `valid` and columns past D are zero-filled
  auto load_rows = [&](bf16* dst, const bf16* src, int row0, int n, int valid) {
    for (int i = tid; i < n * CPR; i += NTH) {
      const int r = i / CPR, c = i % CPR, row = row0 + r;
      const bool ok = row < valid && c * 8 < D;
      hopper::cp_async16(dst + hopper::swz<CPR>(r, c), ok ? src + (long long)row * D + c * 8 : src,
                         ok);
    }
  };
  // the same for v's [*, Dv] rows into a [BKV, DVP] tile
  auto load_v = [&](bf16* dst, int row0) {
    for (int i = tid; i < BKV * CPRV; i += NTH) {
      const int r = i / CPRV, c = i % CPRV, row = row0 + r;
      const bool ok = row < Sk && c * 8 < Dv;
      hopper::cp_async16(dst + hopper::swz<CPRV>(r, c),
                         ok ? vg + (long long)row * Dv + c * 8 : vg, ok);
    }
  };

  int n_tiles = (Sk + BKV - 1) / BKV;
  if (causal && off >= 0) {
    // keys past the block's last row (shifted by off) are masked for every row
    const int last_row = min(q0 + BQ, Sq) - 1;
    n_tiles = min(n_tiles, (last_row + off) / BKV + 1);
  }

  load_rows(qs, qg, q0, BQ, Sq);
  load_rows(ks, kg, 0, BKV, Sk);
  load_v(vs, 0);
  hopper::cp_async_commit();

  uint32_t qf[QREG ? KT : 1][4];
  float oacc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[d][e] = 0.f;
  // this thread's two rows: r_lo and r_lo + 8; running max (log2 units) and
  // the thread's share of the running denominator
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_rows(ks + (buf ^ 1) * BKV * DP, kg, (t + 1) * BKV, BKV, Sk);
      load_v(vs + (buf ^ 1) * BKV * DVP, (t + 1) * BKV);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and q) have landed
    __syncthreads();
    if constexpr (QREG) {
      if (t == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          hopper::ldmatrix_x4(qf[kt], qs + hopper::swz<CPR>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                            kt * 2 + (lane >> 4)));
      }
    }
    const bf16* kb = ks + buf * BKV * DP;
    const bf16* vb = vs + buf * BKV * DVP;

    // S = Q Kᵀ (f32)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kt][e];
      } else {
        hopper::ldmatrix_x4(qa, qs + hopper::swz<CPR>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                      kt * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        hopper::ldmatrix_x4(b, kb + hopper::swz<CPR>(jp * 16 + (lane & 7) + ((lane >> 4) & 1) * 8,
                                                     kt * 2 + ((lane >> 3) & 1)));
        hopper::mma_bf16(s[2 * jp], qa, b[0], b[1]);
        hopper::mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
      }
    }

    // scale into log2 units; mask only tiles that reach past the diagonal or Sk
    const int k0 = t * BKV;
    const bool edge = k0 + BKV > Sk || (causal && k0 + BKV - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = r_lo + (e >> 1) * 8;
          // past Sk not a key at all; the reference's finite mask, in log2 units
          if (key >= Sk) x = -INFINITY;
          else if (causal && key > row + off) x = NEG_INF * LOG2E;
        }
        s[j][e] = x;
      }

    // online softmax, f32: a row's four owners are lanes 4i .. 4i + 3
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = mrow[h];
#pragma unroll
      for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[h] = exp2f(mrow[h] - mx);
      mrow[h] = mx;
      lrow[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mrow[e >> 1]);
        lrow[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[d][e] *= alpha[e >> 1];

    // O += P V: P (rounded to bf16) goes from the score registers straight
    // into mma's A fragments
#pragma unroll
    for (int kp = 0; kp < BKV / 16; ++kp) {
      const uint32_t a[4] = {hopper::pack_bf16(s[2 * kp][0], s[2 * kp][1]),
                             hopper::pack_bf16(s[2 * kp][2], s[2 * kp][3]),
                             hopper::pack_bf16(s[2 * kp + 1][0], s[2 * kp + 1][1]),
                             hopper::pack_bf16(s[2 * kp + 1][2], s[2 * kp + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t b[4];
        hopper::ldmatrix_x4_trans(b, vb + hopper::swz<CPRV>(kp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                            dp * 2 + (lane >> 4)));
        hopper::mma_bf16(oacc[2 * dp], a, b[0], b[1]);
        hopper::mma_bf16(oacc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(0xffffffffu, lrow[h], 2);
  }
  // the row's logsumexp of the scaled scores, natural log: ln 2 (m + log2 l)
  // with m in log2 units; the backward's P = exp(s·scale - lse)
  if (lse != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + h * 8;
      if (row < Sq) lse[(long long)bh * Sq + row] = (mrow[h] + log2f(lrow[h])) * LN2;
    }
  }
  bf16* og = o + (long long)bh * Sq * Dv;
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + h * 8, col = d * 8 + (lane & 3) * 2;
      if (row < Sq && col < Dv) {  // Dv is a multiple of 16, so col + 1 < Dv too
        const float inv = 1.f / lrow[h];
        *reinterpret_cast<__nv_bfloat162*>(og + (long long)row * Dv + col) =
            __floats2bfloat162_rn(oacc[d][2 * h] * inv, oacc[d][2 * h + 1] * inv);
      }
    }
}

template <int DP, int DVP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
           int sk, int d, int dv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, DVP>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<DP, DVP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_mma_kernel<DP, DVP><<<grid, NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, sq, sk, d, dv, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// the tile is chosen by the wider of the two head dims, as in dispatch_d
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
             int sk, int d, int dv, float scale, int causal, cudaStream_t stream) {
  const int w = d > dv ? d : dv;
  if (w <= 32) return launch<32, 32>(q, k, v, o, lse, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 64) return launch<64, 64>(q, k, v, o, lse, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 128)
    return launch<128, 128>(q, k, v, o, lse, bh, sq, sk, d, dv, scale, causal, stream);
  return launch<192, 128>(q, k, v, o, lse, bh, sq, sk, d, dv, scale, causal, stream);
}

// ------------------------------------------------------------------------- //
// the backward: FA2's, deterministic (three kernels, no atomics)
// ------------------------------------------------------------------------- //
// rows [row0, row0 + n) of a [*, width] bf16 matrix into a swizzled [n, 8 CPRX]
// tile by cp.async; rows past `valid` and columns past `width` zero-filled
template <int CPRX>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int n, int valid,
                                          int width) {
  for (int i = threadIdx.x; i < n * CPRX; i += NTH) {
    const int r = i / CPRX, c = i % CPRX, row = row0 + r;
    const bool ok = row < valid && c * 8 < width;
    hopper::cp_async16(dst + hopper::swz<CPRX>(r, c), ok ? src + (long long)row * width + c * 8 : src,
                       ok);
  }
}

// A fragments (16 rows x 16 columns) of rows r0.. of a swizzled tile, k16 step kt
template <int CPRX>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile, int r0, int kt, int lane) {
  hopper::ldmatrix_x4(a, tile + hopper::swz<CPRX>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                  kt * 2 + (lane >> 4)));
}
// B fragments of two n8 tiles (rows n0 .. n0 + 15 of a [n][k] tile), k16 step kt
template <int CPRX>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const bf16* tile, int n0, int kt, int lane) {
  hopper::ldmatrix_x4(b, tile + hopper::swz<CPRX>(n0 + (lane & 7) + ((lane >> 4) & 1) * 8,
                                                  kt * 2 + ((lane >> 3) & 1)));
}
// B fragments of two n8 tiles (columns 16 c .. 16 c + 15) of a [k][n] tile
// (transposed by ldmatrix), k16 step over rows k0 .. k0 + 15
template <int CPRX>
__device__ __forceinline__ void ld_bt(uint32_t (&b)[4], const bf16* tile, int k0, int c, int lane) {
  hopper::ldmatrix_x4_trans(b, tile + hopper::swz<CPRX>(k0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                        c * 2 + (lane >> 4)));
}
// the A fragment of k16 step kp from a row of n8 accumulator tiles, rounded to bf16
template <int NJ>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[NJ][4], int kp) {
  a[0] = hopper::pack_bf16(x[2 * kp][0], x[2 * kp][1]);
  a[1] = hopper::pack_bf16(x[2 * kp][2], x[2 * kp][3]);
  a[2] = hopper::pack_bf16(x[2 * kp + 1][0], x[2 * kp + 1][1]);
  a[3] = hopper::pack_bf16(x[2 * kp + 1][2], x[2 * kp + 1][3]);
}
// acc[2 c], acc[2 c + 1] += a · (the two n8 tiles of b)
template <int N>
__device__ __forceinline__ void mma2(float (&acc)[N][4], int c, const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  hopper::mma_bf16(acc[2 * c], a, b[0], b[1]);
  hopper::mma_bf16(acc[2 * c + 1], a, b[2], b[3]);
}
template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}
// rows [row0, row0 + 16) of an [*, width] output from n8 accumulator tiles,
// times `mul`, to bf16; rows past `valid` and columns past `width` not written
template <int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[N][4], int row0,
                                           int valid, int width, float mul, int lane) {
#pragma unroll
  for (int d = 0; d < N; ++d)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + (lane >> 2) + h * 8, col = d * 8 + (lane & 3) * 2;
      if (row < valid && col < width)  // width is a multiple of 16, so col + 1 < width too
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * width + col) =
            __floats2bfloat162_rn(acc[d][2 * h] * mul, acc[d][2 * h + 1] * mul);
    }
}

// delta = rowsum(dO ⊙ O) in f32, one warp a row
__global__ void __launch_bounds__(NTH) flash_delta_kernel(const bf16* __restrict__ o,
                                                          const bf16* __restrict__ dout,
                                                          float* __restrict__ delta,
                                                          long long rows, int Dv) {
  const long long row = (long long)blockIdx.x * (NTH / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp
  float acc = 0.f;
  for (int c = lane * 2; c < Dv; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + row * Dv + c));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + row * Dv + c));
    acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
  }
  acc = warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// dK and dV: one CTA per (bh, 128 keys), each of the 8 warps owns 16 keys
// and walks the q tiles of BQ rows that see them (Q, dO, lse and delta
// double-buffered).  Per q tile, keys x queries in f32: S = K Qᵀ, dP = V
// dOᵀ, P = exp2(S·scale·log2 e - lse·log2 e), dS = P ⊙ (dP - delta); then
// dV += P dO and dK += dS Q with P and dS rounded to bf16 straight from the
// score registers.
constexpr int BKB = 128;  // keys a dK/dV CTA

template <int DP, int DVP, int BQB>
constexpr size_t dkdv_smem_bytes() {
  return (size_t)(BKB * DP + BKB * DVP + 2 * BQB * DP + 2 * BQB * DVP) * 2 + 2 * 2 * BQB * 4;
}

template <int DP, int DVP, int BQB>
__global__ void __launch_bounds__(NTH) flash_mma_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
    int D, int Dv, float scale, float scale_log2, int causal) {
  constexpr int CPR = DP / 8, CPRV = DVP / 8;
  constexpr int KT = DP / 16, KTV = DVP / 16;  // k16 steps over D and Dv
  constexpr int NJ = BQB / 8;                  // n8 tiles of queries
  constexpr int ND = DP / 8, NDV = DVP / 8;    // n8 tiles of dK and dV
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BKB * DP]
  bf16* vs = ks + BKB * DP;                      // [BKB * DVP]
  bf16* qs = vs + BKB * DVP;                     // [2][BQB * DP]
  bf16* dos = qs + 2 * BQB * DP;                 // [2][BQB * DVP]
  float* ls = reinterpret_cast<float*>(dos + 2 * BQB * DVP);  // [2][BQB]: lse·log2 e
  float* es = ls + 2 * BQB;                                   // [2][BQB]: delta

  const int bh = blockIdx.x, k0 = blockIdx.y * BKB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* qg = q + (long long)bh * Sq * D;
  const bf16* dog = dout + (long long)bh * Sq * Dv;
  const float* lg = lse + (long long)bh * Sq;
  const float* eg = delta + (long long)bh * Sq;
  const int off = Sk - Sq;

  auto load_q = [&](int buf, int q0) {
    load_tile<CPR>(qs + buf * BQB * DP, qg, q0, BQB, Sq, D);
    load_tile<CPRV>(dos + buf * BQB * DVP, dog, q0, BQB, Sq, Dv);
    for (int i = tid; i < BQB; i += NTH) {
      const bool ok = q0 + i < Sq;
      ls[buf * BQB + i] = ok ? lg[q0 + i] * LOG2E : 0.f;
      es[buf * BQB + i] = ok ? eg[q0 + i] : 0.f;
    }
  };

  // when causal (and Sq <= Sk), query rows before k0 - off see none of these keys
  const int n_qt = (Sq + BQB - 1) / BQB;
  const int t0 = causal && off >= 0 ? max(0, k0 - off) / BQB : 0;
  load_tile<CPR>(ks, k + (long long)bh * Sk * D, k0, BKB, Sk, D);
  load_tile<CPRV>(vs, v + (long long)bh * Sk * Dv, k0, BKB, Sk, Dv);
  if (t0 < n_qt) load_q(0, t0 * BQB);
  hopper::cp_async_commit();

  float dka[ND][4], dva[NDV][4];
  zero(dka);
  zero(dva);
  const int kw = warp * 16;              // this warp's keys in the tile
  const int key_lo = k0 + kw + (lane >> 2);  // this thread's keys: key_lo and key_lo + 8
  const float inv_sk = 1.f / (float)Sk;  // P of a row that sees no key (uniform)

  for (int t = t0; t < n_qt; ++t) {
    const int buf = (t - t0) & 1, q0 = t * BQB;
    if (t + 1 < n_qt) load_q(buf ^ 1, q0 + BQB);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and K, V) have landed
    __syncthreads();
    const bf16* qb = qs + buf * BQB * DP;
    const bf16* db = dos + buf * BQB * DVP;
    const float* lb = ls + buf * BQB;
    const float* eb = es + buf * BQB;

    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {  // S = K Qᵀ
      uint32_t a[4];
      ld_a<CPR>(a, ks, kw, kt, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ld_b<CPR>(b, qb, jp * 16, kt, lane);
        mma2(s, jp, a, b);
      }
    }
#pragma unroll
    for (int kt = 0; kt < KTV; ++kt) {  // dP = V dOᵀ
      uint32_t a[4];
      ld_a<CPRV>(a, vs, kw, kt, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ld_b<CPRV>(b, db, jp * 16, kt, lane);
        mma2(dp, jp, a, b);
      }
    }

    // P and dS in place (f32); only tiles that reach past an end or the
    // diagonal are masked: a masked pair has dS = 0 and P = 0, or the
    // forward's uniform 1/Sk in a row that sees no key at all
    const bool edge = q0 + BQB > Sq || k0 + BKB > Sk || (causal && q0 + off < k0 + BKB - 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + (lane & 3) * 2 + (e & 1);
        float p = exp2f(s[j][e] * scale_log2 - lb[col]);
        float d = p * (dp[j][e] - eb[col]);
        if (edge) {
          const int key = key_lo + (e >> 1) * 8, row = q0 + col;
          if (key >= Sk || row >= Sq) {
            p = 0.f;
            d = 0.f;
          } else if (causal && key > row + off) {
            p = row + off < 0 ? inv_sk : 0.f;
            d = 0.f;
          }
        }
        s[j][e] = p;
        dp[j][e] = d;
      }

#pragma unroll
    for (int kp = 0; kp < BQB / 16; ++kp) {  // dV += P dO, dK += dS Q
      uint32_t a[4];
      acc_to_a(a, s, kp);
#pragma unroll
      for (int c = 0; c < NDV / 2; ++c) {
        uint32_t b[4];
        ld_bt<CPRV>(b, db, kp * 16, c, lane);
        mma2(dva, c, a, b);
      }
      acc_to_a(a, dp, kp);
#pragma unroll
      for (int c = 0; c < ND / 2; ++c) {
        uint32_t b[4];
        ld_bt<CPR>(b, qb, kp * 16, c, lane);
        mma2(dka, c, a, b);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  hopper::cp_async_wait<0>();

  store_rows(dv + (long long)bh * Sk * Dv, dva, k0 + kw, Sk, Dv, 1.f, lane);
  store_rows(dk + (long long)bh * Sk * D, dka, k0 + kw, Sk, D, scale, lane);
}

// dQ: one CTA per (bh, 128 query rows), each warp 16 rows, walking the K/V
// tiles of BKQ keys it sees (double-buffered, as the forward): S = Q Kᵀ,
// dP = dO Vᵀ, dS = P ⊙ (dP - delta), dQ += dS K
template <int DP, int DVP, int BKQ>
constexpr size_t dq_smem_bytes() {
  return (size_t)(BQ * DP + BQ * DVP + 2 * BKQ * DP + 2 * BKQ * DVP) * 2;
}

template <int DP, int DVP, int BKQ>
__global__ void __launch_bounds__(NTH) flash_mma_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int D, int Dv,
    float scale, float scale_log2, int causal) {
  constexpr int CPR = DP / 8, CPRV = DVP / 8;
  constexpr int KT = DP / 16, KTV = DVP / 16;
  constexpr int NJ = BKQ / 8;  // n8 tiles of keys
  constexpr int ND = DP / 8;   // n8 tiles of dQ
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ * DP]
  bf16* dos = qs + BQ * DP;                      // [BQ * DVP]
  bf16* ks = dos + BQ * DVP;                     // [2][BKQ * DP]
  bf16* vs = ks + 2 * BKQ * DP;                  // [2][BKQ * DVP]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest (last) q tiles launch first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bf16* kg = k + (long long)bh * Sk * D;
  const bf16* vg = v + (long long)bh * Sk * Dv;
  const int off = Sk - Sq;

  int n_tiles = (Sk + BKQ - 1) / BKQ;
  if (causal && off >= 0) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1 + off) / BKQ + 1);

  load_tile<CPR>(qs, q + (long long)bh * Sq * D, q0, BQ, Sq, D);
  load_tile<CPRV>(dos, dout + (long long)bh * Sq * Dv, q0, BQ, Sq, Dv);
  load_tile<CPR>(ks, kg, 0, BKQ, Sk, D);
  load_tile<CPRV>(vs, vg, 0, BKQ, Sk, Dv);
  hopper::cp_async_commit();

  // this thread's rows r_lo and r_lo + 8: lse·log2 e and delta (0 past Sq,
  // where Q and dO are zero and nothing is stored)
  const int r_lo = q0 + warp * 16 + (lane >> 2);
  float lrow[2], erow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + h * 8;
    lrow[h] = row < Sq ? lse[(long long)bh * Sq + row] * LOG2E : 0.f;
    erow[h] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }
  float dqa[ND][4];
  zero(dqa);

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<CPR>(ks + (buf ^ 1) * BKQ * DP, kg, (t + 1) * BKQ, BKQ, Sk, D);
      load_tile<CPRV>(vs + (buf ^ 1) * BKQ * DVP, vg, (t + 1) * BKQ, BKQ, Sk, Dv);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const bf16* kb = ks + buf * BKQ * DP;
    const bf16* vb = vs + buf * BKQ * DVP;

    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {  // S = Q Kᵀ
      uint32_t a[4];
      ld_a<CPR>(a, qs, warp * 16, kt, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ld_b<CPR>(b, kb, jp * 16, kt, lane);
        mma2(s, jp, a, b);
      }
    }
#pragma unroll
    for (int kt = 0; kt < KTV; ++kt) {  // dP = dO Vᵀ
      uint32_t a[4];
      ld_a<CPRV>(a, dos, warp * 16, kt, lane);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ld_b<CPRV>(b, vb, jp * 16, kt, lane);
        mma2(dp, jp, a, b);
      }
    }

    const int k0 = t * BKQ;
    const bool edge = k0 + BKQ > Sk || (causal && k0 + BKQ - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float d = exp2f(s[j][e] * scale_log2 - lrow[h]) * (dp[j][e] - erow[h]);
        if (edge) {
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          if (key >= Sk || (causal && key > r_lo + h * 8 + off)) d = 0.f;
        }
        dp[j][e] = d;
      }

#pragma unroll
    for (int kp = 0; kp < BKQ / 16; ++kp) {  // dQ += dS K
      uint32_t a[4];
      acc_to_a(a, dp, kp);
#pragma unroll
      for (int c = 0; c < ND / 2; ++c) {
        uint32_t b[4];
        ld_bt<CPR>(b, kb, kp * 16, c, lane);
        mma2(dqa, c, a, b);
      }
    }
    __syncthreads();
  }
  hopper::cp_async_wait<0>();
  store_rows(dq + (long long)bh * Sq * D, dqa, q0 + warp * 16, Sq, D, scale, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// BQB: query rows a dK/dV step; BKQ: keys a dQ step (smaller where the
// dK and dV, or dQ, accumulators are wide: no spill)
template <int DP, int DVP, int BQB, int BKQ>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, float* delta, int bh, int sq,
               int sk, int d, int dvd, float scale, int causal, cudaStream_t stream) {
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const long long rows = (long long)bh * sq;
  flash_delta_kernel<<<(unsigned)((rows + NTH / 32 - 1) / (NTH / 32)), NTH, 0, stream>>>(
      static_cast<const bf16*>(o), dop, delta, rows, dvd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t kv_smem = dkdv_smem_bytes<DP, DVP, BQB>();
  if ((err = allow_smem(flash_mma_dkdv_kernel<DP, DVP, BQB>, kv_smem)) != cudaSuccess) return (int)err;
  flash_mma_dkdv_kernel<DP, DVP, BQB><<<dim3(bh, (sk + BKB - 1) / BKB), NTH, kv_smem, stream>>>(
      qp, kp, vp, dop, lp, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, d, dvd,
      scale, scale * LOG2E, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t q_smem = dq_smem_bytes<DP, DVP, BKQ>();
  if ((err = allow_smem(flash_mma_dq_kernel<DP, DVP, BKQ>, q_smem)) != cudaSuccess) return (int)err;
  flash_mma_dq_kernel<DP, DVP, BKQ><<<dim3(bh, (sq + BQ - 1) / BQ), NTH, q_smem, stream>>>(
      qp, kp, vp, dop, lp, delta, static_cast<bf16*>(dq), sq, sk, d, dvd, scale, scale * LOG2E,
      causal);
  return (int)cudaGetLastError();
}

int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const void* lse, void* dq, void* dk, void* dv, float* delta, int bh, int sq,
                 int sk, int d, int dvd, float scale, int causal, cudaStream_t stream) {
  const int w = d > dvd ? d : dvd;
  if (w <= 32)
    return launch_bwd<32, 32, 64, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, sq, sk, d,
                                      dvd, scale, causal, stream);
  if (w <= 64)
    return launch_bwd<64, 64, 64, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, sq, sk, d,
                                      dvd, scale, causal, stream);
  if (w <= 128)
    return launch_bwd<128, 128, 32, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, sq, sk, d,
                                        dvd, scale, causal, stream);
  return launch_bwd<192, 128, 16, 32>(q, k, v, o, dout, lse, dq, dk, dv, delta, bh, sq, sk, d,
                                      dvd, scale, causal, stream);
}
}  // namespace tc

}  // namespace

// q: [bh, sq, d]; k: [bh, sk, d]; v: [bh, sk, dv]; o: [bh, sq, dv];
// contiguous; d <= 192, dv <= 128; dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int bh, int sq, int sk, int d, int dv, float scale,
                                   int causal, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || dv <= 0 || d > 192 || dv > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core variant: same operands, bf16 only, d a multiple of 16
// up to 192 and dv a multiple of 16 up to 128.
// lse: [bh, sq] f32, each row's logsumexp of its scaled scores (natural
// log), for the backward; null writes none.
extern "C" int flash_attention_mma_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int bh, int sq, int sk, int d, int dv,
                                       float scale, int causal, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 192 || d % 16 || dv <= 0 || dv > 128 ||
      dv % 16)
    return (int)cudaErrorInvalidValue;
  return tc::dispatch(q, k, v, o, static_cast<float*>(lse), bh, sq, sk, d, dv, scale, causal,
                      static_cast<cudaStream_t>(stream));
}

// The backward of the mma variant: dq, dk, dv (bf16, the shapes of q, k, v)
// at the cotangent dout [bh, sq, dv], from the forward's o and lse; delta:
// [bh, sq] f32 scratch.  The same shapes as flash_attention_mma_fwd.
extern "C" int flash_attention_mma_bwd(const void* q, const void* k, const void* v, const void* o,
                                       const void* dout, const void* lse, void* dq, void* dk,
                                       void* dv, void* delta, int bh, int sq, int sk, int d,
                                       int dvd, float scale, int causal, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 192 || d % 16 || dvd <= 0 || dvd > 128 ||
      dvd % 16)
    return (int)cudaErrorInvalidValue;
  return tc::dispatch_bwd(q, k, v, o, dout, lse, dq, dk, dv, static_cast<float*>(delta), bh, sq,
                          sk, d, dvd, scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
