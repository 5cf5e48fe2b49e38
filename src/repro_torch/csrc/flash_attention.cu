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
//    pipeline to amortise.  The backward (3) is on wgmma: it does 2.5x the
//    forward's work in every train step, where mma.sync's (FA2's layout,
//    one CTA of 8 warps an SM at 242-255 registers) trailed SDPA's
//    backward by 1.39-2.34x.
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
// 3. `wgmma_bwd`, the backward of (1) (entry flash_attention_wgmma_bwd; the
//    TPU kernel has no VJP, its model trains through plain jnp): dq, dk, dv
//    from the forward's O and lse, with its masks (a masked pair has dS =
//    0, as autograd through the reference's `where` gives it, and P = 0, or
//    the forward's uniform 1/Sk in a row that sees no key) and its causal
//    offset.  Bound by operations: five products over the pairs the mask
//    leaves (S = Q Kᵀ, dP = dO Vᵀ, dV = Pᵀ dO, dK = dSᵀ Q, dQ = dS K), 2.5x
//    the forward's, against q, k, v, o, dO and the three gradients moved
//    once; Hopper's full bf16 rate is wgmma's alone.  Three kernels:
//    - `flash_delta_kernel`: delta = rowsum(dO ⊙ O) and lse·log2 e, f32,
//      into rows padded to 128 a head (16-byte loads, 16 lanes a row);
//    - `flash_wgmma_dkdv_kernel`: one CTA per (bh, 128 keys), two
//      warpgroups of 64 keys each (the keys are wgmma's M rows).  Per query
//      tile of BQ rows: Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (m64nBQk16, both operands
//      from shared memory), Pᵀ = exp2(Sᵀ·scale·log2 e - lse·log2 e) and dSᵀ
//      = Pᵀ ⊙ (dPᵀ - delta) in f32 in the accumulators, rounded to bf16
//      straight into the A fragments of dV += Pᵀ dO and dK += dSᵀ Q (A from
//      registers, dO and Q read MN-major: FA3's identity, the m64nN
//      accumulator's values of k16 step j are that step's A fragment);
//    - `flash_wgmma_dq_kernel`: one CTA per (bh, 128 query rows), the
//      longest first, two warpgroups of 64 rows: per key tile of BKQ, S =
//      Q Kᵀ and dP = dO Vᵀ from shared memory, dS in f32, dQ += dS K from
//      registers.  dQ recomputes S and dP (7 products to FA2's 5) so that
//      no sum crosses CTAs and no float atomic is used: dq, dk and dv are
//      the same bits from run to run (a killed and resumed training run
//      must equal the uninterrupted one).
//    Loads are TMA boxes [1, rows, AW] of 3-D maps over [BH, S, D] (a box
//    never crosses heads; rows past S and columns past D are zero-filled,
//    which covers ragged S, Sq != Sk and head dims below the tile's), with
//    lse·log2 e and delta by 1-D bulk copies, all completed on mbarriers,
//    in a ring of up to STAGES = 3 stages refilled as both warpgroups
//    release them ("The producer" below: thread 0 issues them; a producer
//    warp would have cut the register cap ptxas plans the wgmma pipelines
//    by from 255 to 168, which serialised every wgmma at D = 128).  Causal
//    tiles wholly above the diagonal are skipped per CTA and per
//    warpgroup; masks are applied only in tiles that reach past an end or
//    the diagonal.  Tile classes by the wider head dim (D/Dv, swizzle atom,
//    BQ, BKQ): 64/64 (128-byte swizzle; D 16 to 64 zero-filled up to it;
//    64/64), 80/80 (32-byte swizzle, 16-column atoms: N = 80 is five of
//    them and five k16 steps over D, no padding to 128; 64/128), 128/128
//    (64/128) and 192/128 (32/64: dK and dV hold 160 registers a thread).
//    128-key dQ steps halve the barrier round trips where registers allow
//    (HuBERT's non-causal dQ 0.535 -> 0.360 ms, D 128's 0.158 -> 0.146 on
//    the H100 by scripts/flash_bwd_probe.py; at D 64 they cost 6%).
//
// -Xptxas -v (sm_90a, nvcc 12.9; scripts/flash_bwd_probe.py prints them),
// no spills: flash_mma_kernel 117 / 127 / 215 / 195 registers for the
// 32/32, 64/64, 128/128 and 192/128 tiles, with 24 / 48 / 96 / 128 KB of
// dynamic shared memory; flash_fwd_kernel 64 / 80 / 104-106 / 116;
// flash_wgmma_dkdv_kernel 163 / 178 / 226 / 226 registers for the 64/64,
// 80/80, 128/128 and 192/128 classes with 82.6 / 102.6 / 162.6 / 141.8 KB
// of dynamic shared memory (3 stages); flash_wgmma_dq_kernel 124 / 200 /
// 224 / 192 with 81.1 / 161.1 / 193.0 (2 stages fit) / 201.1 KB;
// flash_delta_kernel 26.  One CTA of 8 warps an SM, two for dQ at 64/64.

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
// the backward, wgmma_bwd: three kernels, deterministic (no atomics)
// ------------------------------------------------------------------------- //
namespace bwd {
constexpr int BK = 128;  // keys a dK/dV CTA, query rows a dQ CTA: two warpgroups of 64
// two warpgroups; thread 0 also issues the loads (see "The producer" below)
constexpr int NT = 256;
// the producer's ring of Q/dO or K/V tiles: at most STAGES, as many as fit
// in the 227 KB of shared memory a CTA may have beside the tiles loaded once
constexpr int STAGES = 3;
constexpr int SMEM_MAX = 232448;
constexpr int ring(int once_bytes, int stage_bytes) {
  const int fit = (SMEM_MAX - 1024 - once_bytes - (2 * STAGES + 1) * 8) / stage_bytes;
  return fit < STAGES ? fit : STAGES;
}

// rows of the lse·log2 e and delta scratch a head: Sq padded to BK with zeros,
// so that every stage's bulk copy is whole and 16-byte aligned
__host__ __device__ constexpr int padded_rows(int sq) { return (sq + BK - 1) / BK * BK; }

// A tile class: DP, DVP the q/k and v head dims as the tiles hold them (D
// and Dv zero-filled up to them by TMA), AW the bf16 columns of one swizzle
// atom (64: 128-byte swizzle; 16: 32-byte swizzle, for DP = 80, whose
// wgmma N = 80 is a whole number of 16-column atoms but not of 64), BQ the
// query rows of a dK/dV stage, BKQ the keys of a dQ stage.  A tile of R rows
// is stored as DP / AW atoms [R][AW], one after the other.
template <int DP_, int DVP_, int AW_, int BQ_, int BKQ_>
struct Tile {
  static constexpr int DP = DP_, DVP = DVP_, AW = AW_, BQ = BQ_, BKQ = BKQ_;
  static constexpr int SW = 2 * AW;                  // swizzle width, bytes
  static constexpr int NAD = DP / AW, NADV = DVP / AW;  // atoms across D and Dv
  static constexpr int KD = DP / 16, KDV = DVP / 16;    // k16 steps over D and Dv
  static constexpr int SBO = 8 * SW;                 // bytes between 8-row groups
  static_assert(DP % AW == 0 && DVP % AW == 0, "whole atoms");
};

// wgmma descriptors as a base and a step: a K-major operand (rows r0 ..
// of a tile of R rows, from desc_k(tile + r0 AW)) at k16 step kk, columns
// 16 kk .. 16 kk + 15, is desc_k(..) + k_step<T, R>(kk); an MN-major one
// (all the tile's columns, the atoms R·AW elements apart) at rows 16 kk ..
// 16 kk + 15 is desc_mn<T, R>(tile) + mn_step<T>(kk).  A step adds to the
// start address field (16-byte units), so the loops add an immediate.
template <class T>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile) {
  return hopper::wgmma_desc_sw<T::SW>(tile, 16, T::SBO);
}
template <class T, int R>
__device__ __forceinline__ constexpr uint64_t k_step(int kk) {
  return (uint64_t)(((kk * 16 / T::AW) * R * T::AW + (kk * 16) % T::AW) * 2 / 16);
}
template <class T, int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile) {
  return hopper::wgmma_desc_sw<T::SW>(tile, R * T::AW * 2, T::SBO);
}
template <class T>
__device__ __forceinline__ constexpr uint64_t mn_step(int kk) {
  return (uint64_t)(kk * 16 * T::AW * 2 / 16);
}
// d (64 x N) = A (64 x 16) B (16 x N), both K-major from shared memory;
// scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    hopper::wgmma_m64n128k16_ss<0, 0>(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    hopper::wgmma_m64n64k16_ss<0, 0>(d, da, db, scale_d);
  } else {
    static_assert(N == 32, "n32, n64 or n128");
    hopper::wgmma_m64n32k16_ss<0, 0>(d, da, db, scale_d);
  }
}
// d (64 x N) += A (64 x 16, registers) B (16 x N, MN-major from shared memory)
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) {
    hopper::wgmma_m64n64k16_rs<1>(d, a, db, 1);
  } else if constexpr (N == 80) {
    hopper::wgmma_m64n80k16_rs<1>(d, a, db, 1);
  } else if constexpr (N == 128) {
    hopper::wgmma_m64n128k16_rs<1>(d, a, db, 1);
  } else {
    static_assert(N == 192, "n64, n80, n128 or n192");
    hopper::wgmma_m64n192k16_rs<1>(d, a, db, 1);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// An m64nN accumulator's rows row_lo + {0, 8} (value v of a thread is row
// row_lo + 8 ((v / 2) % 2), column 8 (v / 4) + 2 (lane % 4) + v % 2) into
// an [*, width] bf16 output, times `mul`; rows past `valid` and columns past
// `width` not written
template <int N>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[N], int row_lo, int valid,
                                          int width, float mul, int lane) {
#pragma unroll
  for (int v = 0; v < N; v += 2) {
    const int row = row_lo + 8 * ((v >> 1) & 1), col = 8 * (v >> 2) + 2 * (lane & 3);
    if (row < valid && col < width)  // width is a multiple of 16, so col + 1 < width too
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row * width + col) =
          __floats2bfloat162_rn(acc[v] * mul, acc[v + 1] * mul);
  }
}

// delta = rowsum(dO ⊙ O) and lse·log2 e, f32, into rows padded to
// padded_rows(Sq) a head (zeros past Sq): 16 lanes a padded row, each with
// 16-byte loads of 8 columns of O and dO
__global__ void __launch_bounds__(NTH) flash_delta_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ lse2, float* __restrict__ delta, int bh, int Sq, int Dv) {
  const int Sqp = padded_rows(Sq);
  const long long row = ((long long)blockIdx.x * NTH + threadIdx.x) / 16;
  const int c = (threadIdx.x % 16) * 8;
  const bool live = row < (long long)bh * Sqp;
  const long long b = row / Sqp;
  const int i = (int)(row % Sqp);
  float acc = 0.f, l2 = 0.f;
  if (live && i < Sq) {
    const long long r = b * Sq + i;
    if (c < Dv) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + r * Dv + c);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + r * Dv + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(g2[e]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
    l2 = lse[r] * LOG2E;
  }
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (live && c == 0) {
    delta[row] = acc;
    lse2[row] = l2;
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* once,
                                              int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init(once, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// The producer.  Thread 0 of the first warpgroup issues every load: no
// warp of its own, because a producer warp or warpgroup would lower the
// register cap that ptxas sizes the wgmma pipelines by (the register file
// is split over the SM's four sub-partitions, and a ninth to twelfth warp
// puts three warps on one of them: 168 registers a thread; setmaxnreg
// raises what a consumer may hold, not the cap ptxas plans the wgmma
// pipelines for: at D = 128 it serialised every wgmma and spilled dV
// around each tile).  Two warpgroups alone leave 255.  The producer loads
// the first STAGES tiles up front; then, at the top of each tile, every
// further tile whose stage both warpgroups have released (`released`
// without waiting), and waits only for the tile its own warpgroup needs
// next, so a warpgroup running ahead does not stall on the other.
__device__ __forceinline__ bool released(uint64_t* empty, int parity, bool wait) {
  if (wait) {
    hopper::mbar_wait(empty, parity);
    return true;
  }
  return hopper::mbar_try_wait(empty, parity);
}

// P (f32) and dS of one (key, query) pair in a tile that reaches past an end
// or the causal diagonal: a masked pair has dS = 0 and P = 0, or the
// forward's uniform 1/Sk in a row that sees no key at all
__device__ __forceinline__ void mask_pair(float& p, float& d, int key, int row, int Sq, int Sk,
                                          int off, int causal) {
  if (key >= Sk || row >= Sq) {
    p = 0.f;
    d = 0.f;
  } else if (causal && key > row + off) {
    p = row + off < 0 ? 1.f / (float)Sk : 0.f;
    d = 0.f;
  }
}

// dK and dV: one CTA per (bh, BK keys).  The producer (thread 0 of warpgroup
// 0) loads the CTA's K and V tiles once, then keeps Q, dO, lse·log2 e and
// delta tiles of BQ query rows in a ring of STAGES, from the causal diagonal
// on.  Consumer
// warpgroup w owns keys k0 + 64 w ..: per stage, Sᵀ = K Qᵀ and dPᵀ = V dOᵀ
// (m64nBQ, both operands K-major from shared memory), Pᵀ and dSᵀ in f32 in
// the accumulators, then dV += Pᵀ dO and dK += dSᵀ Q with Pᵀ and dSᵀ rounded
// to bf16 straight into A fragments (the m64nN accumulator's values 8 j ..
// 8 j + 7 are the A fragment of k16 step j) and dO, Q read MN-major.
template <class T>
struct DkdvSmem {
  static constexpr int K_ELEMS = BK * T::DP, V_ELEMS = BK * T::DVP;
  static constexpr int Q_ELEMS = T::BQ * T::DP, DO_ELEMS = T::BQ * T::DVP;
  static constexpr int STAGE_TX = (Q_ELEMS + DO_ELEMS) * 2 + 2 * T::BQ * 4;
  static constexpr int ST = ring((K_ELEMS + V_ELEMS) * 2, STAGE_TX);
  static constexpr size_t BYTES =
      (size_t)(K_ELEMS + V_ELEMS) * 2 + (size_t)ST * STAGE_TX + (2 * ST + 1) * 8 + 1024;
};

template <class T>
__global__ void __launch_bounds__(NT, 1) flash_wgmma_dkdv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Sk, int D, int Dv, float scale, float scale_log2,
    int causal) {
  using S = DkdvSmem<T>;
  constexpr int BQ = T::BQ, AW = T::AW;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw + pad);  // [NAD][BK][AW]
  bf16* vs = ks + S::K_ELEMS;                          // [NADV][BK][AW]
  bf16* qs = vs + S::V_ELEMS;                          // [S::ST][NAD][BQ][AW]
  bf16* dos = qs + S::ST * S::Q_ELEMS;                // [S::ST][NADV][BQ][AW]
  float* ls = reinterpret_cast<float*>(dos + S::ST * S::DO_ELEMS);  // [S::ST][BQ]
  float* es = ls + S::ST * BQ;                                      // [S::ST][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(es + S::ST * BQ);
  uint64_t* empty = full + S::ST;
  uint64_t* kv_full = empty + S::ST;

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;
  const int off = Sk - Sq;  // aligns the diagonals when Sq != Sk
  const int n_qt = (Sq + BQ - 1) / BQ;
  // when causal (and Sq <= Sk), query rows before k0 - off see none of these keys
  const int t0 = causal && off >= 0 ? max(0, k0 - off) / BQ : 0;
  const int group = threadIdx.x / 128;
  init_barriers(full, empty, kv_full, S::ST);

  // the producer: thread 0 loads the CTA's K and V tiles and the first
  // S::ST query tiles, then refills each stage once both warpgroups have
  // released it (below)
  const bool producer = threadIdx.x == 0;
  const long long rows = (long long)bh * padded_rows(Sq);
  auto load_q = [&](int t) {
    const int s = (t - t0) % S::ST, q0 = t * BQ;
    hopper::mbar_expect_tx(&full[s], S::STAGE_TX);
    bf16* qb = qs + s * S::Q_ELEMS;
    bf16* db = dos + s * S::DO_ELEMS;
#pragma unroll
    for (int a = 0; a < T::NAD; ++a) hopper::tma_load_3d(qb + a * BQ * AW, &qmap, &full[s], a * AW, q0, bh);
#pragma unroll
    for (int a = 0; a < T::NADV; ++a) hopper::tma_load_3d(db + a * BQ * AW, &domap, &full[s], a * AW, q0, bh);
    hopper::bulk_load(ls + s * BQ, lse2 + rows + q0, BQ * 4, &full[s]);
    hopper::bulk_load(es + s * BQ, delta + rows + q0, BQ * 4, &full[s]);
  };
  if (producer) {
    hopper::mbar_expect_tx(kv_full, (S::K_ELEMS + S::V_ELEMS) * 2);
#pragma unroll
    for (int a = 0; a < T::NAD; ++a) hopper::tma_load_3d(ks + a * BK * AW, &kmap, kv_full, a * AW, k0, bh);
#pragma unroll
    for (int a = 0; a < T::NADV; ++a) hopper::tma_load_3d(vs + a * BK * AW, &vmap, kv_full, a * AW, k0, bh);
    for (int t = t0; t < n_qt && t < t0 + S::ST; ++t) load_q(t);
  }
  int next = t0 + S::ST;  // the producer's next tile to load

  // consumer warpgroup `group` owns keys kw0 .. kw0 + 63
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int kw0 = k0 + 64 * group;
  const int key_lo = kw0 + warp * 16 + (lane >> 2);  // this thread's keys: key_lo, key_lo + 8
  const uint64_t kdesc = desc_k<T>(ks + 64 * group * AW), vdesc = desc_k<T>(vs + 64 * group * AW);
  float dka[T::DP / 2], dva[T::DVP / 2];
  zero(dka);
  zero(dva);
  hopper::mbar_wait(kv_full, 0);

  for (int t = t0; t < n_qt; ++t) {
    const int it = t - t0, s = it % S::ST, q0 = t * BQ;
    if (producer) {
      for (; next < n_qt; ++next) {
        const int ni = next - t0;  // its stage was tile next - S::ST's
        if (!released(&empty[ni % S::ST], (ni / S::ST - 1) & 1, next <= t)) break;
        load_q(next);
      }
    }
    __syncwarp();
    hopper::mbar_wait(&full[s], (it / S::ST) & 1);
    // nothing to add when every key of this warpgroup is past Sk, or masked
    // for every row of the tile
    const bool skip = kw0 >= Sk || (causal && off >= 0 && q0 + BQ - 1 + off < kw0);
    if (skip) {
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      continue;
    }
    const bf16* qb = qs + s * S::Q_ELEMS;
    const bf16* db = dos + s * S::DO_ELEMS;
    const float* lb = ls + s * BQ;
    const float* eb = es + s * BQ;
    float st[BQ / 2], dpt[BQ / 2];
    const uint64_t qdesc = desc_k<T>(qb), ddesc = desc_k<T>(db);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KD; ++kk)  // Sᵀ = K Qᵀ
      mma_ss<BQ>(st, kdesc + k_step<T, BK>(kk), qdesc + k_step<T, BQ>(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < T::KDV; ++kk)  // dPᵀ = V dOᵀ
      mma_ss<BQ>(dpt, vdesc + k_step<T, BK>(kk), ddesc + k_step<T, BQ>(kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();

    // P = exp2(S·scale·log2 e - lse·log2 e), dS = P ⊙ (dP - delta), in f32;
    // masked only in tiles that reach past an end or the diagonal.  Value
    // 8 j + 2 r (+ 1) of a thread is key key_lo + 8 (r % 2), query
    // q0 + 16 j + 8 (r / 2) + 2 (lane % 4) (+ 1); the values of k16 step j
    // are the A fragment of step j of dV and dK
    const bool edge = q0 + BQ > Sq || kw0 + 64 > Sk || (causal && q0 + off < kw0 + 63);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const int c = 16 * j + 2 * (lane & 3);
      const float2 l2[2] = {*reinterpret_cast<const float2*>(lb + c),
                            *reinterpret_cast<const float2*>(lb + c + 8)};
      const float2 e2[2] = {*reinterpret_cast<const float2*>(eb + c),
                            *reinterpret_cast<const float2*>(eb + c + 8)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = 8 * j + 2 * r;
        const float2 l = l2[r >> 1], e = e2[r >> 1];
        float p0 = exp2f(st[v] * scale_log2 - l.x), p1 = exp2f(st[v + 1] * scale_log2 - l.y);
        float d0 = p0 * (dpt[v] - e.x), d1 = p1 * (dpt[v + 1] - e.y);
        if (edge) {
          const int key = key_lo + 8 * (r & 1), row = q0 + c + 8 * (r >> 1);
          mask_pair(p0, d0, key, row, Sq, Sk, off, causal);
          mask_pair(p1, d1, key, row + 1, Sq, Sk, off, causal);
        }
        pa[j][r] = hopper::pack_bf16(p0, p1);
        da[j][r] = hopper::pack_bf16(d0, d1);
      }
    }
    const uint64_t dmn = desc_mn<T, BQ>(db), qmn = desc_mn<T, BQ>(qb);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) mma_rs<T::DVP>(dva, pa[j], dmn + mn_step<T>(j));  // dV += Pᵀ dO
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) mma_rs<T::DP>(dka, da[j], qmn + mn_step<T>(j));  // dK += dSᵀ Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  store_acc(dv + (long long)bh * Sk * Dv, dva, key_lo, Sk, Dv, 1.f, lane);
  store_acc(dk + (long long)bh * Sk * D, dka, key_lo, Sk, D, scale, lane);
}

// dQ: one CTA per (bh, BK query rows), the longest (last) first.  The
// producer (thread 0 of warpgroup 0) loads the CTA's Q and dO tiles once, then keeps K and V tiles of
// BKQ keys in a ring of STAGES, up to the causal diagonal.  Consumer
// warpgroup w owns rows q0 + 64 w ..: per stage, S = Q Kᵀ and dP = dO Vᵀ
// (m64nBKQ, K-major), dS = P ⊙ (dP - delta) in f32, then dQ += dS K with dS
// rounded to bf16 into A fragments and K read MN-major.  dQ is summed over
// the key tiles in order, in registers: no sum crosses CTAs.
template <class T>
struct DqSmem {
  static constexpr int Q_ELEMS = BK * T::DP, DO_ELEMS = BK * T::DVP;
  static constexpr int K_ELEMS = T::BKQ * T::DP, V_ELEMS = T::BKQ * T::DVP;
  static constexpr int STAGE_TX = (K_ELEMS + V_ELEMS) * 2;
  static constexpr int ST = ring((Q_ELEMS + DO_ELEMS) * 2, STAGE_TX);
  static constexpr size_t BYTES =
      (size_t)(Q_ELEMS + DO_ELEMS) * 2 + (size_t)ST * STAGE_TX + (2 * ST + 1) * 8 + 1024;
};

template <class T>
__global__ void __launch_bounds__(NT, T::DP <= 64 && T::BKQ <= 64 ? 2 : 1) flash_wgmma_dq_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dq,
    int Sq, int Sk, int D, float scale, float scale_log2, int causal) {
  using S = DqSmem<T>;
  constexpr int BKQ = T::BKQ, AW = T::AW;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw + pad);  // [NAD][BK][AW]
  bf16* dos = qs + S::Q_ELEMS;                         // [NADV][BK][AW]
  bf16* ks = dos + S::DO_ELEMS;                        // [S::ST][NAD][BKQ][AW]
  bf16* vs = ks + S::ST * S::K_ELEMS;                 // [S::ST][NADV][BKQ][AW]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + S::ST * S::V_ELEMS);
  uint64_t* empty = full + S::ST;
  uint64_t* qd_full = empty + S::ST;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BK;  // the longest (last) q tiles launch first
  const int off = Sk - Sq;
  int n_kt = (Sk + BKQ - 1) / BKQ;
  // keys past the block's last row (shifted by off) are masked for every row
  if (causal && off >= 0) n_kt = min(n_kt, (min(q0 + BK, Sq) - 1 + off) / BKQ + 1);
  const int group = threadIdx.x / 128;
  init_barriers(full, empty, qd_full, S::ST);

  // the producer, as in the dK/dV kernel: the CTA's Q and dO tiles, then
  // the first S::ST key tiles, each stage refilled once it is released
  const bool producer = threadIdx.x == 0;
  auto load_kv = [&](int t) {
    const int s = t % S::ST;
    hopper::mbar_expect_tx(&full[s], S::STAGE_TX);
    bf16* kb = ks + s * S::K_ELEMS;
    bf16* vb = vs + s * S::V_ELEMS;
#pragma unroll
    for (int a = 0; a < T::NAD; ++a) hopper::tma_load_3d(kb + a * BKQ * AW, &kmap, &full[s], a * AW, t * BKQ, bh);
#pragma unroll
    for (int a = 0; a < T::NADV; ++a) hopper::tma_load_3d(vb + a * BKQ * AW, &vmap, &full[s], a * AW, t * BKQ, bh);
  };
  if (producer) {
    hopper::mbar_expect_tx(qd_full, (S::Q_ELEMS + S::DO_ELEMS) * 2);
#pragma unroll
    for (int a = 0; a < T::NAD; ++a) hopper::tma_load_3d(qs + a * BK * AW, &qmap, qd_full, a * AW, q0, bh);
#pragma unroll
    for (int a = 0; a < T::NADV; ++a) hopper::tma_load_3d(dos + a * BK * AW, &domap, qd_full, a * AW, q0, bh);
    for (int t = 0; t < n_kt && t < S::ST; ++t) load_kv(t);
  }
  int next = S::ST;  // the producer's next tile to load

  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qw0 = q0 + 64 * group;
  const int r_lo = qw0 + warp * 16 + (lane >> 2);  // this thread's rows: r_lo, r_lo + 8
  // key tiles this warpgroup sees: none past Sq; up to its own last row's diagonal
  int n_w = qw0 >= Sq ? 0 : n_kt;
  if (causal && off >= 0 && n_w > 0) n_w = min(n_w, (min(qw0 + 64, Sq) - 1 + off) / BKQ + 1);
  // lse·log2 e and delta of the thread's rows (0 past Sq: the scratch is padded)
  float lrow[2], erow[2];
  const long long rows = (long long)bh * padded_rows(Sq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] = lse2[rows + r_lo + 8 * h];
    erow[h] = delta[rows + r_lo + 8 * h];
  }
  const uint64_t qdesc = desc_k<T>(qs + 64 * group * AW), ddesc = desc_k<T>(dos + 64 * group * AW);
  float dqa[T::DP / 2];
  zero(dqa);
  hopper::mbar_wait(qd_full, 0);

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % S::ST;
    if (producer) {
      for (; next < n_kt; ++next) {
        if (!released(&empty[next % S::ST], (next / S::ST - 1) & 1, next <= t)) break;
        load_kv(next);
      }
    }
    __syncwarp();
    hopper::mbar_wait(&full[s], (t / S::ST) & 1);
    if (t >= n_w) {  // past this warpgroup's diagonal: release the stage
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      continue;
    }
    const bf16* kb = ks + s * S::K_ELEMS;
    const bf16* vb = vs + s * S::V_ELEMS;
    const uint64_t kdesc = desc_k<T>(kb), vdesc = desc_k<T>(vb);
    float sa[BKQ / 2], dpa[BKQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KD; ++kk)  // S = Q Kᵀ
      mma_ss<BKQ>(sa, qdesc + k_step<T, BK>(kk), kdesc + k_step<T, BKQ>(kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < T::KDV; ++kk)  // dP = dO Vᵀ
      mma_ss<BKQ>(dpa, ddesc + k_step<T, BK>(kk), vdesc + k_step<T, BKQ>(kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();

    // value 8 j + 2 r (+ 1) of a thread is row r_lo + 8 (r % 2), key
    // kt0 + 16 j + 8 (r / 2) + 2 (lane % 4) (+ 1)
    const int kt0 = t * BKQ;
    const bool edge = kt0 + BKQ > Sk || (causal && kt0 + BKQ - 1 > qw0 + off);
    uint32_t dsa[BKQ / 16][4];
#pragma unroll
    for (int j = 0; j < BKQ / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int v = 8 * j + 2 * r, h = r & 1;
        float d0 = exp2f(sa[v] * scale_log2 - lrow[h]) * (dpa[v] - erow[h]);
        float d1 = exp2f(sa[v + 1] * scale_log2 - lrow[h]) * (dpa[v + 1] - erow[h]);
        if (edge) {
          const int key = kt0 + 16 * j + 8 * (r >> 1) + 2 * (lane & 3), row = r_lo + 8 * h;
          if (key >= Sk || (causal && key > row + off)) d0 = 0.f;
          if (key + 1 >= Sk || (causal && key + 1 > row + off)) d1 = 0.f;
        }
        dsa[j][r] = hopper::pack_bf16(d0, d1);
      }
    const uint64_t kmn = desc_mn<T, BKQ>(kb);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BKQ / 16; ++j) mma_rs<T::DP>(dqa, dsa[j], kmn + mn_step<T>(j));  // dQ += dS K
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  store_acc(dq + (long long)bh * Sq * D, dqa, r_lo, Sq, D, scale, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// scratch: 2 bh padded_rows(sq) floats (lse·log2 e, then delta)
template <class T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dq, void* dk, void* dv, float* scratch, int bh, int sq,
               int sk, int d, int dvd, float scale, int causal, cudaStream_t stream) {
  const long long rows = (long long)bh * padded_rows(sq);
  float* lse2 = scratch;
  float* delta = scratch + rows;
  // [bh, s, width] read in boxes of [1, box_rows, AW]: a box never crosses
  // heads, and rows past s (and columns past width) are zero-filled
  auto map = [&](CUtensorMap* m, const void* base, int s, int width, int box_rows) {
    const long long dims[3] = {width, s, bh};
    const long long strides[2] = {2LL * width, 2LL * width * s};
    const int box[3] = {T::AW, box_rows, 1};
    return hopper::make_map_bf16_3d(m, base, dims, strides, box, T::SW);
  };
  CUtensorMap qa, doa, ka, va, qb, dob, kb, vb;
  if (!map(&qa, q, sq, d, T::BQ) || !map(&doa, dout, sq, dvd, T::BQ) || !map(&ka, k, sk, d, BK) ||
      !map(&va, v, sk, dvd, BK) || !map(&qb, q, sq, d, BK) || !map(&dob, dout, sq, dvd, BK) ||
      !map(&kb, k, sk, d, T::BKQ) || !map(&vb, v, sk, dvd, T::BKQ))
    return (int)cudaErrorInvalidValue;
  const float sl2 = scale * LOG2E;
  flash_delta_kernel<<<(unsigned)((rows * 16 + NTH - 1) / NTH), NTH, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      lse2, delta, bh, sq, dvd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if ((err = allow_smem(flash_wgmma_dkdv_kernel<T>, DkdvSmem<T>::BYTES)) != cudaSuccess) return (int)err;
  flash_wgmma_dkdv_kernel<T><<<dim3(bh, (sk + BK - 1) / BK), NT, DkdvSmem<T>::BYTES, stream>>>(
      qa, ka, va, doa, lse2, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, d, dvd,
      scale, sl2, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = allow_smem(flash_wgmma_dq_kernel<T>, DqSmem<T>::BYTES)) != cudaSuccess) return (int)err;
  flash_wgmma_dq_kernel<T><<<dim3(bh, (sq + BK - 1) / BK), NT, DqSmem<T>::BYTES, stream>>>(
      qb, kb, vb, dob, lse2, delta, static_cast<bf16*>(dq), sq, sk, d, scale, sl2, causal);
  return (int)cudaGetLastError();
}

// the tile class by the wider of the two head dims: 64/64, 80/80 (32-byte
// swizzle), 128/128, 192/128 (dK/dV stages of 32 query rows: the wider dK
// accumulator leaves fewer registers for Sᵀ and dPᵀ)
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const void* lse, void* dq, void* dk, void* dv, float* scratch, int bh, int sq,
                 int sk, int d, int dvd, float scale, int causal, cudaStream_t stream) {
  const int w = d > dvd ? d : dvd;
  if (w <= 64)
    return launch_bwd<Tile<64, 64, 64, 64, 64>>(q, k, v, o, dout, lse, dq, dk, dv, scratch, bh, sq,
                                                 sk, d, dvd, scale, causal, stream);
  if (w <= 80)
    return launch_bwd<Tile<80, 80, 16, 64, 128>>(q, k, v, o, dout, lse, dq, dk, dv, scratch, bh, sq,
                                                 sk, d, dvd, scale, causal, stream);
  if (w <= 128)
    return launch_bwd<Tile<128, 128, 64, 64, 128>>(q, k, v, o, dout, lse, dq, dk, dv, scratch, bh,
                                                   sq, sk, d, dvd, scale, causal, stream);
  return launch_bwd<Tile<192, 128, 64, 32, 64>>(q, k, v, o, dout, lse, dq, dk, dv, scratch, bh, sq,
                                                 sk, d, dvd, scale, causal, stream);
}
}  // namespace bwd
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

// f32 elements of the scratch flash_attention_wgmma_bwd takes for bh heads of
// sq query rows: 2 bh padded_rows(sq) (lse·log2 e, then delta)
extern "C" long long flash_attention_bwd_scratch_floats(int bh, int sq) {
  return 2LL * bh * tc::bwd::padded_rows(sq);
}

// The backward of the mma variant (wgmma_bwd): dq, dk, dv (bf16, the shapes
// of q, k, v) at the cotangent dout [bh, sq, dv], from the forward's o and
// lse; scratch: flash_attention_bwd_scratch_floats(bh, sq) f32.  The same
// shapes as flash_attention_mma_fwd.
extern "C" int flash_attention_wgmma_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* scratch, int bh,
                                         int sq, int sk, int d, int dvd, float scale, int causal,
                                         void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 192 || d % 16 || dvd <= 0 || dvd > 128 ||
      dvd % 16)
    return (int)cudaErrorInvalidValue;
  return tc::bwd::dispatch_bwd(q, k, v, o, dout, lse, dq, dk, dv, static_cast<float*>(scratch), bh,
                               sq, sk, d, dvd, scale, causal, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
