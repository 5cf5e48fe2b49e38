// Flash attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body `_kernel`): softmax(q k^T * scale) v for q, k [BH, S, D] and v [BH, S,
// Dv] (Dv = D on the dense path; MLA's prefill has D = 192, Dv = 128: 128
// latent-expanded dims plus the 64-wide rope key, against a 128-wide value)
// with an online (streaming) softmax, an optional causal mask offset by Sk - Sq, the finite
// -1e30 mask value, f32 running max / denominator / accumulator, and the
// output cast to the input type.  Two kernels, one C entry point each; the
// wrapper (kernels/flash_attention.py::select_variant) picks one.
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
//
// -Xptxas -v (sm_90a, nvcc 12.8), no spills: flash_mma_kernel 117 / 127 / 215
// / 195 registers for the 32/32, 64/64, 128/128 and 192/128 tiles, with 24 /
// 48 / 96 / 128 KB of dynamic shared memory; flash_fwd_kernel 64 / 80 / 104-106
// / 116 (H100; PERF.md).

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

// DP: q/k head dim padded to 32, 64, 128 or 192; DVP: v's, to 32, 64 or 128
template <int DP, int DVP>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * DP + 2 * BKV * DP + 2 * BKV * DVP) * 2;  // q, then k and v double-buffered
}

template <int DP, int DVP>
__global__ void __launch_bounds__(NTH) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int Sq, int Sk, int D, int Dv, float scale_log2, int causal) {
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
          if (key >= Sk) x = -INFINITY;                  // not a key at all
          else if (causal && key > row + off) x = NEG_INF;  // the reference's finite mask
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
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
           int dv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, DVP>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<DP, DVP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_mma_kernel<DP, DVP><<<grid, NTH, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), sq, sk, d, dv, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// the tile is chosen by the wider of the two head dims, as in dispatch_d
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
             int dv, float scale, int causal, cudaStream_t stream) {
  const int w = d > dv ? d : dv;
  if (w <= 32) return launch<32, 32>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 64) return launch<64, 64>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  if (w <= 128) return launch<128, 128>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
  return launch<192, 128>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream);
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
extern "C" int flash_attention_mma_fwd(const void* q, const void* k, const void* v, void* o,
                                       int bh, int sq, int sk, int d, int dv, float scale,
                                       int causal, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 192 || d % 16 || dv <= 0 || dv > 128 ||
      dv % 16)
    return (int)cudaErrorInvalidValue;
  return tc::dispatch(q, k, v, o, bh, sq, sk, d, dv, scale, causal,
                      static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
