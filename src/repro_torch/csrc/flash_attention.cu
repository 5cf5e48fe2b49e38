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
// 2. `flash_cuda_core_kernel` (entry flash_attention_fwd; namespace simt):
//    f32, and bf16 with other head dims; any D up to 192 and Dv up to 128.
//    FFMA on the CUDA cores in IEEE f32, nothing rounded to TF32 or bf16, so
//    it is bound by f32 operations (BH 32, S 1024, D 64, causal: 4.30
//    GFLOP, 0.0642 ms at 67 TFLOP/s).  The earlier kernel (4 x 4 scores a
//    thread, scalar loads between four barriers a 64-key tile, the softmax
//    in a pass through shared memory) ran at 0.2896 ms there, 22% of the
//    bound: its loads cost 16-34% of a call, its softmax pass 7-13%, and its
//    inner loops read 2 bytes of shared memory an FFMA.  The design:
//    - tile classes by the wider head dim, 32/32, 64/64 (64-key tiles),
//      128/128 and 192/128 (32-key tiles; q tiles of 64 rows at 192/128,
//      whose Q and K halves leave no room for 128); one CTA a q tile, the
//      last (longest causal) first, one CTA an SM (simt::Cls);
//    - each block of 32 query rows (a warp's) is walked by two warps, one
//      over the even key tiles and one over the odd, whose running maxima,
//      denominators and accumulators merge at the end: a causal q tile
//      keeps two warps on every scheduler to its end, where one walk a row
//      block left the long tiles' warps alone on theirs (0.1603 ms);
//    - a lane holds 8 rows x 8 keys of a 64-key tile's scores (8 x 4 of a
//      32-key tile) and 8 rows x Dv / 8 output columns; every fragment is
//      one 16-byte read: Q transposed, K as it lies (keys lx + 8 j, 4 d a
//      read), P [key][row] in rows of 36 floats, V as it lies, 1 byte of
//      shared memory an FFMA at D 64;
//    - the online softmax on the score registers in base 2 (scale·log2 e
//      folded into one multiply, -1e30·log2 e as the mask, ex2.approx), the
//      row max by three shuffles among the row's 8 lanes, alpha applied in
//      registers; P goes once through the warp's own tile;
//    - K and V as half-tiles through a cp.async ring (16-byte copies for
//      f32 with D and Dv multiples of 4 and k, v, o on 16-byte boundaries;
//      element loads converted to f32 otherwise), each half of the warps
//      with its own part of the ring and one barrier of its own a step;
//    - the products' loops unrolled 8 d and 8 keys deep: wholly unrolled
//      (~4,400 instructions a product at D 64) the first build ran 3.2x
//      slower, out of the instruction cache.
//    On an H100 80GB HBM3 at 700 W (scripts/flash_f32_probe.py --earlier,
//    both in one session): 0.1360 ms at D 64 (47% of the bound; the earlier
//    kernel 0.2896, SDPA's memory-efficient backend 0.2275), 0.2594 at D
//    128 (49%; 0.6228; SDPA 0.2813), 0.2111 at MLA's 192/128 (38%; 0.5325;
//    SDPA 0.2107).  Not the earlier kernel's bits (base 2, other sums); two
//    launches agree.  What is left at D 64: the FFMAs with a quarter of
//    their shared-memory reads and no loads alone take 0.1259 ms; the FFMA
//    stream fills ~59% of the issue slots at 247 registers and two warps a
//    scheduler.  Tried and left out: two CTAs of 64 rows an SM (0.1384),
//    the products unrolled 4 or 16 deep (0.1396, 0.1349 but 11-25% slower
//    at 128/128 and 192/128).
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
// -Xptxas -v (sm_90a, nvcc 12.9; scripts/flash_bwd_probe.py and
// scripts/flash_f32_probe.py print them),
// no spills: flash_mma_kernel 117 / 127 / 215 / 195 registers for the
// 32/32, 64/64, 128/128 and 192/128 tiles, with 24 / 48 / 96 / 128 KB of
// dynamic shared memory; flash_cuda_core_kernel 219-221 / 247-248 / 242-254
// / 244 registers for the 32/32, 64/64, 128/128 and 192/128 classes, with
// 164,352 / 211,968 / 205,824 / 171,008 bytes of dynamic shared memory (one
// CTA an SM; simt::Cls::BYTES, flash_cuda_core_layout);
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

constexpr float NEG_INF = -1e30f;  // the reference's finite mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// ------------------------------------------------------------------------- //
// 2. cuda_core: f32 FFMA on the score registers, fed by a cp.async ring
// ------------------------------------------------------------------------- //
namespace simt {
constexpr float LOG2E = 1.4426950408889634f;

// A tile class.  A CTA takes one q tile of IR query rows of one head: WI =
// IR / 32 row blocks of 32 (a warp's rows) times two halves of the key
// tiles (split-KV: half 0 takes the even tiles, half 1 the odd ones, and the
// two partial softmaxes are merged at the end), NW = 2 WI warps.  DP, DVP:
// the q/k and v head dims as the tiles hold them (zero past D and Dv); BK:
// the keys of a K/V tile; NS: the ring's slots, each the K halves or the V
// halves of two tiles (one for each half of the warps, each filled and read
// by that half alone).  Shared memory: Q
// transposed, [DP][QLD]; the ring, a K half [BK][KLD] or a V half [BK][DVP]
// a tile, as they lie; a [BK][32] P tile a warp.  QLD is 4 mod 32, so that
// the transposing copies of 8 consecutive d of 4 rows land on 32 banks; KLD
// is 4 mod 8, so that the 8 keys lx + 8 j a read of 4 d takes (one per lane
// lx) fall on 8 different 16-byte bank groups; every fragment read is one
// float4.
template <int DP_, int DVP_, int BK_, int IR_, int NS_>
struct Cls {
  static constexpr int DP = DP_, DVP = DVP_, BK = BK_, IR = IR_, NS = NS_;
  static constexpr int WI = IR / 32, NW = 2 * WI, NT = 32 * NW;
  static constexpr int TN = BK / 8;   // keys a lane holds of a tile's scores
  static constexpr int TV = DVP / 8;  // output columns a lane holds
  static constexpr int QLD = IR + 4, KLD = DP + 4;
  static constexpr int K_FLOATS = BK * KLD, V_FLOATS = BK * DVP;
  static constexpr int HALF = K_FLOATS > V_FLOATS ? K_FLOATS : V_FLOATS;  // a tile's half
  static constexpr int SLOT = 2 * HALF;
  static constexpr int Q_FLOATS = DP * QLD;
  static constexpr int PLD = 36;  // a key's row of P: 32 query rows, padded
  static constexpr int P_FLOATS = BK * PLD;  // a warp's P tile
  static constexpr int BYTES = (Q_FLOATS + NS * SLOT + NW * P_FLOATS) * 4;
  static_assert(IR % 32 == 0 && (BK == 32 || BK == 64) && DVP % 32 == 0 && DP % 8 == 0, "tile");
  static_assert(HALF % 4 == 0 && Q_FLOATS % 4 == 0 && QLD % 32 == 4 && KLD % 8 == 4, "layout");
  static_assert((BK * DP / 4) % (NT / 2) == 0 && (IR * DP) % NT == 0 &&
                    (BK * DVP / 4) % (NT / 2) == 0,
                "copies");
  static_assert(NS * SLOT >= WI * 32 * (16 + 8 * TV), "the merge's exchange fits in the ring");
  static_assert(NS >= 2 && BYTES <= 232448, "shared memory");
};
// the classes by the wider head dim: 8 warps (4 at 192/128, whose Q and K
// halves leave room for q tiles of 64 rows and a ring of two slots), one
// CTA an SM
using C32 = Cls<32, 32, 64, 128, 4>;
using C64 = Cls<64, 64, 64, 128, 3>;
using C128 = Cls<128, 128, 32, 128, 3>;
using C192 = Cls<192, 128, 32, 64, 2>;

__device__ __forceinline__ void put4(float* f, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// R rows from row0 of a [*, D] matrix into a transposed [DP][LD] tile, zero
// past `valid` rows and past D: copy e = tid + t NT is row (e / 8) % R, d
// (e / (8 R)) 8 + e % 8, so 8 threads read one 32-byte sector of a row and a
// warp's 4 rows x 8 d land on 32 banks (LD = 4 mod 32).  FAST: 4-byte
// cp.async (f32); else element loads converted to f32.
template <class C, int R, int LD, bool FAST, typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src, int row0, int valid, int D,
                                       int tid) {
  constexpr int N = R * C::DP / C::NT;
#pragma unroll 4
  for (int t = 0; t < N; ++t) {
    const int e = tid + t * C::NT, r = (e >> 3) % R, d = e / (8 * R) * 8 + (e & 7);
    const bool ok = row0 + r < valid && d < D;
    const T* s = src + (long long)(row0 + r) * D + d;
    if constexpr (FAST) {
      hopper::cp_async4(dst + d * LD + r, ok ? s : src, ok);
    } else {
      dst[d * LD + r] = ok ? to_f32(*s) : 0.f;
    }
  }
}

// 2^x by the SFU's ex2.approx (2 ulp; denormal results flushed to 0, as
// the softmax's weights below 2^-126 may be)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// BK rows from row k0 of a [*, W] matrix into a [BK][LD] tile as they lie,
// zero past Sk and past W, by the NT / 2 threads of one half (htid):
// FAST copies 16 bytes at a time (f32, W % 4 == 0, 16-byte aligned rows),
// else element loads converted to f32.
template <class C, int WP, int LD, bool FAST, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int k0, int Sk, int W,
                                          int htid) {
  constexpr int NTH = C::NT / 2, CPR = WP / 4, N = C::BK * CPR / NTH;
#pragma unroll 8
  for (int i = 0; i < N; ++i) {
    const int c = htid + i * NTH, r = c / CPR, col = c % CPR * 4;
    const T* s = src + (long long)(k0 + r) * W + col;
    if constexpr (FAST) {
      const bool ok = k0 + r < Sk && col < W;
      hopper::cp_async16(dst + r * LD + col, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + r < Sk && col + j < W;
        dst[r * LD + col + j] = ok ? to_f32(s[j]) : 0.f;
      }
    }
  }
}

// Step h of a half's walk into its part of a ring slot, by that half's
// threads: the K half (h even) or the V half (h odd) of its key tile 2 (h /
// 2) + half, zero past Sk, D and Dv.
template <class C, bool FAST, typename T>
__device__ __forceinline__ void fetch(float* dst, const T* k, const T* v, int h, int half, int Sk,
                                      int D, int Dv, int htid) {
  const int k0 = ((h >> 1) * 2 + half) * C::BK;
  if ((h & 1) == 0)
    load_rows<C, C::DP, C::KLD, FAST>(dst, k, k0, Sk, D, htid);
  else
    load_rows<C, C::DVP, C::DVP, FAST>(dst, v, k0, Sk, Dv, htid);
}

// KV tiles a block of query rows [first, last] needs: all of them, or, when
// causal and every row sees a key, up to the last row's diagonal (keys past
// a row's diagonal are masked, so a tile past every row's diagonal adds
// exactly zero: alpha = 1, P = 0); none for no rows.
__device__ __forceinline__ int tiles_for(int first, int last, int Sq, int Sk, int BK,
                                         int causal) {
  if (first >= Sq) return 0;
  const int all = (Sk + BK - 1) / BK, off = Sk - Sq;
  if (!causal || first + off < 0) return all;
  const int need = (min(last, Sq - 1) + off) / BK + 1;
  return need < all ? need : all;
}

// softmax(q kᵀ · scale) v on the CUDA cores in f32, tile class C.  The grid
// is (BH, n) for n = ceil(Sq / IR) q tiles a head, the last (longest causal)
// q tile first.  Warp w holds rows 32 (w % WI) .. + 31 of the tile and walks
// the key tiles of its half, w / WI: tiles 2 u + w / WI.  Lane (ly, lx) =
// (lane / 8, lane % 8) holds rows 4 ly + i and 16 + 4 ly + i (i < 4) of the
// warp's 32, keys lx + 8 j (j < BK / 8) of a tile's scores, and output
// columns 4 lx + j + 32 g.  Per key tile two steps: (even) S = Q Kᵀ from the
// K half, the online softmax on the score registers in base 2 (row max by
// shuffles among the 8 lanes of a row, alpha applied to the accumulators in
// registers), P into the warp's own P tile; (odd) O += P V from the V half.
// Each half walks on its own, with its part of a ring of NS slots refilled
// by cp.async (FAST) NS - 1 steps ahead and one barrier of its warps a
// step.  At the end the half-1 warps hand their running max, denominator
// and accumulators to the half-0 warp of the same rows through shared
// memory, which merges them (both scaled to the larger max) and stores.
// Every output is a fixed sequence of FFMA chains, maxima and sums: two
// launches give the same bits.
template <class C, bool FAST, typename T>
__global__ void __launch_bounds__(C::NT, 1) flash_cuda_core_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int D, int Dv, float scale_log2, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [DP][QLD]
  float* ring = qs + C::Q_FLOATS;          // [NS][2][HALF]
  float* ps = ring + C::NS * C::SLOT;      // [NW][BK][32]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ly = lane >> 3, lx = lane & 7;
  const int half = warp / C::WI, rb = warp % C::WI;
  const int bh = blockIdx.x, n = (Sq + C::IR - 1) / C::IR;
  const int q0 = (n - 1 - blockIdx.y) * C::IR;  // the longest q tiles first
  const int row0 = q0 + rb * 32;                // the warp's first row
  const int off = Sk - Sq;  // aligns the diagonals when Sq != Sk
  q += (long long)bh * Sq * D;
  k += (long long)bh * Sk * D;
  v += (long long)bh * Sk * Dv;
  o += (long long)bh * Sq * Dv;

  // the tiles the CTA walks (its last row block's, or, when a row block
  // sees no key, all), this half's steps (two a tile of its), and the
  // warp's own count
  int nt = 0;
  for (int b = 0; b < C::WI; ++b)
    nt = max(nt, tiles_for(q0 + b * 32, q0 + b * 32 + 31, Sq, Sk, C::BK, causal));
  const int nw = tiles_for(row0, row0 + 31, Sq, Sk, C::BK, causal);
  const int nh = 2 * ((nt - half + 1) / 2);
  const int htid = tid % (C::NT / 2);
  float* own = ring + half * C::HALF;  // this half's part of slot 0

  // Q (one commit group), then the half's steps 0 .. NS - 2 (one each)
  load_t<C, C::IR, C::QLD, FAST>(qs, q, q0, Sq, D, tid);
  hopper::cp_async_commit();
#pragma unroll
  for (int s = 0; s < C::NS - 1; ++s) {
    if (s < nh) fetch<C, FAST>(own + s * C::SLOT, k, v, s, half, Sk, D, Dv, htid);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<C::NS - 1>();  // this thread's copies of Q have landed ...
  __syncthreads();                     // ... and every thread's

  float acc[8][C::TV], m[8], l[8], s[8][C::TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::TV; ++j) acc[i][j] = 0.f;
  }
  const float* qw = qs + rb * 32 + 4 * ly;
  float* pw = ps + warp * C::P_FLOATS;

  for (int h = 0; h < nh; ++h) {
    hopper::cp_async_wait<C::NS - 2>();        // step h has landed, and every thread
    hopper::named_sync(1 + half, C::NT / 2);  // of the half is done with step h - 1
    if (h + C::NS - 1 < nh)  // into the slot step h - 1 left
      fetch<C, FAST>(own + (h + C::NS - 1) % C::NS * C::SLOT, k, v, h + C::NS - 1, half, Sk, D,
                     Dv, htid);
    hopper::cp_async_commit();
    const int t = (h >> 1) * 2 + half;  // this warp's key tile
    if (t >= nw) continue;  // past this warp's last tile (or it has no rows)
    const float* tile = own + h % C::NS * C::SLOT;
    if ((h & 1) == 0) {
      // S = Q Kᵀ: per 4 d, 8 Q rows of each d (two float4 reads a d) and 4
      // d of each of TN keys (a float4 a key), each score one FFMA chain over
      // d in order
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) s[i][j] = 0.f;
      const float* kw = tile + lx * C::KLD;
#pragma unroll 2
      for (int d = 0; d < C::DP; d += 4) {
        float a[4][8], b[C::TN][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          put4(a[e], qw + (d + e) * C::QLD);
          put4(a[e] + 4, qw + (d + e) * C::QLD + 16);
        }
#pragma unroll
        for (int j = 0; j < C::TN; ++j) put4(b[j], kw + 8 * j * C::KLD + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < C::TN; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i][j] = fmaf(a[e][i], b[j][e], s[i][j]);
      }
      // into log2 units; mask only a tile that reaches past Sk or this
      // warp's first row's diagonal
      const int k0 = t * C::BK;
      const bool edge = k0 + C::BK > Sk || (causal && k0 + C::BK - 1 > row0 + off);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) {
          float x = s[i][j] * scale_log2;
          if (edge) {
            const int key = k0 + lx + 8 * j;
            const int row = row0 + i / 4 * 16 + 4 * ly + i % 4;
            // past Sk not a key at all; the reference's finite mask, in log2 units
            if (key >= Sk) x = -INFINITY;
            else if (causal && key > row + off) x = NEG_INF * LOG2E;
          }
          s[i][j] = x;
        }
      // the online softmax on the score registers
      {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float mx = m[i];
#pragma unroll
          for (int j = 0; j < C::TN; ++j) mx = fmaxf(mx, s[i][j]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
          const float alpha = exp2_fast(m[i] - mx);  // 0 on the warp's first tile
          m[i] = mx;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < C::TN; ++j) {
            s[i][j] = exp2_fast(s[i][j] - mx);
            sum += s[i][j];
          }
          l[i] = l[i] * alpha + sum;  // this lane's share of the row's denominator
#pragma unroll
          for (int j = 0; j < C::TV; ++j) acc[i][j] *= alpha;
        }
      }
      // P into the warp's tile, [key][row] with rows of PLD = 36 floats:
      // row group g (4 rows, one float4) of key kk falls on bank group (kk +
      // g) % 8, so that a store of the warp's 32 float4 (keys lx + 8 j of 8
      // lanes, groups ly of 4) takes the 4 wavefronts of 512 bytes, and a
      // read of one key's rows no more than its own
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        float* prow = pw + (lx + 8 * j) * C::PLD + 4 * ly;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float4*>(prow + 16 * hh) =
              make_float4(s[4 * hh][j], s[4 * hh + 1][j], s[4 * hh + 2][j], s[4 * hh + 3][j]);
      }
    } else {
      // O += P V: per key, 8 P rows and TV columns, two and TV / 4 float4 reads
      const float* vw = tile + 4 * lx;
      const float* pr = pw + 4 * ly;
#pragma unroll 8
      for (int kk = 0; kk < C::BK; ++kk) {
        float a[8], b[C::TV];
        put4(a, pr + kk * C::PLD);
        put4(a + 4, pr + kk * C::PLD + 16);
#pragma unroll
        for (int g = 0; g < C::TV / 4; ++g) put4(b + 4 * g, vw + kk * C::DVP + 32 * g);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < C::TV; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  // the merge: the half-1 warp of each row block hands its running max,
  // denominator share and accumulators, lane by lane, to the half-0 warp
  // through the ring's memory
  hopper::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  constexpr int XF = 16 + 8 * C::TV;  // floats a lane hands over, [XF][32] a row block
  float* xw = ring + rb * 32 * XF + lane;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xw[32 * i] = m[i];
      xw[32 * (8 + i)] = l[i];
#pragma unroll
      for (int j = 0; j < C::TV; ++j) xw[32 * (16 + C::TV * i + j)] = acc[i][j];
    }
  }
  __syncthreads();
  if (half == 1 || nw == 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float m1 = xw[32 * i], mx = fmaxf(m[i], m1);
    const float a0 = exp2_fast(m[i] - mx), a1 = exp2_fast(m1 - mx);  // half 1 no tile: a1 = 0
    l[i] = l[i] * a0 + xw[32 * (8 + i)] * a1;
#pragma unroll
    for (int j = 0; j < C::TV; ++j)
      acc[i][j] = acc[i][j] * a0 + xw[32 * (16 + C::TV * i + j)] * a1;
  }

  // the row's denominator from its 8 lanes' shares; out = acc / l (IEEE)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 4);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + i / 4 * 16 + 4 * ly + i % 4;
    if (row >= Sq) continue;
#pragma unroll
    for (int g = 0; g < C::TV / 4; ++g) {
      const int col = 32 * g + 4 * lx;
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = acc[i][4 * g + j] / l[i];
      T* out = o + (long long)row * Dv + col;
      if constexpr (FAST) {
        if (col < Dv) *reinterpret_cast<float4*>(out) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < Dv) store(out + j, x[j]);
      }
    }
  }
}

// The tile class of head dims d, dv: 0 (32/32), 1 (64/64), 2 (128/128) or 3
// (192/128) by the wider of the two, the smallest that holds it.
// kernels/flash_attention.py::cuda_core_plan repeats it.
int tile_class(int d, int dv) {
  const int w = d > dv ? d : dv;
  return w <= 32 ? 0 : w <= 64 ? 1 : w <= 128 ? 2 : 3;
}

// The fast load path: f32, D and Dv multiples of 4, k, v and o on 16-byte
// boundaries (q goes 4 bytes at a time, transposed: its alignment is free).
bool fast_path(int dtype, int d, int dv, bool aligned) {
  return dtype == 0 && d % 4 == 0 && dv % 4 == 0 && aligned;
}

template <class C, bool FAST, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
           int dv, float scale, int causal, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_cuda_core_kernel<C, FAST, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n = (sq + C::IR - 1) / C::IR;
  if (n > 65535) return (int)cudaErrorInvalidValue;
  flash_cuda_core_kernel<C, FAST, T><<<dim3(bh, n), C::NT, C::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, d, dv, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <class C>
int launch_path(bool fast, int dtype, const void* q, const void* k, const void* v, void* o,
                int bh, int sq, int sk, int d, int dv, float scale, int causal, cudaStream_t s) {
  if (dtype == 1)
    return launch<C, false, __nv_bfloat16>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
  if (fast) return launch<C, true, float>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
  return launch<C, false, float>(q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
}

int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int d,
             int dv, float scale, int causal, int dtype, cudaStream_t s) {
  const bool fast = fast_path(dtype, d, dv,
                              ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                                reinterpret_cast<uintptr_t>(o)) & 15) == 0);
  switch (tile_class(d, dv)) {
    case 0: return launch_path<C32>(fast, dtype, q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
    case 1: return launch_path<C64>(fast, dtype, q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
    case 2: return launch_path<C128>(fast, dtype, q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
    default:
      return launch_path<C192>(fast, dtype, q, k, v, o, bh, sq, sk, d, dv, scale, causal, s);
  }
}

// A class's constants (layout keys 8 c + f, below); f = 6: the CTAs an SM
// the card gives its f32 fast-path kernel
template <class C>
long long constant(int f) {
  switch (f) {
    case 0: return C::DP;
    case 1: return C::DVP;
    case 2: return C::BK;
    case 3: return C::IR;
    case 4: return C::NT;
    case 5: return C::NS;
    case 6: {
      int n = -1;
      auto kernel = flash_cuda_core_kernel<C, true, float>;
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES) !=
              cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::NT, C::BYTES) !=
              cudaSuccess)
        return -1;
      return n;
    }
    case 7: return C::BYTES;
    default: return -1;
  }
}
}  // namespace simt

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

// the tile is chosen by the wider of the two head dims, as in simt::tile_class
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return simt::dispatch(q, k, v, o, bh, sq, sk, d, dv, scale, causal, dtype,
                        static_cast<cudaStream_t>(stream));
}

// The CUDA-core entry's plan for head dims d, dv, dtype (0 = f32, 1 = bf16)
// and whether k, v and o lie on 16-byte boundaries: its tile class (0 32/32, 1
// 64/64, 2 128/128, 3 192/128) times 2, plus 1 on the fast load path; -1 for
// head dims the entry refuses.  kernels/flash_attention.py::cuda_core_plan
// repeats it; a card test holds the two equal.
extern "C" long long flash_cuda_core_plan(int d, int dv, int dtype, int aligned) {
  if (d <= 0 || dv <= 0 || d > 192 || dv > 128 || (dtype != 0 && dtype != 1)) return -1;
  return 2LL * simt::tile_class(d, dv) + (simt::fast_path(dtype, d, dv, aligned != 0) ? 1 : 0);
}

// The CUDA-core kernel's constants, which kernels/flash_attention.py repeats
// (CUDA_CORE_CLASSES) and a card test holds equal: key 8 c + f for tile class
// c (0 32/32, 1 64/64, 2 128/128, 3 192/128), f = 0 its q/k head dim, 1 its v
// head dim, 2 the keys of a K/V tile, 3 the query rows of a q tile, 4 its
// threads (two q tiles a CTA), 5 its ring's half-tile slots, 6 the CTAs an
// SM this card gives its f32 kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// 7 its dynamic shared memory in bytes; -1 for any other key.
extern "C" long long flash_cuda_core_layout(int key) {
  if (key < 0 || key >= 32) return -1;
  switch (key / 8) {
    case 0: return simt::constant<simt::C32>(key % 8);
    case 1: return simt::constant<simt::C64>(key % 8);
    case 2: return simt::constant<simt::C128>(key % 8);
    default: return simt::constant<simt::C192>(key % 8);
  }
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
