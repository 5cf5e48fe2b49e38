// Fused SwiGLU matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/swiglu_matmul.py::swiglu_matmul
// (body `_kernel`): out = silu(x @ wg) * (x @ wu) for x [M, D] and wg, wu
// [D, F], two f32 accumulators, the epilogue g / (1 + exp(-g)) * u fused and
// cast once to the input type, so the [M, F] gate and up products never reach
// device memory.  Three kernels, each with two C entry points: one product,
// and E products at once for a mixture of experts (x [E, M, D], wg and wu [E,
// D, F], out [E, M, F]: out[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e]), the
// reference's `gecd,edf->gecf` pair with the groups folded into M).  The
// wrapper (kernels/swiglu_matmul.py::select_variant) picks one from (M, D,
// F, dtype); E does not enter the choice.
//
// Experts (DeepSeek-V2-Lite: E = 64, D = 2048, F = 1408; M = the capacity of
// a prefill's one group, 8 to 120 rows, or 8 slots of one row on a decode
// tick): every expert's weights are read once whatever M is, 0.74 GB a layer,
// so up to M ~ 300 the product is bound by those bytes, not by operations
// (H100: wgmma at M = 120 and decode at M = 8 run at 79% and 86% of the byte
// bound, ahead of two cuBLAS bmm; PERF.md).
// Each kernel takes the expert as one more coordinate of its own work
// (below); rows past an expert's M are zero-filled or never loaded, and
// their stores are masked, so no tile reads or writes another expert's rows.
//
// 1. `swiglu_wgmma_kernel` (entry swiglu_matmul_wgmma_fwd): bf16, M >= 64,
//    D and F multiples of 8 (TMA needs 16-byte row strides).  Prefill is
//    bound by operations (M = 512: 23.6 GFLOP against 46 MB of weights), so
//    it runs on the tensor cores.  Each tile is [BM rows, BN columns] of
//    both products from one x tile (x read once for gate and up, as in the
//    TPU kernel).  A producer warp keeps a ring of 4 shared-memory stages
//    filled by TMA (x box [BM, 64]; wg and wu boxes [64, 64]; 128-byte
//    swizzle; full/empty mbarriers).  Consumer warpgroups of 64 rows each
//    issue wgmma m64n(2 BN)k16 with the gate and up tiles side by side in
//    shared memory as one B operand, so one instruction feeds both
//    accumulators.  The weights are [D, F] row-major, i.e. MN-major B, taken
//    through wgmma's transpose bit: nothing is copied transposed.
//    setmaxnreg moves registers from the producer to the consumers.  Two
//    shapes: 2 consumers x BN 128 (tile 128 x 128, n256, 128 accumulators a
//    thread) or 3 consumers x BN 64 (tile 192 x 64, n128: ptxas caps a
//    512-thread kernel at 128 registers), whichever idles fewer SMs in its
//    last wave (M = 512: 264 tiles of 192 x 64 in two full waves, where 176
//    tiles of 128 x 128 leave the second wave two-thirds empty).  The kernel
//    is persistent (one CTA per SM walks tiles M-fastest, so the CTAs at
//    work share weight tiles in L2), and the ring runs on across tiles: the
//    producer fills the next tile while the consumers run the epilogue.
//    Ragged M, D and F: TMA zero-fills the loads, the store is masked.
//    Tried on the H100 and left out: a 2-CTA cluster multicasting the
//    weight tiles (no faster: L2 is not the limit), and one CTA per tile
//    (slower than the persistent loop).
// 2. `swiglu_decode_kernel` (entry swiglu_matmul_decode_fwd): bf16, M < 64.
//    Decode (M = 8) does 8 operations per weight element: it is bound by the
//    bytes of wg and wu (46 MB).  Each CTA streams a [K/s, 128] column slab
//    of both weights through a 5-stage cp.async ring (16-byte copies, 16 KB
//    a stage) and multiplies on mma.sync m16n8k16 with x zero-padded to 16,
//    32 or 64 rows.  K is split s ways (s = SMs / column slabs, at most 8:
//    44 slabs x 3 = 132 CTAs at F = 5632, one wave); the s CTAs of a slab form
//    a thread-block cluster and sum their partial g and u through
//    distributed shared memory before the (nonlinear) epilogue, in one launch.
// 3. `swiglu_kernel` (entry swiglu_matmul_fwd): f32, and bf16 with D or F
//    not a multiple of 8.  A tiled f32 GEMM on the CUDA cores: each block
//    computes one [BM, BN] tile of both products from one shared x tile;
//    16 x 32 tiles for M <= 16, 64 x 64 otherwise; any M, D, F.
//
// 4. The backward of both entries (swiglu_matmul_wgmma_bwd,
//    swiglu_experts_wgmma_bwd; the TPU kernel has no VJP, its model trains
//    through einsums): kernel 1's mainloop, tiles and persistent walk
//    unchanged, with a second epilogue (a template parameter, not a copy)
//    that reads the dout tile and writes, from the f32 accumulators, dg = dout
//    u σ(g)(1 + g(1 - σ(g))) and du = dout g σ(g) in bf16.  g and u are
//    never rounded or stored: the only [M, F] intermediates are dg and du.
//    It recomputes the two forward products (bound by operations as the
//    forward is) and moves dout, dg and du besides; the wrapper then forms
//    dx = dg wgᵀ + du wuᵀ, dwg = xᵀ dg and dwu = xᵀ du as plain cuBLAS
//    products, as the reference leaves them to XLA.  Any M: the mainloop
//    takes ragged tiles, so the backward of a decode-sized forward (an
//    expert's few rows) runs here too.
//
// The expert entries (swiglu_experts_{wgmma,decode,}fwd):
// - wgmma: the expert is the outermost coordinate of the persistent walk
//   (m fastest, then n, then e: the CTAs at work share an expert's weight
//   tiles in L2, and an expert's x tile stays there across its n tiles).
//   The maps are 4-D ({D, M, E, 1} for x, {F, D, E, 1} for the weights), so
//   TMA zero-fills rows past M and K past D inside the expert.  Tiles are
//   128 x 128 on two consumers: at M <= 128 rows an expert the 192 x 64
//   shape only doubles the tiles.
// - decode: the expert is the grid's z axis; K is split across a cluster
//   only as far as the card has SMs for E x column slabs (E = 64, F = 1408:
//   704 slabs, no split).
// - cuda_core: the expert is the grid's z axis.
//
// -Xptxas -v (sm_90a, nvcc 12.8), no spills anywhere: swiglu_wgmma_kernel
// 168 registers at launch (2 consumers, one product or experts, forward or
// backward epilogue; 3 consumers: 128) before setmaxnreg (producer 40 and consumers 232; 24 and 160),
// 197,696 and 164,928 bytes of dynamic shared memory; swiglu_decode_kernel
// 48 / 96 / 121 registers for 16 / 32 / 64 rows of x, 87,040 to 102,400
// bytes of dynamic shared memory; swiglu_kernel 32 to 64 registers, 10-12 KB
// of static shared memory.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// EXPERTS: E products, the expert on the grid's z axis
template <typename T, int BM, int BN, int BK, int TM, int TN, bool EXPERTS>
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
  if constexpr (EXPERTS) {
    const long long e = blockIdx.z;
    x += e * M * D;
    wg += e * D * F;
    wu += e * D * F;
    out += e * M * F;
  }

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

template <typename T, int BM, int BN, int BK, int TM, int TN, bool EXPERTS>
int launch(const void* x, const void* wg, const void* wu, void* out, int E, int M, int D, int F,
           cudaStream_t stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM, E);
  swiglu_kernel<T, BM, BN, BK, TM, TN, EXPERTS><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(out), M, D, F);
  return (int)cudaGetLastError();
}

template <typename T, bool EXPERTS>
int dispatch_m(const void* x, const void* wg, const void* wu, void* out, int E, int M, int D,
               int F, cudaStream_t stream) {
  if (M <= 16) return launch<T, 16, 32, 32, 2, 1, EXPERTS>(x, wg, wu, out, E, M, D, F, stream);
  return launch<T, 64, 64, 16, 4, 4, EXPERTS>(x, wg, wu, out, E, M, D, F, stream);
}

// ------------------------------------------------------------------------- //
// 1. prefill: wgmma fed by TMA, warp-specialised
// ------------------------------------------------------------------------- //
using bf16 = __nv_bfloat16;

namespace prefill {
constexpr int BK = 64;      // one 128-byte swizzle atom of bf16 along K
constexpr int ATOM = 64;    // bf16 columns of one 128-byte swizzle atom
constexpr int STAGES = 4;

// CONS consumer warpgroups of 64 rows each (BM = 64 CONS), then one producer
// warpgroup; setmaxnreg hands the producer's registers to the consumers.
// BN columns of each product per tile: 128 with two consumers (n256, 128
// accumulators a thread), 64 with three (n128: ptxas caps a 512-thread
// kernel at 128 registers a thread).
template <int CONS, int BN>
struct Cfg {
  static constexpr int NA = BN / ATOM;  // swizzle atoms per product
  static constexpr int BM = 64 * CONS;
  static constexpr int NT = 128 * (CONS + 1);
  static constexpr int A_ELEMS = BM * BK;       // x tile, K-major
  static constexpr int B_ELEMS = 2 * BK * BN;   // gate atoms, then up atoms
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
  static constexpr size_t BYTES = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static constexpr int PRODUCER_REGS = CONS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = CONS == 2 ? 232 : 160;
};

template <int BN>
__device__ __forceinline__ void mma_tile(float (&acc)[BN], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    hopper::wgmma_m64n256k16_tb(acc, da, db, 1);
  } else {
    hopper::wgmma_m64n128k16_tb(acc, da, db, 1);
  }
}

// EXPERTS: E products, 4-D maps with the expert as their third coordinate.
// BWD: the backward's epilogue (the derivative at dout, into out = dg and du)
// in place of the forward's (silu(g) u into out); dout and du are null
// without it.
template <int CONS, int BN, bool EXPERTS, bool BWD>
__global__ void __launch_bounds__(Cfg<CONS, BN>::NT, 1) swiglu_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap umap, bf16* __restrict__ out,
    const bf16* __restrict__ dout, bf16* __restrict__ du, int E, int M, int D, int F) {
  using C = Cfg<CONS, BN>;
  constexpr int NA = C::NA;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* sa = reinterpret_cast<bf16*>(smem_raw + pad);  // [STAGES][A_ELEMS]
  bf16* sb = sa + STAGES * C::A_ELEMS;                 // [STAGES][B_ELEMS]
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * C::B_ELEMS);
  uint64_t* empty = full + STAGES;

  // persistent: CTA b takes tiles b, b + gridDim.x, ...; tile t is
  // (m tile t % mtiles, n tile t / mtiles % ncols, expert t / (mtiles ncols)),
  // M fastest, so the CTAs at work at one time share weight tiles in L2.  The
  // ring's stage and phase run on across tiles, so the producer fills the
  // next tile's first stages while the consumers run this tile's epilogue.
  const int mtiles = (M + C::BM - 1) / C::BM;
  const int ncols = (F + BN - 1) / BN;
  const int ntiles = E * mtiles * ncols;
  const int kblocks = (D + BK - 1) / BK;
  const int group = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONS * 4);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (group == CONS) {
    // producer: one thread issues every TMA load
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == CONS * 128) {
      int it = 0;  // stage uses so far
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int m0 = (t % mtiles) * C::BM, n0 = (t / mtiles % ncols) * BN;
        const int e = t / (mtiles * ncols);
        for (int kb = 0; kb < kblocks; ++kb, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], C::STAGE_BYTES);
          const int k0 = kb * BK;
          bf16* b = sb + s * C::B_ELEMS;
          if constexpr (EXPERTS) {
            hopper::tma_load_4d(sa + s * C::A_ELEMS, &xmap, &full[s], k0, m0, e, 0);
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              hopper::tma_load_4d(b + a * BK * ATOM, &gmap, &full[s], n0 + a * ATOM, k0, e, 0);
              hopper::tma_load_4d(b + (NA + a) * BK * ATOM, &umap, &full[s], n0 + a * ATOM, k0,
                                  e, 0);
            }
          } else {
            hopper::tma_load_2d(sa + s * C::A_ELEMS, &xmap, &full[s], k0, m0);
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              hopper::tma_load_2d(b + a * BK * ATOM, &gmap, &full[s], n0 + a * ATOM, k0);
              hopper::tma_load_2d(b + (NA + a) * BK * ATOM, &umap, &full[s], n0 + a * ATOM, k0);
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup `group` owns rows 64 group .. 64 group + 63
    hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    int it = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int m0 = (t % mtiles) * C::BM, n0 = (t / mtiles % ncols) * BN;
      const long long eoff = (long long)(t / (mtiles * ncols)) * M * F;  // this tile's expert
      bf16* oe = out + eoff;
      float acc[BN];  // 64 x 2 BN f32 over 128 threads: gate in [0, BN/2), up in [BN/2, BN)
#pragma unroll
      for (int i = 0; i < BN; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < kblocks; ++kb, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const bf16* a = sa + s * C::A_ELEMS + group * 64 * BK;
        const bf16* b = sb + s * C::B_ELEMS;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // A: K-major, 128-byte rows, 8-row groups 1024 B apart; a k16 step is 32 B.
          // B: MN-major, atoms of [BK rows, 64 columns] 8 KB apart (LBO), 8-row
          // groups 1024 B apart (SBO); a k16 step is 16 rows.  The gate's and
          // the up product's atoms lie side by side: one n(2 BN) instruction.
          const uint64_t da = hopper::wgmma_desc(a + kk * 16, 16, 1024);
          const uint64_t db = hopper::wgmma_desc(b + kk * 16 * ATOM, BK * ATOM * 2, 1024);
          mma_tile<BN>(acc, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done: free it
        if (kb > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      hopper::wgmma_wait<0>();
      if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last stage

      // fused epilogue straight from the accumulators: value i of a thread is
      // row 16 warp + lane/4 + 8 ((i/2) % 2), column 8 (i/4) + 2 (lane % 4) + i % 2
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int r = m0 + group * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int c = n0 + (i >> 2) * 8 + (lane & 3) * 2;
        if (r < M && c < F) {  // F is a multiple of 8, so c + 1 < F too
          const float g0 = acc[i], g1 = acc[i + 1];
          const float u0 = acc[i + BN / 2], u1 = acc[i + 1 + BN / 2];
          const long long at = (long long)r * F + c;
          if constexpr (BWD) {
            // s = σ(g); du = dout g s; dg = dout u s (1 + g (1 - s)), in f32
            // from the accumulators: g and u are never rounded or stored
            const float2 d = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(dout + eoff + at));
            const float s0 = 1.f / (1.f + __expf(-g0)), s1 = 1.f / (1.f + __expf(-g1));
            *reinterpret_cast<__nv_bfloat162*>(du + eoff + at) =
                __floats2bfloat162_rn(d.x * g0 * s0, d.y * g1 * s1);
            *reinterpret_cast<__nv_bfloat162*>(oe + at) =
                __floats2bfloat162_rn(d.x * u0 * s0 * (1.f + g0 * (1.f - s0)),
                                      d.y * u1 * s1 * (1.f + g1 * (1.f - s1)));
          } else {
            *reinterpret_cast<__nv_bfloat162*>(oe + at) = __floats2bfloat162_rn(
                g0 / (1.f + __expf(-g0)) * u0, g1 / (1.f + __expf(-g1)) * u1);
          }
        }
      }
    }
  }
}

template <int CONS, int BN, bool EXPERTS, bool BWD>
int launch(const void* x, const void* wgt, const void* wup, void* out, const void* dout,
           void* du, int E, int M, int D, int F, cudaStream_t stream) {
  using C = Cfg<CONS, BN>;
  CUtensorMap xm, gm, um;
  if constexpr (EXPERTS) {
    const long long xd[4] = {D, M, E, 1}, wd[4] = {F, D, E, 1};
    const long long xs[3] = {2LL * D, 2LL * M * D, 2LL * E * M * D};
    const long long ws[3] = {2LL * F, 2LL * D * F, 2LL * E * D * F};
    const int xbox[4] = {BK, C::BM, 1, 1}, wbox[4] = {ATOM, BK, 1, 1};
    if (!hopper::make_map_bf16_4d(&xm, x, xd, xs, xbox) ||
        !hopper::make_map_bf16_4d(&gm, wgt, wd, ws, wbox) ||
        !hopper::make_map_bf16_4d(&um, wup, wd, ws, wbox))
      return (int)cudaErrorInvalidValue;
  } else {
    if (!hopper::make_map_bf16(&xm, x, M, D, C::BM, BK) ||
        !hopper::make_map_bf16(&gm, wgt, D, F, BK, ATOM) ||
        !hopper::make_map_bf16(&um, wup, D, F, BK, ATOM))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(swiglu_wgmma_kernel<CONS, BN, EXPERTS, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)E * ((M + C::BM - 1) / C::BM) * ((F + BN - 1) / BN);
  const int grid = tiles < hopper::num_sms() ? (int)tiles : hopper::num_sms();  // one CTA per SM
  swiglu_wgmma_kernel<CONS, BN, EXPERTS, BWD><<<grid, C::NT, C::BYTES, stream>>>(
      xm, gm, um, static_cast<bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<bf16*>(du), E, M, D, F);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles on two consumers or 192 x 64 on three, whichever leaves
// less of the card's waves idle (waves of one CTA per SM times the tile's
// area; the larger tile on a tie): M = 512 is 264 tiles of 192 x 64, two
// waves of 12288 against 176 of 128 x 128, two waves of 16384.
// (BWD: the same tiles for the backward, out = dg)
template <bool BWD>
int dispatch(const void* x, const void* wgt, const void* wup, void* out, const void* dout,
             void* du, int M, int D, int F, cudaStream_t stream) {
  const long long sms = hopper::num_sms();
  auto cost = [&](int bm, int bn) {
    const long long tiles = (long long)((M + bm - 1) / bm) * ((F + bn - 1) / bn);
    return (tiles + sms - 1) / sms * bm * bn;
  };
  if (cost(192, 64) < cost(128, 128))
    return launch<3, 64, false, BWD>(x, wgt, wup, out, dout, du, 1, M, D, F, stream);
  return launch<2, 128, false, BWD>(x, wgt, wup, out, dout, du, 1, M, D, F, stream);
}

template <bool BWD>
int dispatch_experts(const void* x, const void* wgt, const void* wup, void* out, const void* dout,
                     void* du, int E, int M, int D, int F, cudaStream_t stream) {
  return launch<2, 128, true, BWD>(x, wgt, wup, out, dout, du, E, M, D, F, stream);
}
}  // namespace prefill

// ------------------------------------------------------------------------- //
// 2. decode: a cp.async weight stream, mma.sync, split K summed in a cluster
// ------------------------------------------------------------------------- //
namespace decode {
namespace cg = cooperative_groups;
constexpr int BN = 128;    // weight columns per CTA (of each product)
constexpr int BK = 32;     // K rows a stage
constexpr int STAGES = 5;  // (BK 64 or 128, or 8 stages, measured slower)
constexpr int NT = 256;    // 8 warps, 16 columns each
constexpr int MAX_SPLIT = 8;  // portable cluster size

template <int MT>  // m16 tiles of x: M <= 16 MT
struct Layout {
  static constexpr int ROWS = 16 * MT;
  static constexpr int XC = BK / 8;           // 16-byte chunks of an x row
  static constexpr int X_ELEMS = ROWS * BK;
  static constexpr int W_ELEMS = BK * BN;     // 256-byte rows: 16 chunks
  static constexpr int STAGE_ELEMS = X_ELEMS + 2 * W_ELEMS;
  static constexpr size_t PIPE_BYTES = (size_t)STAGES * STAGE_ELEMS * 2;
  static constexpr size_t RED_BYTES = (size_t)ROWS * 2 * BN * 4;  // f32 partial g | u
  static constexpr size_t BYTES = PIPE_BYTES > RED_BYTES ? PIPE_BYTES : RED_BYTES;
};

template <int MT>
__global__ void __launch_bounds__(NT) swiglu_decode_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wgt, const bf16* __restrict__ wup,
    bf16* __restrict__ out, int M, int D, int F, int nsplit) {
  using L = Layout<MT>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const long long e = blockIdx.z;  // the expert (0 for one product)
  x += e * M * D;
  wgt += e * D * F;
  wup += e * D * F;
  out += e * M * F;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();  // the cluster spans gridDim.y
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (D + BK - 1) / BK;
  const int kb0 = (int)((long long)split * nk / nsplit);
  const int nkb = (int)((long long)(split + 1) * nk / nsplit) - kb0;

  auto load = [&](int kb, int s) {
    bf16* xs = sm + s * L::STAGE_ELEMS;
    bf16* gs = xs + L::X_ELEMS;
    bf16* us = gs + L::W_ELEMS;
    const int k0 = kb * BK;
    for (int i = tid; i < L::ROWS * L::XC; i += NT) {
      const int r = i / L::XC, c = i % L::XC, k = k0 + c * 8;
      const bool ok = r < M && k < D;
      hopper::cp_async16(xs + hopper::swz<L::XC>(r, c), ok ? x + (long long)r * D + k : x, ok);
    }
#pragma unroll
    for (int i = tid; i < BK * 16; i += NT) {
      const int r = i >> 4, c = i & 15, k = k0 + r, n = n0 + c * 8;
      const bool ok = k < D && n < F;
      const long long off = ok ? (long long)k * F + n : 0;
      hopper::cp_async16(gs + hopper::swz<16>(r, c), wgt + off, ok);
      hopper::cp_async16(us + hopper::swz<16>(r, c), wup + off, ok);
    }
  };

  float acc[MT][2][2][4];  // [m tile][gate, up][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][p][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkb) load(kb0 + s, s);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < nkb; ++i) {
    hopper::cp_async_wait<STAGES - 2>();  // stage i has landed
    __syncthreads();                      // ... for every thread; stage i-1 is free
    if (i + STAGES - 1 < nkb) load(kb0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const bf16* xs = sm + (i % STAGES) * L::STAGE_ELEMS;
    const bf16* ws[2] = {xs + L::X_ELEMS, xs + L::X_ELEMS + L::W_ELEMS};
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        hopper::ldmatrix_x4(a[mt], xs + hopper::swz<L::XC>(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                      kk * 2 + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t b[4];
        hopper::ldmatrix_x4_trans(
            b, ws[p] + hopper::swz<16>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                       warp * 2 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          hopper::mma_bf16(acc[mt][p][0], a[mt], b[0], b[1]);
          hopper::mma_bf16(acc[mt][p][1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the ring's shared memory now holds the partial sums

  float* red = reinterpret_cast<float*>(smem_raw);  // [ROWS][gate BN | up BN]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int c = warp * 16 + nt * 8 + (lane & 3) * 2 + (e & 1);
          red[r * 2 * BN + p * BN + c] = acc[mt][p][nt][e];
        }
  cluster.sync();
  // the cluster's CTAs share out the sum and the epilogue of the slab
  for (int idx = split * NT + tid; idx < M * BN; idx += nsplit * NT) {
    const int r = idx / BN, c = idx % BN;
    if (n0 + c >= F) continue;
    float g = 0.f, u = 0.f;
    for (int q = 0; q < nsplit; ++q) {
      const float* rq = cluster.map_shared_rank(red, q);
      g += rq[r * 2 * BN + c];
      u += rq[r * 2 * BN + BN + c];
    }
    out[(long long)r * F + n0 + c] = __float2bfloat16(g / (1.f + __expf(-g)) * u);
  }
  cluster.sync();  // no CTA leaves while another still reads its shared memory
}

template <int MT>
int launch(const void* x, const void* wgt, const void* wup, void* out, int E, int M, int D,
           int F, cudaStream_t stream) {
  const size_t smem = Layout<MT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(swiglu_decode_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ncol = (F + BN - 1) / BN, nk = (D + BK - 1) / BK;
  const long long slabs = (long long)E * ncol;  // column slabs of all experts
  int split = (int)((hopper::num_sms() + slabs / 2) / slabs);
  split = split < 1 ? 1 : (split > MAX_SPLIT ? MAX_SPLIT : split);
  split = split > nk ? nk : split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncol, split, E);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, swiglu_decode_kernel<MT>, static_cast<const bf16*>(x),
                           static_cast<const bf16*>(wgt), static_cast<const bf16*>(wup),
                           static_cast<bf16*>(out), M, D, F, split);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int dispatch(const void* x, const void* wgt, const void* wup, void* out, int E, int M, int D,
             int F, cudaStream_t stream) {
  if (M <= 16) return launch<1>(x, wgt, wup, out, E, M, D, F, stream);
  if (M <= 32) return launch<2>(x, wgt, wup, out, E, M, D, F, stream);
  return launch<4>(x, wgt, wup, out, E, M, D, F, stream);
}
}  // namespace decode

}  // namespace

// x: [M, D]; wg, wu: [D, F]; out: [M, F]; contiguous; dtype 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int swiglu_matmul_fwd(const void* x, const void* wg, const void* wu, void* out,
                                 int M, int D, int F, int dtype, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_m<float, false>(x, wg, wu, out, 1, M, D, F, s);
  if (dtype == 1) return dispatch_m<__nv_bfloat16, false>(x, wg, wu, out, 1, M, D, F, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core variants: same operands, bf16 only; D and F must be
// multiples of 8.  wgmma: any M >= 1 (meant for M >= 64); decode: M <= 64.
extern "C" int swiglu_matmul_wgmma_fwd(const void* x, const void* wg, const void* wu, void* out,
                                       int M, int D, int F, void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  return prefill::dispatch<false>(x, wg, wu, out, nullptr, nullptr, M, D, F,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_matmul_decode_fwd(const void* x, const void* wg, const void* wu, void* out,
                                        int M, int D, int F, void* stream) {
  if (M <= 0 || M > 64 || D <= 0 || F <= 0 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  return decode::dispatch(x, wg, wu, out, 1, M, D, F, static_cast<cudaStream_t>(stream));
}

// The expert entries: x [E, M, D]; wg, wu [E, D, F]; out [E, M, F]; contiguous;
// the same kinds and limits as the entries above, E products in one launch.
extern "C" int swiglu_experts_fwd(const void* x, const void* wg, const void* wu, void* out, int E,
                                  int M, int D, int F, int dtype, void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || D <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_m<float, true>(x, wg, wu, out, E, M, D, F, s);
  if (dtype == 1) return dispatch_m<__nv_bfloat16, true>(x, wg, wu, out, E, M, D, F, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int swiglu_experts_wgmma_fwd(const void* x, const void* wg, const void* wu, void* out,
                                        int E, int M, int D, int F, void* stream) {
  if (E <= 0 || M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  return prefill::dispatch_experts<false>(x, wg, wu, out, nullptr, nullptr, E, M, D, F,
                                         static_cast<cudaStream_t>(stream));
}

// The backward of either entry (bf16; D and F multiples of 8; any M): the
// gate and up products recomputed by the wgmma kernel and, in its epilogue,
// dg = dout u σ(g)(1 + g(1 - σ(g))) and du = dout g σ(g) at the cotangent
// dout [M, F] ([E, M, F]), into dg and du of dout's shape.
extern "C" int swiglu_matmul_wgmma_bwd(const void* x, const void* wg, const void* wu,
                                       const void* dout, void* dg, void* du, int M, int D, int F,
                                       void* stream) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  return prefill::dispatch<true>(x, wg, wu, dg, dout, du, M, D, F,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_experts_wgmma_bwd(const void* x, const void* wg, const void* wu,
                                        const void* dout, void* dg, void* du, int E, int M, int D,
                                        int F, void* stream) {
  if (E <= 0 || M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8) return (int)cudaErrorInvalidValue;
  return prefill::dispatch_experts<true>(x, wg, wu, dg, dout, du, E, M, D, F,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int swiglu_experts_decode_fwd(const void* x, const void* wg, const void* wu, void* out,
                                         int E, int M, int D, int F, void* stream) {
  if (E <= 0 || E > 65535 || M <= 0 || M > 64 || D <= 0 || F <= 0 || D % 8 || F % 8)
    return (int)cudaErrorInvalidValue;
  return decode::dispatch(x, wg, wu, out, E, M, D, F, static_cast<cudaStream_t>(stream));
}

extern "C" const char* swiglu_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
