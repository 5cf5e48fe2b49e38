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
// 3. `swiglu_cuda_core_kernel` (entries swiglu_matmul_fwd,
//    swiglu_experts_fwd; namespace simt): f32, and bf16 with D or F not a
//    multiple of 8, any M, D, F.  It replaces the TPU kernel on its f32 and
//    unaligned route (src/repro/kernels/swiglu_matmul.py:50) in IEEE f32:
//    FFMA on the CUDA cores, nothing rounded to TF32 or bf16, so it is bound
//    by f32 operations (M = 512, D = 2048, F = 5632: 23.6 GFLOP, 0.3526 ms at
//    67 TFLOP/s); the small-M class by the weights' bytes (M = 8: 92 MB,
//    0.0276 ms).  The earlier kernel (64 x 64 tiles, 4 x 4 outputs of each
//    product a thread, scalar global loads between two __syncthreads a
//    16-row k-step) ran at 1.1069 ms, 32% of the bound: its inner loop alone
//    at 45% (1.5 bytes of shared memory an FFMA), and nothing in flight
//    while the FFMAs ran (the loads cost 0.33 ms more).  The design:
//    - each thread holds 8 x 8 outputs of both products (128 accumulators):
//      8 x values and 8 + 8 weights, six 16-byte reads of shared memory,
//      feed 128 FFMA (0.75 byte an FFMA); the gate's FFMAs run, then the up
//      product's with its weights in the gate's registers;
//    - a ring of 4 shared-memory stages of 8 k rows, filled by cp.async
//      (x 4 bytes at a time, transposed to [k][m] on the way in; the
//      weights 16 bytes at a time), one barrier a stage;
//    - tile classes by a wave-count model (simt::tile_class): 128 x 64 or
//      64 x 64 tiles at 3 or 6 CTAs an SM (168 registers a thread: 12 warps
//      an SM), so M = 512's 352 tiles fill 89% of one wave of 396 slots; M
//      <= 16 on 16 x 32 tiles (176 CTAs stream the weights at F = 5632),
//      four k groups a CTA whose partial sums are added in group order;
//    - two load paths picked before the launch: 16-byte weight copies for f32
//      with F % 4 == 0 and 16-byte aligned wg, wu and out, element loads
//      converted to f32 otherwise (any F, any alignment, bf16);
//    - every output one FFMA chain over k in order (or four such chains
//      added in a fixed order), the epilogue g / (1 + expf(-g)) u with a
//      correctly rounded division: two launches give the same bits, and M >
//      16 the same bits as the earlier kernel.
//    On an H100 80GB HBM3 at 700 W (SM clock 1980 MHz throughout;
//    scripts/swiglu_f32_probe.py --earlier, both in one session): 0.5762
//    ms at M = 512 (61% of the bound; the earlier kernel 1.1069, cuBLAS's two
//    SGEMMs and silu·mul 0.5300), 2.0234 at the experts E 64, M 120, F 1408
//    (65%; 4.0925, cuBLAS 2.0364), 0.0499 at M = 8 (55% of the byte bound;
//    0.1682, cuBLAS 0.1031).  What is left at M = 512: without its loads
//    0.5354, its FFMAs alone 0.4790 (83% of the issue rate after the 89%
//    wave).  Tried and left out: double-buffered fragments (220 registers,
//    so 2 CTAs an SM: 0.7450), 16 k rows a stage (0.6697), the copy loops
//    rolled (~10% slower), the 64-row class at M = 512 (0.5878).
//
// 4. The backward of both entries (swiglu_matmul_wgmma_bwd,
//    swiglu_experts_wgmma_bwd; the TPU kernel has no VJP, its model trains
//    through einsums): kernel 1's mainloop, tiles and persistent walk
//    unchanged, with a second epilogue (a template parameter, not a copy)
//    that reads the dout tile and writes, from the f32 accumulators, dg = dout
//    u σ(g)(1 + g(1 - σ(g))) and du = dout g σ(g) in bf16.  g and u are
//    never rounded or stored: the only [M, F] intermediates are dg and du.
//    The wrapper then forms dx = dg wgᵀ + du wuᵀ, dwg = xᵀ dg and dwu = xᵀ
//    du as plain cuBLAS products, as the reference leaves them to XLA.  Any
//    M: the mainloop takes ragged tiles, so the backward of a decode-sized
//    forward (an expert's few rows) runs here too.
//    Bound: operations, as the forward (the two products again; dout, dg
//    and du are 3 M F bf16 besides): 0.1911 ms at TinyLlama's train shape
//    (M 4096, D 2048, F 5632) on an H100.  What held it back (PERF.md): an
//    epilogue that loaded dout from device memory only after the
//    mainloop and stored dg and du with 4-byte scattered stores, the tensor
//    cores idle meanwhile: 0.4143 ms, of which 0.1301 went to the
//    epilogue (0.2842 with the forward's epilogue in its place).
//    The epilogue now: the producer brings each warpgroup's dout tile by
//    TMA (two [64, 64] boxes, 128-byte swizzle, their own mbarrier) during
//    the tile's mainloop, once the consumers are past the last tile's
//    epilogue; each thread reads its dout pairs from shared memory, writes
//    dg and du back in the boxes' swizzle, and one thread of the warpgroup
//    issues TMA stores (which clip the ragged edge of M, F and each expert)
//    without a barrier with the other warpgroup; it waits for them to have
//    read shared memory only after issuing the next tile's first products.
//    Shared memory: the 4-stage ring (192 KB) leaves room for one buffer of
//    a tile (32 KB), so columns 0-63's dg goes over their dout and their du
//    over columns 64-127's dout (kept in registers); those boxes leave while
//    columns 64-127's derivative is computed.  σ(g) takes the approximate
//    reciprocal (__fdividef): the correctly rounded division costs the call
//    a quarter of its time (0.3420 against 0.2689 ms), so dg and du differ
//    from the exact division's by bf16 rounding, within the same tolerance.
//    0.2689 ms at TinyLlama's shape (71% of the bound); tried and left out:
//    a 3-stage ring beside two buffers (dout then dg; du), 0.2953 ms (the
//    ring's third stage costs the mainloop ~4%), and one buffer without the
//    split (dg, wait for its stores to read, then du), 0.3050 with exact
//    division against 0.3257 for two buffers (H100 80GB HBM3 at 700 W,
//    scripts/swiglu_bwd_probe.py).
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
// -Xptxas -v (sm_90a, nvcc 12.8): swiglu_wgmma_kernel 168 registers at
// launch (2 consumers, one product or experts, forward or backward
// epilogue; 3 consumers: 128) before setmaxnreg (producer 40 and consumers
// 232; 24 and 160), no spills but 16 bytes in the 3-consumer backward (off
// the train paths: M 4096 and 2048 take 2 consumers); dynamic shared memory
// 197,696 bytes (2 consumers) and 164,928 (3) forward, 230,496 and 214,128
// backward (swiglu_matmul_bwd_layout); swiglu_decode_kernel 48 / 96 / 121
// registers for 16 / 32 / 64 rows of x, 87,040 to 102,400 bytes of dynamic
// shared memory; swiglu_cuda_core_kernel 168 registers (the 128- and the
// 64-row classes, 3 and 6 CTAs an SM), 93 to 104 (the small class), no
// spills, 33,280, 25,088 and 43,008 bytes of dynamic shared memory.

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

// ------------------------------------------------------------------------- //
// 3. cuda_core: f32 FFMA fed by a cp.async ring, both products a thread
// ------------------------------------------------------------------------- //
namespace simt {
constexpr int SMALL_M = 16;  // rows up to which the small class runs

// A tile class.  A CTA computes [BM rows, BN columns] of both products.  Its
// threads form KSPLIT groups: group s takes k rows [s KG, (s + 1) KG) of
// every stage of BK rows, and the groups' partial sums are added in group
// order after the mainloop (KSPLIT = 1: one FFMA chain an output).  Thread
// (ty, tx) of a group holds TM x TN outputs of each product: rows ty 4 + i
// (i < 4) of each of the tile's TM / 4 row blocks (RH rows apart) and
// columns tx 4 + j of each of its TN / 4 column blocks (CH apart), so that
// each of its fragment reads is one 16-byte float4 and a warp's reads of a k
// row cover consecutive addresses.  CTAS: the CTAs an SM the class is built
// for, at least (__launch_bounds__ caps the registers so that they fit; the
// wave model counts on it).  DB: the next
// k row's fragments are read into a second set of registers while this
// row's FFMAs run (else the CTA's other warps hide the reads' latency).
template <int BM_, int BN_, int BK_, int TM_, int TN_, int KSPLIT_, int STAGES_, int CTAS_,
          bool DB_>
struct Cls {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_, KSPLIT = KSPLIT_;
  static constexpr int STAGES = STAGES_;  // the ring's stages
  static constexpr int CTAS = CTAS_;
  static constexpr bool DB = DB_;
  static constexpr int NTY = BM / TM, NTX = BN / TN;
  static constexpr int GROUP = NTY * NTX;  // threads of a k group
  static constexpr int NT = GROUP * KSPLIT;
  static constexpr int KG = BK / KSPLIT;  // k rows of a stage a group takes
  static constexpr int RH = BM / (TM / 4), CH = BN / (TN / 4);
  static constexpr int XLD = BM + 4;  // the x tile transposed, [BK][XLD] (padded: below)
  static constexpr int X_ELEMS = BK * XLD, W_ELEMS = BK * BN;
  static constexpr int STAGE = X_ELEMS + 2 * W_ELEMS;  // floats: x, wg, wu
  static constexpr int RED = KSPLIT > 1 ? KSPLIT * 2 * BM * BN : 0;  // the groups' partials
  static constexpr int FLOATS = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BK % 8 == 0 && KG % 2 == 0, "tile");
  static_assert(NT % 32 == 0, "whole warps");
  static_assert(STAGE % 4 == 0 && X_ELEMS % 4 == 0, "16-byte fragment reads");
  static constexpr int BYTES = FLOATS * 4;  // dynamic shared memory
  static_assert(BYTES <= 232448, "shared memory");
};
// M <= SMALL_M, bound by the weights' bytes: narrow column slabs (176 CTAs
// at F = 5632), each warp a quarter of every stage's k rows
using Small = Cls<16, 32, 32, 4, 4, 4, 4, 4, true>;
// M > SMALL_M, bound by operations: 8 x 8 outputs of each product a thread
// (8 + 8 + 8 floats of fragments feed 128 FFMA: 0.75 byte of shared memory
// an FFMA), 168 registers a thread so that 12 warps fit an SM
using R64 = Cls<64, 64, 8, 8, 8, 1, 4, 6, false>;
using R128 = Cls<128, 64, 8, 8, 8, 1, 4, 3, false>;

__device__ __forceinline__ void put4(float* f, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// Copy t of a thread's share of a stage (k rows k0 .. k0 + BK - 1) into the
// ring slot at sm, zero past M, D and F.  x goes transposed, [BK][XLD]:
// element e = tid + t NT of the x tile is row (e / 8) % BM, k 8 (e / (8 BM))
// + e % 8, so 8 threads read one 32-byte sector of a row and a warp's 4 rows
// x 8 k land on 32 different banks (XLD = 4 mod 32).  The weights go as they
// lie, [BK][BN] each: copy c = tid + t NT is k row c / BN, column c % BN.
// These are the general path's copies: element loads converted to f32 and
// stored (any F, any alignment, bf16).  The fast path (load) copies the same
// x elements by 4-byte cp.async, and the weights 16 bytes at a time.
template <class C, typename T>
__device__ __forceinline__ void copy_x(float* sm, const T* x, int t, int k0, int m0, int M, int D,
                                       int tid) {
  const int e = tid + t * C::NT, r = e / 8 % C::BM, kk = e / (8 * C::BM) * 8 + e % 8;
  const bool ok = m0 + r < M && k0 + kk < D;
  sm[kk * C::XLD + r] = ok ? to_f32(x[(long long)(m0 + r) * D + k0 + kk]) : 0.f;
}
template <class C, typename T>
__device__ __forceinline__ void copy_w(float* sm, const T* wg, const T* wu, int t, int k0, int n0,
                                       int D, int F, int tid) {
  static_assert(C::NT % C::BN == 0, "weight copies");
  const int kk = tid / C::BN + t * (C::NT / C::BN), n = tid % C::BN;
  const bool ok = k0 + kk < D && n0 + n < F;
  const long long off = (long long)(k0 + kk) * F + n0 + n;
  sm[C::X_ELEMS + kk * C::BN + n] = ok ? to_f32(wg[off]) : 0.f;
  sm[C::X_ELEMS + C::W_ELEMS + kk * C::BN + n] = ok ? to_f32(wu[off]) : 0.f;
}
// The stage of k rows k0 .. into the ring slot at sm, zero past M, D and F.
// The general path runs copy_x and copy_w in loops that are not unrolled:
// its element loads' addresses then stay out of the registers the 8 x 8
// classes are short of.  The fast path (f32; F % 4 == 0 and 16-byte aligned
// weights, so each 16 bytes lie in one row, inside F or past it) copies by
// cp.async, unrolled and walked by pointer increments from one address a
// thread: the rolled loops' control cost ~10% at M = 512, and addresses
// computed apart from the thread and copy index spill.
template <class C, bool FAST, typename T>
__device__ __forceinline__ void load(float* sm, const T* x, const T* wg, const T* wu, int k0,
                                     int m0, int n0, int M, int D, int F, int tid) {
  static_assert(!FAST || sizeof(T) == 4, "the fast path copies f32");
  constexpr int XN = C::BM * C::BK / C::NT, WN = C::BK * C::BN / (FAST ? 4 : 1) / C::NT;
  static_assert(XN * C::NT == C::BM * C::BK && WN * C::NT * (FAST ? 4 : 1) == C::BK * C::BN,
                "copies");
  if constexpr (FAST) {
    // x: thread tid starts at row tid / 8, k tid % 8, and walks NT / 8 rows
    // down, then 8 k on (the same copies as copy_x's)
    constexpr int XR = C::NT / 8;
    static_assert(C::BM % XR == 0, "x copies walk down the rows");
#pragma unroll
    for (int c = 0; c < C::BK / 8; ++c) {
      const int kk = tid % 8 + 8 * c;
      const bool kin = k0 + kk < D;
      int r = tid / 8;
      const T* src = x + (long long)(m0 + r) * D + k0 + kk;
      float* dst = sm + kk * C::XLD + r;
#pragma unroll
      for (int j = 0; j < C::BM / XR; ++j) {
        const bool ok = kin && m0 + r < M;
        hopper::cp_async4(dst, ok ? src : x, ok);
        r += XR;
        src += (long long)XR * D;
        dst += XR;
      }
    }
    // the weights: 16 bytes a copy, thread tid at k row tid / (BN / 4),
    // columns 4 (tid % (BN / 4)), walking NT / (BN / 4) rows down
    constexpr int WC = C::BN / 4, WR = C::NT / WC;
    static_assert(C::NT % WC == 0, "weight copies");
    const int n = tid % WC * 4;
    const bool nin = n0 + n < F;
    int kw = tid / WC;
    long long off = (long long)(k0 + kw) * F + n0 + n;
    float* g = sm + C::X_ELEMS + kw * C::BN + n;
#pragma unroll
    for (int t = 0; t < WN; ++t) {
      const bool ok = nin && k0 + kw < D;
      hopper::cp_async16(g, wg + (ok ? off : 0), ok);
      hopper::cp_async16(g + C::W_ELEMS, wu + (ok ? off : 0), ok);
      kw += WR;
      off += (long long)WR * F;
      g += WR * C::BN;
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < XN; ++t) copy_x<C>(sm, x, t, k0, m0, M, D, tid);
#pragma unroll 1
    for (int t = 0; t < WN; ++t) copy_w<C>(sm, wg, wu, t, k0, n0, D, F, tid);
  }
}

// A thread's fragments of k row kk of a stage: its TM x values (frag_x),
// its TN weights of product p (frag_w), each four by one float4
template <class C>
__device__ __forceinline__ void frag_x(float (&a)[C::TM], const float* stage, int kk, int ty) {
  const float* xs = stage + kk * C::XLD + ty * 4;
#pragma unroll
  for (int h = 0; h < C::TM / 4; ++h) put4(a + 4 * h, xs + h * C::RH);
}
template <class C>
__device__ __forceinline__ void frag_w(float (&b)[C::TN], const float* stage, int kk, int tx,
                                       int p) {
  const float* ws = stage + C::X_ELEMS + p * C::W_ELEMS + kk * C::BN + tx * 4;
#pragma unroll
  for (int h = 0; h < C::TN / 4; ++h) put4(b + 4 * h, ws + h * C::CH);
}

template <class C>
__device__ __forceinline__ void fma_tile(float (&acc)[C::TM][C::TN], const float (&a)[C::TM],
                                         const float (&b)[C::TN]) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// One k row's fragments of both products, for the double-buffered mainloop
template <class C>
struct Frag {
  float a[C::TM], g[C::TN], u[C::TN];
  __device__ __forceinline__ void load(const float* stage, int kk, int ty, int tx) {
    frag_x<C>(a, stage, kk, ty);
    frag_w<C>(g, stage, kk, tx, 0);
    frag_w<C>(u, stage, kk, tx, 1);
  }
};
template <class C>
__device__ __forceinline__ void fma_frag(float (&acc)[2][C::TM][C::TN], const Frag<C>& f) {
  fma_tile<C>(acc[0], f.a, f.g);
  fma_tile<C>(acc[1], f.a, f.u);
}

// out = silu(x wg) (x wu) on the CUDA cores, tile class C.  EXPERTS: E
// products, the expert on the grid's z axis.  The grid's x axis walks the
// row tiles, so the CTAs that share a slab of the weights run together and
// read it from L2.  Every output is one thread's FFMA chain over k in order
// (or KSPLIT such chains added in group order): two launches give the same
// bits.  The epilogue is IEEE f32: g / (1 + expf(-g)) u, the division
// correctly rounded.
template <class C, bool FAST, bool EXPERTS, typename T>
__global__ void __launch_bounds__(C::NT, C::CTAS) swiglu_cuda_core_kernel(
    const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
    T* __restrict__ out, int M, int D, int F) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int grp = tid / C::GROUP, tx = tid % C::GROUP % C::NTX, ty = tid % C::GROUP / C::NTX;
  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  if constexpr (EXPERTS) {
    const long long e = blockIdx.z;
    x += e * M * D;
    wg += e * D * F;
    wu += e * D * F;
    out += e * M * F;
  }
  const int nk = (D + C::BK - 1) / C::BK;
  const int kg0 = grp * C::KG;  // the group's first k row of a stage
  float acc[2][C::TM][C::TN];   // gate, up
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[0][i][j] = acc[1][i][j] = 0.f;

  // the ring: stage i lives in slot i % STAGES; stages i + 1 .. i + STAGES -
  // 2 are in flight while stage i is read; one barrier a stage
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nk) load<C, FAST>(sm + s * C::STAGE, x, wg, wu, s * C::BK, m0, n0, M, D, F, tid);
    hopper::cp_async_commit();
  }
  hopper::cp_async_wait<C::STAGES - 2>();  // stage 0 has landed ...
  __syncthreads();                      // ... for every thread
  if constexpr (C::DB) {
    Frag<C> frag[2];
    frag[0].load(sm, kg0, ty, tx);
    for (int i = 0; i < nk; ++i) {
      const float* cur = sm + (i % C::STAGES) * C::STAGE;
#pragma unroll
      for (int q = 0; q < C::KG; ++q) {
        if (q == C::KG - 1) {
          hopper::cp_async_wait<C::STAGES - 2>();  // stage i + 1 has landed, and every
          __syncthreads();                      // thread has read its last of stage i - 1
          frag[(q + 1) & 1].load(sm + ((i + 1) % C::STAGES) * C::STAGE, kg0, ty, tx);
        } else {
          frag[(q + 1) & 1].load(cur, kg0 + q + 1, ty, tx);
        }
        if (q == 0) {  // into the slot stage i - 1 left
          if (i + C::STAGES - 1 < nk)
            load<C, FAST>(sm + ((i + C::STAGES - 1) % C::STAGES) * C::STAGE, x, wg, wu,
                          (i + C::STAGES - 1) * C::BK, m0, n0, M, D, F, tid);
          hopper::cp_async_commit();
        }
        fma_frag<C>(acc, frag[q & 1]);
      }
    }
  } else {
    // no second set of fragments: the gate's FFMAs run on x and wg, then the
    // up product's on x and wu in wg's registers (16 live, not 24)
    for (int i = 0; i < nk; ++i) {
      if (i + C::STAGES - 1 < nk)  // into the slot stage i - 1 left
        load<C, FAST>(sm + ((i + C::STAGES - 1) % C::STAGES) * C::STAGE, x, wg, wu,
                      (i + C::STAGES - 1) * C::BK, m0, n0, M, D, F, tid);
      hopper::cp_async_commit();
      const float* cur = sm + (i % C::STAGES) * C::STAGE;
#pragma unroll
      for (int q = 0; q < C::KG; ++q) {
        float a[C::TM], b[C::TN];
        frag_x<C>(a, cur, kg0 + q, ty);
        frag_w<C>(b, cur, kg0 + q, tx, 0);
        fma_tile<C>(acc[0], a, b);
        frag_w<C>(b, cur, kg0 + q, tx, 1);
        fma_tile<C>(acc[1], a, b);
      }
      hopper::cp_async_wait<C::STAGES - 2>();  // stage i + 1 has landed, and every
      __syncthreads();                      // thread is done with stage i
    }
  }

  auto silu_mul = [](float g, float u) { return g / (1.f + expf(-g)) * u; };
  if constexpr (C::KSPLIT == 1) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int m = m0 + i / 4 * C::RH + ty * 4 + i % 4;
      if (m >= M) continue;
#pragma unroll
      for (int h = 0; h < C::TN / 4; ++h) {
        const int n = n0 + h * C::CH + tx * 4;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = silu_mul(acc[0][i][4 * h + j], acc[1][i][4 * h + j]);
        T* o = out + (long long)m * F + n;
        if constexpr (FAST) {
          if (n < F) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < F) store(o + j, v[j]);
        }
      }
    }
  } else {
    // the ring's memory takes the groups' partials, [KSPLIT][gate, up][BM][BN]
    hopper::cp_async_wait<0>();
    __syncthreads();  // every group is done with the ring
    constexpr int TILE = C::BM * C::BN;
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int o = (i / 4 * C::RH + ty * 4 + i % 4) * C::BN + j / 4 * C::CH + tx * 4 + j % 4;
        sm[2 * grp * TILE + o] = acc[0][i][j];
        sm[(2 * grp + 1) * TILE + o] = acc[1][i][j];
      }
    __syncthreads();
    for (int o = tid; o < TILE; o += C::NT) {
      const int m = m0 + o / C::BN, n = n0 + o % C::BN;
      float g = sm[o], u = sm[TILE + o];
#pragma unroll
      for (int s = 1; s < C::KSPLIT; ++s) {
        g += sm[2 * s * TILE + o];
        u += sm[(2 * s + 1) * TILE + o];
      }
      if (m < M && n < F) store(out + (long long)m * F + n, silu_mul(g, u));
    }
  }
}

template <class C, bool FAST, bool EXPERTS, typename T>
int launch(const void* x, const void* wg, const void* wu, void* out, int E, int M, int D, int F,
           cudaStream_t stream) {
  const dim3 grid((M + C::BM - 1) / C::BM, (F + C::BN - 1) / C::BN, E);
  if (C::BYTES > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(swiglu_cuda_core_kernel<C, FAST, EXPERTS, T>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 C::BYTES);
    if (err != cudaSuccess) return (int)err;
  }
  swiglu_cuda_core_kernel<C, FAST, EXPERTS, T><<<grid, C::NT, C::BYTES, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<T*>(out), M, D, F);
  return (int)cudaGetLastError();
}

// The tile class of a call: 0 (Small) for M <= SMALL_M; else 1 (R64) or 2
// (R128), whichever costs less in a wave-count model, the larger tile on a
// tie: a wave is one CTA on each of the CTAS slots of every SM, and takes as
// long as an SM needs for CTAS x BM x BN outputs of each product; the tiles
// take ceil(tiles / (SMs x CTAS)) waves.  M = 512, F = 5632: 352 tiles of
// R128 fill one wave of 396 slots (89%), as 704 of R64 fill 792; R128's
// larger tile reads less of L2 for the same outputs.
// kernels/swiglu_matmul.py::cuda_core_plan repeats it.
int tile_class(long long E, long long M, long long F, long long sms) {
  if (M <= SMALL_M) return 0;
  auto cost = [&](long long bm, long long bn, long long ctas) {
    const long long tiles = E * ((M + bm - 1) / bm) * ((F + bn - 1) / bn), slots = sms * ctas;
    return (tiles + slots - 1) / slots * ctas * bm * bn;
  };
  return cost(R64::BM, R64::BN, R64::CTAS) < cost(R128::BM, R128::BN, R128::CTAS) ? 1 : 2;
}

// The fast load path: f32, F % 4 == 0, and wg, wu and out on 16-byte
// boundaries (x goes 4 bytes at a time: D and x's alignment are free).
bool fast_path(int dtype, int F, bool aligned) { return dtype == 0 && F % 4 == 0 && aligned; }

bool aligned16(const void* wg, const void* wu, const void* out) {
  return ((reinterpret_cast<uintptr_t>(wg) | reinterpret_cast<uintptr_t>(wu) |
           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

template <class C, bool EXPERTS>
int launch_path(bool fast, int dtype, const void* x, const void* wg, const void* wu, void* out,
                int E, int M, int D, int F, cudaStream_t s) {
  if (dtype == 1) return launch<C, false, EXPERTS, __nv_bfloat16>(x, wg, wu, out, E, M, D, F, s);
  if (fast) return launch<C, true, EXPERTS, float>(x, wg, wu, out, E, M, D, F, s);
  return launch<C, false, EXPERTS, float>(x, wg, wu, out, E, M, D, F, s);
}

template <bool EXPERTS>
int dispatch(const void* x, const void* wg, const void* wu, void* out, int E, int M, int D, int F,
             int dtype, cudaStream_t s) {
  const bool fast = fast_path(dtype, F, aligned16(wg, wu, out));
  switch (tile_class(E, M, F, hopper::num_sms())) {
    case 0:
      return launch_path<Small, EXPERTS>(fast, dtype, x, wg, wu, out, E, M, D, F, s);
    case 1:
      return launch_path<R64, EXPERTS>(fast, dtype, x, wg, wu, out, E, M, D, F, s);
    default:
      return launch_path<R128, EXPERTS>(fast, dtype, x, wg, wu, out, E, M, D, F, s);
  }
}

// A class's constants (layout keys 8 c + f, below); f = 6: the CTAs an SM
// the card gives its f32 fast-path kernel
template <class C>
long long constant(int f) {
  switch (f) {
    case 0: return C::BM;
    case 1: return C::BN;
    case 2: return C::BK;
    case 3: return C::KSPLIT;
    case 4: return C::NT;
    case 5: return C::CTAS;
    case 6: {
      int n = -1;
      auto kernel = swiglu_cuda_core_kernel<C, true, false, float>;
      if ((C::BYTES > 48 * 1024 &&
           cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                C::BYTES) != cudaSuccess) ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::NT, C::BYTES) !=
              cudaSuccess)
        return -1;
      return n;
    }
    case 7: return C::STAGES;
    default: return -1;
  }
}
}  // namespace simt

// ------------------------------------------------------------------------- //
// 1. prefill: wgmma fed by TMA, warp-specialised
// ------------------------------------------------------------------------- //
using bf16 = __nv_bfloat16;

namespace prefill {
constexpr int BK = 64;      // one 128-byte swizzle atom of bf16 along K
constexpr int ATOM = 64;    // bf16 columns of one 128-byte swizzle atom
constexpr int STAGES = 4;
// The backward's epilogue buffers (item 4 of the header), each a tile's
// [BM, BN] of bf16: two where they fit beside the ring (dout, then dg over
// it; du), else one (dout, then dg and du through it by halves).
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a CTA may have
constexpr int DOUT_BUF = 0;      // the epilogue buffer every tile's dout lands in
constexpr int BOX_ROWS = 64;     // an epilogue box: one warpgroup's rows ..
constexpr int BOX_COLS = ATOM;   // .. by one 128-byte swizzle atom of columns

// CONS consumer warpgroups of 64 rows each (BM = 64 CONS), then one producer
// warpgroup; setmaxnreg hands the producer's registers to the consumers.
// BN columns of each product per tile: 128 with two consumers (n256, 128
// accumulators a thread), 64 with three (n128: ptxas caps a 512-thread
// kernel at 128 registers a thread).  BWD: the backward's epilogue buffers
// ([EPI_BUFS][CONS][NA] boxes of [64 rows, 64 columns]).
template <int CONS, int BN, bool BWD = false>
struct Cfg {
  static constexpr int NA = BN / ATOM;  // swizzle atoms per product
  static constexpr int BM = 64 * CONS;
  static constexpr int NT = 128 * (CONS + 1);
  static constexpr int A_ELEMS = BM * BK;       // x tile, K-major
  static constexpr int B_ELEMS = 2 * BK * BN;   // gate atoms, then up atoms
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
  static constexpr int BOX_BYTES = BOX_ROWS * BOX_COLS * 2;
  static constexpr int EPI_ELEMS = CONS * NA * BOX_ROWS * BOX_COLS;  // one epilogue buffer
  static constexpr int NBARS = 2 * STAGES + (BWD ? 2 * CONS : 0);
  static constexpr size_t bytes(int bufs) {
    return (size_t)STAGES * STAGE_BYTES + (size_t)bufs * EPI_ELEMS * 2 + NBARS * 8 + 1024;
  }
  static constexpr int EPI_BUFS = !BWD ? 0 : bytes(2) <= SMEM_MAX ? 2 : 1;
  static constexpr size_t BYTES = bytes(EPI_BUFS);
  static_assert(BYTES <= SMEM_MAX && (EPI_BUFS != 1 || NA == 2), "shared memory");
  static constexpr int PRODUCER_REGS = CONS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = CONS == 2 ? 232 : 160;
};

// The backward's epilogue maps: dout read, dg and du written, each in boxes
// of [BOX_ROWS, BOX_COLS] with the 128-byte swizzle (2-D {F, M}; the expert
// entry's 4-D {F, M, E, 1}).  The forward passes them zeroed and unread.
struct BwdMaps {
  CUtensorMap dout, dg, du;
};

template <int BN>
__device__ __forceinline__ void mma_tile(float (&acc)[BN], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) {
    hopper::wgmma_m64n256k16_tb(acc, da, db, 1);
  } else {
    hopper::wgmma_m64n128k16_tb(acc, da, db, 1);
  }
}

// One epilogue box to or from the tensor of `map` at column c, row r (of
// expert e: EXPERTS).
template <bool EXPERTS>
__device__ __forceinline__ void box_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int r, int e) {
  if constexpr (EXPERTS) {
    hopper::tma_load_4d(dst, map, bar, c, r, e, 0);
  } else {
    hopper::tma_load_2d(dst, map, bar, c, r);
  }
}
template <bool EXPERTS>
__device__ __forceinline__ void box_store(const CUtensorMap* map, const void* src, int c, int r,
                                          int e) {
  if constexpr (EXPERTS) {
    hopper::tma_store_4d(map, src, c, r, e, 0);
  } else {
    hopper::tma_store_2d(map, src, c, r);
  }
}

// Byte offset of a consumer thread's accumulator pair i (row 16 warp +
// lane/4 + 8 ((i/2) % 2), columns 8 (i/4) + 2 (lane % 4) + {0, 1} of its
// warpgroup's tile) in the warpgroup's epilogue boxes of BOX_BYTES each,
// [64 rows, 64 columns] of bf16 in the 128-byte swizzle.
template <int BOX_BYTES>
__device__ __forceinline__ int epi_offset(int i, int warp, int lane) {
  const int r8 = lane >> 2, rr = warp * 16 + r8 + 8 * ((i >> 1) & 1), cc = i >> 2;
  return (cc / 8) * BOX_BYTES + rr * 128 + (((cc & 7) ^ r8) << 4) + (lane & 3) * 4;
}

// dg and du (bf16 pairs) of one pair of g = (g0, g1), u = (u0, u1) at dout
// `dbits` (a bf16 pair), in f32: s = σ(g); du = dout g s; dg = dout u s
// (1 + g (1 - s)).
__device__ __forceinline__ void grad_pair(float g0, float g1, float u0, float u1, uint32_t dbits,
                                          uint32_t& dg, uint32_t& du) {
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dbits));
  const float s0 = __fdividef(1.f, 1.f + __expf(-g0)), s1 = __fdividef(1.f, 1.f + __expf(-g1));
  du = hopper::pack_bf16(d.x * g0 * s0, d.y * g1 * s1);
  dg = hopper::pack_bf16(d.x * u0 * s0 * (1.f + g0 * (1.f - s0)),
                         d.y * u1 * s1 * (1.f + g1 * (1.f - s1)));
}

// EXPERTS: E products, 4-D maps with the expert as their third coordinate.
// BWD: the backward's epilogue (the derivative at dout, into dg and du, by
// TMA both ways) in place of the forward's (silu(g) u into out by direct
// stores); bmaps is read only with it.
template <int CONS, int BN, bool EXPERTS, bool BWD>
__global__ void __launch_bounds__(Cfg<CONS, BN, BWD>::NT, 1) swiglu_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
    const __grid_constant__ CUtensorMap umap, bf16* __restrict__ out,
    const __grid_constant__ BwdMaps bmaps, int E, int M, int D, int F) {
  using C = Cfg<CONS, BN, BWD>;
  constexpr int NA = C::NA;
  constexpr bool TMA_EPI = BWD;  // dout in and dg, du out by TMA
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* sa = reinterpret_cast<bf16*>(smem_raw + pad);  // [STAGES][A_ELEMS]
  bf16* sb = sa + STAGES * C::A_ELEMS;                 // [STAGES][B_ELEMS]
  bf16* epi = sb + STAGES * C::B_ELEMS;                // [EPI_BUFS][CONS][NA][64 x 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + C::EPI_BUFS * C::EPI_ELEMS);
  uint64_t* empty = full + STAGES;
  uint64_t* epi_full = empty + STAGES;    // [CONS]: a warpgroup's dout has landed
  uint64_t* epi_empty = epi_full + CONS;  // [CONS]: its stores have read the buffers

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
    if constexpr (TMA_EPI) {
      for (int w = 0; w < CONS; ++w) {
        hopper::mbar_init(&epi_full[w], 1);
        hopper::mbar_init(&epi_empty[w], 1);  // the warpgroup's storing thread
      }
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (group == CONS) {
    // producer: one thread issues every TMA load
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == CONS * 128) {
      // a tile's dout goes out once the consumers have freed this tile's
      // first stage (so they are past the last tile's epilogue), or at its
      // last k block when it has fewer
      const int dout_kb = kblocks - 1 < STAGES ? kblocks - 1 : STAGES;
      int it = 0;  // stage uses so far
      int j = 0;   // this CTA's tiles so far
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++j) {
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
          if constexpr (TMA_EPI) {
            if (kb == dout_kb) {
              for (int w = 0; w < CONS; ++w) {
                hopper::mbar_wait(&epi_empty[w], (j & 1) ^ 1);
                hopper::mbar_expect_tx(&epi_full[w], NA * C::BOX_BYTES);
                bf16* dst = epi + DOUT_BUF * C::EPI_ELEMS + w * NA * BOX_ROWS * BOX_COLS;
#pragma unroll
                for (int a = 0; a < NA; ++a)
                  box_load<EXPERTS>(dst + a * BOX_ROWS * BOX_COLS, &bmaps.dout, &epi_full[w],
                                    n0 + a * BOX_COLS, m0 + w * BOX_ROWS, e);
              }
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup `group` owns rows 64 group .. 64 group + 63
    hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const bool storer = threadIdx.x % 128 == 0;  // issues the warpgroup's TMA stores
    int it = 0, j = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, ++j) {
      const int m0 = (t % mtiles) * C::BM, n0 = (t / mtiles % ncols) * BN;
      const int e = t / (mtiles * ncols);
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
        if constexpr (TMA_EPI) {
          // the last tile's stores were issued just before this k block's
          // products: once they have read the buffers, the producer may
          // bring this tile's dout
          if (kb == 0 && j > 0 && storer) {
            hopper::bulk_wait_read<0>();
            hopper::mbar_arrive(&epi_empty[group]);
          }
        }
        hopper::wgmma_wait<1>();  // the previous stage's products are done: free it
        if (kb > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      hopper::wgmma_wait<0>();
      if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % STAGES]);  // the tile's last stage

      // value i of a thread is row 16 warp + lane/4 + 8 ((i/2) % 2), column
      // 8 (i/4) + 2 (lane % 4) + i % 2 of the warpgroup's [64, 2 BN]
      if constexpr (TMA_EPI) {
        // dg and du from the f32 accumulators (grad_pair): g and u are never
        // rounded or stored.  Pair i of a thread sits at the same place
        // at(i) in the warpgroup's boxes of every buffer; a thread reads its
        // own dout and writes its dg over it, so no thread waits for another
        // before the stores, and the warpgroup's boxes go out as soon as its
        // own threads are done: no barrier with the other consumers.
        uint8_t* const din = reinterpret_cast<uint8_t*>(epi + DOUT_BUF * C::EPI_ELEMS +
                                                        group * NA * BOX_ROWS * BOX_COLS);
        uint8_t* const dub = reinterpret_cast<uint8_t*>(epi + (C::EPI_BUFS - 1) * C::EPI_ELEMS +
                                                        group * NA * BOX_ROWS * BOX_COLS);
        auto at = [&](int i) { return epi_offset<C::BOX_BYTES>(i, warp, lane); };
        auto grads = [&](int i, uint32_t dbits, uint32_t& dgb, uint32_t& dub_) {
          grad_pair(acc[i], acc[i + 1], acc[i + BN / 2], acc[i + 1 + BN / 2], dbits, dgb, dub_);
        };
        auto word = [](uint8_t* p) -> uint32_t& { return *reinterpret_cast<uint32_t*>(p); };
        auto store = [&](const CUtensorMap* map, const uint8_t* box, int a) {
          box_store<EXPERTS>(map, box, n0 + a * BOX_COLS, m0 + group * BOX_ROWS, e);
        };
        hopper::mbar_wait(&epi_full[group], j & 1);
        if constexpr (C::EPI_BUFS == 2) {
#pragma unroll
          for (int i = 0; i < BN / 2; i += 2) grads(i, word(din + at(i)), word(din + at(i)),
                                                    word(dub + at(i)));
          hopper::fence_proxy_async();
          hopper::named_sync(1 + group, 128);
          if (storer) {
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              store(&bmaps.dg, din + a * C::BOX_BYTES, a);
              store(&bmaps.du, dub + a * C::BOX_BYTES, a);
            }
            hopper::bulk_commit();
          }
        } else {
          // one buffer, two boxes a warpgroup: columns 0-63's dg over their
          // dout (box 0) and their du over columns 64-127's dout (box 1),
          // which waits in registers; those boxes leave while columns
          // 64-127's derivative is computed, then go through the same boxes
          constexpr int HALF = BN / 4;  // a box's pairs: i < HALF in box 0
          uint32_t d1[HALF / 2], dg1[HALF / 2], du1[HALF / 2];
#pragma unroll
          for (int i = HALF; i < BN / 2; i += 2) d1[(i - HALF) / 2] = word(din + at(i));
#pragma unroll
          for (int i = 0; i < HALF; i += 2)
            grads(i, word(din + at(i)), word(din + at(i)), word(din + C::BOX_BYTES + at(i)));
          hopper::fence_proxy_async();
          hopper::named_sync(1 + group, 128);
          if (storer) {
            store(&bmaps.dg, din, 0);
            store(&bmaps.du, din + C::BOX_BYTES, 0);
            hopper::bulk_commit();
          }
#pragma unroll
          for (int i = HALF; i < BN / 2; i += 2)
            grads(i, d1[(i - HALF) / 2], dg1[(i - HALF) / 2], du1[(i - HALF) / 2]);
          if (storer) hopper::bulk_wait_read<0>();
          hopper::named_sync(1 + group, 128);
#pragma unroll
          for (int i = HALF; i < BN / 2; i += 2) {
            word(din + at(i) - C::BOX_BYTES) = dg1[(i - HALF) / 2];
            word(din + at(i)) = du1[(i - HALF) / 2];
          }
          hopper::fence_proxy_async();
          hopper::named_sync(1 + group, 128);
          if (storer) {
            store(&bmaps.dg, din, 1);
            store(&bmaps.du, din + C::BOX_BYTES, 1);
            hopper::bulk_commit();
          }
        }
      } else {
        // the forward: silu(g) u straight from the accumulators
        bf16* oe = out + (long long)e * M * F;
#pragma unroll
        for (int i = 0; i < BN / 2; i += 2) {
          const int r = m0 + group * 64 + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
          const int c = n0 + (i >> 2) * 8 + (lane & 3) * 2;
          if (r < M && c < F) {  // F is a multiple of 8, so c + 1 < F too
            const float g0 = acc[i], g1 = acc[i + 1];
            const float u0 = acc[i + BN / 2], u1 = acc[i + 1 + BN / 2];
            *reinterpret_cast<__nv_bfloat162*>(oe + (long long)r * F + c) = __floats2bfloat162_rn(
                g0 / (1.f + __expf(-g0)) * u0, g1 / (1.f + __expf(-g1)) * u1);
          }
        }
      }
    }
    // the shared memory the last stores read lives as long as the CTA
    if constexpr (TMA_EPI) {
      if (storer) hopper::bulk_wait<0>();
    }
  }
}

template <int CONS, int BN, bool EXPERTS, bool BWD>
int launch(const void* x, const void* wgt, const void* wup, void* out, const void* dout,
           void* du, int E, int M, int D, int F, cudaStream_t stream) {
  using C = Cfg<CONS, BN, BWD>;
  CUtensorMap xm, gm, um;
  BwdMaps bm{};
  if constexpr (EXPERTS) {
    const long long xd[4] = {D, M, E, 1}, wd[4] = {F, D, E, 1}, od[4] = {F, M, E, 1};
    const long long xs[3] = {2LL * D, 2LL * M * D, 2LL * E * M * D};
    const long long ws[3] = {2LL * F, 2LL * D * F, 2LL * E * D * F};
    const long long os[3] = {2LL * F, 2LL * M * F, 2LL * E * M * F};
    const int xbox[4] = {BK, C::BM, 1, 1}, wbox[4] = {ATOM, BK, 1, 1};
    const int obox[4] = {BOX_COLS, BOX_ROWS, 1, 1};
    if (!hopper::make_map_bf16_4d(&xm, x, xd, xs, xbox) ||
        !hopper::make_map_bf16_4d(&gm, wgt, wd, ws, wbox) ||
        !hopper::make_map_bf16_4d(&um, wup, wd, ws, wbox))
      return (int)cudaErrorInvalidValue;
    if (BWD && (!hopper::make_map_bf16_4d(&bm.dout, dout, od, os, obox) ||
                !hopper::make_map_bf16_4d(&bm.dg, out, od, os, obox) ||
                !hopper::make_map_bf16_4d(&bm.du, du, od, os, obox)))
      return (int)cudaErrorInvalidValue;
  } else {
    if (!hopper::make_map_bf16(&xm, x, M, D, C::BM, BK) ||
        !hopper::make_map_bf16(&gm, wgt, D, F, BK, ATOM) ||
        !hopper::make_map_bf16(&um, wup, D, F, BK, ATOM))
      return (int)cudaErrorInvalidValue;
    if (BWD && (!hopper::make_map_bf16(&bm.dout, dout, M, F, BOX_ROWS, BOX_COLS) ||
                !hopper::make_map_bf16(&bm.dg, out, M, F, BOX_ROWS, BOX_COLS) ||
                !hopper::make_map_bf16(&bm.du, du, M, F, BOX_ROWS, BOX_COLS)))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(swiglu_wgmma_kernel<CONS, BN, EXPERTS, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)E * ((M + C::BM - 1) / C::BM) * ((F + BN - 1) / BN);
  const int grid = tiles < hopper::num_sms() ? (int)tiles : hopper::num_sms();  // one CTA per SM
  swiglu_wgmma_kernel<CONS, BN, EXPERTS, BWD><<<grid, C::NT, C::BYTES, stream>>>(
      xm, gm, um, static_cast<bf16*>(out), bm, E, M, D, F);
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return simt::dispatch<false>(x, wg, wu, out, 1, M, D, F, dtype,
                               static_cast<cudaStream_t>(stream));
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return simt::dispatch<true>(x, wg, wu, out, E, M, D, F, dtype,
                              static_cast<cudaStream_t>(stream));
}

// The CUDA-core entries' plan for E products of M rows (E = 1: one product),
// D, F, dtype (0 = f32, 1 = bf16) and whether wg, wu and out lie on 16-byte
// boundaries, on this card: its tile class (0 Small, 1 R64, 2 R128) times 2,
// plus 1 on the fast load path; -1 for shapes the entries refuse.
// kernels/swiglu_matmul.py::cuda_core_plan repeats it; a card test holds the
// two equal.
extern "C" long long swiglu_cuda_core_plan(int E, int M, int D, int F, int dtype, int aligned) {
  if (E <= 0 || M <= 0 || D <= 0 || F <= 0 || (dtype != 0 && dtype != 1)) return -1;
  return 2LL * simt::tile_class(E, M, F, hopper::num_sms()) +
         (simt::fast_path(dtype, F, aligned != 0) ? 1 : 0);
}

// The CUDA-core kernel's constants, which kernels/swiglu_matmul.py repeats
// (CUDA_CORE_CLASSES, CUDA_CORE_SMALL_M) and a card test holds equal: key 8
// c + f for tile class c (0 Small, 1 R64, 2 R128), f = 0 its rows, 1 its
// columns, 2 the k rows of a stage, 3 its k groups, 4 its threads, 5 the
// CTAs an SM it is built for, 6 the CTAs an SM this card gives its f32
// kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor), 7 its ring's
// stages; key 24 the small class's largest M; -1 for any other.
extern "C" long long swiglu_cuda_core_layout(int key) {
  if (key == 24) return simt::SMALL_M;
  if (key < 0 || key >= 24) return -1;
  switch (key / 8) {
    case 0: return simt::constant<simt::Small>(key % 8);
    case 1: return simt::constant<simt::R64>(key % 8);
    default: return simt::constant<simt::R128>(key % 8);
  }
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

// The backward's tile, stage and buffer constants, which the CPU model of
// its walk (kernels/ref.py::swiglu_bwd_tiles) repeats and a card test holds
// equal: key 0 the ring's stages, 1 and 2 the epilogue buffers of the two-
// and the three-consumer tile, 3 the buffer dout lands in, 4 and 5 an
// epilogue box's rows and columns, 6 and 7 the two-consumer tile's rows and
// columns (the expert entry's too), 8 and 9 the three-consumer tile's, 10
// the two-consumer backward's dynamic shared memory in bytes; -1 for any
// other key.
extern "C" long long swiglu_matmul_bwd_layout(int key) {
  using C2 = prefill::Cfg<2, 128, true>;
  using C3 = prefill::Cfg<3, 64, true>;
  const long long v[] = {prefill::STAGES,    C2::EPI_BUFS,      C3::EPI_BUFS,
                         prefill::DOUT_BUF,  prefill::BOX_ROWS, prefill::BOX_COLS,
                         C2::BM,             128,               C3::BM,
                         64,                 (long long)C2::BYTES};
  return key >= 0 && key < (int)(sizeof(v) / sizeof(v[0])) ? v[key] : -1;
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
