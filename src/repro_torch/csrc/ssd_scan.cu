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
// 2. `cuda_core` (entry ssd_scan_fwd; namespace simt): f32, and every other
//    shape (any P, N a multiple of 4 up to 128), on flat contiguous [BH, S,
//    *] operands, in IEEE f32 on the CUDA cores (FFMA; no TF32, no bf16
//    rounding of an f32 operand).  What bounds it: at 32 heads, S = 1024, P =
//    64, N = 128 its products, 1.28 GFLOP counted at chunks of 32 (1.48 at
//    its own 64), take 0.019 ms at 67 TFLOP/s, its 51.5 MB 0.015 ms: it is
//    bound by operations.  The design: the three chunk-parallel phases of
//    `wgmma` over chunks of 64 (in place of a walk over 32 chunks in series
//    on 128 blocks), one launch of the variant:
//    - chunk_state, grid (BH, chunk, 64 columns of P), 128 threads: cs by two
//      warp scans; s_c^T = B^T (x ∘ w) as a rank-64 update, each thread's 8 x
//      8 outputs (at N 128) fed by one float4 of x ∘ w and one of B a row;
//      x and B come in four cp.async stages, each row of x scaled by w_j by
//      the thread that copied it; into an f32 scratch [BH, chunk, N, P
//      padded to 4] (ssd_cuda_core_scratch_floats gives its size), and the
//      decay exp(cs_Q);
//    - the state pass of (1), its SIMT instantiation (that layout);
//    - chunk_scan, grid as chunk_state, eight warps: before
//      griddepcontrol.wait, C B^T of one 16-row band a warp over only the
//      columns the band's triangle reads (each band paired with the S x
//      band of the other end, so that the warps' work evens out), S = C B^T
//      ∘ L ∘ dt stored transposed, and S x; then h^T and C h^T into a second
//      accumulator, added with exp(cs).  4 x 4 outputs a thread.  Every
//      CTA waits for the state pass, chunk 0's too (it reads no state), so
//      that the call's last kernel ends after the pass: a later operation
//      on the stream, or a reuse of the scratch, cannot overtake it.
//    Two tile classes by N (32, Jamba's 16; 128: shared memory and the N
//    loops; N 36 to 124 take the 128 class's tiles, zero past N) and
//    two load paths (16-byte cp.async for f32 with P % 4 == 0 on aligned
//    operands; element loads converted to f32, 8 in flight a thread, for
//    the rest and bf16).  Every output one FFMA chain in a fixed order, no
//    float atomics: two launches give the same bits.  It runs at ~23% of the
//    0.019 ms (PERF.md): what holds it is its phases' loads, stores
//    and barriers, each phase's CTAs in step (without any FFMA a call takes
//    63% of its time, without loads or FFMAs 34%), and the states' round
//    trip through the scratch.
//
// 3. `wgmma_bwd` (entry ssd_scan_wgmma_bwd): the backward of `wgmma`, on the
//    same layout.  The Pallas kernel has no VJP (the reference trains through
//    _ssd_chunked, which XLA differentiates), so this replaces no TPU kernel:
//    it computes what jax.vjp of _ssd_chunked gives, (dx, ddt, dA, dB, dC) at
//    the cotangents dy and dh_final, where kernels/ssd_scan.py::ssd_scan_vjp
//    (its plain version) computes it in eager PyTorch.  Three kernels, one
//    count (ref.ssd_scan_bwd_phases emulates them):
//    - bwd_states, grid (64-column atom of N, batch·H, direction): one CTA
//      walks a head's chunks in order for h0, the state each chunk starts
//      from, and in reverse for dh1, the cotangent of the state each chunk
//      ends with, adding each chunk's own term (one wgmma product) to the
//      state it carries in registers, and writes each state once, as the
//      bf16 hi and lo tiles the next kernel's products read (recomputed
//      rather than saved by the forward: a saved state would keep 67 MB a
//      layer and microbatch alive at mamba2's train shape without remat);
//    - chunk_grad, grid (rank, chunk, batch·G) in clusters of 1 to 8 CTAs of
//      two warpgroups (whichever takes the fewest waves times heads on this
//      card): each CTA walks its run of a group's heads, loads the
//      group's B and C tiles and computes C B^T once, and keeps dC and dB
//      summed over its heads in registers (each head's state product scaled
//      by row into the sum; dCB summed over the heads before its products);
//      then the cluster sums dB and dC over its ranks in rank order through
//      distributed shared memory and writes them in bf16;
//    - dA_reduce: dA over chunks.
//    No float atomics: two launches give the same bits.  What bounds it: at
//    mamba2's train layout (B 4, S 1024, H 32, N 128, one group) the bytes
//    of x, dy, dx, B, C, dB, dC, dt and ddt, 55.6 MB, ~16.6 us at 3.35 TB/s
//    (kernels/ssd_scan.py::work_bwd); the products, ~15.2 GFLOP, ~15.4 us
//    at the bf16 peak: bytes, by a little.  This design's own traffic beyond
//    that is the states, written once and read once (2 x 67 MB at that
//    layout); nothing is kept per head beyond them.
//
// -Xptxas -v (sm_90a, nvcc 12.8), no spills but where stated:
// ssd_chunk_scan_kernel 128 / 113 registers (N > 64 / N <= 64; launch
// bounds of 4 CTAs an SM), 42,760 /
// 34,568 bytes of dynamic shared memory; ssd_chunk_state_kernel 122 / 90
// registers, 26,376 / 18,184 bytes; ssd_state_pass_kernel 141 registers;
// cuda_core (f32 fast path, at N 128 / 32): ssd_cc_state_kernel 125 / 72
// registers, 49,664 / 25,088 bytes (4 / 7 CTAs an SM); ssd_cc_scan_kernel
// 126 / 80 registers, 84,480 / 43,520 bytes (2 / 3 CTAs an SM; 28 bytes
// spilled at N 32).  The
// backward: ssd_bwd_states_kernel 128 registers (4 CTAs an SM), 50,704 bytes;
// ssd_chunk_grad_kernel 255 registers with 16 bytes spilled / 231 (256
// threads), 151,608 / 102,456 bytes (one CTA an SM); ssd_dA_reduce_kernel 31.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NMAX = 128;  // largest state width N

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

// The A fragments of the four k16 steps of (u ∘ s)^T [p, j] (M = p, K = j),
// u a [Q][P] tile (x or dy) and s a per-position scale, as hi + lo halves:
// register r of step kk holds rows p0 + 8 (r & 1), columns 16 kk + 8 (r >> 1)
// + 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void frags_t(const bf16* u, const float* s, uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
  const int lane = threadIdx.x & 31;
  const int p0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + 8 * (r & 1);
      const int j = 16 * kk + 8 * (r >> 1) + 2 * (lane & 3);
      split2(__bfloat162float(u[swz(j, p)]) * s[j], __bfloat162float(u[swz(j + 1, p)]) * s[j + 1],
             hi[kk][r], lo[kk][r]);
    }
  }
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
template <int NA>
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
  if (tid < Q) w[tid] = expf(cs[Q - 1] - cs[tid]) * dts[tid];
  if (tid == 0) decay[(long long)bh * nch + c] = expf(cs[Q - 1]);
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  uint32_t ahi[4][4], alo[4][4];  // (x∘w)^T [p, j]
  frags_t(sx, w, ahi, alo);
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
// starts all its loads before the chain of FMAs.  SIMT: the same pass for
// the cuda_core variant (namespace simt), whose states are [N][PP] (P
// padded to a multiple of 4), on the grid (batch·H, PN4 / PASS_NT).
template <bool SIMT>
__global__ void __launch_bounds__(PASS_NT) ssd_state_pass_kernel(
    float* __restrict__ states, const float* __restrict__ decay, float* __restrict__ h_out,
    int PN4, int N, int nch, int Pv) {
  const int e = (SIMT ? blockIdx.y : blockIdx.x) * PASS_NT + threadIdx.x;
  const long long bh = SIMT ? blockIdx.x : blockIdx.y;
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
  if constexpr (SIMT) {
    // float4 e is row n, columns p .. p + 3 of the [N][PP] state
    const int p4 = PN4 / N, n = e / p4, p = 4 * (e % p4);
    float* o = h_out + (bh * Pv + p) * N + n;
    const float v[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p + k < Pv) o[k * N] = v[k];
    return;
  }
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
// _SSDScan.backward), three kernels on PyTorch's stream:
//   1. bwd_states, grid (64-column atom, batch·H, direction): the state each
//      chunk starts from (h0) and the cotangent of the state each chunk ends
//      with (dh1), one head's chunks walked in order (reverse order for dh1)
//      with the state carried in registers;
//   2. chunk_grad, grid (rank, chunk, batch·G) in clusters of the ranks:
//      every gradient of one chunk of one group's heads, dB and dC summed
//      over the heads on chip;
//   3. dA_reduce: dA over chunks.
// ------------------------------------------------------------------------- //
constexpr int ST_STAGES = 2;     // bwd_states' ring of (x or dy, B or C atom) tiles
constexpr int GRAD_NT = 2 * NT;  // chunk_grad: two warpgroups
constexpr int MAX_RANKS = 8;     // chunk_grad's largest cluster (the portable size)
// chunk_grad's named barriers: K is in shared memory (warpgroup 0 arrives,
// 1 waits); warpgroup 1 has read h0 (1 arrives, 0 waits); warpgroup 1 alone
constexpr int BAR_K = 1, BAR_HDOT = 2, BAR_WG1 = 3;

// A [64, 64] f32 accumulator (value v of a thread at row r0 + 8 ((v / 2) %
// 2), column 8 (v / 4) + 2 (lane % 4) + v % 2, r0 = 16 (warp % 4) + lane / 4)
// into bf16 hi and lo tiles [64][64], swizzled as TMA writes them: a K-major
// operand with M along the rows, or MN-major with K along them.
__device__ __forceinline__ void split_tile(const float (&v)[32], bf16* hi, bf16* lo) {
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = 8 * q + 2 * (lane & 3);
    uint32_t h, l;
    split2(v[4 * q], v[4 * q + 1], h, l);
    *reinterpret_cast<uint32_t*>(hi + swz(r0, n)) = h;
    *reinterpret_cast<uint32_t*>(lo + swz(r0, n)) = l;
    split2(v[4 * q + 2], v[4 * q + 3], h, l);
    *reinterpret_cast<uint32_t*>(hi + swz(r0 + 8, n)) = h;
    *reinterpret_cast<uint32_t*>(lo + swz(r0 + 8, n)) = l;
  }
}

// Phase 1 of the backward, grid (NA, batch·H, 2): one head's states, 64
// columns of N (atom a) a CTA, carried in registers from chunk to chunk.
// Direction 0 (x, B): h0(0) = 0, h0(c + 1) = exp(T_c) h0(c) + (x∘w)^T B
// with w_j = exp(T_c - cs_j) dt_j, each h0(c), c >= 1, into h0s[bh, c].
// Direction 1 (dy, C), from the last chunk: dh1(nch - 1) = dh_final (or 0),
// dh1(c - 1) = exp(T_c) dh1(c) + (dy∘exp(cs))^T C, each dh1(c) into
// dh1s[bh, c].  A chunk's own term is chunk_state's product (A = (u∘w)^T
// from registers as hi + lo, B the atom MN-major); the tiles come by TMA
// through a ring of ST_STAGES that thread 0 refills, dt a chunk ahead.
// Each state is kept as the bf16 hi and lo tiles chunk_grad's products read
// ([NA hi atoms][NA lo atoms] [P][64] of one (bh, c), swizzled, so that
// chunk_grad copies them to shared memory as they are), written through
// shared memory in 16-byte rows: as many bytes as the f32 state.
__global__ void __launch_bounds__(NT, 4) ssd_bwd_states_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap dymap, const __grid_constant__ CUtensorMap cmap,
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ dh_final,
    bf16* __restrict__ h0s, bf16* __restrict__ dh1s, const Layout L, int S, int H, int G, int N,
    int NA, int nch) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + pad);  // [ST_STAGES][u tile, atom tile]
  bf16* out = ring + ST_STAGES * 2 * TILE;               // the state's hi and lo tiles
  float* cs = reinterpret_cast<float*>(out + 2 * TILE);  // [Q]
  float* w = cs + Q;                                     // [Q]
  uint64_t* bar = reinterpret_cast<uint64_t*>(w + Q);    // [ST_STAGES]

  const bool rev = blockIdx.z != 0;
  const int a = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const CUtensorMap* umap = rev ? &dymap : &xmap;
  const CUtensorMap* vmap = rev ? &cmap : &bmap;
  hopper::griddep_launch_dependents();
  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) hopper::mbar_init(&bar[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the k-th chunk this CTA walks, and its tiles into stage k % ST_STAGES
  auto chunk = [&](int k) { return rev ? nch - 1 - k : k; };
  auto issue = [&](int k) {
    bf16* st = ring + (k % ST_STAGES) * 2 * TILE;
    uint64_t* br = &bar[k % ST_STAGES];
    const int t0 = chunk(k) * Q;
    hopper::mbar_expect_tx(br, 2 * TILE_BYTES);
    hopper::tma_load_4d(st, umap, br, 0, h, t0, b);
    hopper::tma_load_4d(st + TILE, vmap, br, a * ATOM, g, t0, b);
  };
  if (tid == 0)
    for (int k = 0; k < ST_STAGES && k < nch; ++k) issue(k);
  auto dt_of = [&](int k) {  // threads < Q: dt at the k-th chunk's position tid (0 past S)
    const int t = chunk(k) * Q + tid;
    return tid < Q && t < S ? dt[b * L.dt_b + t * L.dt_s + h * L.dt_h] : 0.f;
  };
  const float a_h = A[b * L.a_b + h * L.a_h];
  const int r0 = warp * 16 + (lane >> 2);
  float st[32];  // the carried state's atom, in the accumulator's order
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int p = r0 + 8 * ((v >> 1) & 1);
    const int n = a * ATOM + 8 * (v >> 2) + 2 * (lane & 3) + (v & 1);
    st[v] = rev && dh_final != nullptr && n < N ? dh_final[((long long)bh * P + p) * N + n] : 0.f;
  }
  bf16* dst = (rev ? dh1s : h0s) + (long long)bh * nch * 2 * NA * TILE;
  float dnext = dt_of(0);
  for (int k = 0; k < nch; ++k) {
    const int c = chunk(k);
    const float d = dnext;
    if (k + 1 < nch) dnext = dt_of(k + 1);
    // cs = cumsum(dt·A): two warp scans, the second offset by the first's total
    if (tid < Q) {
      float v = d * a_h;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      cs[tid] = v;
    }
    // the state chunk c starts from (forward: chunk 0's is 0 and not kept)
    // or ends with (reverse), split into the out tiles
    const bool keep = rev || c > 0;
    if (keep) split_tile(st, out, out + TILE);
    __syncthreads();
    if (tid >= 32 && tid < Q) cs[tid] += cs[31];
    __syncthreads();
    if (tid < Q) w[tid] = rev ? expf(cs[tid]) : expf(cs[Q - 1] - cs[tid]) * d;
    const float decay = expf(cs[Q - 1]);
    if (keep) {  // out -> dst[c] in 16-byte rows, while the stage lands
      bf16* o = dst + (long long)c * 2 * NA * TILE;
#pragma unroll
      for (int e = tid; e < TILE / 8; e += NT) {
        *reinterpret_cast<uint4*>(o + a * TILE + 8 * e) = *reinterpret_cast<const uint4*>(out + 8 * e);
        *reinterpret_cast<uint4*>(o + (NA + a) * TILE + 8 * e) =
            *reinterpret_cast<const uint4*>(out + TILE + 8 * e);
      }
    }
    __syncthreads();  // w
    hopper::mbar_wait(&bar[k % ST_STAGES], (k / ST_STAGES) & 1);
    const bf16* su = ring + (k % ST_STAGES) * 2 * TILE;
    uint32_t ahi[4][4], alo[4][4];
    frags_t(su, w, ahi, alo);
    float s[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) s[v] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B: the atom MN-major [j rows][n], 8-row groups 1024 B apart
      const uint64_t db = hopper::wgmma_desc(su + TILE + kk * 16 * ATOM, TILE_BYTES, 1024);
      hopper::wgmma_m64n64k16_rs<1>(s, ahi[kk], db, 1);
      hopper::wgmma_m64n64k16_rs<1>(s, alo[kk], db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < 32; ++v) st[v] = fmaf(decay, st[v], s[v]);
    __syncthreads();  // every thread is done with the stage and the out tiles
    if (tid == 0 && k + ST_STAGES < nch) issue(k + ST_STAGES);
  }
}

// This warp's share of the column sums of a [64, 64] accumulator (rows
// 16 w .. 16 w + 15, w the warp in its warpgroup) into red[w * Q + column].
__device__ __forceinline__ void col_partials(const float (&v)[32], float* red) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
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
    const int r0 = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    out[r0] = s0;
    out[r0 + 8] = s1;
  }
}

// chunk_grad's shared memory after the NA-dependent tiles: per-head vectors
// and sums, then the mbarriers.
struct GradVectors {
  float cs[Q], dts[Q], ecs[Q], wexp[Q];  // cs, dt, exp(cs), exp(T - cs)
  float rowm[Q];                         // the row sums of M
  float colm[4 * Q];                     // [4 warps][Q]: the column sums of M, by warp
  float inter[Q];                        // Σ_p dy_ip (C h0^T)_ip
  float xhb[Q], xdu[Q];                  // Σ_p x_jp (B dh1^T)_jp, Σ_p x_jp du_jp
  float scr[4];                          // Σ dh1∘h0 per warp of warpgroup 1
  uint64_t bar[5];                       // B and C; x and dy stages 0, 1; h0; dh1
};

// chunk_grad's per-head vectors, by warp 0 alone (lane: positions lane and
// lane + 32, their dt d0 and d1, 0 past S; the head's A): cs = cumsum(dt·A)
// by shuffles, dt, exp(cs) and exp(T - cs).  A barrier follows before any
// other warp reads them.
__device__ __forceinline__ void head_vectors(GradVectors& v, float d0, float d1, float a) {
  const int lane = threadIdx.x & 31;
  float c0 = d0 * a, c1 = d1 * a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u0 = __shfl_up_sync(0xffffffffu, c0, o), u1 = __shfl_up_sync(0xffffffffu, c1, o);
    if (lane >= o) {
      c0 += u0;
      c1 += u1;
    }
  }
  c1 += __shfl_sync(0xffffffffu, c0, 31);
  const float T = __shfl_sync(0xffffffffu, c1, 31);
  v.cs[lane] = c0;
  v.cs[lane + 32] = c1;
  v.dts[lane] = d0;
  v.dts[lane + 32] = d1;
  v.ecs[lane] = expf(c0);
  v.ecs[lane + 32] = expf(c1);
  v.wexp[lane] = expf(T - c0);
  v.wexp[lane + 32] = expf(T - c1);
}

// (f) of one head, by warp 0 (positions lane and lane + 32), every thread of
// the CTA calling: dcs, d T, da (a suffix sum by shuffles), ddt = x·du + A
// da at row0 + j H, and the chunk's share of dA into *part_a; `inter` says
// whether the inter-chunk sums count (chunk 0 starts from 0 and computes
// none).  Then, if `next`, warp 0 puts the next head's vectors in (its dt
// nd0, nd1 and A na) before the barrier that ends the head.
__device__ __forceinline__ void grad_tail(GradVectors& v, bool inter, float a_h,
                                          float* __restrict__ ddt, long long row0, int H,
                                          int rows, float* __restrict__ part_a, bool next,
                                          float nd0, float nd1, float na) {
  const int tid = threadIdx.x, lane = tid & 31;
  __syncthreads();  // both warpgroups' sums are in
  if (tid < 32) {
    float dc[2], W[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      const float colm = v.colm[j] + v.colm[Q + j] + v.colm[2 * Q + j] + v.colm[3 * Q + j];
      W[h] = v.dts[j] * v.wexp[j] * v.xhb[j];
      dc[h] = v.rowm[j] - colm + (inter ? v.ecs[j] * v.inter[j] : 0.f) - W[h];
    }
    float s = W[0] + W[1];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 31)  // d T onto the last position
      dc[1] += s + expf(v.cs[Q - 1]) * (v.scr[0] + v.scr[1] + v.scr[2] + v.scr[3]);
    // da_j = Σ_{i >= j} dcs_i: suffix sums of each half, the upper half's total
    // added to the lower
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u1 = __shfl_down_sync(0xffffffffu, dc[1], o);
      const float u0 = __shfl_down_sync(0xffffffffu, dc[0], o);
      if (lane + o < 32) {
        dc[1] += u1;
        dc[0] += u0;
      }
    }
    dc[0] += __shfl_sync(0xffffffffu, dc[1], 0);
    float sa = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
      if (j < rows) ddt[row0 + (long long)j * H] = fmaf(a_h, dc[h], v.xdu[j]);
      sa = fmaf(v.dts[j], dc[h], sa);  // dt = 0 past S
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sa += __shfl_xor_sync(0xffffffffu, sa, o);
    if (lane == 0) *part_a = sa;
    if (next) head_vectors(v, nd0, nd1, na);  // each lane rewrites only what it read
  }
  __syncthreads();
}

// Phase 2, grid (rank, chunk, batch·G) in clusters of gridDim.x ranks
// (grad_ranks), two warpgroups a CTA: every gradient of one chunk of group
// g's heads k0 .. k0 + nh - 1 (ref.bwd_head_ranks: each rank a contiguous
// run of the group's heads), head by head; every product a 64-row wgmma
// m64n64k16, each f32 operand as bf16 hi and lo.
//   Once: the group's B and C tiles; CB = C B^T (warpgroup 0's registers).
//   Per head: x and dy by TMA (a ring of two, filled a head ahead), h0 and
//   dh1 as phase 1 wrote them (a bulk copy each, refilled as soon as the
//   head is done with them), then
//     warpgroup 0: (a) G = dy x^T [i, j] -> K = CB∘L (hi, lo tiles), dCB =
//       L∘G∘dt_j (summed over the heads in registers), M = CB∘dCB: its row
//       and column sums; (b) dC += exp(cs_i) (dy h0) [i, n] (the head's
//       product, its rows scaled into the sum in registers); (c) C h0^T [i, p]
//       -> Σ_p dy_ip (C h0^T)_ip, the inter-chunk dcs;
//     warpgroup 1: Σ dh1∘h0 (d T's state term, from the halves); (d) dB +=
//       dt_j exp(T - cs_j) (x dh1) [j, n], as (b); (e) B dh1^T [j, p], then
//       (once K is in) du = K^T dy + exp(T - cs_j) B dh1^T [j, p] -> W_j, x·du
//       (row sums), dx = dt du (through shared memory to 16-byte rows);
//     both: (f) grad_tail.
//   After the last head: dC += (Σ dCB) B, dB += (Σ dCB)^T C; each rank's dC
//   and dB into its own shared memory; then every rank sums a share of the
//   elements over the cluster's ranks in rank order (distributed shared
//   memory) into bf16 dC and dB.  Sums are taken in a fixed order and no
//   float atomics: two launches give the same bits.
template <int NA>
__global__ void __launch_bounds__(GRAD_NT, 1) ssd_chunk_grad_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dymap,
    const __grid_constant__ CUtensorMap bmap, const __grid_constant__ CUtensorMap cmap,
    const float* __restrict__ dt, const float* __restrict__ A, const bf16* __restrict__ h0s,
    const bf16* __restrict__ dh1s, bf16* __restrict__ dx, float* __restrict__ ddt,
    bf16* __restrict__ dB, bf16* __restrict__ dC, float* __restrict__ part_a, const Layout L,
    int S, int H, int G, int N, int nch) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023;
  bf16* sb = reinterpret_cast<bf16*>(smem_raw + pad);  // NA atoms [Q][64] of B
  bf16* sc = sb + NA * TILE;                           // NA atoms of C
  bf16* sxy = sc + NA * TILE;                          // [2 stages][x, dy] [Q][P]
  bf16* sh0 = sxy + 4 * TILE;       // h0: NA hi atoms, NA lo atoms [P][64]; at the end dC
  bf16* sdh = sh0 + 2 * NA * TILE;  // dh1, the same; at the end dB
  bf16* skhi = sdh + 2 * NA * TILE;  // K [i][j] hi; then dx [j][p]; at the end Σ dCB hi
  bf16* sklo = skhi + TILE;          // K lo; at the end Σ dCB lo
  GradVectors& V = *reinterpret_cast<GradVectors*>(sklo + TILE);
  uint64_t* bar_bc = &V.bar[0];
  uint64_t* bar_xy = &V.bar[1];
  uint64_t* bar_h0 = &V.bar[3];
  uint64_t* bar_dh = &V.bar[4];

  const int ranks = gridDim.x, rank = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / G, g = blockIdx.z % G, R = H / G;
  const int k0 = rank * R / ranks, nh = (rank + 1) * R / ranks - k0;
  const int t0 = c * Q, tid = threadIdx.x, wg = tid >> 7, wt = tid & (NT - 1);
  const int warp = wt >> 5, lane = tid & 31, r0 = warp * 16 + (lane >> 2);
  const int rows = min(Q, S - t0);
  auto head = [&](int k) { return g * R + k0 + k; };
  auto state = [&](const bf16* base, int k) {  // (b·H + head, c)'s tiles
    return base + ((long long)(b * H + head(k)) * nch + c) * 2 * NA * TILE;
  };
  auto issue_xy = [&](int k) {
    bf16* st = sxy + (k & 1) * 2 * TILE;
    hopper::mbar_expect_tx(&bar_xy[k & 1], 2 * TILE_BYTES);
    hopper::tma_load_4d(st, &xmap, &bar_xy[k & 1], 0, head(k), t0, b);
    hopper::tma_load_4d(st + TILE, &dymap, &bar_xy[k & 1], 0, head(k), t0, b);
  };
  auto issue_state = [&](bf16* to, const bf16* base, uint64_t* br, int k) {
    hopper::mbar_expect_tx(br, 2 * NA * TILE_BYTES);
    hopper::bulk_load(to, state(base, k), 2 * NA * TILE_BYTES, br);
  };
  // warp 0: the k-th head's dt at position lane + 32 h (0 past S) and its A
  auto dt_of = [&](int k, int h) {
    const int t = t0 + lane + 32 * h;
    return tid < 32 && k < nh && t < S ? dt[b * L.dt_b + t * L.dt_s + head(k) * L.dt_h] : 0.f;
  };
  auto a_of = [&](int k) { return k < nh ? A[b * L.a_b + head(k) * L.a_h] : 0.f; };

  hopper::griddep_launch_dependents();
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) hopper::mbar_init(&V.bar[i], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(bar_bc, 2 * NA * TILE_BYTES);
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      hopper::tma_load_4d(sb + a * TILE, &bmap, bar_bc, a * ATOM, g, t0, b);
      hopper::tma_load_4d(sc + a * TILE, &cmap, bar_bc, a * ATOM, g, t0, b);
    }
    issue_xy(0);
    if (nh > 1) issue_xy(1);
    hopper::griddep_wait();  // phase 1's states
    if (c > 0) issue_state(sh0, h0s, bar_h0, 0);
    issue_state(sdh, dh1s, bar_dh, 0);
  }
  if (tid < 32) head_vectors(V, dt_of(0, 0), dt_of(0, 1), a_of(0));  // the first head's
  __syncthreads();
  hopper::mbar_wait(bar_bc, 0);

  if (wg == 0) {
    float cb[32], dcb[32], acc[NA][32];  // C B^T; Σ dCB; dC over the heads
#pragma unroll
    for (int v = 0; v < 32; ++v) dcb[v] = 0.f;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int v = 0; v < 32; ++v) acc[a][v] = 0.f;
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
    for (int k = 0; k < nh; ++k) {
      const float a_h = a_of(k), nd0 = dt_of(k + 1, 0), nd1 = dt_of(k + 1, 1), na = a_of(k + 1);
      if (tid == 0 && k >= 1 && k + 1 < nh) issue_xy(k + 1);  // into head k - 1's stage
      hopper::mbar_wait(&bar_xy[k & 1], (k >> 1) & 1);
      const bf16* sx = sxy + (k & 1) * 2 * TILE;
      const bf16* sdy = sx + TILE;
      // (a) value v of a [64, 64] accumulator is row r0 + 8 ((v / 2) % 2),
      // column 8 (v / 4) + 2 (lane % 4) + v % 2
      {
        float gx[32];
        hopper::wgmma_fence();
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
          const float csi = V.cs[i];
          const float l0 = j <= i ? __expf(csi - V.cs[j]) : 0.f;
          const float l1 = j + 1 <= i ? __expf(csi - V.cs[j + 1]) : 0.f;
          const float d0 = l0 * gx[v] * V.dts[j], d1 = l1 * gx[v + 1] * V.dts[j + 1];
          dcb[v] += d0;
          dcb[v + 1] += d1;
          gx[v] = cb[v] * d0;  // M
          gx[v + 1] = cb[v + 1] * d1;
          uint32_t hi, lo;
          split2(cb[v] * l0, cb[v + 1] * l1, hi, lo);
          *reinterpret_cast<uint32_t*>(skhi + swz(i, j)) = hi;
          *reinterpret_cast<uint32_t*>(sklo + swz(i, j)) = lo;
        }
        row_sums(gx, V.rowm);
        col_partials(gx, V.colm);
      }
      hopper::fence_proxy_async();
      hopper::named_arrive(BAR_K, GRAD_NT);
      if (c > 0) {
        hopper::mbar_wait(bar_h0, k & 1);
        // (b) dC += exp(cs_i) (dy h0) [i, n]: A = dy (K-major), B = h0 (MN-major,
        // hi and lo); the head's product, then its rows scaled into the sum
        {
          float hd[NA][32];
          hopper::wgmma_fence();
#pragma unroll
          for (int a = 0; a < NA; ++a) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = hopper::wgmma_desc(sdy + kk * 16, 16, 1024);
              const int o = a * TILE + kk * 16 * ATOM;
              hopper::wgmma_m64n64k16_ss<0, 1>(hd[a], da, hopper::wgmma_desc(sh0 + o, TILE_BYTES, 1024),
                                               kk > 0);
              hopper::wgmma_m64n64k16_ss<0, 1>(
                  hd[a], da, hopper::wgmma_desc(sh0 + NA * TILE + o, TILE_BYTES, 1024), 1);
            }
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          const float e0 = V.ecs[r0], e1 = V.ecs[r0 + 8];
#pragma unroll
          for (int a = 0; a < NA; ++a)
#pragma unroll
            for (int v = 0; v < 32; ++v) acc[a][v] = fmaf((v >> 1) & 1 ? e1 : e0, hd[a][v], acc[a][v]);
        }
        // (c) C h0^T [i, p]: A = the C tile (K-major), B = h0 (K-major, hi and
        // lo); Σ_p dy_ip (C h0^T)_ip, a row sum
        {
          float hc[32];
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NA; ++kk) {
            const int o = (kk >> 2) * TILE + (kk & 3) * 16;
            const uint64_t da = hopper::wgmma_desc(sc + o, 16, 1024);
            hopper::wgmma_m64n64k16_ss<0, 0>(hc, da, hopper::wgmma_desc(sh0 + o, 16, 1024), kk > 0);
            hopper::wgmma_m64n64k16_ss<0, 0>(hc, da,
                                             hopper::wgmma_desc(sh0 + NA * TILE + o, 16, 1024), 1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int v = 0; v < 32; v += 2) {
            const int i = r0 + 8 * ((v >> 1) & 1), p = 8 * (v >> 2) + 2 * (lane & 3);
            const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(sdy + swz(i, p));
            hc[v] *= __low2float(d2);
            hc[v + 1] *= __high2float(d2);
          }
          row_sums(hc, V.inter);
        }
      }
      // both warpgroups are done with h0: the next head's comes in
      hopper::named_sync(BAR_HDOT, GRAD_NT);
      if (tid == 0 && c > 0 && k + 1 < nh) issue_state(sh0, h0s, bar_h0, k + 1);
      grad_tail(V, c > 0, a_h, ddt, ((long long)b * S + t0) * H + head(k), H, rows,
                part_a + (long long)(b * H + head(k)) * nch + c, k + 1 < nh, nd0, nd1, na);
    }
    // Σ dCB into the K tiles (their last reader, the last head's du, is done)
    split_tile(dcb, skhi, sklo);
    hopper::fence_proxy_async();
    __syncthreads();
    // dC += Σ dCB B: A = Σ dCB (K-major), B = the B tile (MN-major)
    hopper::wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = hopper::wgmma_desc(sb + a * TILE + kk * 16 * ATOM, TILE_BYTES, 1024);
        hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], hopper::wgmma_desc(skhi + kk * 16, 16, 1024), db,
                                         1);
        hopper::wgmma_m64n64k16_ss<0, 1>(acc[a], hopper::wgmma_desc(sklo + kk * 16, 16, 1024), db,
                                         1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    float4* mine = reinterpret_cast<float4*>(sh0);  // dC, in the accumulator's order
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        mine[(8 * a + q) * NT + wt] =
            make_float4(acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2], acc[a][4 * q + 3]);
  } else {
    float acc[NA][32];  // dB over the heads
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int v = 0; v < 32; ++v) acc[a][v] = 0.f;
    for (int k = 0; k < nh; ++k) {
      hopper::mbar_wait(&bar_xy[k & 1], (k >> 1) & 1);
      const bf16* sx = sxy + (k & 1) * 2 * TILE;
      const bf16* sdy = sx + TILE;
      hopper::mbar_wait(bar_dh, k & 1);
      // Σ dh1∘h0 over this thread's 16-byte chunks (the four tiles share a layout)
      float hd = 0.f;
      if (c > 0) {
        hopper::mbar_wait(bar_h0, k & 1);
        for (int e = wt; e < NA * TILE / 8; e += NT) {
          const uint4 u[4] = {*reinterpret_cast<const uint4*>(sh0 + 8 * e),
                              *reinterpret_cast<const uint4*>(sh0 + NA * TILE + 8 * e),
                              *reinterpret_cast<const uint4*>(sdh + 8 * e),
                              *reinterpret_cast<const uint4*>(sdh + NA * TILE + 8 * e)};
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(u);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float2 h0h = __bfloat1622float2(p[m]), h0l = __bfloat1622float2(p[4 + m]);
            const float2 dhh = __bfloat1622float2(p[8 + m]), dhl = __bfloat1622float2(p[12 + m]);
            hd = fmaf(h0h.x + h0l.x, dhh.x + dhl.x, hd);
            hd = fmaf(h0h.y + h0l.y, dhh.y + dhl.y, hd);
          }
        }
      }
      hopper::named_arrive(BAR_HDOT, GRAD_NT);
      // (d) dB += dt_j exp(T - cs_j) (x dh1) [j, n]: A = x (K-major), B = dh1
      // (MN-major, hi and lo); the head's product, then its rows scaled into the sum
      {
        float hx[NA][32];
        hopper::wgmma_fence();
#pragma unroll
        for (int a = 0; a < NA; ++a) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t da = hopper::wgmma_desc(sx + kk * 16, 16, 1024);
            const int o = a * TILE + kk * 16 * ATOM;
            hopper::wgmma_m64n64k16_ss<0, 1>(hx[a], da, hopper::wgmma_desc(sdh + o, TILE_BYTES, 1024),
                                             kk > 0);
            hopper::wgmma_m64n64k16_ss<0, 1>(
                hx[a], da, hopper::wgmma_desc(sdh + NA * TILE + o, TILE_BYTES, 1024), 1);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        const float w0 = V.dts[r0] * V.wexp[r0], w1 = V.dts[r0 + 8] * V.wexp[r0 + 8];
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int v = 0; v < 32; ++v) acc[a][v] = fmaf((v >> 1) & 1 ? w1 : w0, hx[a][v], acc[a][v]);
      }
      // (e) B dh1^T [j, p]: A = the B tile (K-major), B = dh1 (K-major, hi and lo)
      float hb[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NA; ++kk) {
        const int o = (kk >> 2) * TILE + (kk & 3) * 16;
        const uint64_t da = hopper::wgmma_desc(sb + o, 16, 1024);
        hopper::wgmma_m64n64k16_ss<0, 0>(hb, da, hopper::wgmma_desc(sdh + o, 16, 1024), kk > 0);
        hopper::wgmma_m64n64k16_ss<0, 0>(hb, da, hopper::wgmma_desc(sdh + NA * TILE + o, 16, 1024),
                                         1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::named_sync(BAR_WG1, NT);  // every warp of this warpgroup is done with dh1
      if (wt == 0 && k + 1 < nh) issue_state(sdh, dh1s, bar_dh, k + 1);
      // du = K^T dy + exp(T - cs_j) B dh1^T [j, p]: A = K^T (the K tiles
      // MN-major), B = dy (MN-major); then W_j's and x·du's row sums, dx = dt du
      hopper::named_sync(BAR_K, GRAD_NT);
      {
        float du[32], t[32], xd[32];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = hopper::wgmma_desc(sdy + kk * 16 * ATOM, TILE_BYTES, 1024);
          hopper::wgmma_m64n64k16_ss<1, 1>(
              du, hopper::wgmma_desc(skhi + kk * 16 * ATOM, TILE_BYTES, 1024), db, kk > 0);
          hopper::wgmma_m64n64k16_ss<1, 1>(
              du, hopper::wgmma_desc(sklo + kk * 16 * ATOM, TILE_BYTES, 1024), db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        const float w0 = V.wexp[r0], w1 = V.wexp[r0 + 8];
#pragma unroll
        for (int v = 0; v < 32; v += 2) {
          const int j = r0 + 8 * ((v >> 1) & 1), p = 8 * (v >> 2) + 2 * (lane & 3);
          const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(sx + swz(j, p));
          const float xa = __low2float(x2), xb = __high2float(x2), w = (v >> 1) & 1 ? w1 : w0;
          t[v] = hb[v] * xa;
          t[v + 1] = hb[v + 1] * xb;
          du[v] = fmaf(w, hb[v], du[v]);
          du[v + 1] = fmaf(w, hb[v + 1], du[v + 1]);
          xd[v] = du[v] * xa;
          xd[v + 1] = du[v + 1] * xb;
        }
        row_sums(t, V.xhb);   // Σ_p x_jp (B dh1^T)_jp
        row_sums(xd, V.xdu);  // Σ_p x_jp du_jp
        hopper::named_sync(BAR_WG1, NT);  // every warp's reads of K are done: dx takes its place
        const float d0 = V.dts[r0], d1 = V.dts[r0 + 8];
#pragma unroll
        for (int v = 0; v < 32; v += 2) {
          const int j = r0 + 8 * ((v >> 1) & 1), p = 8 * (v >> 2) + 2 * (lane & 3);
          const float d = (v >> 1) & 1 ? d1 : d0;
          *reinterpret_cast<uint32_t*>(skhi + swz(j, p)) = hopper::pack_bf16(d * du[v], d * du[v + 1]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) hd += __shfl_xor_sync(0xffffffffu, hd, o);
      if (lane == 0) V.scr[warp] = hd;
      hopper::named_sync(BAR_WG1, NT);
      const long long row0 = ((long long)b * S + t0) * H + head(k);  // (t0, head)'s row of [batch·S·H, *]
#pragma unroll
      for (int e = wt; e < Q * P / 8; e += NT) {
        const int i = e >> 3, ch = e & 7;
        if (i < rows)
          *reinterpret_cast<uint4*>(dx + (row0 + (long long)i * H) * P + ch * 8) =
              *reinterpret_cast<const uint4*>(skhi + swz(i, ch * 8));
      }
      grad_tail(V, c > 0, 0.f, ddt, row0, H, rows,
                part_a + (long long)(b * H + head(k)) * nch + c, false, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // warpgroup 0 has put Σ dCB in the K tiles
    // dB += Σ dCB^T C: A = the Σ dCB tiles MN-major, B = the C tile (MN-major)
    hopper::wgmma_fence();
#pragma unroll
    for (int a = 0; a < NA; ++a) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = hopper::wgmma_desc(sc + a * TILE + kk * 16 * ATOM, TILE_BYTES, 1024);
        hopper::wgmma_m64n64k16_ss<1, 1>(
            acc[a], hopper::wgmma_desc(skhi + kk * 16 * ATOM, TILE_BYTES, 1024), db, 1);
        hopper::wgmma_m64n64k16_ss<1, 1>(
            acc[a], hopper::wgmma_desc(sklo + kk * 16 * ATOM, TILE_BYTES, 1024), db, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    float4* mine = reinterpret_cast<float4*>(sdh);  // dB, in the accumulator's order
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        mine[(8 * a + q) * NT + wt] =
            make_float4(acc[a][4 * q], acc[a][4 * q + 1], acc[a][4 * q + 2], acc[a][4 * q + 3]);
  }

  // dC (sh0) and dB (sdh) over the cluster's ranks, in rank order: float4 f
  // of a sum holds a thread's values 4 q .. 4 q + 3 (q = f / NT, t = f % NT),
  // rows i and i + 8, columns n and n + 1; the ranks share the float4s out
  hopper::cluster_sync();
  constexpr int PER = 8 * NA * NT;  // float4s of one sum
  for (int e = rank * GRAD_NT + tid; e < 2 * PER; e += ranks * GRAD_NT) {
    const bool isb = e >= PER;
    const int f = isb ? e - PER : e;
    const float4* src = reinterpret_cast<const float4*>(isb ? sdh : sh0) + f;
    float4 s = *hopper::cluster_map(src, 0);
    for (int r = 1; r < ranks; ++r) {
      const float4 u = *hopper::cluster_map(src, r);
      s.x += u.x;
      s.y += u.y;
      s.z += u.z;
      s.w += u.w;
    }
    const int t = f % NT, q = f / NT;
    const int i = 16 * (t >> 5) + ((t & 31) >> 2), n = 8 * q + 2 * (t & 3);
    if (n < N) {
      bf16* o = (isb ? dB : dC) + (((long long)b * S + t0) * G + g) * N + n;
      if (i < rows) *reinterpret_cast<uint32_t*>(o + (long long)i * G * N) = hopper::pack_bf16(s.x, s.y);
      if (i + 8 < rows)
        *reinterpret_cast<uint32_t*>(o + (long long)(i + 8) * G * N) = hopper::pack_bf16(s.z, s.w);
    }
  }
  hopper::cluster_sync();  // no rank leaves while another still reads its shared memory
}

// Phase 3: dA [batch·H], each the sum of part_a's chunks in order.
__global__ void __launch_bounds__(PASS_NT) ssd_dA_reduce_kernel(const float* __restrict__ part_a,
                                                                float* __restrict__ dA, int BH,
                                                                int nch) {
  hopper::griddep_wait();  // phase 2's shares
  const int i = blockIdx.x * PASS_NT + threadIdx.x;
  if (i >= BH) return;
  const float* p = part_a + (long long)i * nch;
  float s = p[0];
  for (int c = 1; c < nch; ++c) s += p[c];
  dA[i] = s;
}

template <int NA>
constexpr size_t grad_smem() {
  return (size_t)(6 * NA + 6) * TILE_BYTES + sizeof(GradVectors) + 1024;
}

// chunk_grad's cluster size for R heads a group and `units` (chunk, batch,
// group) clusters: of 8 .. 1 ranks (at most R), the one whose waves of
// clusters (cudaOccupancyMaxActiveClusters on this card, queried once) times
// the heads its CTAs walk are fewest; ties go to more ranks.  One CTA an SM,
// so clusters of 8 fill 120 of the H100's 132 SMs and smaller ones more.
template <int NA>
int grad_ranks(int R, long long units) {
  static int active[MAX_RANKS] = {};  // clusters of 8, 7, .., 1 ranks the card holds at once
  int best = 1;
  long long best_cost = -1;
  for (int i = 0; i < MAX_RANKS; ++i) {
    const int ranks = MAX_RANKS - i;
    if (ranks > R) continue;
    if (active[i] == 0) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = ranks;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(ranks);
      cfg.blockDim = dim3(GRAD_NT);
      cfg.dynamicSmemBytes = grad_smem<NA>();
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, ssd_chunk_grad_kernel<NA>, &cfg) != cudaSuccess) {
        (void)cudaGetLastError();
        n = 0;
      }
      active[i] = n > 0 ? n : 1;
    }
    const long long cost = (units + active[i] - 1) / active[i] * ((R + ranks - 1) / ranks);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = ranks;
    }
  }
  return best;
}
constexpr size_t bwd_states_smem() {
  return (size_t)(2 * ST_STAGES + 2) * TILE_BYTES + 2 * Q * sizeof(float) + ST_STAGES * 8 + 1024;
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
  err = cudaLaunchKernelEx(&cfg, ssd_state_pass_kernel<false>, st, static_cast<const float*>(dec),
                           static_cast<float*>(h_out), PN4, N, nch, P);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = scan_smem<NA>();
  err = cudaLaunchKernelEx(&cfg, ssd_chunk_scan_kernel<NA>, xm, bm, cm, dtf, Af,
                           static_cast<const float*>(st), static_cast<bf16*>(y), L, S, H, G, nch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The backward's three kernels (see wgmma_bwd above).  Phases 2 and 3
// start by programmatic dependent launch while the phase before drains;
// phase 2 runs in clusters of grad_ranks CTAs.
template <int NA>
int launch_bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
               const void* dy, const void* dh_final, void* dx, void* ddt, void* dA, void* dB,
               void* dC, void* h0s, void* dh1s, void* part_a, int batch, int S, int H, int G,
               int N, const Layout& L, const long long (&dys)[3], cudaStream_t stream) {
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
    err = cudaFuncSetAttribute(ssd_bwd_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bwd_states_smem());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_chunk_grad_kernel<NA>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)grad_smem<NA>());
    if (err != cudaSuccess) return (int)err;
    attributes_set = true;
  }
  const int nch = (S + Q - 1) / Q;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  // 1: h0 and dh1, both directions in one grid
  ssd_bwd_states_kernel<<<dim3(NA, batch * H, 2), NT, bwd_states_smem(), stream>>>(
      xm, bm, dym, cm, dtf, Af, static_cast<const float*>(dh_final), static_cast<bf16*>(h0s),
      static_cast<bf16*>(dh1s), L, S, H, G, N, NA, nch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // 2: the chunks' gradients, a cluster of ranks per (chunk, batch, group)
  const int ranks = grad_ranks<NA>(H / G, (long long)nch * batch * G);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.gridDim = dim3(ranks, nch, batch * G);
  cfg.blockDim = dim3(GRAD_NT);
  cfg.dynamicSmemBytes = grad_smem<NA>();
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, ssd_chunk_grad_kernel<NA>, xm, dym, bm, cm, dtf, Af,
                           static_cast<const bf16*>(h0s), static_cast<const bf16*>(dh1s),
                           static_cast<bf16*>(dx), static_cast<float*>(ddt),
                           static_cast<bf16*>(dB), static_cast<bf16*>(dC),
                           static_cast<float*>(part_a), L, S, H, G, N, nch);
  if (err != cudaSuccess) return (int)err;
  // 3: dA over chunks
  cfg.gridDim = dim3((batch * H + PASS_NT - 1) / PASS_NT);
  cfg.blockDim = dim3(PASS_NT);
  cfg.dynamicSmemBytes = 0;
  cfg.attrs = attr + 1;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ssd_dA_reduce_kernel, static_cast<const float*>(part_a),
                           static_cast<float*>(dA), batch * H, nch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
}  // namespace tc

// ------------------------------------------------------------------------- //
// cuda_core variant: three chunk-parallel phases on the CUDA cores (f32 FFMA)
// ------------------------------------------------------------------------- //
namespace simt {
constexpr int Q = 64;        // chunk length: two warp-wide scans
constexpr int PT = 64;       // columns of P a CTA takes (the grid's z axis walks P)
constexpr int NT = 128;      // threads of a phase 1 CTA: four warps
constexpr int NT3 = 256;     // threads of a phase 3 CTA: eight warps
constexpr int STAGES1 = 4;   // phase 1's cp.async groups of Q / STAGES1 rows of x and B

// A tile class: NP, the state width its tiles hold (zero past N).  Phase 1
// (chunk_state): thread (tp, tn) = (tid % NTP, tid / NTP) holds s^T[n][p]
// for p in the TPB float4 groups 4 tp + PH g and n in the TNB groups 4 tn +
// NH g, so that each fragment read is one 16-byte float4 (TPB + TNB of them
// feed 16 TPB TNB FFMA) and a warp's stores of a row n cover 8 consecutive
// float4.  Phase 3 (chunk_scan) is the same for every class but for its K
// loops over n.  CTAS1, CTAS3: the CTAs an SM the phases are built for
// (__launch_bounds__; shared memory allows them).
template <int NP_, int CTAS1_, int CTAS3_>
struct Cls {
  static constexpr int NP = NP_, CTAS1 = CTAS1_, CTAS3 = CTAS3_;
  static constexpr int TPB = NP >= 64 ? 2 : 1, TNB = NP == 128 ? 2 : 1;
  static constexpr int NTP = PT / (4 * TPB), NTN = NP / (4 * TNB);
  static constexpr int PH = PT / TPB, NH = NP / TNB;
  static_assert(NTP * NTN == NT, "phase 1 covers [PT, NP] with NT threads");
  static constexpr int LD = NP + 4;  // a row of C and of B in phase 3 (rows on distinct banks)
  static constexpr int SL = Q + 4;   // a row of S^T
  // phase 3's second region: B [Q][LD], then S^T [Q][SL], then h^T [NP][PT]
  static constexpr int R2 = Q * LD > Q * SL ? (Q * LD > NP * PT ? Q * LD : NP * PT)
                                            : (Q * SL > NP * PT ? Q * SL : NP * PT);
  // dynamic shared memory in bytes: phase 1 x [Q][PT], B [Q][NP], cs and dt;
  // phase 3 C [Q][LD], the second region, x [Q][PT], cs and dt
  static constexpr int STATE_BYTES = 4 * (Q * PT + Q * NP + 2 * Q);
  static constexpr int SCAN_BYTES = 4 * (Q * LD + R2 + Q * PT + 2 * Q);
  static_assert(CTAS3 * SCAN_BYTES <= 232448 && CTAS1 * STATE_BYTES <= 232448, "shared memory");
};
using N32 = Cls<32, 4, 3>;
using N128 = Cls<128, 4, 2>;

__device__ __forceinline__ void put4(float* f, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Rows r0 .. r0 + R - 1 of a chunk's tile [Q][W] in shared memory (a row LDW
// floats apart) from rows row0 + r of a row-major global array (ld elements
// a row), by the TH threads of the CTA: columns col0 .. col0 + W - 1, zero
// at rows r >= nrows and columns >= ncol.  The fast path copies 16 bytes at
// a time by cp.async (f32; ld, col0 and ncol multiples of 4, the array on 16
// bytes); the general path loads elements, converts them to f32 and stores
// them.  Copy e = tid + TH k
// of a thread is row r0 + e / (W / 4), float4 e % (W / 4) (fast) or row r0 +
// e / W, column e % W (general): scale_rows walks the same copies.
template <bool FAST, int R, int W, int LDW, int TH = NT, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long row0,
                                          int nrows, int r0, long long ld, int col0, int ncol) {
  const int tid = threadIdx.x;
  if constexpr (FAST) {
    constexpr int C4 = W / 4, COPIES = R * C4 / TH;
    static_assert(COPIES * TH == R * C4, "copies");
#pragma unroll
    for (int k = 0; k < COPIES; ++k) {
      const int e = tid + TH * k, r = r0 + e / C4, c = 4 * (e % C4);
      const bool ok = r < nrows && col0 + c < ncol;
      hopper::cp_async16(dst + r * LDW + c, ok ? src + (row0 + r) * ld + col0 + c : src, ok);
    }
  } else {
    // batches of up to 8 loads in flight before their stores
    constexpr int COPIES = R * W / TH, BATCH = COPIES < 8 ? COPIES : 8;
    static_assert(COPIES * TH == R * W && COPIES % BATCH == 0, "copies");
#pragma unroll 1
    for (int k0 = 0; k0 < COPIES; k0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = tid + TH * (k0 + k), r = r0 + e / W, c = e % W;
        v[k] = r < nrows && col0 + c < ncol ? to_f32(src[(row0 + r) * ld + col0 + c]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int e = tid + TH * (k0 + k);
        dst[(r0 + e / W) * LDW + e % W] = v[k];
      }
    }
  }
}

// cp.async.wait_group for a count the unrolled loops below know at compile
// time only after unrolling (0 to 3)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: hopper::cp_async_wait<0>(); break;
    case 1: hopper::cp_async_wait<1>(); break;
    case 2: hopper::cp_async_wait<2>(); break;
    default: hopper::cp_async_wait<3>(); break;
  }
}

// Each row j of this thread's copies of rows r0 .. r0 + R - 1 (load_rows'
// mapping) times w_j = exp(cs_Q - cs_j) dt_j, in place: the thread's own
// copies have landed once it has waited for them, so no barrier is needed
// before it.
template <bool FAST, int R, int W>
__device__ __forceinline__ void scale_rows(float* tile, const float* cs, const float* dts,
                                           int r0) {
  const int tid = threadIdx.x;
  const float total = cs[Q - 1];
  if constexpr (FAST) {
    constexpr int C4 = W / 4;
#pragma unroll
    for (int k = 0; k < R * C4 / NT; ++k) {
      const int e = tid + NT * k, r = r0 + e / C4;
      float4* v = reinterpret_cast<float4*>(tile + r * W + 4 * (e % C4));
      const float w = expf(total - cs[r]) * dts[r];
      float4 t = *v;
      t.x *= w;
      t.y *= w;
      t.z *= w;
      t.w *= w;
      *v = t;
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < R * W / NT; ++k) {
      const int e = tid + NT * k, r = r0 + e / W;
      tile[r * W + e % W] *= expf(total - cs[r]) * dts[r];
    }
  }
}

// cs = cumsum(dt·A) over the chunk (dt = 0 past S) and dt, into shared
// memory, by threads 0 .. Q - 1: a warp-wide scan of each half, the second
// offset by the first half's total, which warp 1 scans again for itself (the
// same sum, bit for bit), so that one barrier after this suffices.  Both
// phases call it: their cs agree bit for bit.
__device__ __forceinline__ void chunk_cs(float* cs, float* dts, const float* __restrict__ dt,
                                         long long row, int t0, int S, float a) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid >= Q) return;
  auto scan = [&](float v) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    return v;
  };
  const float d = t0 + tid < S ? dt[row + t0 + tid] : 0.f;
  float v = scan(d * a);
  if (tid >= 32) {
    const float first = scan((t0 + lane < S ? dt[row + t0 + lane] : 0.f) * a);
    v += __shfl_sync(0xffffffffu, first, 31);
  }
  cs[tid] = v;
  dts[tid] = d;
}

// Phase 1, grid (batch·H, chunk, P tile): the chunk's own contribution to
// the state, transposed,
//   s^T = B^T (x ∘ w),  w_j = exp(cs_Q - cs_j) dt_j   ([N][PP], f32),
// into states[bh, c] (columns p0 .. p0 + PT - 1, PP = P padded to a multiple
// of 4, zero in the padding), and its decay exp(cs_Q) into decay[bh, c] (P
// tile 0).  x and B come in STAGES1 groups of the chunk's rows, the later
// ones in flight while the earlier ones' FFMAs run; each row j of x is scaled
// by w_j in shared memory, by the thread that copied it.  The product is a
// rank-Q update: per row j, the thread's x ∘ w and B fragments (float4s of
// row j) and 16 TPB TNB FFMA.
template <class C, bool FAST, typename T>
__global__ void __launch_bounds__(NT, C::CTAS1) ssd_cc_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, float* __restrict__ states, float* __restrict__ decay, int S, int P,
    int N, int PP, int nch) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;              // [Q][PT]: x, then x ∘ w
  float* bs = xs + Q * PT;     // [Q][NP]
  float* cs = bs + Q * C::NP;  // [Q]
  float* dts = cs + Q;         // [Q]
  const long long bh = blockIdx.x;
  const int c = blockIdx.y, p0 = blockIdx.z * PT, t0 = c * Q, tid = threadIdx.x;
  const long long row0 = bh * S + t0;
  hopper::griddep_launch_dependents();
#pragma unroll
  for (int h = 0; h < STAGES1; ++h) {
    load_rows<FAST, Q / STAGES1, PT, PT>(xs, x, row0, S - t0, h * Q / STAGES1, P, p0, P);
    load_rows<FAST, Q / STAGES1, C::NP, C::NP>(bs, B, row0, S - t0, h * Q / STAGES1, N, 0, N);
    hopper::cp_async_commit();
  }
  chunk_cs(cs, dts, dt, bh * S, t0, S, A[bh]);
  __syncthreads();
  if (tid == 0 && blockIdx.z == 0) decay[bh * nch + c] = expf(cs[Q - 1]);

  const int tp = tid % C::NTP, tn = tid / C::NTP;
  float acc[4 * C::TPB][4 * C::TNB];  // [p][n]
#pragma unroll
  for (int i = 0; i < 4 * C::TPB; ++i)
#pragma unroll
    for (int j = 0; j < 4 * C::TNB; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int h = 0; h < STAGES1; ++h) {
    cp_async_wait_upto(STAGES1 - 1 - h);
    scale_rows<FAST, Q / STAGES1, PT>(xs, cs, dts, h * Q / STAGES1);
    __syncthreads();  // the stage has landed and is scaled, for every thread
#pragma unroll 4
    for (int j = h * Q / STAGES1; j < (h + 1) * Q / STAGES1; ++j) {
      float a[4 * C::TPB], b[4 * C::TNB];
#pragma unroll
      for (int g = 0; g < C::TPB; ++g) put4(a + 4 * g, xs + j * PT + 4 * tp + C::PH * g);
#pragma unroll
      for (int g = 0; g < C::TNB; ++g) put4(b + 4 * g, bs + j * C::NP + 4 * tn + C::NH * g);
#pragma unroll
      for (int i = 0; i < 4 * C::TPB; ++i)
#pragma unroll
        for (int k = 0; k < 4 * C::TNB; ++k) acc[i][k] = fmaf(a[i], b[k], acc[i][k]);
    }
  }
  float* out = states + (bh * nch + c) * N * PP;
#pragma unroll
  for (int k = 0; k < 4 * C::TNB; ++k) {
    const int n = 4 * tn + C::NH * (k / 4) + k % 4;
    if (n >= N) continue;
#pragma unroll
    for (int g = 0; g < C::TPB; ++g) {
      const int p = p0 + 4 * tp + C::PH * g;
      if (p < PP)
        *reinterpret_cast<float4*>(out + (long long)n * PP + p) =
            make_float4(acc[4 * g][k], acc[4 * g + 1][k], acc[4 * g + 2][k], acc[4 * g + 3][k]);
    }
  }
}

// C B^T for the 4 rows i = i0 + 4 r (r < 4) and the columns j = j0 + 8 k (k
// < KM) of a thread, over n in [4 lo, 4 hi), both operands as they lie (rows
// of LD floats): per 4 n, 4 C float4s and KM B float4s feed 16 KM FFMA.
template <int LD, int KM>
__device__ __forceinline__ void cb_rows(float (&cb)[4][4], const float* cm, const float* bm,
                                        int i0, int j0, int lo, int hi) {
#pragma unroll 2
  for (int n4 = lo; n4 < hi; ++n4) {
    float4 cv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(cm + (i0 + 4 * r) * LD + 4 * n4);
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(bm + (j0 + 8 * k) * LD + 4 * n4);
#pragma unroll
      for (int r = 0; r < 4; ++r) cb[r][k] = dot4(cv[r], bv, cb[r][k]);
    }
  }
}

// Phase 3, grid (batch·H, chunk, P tile): the chunk's output
//   y = (C B^T ∘ L ∘ dt) x + exp(cs) ∘ (C h^T),   L_ij = exp(cs_i - cs_j), j <= i,
// with h the state the chunk starts from (phase 2's; zero for chunk 0), by
// NT3 threads: eight warps, each on y's rows in one band b, [16 b, 16 b +
// 16), and one half of its columns, [32 hp, 32 hp + 32).  Lane (ri, g) =
// (lane / 8, lane % 8) takes the rows i0 + 4 r (i0 = 16 b + ri, r < 4), so
// that a warp's 4 rows of C an instruction lie on distinct banks, and the
// columns p0 + 32 hp + 4 g + k (k < 4), so that its x and h^T reads are 8
// consecutive float4s.  Before phase 2 is waited for: C B^T of band 3 - b's
// rows (cb_rows, the same lane mapping; only the columns j < 16 (3 - b) + 16
// that band's triangle reads, half of them a warp), the masked scores S = C
// B^T ∘ L ∘ dt stored transposed (S^T [j][16 band + 4 ri + r], so that a
// thread's 4 rows are one float4) in B's place, and S x as a rank-1 update
// per j < 16 b + 16.  Band b's C B^T and S x both grow with b: a warp takes
// the C B^T of the band at the other end from its S x, and the two warps
// that share a scheduler (w, w + 4) take bands b and 3 - b, so that every
// scheduler gets the same work between two barriers.  Then h^T (rows n,
// columns p: phase 1's layout) comes into that place and C h^T runs over n,
// per 4 n 4 C float4s and 4 h^T float4s feeding 64 FFMA into a second
// accumulator, added to y with exp(cs_i).  One FFMA chain an output, in a
// fixed order: two launches give the same bits.
template <class C, bool FAST, typename T>
__global__ void __launch_bounds__(NT3, C::CTAS3) ssd_cc_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ B, const T* __restrict__ Cin, const float* __restrict__ states,
    T* __restrict__ y, int S, int P, int N, int PP, int nch) {
  extern __shared__ __align__(16) float sm[];
  float* cm = sm;              // [Q][LD]: C
  float* r2 = cm + Q * C::LD;  // B [Q][LD]; S^T [Q][SL]; h^T [NP][PT]
  float* xs = r2 + C::R2;      // [Q][PT]
  float* cs = xs + Q * PT;     // [Q]
  float* dts = cs + Q;         // [Q]
  const long long bh = blockIdx.x;
  const int c = blockIdx.y, p0 = blockIdx.z * PT, t0 = c * Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = bh * S + t0;
  // C and B in two groups of columns (C B^T starts on the first), then x
  constexpr int H4 = C::NP / 8;  // float4s of a half row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    load_rows<FAST, Q, C::NP / 2, C::LD, NT3>(cm + 4 * H4 * h, Cin, row0, S - t0, 0, N, 4 * H4 * h,
                                              N);
    load_rows<FAST, Q, C::NP / 2, C::LD, NT3>(r2 + 4 * H4 * h, B, row0, S - t0, 0, N, 4 * H4 * h,
                                              N);
    hopper::cp_async_commit();
  }
  load_rows<FAST, Q, PT, PT, NT3>(xs, x, row0, S - t0, 0, P, p0, P);
  hopper::cp_async_commit();
  chunk_cs(cs, dts, dt, bh * S, t0, S, A[bh]);

  // warps w and w + 4 share a scheduler: give them bands b and 3 - b, so
  // that each scheduler's C B^T and S x add up to the same work
  const int q = warp & 3, b0 = (q == 1 || q == 2) ? 1 : 0;
  const int b = warp < 4 ? b0 : 3 - b0, hp = q >> 1, ri = lane >> 3, g = lane & 7;
  const int i0 = 16 * b + ri, pc = 32 * hp + 4 * g, N4 = N / 4;
  {
    // C B^T for the rows of band 3 - b, this warp's half of its columns
    const int band = 3 - b, ib = 16 * band + ri, km = band + 1, j0 = g + 8 * km * hp;
    float cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) cb[r][k] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cp_async_wait_upto(2 - h);
      __syncthreads();  // columns [4 H4 h, 4 H4 (h + 1)) of C and B (and cs)
      const int lo = H4 * h, hi = h ? N4 : (N4 < H4 ? N4 : H4);
      switch (band) {
        case 0: cb_rows<C::LD, 1>(cb, cm, r2, ib, j0, lo, hi); break;
        case 1: cb_rows<C::LD, 2>(cb, cm, r2, ib, j0, lo, hi); break;
        case 2: cb_rows<C::LD, 3>(cb, cm, r2, ib, j0, lo, hi); break;
        default: cb_rows<C::LD, 4>(cb, cm, r2, ib, j0, lo, hi); break;
      }
    }
    __syncthreads();  // every read of B is done: S^T takes its place
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= km) break;
      const int j = j0 + 8 * k;
      float s[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ib + 4 * r;
        s[r] = j <= i ? cb[r][k] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
      }
      *reinterpret_cast<float4*>(r2 + j * C::SL + 16 * band + 4 * ri) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // S^T and x

  float acc[4][4];  // y [i0 + 4 r][pc + q]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  const int jend = 16 * b + 16;
#pragma unroll 4
  for (int j = 0; j < jend; ++j) {
    float s[4], xv[4];
    put4(s, r2 + j * C::SL + 16 * b + 4 * ri);
    put4(xv, xs + j * PT + pc);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(s[r], xv[q], acc[r][q]);
  }

  // phase 2's states; chunk 0 reads none, but waits all the same, so that
  // this grid ends after phase 2 (see the design note)
  hopper::griddep_wait();
  if (c > 0) {
    __syncthreads();  // every read of S^T is done: h^T takes its place
    // h^T in two groups of rows (C h^T starts on the first)
    const float* hs = states + (bh * nch + c) * N * PP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_rows<true, C::NP / 2, PT, PT, NT3>(r2, hs, 0, N, C::NP / 2 * h, PP, p0, PP);
      hopper::cp_async_commit();
    }
    float ch[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) ch[r][q] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cp_async_wait_upto(1 - h);
      __syncthreads();  // rows [4 H4 h, 4 H4 (h + 1)) of h^T
      const int hi = h ? N4 : (N4 < H4 ? N4 : H4);
#pragma unroll 2
      for (int n4 = H4 * h; n4 < hi; ++n4) {
        float cv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) put4(cv[r], cm + (i0 + 4 * r) * C::LD + 4 * n4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float hv[4];
          put4(hv, r2 + (4 * n4 + kk) * PT + pc);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) ch[r][q] = fmaf(cv[r][kk], hv[q], ch[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = expf(cs[i0 + 4 * r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(e, ch[r][q], acc[r][q]);
    }
  }

  const int p = p0 + pc;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = t0 + i0 + 4 * r;
    if (t >= S) continue;
    T* yrow = y + (bh * S + t) * P;
    if constexpr (FAST) {
      if (p < P)
        *reinterpret_cast<float4*>(yrow + p) = make_float4(acc[r][0], acc[r][1], acc[r][2],
                                                           acc[r][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (p + k < P) store(yrow + p + k, acc[r][k]);
    }
  }
}

// f32 elements of the scratch a call takes: the chunks' states [BH][nch][N][PP]
// (phase 1 writes each chunk's own term, phase 2 overwrites it with the
// state the chunk starts from), then their decays [BH][nch]
long long scratch_floats(long long BH, long long S, long long P, long long N) {
  const long long nch = (S + Q - 1) / Q, PP = (P + 3) / 4 * 4;
  return BH * nch * N * PP + BH * nch;
}

template <class C, bool FAST, typename T>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* Cin, void* y,
           void* h_out, void* scratch, int BH, int S, int P, int N, cudaStream_t stream) {
  static bool attributes_set = false;  // per instantiation, once per process
  cudaError_t err = cudaSuccess;
  if (!attributes_set) {
    err = cudaFuncSetAttribute(ssd_cc_state_kernel<C, FAST, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::STATE_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_cc_scan_kernel<C, FAST, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, C::SCAN_BYTES);
    if (err != cudaSuccess) return (int)err;
    attributes_set = true;
  }
  const int nch = (S + Q - 1) / Q, PP = (P + 3) / 4 * 4;
  float* states = static_cast<float*>(scratch);
  float* decay = states + (long long)BH * nch * N * PP;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const dim3 grid(BH, nch, (P + PT - 1) / PT);
  ssd_cc_state_kernel<C, FAST, T><<<grid, NT, C::STATE_BYTES, stream>>>(
      static_cast<const T*>(x), dtf, Af, static_cast<const T*>(B), states, decay, S, P, N, PP,
      nch);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // phases 2 and 3 start while the phase before them drains (griddep_wait)
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  const int PN4 = N * PP / 4;
  cfg.gridDim = dim3(BH, (PN4 + tc::PASS_NT - 1) / tc::PASS_NT);
  cfg.blockDim = dim3(tc::PASS_NT);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, tc::ssd_state_pass_kernel<true>, states,
                           static_cast<const float*>(decay), static_cast<float*>(h_out), PN4, N,
                           nch, P);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT3);
  cfg.dynamicSmemBytes = C::SCAN_BYTES;
  err = cudaLaunchKernelEx(&cfg, ssd_cc_scan_kernel<C, FAST, T>, static_cast<const T*>(x), dtf,
                           Af, static_cast<const T*>(B), static_cast<const T*>(Cin),
                           static_cast<const float*>(states), static_cast<T*>(y), S, P, N, PP,
                           nch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The tile class of a state width N: 0 (N32) up to 32, 1 (N128) beyond:
// the smallest whose tiles hold N.
// kernels/ssd_scan.py::cuda_core_plan repeats it.
int tile_class(int N) { return N <= 32 ? 0 : 1; }

// The fast load path: f32, P % 4 == 0 (x's and y's rows are whole float4s)
// and x, B, C and y on 16-byte boundaries.
bool fast_path(int dtype, int P, bool aligned) { return dtype == 0 && P % 4 == 0 && aligned; }

bool aligned16(const void* x, const void* B, const void* C, const void* y) {
  return ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
           reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
}

template <class C>
int launch_path(bool fast, int dtype, const void* x, const void* dt, const void* A, const void* B,
                const void* Cin, void* y, void* h_out, void* scratch, int BH, int S, int P, int N,
                cudaStream_t s) {
  if (dtype == 1)
    return launch<C, false, __nv_bfloat16>(x, dt, A, B, Cin, y, h_out, scratch, BH, S, P, N, s);
  if (fast) return launch<C, true, float>(x, dt, A, B, Cin, y, h_out, scratch, BH, S, P, N, s);
  return launch<C, false, float>(x, dt, A, B, Cin, y, h_out, scratch, BH, S, P, N, s);
}

int dispatch(const void* x, const void* dt, const void* A, const void* B, const void* Cin, void* y,
             void* h_out, void* scratch, int BH, int S, int P, int N, int dtype, cudaStream_t s) {
  const bool fast = fast_path(dtype, P, aligned16(x, B, Cin, y));
  if (tile_class(N) == 0)
    return launch_path<N32>(fast, dtype, x, dt, A, B, Cin, y, h_out, scratch, BH, S, P, N, s);
  return launch_path<N128>(fast, dtype, x, dt, A, B, Cin, y, h_out, scratch, BH, S, P, N, s);
}

// A class's constants (layout keys 8 c + f, below); f = 6 and 7: the CTAs an
// SM the card gives its f32 fast-path phase 1 and phase 3 kernels
template <class C>
long long constant(int f) {
  auto occupancy = [](auto kernel, int threads, int bytes) -> long long {
    int n = -1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes) != cudaSuccess)
      return -1;
    return n;
  };
  switch (f) {
    case 0: return C::NP;
    case 1: return Q;
    case 2: return PT;
    case 3: return NT3;
    case 4: return C::STATE_BYTES;
    case 5: return C::SCAN_BYTES;
    case 6: return occupancy(ssd_cc_state_kernel<C, true, float>, NT, C::STATE_BYTES);
    case 7: return occupancy(ssd_cc_scan_kernel<C, true, float>, NT3, C::SCAN_BYTES);
    default: return -1;
  }
}
}  // namespace simt

}  // namespace

// x: [BH, S, P]; dt: [BH, S] f32; A: [BH] f32; B, C: [BH, S, N]; y: [BH, S, P];
// h_out: [BH, P, N] f32 or null; all contiguous; x, B, C, y of one dtype
// (0 = f32, 1 = bf16); N a multiple of 4, at most 128.  scratch: f32, as many
// elements as ssd_cuda_core_scratch_floats(BH, S, P, N), on 16 bytes.
// Enqueues three kernels on `stream`; returns cudaGetLastError() after them
// (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* h_out, void* scratch, int BH, int S,
                            int P, int N, int dtype, void* stream) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0 || N > NMAX || N % 4 != 0 || scratch == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return simt::dispatch(x, dt, A, B, C, y, h_out, scratch, BH, S, P, N, dtype,
                        static_cast<cudaStream_t>(stream));
}

// f32 elements of the scratch ssd_scan_fwd takes for BH sequences of S
// positions, head dim P and state width N: each chunk's state [N][P padded to
// a multiple of 4], then each chunk's decay.  kernels/ssd_scan.py allocates
// it from this count and repeats it (cuda_core_scratch_floats).
extern "C" long long ssd_cuda_core_scratch_floats(int BH, int S, int P, int N) {
  if (BH <= 0 || S <= 0 || P <= 0 || N <= 0) return -1;
  return simt::scratch_floats(BH, S, P, N);
}

// The CUDA-core entry's plan for head dim P, state width N, dtype (0 = f32,
// 1 = bf16) and whether x, B, C and y lie on 16-byte boundaries: its tile
// class (0 N <= 32, 1 N <= 128) times 2, plus 1 on the fast load
// path; -1 for shapes the entry refuses.  kernels/ssd_scan.py::cuda_core_plan
// repeats it; a card test holds the two equal.
extern "C" long long ssd_cuda_core_plan(int P, int N, int dtype, int aligned) {
  if (P <= 0 || N <= 0 || N > NMAX || N % 4 != 0 || (dtype != 0 && dtype != 1)) return -1;
  return 2LL * simt::tile_class(N) + (simt::fast_path(dtype, P, aligned != 0) ? 1 : 0);
}

// The CUDA-core kernels' constants, which kernels/ssd_scan.py repeats
// (CUDA_CORE_CLASSES) and a card test holds equal: key 8 c + f for tile class
// c (0 N32, 1 N128), f = 0 its state width NP, 1 the chunk length,
// 2 the columns of P a CTA takes, 3 phase 3's threads (phase 1's are 128), 4
// and 5 phase 1's and phase 3's dynamic shared memory in bytes, 6 and 7 the
// CTAs an SM this card gives their f32 fast-path kernels
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 for any other key.
extern "C" long long ssd_cuda_core_layout(int key) {
  if (key < 0 || key >= 16) return -1;
  return key < 8 ? simt::constant<simt::N32>(key) : simt::constant<simt::N128>(key % 8);
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
// Scratch: h0s and dh1s [batch·H, ceil(S / 64), 2·P·64] bf16 (2·P·128 for N
// > 64: each state's hi and lo halves), part_a [batch·H, ceil(S / 64)] f32.
// P = 64; N a multiple of 16 up to 128.  Enqueues three kernels on
// `stream`; returns cudaGetLastError() after them (0 on success).
extern "C" int ssd_scan_wgmma_bwd(const void* x, const void* dt, const void* A, const void* B,
                                  const void* C, const void* dy, const void* dh_final, void* dx,
                                  void* ddt, void* dA, void* dB, void* dC, void* h0s, void* dh1s,
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
    return tc::launch_bwd<1>(x, dt, A, B, C, dy, dh_final, dx, ddt, dA, dB, dC, h0s, dh1s,
                             part_a, batch, S, H, G, N, L, dys, s);
  return tc::launch_bwd<2>(x, dt, A, B, C, dy, dh_final, dx, ddt, dA, dB, dC, h0s, dh1s, part_a,
                           batch, S, H, G, N, L, dys, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
