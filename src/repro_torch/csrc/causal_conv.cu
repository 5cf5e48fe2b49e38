// The Mamba-2 mixer's depthwise causal convolution, its bias and its SiLU in
// one pass, with its backward, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Replaces no TPU kernel: the JAX package computes the conv in jnp
// (src/repro/models/ssm.py::_causal_conv), which XLA fuses into its
// neighbours.  The port ran it as ~23 eager f32 passes forward and ~39
// backward (a zeros buffer, four taps each casting a shifted slice to f32,
// multiplying and adding, the bias, the SiLU, the cast back), over a [T, CH]
// f32 tensor each.  For x [B, S, CH], taps w [4, CH], bias b [CH] and the
// W - 1 = 3 positions before x (a carry [B, 3, CH], zeros without):
//     pre[t] = ((((0 + p[t]·w0) + p[t+1]·w1) + p[t+2]·w2) + p[t+3]·w3) + b,
//     y[t]   = pre[t] / (1 + exp(-pre[t])),        p = concat(carry, x)
// in f32, in that order, each product and sum rounded on its own (no FMA),
// as the eager passes compute it, so y matches them to the bit or to one
// ulp of its type.  The backward recomputes pre from x:
//     dpre[t] = dy[t] · σ · (1 + pre[t] (1 - σ)),   σ = 1 / (1 + exp(-pre[t])),
//     dx[s]   = Σ_i dpre[s + 3 - i] · w_i,   dw_i = Σ_t dpre[t] p[t+i],   db = Σ_t dpre[t].
//
// What bounds it on this card: bytes.  At mamba2-370m's training layout (B
// 16, S 2048, CH 2304, bf16) the forward reads x and writes y, 0.30 GB,
// 0.090 ms at 3.35 TB/s, against 13 operations an element (0.0059 ms at 67
// TFLOP/s); the backward reads x and dy and writes dx, 0.45 GB.  The design
// moves each of those bytes once:
// - forward (conv_silu_fwd_kernel): a thread owns VEC channels of one batch
//   row (8 bf16, one 16-byte load) and walks `tt` time rows in order, the
//   taps and the bias in registers and the three rows before the current one
//   in a sliding window, so each input row is read once, plus a 3-row halo
//   at the start of its run (from x, or from the carry at t = 0).  Rows are
//   loaded four at a time before they are used, to keep loads in flight.  A
//   CTA is 32 threads across channels (512 contiguous bytes a row) by up to 8
//   runs down the time axis.  `tt` adapts to the shape alone: the longest
//   run (32 rows) that still gives two waves of 1,024-thread SMs, down to 4;
//   with a carry read, one run covers all of S (decode: S = 1, one row a
//   slot).  The new window (the last three rows of carry + x) is written by
//   the run that ends at S, from its registers, in place where the carry in
//   and out are the cache's one window (each thread reads its channels'
//   window before it writes them; no other thread touches them).
// - backward (conv_silu_bwd_kernel): the same walk, VEC = 4 (the tap
//   gradients take registers: at 8 channels a thread would hold 170 and run
//   one CTA an SM), reading x and dy and writing dx; dx[s] needs dpre of the
//   next three rows, so a run goes three rows past its end (recomputing pre
//   there) and writes dx three rows behind.  Each thread sums dw and db over
//   its own rows in f32 registers; the 8 runs of a CTA are summed in shared
//   memory in a fixed order into one partial a CTA, written to a scratch the
//   wrapper allocates (conv_silu_bwd_scratch_floats);
//   conv_silu_bwd_reduce_kernel sums the partials over the CTAs in order.
//   No atomics: two launches give the same bits.
// - a scalar path (VEC = 1) for f32, for CH % 8 != 0 and for operands off
//   16-byte boundaries, with the same walk.
// The symbols avoid the prefixes of the port's other kernels: a profile
// classes this time with the elementwise passes it replaces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace causal {

using bf16 = __nv_bfloat16;
constexpr int W = 4;           // taps
constexpr int CTA_X = 32;      // threads across channels
constexpr int CTA_Y = 8;       // runs down the time axis, at most
constexpr int BWD_ROWS = 16;   // rows a backward run walks
constexpr int SMS = 132;       // H100's SMs: the forward's run length aims at two waves of them

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };

// VEC elements of T at p (VEC·sizeof(T) bytes aligned when VEC > 1) as f32
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else {
    using R = typename Raw<int(VEC * sizeof(T))>::type;
    const R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    using R = typename Raw<int(VEC * sizeof(T))>::type;
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<R*>(p) = raw;
  }
}

// the pre-activation of one channel, in the eager passes' order, no FMA
__device__ __forceinline__ float pre_act(const float (&win)[W - 1], float cur, const float (&w)[W],
                                         float b) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < W - 1; ++i) acc = __fadd_rn(acc, __fmul_rn(win[i], w[i]));
  acc = __fadd_rn(acc, __fmul_rn(cur, w[W - 1]));
  return __fadd_rn(acc, b);
}

__device__ __forceinline__ float silu(float p) { return __fdiv_rn(p, __fadd_rn(1.f, expf(-p))); }

// grid (channel blocks, time blocks, batch), block (CTA_X, ny): thread
// (x, y) of block (bx, by, z) takes channels [VEC·(32 bx + x), + VEC) of
// batch row z and rows [tt·(ny by + y), + tt)
template <typename T, typename TC, int VEC>
__global__ void __launch_bounds__(CTA_X * CTA_Y, 2)
conv_silu_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                     const TC* carry_in, TC* carry_out, T* __restrict__ out, int S, int CH,
                     int tt) {
  const int c = (blockIdx.x * CTA_X + threadIdx.x) * VEC;
  const int t0 = (blockIdx.y * blockDim.y + threadIdx.y) * tt;
  if (c >= CH || t0 >= S) return;
  const int t1 = min(t0 + tt, S);
  const long long rows = (long long)blockIdx.z * S;  // this batch row's first row
  float wr[VEC][W], br[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
#pragma unroll
    for (int i = 0; i < W; ++i) wr[v][i] = to_f(w[i * CH + c + v]);
    br[v] = to_f(b[c + v]);
  }
  // win[v][j]: row t0 - (W - 1) + j of concat(carry, x), channel c + v
  float win[VEC][W - 1];
#pragma unroll
  for (int j = 0; j < W - 1; ++j) {
    const int r = t0 - (W - 1) + j;
    float row[VEC];
    if (r >= 0) {
      load<T, VEC>(x + (rows + r) * CH + c, row);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        row[v] = carry_in == nullptr
                     ? 0.f
                     : to_f(carry_in[((long long)blockIdx.z * (W - 1) + r + W - 1) * CH + c + v]);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) win[v][j] = row[v];
  }
  for (int t = t0; t < t1; t += 4) {
    float cur[4][VEC];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t + k < t1) load<T, VEC>(x + (rows + t + k) * CH + c, cur[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (t + k < t1) {
        float y[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          y[v] = silu(pre_act(win[v], cur[k][v], wr[v], br[v]));
#pragma unroll
          for (int j = 0; j < W - 2; ++j) win[v][j] = win[v][j + 1];
          win[v][W - 2] = cur[k][v];
        }
        store<T, VEC>(out + (rows + t + k) * CH + c, y);
      }
    }
  }
  if (carry_out != nullptr && t1 == S) {
#pragma unroll
    for (int j = 0; j < W - 1; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        carry_out[((long long)blockIdx.z * (W - 1) + j) * CH + c + v] = from_f<TC>(win[v][j]);
  }
}

// grid (channel blocks, time blocks, batch), block (CTA_X, CTA_Y): as the
// forward, runs of BWD_ROWS rows; one partial of dw (W rows) and db (one
// row) a CTA: part[(z · gridDim.y + by) · (W + 1) + i][CH]
template <typename T, int VEC>
__global__ void __launch_bounds__(CTA_X * CTA_Y, 2)
conv_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                     const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                     int S, int CH) {
  __shared__ float red[CTA_Y][W + 1][CTA_X * VEC];
  const int c = (blockIdx.x * CTA_X + threadIdx.x) * VEC;
  const int t0 = (blockIdx.y * CTA_Y + threadIdx.y) * BWD_ROWS;
  float dwa[VEC][W + 1];  // dw_0 .. dw_{W-1}, db
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int i = 0; i <= W; ++i) dwa[v][i] = 0.f;
  if (c < CH && t0 < S) {
    const int t1 = min(t0 + BWD_ROWS, S);
    const long long rows = (long long)blockIdx.z * S;
    float wr[VEC][W], br[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
#pragma unroll
      for (int i = 0; i < W; ++i) wr[v][i] = to_f(w[i * CH + c + v]);
      br[v] = to_f(b[c + v]);
    }
    // xw: rows t - (W - 1) .. t - 1 of concat(0, x); dp: dpre of the same rows
    float xw[VEC][W - 1], dp[VEC][W - 1];
#pragma unroll
    for (int j = 0; j < W - 1; ++j) {
      const int r = t0 - (W - 1) + j;
      float row[VEC];
      if (r >= 0) {
        load<T, VEC>(x + (rows + r) * CH + c, row);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) row[v] = 0.f;
      }
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        xw[v][j] = row[v];
        dp[v][j] = 0.f;
      }
    }
    // rows t0 .. t1 + W - 2: dpre of each (zero past S); dx three rows behind
    const int tend = t1 + W - 1;
    for (int t = t0; t < tend; t += 2) {
      float xc[2][VEC], gc[2][VEC];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (t + k < tend && t + k < S) {
          load<T, VEC>(x + (rows + t + k) * CH + c, xc[k]);
          load<T, VEC>(dy + (rows + t + k) * CH + c, gc[k]);
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) xc[k][v] = gc[k][v] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int tk = t + k;
        if (tk < tend) {
          float g[VEC];
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float d = 0.f;
            if (tk < S) {
              const float p = pre_act(xw[v], xc[k][v], wr[v], br[v]);
              const float sg = 1.f / (1.f + expf(-p));
              d = gc[k][v] * sg * (1.f + p * (1.f - sg));
            }
            if (tk < t1) {
#pragma unroll
              for (int i = 0; i < W - 1; ++i) dwa[v][i] += d * xw[v][i];
              dwa[v][W - 1] += d * xc[k][v];
              dwa[v][W] += d;
            }
            // dx[tk - (W - 1)] = Σ_i dpre[tk - i] · w_i
            float s = d * wr[v][0];
#pragma unroll
            for (int i = 1; i < W; ++i) s += dp[v][W - 1 - i] * wr[v][i];
            g[v] = s;
#pragma unroll
            for (int j = 0; j < W - 2; ++j) {
              xw[v][j] = xw[v][j + 1];
              dp[v][j] = dp[v][j + 1];
            }
            xw[v][W - 2] = xc[k][v];
            dp[v][W - 2] = d;
          }
          if (tk - (W - 1) >= t0) store<T, VEC>(dx + (rows + tk - (W - 1)) * CH + c, g);
        }
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int i = 0; i <= W; ++i) red[threadIdx.y][i][threadIdx.x * VEC + v] = dwa[v][i];
  __syncthreads();
  const long long tile = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  for (int e = threadIdx.y * CTA_X + threadIdx.x; e < (W + 1) * CTA_X * VEC;
       e += CTA_X * CTA_Y) {
    const int i = e / (CTA_X * VEC), cc = blockIdx.x * CTA_X * VEC + e % (CTA_X * VEC);
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < CTA_Y; ++y) s += red[y][i][e % (CTA_X * VEC)];
    if (cc < CH) part[(tile * (W + 1) + i) * CH + cc] = s;
  }
}

// one thread an element of [W + 1, CH]: the sum over `tiles` partials, in order
template <typename TW>
__global__ void conv_silu_bwd_reduce_kernel(const float* __restrict__ part, int tiles, int CH,
                                            TW* __restrict__ dw, TW* __restrict__ db) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (W + 1) * CH) return;
  const long long stride = (long long)(W + 1) * CH;
  const float* p = part + e;
  float s = 0.f;
  int k = 0;
  for (; k + 8 <= tiles; k += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = p[(k + j) * stride];
#pragma unroll
    for (int j = 0; j < 8; ++j) s += v[j];
  }
  for (; k < tiles; ++k) s += p[k * stride];
  if (e < W * CH) dw[e] = from_f<TW>(s);
  else db[e - W * CH] = from_f<TW>(s);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// the forward's run length: a run covers all of S with a carry read (its
// window is rewritten in place), else the longest of 32, 16, 8, 4 rows that
// gives at least two waves of 1,024 threads on each SM
inline int fwd_rows(int batch, int S, int CH, int vec, bool reads_carry) {
  if (reads_carry) return S;
  const long long cols = (long long)batch * cdiv(CH, vec);
  int tt = 32;
  while (tt > 4 && cols * cdiv(S, tt) < 2LL * SMS * 1024) tt /= 2;
  return tt;
}

inline long long bwd_tiles(int batch, int S) {
  return (long long)batch * cdiv(S, CTA_Y * BWD_ROWS);
}

template <typename T, typename TC, int VEC>
int launch_fwd(const void* x, const void* w, const void* b, const void* carry_in,
               void* carry_out, void* out, int batch, int S, int CH, cudaStream_t st) {
  const int tt = fwd_rows(batch, S, CH, VEC, carry_in != nullptr);
  const int runs = cdiv(S, tt), ny = runs < CTA_Y ? runs : CTA_Y;
  const dim3 grid(cdiv(cdiv(CH, VEC), CTA_X), cdiv(runs, ny), batch);
  conv_silu_fwd_kernel<T, TC, VEC><<<grid, dim3(CTA_X, ny), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const TC*>(carry_in), static_cast<TC*>(carry_out), static_cast<T*>(out), S, CH,
      tt);
  return (int)cudaGetLastError();
}

template <typename T, typename TC>
int dispatch_fwd(const void* x, const void* w, const void* b, const void* carry_in,
                 void* carry_out, void* out, int batch, int S, int CH, cudaStream_t st) {
  if constexpr (sizeof(T) == 2)
    if (CH % 8 == 0 && aligned16(x) && aligned16(out))
      return launch_fwd<T, TC, 8>(x, w, b, carry_in, carry_out, out, batch, S, CH, st);
  return launch_fwd<T, TC, 1>(x, w, b, carry_in, carry_out, out, batch, S, CH, st);
}

template <typename T, int VEC>
int launch_bwd(const void* x, const void* w, const void* b, const void* dy, void* dx, void* part,
               int batch, int S, int CH, cudaStream_t st) {
  const dim3 grid(cdiv(cdiv(CH, VEC), CTA_X), cdiv(S, CTA_Y * BWD_ROWS), batch);
  conv_silu_bwd_kernel<T, VEC><<<grid, dim3(CTA_X, CTA_Y), 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(part), S, CH);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(const void* x, const void* w, const void* b, const void* dy, void* dx,
                 void* part, int batch, int S, int CH, cudaStream_t st) {
  if constexpr (sizeof(T) == 2)
    if (CH % 8 == 0 && aligned16(x) && aligned16(dy) && aligned16(dx))
      return launch_bwd<T, 4>(x, w, b, dy, dx, part, batch, S, CH, st);
  return launch_bwd<T, 1>(x, w, b, dy, dx, part, batch, S, CH, st);
}

}  // namespace causal

// The forward: x [batch, S, CH] and out (the same), w [4, CH], b [CH], all in
// one dtype (0 = f32, 1 = bf16), contiguous; carry_in and carry_out [batch,
// 3, CH] in carry_dtype, contiguous, either null (no history: zeros; no
// window written) and possibly the same tensor (decode's in-place window).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int conv_silu_fwd(const void* x, const void* w, const void* b, const void* carry_in,
                             void* carry_out, void* out, int batch, int S, int CH, int dtype,
                             int carry_dtype, void* stream) {
  using namespace causal;
  if (batch <= 0 || S <= 0 || CH <= 0 || batch > 65535 || (dtype != 0 && dtype != 1) ||
      (carry_dtype != 0 && carry_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* c_in = carry_in;
  if (dtype == 1)
    return carry_dtype == 1
               ? dispatch_fwd<bf16, bf16>(x, w, b, c_in, carry_out, out, batch, S, CH, st)
               : dispatch_fwd<bf16, float>(x, w, b, c_in, carry_out, out, batch, S, CH, st);
  return carry_dtype == 1
             ? dispatch_fwd<float, bf16>(x, w, b, c_in, carry_out, out, batch, S, CH, st)
             : dispatch_fwd<float, float>(x, w, b, c_in, carry_out, out, batch, S, CH, st);
}

// The backward's first kernel, no carry: x, dy and dx [batch, S, CH], w [4,
// CH], b [CH], one dtype, contiguous; part: conv_silu_bwd_scratch_floats f32
// elements, each CTA's partial sums of dw and db.
extern "C" int conv_silu_bwd(const void* x, const void* w, const void* b, const void* dy,
                             void* dx, void* part, int batch, int S, int CH, int dtype,
                             void* stream) {
  using namespace causal;
  if (batch <= 0 || S <= 0 || CH <= 0 || batch > 65535 || (dtype != 0 && dtype != 1) ||
      part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch_bwd<bf16>(x, w, b, dy, dx, part, batch, S, CH, st)
                    : dispatch_bwd<float>(x, w, b, dy, dx, part, batch, S, CH, st);
}

// The backward's second kernel: dw [4, CH] and db [CH] in w_dtype, the sums
// of conv_silu_bwd's partials for the same batch, S and CH.
extern "C" int conv_silu_bwd_reduce(const void* part, void* dw, void* db, int batch, int S,
                                    int CH, int w_dtype, void* stream) {
  using namespace causal;
  if (batch <= 0 || S <= 0 || CH <= 0 || (w_dtype != 0 && w_dtype != 1) || part == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (int)bwd_tiles(batch, S), threads = 256;
  const int blocks = cdiv((long long)(W + 1) * CH, threads);
  const float* p = static_cast<const float*>(part);
  if (w_dtype == 1)
    conv_silu_bwd_reduce_kernel<bf16><<<blocks, threads, 0, st>>>(
        p, tiles, CH, static_cast<bf16*>(dw), static_cast<bf16*>(db));
  else
    conv_silu_bwd_reduce_kernel<float><<<blocks, threads, 0, st>>>(
        p, tiles, CH, static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

// f32 elements of the backward's scratch: (W + 1) rows of CH for each CTA
// along batch and time
extern "C" long long conv_silu_bwd_scratch_floats(int batch, int S, int CH) {
  if (batch <= 0 || S <= 0 || CH <= 0) return -1;
  return causal::bwd_tiles(batch, S) * (causal::W + 1) * CH;
}

extern "C" const char* causal_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
