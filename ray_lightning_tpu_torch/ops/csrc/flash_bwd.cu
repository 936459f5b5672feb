// Flash-attention backward for Hopper (sm_90a): two kernels over recomputed
// score tiles, so the (Sq, Sk) probability matrix never reaches device memory.
//
// Replaces: ray_lightning_tpu/ops/flash_attention.py:_dkv_kernel (K2) and
// _dq_kernel (K3), both launched by _flash_vjp_bwd through pl.pallas_call.
//
//   rlt_flash_bwd_dkv (K2): one block per (64-column key tile, batch*head).
//     The block keeps its K and V tiles in shared memory and walks the query
//     tiles that can see them. Per query tile it recomputes
//       P  = exp(Q K^T * scale - lse)            (0 where masked)
//       dP = dO V^T
//       dS = P * (dP - delta) * scale
//     and accumulates dV += P^T dO and dK += dS^T Q in registers.
//   rlt_flash_bwd_dq (K3): one block per (64-row query tile, batch*head).
//     The block keeps Q, dO, lse and delta and walks the key tiles of the
//     forward's band (the sink tiles first), accumulating dQ += dS K.
//
// The split follows the TPU kernels: each output tile belongs to exactly one
// block, so there are no atomics and the gradients are bit-for-bit the same
// from run to run. delta = rowsum(dO * O) is computed by the caller.
//
// What bounds it on the H100. At the GPT-2-small training shape (B=8, H=12,
// S=1024, D=64, bf16, causal) K2 does four and K3 three products of
// 2*Sq*Sk*D FLOPs over the causal half: ~20 and ~15 GFLOP against ~50 MB of
// inputs, far above the ridge point, so the bound is the tensor cores. This
// first version does its products as fp32 FMAs from shared memory (as K1
// does), so it runs at a fraction of the fp32 FMA rate, roughly 15x below
// the bf16 tensor-core rate at best. What the design does about it: each
// thread holds a 4x4 tile of scores and of dP and a 4x(D/16) tile of each
// accumulator in registers, so one shared-memory load feeds 4 FMAs; padded
// rows keep the column reads free of bank conflicts; tiles outside the
// causal / sliding-window band are never visited. Tensor cores (wgmma), TMA
// and warp specialisation are left to a later version.
//
// Layout. q, do (B, Sq, H, D) and k, v (B, Sk, H, D) are read through their
// strides (the last dimension must be contiguous); lse and delta are fp32
// (B, H, Sq), the layout K1 writes its lse in. dq, dk, dv are written
// contiguous (B, S, H, D) in the input type, accumulated in fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;           // rows of a query tile = columns of a key tile
constexpr int NT = 16;          // threads along each side of a 64x64 tile
constexpr int THREADS = NT * NT;
constexpr int R = T / NT;       // rows (and columns) of a tile per thread
constexpr int PS = T + 1;       // padded row stride of the P and dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float sm_scale;
  int causal, window, sinks;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage `rows` rows of a strided (S, D) slab starting at row `r0` into a
// padded fp32 tile; rows past `n` are zero.
template <typename Tin, int D>
__device__ __forceinline__ void load_tile(float* dst, const Tin* src,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < T * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * DP + d] = row < n ? to_f32(src[row * row_stride + d]) : 0.f;
  }
}

// band_allowed of ops/attention.py: col <= row, and with a window
// col > row - W or col < sinks.
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  if (row >= p.Sq || col >= p.Sk) return false;
  if (!p.causal) return true;
  return col <= row &&
         (!p.window || col > row - p.window || col < p.sinks);
}

// dS (and P) of one (query tile q0, key tile c0) pair. Thread (ty, tx)
// computes rows ty*R + i and columns tx + NT*j of the 64x64 tile. Qs, dOs,
// Ks, Vs are padded fp32 tiles; lse_s, delta_s the query rows' statistics.
template <int D>
__device__ __forceinline__ void score_tile(
    const Params& p, const float* Qs, const float* dOs, const float* Ks,
    const float* Vs, const float* lse_s, const float* delta_s, int q0,
    int c0, float P[R][R], float dS[R][R]) {
  constexpr int DP = D + 1;
  const int tx = threadIdx.x % NT, ty = threadIdx.x / NT;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[R], o[R], kk[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = Qs[(ty * R + i) * DP + d];
      o[i] = dOs[(ty * R + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      kk[j] = Ks[(tx + NT * j) * DP + d];
      vv[j] = Vs[(tx + NT * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(o[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty * R + i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // Masked scores give p = 0 outright: exp(-inf - lse) is never formed.
      const bool ok = visible(p, q0 + r, c0 + tx + NT * j);
      const float pij = ok ? expf(s[i][j] * p.sm_scale - lse_s[r]) : 0.f;
      P[i][j] = pij;
      dS[i][j] = pij * (dp[i][j] - delta_s[r]) * p.sm_scale;
    }
  }
}

// K2: one block per (key tile, batch*head); dK and dV of that tile.
template <typename Tin, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int RD = D / NT;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // [T][DP]
  float* Vs = Ks + T * DP;      // [T][DP]
  float* Qs = Vs + T * DP;      // [T][DP]
  float* dOs = Qs + T * DP;     // [T][DP]
  float* Ps = dOs + T * DP;     // [T][PS], indexed [query row][key col]
  float* dSs = Ps + T * PS;     // [T][PS]
  float* lse_s = dSs + T * PS;  // [T]
  float* delta_s = lse_s + T;   // [T]

  const int tx = threadIdx.x % NT, ty = threadIdx.x / NT;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = blockIdx.x * T;

  const Tin* q = static_cast<const Tin*>(p.q) + b * p.q_sb + h * p.q_sh;
  const Tin* k = static_cast<const Tin*>(p.k) + b * p.k_sb + h * p.k_sh;
  const Tin* v = static_cast<const Tin*>(p.v) + b * p.v_sb + h * p.v_sh;
  const Tin* dout =
      static_cast<const Tin*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  load_tile<Tin, D>(Ks, k, p.k_ss, c0, p.Sk);
  load_tile<Tin, D>(Vs, v, p.v_ss, c0, p.Sk);

  float dk[R][RD], dv[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dk[i][j] = dv[i][j] = 0.f;

  // Query tiles that can see this key tile (K2 :202-213 for 64-row tiles).
  // Causal: rows before c0 see no column of the tile, so start at the tile
  // holding row c0. A window: the last row that sees the tile's last column
  // is (c0 + T - 1) + W - 1; a tile holding sink columns is seen by every
  // later row.
  int start = 0, end = (p.Sq + T - 1) / T;
  if (p.causal) {
    start = c0 / T;
    if (p.window && !(p.sinks && c0 < p.sinks)) {
      end = min(end, (c0 + T - 1 + p.window - 1) / T + 1);
    }
  }

  for (int qt = start; qt < end; ++qt) {
    const int q0 = qt * T;
    __syncthreads();  // the previous tile's Qs/dOs/Ps/dSs reads are done
    load_tile<Tin, D>(Qs, q, p.q_ss, q0, p.Sq);
    load_tile<Tin, D>(dOs, dout, p.o_ss, q0, p.Sq);
    for (int i = threadIdx.x; i < T; i += THREADS) {
      const bool ok = q0 + i < p.Sq;
      lse_s[i] = ok ? lse[q0 + i] : 0.f;
      delta_s[i] = ok ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float P[R][R], dS[R][R];
    score_tile<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, c0, P, dS);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        Ps[(ty * R + i) * PS + tx + NT * j] = P[i][j];
        dSs[(ty * R + i) * PS + tx + NT * j] = dS[i][j];
      }
    __syncthreads();

    // dV[c][d] += sum_r P[r][c] dO[r][d]; dK[c][d] += sum_r dS[r][c] Q[r][d].
    // Here thread (ty, tx) owns key rows ty*R + i and columns tx + NT*j.
#pragma unroll 4
    for (int r = 0; r < T; ++r) {
      float pc[R], dc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pc[i] = Ps[r * PS + ty * R + i];
        dc[i] = dSs[r * PS + ty * R + i];
      }
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const float o = dOs[r * DP + tx + NT * j];
        const float a = Qs[r * DP + tx + NT * j];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dv[i][j] = fmaf(pc[i], o, dv[i][j]);
          dk[i][j] = fmaf(dc[i], a, dk[i][j]);
        }
      }
    }
  }

  Tin* dkp = static_cast<Tin*>(p.dk);
  Tin* dvp = static_cast<Tin*>(p.dv);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = c0 + ty * R + i;
    if (col >= p.Sk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sk + col) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      store(dkp + off + tx + NT * j, dk[i][j]);
      store(dvp + off + tx + NT * j, dv[i][j]);
    }
  }
}

// K3: one block per (query tile, batch*head); dQ of that tile.
template <typename Tin, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int RD = D / NT;
  extern __shared__ float smem[];
  float* Qs = smem;             // [T][DP]
  float* dOs = Qs + T * DP;     // [T][DP]
  float* Ks = dOs + T * DP;     // [T][DP]
  float* Vs = Ks + T * DP;      // [T][DP]
  float* dSs = Vs + T * DP;     // [T][PS]
  float* lse_s = dSs + T * PS;  // [T]
  float* delta_s = lse_s + T;   // [T]

  const int tx = threadIdx.x % NT, ty = threadIdx.x / NT;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * T;

  const Tin* q = static_cast<const Tin*>(p.q) + b * p.q_sb + h * p.q_sh;
  const Tin* k = static_cast<const Tin*>(p.k) + b * p.k_sb + h * p.k_sh;
  const Tin* v = static_cast<const Tin*>(p.v) + b * p.v_sb + h * p.v_sh;
  const Tin* dout =
      static_cast<const Tin*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  load_tile<Tin, D>(Qs, q, p.q_ss, q0, p.Sq);
  load_tile<Tin, D>(dOs, dout, p.o_ss, q0, p.Sq);
  for (int i = threadIdx.x; i < T; i += THREADS) {
    const bool ok = q0 + i < p.Sq;
    lse_s[i] = ok ? lse[q0 + i] : 0.f;
    delta_s[i] = ok ? delta[q0 + i] : 0.f;
  }

  float dq[R][RD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dq[i][j] = 0.f;

  // The forward's band for 64-wide tiles (K3 :267-273, :299-302; the same
  // bounds as flash_fwd.cu): causal ends at the tile holding the block's
  // last row; a window starts at the tile holding the earliest column any
  // row can see; sink tiles below that start are visited first.
  const int n_tiles = (p.Sk + T - 1) / T;
  int end = n_tiles;
  if (p.causal) end = min(end, (q0 + T + T - 1) / T);
  const int first = p.window ? max(0, q0 - p.window + 1) / T : 0;
  const int n_sink =
      (p.window && p.sinks) ? min((p.sinks + T - 1) / T, first) : 0;
  const int n_visit = n_sink + max(0, end - first);

  for (int it = 0; it < n_visit; ++it) {
    const int c0 = (it < n_sink ? it : first + it - n_sink) * T;
    __syncthreads();  // the previous tile's Ks/dSs reads are done
    load_tile<Tin, D>(Ks, k, p.k_ss, c0, p.Sk);
    load_tile<Tin, D>(Vs, v, p.v_ss, c0, p.Sk);
    __syncthreads();

    float P[R][R], dS[R][R];
    score_tile<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, c0, P, dS);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) dSs[(ty * R + i) * PS + tx + NT * j] = dS[i][j];
    __syncthreads();

    // dQ[r][d] += sum_c dS[r][c] K[c][d]; thread owns rows ty*R + i.
#pragma unroll 4
    for (int c = 0; c < T; ++c) {
      float dc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dc[i] = dSs[(ty * R + i) * PS + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const float kk = Ks[c * DP + tx + NT * j];
#pragma unroll
        for (int i = 0; i < R; ++i) dq[i][j] = fmaf(dc[i], kk, dq[i][j]);
      }
    }
  }

  Tin* dqp = static_cast<Tin*>(p.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= p.Sq) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < RD; ++j) store(dqp + off + tx + NT * j, dq[i][j]);
  }
}

template <typename Tin, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * T * (D + 1) + 2 * T * PS + 2 * T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<Tin, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sk + T - 1) / T, p.B * p.H);
  flash_bwd_dkv_kernel<Tin, D><<<grid, THREADS, smem, stream>>>(p);
  // A launch refused for its shared memory or block size never runs, and a
  // later synchronize does not report it: read the launch error here.
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * T * (D + 1) + T * PS + 2 * T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<Tin, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + T - 1) / T, p.B * p.H);
  flash_bwd_dq_kernel<Tin, D><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin>
int dispatch(const Params& p, int head_dim, bool dkv, cudaStream_t s) {
  switch (head_dim) {
    case 64: return dkv ? launch_dkv<Tin, 64>(p, s) : launch_dq<Tin, 64>(p, s);
    case 128:
      return dkv ? launch_dkv<Tin, 128>(p, s) : launch_dq<Tin, 128>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int batch, int heads, int seq_q, int seq_k, int head_dim,
        const long long* strides, float sm_scale, int causal, int window,
        int sinks, int dtype, int device, void* stream, bool dkv) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = batch;
  p.H = heads;
  p.Sq = seq_q;
  p.Sk = seq_k;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, head_dim, dkv, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, head_dim, dkv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 on
// success). dtype: 0 = float32, 1 = bfloat16. strides: the (batch, seq,
// head) strides of q, k, v and dout, in elements, twelve in all.
extern "C" int rlt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int heads, int seq_q, int seq_k, int head_dim, const long long* strides,
    float sm_scale, int causal, int window, int sinks, int dtype, int device,
    void* stream) {
  return run(q, k, v, dout, lse, delta, nullptr, dk, dv, batch, heads, seq_q,
             seq_k, head_dim, strides, sm_scale, causal, window, sinks, dtype,
             device, stream, true);
}

extern "C" int rlt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int heads,
    int seq_q, int seq_k, int head_dim, const long long* strides,
    float sm_scale, int causal, int window, int sinks, int dtype, int device,
    void* stream) {
  return run(q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch, heads,
             seq_q, seq_k, head_dim, strides, sm_scale, causal, window,
             sinks, dtype, device, stream, false);
}
