// Flash-attention forward for Hopper (sm_90a): online-softmax attention that
// never materialises the (Sq, Sk) score matrix in device memory.
//
// Replaces: ray_lightning_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd through pl.pallas_call), the TPU forward kernel K1.
//
// What bounds it on the H100. At GPT-2-small prefill shapes (B=1, S<=1024,
// H=12, D=64, bf16) the work is ~S*S*D*H*2 FLOPs against ~8*S*H*D bytes: the
// tensor-core bound and the memory bound are both a few microseconds, and the
// real limit of this version is instruction issue. It does its products as
// fp32 FMAs from shared memory (the TPU kernel upcasts to fp32 inside as
// well), so it is bound by shared-memory loads and FP32 issue, roughly 15x
// below the bf16 tensor-core rate. What the design does about it: each
// thread keeps a 4x8 register tile of scores and a 4x(D/8) tile of the output
// accumulator, so one shared-memory load feeds 4 or 8 FMAs; padded rows keep
// the shared-memory reads free of bank conflicts; key tiles outside the
// causal / sliding-window band are never loaded. Tensor cores (wgmma), TMA
// and warp specialisation are left to a later version.
//
// Layout. q (B, Sq, H, D) and k, v (B, Sk, H, D) are read through their
// strides (the last dimension must be contiguous), so the caller pays no
// transpose. o is written contiguous (B, Sq, H, D) in the input type and
// lse = m + log(l) as fp32 (B, H, Sq), without the TPU kernel's 8-lane pad.
//
// Grid: one block of 128 threads per (q tile of 64 rows, batch*head). The
// block walks key tiles of 64 columns: first the sink tiles that the band
// loop would not reach, then the band [first, end). Semantics follow K1
// exactly: -inf masking, alpha = 0 while the running max is still -inf,
// p = 0 where the score is -inf, and a row with no visible key writes 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // query rows per block
constexpr int TK = 64;          // key columns per tile
constexpr int NTX = 8;          // threads across a tile's columns
constexpr int NTY = 16;         // threads across a tile's rows
constexpr int THREADS = NTX * NTY;
constexpr int RQ = TQ / NTY;    // rows held by one thread
constexpr int RK = TK / NTX;    // score columns held by one thread
constexpr int PS = TK + 1;      // padded row stride of the probability tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Sq, Sk;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(Params p) {
  constexpr int DP = D + 1;     // padded row stride of the Q and K tiles
  constexpr int RD = D / NTX;   // output columns held by one thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [TQ][DP], pre-scaled by sm_scale
  float* Ks = Qs + TQ * DP;     // [TK][DP]
  float* Vs = Ks + TK * DP;     // [TK][D]
  float* Ps = Vs + TK * D;      // [TQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid % NTX;     // the 8 threads of one row group share a warp
  const int ty = tid / NTX;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * TQ;
  const float NEG_INF = -INFINITY;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < TQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * DP + d] =
        row < p.Sq ? to_f32(q[row * p.q_ss + d]) * p.sm_scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  // Loop bounds (K1 :42-58, :95-101). Causal stops at the tile holding this
  // block's last row; a window starts at the tile holding the earliest
  // column any row of the block can see; sink tiles below that start are
  // visited first, so no tile is visited twice.
  const int n_tiles = (p.Sk + TK - 1) / TK;
  int end = n_tiles;
  if (p.causal) end = min(end, (q0 + TQ + TK - 1) / TK);
  const int first = p.window ? max(0, q0 - p.window + 1) / TK : 0;
  const int n_sink =
      (p.window && p.sinks) ? min((p.sinks + TK - 1) / TK, first) : 0;
  const int n_visit = n_sink + max(0, end - first);

  for (int it = 0; it < n_visit; ++it) {
    const int c0 = (it < n_sink ? it : first + it - n_sink) * TK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps reads are done
    for (int i = tid; i < TK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int col = c0 + r;
      const bool ok = col < p.Sk;
      Ks[r * DP + d] = ok ? to_f32(k[col * p.k_ss + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f32(v[col * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RQ], kk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[(ty * RQ + i) * DP + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kk[j] = Ks[(tx + NTX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i;
      const int row = q0 + r;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = c0 + tx + NTX * j;
        bool ok = col < p.Sk;
        if (p.causal) {
          // band_allowed: col <= row, and with a window col > row - W or
          // col < sinks.
          ok = ok && col <= row &&
               (!p.window || col > row - p.window || col < p.sinks);
        }
        if (!ok) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
      const float m_new = fmaxf(m[i], mt);
      // -inf - -inf is NaN: a row can be fully masked inside a visited tile
      // when the window is narrower than the tile (K1 :80-83).
      const float alpha = m[i] == NEG_INF ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float pij = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        Ps[r * PS + tx + NTX * j] = pij;
        rs += pij;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // the whole probability tile is in Ps

#pragma unroll 4
    for (int c = 0; c < TK; ++c) {
      float pc[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pc[i] = Ps[(ty * RQ + i) * PS + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        const float vv = Vs[c * D + tx + NTX * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pc[i], vv, acc[i][j]);
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= p.Sq) continue;
    // A row with no visible key has l == 0 and writes 0 (K1 :105).
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < RD; ++j) store(orow + tx + NTX * j, acc[i][j] / l_safe);
    if (tx == 0) {
      p.lse[static_cast<long long>(bh) * p.Sq + row] = m[i] + logf(l_safe);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (TQ * (D + 1) + TK * (D + 1) + TK * D + TQ * PS);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sq + TQ - 1) / TQ, p.B * p.H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  // A launch refused for its shared memory or block size never runs, and a
  // later synchronize does not report it: read the launch error here.
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(const Params& p, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t (0 on success).
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int rlt_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int seq_q, int seq_k, int head_dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float sm_scale, int causal, int window, int sinks, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.B = batch;
  p.H = heads;
  p.Sq = seq_q;
  p.Sk = seq_k;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.sm_scale = sm_scale;
  p.causal = causal;
  p.window = window;
  p.sinks = sinks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float>(p, head_dim, s);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(p, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
