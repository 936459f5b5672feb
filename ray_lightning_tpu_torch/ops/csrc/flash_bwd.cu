// Flash-attention backward for Hopper (sm_90a): two kernels over recomputed
// score tiles, so the (Sq, Sk) probability matrix never reaches device memory.
//
// Replaces: ray_lightning_tpu/ops/flash_attention.py:_dkv_kernel (K2) and
// _dq_kernel (K3), both launched by _flash_vjp_bwd through pl.pallas_call.
//
//   rlt_flash_bwd_dkv (K2): one block per (key tile, batch*head). The block
//     walks the query tiles that can see its keys. Per query tile it
//     recomputes
//       P  = exp(Q K^T * scale - lse)            (0 where masked)
//       dP = dO V^T
//       dS = P * (dP - delta) * scale
//     and accumulates dV += P^T dO and dK += dS^T Q in registers.
//   rlt_flash_bwd_dq (K3): one block per (query tile, batch*head). The block
//     walks the key tiles of the forward's band (the sink tiles first) and
//     accumulates dQ += dS K.
//
// Each output tile belongs to exactly one block, as in the TPU kernels, so
// there are no atomics and the gradients are bit-for-bit the same from run
// to run. delta = rowsum(dO * O) is computed by the caller.
//
// What bounds it on the H100. At the GPT-2-small training shape (B=8, H=12,
// S=1024, D=64, bf16, causal) K2 does four and K3 three products of 2*D
// FLOPs per visible (query, key) pair: 25.8 and 19.3 GFLOP against ~50 MB
// of inputs, far above the ridge point, so the bound is the bf16 tensor
// cores: 0.026 and 0.020 ms at 989 TFLOP/s.
//
// The bf16 kernels (the training path) run every product on the tensor
// cores as wgmma (m64nNk16, bf16 in, fp32 accumulate), one warpgroup of 128
// threads per block owning a 64-row tile. Tiles stay bf16 in shared memory
// in the 128-byte swizzled layout wgmma reads through descriptors. They
// arrive by TMA (one thread starts cp.async.bulk.tensor through a tensor
// map built per launch from the strided global view; the wrapper checks
// the 16-byte alignment TMA needs) into a two-stage ring whose mbarriers
// count the bytes, so the next tile loads while this one computes and the
// compute threads spend no instructions on the copies. One swizzled
// (rows, D) tile is both a K-major operand and, with wgmma's transpose
// flag, an MN-major one, so each tile is loaded once and read both ways:
//   K2: the block holds 64 key rows; per query tile it forms S^T = K Q^T
//     and dP^T = V dO^T (both operands from shared memory), turns them into
//     P^T and dS^T in registers (lse and delta of the query columns from
//     shared memory), and feeds those accumulators, rounded to bf16,
//     straight back as the register A operand of dV += P^T dO and
//     dK += dS^T Q (FlashAttention-2's reuse): P and dS never touch shared
//     memory.
//   K3: the block holds 64 query rows (Q, dO, their lse and delta loaded
//     once); per key tile S = Q K^T, dP = dO V^T, dS in registers, and
//     dQ += dS K with dS as the register A operand. Causal blocks launch
//     heaviest first (the last query tile sees the most keys).
// A tile wholly inside the band skips the per-element mask. P and dS are
// rounded to bf16 where they enter a product, as FlashAttention-2 does;
// the sums are fp32 and each output is rounded once. At D=128 K2 walks
// 32-row query tiles, so that dK, dV, S^T and dP^T fit the registers.
// Left for a later version: warp specialisation (a producer warp, two
// consumer warpgroups sharing each loaded tile), overlap of the P/dS
// arithmetic with the next products, persistent blocks.
//
// The fp32 kernels keep the SIMT design (fp32 FMAs from padded fp32 tiles,
// a 4x4 register tile of S and dP per thread): the tensor cores would take
// fp32 only as TF32, whose 10-bit mantissa cannot meet the fp32 bar of
// 1e-4 against the plain version.
//
// Layout. q, do (B, Sq, H, D) and k, v (B, Sk, H, D) are read through their
// strides (the last dimension must be contiguous); lse and delta are fp32
// (B, H, Sq), the layout K1 writes its lse in. dq, dk, dv are written
// contiguous (B, S, H, D) in the input type.

#include "sm90.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// fp32: SIMT kernels.

constexpr int T = 64;           // rows of a query tile = columns of a key tile
constexpr int NT = 16;          // threads along each side of a 64x64 tile
constexpr int THREADS = NT * NT;
constexpr int R = T / NT;       // rows (and columns) of a tile per thread
constexpr int PS = T + 1;       // padded row stride of the P and dS tiles

// Stage `rows` rows of a strided (S, D) slab starting at row `r0` into a
// padded fp32 tile; rows past `n` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int r0,
                                          int n) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < T * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    dst[r * DP + d] = row < n ? src[row * row_stride + d] : 0.f;
  }
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

// K2, fp32: one block per (key tile, batch*head); dK and dV of that tile.
template <int D>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  load_tile<D>(Ks, k, p.k_ss, c0, p.Sk);
  load_tile<D>(Vs, v, p.v_ss, c0, p.Sk);

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
    load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
    load_tile<D>(dOs, dout, p.o_ss, q0, p.Sq);
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

  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = c0 + ty * R + i;
    if (col >= p.Sk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sk + col) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      dkp[off + tx + NT * j] = dk[i][j];
      dvp[off + tx + NT * j] = dv[i][j];
    }
  }
}

// K3, fp32: one block per (query tile, batch*head); dQ of that tile.
template <int D>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dout =
      static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  load_tile<D>(Qs, q, p.q_ss, q0, p.Sq);
  load_tile<D>(dOs, dout, p.o_ss, q0, p.Sq);
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
    load_tile<D>(Ks, k, p.k_ss, c0, p.Sk);
    load_tile<D>(Vs, v, p.v_ss, c0, p.Sk);
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

  float* dqp = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= p.Sq) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < RD; ++j) dqp[off + tx + NT * j] = dq[i][j];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (wgmma; the helpers are in sm90.cuh).

// 4-byte asynchronous copy into shared memory; with `ok` false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `nrows` fp32 values from `src[r0:]` into smem; past n they are zero.
__device__ __forceinline__ void load_stats(float* dst, const float* src,
                                           int r0, int nrows, int n) {
  for (int i = threadIdx.x; i < nrows; i += WG_THREADS) {
    const bool ok = r0 + i < n;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok);
  }
}

// K2's P^T (into s) and dS^T (into dp) for a tile of key rows from key0
// (the warp's) x N query columns from q0: lse and delta are the query
// columns'. MASK: the tile crosses the band's edge, so each element is
// checked; masked scores give p = 0 outright (exp(-inf - lse) is never
// formed).
template <int N, bool MASK>
__device__ __forceinline__ void dkv_probs(const Params& p, float* s,
                                          float* dp, const float* lse,
                                          const float* delta, int q0,
                                          int key0, int lane) {
  const float scale = p.sm_scale, scale_log2 = p.sm_scale * LOG2E;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + acc_col(lane, e);
      const bool ok =
          !MASK || visible(p, q0 + col, key0 + acc_row(lane, e));
      const float pv =
          ok ? fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse[col] * LOG2E))
             : 0.f;
      s[4 * j + e] = pv;
      dp[4 * j + e] = pv * (dp[4 * j + e] - delta[col]) * scale;
    }
}

// K3's dS (into dp) for the warp's query rows from row0 x N key columns
// from c0; lse2 (times log2 e) and delta of rows row0 + lane / 4 and that
// + 8. MASK as in dkv_probs.
template <int N, bool MASK>
__device__ __forceinline__ void dq_dscores(const Params& p, const float* s,
                                           float* dp, const float lse2[2],
                                           const float delta[2], int row0,
                                           int c0, int lane) {
  const float scale = p.sm_scale, scale_log2 = p.sm_scale * LOG2E;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      const bool ok = !MASK || visible(p, row0 + acc_row(lane, e),
                                       c0 + j * 8 + acc_col(lane, e));
      const float pv =
          ok ? fast_exp2(fmaf(s[4 * j + e], scale_log2, -lse2[half])) : 0.f;
      dp[4 * j + e] = pv * (dp[4 * j + e] - delta[half]) * scale;
    }
}

// The bf16 kernels' arguments: the TMA maps of q, k, v and dO (boxes of
// the rows each kernel walks) beside the common parameters.
struct TmaParams {
  CUtensorMap q, k, v, o;
  Params p;
};

// Query rows the K2 loop walks per iteration: 64, or 32 at D=128 so that
// dK, dV, S^T and dP^T fit the registers.
template <int D>
struct DkvTile {
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr size_t smem =
      sizeof(bf16) * (2 * ROWS * D + 4 * BQ * D) + sizeof(float) * 4 * BQ +
      2 * sizeof(uint64_t) + 1024;
};

// K2, bf16: one block (one warpgroup) per (64-row key tile, batch*head);
// warp w holds key rows [16w, 16w + 16) of every accumulator.
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ TmaParams t) {
  constexpr int BQ = DkvTile<D>::BQ;
  const Params& p = t.p;
  bf16* Ks = reinterpret_cast<bf16*>(smem_base());  // (ROWS, D)
  bf16* Vs = Ks + ROWS * D;                          // (ROWS, D)
  bf16* Qs = Vs + ROWS * D;                          // 2 x (BQ, D)
  bf16* dOs = Qs + 2 * BQ * D;                       // 2 x (BQ, D)
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * D);  // 2 x BQ
  float* delta_s = lse_s + 2 * BQ;                             // 2 x BQ
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + 2 * BQ);  // 2

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // Key tile 0 is seen by the most query tiles: blockIdx.y = 0 launches
  // first, so the grid starts with its heaviest blocks.
  const int c0 = blockIdx.y * ROWS;

  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  // Query tiles that can see this key tile, as in the fp32 kernel, for
  // BQ-row tiles.
  int start = 0, end = (p.Sq + BQ - 1) / BQ;
  if (p.causal) {
    start = c0 / BQ;
    if (p.window && !(p.sinks && c0 < p.sinks)) {
      end = min(end, (c0 + ROWS - 1 + p.window - 1) / BQ + 1);
    }
  }

  // Q and dO of a query tile by TMA onto full[buf] (thread 0 starts the
  // copies), lse and delta by cp.async (every thread).
  constexpr uint32_t tile_bytes = 2 * BQ * D * sizeof(bf16);
  auto load_query_tile = [&](int qt, int buf) {
    const int q0 = qt * BQ;
    if (threadIdx.x == 0) {
      tma_rows<D>(Qs + buf * BQ * D, &t.q, &full[buf], q0, h, b, BQ);
      tma_rows<D>(dOs + buf * BQ * D, &t.o, &full[buf], q0, h, b, BQ);
    }
    load_stats(lse_s + buf * BQ, lse, q0, BQ, p.Sq);
    load_stats(delta_s + buf * BQ, delta, q0, BQ, p.Sq);
    cp_async_commit();
  };

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
  }
  __syncthreads();
  if (start < end) {
    if (threadIdx.x == 0) {
      mbar_expect(&full[0], 2 * ROWS * D * sizeof(bf16) + tile_bytes);
      tma_rows<D>(Ks, &t.k, &full[0], c0, h, b, ROWS);
      tma_rows<D>(Vs, &t.v, &full[0], c0, h, b, ROWS);
    }
    load_query_tile(start, 0);
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const int r0 = w * 16;  // the warp's first key row in the tile
  for (int qt = start; qt < end; ++qt) {
    const int buf = (qt - start) & 1;
    if (qt + 1 < end) {
      if (threadIdx.x == 0) mbar_expect(&full[buf ^ 1], tile_bytes);
      load_query_tile(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    mbar_wait(&full[buf], ((qt - start) >> 1) & 1);
    __syncthreads();  // lse and delta from every thread's cp.async
    const bf16* Qb = Qs + buf * BQ * D;
    const bf16* dOb = dOs + buf * BQ * D;
    const float* lse_b = lse_s + buf * BQ;
    const float* delta_b = delta_s + buf * BQ;
    const int q0 = qt * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 64 key rows x BQ query columns.
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<BQ>(s, desc_k<ROWS>(Ks, ks), desc_k<BQ>(Qb, ks));
      wgmma_ss<BQ>(dp, desc_k<ROWS>(Vs, ks), desc_k<BQ>(dOb, ks));
    }
    wg_commit();
    wg_wait();
    pin<BQ / 2>(s);
    pin<BQ / 2>(dp);

    // P^T into s, dS^T into dp; only tiles across the band's edge mask.
    if (tile_visible(p, q0, BQ, c0, ROWS)) {
      dkv_probs<BQ, false>(p, s, dp, lse_b, delta_b, q0, c0 + r0, lane);
    } else {
      dkv_probs<BQ, true>(p, s, dp, lse_b, delta_b, q0, c0 + r0, lane);
    }

    // dV += P^T dO and dK += dS^T Q, the reduction over the BQ queries:
    // P^T and dS^T are the register A operands, dO and Q are read
    // transposed from the tiles that fed S^T and dP^T.
    wg_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s + 8 * kq);
      acc_to_a(da, dp + 8 * kq);
      wgmma_rs<D>(dv, pa, desc_mn<BQ>(dOb, kq));
      wgmma_rs<D>(dk, da, desc_mn<BQ>(Qb, kq));
    }
    wg_commit();
    wg_wait();
    pin<D / 2>(dv);
    pin<D / 2>(dk);
    __syncthreads();  // buffer `buf` is refilled by the next iteration
  }

  store_rows<D>(p.dk, dk, p.Sk, p.H, b, h, c0 + r0, lane);
  store_rows<D>(p.dv, dv, p.Sk, p.H, b, h, c0 + r0, lane);
}

// Key columns the K3 loop walks per iteration.
template <int D>
struct DqTile {
  static constexpr int BK = 64;
  static constexpr size_t smem =
      sizeof(bf16) * (2 * ROWS * D + 4 * BK * D) +
      sizeof(float) * 2 * ROWS + 2 * sizeof(uint64_t) + 1024;
};

// K3, bf16: one block (one warpgroup) per (64-row query tile,
// batch*head); warp w holds query rows [16w, 16w + 16).
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ TmaParams t) {
  constexpr int BK = DqTile<D>::BK;
  const Params& p = t.p;
  bf16* Qs = reinterpret_cast<bf16*>(smem_base());  // (ROWS, D)
  bf16* dOs = Qs + ROWS * D;                         // (ROWS, D)
  bf16* Ks = dOs + ROWS * D;                         // 2 x (BK, D)
  bf16* Vs = Ks + 2 * BK * D;                        // 2 x (BK, D)
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BK * D);  // ROWS
  float* delta_s = lse_s + ROWS;                             // ROWS
  uint64_t* full = reinterpret_cast<uint64_t*>(delta_s + ROWS);  // 2

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // Causal: the last query tile sees the most key tiles, so it launches
  // first (blockIdx.y = 0) and the grid ends on its lightest blocks.
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS;

  const float* lse = p.lse + static_cast<long long>(bh) * p.Sq;
  const float* delta = p.delta + static_cast<long long>(bh) * p.Sq;

  // The forward's band, as in the fp32 kernel, for BK-column tiles.
  const int n_tiles = (p.Sk + BK - 1) / BK;
  int end = n_tiles;
  if (p.causal) end = min(end, (q0 + ROWS - 1) / BK + 1);
  const int first = p.window ? max(0, q0 - p.window + 1) / BK : 0;
  const int n_sink =
      (p.window && p.sinks) ? min((p.sinks + BK - 1) / BK, first) : 0;
  const int n_visit = n_sink + max(0, end - first);
  auto tile_col = [&](int it) {
    return (it < n_sink ? it : first + it - n_sink) * BK;
  };
  // K and V of a key tile by TMA onto full[buf]; thread 0 starts them.
  constexpr uint32_t tile_bytes = 2 * BK * D * sizeof(bf16);
  auto load_key_tile = [&](int it, int buf) {
    const int c0 = tile_col(it);
    tma_rows<D>(Ks + buf * BK * D, &t.k, &full[buf], c0, h, b, BK);
    tma_rows<D>(Vs + buf * BK * D, &t.v, &full[buf], c0, h, b, BK);
  };

  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
  }
  __syncthreads();
  if (n_visit > 0) {
    if (threadIdx.x == 0) {
      mbar_expect(&full[0], 2 * ROWS * D * sizeof(bf16) + tile_bytes);
      tma_rows<D>(Qs, &t.q, &full[0], q0, h, b, ROWS);
      tma_rows<D>(dOs, &t.o, &full[0], q0, h, b, ROWS);
      load_key_tile(0, 0);
    }
    load_stats(lse_s, lse, q0, ROWS, p.Sq);
    load_stats(delta_s, delta, q0, ROWS, p.Sq);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // lse and delta from every thread's cp.async

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const int r0 = w * 16;  // the warp's first query row in the tile
  // The warp's rows' lse (times log2 e) and delta, kept in registers.
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lse_r[half] = lse_s[r0 + acc_row(lane, 2 * half)] * LOG2E;
    delta_r[half] = delta_s[r0 + acc_row(lane, 2 * half)];
  }
  for (int it = 0; it < n_visit; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_visit && threadIdx.x == 0) {
      mbar_expect(&full[buf ^ 1], tile_bytes);
      load_key_tile(it + 1, buf ^ 1);
    }
    mbar_wait(&full[buf], (it >> 1) & 1);
    const bf16* Kb = Ks + buf * BK * D;
    const bf16* Vb = Vs + buf * BK * D;
    const int c0 = tile_col(it);

    // S = Q K^T and dP = dO V^T: 64 query rows x BK key columns.
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<BK>(s, desc_k<ROWS>(Qs, ks), desc_k<BK>(Kb, ks));
      wgmma_ss<BK>(dp, desc_k<ROWS>(dOs, ks), desc_k<BK>(Vb, ks));
    }
    wg_commit();
    wg_wait();
    pin<BK / 2>(s);
    pin<BK / 2>(dp);

    // dS into dp (P only feeds it here); only tiles across the band's
    // edge mask.
    if (tile_visible(p, q0, ROWS, c0, BK)) {
      dq_dscores<BK, false>(p, s, dp, lse_r, delta_r, q0 + r0, c0, lane);
    } else {
      dq_dscores<BK, true>(p, s, dp, lse_r, delta_r, q0 + r0, c0, lane);
    }

    // dQ += dS K, the reduction over the BK keys: dS is the register A
    // operand, K is read transposed from the tile that fed S.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, dp + 8 * kk);
      wgmma_rs<D>(dq, da, desc_mn<BK>(Kb, kk));
    }
    wg_commit();
    wg_wait();
    pin<D / 2>(dq);
    __syncthreads();  // buffer `buf` is refilled by the next iteration
  }

  store_rows<D>(p.dq, dq, p.Sq, p.H, b, h, q0 + r0, lane);
}

// ---------------------------------------------------------------------------
// Launch.

// The bf16 kernels' arguments: q and dO in boxes of `q_rows` rows, k and v
// in boxes of `k_rows` rows.
template <int D>
bool tma_params(TmaParams* t, const Params& p, int q_rows, int k_rows) {
  t->p = p;
  return tile_map(&t->q, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                  q_rows) &&
         tile_map(&t->o, p.dout, p.B, p.Sq, p.H, D, p.o_sb, p.o_ss, p.o_sh,
                  q_rows) &&
         tile_map(&t->k, p.k, p.B, p.Sk, p.H, D, p.k_sb, p.k_ss, p.k_sh,
                  k_rows) &&
         tile_map(&t->v, p.v, p.B, p.Sk, p.H, D, p.v_sb, p.v_ss, p.v_sh,
                  k_rows);
}

template <int D>
int launch_dkv(const Params& p, bool bf16_in, cudaStream_t s) {
  if (bf16_in) {
    TmaParams t;
    if (!tma_params<D>(&t, p, DkvTile<D>::BQ, ROWS)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(p.B * p.H, (p.Sk + ROWS - 1) / ROWS);
    return launch<TmaParams, flash_bwd_dkv_bf16_kernel<D>>(
        grid, WG_THREADS, DkvTile<D>::smem, t, s);
  }
  const size_t smem =
      sizeof(float) * (4 * T * (D + 1) + 2 * T * PS + 2 * T);
  const dim3 grid((p.Sk + T - 1) / T, p.B * p.H);
  return launch<Params, flash_bwd_dkv_kernel<D>>(grid, THREADS, smem, p, s);
}

template <int D>
int launch_dq(const Params& p, bool bf16_in, cudaStream_t s) {
  if (bf16_in) {
    TmaParams t;
    if (!tma_params<D>(&t, p, ROWS, DqTile<D>::BK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(p.B * p.H, (p.Sq + ROWS - 1) / ROWS);
    return launch<TmaParams, flash_bwd_dq_bf16_kernel<D>>(
        grid, WG_THREADS, DqTile<D>::smem, t, s);
  }
  const size_t smem = sizeof(float) * (4 * T * (D + 1) + T * PS + 2 * T);
  const dim3 grid((p.Sq + T - 1) / T, p.B * p.H);
  return launch<Params, flash_bwd_dq_kernel<D>>(grid, THREADS, smem, p, s);
}

int run(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int batch, int heads, int seq_q, int seq_k, int head_dim,
        const long long* strides, float sm_scale, int causal, int window,
        int sinks, int dtype, int device, void* stream, bool dkv) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
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
  const bool bf16_in = dtype == 1;
  switch (head_dim) {
    case 64:
      return dkv ? launch_dkv<64>(p, bf16_in, s) : launch_dq<64>(p, bf16_in, s);
    case 128:
      return dkv ? launch_dkv<128>(p, bf16_in, s)
                 : launch_dq<128>(p, bf16_in, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes. Each returns a cudaError_t (0 on
// success). dtype: 0 = float32, 1 = bfloat16. strides: the (batch, seq,
// head) strides of q, k, v and dout, in elements, twelve in all. bf16
// inputs need 16-byte aligned base pointers and strides (the wrapper
// checks).
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
