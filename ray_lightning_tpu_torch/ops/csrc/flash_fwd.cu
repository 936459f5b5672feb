// Flash-attention forward for Hopper (sm_90a): online-softmax attention that
// never materialises the (Sq, Sk) score matrix in device memory.
//
// Replaces: ray_lightning_tpu/ops/flash_attention.py:_fwd_kernel (launched by
// _flash_fwd through pl.pallas_call), the TPU forward kernel K1.
//
// What bounds it on the H100. Two products of 2*D FLOPs per visible (query,
// key) pair (S = Q K^T, O += P V) against q, k, v read once and out, lse
// written once. At the training call (B=8, S=1024, H=12, D=64, bf16,
// causal) that is 12.9 GFLOP against 50.3 MB: 0.0130 ms at 989 TFLOP/s and
// 0.0151 ms at 3.35 TB/s, so the bound is the bytes (0.0151 ms). At the
// serving call (B=1, S=1024) it is 1.6 GFLOP against 6.3 MB, 0.0019 ms
// (bytes). In practice the limit is the SIMT work of the online softmax
// between the two products (max, exp2, sums, masking, rescale, packing:
// at D=64 one exp2 per 256 product FLOPs, and the special-function unit
// runs 1/256 of the tensor rate), serialised with them inside each block
// and overlapped only across the ~5 blocks an SM holds.
//
// The bf16 kernel (the path the serving prefill and the training step
// take): one warpgroup of 128 threads per 64-row query tile, warp w owning
// rows [16w, 16w + 16).
//   - Q is loaded once, K and V tiles of 64 keys stream by TMA (tensor maps
//     built per launch from the strided (batch, seq, head) views, so the
//     fused projection's slices are read in place) into a two-stage ring of
//     128-byte swizzled bf16 tiles whose mbarriers count the bytes; the next
//     tile's copies are issued before this tile's products.
//   - S = Q K^T by wgmma m64n64k16 from shared memory, fp32 accumulate.
//   - The online softmax runs in registers on the accumulator fragments:
//     each row's max and sum combine across the 4 lanes that hold it, the
//     scale goes into the exponent (p = exp2(s * scale * log2 e - m)), so Q
//     is never pre-scaled and rounded; alpha rescales O, skipped when no
//     row of the warp moved its max; l sums the fp32 p (per lane, combined
//     once at the end). Only tiles across the band's edge are masked, each
//     row by two column bounds worked out once per tile.
//   - O += P V by wgmma with P, rounded to bf16, packed from the score
//     accumulator as the register A operand, and V read MN-major from the
//     tile that arrived with K: P never touches shared memory.
//   - Causal blocks launch heaviest first (the last query tile sees the most
//     keys), so the grid ends on its lightest blocks.
//   - out = O / l in bf16 and lse = m * scale + log(l) in fp32, natural log.
// P is rounded to bf16 where it enters P V, as FlashAttention-2 does; sums
// stay fp32 and the output is rounded once. The shared building blocks
// (band tests, TMA, descriptors, wgmma, launch) are in sm90.cuh;
// tools/torch_flash_fwd_ablate.py times the pieces of the loop.
// Left for a later version: two consumer warpgroups in ping-pong, so that
// one's softmax overlaps the other's products, fed by a producer warp;
// persistent blocks. Overlapping the next tile's S product with this
// tile's softmax inside one warpgroup (a third stage, a second score
// buffer) and two warpgroups sharing each K/V tile without ping-pong were
// both slower at the training call on an H100, as was a 128-key tile: each
// costs registers or shared memory, and so blocks per SM.
//
// The fp32 kernel keeps the SIMT design: fp32 FMAs from padded fp32 tiles
// in shared memory, each thread a 4x8 register tile of scores and a
// 4x(D/8) tile of the output. The tensor cores would take fp32 only as
// TF32, whose 10-bit mantissa cannot meet the fp32 bar of 1e-4.
//
// Layout. q (B, Sq, H, D) and k, v (B, Sk, H, D) are read through their
// strides (the last dimension must be contiguous; in bf16 the base pointers
// and strides are 16-byte multiples, which the wrapper checks). o is
// written contiguous (B, Sq, H, D) in the input type and lse = m + log(l)
// as fp32 (B, H, Sq), without the TPU kernel's 8-lane pad.
//
// Both kernels walk key tiles of 64 columns: first the sink tiles that the
// band loop would not reach, then the band [first, end). Semantics follow
// K1 exactly: -inf masking, alpha = 0 while the running max is still -inf,
// p = 0 where the score is -inf, and a row with no visible key writes 0
// and lse -inf.

#include <limits.h>

#include "sm90.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// fp32: SIMT kernel.

constexpr int TQ = 64;          // query rows per block
constexpr int TK = 64;          // key columns per tile
constexpr int NTX = 8;          // threads across a tile's columns
constexpr int NTY = 16;         // threads across a tile's rows
constexpr int THREADS = NTX * NTY;
constexpr int RQ = TQ / NTY;    // rows held by one thread
constexpr int RK = TK / NTX;    // score columns held by one thread
constexpr int PS = TK + 1;      // padded row stride of the probability tile

template <int D>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < TQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    Qs[r * DP + d] =
        row < p.Sq ? q[row * p.q_ss + d] * p.sm_scale : 0.f;
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
      Ks[r * DP + d] = ok ? k[col * p.k_ss + d] : 0.f;
      Vs[r * D + d] = ok ? v[col * p.v_ss + d] : 0.f;
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

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= p.Sq) continue;
    // A row with no visible key has l == 0 and writes 0 (K1 :105).
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    float* orow =
        o + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < RD; ++j) orow[tx + NTX * j] = acc[i][j] / l_safe;
    if (tx == 0) {
      p.lse[static_cast<long long>(bh) * p.Sq + row] = m[i] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma, TMA).

constexpr int BK = 64;  // key columns per tile
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdTile {
  static constexpr size_t smem =
      sizeof(bf16) * (ROWS * D + 4 * BK * D) + 2 * sizeof(uint64_t) + 1024;
};

// The bf16 kernel's arguments: the TMA maps of q (boxes of ROWS rows), k
// and v (boxes of BK rows) beside the common parameters.
struct TmaParams {
  CUtensorMap q, k, v;
  Params p;
};

// One step of the online softmax on the score tile `s` (raw Q K^T) of the
// warp's rows row0 + lane / 4 (half 0) and + 8 (half 1) x BK key columns
// from c0. m2 is each row's running max in units of s * scale * log2 e, l
// the lane's part of the running sum. On return s holds p (fp32) and
// alpha the factor that rescales O and l (exactly 1 where the max did not
// move). MASK: the tile crosses the band's edge, so each element is
// checked (masked scores become -inf and give p = 0).
template <bool MASK>
__device__ __forceinline__ void online_softmax(const Params& p, float* s,
                                               float m2[2], float l[2],
                                               float alpha[2], int row0,
                                               int c0, int lane) {
  const float scale_log2 = p.sm_scale * LOG2E;
  // band_allowed for one row as bounds on the tile's column j (col c0 + j):
  // visible iff j <= hi and (j >= lo or j < sink). A row past Sq sees
  // nothing; without a window every column up to the diagonal is seen.
  int hi[2], lo[2], sink[2];
  if (MASK) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + acc_row(lane, 2 * half);
      const int last = p.causal ? min(row, p.Sk - 1) : p.Sk - 1;
      const bool band = p.causal && p.window;
      hi[half] = row < p.Sq ? last - c0 : -1;
      lo[half] = band ? row - p.window + 1 - c0 : INT_MIN;
      sink[half] = band ? p.sinks - c0 : INT_MIN;
    }
  }
  // Each row's max and sum over the thread's 16 values in four chains of
  // four, so the dependent steps are short.
  float mp[2][4];
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int c = 0; c < 4; ++c) mp[half][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      float& x = s[4 * j + e];
      const int col = j * 8 + acc_col(lane, e);
      if (MASK && !(col <= hi[half] &&
                    (col >= lo[half] || col < sink[half]))) {
        x = -INFINITY;
      }
      mp[half][j & 3] = fmaxf(mp[half][j & 3], x);
    }
  float m_new[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float t = fmaxf(fmaxf(mp[half][0], mp[half][1]),
                    fmaxf(mp[half][2], mp[half][3]));
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
    t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
    // The scale is positive (the wrapper checks), so the max of the scaled
    // scores is the scaled max. -inf - -inf is NaN: alpha is 0 while the
    // row has seen no visible key (K1 :80-83).
    m_new[half] = fmaxf(m2[half], t * scale_log2);
    alpha[half] = m2[half] == -INFINITY      ? 0.f
                  : m2[half] == m_new[half] ? 1.f
                                            : fast_exp2(m2[half] - m_new[half]);
    m2[half] = m_new[half];
  }
  float sp[2][4] = {};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1;
      float& x = s[4 * j + e];
      x = MASK && x == -INFINITY
              ? 0.f
              : fast_exp2(fmaf(x, scale_log2, -m_new[half]));
      sp[half][j & 3] += x;
    }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] = l[half] * alpha[half] +
              ((sp[half][0] + sp[half][1]) + (sp[half][2] + sp[half][3]));
  }
}

// One key tile into the block's running softmax state: S = Q K^T, the
// online softmax, O = O * alpha + P V. Qs is the (ROWS, D) query tile from
// row q0, Kb and Vb the (BK, D) key and value tiles from column c0; warp w
// owns rows q0 + 16w + [0, 16).
template <int D>
__device__ __forceinline__ void attend_tile(const Params& p, const bf16* Qs,
                                            const bf16* Kb, const bf16* Vb,
                                            float* o, float m2[2],
                                            float l[2], int q0, int c0,
                                            int lane, int w) {
  // S = Q K^T: 64 query rows x BK key columns.
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    wgmma_ss<BK>(s, desc_k<ROWS>(Qs, ks), desc_k<BK>(Kb, ks));
  }
  wg_commit();
  wg_wait();
  pin<BK / 2>(s);

  // P into s; only tiles across the band's edge mask.
  float alpha[2];
  if (tile_visible(p, q0, ROWS, c0, BK)) {
    online_softmax<false>(p, s, m2, l, alpha, q0 + 16 * w, c0, lane);
  } else {
    online_softmax<true>(p, s, m2, l, alpha, q0 + 16 * w, c0, lane);
  }
  // Rescale O unless no row of the warp moved its max (the vote keeps the
  // branch uniform over the warp).
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  }
  // P as bf16 A operands. The rescale and the packing are pinned ahead of
  // the fence: a register the products read must not be written after it.
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk);
  pin<D / 2>(o);
  pin_regs<BK / 4>(&pa[0][0]);

  // O += P V, the reduction over the BK keys: P is the register A operand,
  // V is read transposed from its (BK, D) tile.
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wgmma_rs<D>(o, pa[kk], desc_mn<BK>(Vb, kk));
  }
  wg_commit();
  wg_wait();
  pin<D / 2>(o);
}

// K1, bf16: one block (one warpgroup) per (64-row query tile, batch*head);
// warp w holds query rows [16w, 16w + 16).
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
    flash_fwd_bf16_kernel(const __grid_constant__ TmaParams t) {
  const Params& p = t.p;
  bf16* Qs = reinterpret_cast<bf16*>(smem_base());  // (ROWS, D)
  bf16* Ks = Qs + ROWS * D;                          // 2 x (BK, D)
  bf16* Vs = Ks + 2 * BK * D;                        // 2 x (BK, D)
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + 2 * BK * D);  // 2

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // Causal: the last query tile sees the most key tiles, so it launches
  // first (blockIdx.y = 0) and the grid ends on its lightest blocks.
  const int qt = p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS;

  // Loop bounds (K1 :42-58, :95-101), as in the fp32 kernel.
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
  if (n_visit > 0 && threadIdx.x == 0) {
    mbar_expect(&full[0], ROWS * D * sizeof(bf16) + tile_bytes);
    tma_rows<D>(Qs, &t.q, &full[0], q0, h, b, ROWS);
    load_key_tile(0, 0);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int r0 = w * 16;  // the warp's first query row in the tile
  for (int it = 0; it < n_visit; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_visit && threadIdx.x == 0) {
      mbar_expect(&full[buf ^ 1], tile_bytes);
      load_key_tile(it + 1, buf ^ 1);
    }
    mbar_wait(&full[buf], (it >> 1) & 1);
    const bf16* Kb = Ks + buf * BK * D;
    const bf16* Vb = Vs + buf * BK * D;
    attend_tile<D>(p, Qs, Kb, Vb, o, m2, l, q0, tile_col(it), lane, w);
    __syncthreads();  // buffer `buf` is refilled by the next iteration
  }

  // Each row's sum over its 4 lanes; a row with no visible key has l == 0
  // and writes 0 (K1 :105) and lse -inf.
  float l_safe[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x = l[half];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l_safe[half] = x == 0.f ? 1.f : x;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] /= l_safe[(i >> 1) & 1];
  store_rows<D>(p.o, o, p.Sq, p.H, b, h, q0 + r0, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + acc_row(lane, 2 * half);
      if (row < p.Sq) {
        p.lse[static_cast<long long>(bh) * p.Sq + row] =
            m2[half] * LN2 + logf(l_safe[half]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.

template <int D>
int launch_fwd(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == 1) {
    TmaParams t;
    t.p = p;
    if (!tile_map(&t.q, p.q, p.B, p.Sq, p.H, D, p.q_sb, p.q_ss, p.q_sh,
                  ROWS) ||
        !tile_map(&t.k, p.k, p.B, p.Sk, p.H, D, p.k_sb, p.k_ss, p.k_sh, BK) ||
        !tile_map(&t.v, p.v, p.B, p.Sk, p.H, D, p.v_sb, p.v_ss, p.v_sh, BK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(p.B * p.H, (p.Sq + ROWS - 1) / ROWS);
    return launch<TmaParams, flash_fwd_bf16_kernel<D>>(
        grid, WG_THREADS, FwdTile<D>::smem, t, stream);
  }
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * (TQ * (D + 1) + TK * (D + 1) + TK * D + TQ * PS);
    const dim3 grid((p.Sq + TQ - 1) / TQ, p.B * p.H);
    return launch<Params, flash_fwd_kernel<D>>(grid, THREADS, smem, p,
                                               stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point for ctypes. Returns a cudaError_t (0 on success).
// dtype: 0 = float32, 1 = bfloat16 (16-byte aligned base pointers and
// strides, sm_scale > 0: the wrapper checks).
extern "C" int rlt_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int seq_q, int seq_k, int head_dim,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float sm_scale, int causal, int window, int sinks, int dtype,
    int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
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
  switch (head_dim) {
    case 64: return launch_fwd<64>(p, dtype, s);
    case 128: return launch_fwd<128>(p, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
