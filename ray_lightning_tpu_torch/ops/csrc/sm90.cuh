// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): the attention band, TMA copies into
// 128-byte swizzled bf16 tiles completing on mbarriers, wgmma descriptors
// and products (m64nNk16, bf16 in, fp32 accumulate), the accumulator's
// register layout, the bf16 epilogue, and the host side (a launch that
// raises the shared-memory limit once per kernel, tensor maps of strided
// (B, S, H, D) views). Everything lives in an anonymous namespace: each
// source that includes it gets its own copy.
//
// `Params` below is any struct with the fields Sq, Sk, causal, window and
// sinks (each kernel source has its own).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// band_allowed of ops/attention.py: col <= row, and with a window
// col > row - W or col < sinks.
template <class Params>
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  if (row >= p.Sq || col >= p.Sk) return false;
  if (!p.causal) return true;
  return col <= row &&
         (!p.window || col > row - p.window || col < p.sinks);
}

// True when every (row, col) of rows [r0, r0 + nr) x cols [c0, c0 + nc) is
// visible, so the tile needs no per-element mask.
template <class Params>
__device__ __forceinline__ bool tile_visible(const Params& p, int r0, int nr,
                                             int c0, int nc) {
  if (r0 + nr > p.Sq || c0 + nc > p.Sk) return false;
  if (!p.causal) return true;
  const int cmax = c0 + nc - 1;
  if (cmax > r0) return false;
  return !p.window || c0 > r0 + nr - 1 - p.window || cmax < p.sinks;
}

using bf16 = __nv_bfloat16;
constexpr int WG_THREADS = 128;  // one warpgroup per block
constexpr int ROWS = 64;         // rows of the tile a block owns (wgmma M)
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The tiles in shared memory have the 128-byte swizzled layout that TMA
// writes and wgmma reads: a (rows, D) tile is D/64 column blocks of
// (rows, 64), each row 128 bytes, with 16-byte chunk c of row r stored at
// chunk c ^ (r % 8). Every tile starts on a 1024-byte boundary (eight
// rows), where the swizzle repeats. The same tile serves as a K-major
// operand (rows = M or N, columns = K) and, with wgmma's transpose flag,
// as an MN-major one (rows = K).

// mbarriers: one thread arms a barrier with the bytes its TMA copies will
// deliver; every thread waits for the phase to complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// Wait for phase `parity` of `bar`. A copy that never lands (a fault in a
// tensor map) traps after about 2^24 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (int polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1 << 24)) __trap();
  }
}

// TMA copy of `rows` rows from `row0` of one (batch b, head h) slab of a
// (B, S, H, D) tensor into a swizzled tile, one 64-column box per column
// block; rows past the end arrive as zeros. Completes on `bar`.
template <int D>
__device__ __forceinline__ void tma_rows(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int h,
                                         int b, int rows) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(smem_addr(dst + cb * rows * 64)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(cb * 64), "r"(h),
        "r"(row0), "r"(b), "r"(smem_addr(bar))
        : "memory");
  }
}

// wgmma shared-memory descriptor of a 128-byte swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major: all rows of a `rows`-row tile, columns [16 ks, 16 ks + 16).
// Eight-row groups are 1024 bytes apart; a step of 16 columns inside a
// 64-column block moves the start by 32 bytes.
template <int rows>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int ks) {
  return smem_desc(tile + (ks / 4) * rows * 64 + (ks % 4) * 16, 16, 1024);
}
// MN-major: rows [16 ks, 16 ks + 16) of a `rows`-row tile as K, all D
// columns as N; the 64-column blocks are rows * 128 bytes apart.
template <int rows>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int ks) {
  return smem_desc(tile + ks * 16 * 64, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers at this point of the program: an accumulator behind the
// last wg_wait, so that no read of it is scheduled before the products that
// write it have landed; a product's register inputs ahead of wg_fence, so
// that no write of them is scheduled after it.
template <int N>
__device__ __forceinline__ void pin(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin_regs(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (64 x N, fp32, in the warpgroup's registers) += a * b over 16 columns
// of K. ss: a and b from shared memory (K-major both); rs: a from
// registers, b from shared memory read MN-major (transposed).
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout (per warp of the warpgroup, 16 rows from 16 * warp):
// element 4j + e lies in row acc_row(e) and column 8j + acc_col(e).
__device__ __forceinline__ int acc_row(int lane, int e) {
  return lane / 4 + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return 2 * (lane % 4) + (e & 1);
}

// The register A operand of columns [16k, 16k + 16) of an accumulator,
// `c` = its elements from 8k on, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// 2^x on the special-function unit (flushing subnormal results to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Write the warp's 16 rows of a 64 x D accumulator, rounded to bf16, as
// rows row0 + lane / 4 (and + 8) of head h, batch b of a contiguous
// (B, S, H, D) tensor; rows past S are not written.
template <int D>
__device__ __forceinline__ void store_rows(void* out, const float* acc,
                                           int S, int H, int b, int h,
                                           int row0, int lane) {
  bf16* o = static_cast<bf16*>(out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + acc_row(lane, 2 * half);
    if (row >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(o + off + j * 8 + acc_col(lane, 0)) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// The dynamic shared memory, rounded up to a 1024-byte boundary (the
// launch asks for 1024 bytes more).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
}

// Launch `Kernel`, raising its dynamic shared memory limit on the first
// call only (once per instantiation; the port drives one device per
// process): later calls reuse the first call's result.
template <typename Arg, void (*Kernel)(Arg)>
int launch(dim3 grid, int threads, size_t smem, const Arg& arg,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Kernel<<<grid, threads, smem, stream>>>(arg);
  // A launch refused for its shared memory or block size never runs, and a
  // later synchronize does not report it: read the launch error here.
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime's
// entry-point query (so the library needs no link against libcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA map of a strided (B, S, H, D) bf16 tensor, in boxes of `rows`
// rows x 64 columns of one (batch, head), 128-byte swizzled; the strides
// are in elements. False when the encoder refuses it (the wrapper has
// checked the 16-byte alignment it needs).
bool tile_map(CUtensorMap* map, const void* base, int B, int S, int H,
              int D, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
