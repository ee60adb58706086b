// Folded nearest-upsample x2 + Conv3D(3x3x3, SAME) + bias, for Hopper (sm_90a).
//
// Replaces the TPU kernel prdisagg_tpu/ops/pallas_upsample_conv.py::_make_kernel
// (launched by _upsample2_conv3_pallas_raw).  It computes the same function,
//
//   out[n, 2d+a, 2h+b, 2w+c, :] = bias
//       + sum_{p,q,r in {0,1}} x[n, d+a+p-1, h+b+q-1, w+c+r-1, :] @ K2[abc, pqr]
//
// where K2 (8 phases, 8 taps, Cin, Cout) is the 3^3 kernel folded per axis by
// phase_kernels() in ops/upsample_conv.py, and taps outside the input read 0.
// For each of the 8 output phases this is one implicit GEMM with
// M = B*D*H*W low-res positions, N = Cout and K = 8 taps * Cin.  Row m of A is
// the low-res position m = ((n*D + d)*H + h)*W + w, so the source row of a
// tap is m + od*H*W + oh*W + ow whenever the tap lies inside the input.
//
// Weights arrive packed K-major, kp (8 phases, Cout, 8*Cin) with
// k = tap*Cin + ci (pack_phase_kernels() in ops/upsample_conv.py).  Both GEMM
// operands then have K contiguous: the A rows (Cin is innermost in NDHWC) and
// the B rows.  One 16-byte cp.async chunk along K, one shared-memory layout
// and one wgmma descriptor serve both operands, with no transpose flag, and
// the f32 loop reads A and B the same way.
//
// What bounds it on this card.  A stage does 2*64*B*D*H*W*Cin*Cout FLOPs on
// B*D*H*W*Cin inputs and writes 8*B*D*H*W*Cout outputs: 64-128 FLOPs per
// byte at the flagship stages, above the f32 FMA ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so f32 is bound by its FMAs.  In bf16 the
// tensor cores' ridge is ~295 FLOP/byte, and the work per byte of HBM
// would be bound near the tensor-core peak; but one implicit GEMM per
// phase copies each input row into shared memory once per (phase, tap),
// 64 times, and each weight slice once per M tile, so the bf16 kernel is
// bound by the rate at which L2 fills shared memory (chip_smoke.py reports
// the bytes copied as tile_load_bytes).  The design keeps those copies
// 16 bytes wide and keeps the 8 phases of an M tile adjacent in the grid,
// so that the re-reads come from L2 and not from HBM.
//
// Three kernels, chosen by shape in Python (k1_plan in ops/upsample_conv.py):
//
// * k1_bf16_wgmma (bf16, Cin % 64 == 0, Cout % 64 == 0): per CTA a BM x BN
//   tile (128 x 128, 128 x 64 or 64 x 64; one warpgroup per 64 rows) of one
//   phase.  The reduction walks 8 taps x Cin/64 slices of BK = 64, so a slice
//   lies inside one tap and a row's mask is one test.  Each slice is a
//   BM x 64 im2col tile of A and a BN x 64 tile of B, 128 bytes per row,
//   copied with 16-byte cp.async (src-size 0 zero-fills a tap outside the
//   input) into a 4-stage ring laid out in the 128-byte swizzle that the
//   wgmma descriptor names.  Slices k+1 and k+2 load while wgmma
//   (m64nBNk16, f32 accumulators in registers) works on slice k, and
//   slice k's wgmma group stays in flight while slice k+1 is waited for.
//   TMA's tiled mode cannot do the masked row gather of A.  The epilogue
//   adds the bias in f32, rounds once to bf16 and stores bf16 pairs (the
//   widest unit of the accumulator layout) straight into the interleaved
//   (B, 2D, 2H, 2W, Cout) output.
// * k1_f32_fma (f32, Cin % 32 == 0, Cout % 64 == 0): exact f32 FMA (no TF32).
//   The same cp.async ring (3 stages of BK = 32) with rows padded to 36
//   floats, so the float4 reads of 4 rows (A) or 8 rows (B) by a warp fall on
//   distinct banks.  Each thread holds an 8 x 8 tile: per 4 reduction steps
//   it reads 16 float4 and issues 256 FMAs, so the loop is bound by FMAs, not
//   by shared-memory loads.
// * k1_general (either dtype, any widths): the simple kernel (128 x 64 tiles,
//   32-deep slices loaded synchronously, f32 FMA) for widths the two fast
//   kernels do not take, such as the smoke-test models' 8 channels.
//
// Both fast kernels put the phase on the fastest grid axis (block id =
// 8 * tile + phase), so the 8 phases of one M tile, which read the same input
// rows, run together while those rows are in L2.  The tile is chosen so
// that the grid fills the 132 SMs at the training batch.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.  A fast kernel's
// shared-memory limit is raised once per device, at its first launch there,
// so a launch inside a CUDA graph capture is the launch alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (n, d, h, w) of each row of an M tile; rows past M get d = -4, so every
// tap of theirs falls outside the input
__device__ __forceinline__ void tile_rows(int4* rows, int bm, long long m0,
                                          long long M, int D, int H, int W) {
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const long long m = m0 + r;
    int4 v = make_int4(0, -4, 0, 0);
    if (m < M) {
      long long t = m;
      v.w = (int)(t % W); t /= W;
      v.z = (int)(t % H); t /= H;
      v.y = (int)(t % D);
      v.x = (int)(t / D);
    }
    rows[r] = v;
  }
}

// where a tile's K slice reads: the tap's offsets and its first channel
struct Slice {
  int od, oh, ow, c0;
  long long shift;  // od*H*W + oh*W + ow: source row = m + shift
};

__device__ __forceinline__ Slice slice_of(int kt, int slices, int bk,
                                          int phase, int H, int W) {
  const int tap = kt / slices;
  Slice s;
  s.c0 = (kt - tap * slices) * bk;
  s.od = (phase >> 2) + (tap >> 2) - 1;
  s.oh = ((phase >> 1) & 1) + ((tap >> 1) & 1) - 1;
  s.ow = (phase & 1) + (tap & 1) - 1;
  s.shift = (long long)s.od * H * W + (long long)s.oh * W + s.ow;
  return s;
}

__device__ __forceinline__ bool tap_inside(int4 rc, const Slice& s, int D,
                                           int H, int W) {
  return (unsigned)(rc.y + s.od) < (unsigned)D &&
         (unsigned)(rc.z + s.oh) < (unsigned)H &&
         (unsigned)(rc.w + s.ow) < (unsigned)W;
}

// element offset of the output row of low-res position rc in phase `phase`
__device__ __forceinline__ size_t out_row(int4 rc, int phase, int D, int H,
                                          int W, int Cout) {
  const size_t pos =
      (((size_t)rc.x * 2 * D + 2 * rc.y + (phase >> 2)) * (2 * H) + 2 * rc.z +
       ((phase >> 1) & 1)) * (size_t)(2 * W) + 2 * rc.w + (phase & 1);
  return pos * Cout;
}

// ------------------------------------------------ bf16: wgmma tensor cores

namespace tc {

constexpr int BK = 64;        // bf16 per row of a slice: 128 bytes
constexpr int ROW = 128;      // bytes per smem row, one 128-byte swizzle row

constexpr int STAGES = 4;     // a 128 x 64 ring (96 KB) fits 2 CTAs per SM

template <int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * ROW + BM * 16 + 1024;  // + rows, + alignment
}

// 128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8); the
// 8-row atoms are 1024 bytes and 1024-aligned
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return row * ROW + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile in 128-byte swizzle:
// start address >> 4, leading byte offset 1 (unused for this layout),
// stride byte offset 1024 >> 4 (next 8-row atom), layout type 1 (B128)
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// m64nNk16 with A and B from shared memory (K-major, no transpose),
// D += A*B in f32 registers
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da,
                                          uint64_t db);
template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&d)[32], uint64_t da,
                                              uint64_t db) {
  wgmma_m64n64k16(d, da, db);
}
template <>
__device__ __forceinline__ void wgmma_k16<128>(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
k1_bf16_wgmma(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ kp,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
              int B, int D, int H, int W, int Cin, int Cout) {
  constexpr int THREADS = BM * 2;  // one warpgroup (128 threads) per 64 rows
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * BM * ROW;
  int4* rows = reinterpret_cast<int4*>(smem_raw + (base - raw) +
                                       STAGES * (BM + BN) * ROW);

  const int phase = blockIdx.x & 7;
  const long long tile = blockIdx.x >> 3;
  const int n_tiles = Cout / BN;
  const int n0 = (int)(tile % n_tiles) * BN;
  const long long m0 = (tile / n_tiles) * BM;
  const long long M = (long long)B * D * H * W;
  tile_rows(rows, BM, m0, M, D, H, W);
  __syncthreads();

  const int slices = Cin / BK;
  const int KT = 8 * slices;
  const size_t K8 = (size_t)8 * Cin;
  const __nv_bfloat16* kb = kp + ((size_t)phase * Cout + n0) * K8;

  auto load = [&](int kt, int slot) {
    const Slice s = slice_of(kt, slices, BK, phase, H, W);
    const uint32_t a_dst = a_ring + slot * BM * ROW;
#pragma unroll
    for (int it = 0; it < BM * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i >> 3, c = i & 7;
      const bool in = tap_inside(rows[r], s, D, H, W);
      const __nv_bfloat16* src =
          in ? x + (size_t)(m0 + r + s.shift) * Cin + s.c0 + c * 8 : x;
      cp_async16(a_dst + swz(r, c), src, in ? 16 : 0);
    }
    const uint32_t b_dst = b_ring + slot * BN * ROW;
#pragma unroll
    for (int it = 0; it < BN * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, n = i >> 3, c = i & 7;
      cp_async16(b_dst + swz(n, c), kb + n * K8 + (size_t)kt * BK + c * 8, 16);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const int wg = threadIdx.x >> 7;

  // the ring runs STAGES - 2 slices ahead: slot (kt + STAGES - 2) % STAGES
  // was last read by the wgmma of slice kt - 2, which has completed, since
  // one wgmma group (slice kt - 1) at most stays in flight
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of slice kt landed
    // make them visible to the async proxy that wgmma reads through
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // everyone's copies landed; wgmma kt-2 is done
    if (kt + STAGES - 2 < KT)
      load(kt + STAGES - 2, (kt + STAGES - 2) % STAGES);
    cp_async_commit();
    const int slot = kt % STAGES;
    const uint64_t da = desc(a_ring + slot * BM * ROW + wg * 64 * ROW);
    const uint64_t db = desc(b_ring + slot * BN * ROW);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)  // 16 bf16 = 32 bytes = 2 units of 16
      wgmma_k16<BN>(acc, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    // slice kt's products may run on while slice kt+1 is waited for
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  cp_async_wait<0>();

  // epilogue: accumulator register 4j + 2h + e of thread (warp, lane) holds
  // row warp*16 + lane/4 + 8h, column 8j + 2*(lane%4) + e
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (m0 + r < M) {
      __nv_bfloat16* dst = out + out_row(rows[r], phase, D, H, W, Cout) + n0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = 8 * j + 2 * (lane & 3);
        const float2 bb = *reinterpret_cast<const float2*>(bias + n0 + col);
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * h] + bb.x, acc[4 * j + 2 * h + 1] + bb.y);
      }
    }
  }
}

}  // namespace tc

// ------------------------------------------------------- f32: exact FMA

namespace fp32 {

constexpr int BK = 32;
constexpr int PITCH = BK + 4;  // floats per smem row: 4 consecutive rows
                               // start on distinct 16-byte bank groups
constexpr int STAGES = 3;

template <int BM, int BN>
constexpr int smem_bytes() {
  return STAGES * (BM + BN) * PITCH * 4 + BM * 16;
}

// the 256-thread 128 x 128 tile is held to 128 registers, so that two CTAs
// (16 warps) share an SM
template <int BM, int BN>
__global__ void __launch_bounds__((BM / 8) * (BN / 8),
                                  BM == 128 && BN == 128 ? 2 : 1)
k1_f32_fma(const float* __restrict__ x, const float* __restrict__ kp,
           const float* __restrict__ bias, float* __restrict__ out, int B,
           int D, int H, int W, int Cin, int Cout) {
  // thread (ty, tx) owns rows ty + TY*i and columns tx + TX*j, i, j < 8; a
  // warp spans 4 consecutive ty and 8 consecutive tx
  constexpr int TY = BM / 8, TX = BN / 8, THREADS = TY * TX, WX = TX / 8;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + STAGES * BM * PITCH;
  int4* rows = reinterpret_cast<int4*>(Bs + STAGES * BN * PITCH);

  const int phase = blockIdx.x & 7;
  const long long tile = blockIdx.x >> 3;
  const int n_tiles = Cout / BN;
  const int n0 = (int)(tile % n_tiles) * BN;
  const long long m0 = (tile / n_tiles) * BM;
  const long long M = (long long)B * D * H * W;
  tile_rows(rows, BM, m0, M, D, H, W);
  __syncthreads();

  const int slices = Cin / BK;
  const int KT = 8 * slices;
  const size_t K8 = (size_t)8 * Cin;
  const float* kb = kp + ((size_t)phase * Cout + n0) * K8;
  const uint32_t a_ring = smem_addr(As), b_ring = smem_addr(Bs);

  auto load = [&](int kt, int slot) {
    const Slice s = slice_of(kt, slices, BK, phase, H, W);
#pragma unroll
    for (int it = 0; it < BM * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, r = i >> 3, c = i & 7;
      const bool in = tap_inside(rows[r], s, D, H, W);
      const float* src =
          in ? x + (size_t)(m0 + r + s.shift) * Cin + s.c0 + c * 4 : x;
      cp_async16(a_ring + ((slot * BM + r) * PITCH + c * 4) * 4, src,
                 in ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < BN * 8 / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS, n = i >> 3, c = i & 7;
      cp_async16(b_ring + ((slot * BN + n) * PITCH + c * 4) * 4,
                 kb + n * K8 + (size_t)kt * BK + c * 4, 16);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const int tx = (warp % WX) * 8 + (lane & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt landed; everyone is done with slice kt-1
    if (kt + STAGES - 1 < KT)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int slot = kt % STAGES;
    const float* a = As + (slot * BM + ty) * PITCH;
    const float* b = Bs + (slot * BN + tx) * PITCH;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + i * TY * PITCH + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(b + j * TX * PITCH + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float bj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bj[j] = bias[n0 + tx + TX * j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + TY * i;
    if (m0 + r >= M) continue;
    float* dst = out + out_row(rows[r], phase, D, H, W, Cout) + n0 + tx;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[TX * j] = acc[i][j] + bj[j];
  }
}

}  // namespace fp32

// ------------------------------------- general: any widths, f32 FMA

namespace general {

constexpr int BM = 128;          // low-res positions per block
constexpr int BN = 64;           // output channels per block
constexpr int BK = 32;           // reduction slice staged in shared memory
constexpr int THREADS = 256;
constexpr int TM = 8;            // rows per thread
constexpr int TN = 4;            // columns per thread
constexpr int AS_STRIDE = BM + 4;  // keeps float4 reads aligned

static_assert(THREADS == (BM / TM) * (BN / TN), "thread tile mismatch");
static_assert(BK == 32, "the A loader maps one lane to one reduction index");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k1_general(const T* __restrict__ x, const T* __restrict__ kp,
           const float* __restrict__ bias, T* __restrict__ out,
           int B, int D, int H, int W, int Cin, int Cout) {
  __shared__ __align__(16) float As[BK][AS_STRIDE];  // input slice, k-major
  __shared__ __align__(16) float Bs[BK][BN];         // weight slice
  __shared__ long long row_n[BM];                     // per-row coordinates
  __shared__ int row_d[BM], row_h[BM], row_w[BM];

  const int phase = blockIdx.z;
  const int pa = phase >> 2, pb = (phase >> 1) & 1, pc = phase & 1;
  const long long M = (long long)B * D * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < M) {
      long long t = m;
      row_w[tid] = (int)(t % W); t /= W;
      row_h[tid] = (int)(t % H); t /= H;
      row_d[tid] = (int)(t % D);
      row_n[tid] = t / D;
    } else {
      row_n[tid] = 0;
      row_d[tid] = -4;  // every tap of a row past M falls outside
      row_h[tid] = 0;
      row_w[tid] = 0;
    }
  }
  __syncthreads();

  // A loader: lane = reduction index, warp = first row, stride 8 rows
  const int a_k = tid & 31;
  const int a_row0 = tid >> 5;
  // B loader: 4 consecutive channels at reduction rows b_k and b_k + 16
  const int b_c = (tid & 15) * 4;
  const int b_k = tid >> 4;
  // compute tile: rows ty*TM.., columns tx*TN..
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const size_t K8 = (size_t)8 * Cin;
  const T* k_phase = kp + (size_t)phase * Cout * K8;
  for (int tap = 0; tap < 8; ++tap) {
    // input offset of this tap: padded index (d + a + p) is input index - 1
    const int od = pa + (tap >> 2) - 1;
    const int oh = pb + ((tap >> 1) & 1) - 1;
    const int ow = pc + (tap & 1) - 1;
    const T* k_tap = k_phase + (size_t)tap * Cin;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int ci = c0 + a_k;
#pragma unroll 4
      for (int r = 0; r < BM / 8; ++r) {
        const int row = a_row0 + 8 * r;
        const int sd = row_d[row] + od;
        const int sh = row_h[row] + oh;
        const int sw = row_w[row] + ow;
        float v = 0.0f;
        if (ci < Cin && sd >= 0 && sd < D && sh >= 0 && sh < H && sw >= 0 &&
            sw < W) {
          const size_t pos =
              (((size_t)row_n[row] * D + sd) * H + sh) * (size_t)W + sw;
          v = to_float(x[pos * Cin + ci]);
        }
        As[a_k][row] = v;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = b_k + 16 * h;
        const int ck = c0 + kr;
        float w4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (ck < Cin) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int co = n0 + b_c + e;
            if (co < Cout) w4[e] = to_float(k_tap[co * K8 + ck]);
          }
        }
        *reinterpret_cast<float4*>(&Bs[kr][b_c]) =
            make_float4(w4[0], w4[1], w4[2], w4[3]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 a_hi =
            *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
        const float av[TM] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w,
                              a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        const float bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: bias, then store into the interleaved upsampled layout
  const int H2 = 2 * H, W2 = 2 * W, D2 = 2 * D;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = ty * TM + i;
    if (m0 + row >= M) break;
    const size_t opos =
        (((size_t)row_n[row] * D2 + 2 * row_d[row] + pa) * H2 +
         2 * row_h[row] + pb) * (size_t)W2 + 2 * row_w[row] + pc;
    T* dst = out + opos * Cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < Cout) dst[co] = from_float<T>(acc[i][j] + bias[co]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* kp, const void* bias, void* out, int B,
           int D, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const long long M = (long long)B * D * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN), 8);
  k1_general<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(kp),
      static_cast<const float*>(bias), static_cast<T*>(out), B, D, H, W, Cin,
      Cout);
  return (int)cudaGetLastError();
}

}  // namespace general

// ------------------------------------------------------------ launchers

unsigned fast_grid(int B, int D, int H, int W, int Cout, int bm, int bn) {
  const long long M = (long long)B * D * H * W;
  return (unsigned)(8 * (Cout / bn) * ((M + bm - 1) / bm));
}

// A kernel's dynamic shared-memory limit, raised with cudaFuncSetAttribute
// once per device (the attribute persists): one bit per device ordinal.
class SmemLimit {
 public:
  template <typename Kernel>
  cudaError_t ensure(Kernel kernel, int bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = 1ull << (dev & 63);
    if (devices_.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) devices_.fetch_or(bit, std::memory_order_release);
    return err;
  }

 private:
  std::atomic<uint64_t> devices_{0};
};

template <int BM, int BN>
int launch_bf16(const void* x, const void* kp, const void* bias, void* out,
                int B, int D, int H, int W, int Cin, int Cout,
                cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes<BM, BN>();
  static SmemLimit limit;
  cudaError_t err = limit.ensure(tc::k1_bf16_wgmma<BM, BN>, smem);
  if (err != cudaSuccess) return (int)err;
  tc::k1_bf16_wgmma<BM, BN>
      <<<fast_grid(B, D, H, W, Cout, BM, BN), BM * 2, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(kp),
          static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B,
          D, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_f32(const void* x, const void* kp, const void* bias, void* out,
               int B, int D, int H, int W, int Cin, int Cout,
               cudaStream_t stream) {
  constexpr int smem = fp32::smem_bytes<BM, BN>();
  static SmemLimit limit;
  cudaError_t err = limit.ensure(fp32::k1_f32_fma<BM, BN>, smem);
  if (err != cudaSuccess) return (int)err;
  fp32::k1_f32_fma<BM, BN>
      <<<fast_grid(B, D, H, W, Cout, BM, BN), (BM / 8) * (BN / 8), smem,
         stream>>>(static_cast<const float*>(x), static_cast<const float*>(kp),
                   static_cast<const float*>(bias), static_cast<float*>(out),
                   B, D, H, W, Cin, Cout);
  return (int)cudaGetLastError();
}

// one fast launch: the dtype's kernel at tile (bm, bn)
template <int BM, int BN>
int launch_tile(bool bf16, const void* x, const void* kp, const void* bias,
                void* out, int B, int D, int H, int W, int Cin, int Cout,
                cudaStream_t stream) {
  return bf16 ? launch_bf16<BM, BN>(x, kp, bias, out, B, D, H, W, Cin, Cout,
                                    stream)
              : launch_f32<BM, BN>(x, kp, bias, out, B, D, H, W, Cin, Cout,
                                   stream);
}

int launch_fast(bool bf16, const void* x, const void* kp, const void* bias,
                void* out, int B, int D, int H, int W, int Cin, int Cout,
                int bm, int bn, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (Cin % (bf16 ? tc::BK : fp32::BK) != 0 || Cout % bn != 0)
    return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_tile<128, 128>(bf16, x, kp, bias, out, B, D, H, W, Cin, Cout,
                              st);
  if (bm == 128 && bn == 64)
    return launch_tile<128, 64>(bf16, x, kp, bias, out, B, D, H, W, Cin, Cout,
                              st);
  if (bm == 64 && bn == 64)
    return launch_tile<64, 64>(bf16, x, kp, bias, out, B, D, H, W, Cin, Cout,
                              st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin); kp (8 phases, Cout, 8*Cin) of x's dtype, packed by
// pack_phase_kernels(); bias (Cout,) f32; out (B, 2D, 2H, 2W, Cout).  All
// contiguous on the current device.  The fast entries also need 16-byte
// aligned x, kp and bias, Cin % 64 == 0 (bf16) or % 32 == 0 (f32), and take
// the tile (bm, bn), one of 128 x 128, 128 x 64, 64 x 64, with Cout % bn == 0.
int prdisagg_upsample2_conv3_fast_bf16(const void* x, const void* kp,
                                       const void* bias, void* out, int B,
                                       int D, int H, int W, int Cin, int Cout,
                                       int bm, int bn, void* stream) {
  return launch_fast(true, x, kp, bias, out, B, D, H, W, Cin, Cout, bm, bn,
                     stream);
}

int prdisagg_upsample2_conv3_fast_f32(const void* x, const void* kp,
                                      const void* bias, void* out, int B,
                                      int D, int H, int W, int Cin, int Cout,
                                      int bm, int bn, void* stream) {
  return launch_fast(false, x, kp, bias, out, B, D, H, W, Cin, Cout, bm, bn,
                     stream);
}

int prdisagg_upsample2_conv3_general_f32(const void* x, const void* kp,
                                         const void* bias, void* out, int B,
                                         int D, int H, int W, int Cin,
                                         int Cout, void* stream) {
  return general::launch<float>(x, kp, bias, out, B, D, H, W, Cin, Cout,
                                (cudaStream_t)stream);
}

int prdisagg_upsample2_conv3_general_bf16(const void* x, const void* kp,
                                          const void* bias, void* out, int B,
                                          int D, int H, int W, int Cin,
                                          int Cout, void* stream) {
  return general::launch<__nv_bfloat16>(x, kp, bias, out, B, D, H, W, Cin,
                                        Cout, (cudaStream_t)stream);
}

const char* prdisagg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
