// Folded nearest-upsample x2 + Conv3D(3x3x3, SAME) + bias, for Hopper (sm_90a),
// and its gradients (the backward section, further down).
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

// =========================================== backward: dx and dkernel
//
// Replaces the backward of the TPU kernel's custom_vjp,
// prdisagg_tpu/ops/pallas_upsample_conv.py:99-108 (_bwd: XLA's autodiff of
// the phase form), and the port's earlier route for it, 8 phases x 3
// cuDNN convolution_backward calls a pass with layout copies around them
// (upsample2_conv3_backward in ops/upsample_conv.py, now the plain version).
//
// What bounds it on this card: dx and dk are each one forward's FLOPs,
// 2 * 64*B*D*H*W*Cin*Cout, on x, g and the weights: in bf16 that is
// operation-bound (about 0.085 ms for the three training stages at B 32,
// against 0.022 ms of bytes).  At that batch the GEMMs are too small to
// fill the card unsplit, and the reduction passes, the masked gathers
// and the launches take the time; the design answers with the split
// reductions below and with operands read in place, never transposed.
//
// Per axis, the forward's out[2d'+a] reads x[d'+a+p-1] through K2[a, p], so
// low-res index d feeds the full-res output 2d+u, u = 2-j, j = 2p+a in 0..3:
// offset j holds K2[a, p].
//
// dx: one implicit GEMM, M = B*D*H*W low-res positions, N = Cin,
// K = 64 offsets (u, v, t) x Cout.  Row m gathers the cotangent rows
// g[n, 2d+u, 2h+v, 2w+t] (zero outside the full-res grid): relative to the
// row of (2d, 2h, 2w) that is one shift per offset, so a row's mask is one
// test per reduction slice.  The weights are packed K-major as
// wb (Cin, 64*Cout), k = off*Cout + co, off = 16*j_d + 4*j_h + j_w, a
// permutation of the forward's packing (pack_backward_kernels() in
// ops/upsample_conv.py).
//
// dk: per phase (a, b, c) one GEMM, M = 8 taps x Cin, N = Cout,
// K = B*D*H*W positions: A[(tap, ci), m] = x[m + shift(phase, tap), ci]
// (zero outside the input) and B[m, co] = g[(2d+a, 2h+b, 2w+c) of m, co].
// Along the reduction both operands are strided rows whose contiguous axis
// is M (Cin) or N (Cout), so the bf16 kernel feeds wgmma MN-major tiles
// (the instruction's transpose bits) instead of transposing anything.
// The 8 x 8 phase-tap gradients are folded onto the 3^3 kernel by the
// adjoint of phase_kernels() in k1_dk_fold.
//
// Split-K.  At the training batch the grids are small (dx at stage 0 is
// 6 tiles of 128 x 128; dk at stage 2 is 64), so each GEMM's reduction
// slices are cut into `splits` contiguous ranges, one CTA each, chosen by
// k1_backward_plan() so that the grid fills the 132 SMs.  Every CTA writes
// its f32 partial tile to a workspace the wrapper allocates; a second
// kernel sums the partials in split order (k1_dx_reduce: and rounds once to
// x's dtype; k1_dk_fold: and folds).  No atomics: the gradients are the
// same bits on every run.  dx with one split stores x's dtype directly.

namespace bwd {

// the reduction slices [kt0, kt1) of split s of `splits`: contiguous,
// disjoint, covering [0, KT); mirrored by split_range() in Python
__device__ __forceinline__ void split_range(int KT, int splits, int s,
                                            int& kt0, int& kt1) {
  kt0 = (int)((long long)KT * s / splits);
  kt1 = (int)((long long)KT * (s + 1) / splits);
}

// (2d, 2h, 2w, cotangent row of (n, 2d, 2h, 2w)) of each row of a dx tile;
// rows past M get 2d = -8, so every offset of theirs falls outside
__device__ __forceinline__ void dx_rows(int4* rows, int bm, long long m0,
                                        long long M, int D, int H, int W) {
  for (int r = threadIdx.x; r < bm; r += blockDim.x) {
    const long long m = m0 + r;
    int4 v = make_int4(-8, 0, 0, 0);
    if (m < M) {
      long long t = m;
      const int w = (int)(t % W); t /= W;
      const int h = (int)(t % H); t /= H;
      const int d = (int)(t % D);
      const long long n = t / D;
      v = make_int4(2 * d, 2 * h, 2 * w,
                    (int)(((n * 2 * D + 2 * d) * 2 * H + 2 * h) * 2 * W +
                          2 * w));
    }
    rows[r] = v;
  }
}

// where a dx reduction slice reads: its offset, first channel, and the row
// shift u*(2H*2W) + v*2W + t from the row of (2d, 2h, 2w)
struct DxSlice {
  int off, u, v, t, c0, shift;
};

__device__ __forceinline__ DxSlice dx_slice(int kt, int slices, int bk,
                                            int H, int W) {
  DxSlice s;
  s.off = kt / slices;
  s.c0 = (kt - s.off * slices) * bk;
  s.u = 2 - (s.off >> 4);
  s.v = 2 - ((s.off >> 2) & 3);
  s.t = 2 - (s.off & 3);
  s.shift = (s.u * 2 * H + s.v) * 2 * W + s.t;
  return s;
}

__device__ __forceinline__ bool dx_inside(int4 rc, const DxSlice& s, int D,
                                          int H, int W) {
  return (unsigned)(rc.x + s.u) < (unsigned)(2 * D) &&
         (unsigned)(rc.y + s.v) < (unsigned)(2 * H) &&
         (unsigned)(rc.z + s.t) < (unsigned)(2 * W);
}

// cotangent row of low-res position (n, d, h, w) in phase `phase`
__device__ __forceinline__ int g_row(long long n, int d, int h, int w,
                                     int phase, int D, int H, int W) {
  return (int)(((n * 2 * D + 2 * d + (phase >> 2)) * 2 * H + 2 * h +
                ((phase >> 1) & 1)) * 2 * W + 2 * w + (phase & 1));
}

// a dk reduction row (position p): the input row its tap reads (-1 outside
// the input) and its cotangent row (-1 past M)
__device__ __forceinline__ int2 dk_info(long long p, long long M, int D,
                                        int H, int W, int phase,
                                        const Slice& s) {
  if (p >= M) return make_int2(-1, -1);
  long long t = p;
  const int w = (int)(t % W); t /= W;
  const int h = (int)(t % H); t /= H;
  const int d = (int)(t % D);
  const long long n = t / D;
  const bool in = (unsigned)(d + s.od) < (unsigned)D &&
                  (unsigned)(h + s.oh) < (unsigned)H &&
                  (unsigned)(w + s.ow) < (unsigned)W;
  return make_int2(in ? (int)(p + s.shift) : -1,
                   g_row(n, d, h, w, phase, D, H, W));
}

// the partials of `splits` splits summed in split order, rounded once
template <typename T>
__global__ void __launch_bounds__(256)
k1_dx_reduce(const float* __restrict__ part, T* __restrict__ dx, long long n,
             int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    dx[i] = general::from_float<T>(s);
  }
}

// dk[i, j, l, ci, co] = sum over splits, then over the 2 (phase, tap) pairs
// of each axis that fold onto index i (the adjoint of phase_kernels()):
// i = 0: (0,0), (1,0); i = 1: (0,1), (1,0); i = 2: (0,1), (1,1)
__device__ __forceinline__ int fold_tap(int i, int pair) {
  return i == 0 ? 0 : (i == 2 ? 1 : 1 - pair);
}

__global__ void __launch_bounds__(256)
k1_dk_fold(const float* __restrict__ part, float* __restrict__ dk, int Cin,
           int Cout, int splits) {
  const long long cc = (long long)Cin * Cout;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < 27 * cc; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i % cc;
    const int ijl = (int)(i / cc);
    const int ai = ijl / 9, bi = (ijl / 3) % 3, ci = ijl % 3;
    float s = 0.0f;
    for (int k = 0; k < splits; ++k)
      for (int x = 0; x < 8; ++x) {
        // pair x: phase (a, b, c) = bits of x, taps from fold_tap
        const int a = x >> 2, b = (x >> 1) & 1, c = x & 1;
        const int tap = fold_tap(ai, a) * 4 + fold_tap(bi, b) * 2 +
                        fold_tap(ci, c);
        s += part[((long long)(k * 8 + x) * 8 + tap) * cc + e];
      }
    dk[i] = s;
  }
}

}  // namespace bwd

// -------------------------------------- backward, bf16: wgmma tensor cores

namespace tc {

// dx: k1_bf16_wgmma's machinery (4-stage 16-byte cp.async ring, 128-byte
// swizzle, K-major operands, m64nBNk16) on the gathered cotangent rows,
// over the split's range of the 64 * Cout/64 reduction slices
template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
k1_dx_bf16_wgmma(const __nv_bfloat16* __restrict__ g,
                 const __nv_bfloat16* __restrict__ wb,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ part,
                 int B, int D, int H, int W, int Cin, int Cout, int splits) {
  constexpr int THREADS = BM * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * BM * ROW;
  int4* rows = reinterpret_cast<int4*>(smem_raw + (base - raw) +
                                       STAGES * (BM + BN) * ROW);

  const int split = blockIdx.x % splits;
  const long long tile = blockIdx.x / splits;
  const int n_tiles = Cin / BN;
  const int n0 = (int)(tile % n_tiles) * BN;
  const long long m0 = (tile / n_tiles) * BM;
  const long long M = (long long)B * D * H * W;
  bwd::dx_rows(rows, BM, m0, M, D, H, W);
  __syncthreads();

  const int slices = Cout / BK;
  int kt0, kt1;
  bwd::split_range(64 * slices, splits, split, kt0, kt1);
  const int KT = kt1 - kt0;
  const size_t K64 = (size_t)64 * Cout;
  const __nv_bfloat16* kb = wb + (size_t)n0 * K64;

  auto load = [&](int i, int slot) {
    const int kt = kt0 + i;
    const bwd::DxSlice s = bwd::dx_slice(kt, slices, BK, H, W);
    const uint32_t a_dst = a_ring + slot * BM * ROW;
#pragma unroll
    for (int it = 0; it < BM * 8 / THREADS; ++it) {
      const int j = threadIdx.x + it * THREADS, r = j >> 3, c = j & 7;
      const int4 rc = rows[r];
      const bool in = bwd::dx_inside(rc, s, D, H, W);
      const __nv_bfloat16* src =
          in ? g + (size_t)(rc.w + s.shift) * Cout + s.c0 + c * 8 : g;
      cp_async16(a_dst + swz(r, c), src, in ? 16 : 0);
    }
    const uint32_t b_dst = b_ring + slot * BN * ROW;
#pragma unroll
    for (int it = 0; it < BN * 8 / THREADS; ++it) {
      const int j = threadIdx.x + it * THREADS, n = j >> 3, c = j & 7;
      cp_async16(b_dst + swz(n, c), kb + n * K64 + (size_t)kt * BK + c * 8,
                 16);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  const int wg = threadIdx.x >> 7;

  // the forward's ring: STAGES - 2 slices ahead, one wgmma group in flight
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < KT; ++i) {
    cp_async_wait<STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + STAGES - 2 < KT) load(i + STAGES - 2, (i + STAGES - 2) % STAGES);
    cp_async_commit();
    const int slot = i % STAGES;
    const uint64_t da = desc(a_ring + slot * BM * ROW + wg * 64 * ROW);
    const uint64_t db = desc(b_ring + slot * BN * ROW);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      wgmma_k16<BN>(acc, da + 2 * k, db + 2 * k);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  cp_async_wait<0>();

  // register 4j + 2h + e: row warp*16 + lane/4 + 8h, column 8j + 2*(lane%4) + e
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane & 3);
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (splits == 1)
        *reinterpret_cast<__nv_bfloat162*>(dx + m * Cin + col) =
            __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(part + ((long long)split * M + m) * Cin +
                                   col) = make_float2(v0, v1);
    }
  }
}

// the descriptor of an MN-major tile: both byte offsets 1024, so that the
// 8-row step along K is right whichever field the hardware reads it from
// (the other one, the step between 64-wide blocks, is never used)
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// dk's tiles are MN-major: a slice is DK_BK = 64 positions (k rows); each
// k row holds 64-element (128-byte) blocks of the contiguous axis, stored
// block by block, every block a column of 8-row, 1024-byte swizzle atoms.
// Each wgmma reads one 64-wide block (desc_mn()), so only the step from
// one 8-row group of k to the next, 1024 bytes, is ever taken.
constexpr int DK_BK = 64;

template <int BM, int BN>
constexpr int dk_smem_bytes() {
  return STAGES * (BM + BN) * ROW + STAGES * DK_BK * 8 + 1024;  // + info
}

__device__ __forceinline__ uint32_t swz_mn(int r, int c) {
  return (c >> 3) * (DK_BK * ROW) + swz(r, c & 7);
}

// m64n64k16 with both operands MN-major (transpose bits set)
__device__ __forceinline__ void wgmma_m64n64k16_mn(float (&d)[32],
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
      "%32, %33, p, 1, 1, 1, 1;\n"
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

// per CTA: one phase, BM rows of (tap, ci) inside one tap (Cin % BM == 0),
// BN output channels, one split of the positions; one warpgroup per 64 rows
template <int BM, int BN>
__global__ void __launch_bounds__(BM * 2)
k1_dk_bf16_wgmma(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ g, float* __restrict__ part,
                 int B, int D, int H, int W, int Cin, int Cout, int splits) {
  constexpr int THREADS = BM * 2, NB = BN / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + STAGES * BM * ROW;
  int2* info = reinterpret_cast<int2*>(smem_raw + (base - raw) +
                                       STAGES * (BM + BN) * ROW);

  const int phase = blockIdx.x & 7;
  long long rest = blockIdx.x >> 3;
  const int split = (int)(rest % splits);
  rest /= splits;
  const int n_tiles = Cout / BN;
  const int n0 = (int)(rest % n_tiles) * BN;
  const int mrow0 = (int)(rest / n_tiles) * BM;  // on the (tap, ci) axis
  const int tap = mrow0 / Cin, ci0 = mrow0 - tap * Cin;
  const Slice tp = slice_of(tap, 1, 0, phase, H, W);
  const long long M = (long long)B * D * H * W;
  int kt0, kt1;
  bwd::split_range((int)((M + DK_BK - 1) / DK_BK), splits, split, kt0, kt1);
  const int KT = kt1 - kt0;

  // the rows of local slice i, in the info ring's slot i % STAGES
  auto fill_info = [&](int i) {
    if (threadIdx.x < DK_BK)
      info[(i % STAGES) * DK_BK + threadIdx.x] =
          i < KT ? bwd::dk_info((long long)(kt0 + i) * DK_BK + threadIdx.x,
                                M, D, H, W, phase, tp)
                 : make_int2(-1, -1);
  };
  auto load = [&](int i, int slot) {
    const int2* inf = info + slot * DK_BK;
    const uint32_t a_dst = a_ring + slot * BM * ROW;
#pragma unroll
    for (int it = 0; it < DK_BK * (BM / 8) / THREADS; ++it) {
      const int j = threadIdx.x + it * THREADS;
      const int r = j / (BM / 8), c = j % (BM / 8);
      const int a = inf[r].x;
      const __nv_bfloat16* src =
          a >= 0 ? x + (size_t)a * Cin + ci0 + c * 8 : x;
      cp_async16(a_dst + swz_mn(r, c), src, a >= 0 ? 16 : 0);
    }
    const uint32_t b_dst = b_ring + slot * BN * ROW;
#pragma unroll
    for (int it = 0; it < DK_BK * (BN / 8) / THREADS; ++it) {
      const int j = threadIdx.x + it * THREADS;
      const int r = j / (BN / 8), c = j % (BN / 8);
      const int gr = inf[r].y;
      const __nv_bfloat16* src =
          gr >= 0 ? g + (size_t)gr * Cout + n0 + c * 8 : g;
      cp_async16(b_dst + swz_mn(r, c), src, gr >= 0 ? 16 : 0);
    }
  };

  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
  const int wg = threadIdx.x >> 7;

  // the info ring runs one slice ahead of the loads: slice i's rows are
  // written in iteration i - 3 (or before the loop) and read by its load in
  // iteration i - 2, after that iteration's barrier
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fill_info(s);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < KT; ++i) {
    cp_async_wait<STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + STAGES - 2 < KT) load(i + STAGES - 2, (i + STAGES - 2) % STAGES);
    cp_async_commit();
    fill_info(i + STAGES - 1);
    const int slot = i % STAGES;
    const uint32_t a_tile = a_ring + slot * BM * ROW + wg * DK_BK * ROW;
    const uint32_t b_tile = b_ring + slot * BN * ROW;
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < DK_BK / 16; ++k) {  // 16 k rows = two 1024-byte atoms
      const uint64_t da = desc_mn(a_tile + k * 2048);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_m64n64k16_mn(acc[j], da,
                           desc_mn(b_tile + j * DK_BK * ROW + k * 2048));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
  cp_async_wait<0>();

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float* out = part + (((size_t)split * 8 + phase) * 8 * Cin + mrow0) * Cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = n0 + j * 64 + 8 * q + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + (size_t)r * Cout + col) =
            make_float2(acc[j][4 * q + 2 * h], acc[j][4 * q + 2 * h + 1]);
      }
  }
}

}  // namespace tc

// -------------------------- backward, FMA: f32 (vectorised) and any width

namespace bfma {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;  // 4 x 4 a thread
constexpr int PITCH = 68;  // floats per smem row; keeps float4 reads aligned

using general::from_float;
using general::to_float;

// dx in exact FMA.  VEC (f32, Cin % 64 == 0, Cout % 16 == 0, 16-byte
// aligned operands): float4 loads with one mask per row; otherwise scalar
// loads masked by element, for any widths.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
k1_dx_fma(const T* __restrict__ g, const T* __restrict__ wb,
          T* __restrict__ dx, float* __restrict__ part, int B, int D, int H,
          int W, int Cin, int Cout, int splits) {
  __shared__ __align__(16) float As[BK][PITCH];  // [k][row]
  __shared__ __align__(16) float Bs[BK][PITCH];  // [k][ci]
  __shared__ int4 rows[BM];

  const int split = blockIdx.x % splits;
  const long long tile = blockIdx.x / splits;
  const int n_tiles = (Cin + BN - 1) / BN;
  const int n0 = (int)(tile % n_tiles) * BN;
  const long long m0 = (tile / n_tiles) * BM;
  const long long M = (long long)B * D * H * W;
  bwd::dx_rows(rows, BM, m0, M, D, H, W);
  __syncthreads();

  const int slices = (Cout + BK - 1) / BK;
  int kt0, kt1;
  bwd::split_range(64 * slices, splits, split, kt0, kt1);
  const size_t K64 = (size_t)64 * Cout;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};

  for (int kt = kt0; kt < kt1; ++kt) {
    const bwd::DxSlice s = bwd::dx_slice(kt, slices, BK, H, W);
    const size_t wk = (size_t)s.off * Cout + s.c0;  // packed k of the slice
    if constexpr (VEC) {
      const int r = tid >> 2, q = (tid & 3) * 4;
      const int4 rc = rows[r];
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (bwd::dx_inside(rc, s, D, H, W))
        v = *reinterpret_cast<const float4*>(
            g + (size_t)(rc.w + s.shift) * Cout + s.c0 + q);
      As[q][r] = v.x; As[q + 1][r] = v.y; As[q + 2][r] = v.z;
      As[q + 3][r] = v.w;
      const float4 b = *reinterpret_cast<const float4*>(
          wb + (size_t)(n0 + r) * K64 + wk + q);
      Bs[q][r] = b.x; Bs[q + 1][r] = b.y; Bs[q + 2][r] = b.z;
      Bs[q + 3][r] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < BM * BK / THREADS; ++e) {
        const int i = tid + e * THREADS, r = i / BK, kk = i % BK;
        const int co = s.c0 + kk;
        const int4 rc = rows[r];
        As[kk][r] = co < Cout && bwd::dx_inside(rc, s, D, H, W)
                        ? to_float(g[(size_t)(rc.w + s.shift) * Cout + co])
                        : 0.0f;
        const int ci = n0 + r;
        Bs[kk][r] = co < Cout && ci < Cin
                        ? to_float(wb[(size_t)ci * K64 + wk + kk])
                        : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = n0 + tx * 4 + j;
      if (ci >= Cin) continue;
      if (splits == 1)
        dx[m * Cin + ci] = from_float<T>(acc[i][j]);
      else
        part[((long long)split * M + m) * Cin + ci] = acc[i][j];
    }
  }
}

// dk in exact FMA: per CTA one phase, 64 rows of (tap, ci) (VEC: inside one
// tap, Cin % 64 == 0, Cout % 64 == 0, float4 loads; otherwise rows may
// straddle taps and loads are scalar), 64 output channels, one split of
// the positions in slices of BK
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
k1_dk_fma(const T* __restrict__ x, const T* __restrict__ g,
          float* __restrict__ part, int B, int D, int H, int W, int Cin,
          int Cout, int splits) {
  __shared__ __align__(16) float As[BK][PITCH];  // [position][(tap, ci)]
  __shared__ __align__(16) float Bs[BK][PITCH];  // [position][co]
  __shared__ int4 pos[BK];                       // (d, h, w, p) of a row
  __shared__ int grow[BK];                       // its cotangent row

  const int phase = blockIdx.x & 7;
  long long rest = blockIdx.x >> 3;
  const int split = (int)(rest % splits);
  rest /= splits;
  const int n_tiles = (Cout + BN - 1) / BN;
  const int n0 = (int)(rest % n_tiles) * BN;
  const int mrow0 = (int)(rest / n_tiles) * BM;
  const long long M = (long long)B * D * H * W;
  int kt0, kt1;
  bwd::split_range((int)((M + BK - 1) / BK), splits, split, kt0, kt1);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};

  for (int kt = kt0; kt < kt1; ++kt) {
    if (tid < BK) {
      const long long p = (long long)kt * BK + tid;
      int4 v = make_int4(-4, 0, 0, 0);  // past M: every tap falls outside
      int gr = -1;
      if (p < M) {
        long long t = p;
        v.z = (int)(t % W); t /= W;
        v.y = (int)(t % H); t /= H;
        v.x = (int)(t % D);
        v.w = (int)p;
        gr = bwd::g_row(t / D, v.x, v.y, v.z, phase, D, H, W);
      }
      pos[tid] = v;
      grow[tid] = gr;
    }
    __syncthreads();
    if constexpr (VEC) {
      const int r = tid >> 4, q = (tid & 15) * 4;
      const int tap = mrow0 / Cin;
      const Slice s = slice_of(tap, 1, 0, phase, H, W);
      const int4 pv = pos[r];
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tap_inside(make_int4(0, pv.x, pv.y, pv.z), s, D, H, W))
        a = *reinterpret_cast<const float4*>(
            x + (size_t)(pv.w + s.shift) * Cin + (mrow0 - tap * Cin) + q);
      *reinterpret_cast<float4*>(&As[r][q]) = a;
      float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (grow[r] >= 0)
        b = *reinterpret_cast<const float4*>(g + (size_t)grow[r] * Cout +
                                             n0 + q);
      *reinterpret_cast<float4*>(&Bs[r][q]) = b;
    } else {
#pragma unroll
      for (int e = 0; e < BM * BK / THREADS; ++e) {
        const int i = tid + e * THREADS, r = i / BM, c = i % BM;
        const int mrow = mrow0 + c;
        const int4 pv = pos[r];
        float a = 0.0f;
        if (mrow < 8 * Cin) {
          const int tap = mrow / Cin;
          const Slice s = slice_of(tap, 1, 0, phase, H, W);
          if (tap_inside(make_int4(0, pv.x, pv.y, pv.z), s, D, H, W))
            a = to_float(x[(size_t)(pv.w + s.shift) * Cin + mrow - tap * Cin]);
        }
        As[r][c] = a;
        const int co = n0 + c;
        Bs[r][c] = grow[r] >= 0 && co < Cout
                       ? to_float(g[(size_t)grow[r] * Cout + co])
                       : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = part + ((size_t)split * 8 + phase) * 8 * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mrow = mrow0 + ty * 4 + i;
    if (mrow >= 8 * Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < Cout) out[(size_t)mrow * Cout + co] = acc[i][j];
    }
  }
}

}  // namespace bfma

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

// ----------------------------------------------------- backward launchers

// A split count must leave every split at least one slice.
bool bad_splits(int splits, long long slices) {
  return splits < 1 || splits > slices;
}

template <int BM, int BN>
int launch_dx_bf16(const void* g, const void* wb, void* dx, void* part,
                   int B, int D, int H, int W, int Cin, int Cout, int splits,
                   cudaStream_t stream) {
  constexpr int smem = tc::smem_bytes<BM, BN>();
  static SmemLimit limit;
  cudaError_t err = limit.ensure(tc::k1_dx_bf16_wgmma<BM, BN>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * D * H * W;
  tc::k1_dx_bf16_wgmma<BM, BN>
      <<<(unsigned)(((M + BM - 1) / BM) * (Cin / BN) * splits), BM * 2, smem,
         stream>>>(static_cast<const __nv_bfloat16*>(g),
                   static_cast<const __nv_bfloat16*>(wb),
                   static_cast<__nv_bfloat16*>(dx), static_cast<float*>(part),
                   B, D, H, W, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

template <int BM, int BN>
int launch_dk_bf16(const void* x, const void* g, void* part, int B, int D,
                   int H, int W, int Cin, int Cout, int splits,
                   cudaStream_t stream) {
  constexpr int smem = tc::dk_smem_bytes<BM, BN>();
  static SmemLimit limit;
  cudaError_t err = limit.ensure(tc::k1_dk_bf16_wgmma<BM, BN>, smem);
  if (err != cudaSuccess) return (int)err;
  tc::k1_dk_bf16_wgmma<BM, BN>
      <<<(unsigned)(8 * (8 * Cin / BM) * (Cout / BN) * splits), BM * 2, smem,
         stream>>>(static_cast<const __nv_bfloat16*>(x),
                   static_cast<const __nv_bfloat16*>(g),
                   static_cast<float*>(part), B, D, H, W, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

int launch_dx_fast_bf16(const void* g, const void* wb, void* dx, void* part,
                        int B, int D, int H, int W, int Cin, int Cout, int bm,
                        int bn, int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (Cout % tc::BK != 0 || bm != 128 || (bn != 128 && bn != 64) ||
      Cin % bn != 0 || bad_splits(splits, 64LL * (Cout / tc::BK)))
    return (int)cudaErrorInvalidValue;
  return bn == 128 ? launch_dx_bf16<128, 128>(g, wb, dx, part, B, D, H, W,
                                              Cin, Cout, splits, st)
                   : launch_dx_bf16<128, 64>(g, wb, dx, part, B, D, H, W,
                                             Cin, Cout, splits, st);
}

int launch_dk_fast_bf16(const void* x, const void* g, void* part, int B,
                        int D, int H, int W, int Cin, int Cout, int bm,
                        int bn, int splits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long M = (long long)B * D * H * W;
  if ((bm != 128 && bm != 64) || (bn != 128 && bn != 64) || Cin % bm != 0 ||
      Cout % bn != 0 ||
      bad_splits(splits, (M + tc::DK_BK - 1) / tc::DK_BK))
    return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_dk_bf16<128, 128>(x, g, part, B, D, H, W, Cin, Cout, splits,
                                    st);
  if (bm == 128)
    return launch_dk_bf16<128, 64>(x, g, part, B, D, H, W, Cin, Cout, splits,
                                   st);
  if (bn == 128)
    return launch_dk_bf16<64, 128>(x, g, part, B, D, H, W, Cin, Cout, splits,
                                   st);
  return launch_dk_bf16<64, 64>(x, g, part, B, D, H, W, Cin, Cout, splits,
                                st);
}

template <typename T, bool VEC>
int launch_dx_fma(const void* g, const void* wb, void* dx, void* part, int B,
                  int D, int H, int W, int Cin, int Cout, int bm, int bn,
                  int splits, void* stream) {
  using namespace bfma;
  const long long M = (long long)B * D * H * W;
  if (bm != BM || bn != BN ||
      (VEC && (Cin % BN != 0 || Cout % BK != 0)) ||
      bad_splits(splits, 64LL * ((Cout + BK - 1) / BK)))
    return (int)cudaErrorInvalidValue;
  k1_dx_fma<T, VEC>
      <<<(unsigned)(((M + BM - 1) / BM) * ((Cin + BN - 1) / BN) * splits),
         THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(wb),
          static_cast<T*>(dx), static_cast<float*>(part), B, D, H, W, Cin,
          Cout, splits);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_dk_fma(const void* x, const void* g, void* part, int B, int D,
                  int H, int W, int Cin, int Cout, int bm, int bn, int splits,
                  void* stream) {
  using namespace bfma;
  const long long M = (long long)B * D * H * W;
  if (bm != BM || bn != BN ||
      (VEC && (Cin % BM != 0 || Cout % BN != 0)) ||
      bad_splits(splits, (M + BK - 1) / BK))
    return (int)cudaErrorInvalidValue;
  k1_dk_fma<T, VEC>
      <<<(unsigned)(8 * ((8 * Cin + BM - 1) / BM) * ((Cout + BN - 1) / BN) *
                    splits),
         THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g),
          static_cast<float*>(part), B, D, H, W, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

// a grid-stride pass over n elements: at most 8 blocks of 256 per SM
unsigned pass_grid(long long n) {
  const long long blocks = (n + 255) / 256;
  return (unsigned)(blocks < 132 * 8 ? (blocks > 0 ? blocks : 1) : 132 * 8);
}

template <typename T>
int launch_dx_reduce(const void* part, void* dx, long long n, int splits,
                     void* stream) {
  if (splits < 1 || n < 0) return (int)cudaErrorInvalidValue;
  bwd::k1_dx_reduce<T><<<pass_grid(n), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(part), static_cast<T*>(dx), n, splits);
  return (int)cudaGetLastError();
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

// K1's backward.  g (B, 2D, 2H, 2W, Cout) and x (B, D, H, W, Cin) in one
// dtype; wb (Cin, 64*Cout) of that dtype, packed by pack_backward_kernels();
// dx (B, D, H, W, Cin) of that dtype, written when splits == 1, else
// part (splits, B*D*H*W, Cin) f32 for prdisagg_k1_dx_reduce_*; dk's part
// (splits, 8 phases, 8*Cin, Cout) f32 for prdisagg_k1_dk_fold.  All
// contiguous on the current device; the fast entries also need 16-byte
// aligned operands.  Tiles and splits come from k1_backward_plan(): fast
// bf16 dx (128, 128 | 64) with Cout % 64 == 0; fast bf16 dk (128 | 64,
// 128 | 64) dividing Cin and Cout; the f32 fast and general entries (64, 64).
int prdisagg_k1_dx_fast_bf16(const void* g, const void* wb, void* dx,
                             void* part, int B, int D, int H, int W, int Cin,
                             int Cout, int bm, int bn, int splits,
                             void* stream) {
  return launch_dx_fast_bf16(g, wb, dx, part, B, D, H, W, Cin, Cout, bm, bn,
                             splits, stream);
}

int prdisagg_k1_dx_fast_f32(const void* g, const void* wb, void* dx,
                            void* part, int B, int D, int H, int W, int Cin,
                            int Cout, int bm, int bn, int splits,
                            void* stream) {
  return launch_dx_fma<float, true>(g, wb, dx, part, B, D, H, W, Cin, Cout,
                                    bm, bn, splits, stream);
}

int prdisagg_k1_dx_general_f32(const void* g, const void* wb, void* dx,
                               void* part, int B, int D, int H, int W,
                               int Cin, int Cout, int bm, int bn, int splits,
                               void* stream) {
  return launch_dx_fma<float, false>(g, wb, dx, part, B, D, H, W, Cin, Cout,
                                     bm, bn, splits, stream);
}

int prdisagg_k1_dx_general_bf16(const void* g, const void* wb, void* dx,
                                void* part, int B, int D, int H, int W,
                                int Cin, int Cout, int bm, int bn, int splits,
                                void* stream) {
  return launch_dx_fma<__nv_bfloat16, false>(g, wb, dx, part, B, D, H, W,
                                             Cin, Cout, bm, bn, splits,
                                             stream);
}

int prdisagg_k1_dk_fast_bf16(const void* x, const void* g, void* part, int B,
                             int D, int H, int W, int Cin, int Cout, int bm,
                             int bn, int splits, void* stream) {
  return launch_dk_fast_bf16(x, g, part, B, D, H, W, Cin, Cout, bm, bn,
                             splits, stream);
}

int prdisagg_k1_dk_fast_f32(const void* x, const void* g, void* part, int B,
                            int D, int H, int W, int Cin, int Cout, int bm,
                            int bn, int splits, void* stream) {
  return launch_dk_fma<float, true>(x, g, part, B, D, H, W, Cin, Cout, bm, bn,
                                    splits, stream);
}

int prdisagg_k1_dk_general_f32(const void* x, const void* g, void* part,
                               int B, int D, int H, int W, int Cin, int Cout,
                               int bm, int bn, int splits, void* stream) {
  return launch_dk_fma<float, false>(x, g, part, B, D, H, W, Cin, Cout, bm,
                                     bn, splits, stream);
}

int prdisagg_k1_dk_general_bf16(const void* x, const void* g, void* part,
                                int B, int D, int H, int W, int Cin, int Cout,
                                int bm, int bn, int splits, void* stream) {
  return launch_dk_fma<__nv_bfloat16, false>(x, g, part, B, D, H, W, Cin,
                                             Cout, bm, bn, splits, stream);
}

int prdisagg_k1_dx_reduce_f32(const void* part, void* dx, long long n,
                              int splits, void* stream) {
  return launch_dx_reduce<float>(part, dx, n, splits, stream);
}

int prdisagg_k1_dx_reduce_bf16(const void* part, void* dx, long long n,
                               int splits, void* stream) {
  return launch_dx_reduce<__nv_bfloat16>(part, dx, n, splits, stream);
}

// dk (3, 3, 3, Cin, Cout) f32 from dk's part
int prdisagg_k1_dk_fold(const void* part, void* dk, int Cin, int Cout,
                        int splits, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  bwd::k1_dk_fold<<<pass_grid(27LL * Cin * Cout), 256, 0,
                    (cudaStream_t)stream>>>(static_cast<const float*>(part),
                                            static_cast<float*>(dk), Cin, Cout,
                                            splits);
  return (int)cudaGetLastError();
}

const char* prdisagg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
