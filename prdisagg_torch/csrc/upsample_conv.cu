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
// and one wgmma descriptor serve both operands, with no transpose flag.
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
// Three forward kernels, one rule a dtype (k1_plan in ops/upsample_conv.py):
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
// * k1_f32_halo (f32, Cin % 8 == 0, Cout % 64 == 0; the tf namespace, in
//   the backward section below, beside the f32 backward whose walk it
//   shares): the same TPU kernel's f32 path on the TF32 tensor cores.
//   What bounds f32 here: exact FMA runs at 67 TFLOP/s, so the three
//   flagship stages at B 1000 (1.309e12 FLOPs) take at least 19.5 ms; a
//   value split into TF32 hi + lo, three TF32 products (lo*hi + hi*lo +
//   hi*hi) keep f32 accuracy at 495 TFLOP/s, 7.9 ms.  Reaching that needs
//   wgmma, and wgmma reads A in 1024-byte swizzled atoms that a tap's
//   shifted rows break, so the im2col gather above would copy each input
//   row 64 times.  Instead a CTA copies the block's input sub-box of a
//   phase once, one TMA box (zero fill is SAME padding and ragged edges),
//   and reads every tap as a shifted window of it by ldmatrix into the
//   register form of wgmma, splitting A into hi and lo in registers; the
//   weights come split and swizzled by k1_pack_fwd_tf32 (one launch a
//   call), a unit's 32 KB as one bulk copy.  The tensor cores round their
//   f32 sums toward zero, so each unit of 8 input channels (24 wgmmas)
//   starts a fresh accumulator, added to f32 sums in registers.  The plan
//   takes its tile of 128, 192 or 256 positions (2 to 4 warpgroups) by the
//   waves of work items it makes.
// * k1_general (either dtype, any widths): the simple kernel (128 x 64 tiles,
//   32-deep slices loaded synchronously, f32 FMA) for widths the two
//   tensor-core kernels do not take, such as the smoke-test models' 8
//   channels, and for operands off the 16-byte alignment.
//
// k1_bf16_wgmma puts the phase on the fastest grid axis (block id =
// 8 * tile + phase; k1_f32_halo its work items likewise), so the 8 phases
// of one M tile, which read the same input rows, run together while those
// rows are in L2.  The tile is chosen so that the grid fills the 132 SMs at
// the training batch.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.  A fast kernel's
// shared-memory limit is raised once per device, at its first launch there,
// so a launch inside a CUDA graph capture is the launch alone; the TMA
// descriptors of the halo kernels are kernel parameters, encoded at each
// launch from the operands' (in a graph, stable) addresses.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

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
// operation-bound (0.0847 ms for the three training stages at B 32,
// against 0.022 ms of bytes; 1.355 ms at the 64x64 stages).
//
// What held the first hand-written version back, measured on an H100 (the
// node of the 16x16 step's three stages at B 32, 0.722 ms; at 64x64 7.55;
// chip_smoke.py --k1-backward-split): dk 0.264 and dx 0.198 ms, the bias
// gradient's f32 copy of g and its sum 0.162, the weight permutation 0.057,
// the folds 0.033 and the split reductions 0.007.  Both GEMMs gathered
// their A rows with 16-byte copies, masked row by row, once per (offset,
// N tile) in dx and per (phase, tap, N tile) in dk: each input row came
// from L2 into shared memory 8 to 128 times, and L2, not the tensor cores,
// set the pace (64x64 stage 2: dk 2.71 ms, dx 1.27, against 0.42 each).
//
// Per axis, the forward's out[2d'+a] reads x[d'+a+p-1] through K2[a, p], so
// low-res index d feeds the full-res output 2d+u, u = 2-j, j = 2p+a in 0..3:
// offset j holds K2[a, p].
//
// dx: one implicit GEMM, M = B*D*H*W low-res positions, N = Cin,
// K = 64 offsets (u, v, t) x Cout.  Row m gathers the cotangent rows
// g[n, 2d+u, 2h+v, 2w+t] (zero outside the full-res grid).  Written per
// phase (a, b, c) of the cotangent, the offset of tap (p, q, r) reads the
// phase's sub-grid g_abc[s] = g[2s + (a, b, c)] at s + 1 - (a+p, b+q, c+r).
//
// dk: per phase (a, b, c) one GEMM, M = 8 taps x Cin, N = Cout,
// K = B*D*H*W positions: A[(tap, ci), m] = x[m + shift(phase, tap), ci]
// (zero outside the input) and B[m, co] = g[(2d+a, 2h+b, 2w+c) of m, co].
// The 8 x 8 phase-tap gradients are folded onto the 3^3 kernel by the
// adjoint of phase_kernels() in k1_dk_fold.
//
// bf16 (k1_dx_bf16_halo, k1_dk_bf16_halo; the tc namespace below): halo
// boxes.  A CTA owns a block of positions (tn, td, th, tw), 3-D so that its
// neighbours are few, and copies every input row a phase of the block
// reads, once, into shared memory: the phase's sub-box (tn, td+1, th+1,
// tw+1) of cotangent rows (dx) or input rows (dk), zero outside the grid,
// so no row is masked again.  Every offset or tap is then a shifted window
// of the sub-box; a shift of one row breaks the 1024-byte atoms that a
// wgmma descriptor names, so A is read from registers (the RS form of
// wgmma), filled by ldmatrix from one row address per lane (.trans in dk,
// whose A has Cin contiguous), and B from shared memory, MN-major.  dx's B
// is the forward's packing kp read in place (Cin is contiguous in it): no
// permuted copy of the weights.  dk's CTAs hold all 8 taps of a phase, so
// a cotangent row is read 8 times less than per tap; those of the first
// Cin tile also sum the cotangent rows' columns, the bias gradient.  Input
// rows now come from L2 about (1 + 1/t)^3 times a phase and N tile.  Each
// box is one TMA copy (tiled mode, a 5-D map of the NDHWC tensor with zero
// fill outside it, which gives SAME padding and ragged blocks; for the
// cotangent's phases the map strides 2 over the full-res axes), issued by
// one thread and waited for on an mbarrier: with per-thread 16-byte
// cp.async gathers of the same boxes the copies set dk's pace.
//
// f32 (k1_dx_f32_halo, k1_dk_f32_halo; the tf namespace): the same halo
// walk on 3xTF32 wgmma.  What bounds f32 work on this card: exact FMA
// runs at 67 TFLOP/s (the FMA kernels these replace reached 0.27-0.30 of
// that on an H100), the TF32 tensor cores at 495; a value v splits into two
// TF32 values hi + lo, and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, summed in
// f32, keeps f32 accuracy (about 3 * 2^-22 relative a product) at three
// times the tensor-core work, so the least time is 3 * FLOPs / 495e12,
// 0.406 of the FMA bound.  TF32's wgmma takes B K-major only (its
// transpose bits exist for 16-bit types alone), and ldmatrix .trans moves
// 16-bit elements, so the bf16 layouts do not carry over: dx's B is
// pack_backward_kernels()'s permuted weights (k = off*Cout + co
// contiguous), split into hi and lo once a call in PyTorch (split_tf32),
// in 32-byte boxes; dx's A, the cotangent rows, is K-major, and ldmatrix
// on f32 rows gives the tf32 A fragment, split in registers.  dk's B, the
// cotangent rows, has Cout contiguous (N-major): one pass a block
// transposes it in shared memory into hi and lo K-major tiles, shared by
// the 8 taps and every Cin tile's CTA (and sums the bias gradient there);
// dk's A, the input window, is read with 8-byte shared loads and split in
// registers.  Units of 8 channels and blocks of 64 positions keep the f32
// rings inside 227 KB.  The tensor cores round their f32 sums toward zero,
// so an error grows with the number of wgmmas summed into one accumulator
// (3e-5 of the largest gradient after 1,536 of them, measured on an H100):
// each unit (dx) or block (dk) starts a fresh accumulator, added at its end
// to f32 sums in registers.
//
// Split-K.  At the training batch the grids are small (dx at 16x16 stage 0
// is 8 blocks x N tiles), so each GEMM's reduction units are cut into
// `splits` contiguous ranges, chosen by k1_backward_plan() so that the grid
// fills the 132 SMs.  On the halo kernels (bf16 and f32) the splits of one
// output tile are the CTAs of one thread-block cluster (at most 8, the
// portable size): each stages its f32 tile in its own shared memory and
// each sums a share of the rows over the cluster's tiles through
// distributed shared memory, in rank order; dx rounds once to x's dtype,
// dk writes the summed phase-tap tiles, and one pass folds them
// (k1_dk_fold, which also sums the 8 phases' bias sums).  At other widths
// and on misaligned operands (the FMA kernels) every split writes its f32
// partial tile to a workspace and a second kernel sums the partials in
// split order (k1_dx_reduce: and rounds once to x's dtype; k1_dk_fold: and
// folds).  No atomics: the gradients are the same bits on every run.

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
           int Cout, int splits, const float* __restrict__ dbp,
           float* __restrict__ db) {
  const long long cc = (long long)Cin * Cout;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < 27 * cc; i += stride) {
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
  if (dbp != nullptr)
    for (long long i = first; i < Cout; i += stride) {
      float s = 0.0f;
      for (int x = 0; x < 8; ++x) s += dbp[x * Cout + i];
      db[i] = s;
    }
}

}  // namespace bwd

// ------------------- backward, bf16: halo boxes, wgmma, in-cluster split-K

namespace tc {

// the descriptor of an MN-major tile: both byte offsets 1024, so that the
// 8-row step along K is right whichever field the hardware reads it from
// (the other one, the step between 64-wide blocks, is never used)
__device__ __forceinline__ uint64_t desc_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// m64n64k16 with A from registers (the m16n8k16 fragment of each warp's 16
// rows, as ldmatrix.x4 leaves it) and B MN-major from shared memory
// (transpose bit set): D += A*B in f32 registers
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 give matrix i's rows); .trans delivers them transposed
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// thread-block clusters: this CTA's rank, a barrier of the whole cluster
// (release/acquire: shared-memory writes before it are seen after it), and
// a 16-byte load from the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t saddr, uint32_t rank) {
  uint32_t remote;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(saddr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster(uint32_t saddr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(saddr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// TMA: one thread asks for a box of a tensor (described by a CUtensorMap
// kernel parameter) to be copied into shared memory; the copy counts its
// bytes on an mbarrier, whose phase completes when the expected bytes have
// all landed.  A wait that outlasts about two seconds traps, so that a
// fault shows as an error and not as a hang.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Both kernels: two warpgroups of wgmma, one CTA a block of low-res
// positions (tn, td, th, tw) at origin (n0, d0, h0, w0), blocks ordered
// (n, d, h, w) with w fastest.  A phase's sub-box is (tn, td+1, th+1,
// tw+1) rows: every row a block's positions read for that phase, in any
// tap.  dx adds a producer warp whose lane 0 issues each reduction unit's
// TMA boxes into a ring slot once the consumers have released it (an
// mbarrier that all 256 consumer threads arrive on): with the issue inside
// the consumers' loop the compiler serialised dx's wgmmas.  dk, which
// needs every register of 256 threads for its 8 taps' accumulators, has
// thread 0 issue after the loop's barrier.
constexpr int HB_THREADS = 256;  // consumers
constexpr int HB_CTA_THREADS = HB_THREADS + 32;
constexpr int HB_BM = 128;       // dx: positions a CTA (64 per warpgroup)
constexpr int HB_CO = 16;        // dx: output channels a reduction unit
constexpr int DX_RMAX = 512;     // dx: sub-box rows (32 bytes each)
constexpr int DX_STAGES = 4;
constexpr int HB_BP = 128;       // dk: positions a block (its unit)
constexpr int DK_RMAX = 256;     // dk: sub-box rows (128 bytes each)
constexpr int DK_STAGES = 4;
constexpr int HB_PITCH = 68;     // dk: floats a staged row of 64 channels
constexpr int MAX_CLUSTER = 8;   // portable cluster size

struct Blocks {
  int tn, td, th, tw, nbd, nbh, nbw;
  __device__ __forceinline__ void origin(int bi, int& n0, int& d0,
                                         int& h0, int& w0) const {
    w0 = (int)(bi % nbw) * tw;
    bi /= nbw;
    h0 = (int)(bi % nbh) * th;
    bi /= nbh;
    d0 = (int)(bi % nbd) * td;
    n0 = (int)(bi / nbd) * tn;
  }
};

__host__ __device__ constexpr int dx_smem_bytes(int nb) {
  return DX_STAGES * (DX_RMAX * 32 + 8 * nb * 2048) + DX_STAGES * 16 + 1024;
}

__host__ __device__ constexpr int dk_smem_bytes() {
  return DK_STAGES * (DK_RMAX * 128 + HB_BP * 128) + DK_STAGES * 8 +
         HB_BP * 4 + 1024;
}

// dx on one block of HB_BM positions and 64*NB input channels.  The
// reduction runs over units (16 output channels c0.., phase): per unit the
// phase's cotangent sub-box of those channels (R rows of 32 bytes, zero
// outside the full-res grid: one TMA box of the phase's sub-grid, map_g
// striding 2 over the full-res axes, in the 32-byte swizzle) and the 8
// taps' weights kp[phase, c0.., tap*Cin + ci] (16 x 64 boxes of map_k, read
// in place: Cin is contiguous, so B is MN-major).  Tap (p, q, r) of position (in, id, ih, iw) reads sub-box row
// (in, id+1-p, ih+1-q, iw+1-r): a warp's 16 rows come by ldmatrix from row
// addresses, so no shifted window has to be a wgmma descriptor's tile.
// The cluster's CTAs take contiguous ranges of the units and sum their f32
// tiles through distributed shared memory in rank order.
template <int NB>
__global__ void __launch_bounds__(HB_CTA_THREADS, 1)
k1_dx_bf16_halo(const __grid_constant__ CUtensorMap map_g,
                const __grid_constant__ CUtensorMap map_k,
                __nv_bfloat16* __restrict__ dx, int B, int D, int H, int W,
                int Cin, int Cout, Blocks bl, int splits) {
  constexpr int A_BYTES = DX_RMAX * 32;
  constexpr int B_TAP = NB * 2048;  // 16 rows x 64*NB channels
  constexpr int SLOT = A_BYTES + 8 * B_TAP;
  constexpr int BN = 64 * NB, PITCH = BN + 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  // a slot's mbarriers: its copies landed (full), its consumers done (empty)
  const uint32_t full = base + DX_STAGES * SLOT, empty = full + 8 * DX_STAGES;

  const int split = (int)cluster_rank();
  const int ci0 = blockIdx.y * BN;
  int n0, d0, h0, w0;
  bl.origin(blockIdx.z, n0, d0, h0, w0);
  const int SD = bl.td + 1, SH = bl.th + 1, SW = bl.tw + 1;
  const int R = bl.tn * SD * SH * SW;
  const int P = bl.tn * bl.td * bl.th * bl.tw;

  if (threadIdx.x == 0) {
    for (int i = 0; i < DX_STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, HB_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // this lane's ldmatrix row: position m of the warp's 16, k chunk kc (the
  // warp's index through a shuffle, which the compiler knows to be uniform)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int lane = threadIdx.x & 31;
  const int kc = lane >> 4;
  int rho0;
  {
    const int m = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int t = m < P ? m : 0;  // rows past the block read a real row, unstored
    const int iw = t % bl.tw;
    t /= bl.tw;
    const int ih = t % bl.th;
    t /= bl.th;
    const int id = t % bl.td;
    rho0 = (((t / bl.td) * SD + id + 1) * SH + ih + 1) * SW + iw + 1;
  }
  __syncthreads();

  const int U = 8 * (Cout / HB_CO);
  int u0, u1;
  bwd::split_range(U, splits, split, u0, u1);
  const int NU = u1 - u0;

  // unit i's boxes into ring slot `slot`, by the producer
  auto load = [&](int i, int slot) {
    const int u = u0 + i, phase = u & 7, c0 = (u >> 3) * HB_CO;
    const int a = phase >> 2, b = (phase >> 1) & 1, c = phase & 1;
    const uint32_t dst = base + slot * SLOT, bar = full + 8 * slot;
    mbar_expect(bar, R * 32 + 8 * B_TAP);
    // sub-grid rows (d0 - a + ld, ...) sit at full-res 2(d0 + ld) - a
    tma_load_5d(dst, &map_g, bar, c0, 2 * w0 - c, 2 * h0 - b, 2 * d0 - a,
                n0);
#pragma unroll
    for (int tap = 0; tap < 8; ++tap)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tma_load_3d(dst + A_BYTES + tap * B_TAP + nb * 2048, &map_k, bar,
                    tap * Cin + ci0 + 64 * nb, c0, phase);
  };

  float acc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
  uint32_t af[2][4][4];

  if (warp_id == HB_THREADS / 32) {
    // the producer: unit i into slot i % DX_STAGES once the consumers have
    // released the unit DX_STAGES back
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < NU; ++i) {
        const int slot = i % DX_STAGES;
        if (i >= DX_STAGES)
          mbar_wait(empty + 8 * slot, (i / DX_STAGES - 1) & 1);
        load(i, slot);
      }
    __syncwarp();
  } else {
    // a unit's wgmmas are two groups (taps 0-3, 4-7), each on its own A
    // registers; at most one group stays in flight, so the registers an
    // ldmatrix refills were last read two groups back, and once the first
    // group of unit i is waited for, unit i - 1 is done with its slot
    for (int i = 0; i < NU; ++i) {
      mbar_wait(full + 8 * (i % DX_STAGES), (i / DX_STAGES) & 1);
      const uint32_t a_sub = base + (i % DX_STAGES) * SLOT;
      const uint32_t b_sub = a_sub + A_BYTES;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int tap = half * 4 + t;
          const int rho = rho0 - ((tap >> 2) * SH * SW +
                                  ((tap >> 1) & 1) * SW + (tap & 1));
          ldsm_x4(af[half][t],
                  a_sub + rho * 32 + ((kc ^ ((rho >> 2) & 1)) << 4));
        }
        fence_regs(af[half]);
#pragma unroll
        for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int j = 0; j < NB; ++j)
            wgmma_rs_m64n64k16(
                acc[j], af[half][t],
                desc_mn(b_sub + (half * 4 + t) * B_TAP + j * 2048));
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
        if (half == 0 && i > 0)
          mbar_arrive(empty + 8 * ((i - 1) % DX_STAGES));
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
  }
  __syncthreads();  // every box has landed and been read

  // the f32 tile into this CTA's shared memory (the idle ring): register
  // 4j + 2h + e of (warp, lane) holds row warp*16 + lane/4 + 8h, column
  // 8j + 2*(lane%4) + e of its 64-wide block
  float* stage = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int h = 0; h < 2 * (warp_id < HB_THREADS / 32); ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(stage + r * PITCH + nb * 64 + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[nb][4 * j + 2 * h], acc[nb][4 * j + 2 * h + 1]);
  }
  cluster_sync();

  // rank `split` sums its rows of the tile over the cluster's CTAs in rank
  // order and stores them in x's dtype
  int r0, r1;
  bwd::split_range(HB_BM, splits, split, r0, r1);
  for (int idx = threadIdx.x; idx < (r1 - r0) * (BN / 4); idx += blockDim.x) {
    const int row = r0 + idx / (BN / 4), c4 = idx % (BN / 4);
    if (row >= P) continue;
    int t = row;
    const int w = w0 + t % bl.tw;
    t /= bl.tw;
    const int h = h0 + t % bl.th;
    t /= bl.th;
    const int d = d0 + t % bl.td;
    const int n = n0 + t / bl.td;
    if (n >= B || d >= D || h >= H || w >= W) continue;
    const uint32_t off = base + (row * PITCH + 4 * c4) * 4;
    float4 s = ld_cluster4(off, 0);
    for (int q = 1; q < splits; ++q) {
      const float4 v = ld_cluster4(off, q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s.z, s.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(
        dx + ((((size_t)n * D + d) * H + h) * W + w) * Cin + ci0 + 4 * c4) =
        packed;
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory
}

// dk on one phase, 64 input channels ci0.. and 64 output channels co0..,
// all 8 taps (warpgroup w: taps 4w..4w+3, p = w).  The reduction runs over
// position blocks of at most HB_BP: per block the phase's input sub-box of
// those channels (x at (d0 + a - 1 + ld, ...), R rows of 128 bytes, zero
// outside the grid: one TMA box of map_x) and the phase's cotangent rows
// of the block's positions (one box of map_g, striding 2 over the
// full-res axes; rows past the block stay zero: the positions are the
// reduction, so B is MN-major), both in the 128-byte swizzle.  Tap (p, q, r) of position (in,
// id, ih, iw) reads sub-box row (in, id+p, ih+q, iw+r), by ldmatrix.trans:
// A is (ci, position) with ci contiguous.  The CTAs of the first ci tile
// also sum the cotangent rows' columns (the bias gradient's share of this
// phase).  The cluster's CTAs take contiguous ranges of the blocks and sum
// their 8 f32 tiles (and bias sums) through distributed shared memory in
// rank order, into dk2[phase][tap][ci][co] and dbp[phase][co].
__global__ void __launch_bounds__(HB_THREADS, 1)
k1_dk_bf16_halo(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_g,
                float* __restrict__ dk2, float* __restrict__ dbp, int B, int D,
                int H, int W, int Cin, int Cout, Blocks bl, int splits) {
  constexpr int A_BYTES = DK_RMAX * 128;
  constexpr int SLOT = A_BYTES + HB_BP * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full = base + DK_STAGES * SLOT;  // a slot's copies landed
  int* qrho = reinterpret_cast<int*>(gbase + DK_STAGES * SLOT +
                                     DK_STAGES * 8);

  const int split = (int)cluster_rank();
  const int co_tiles = Cout / 64;
  const int ci0 = (blockIdx.y / co_tiles) * 64;
  const int co0 = (blockIdx.y % co_tiles) * 64;
  const bool db_cta = ci0 == 0 && dbp != nullptr;
  const int phase = blockIdx.z;
  const int a = phase >> 2, b = (phase >> 1) & 1, c = phase & 1;
  const int SD = bl.td + 1, SH = bl.th + 1, SW = bl.tw + 1;
  const int R = bl.tn * SD * SH * SW;
  const int P = bl.tn * bl.td * bl.th * bl.tw;
  const int nblk =
      ((B + bl.tn - 1) / bl.tn) * bl.nbd * bl.nbh * bl.nbw;

  // each block position's sub-box row at tap (0, 0, 0); the cotangent
  // rows past the block, which no box fills, zero in every slot
  for (int q = threadIdx.x; q < HB_BP; q += blockDim.x) {
    int t = q < P ? q : 0;
    const int iw = t % bl.tw;
    t /= bl.tw;
    const int ih = t % bl.th;
    t /= bl.th;
    const int id = t % bl.td;
    qrho[q] = (((t / bl.td) * SD + id) * SH + ih) * SW + iw;
  }
  for (int j = P * 8 + threadIdx.x; j < HB_BP * 8; j += blockDim.x)
    for (int slot = 0; slot < DK_STAGES; ++slot)
      reinterpret_cast<uint4*>(gbase + slot * SLOT + A_BYTES)[j] =
          make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < DK_STAGES; ++i) mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int b0, b1;
  bwd::split_range(nblk, splits, split, b0, b1);
  const int NU = b1 - b0;

  // block i's boxes into ring slot `slot`, by thread 0
  auto load = [&](int i, int slot) {
    int n0, d0, h0, w0;
    bl.origin(b0 + i, n0, d0, h0, w0);
    const uint32_t dst = base + slot * SLOT, bar = full + 8 * slot;
    mbar_expect(bar, (R + P) * 128);
    tma_load_5d(dst, &map_x, bar, ci0, w0 + c - 1, h0 + b - 1, d0 + a - 1,
                n0);
    tma_load_5d(dst + A_BYTES, &map_g, bar, co0, 2 * w0 + c, 2 * h0 + b,
                2 * d0 + a, n0);
  };

  float acc[4][32];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.0f;
  uint32_t af[2][8][4];
  float dbsum = 0.0f;  // column threadIdx % 64, rows 32 * (threadIdx / 64)..
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int lane = threadIdx.x & 31;
  const int tap_shift = wg * SH * SW;  // p = wg
  const int chunk = 2 * warp + ((lane >> 3) & 1);  // 8 ci of the warp's 16

  // the ring runs DK_STAGES - 2 blocks ahead: the slot thread 0 refills
  // after the barrier was last read two blocks back, whose wgmmas every
  // warpgroup has waited for (at most one group stays in flight)
  if (threadIdx.x == 0)
    for (int s = 0; s < DK_STAGES - 2 && s < NU; ++s) load(s, s);
  for (int i = 0; i < NU; ++i) {
    __syncthreads();
    if (threadIdx.x == 0 && i + DK_STAGES - 2 < NU)
      load(i + DK_STAGES - 2, (i + DK_STAGES - 2) % DK_STAGES);
    mbar_wait(full + 8 * (i % DK_STAGES), (i / DK_STAGES) & 1);
    const uint32_t a_sub = base + (i % DK_STAGES) * SLOT;
    const uint32_t b_sub = a_sub + A_BYTES;
    if (db_cta) {
      const int co = threadIdx.x & 63, q0 = (threadIdx.x >> 6) * 32;
      const uint8_t* bt = gbase + (b_sub - base);
#pragma unroll 8
      for (int q = q0; q < q0 + 32; ++q)
        dbsum += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
            bt + q * 128 + (((co >> 3) ^ (q & 7)) << 4) + (co & 7) * 2));
    }
    // k16 steps 2gi and 2gi + 1 (positions 16j.., rows 8*(lane/16) +
    // lane%8 of the transposed matrices) make one group of 8 wgmmas, on A
    // registers af[gi % 2]: at most one group stays in flight, so the
    // registers an ldmatrix refills were last read two groups back
#pragma unroll
    for (int gi = 0; gi < HB_BP / 32; ++gi) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int rq =
            qrho[(2 * gi + jj) * 16 + (lane >> 4) * 8 + (lane & 7)] +
            tap_shift;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int rho = rq + (t >> 1) * SW + (t & 1);
          ldsm_x4_t(af[gi & 1][jj * 4 + t],
                    a_sub + rho * 128 + ((chunk ^ (rho & 7)) << 4));
        }
      }
      fence_regs(af[gi & 1]);
#pragma unroll
      for (int t = 0; t < 4; ++t) fence_acc(acc[t]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const uint64_t db = desc_mn(b_sub + (2 * gi + jj) * 2048);
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_rs_m64n64k16(acc[t], af[gi & 1][jj * 4 + t], db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int t = 0; t < 4; ++t) fence_acc(acc[t]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int t = 0; t < 4; ++t) fence_acc(acc[t]);
  __syncthreads();

  // the 8 f32 tiles, row (tap, ci) of 64 columns, into the idle ring; then
  // the 4 row groups' bias sums
  float* stage = reinterpret_cast<float*>(gbase);
  float* dbs = stage + 8 * 64 * HB_PITCH;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wg * 4 + t) * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(stage + r * HB_PITCH + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
    }
  dbs[threadIdx.x] = dbsum;
  cluster_sync();

  int r0, r1;
  bwd::split_range(8 * 64, splits, split, r0, r1);
  for (int idx = threadIdx.x; idx < (r1 - r0) * 16; idx += blockDim.x) {
    const int row = r0 + idx / 16, c4 = idx % 16;
    const uint32_t off = base + (row * HB_PITCH + 4 * c4) * 4;
    float4 s = ld_cluster4(off, 0);
    for (int q = 1; q < splits; ++q) {
      const float4 v = ld_cluster4(off, q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int tap = row >> 6, ci = row & 63;
    *reinterpret_cast<float4*>(
        dk2 + (((size_t)phase * 8 + tap) * Cin + ci0 + ci) * Cout + co0 +
        4 * c4) = s;
  }
  if (db_cta && split == 0 && threadIdx.x < 64) {
    const uint32_t off = base + (8 * 64 * HB_PITCH + threadIdx.x) * 4;
    float s = 0.0f;
    for (int q = 0; q < splits; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) s += ld_cluster(off + k * 256, q);
    dbp[phase * Cout + co0 + threadIdx.x] = s;
  }
  cluster_sync();
}

}  // namespace tc

// ------------- backward, f32: halo boxes, 3xTF32 wgmma, in-cluster split sums

namespace tf {

using tc::Blocks;

// The f32 halo kernels' limits.  dx: HF_BM positions a CTA, HF_CO output
// channels a reduction unit (a 32-byte row of the cotangent sub-box, whose
// ldmatrix fragment is the tf32 A fragment of one k8 step), sub-box rows,
// ring stages; dk: HF_BP positions a block (two K blocks of 32 for the
// transposed cotangent), sub-box rows, ring stages.  Each stays inside the
// 227 KB a CTA may use (f32_dx_smem_bytes, f32_dk_smem_bytes).
constexpr int HF_BM = 128;
constexpr int HF_CO = 8;
constexpr int HF_DX_RMAX = 256;
constexpr int HF_DX_STAGES = 3;
constexpr int HF_BP = 64;
constexpr int HF_DK_RMAX = 192;
constexpr int HF_DK_STAGES = 2;

// v rounded to TF32, to nearest with ties away from zero (the low 13 bits
// of the result are 0)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to within 2^-22 |v|: hi is v in TF32, lo the remainder in
// TF32, rounded here (the tensor cores would truncate it); split_tf32() in
// ops/upsample_conv.py is the same split.  By cvt.rna (lo 0 where hi is not
// finite), or (kInt) by integer rounding of the magnitude bits, which gives
// the same parts for finite v in fewer issue slots (cvt.rna runs at a
// fraction of the integer rate); a non-finite v gives non-finite products
// either way.
template <bool kInt>
__device__ __forceinline__ void split_tf32(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(v);
  if (kInt) {
    hi = (v + 0x1000u) & 0xffffe000u;
    lo = (__float_as_uint(__fsub_rn(f, __uint_as_float(hi))) + 0x1000u) &
         0xffffe000u;
  } else {
    hi = tf32_rna(f);
    lo = (hi & 0x7f800000u) == 0x7f800000u
             ? 0u
             : tf32_rna(f - __uint_as_float(hi));
  }
}

// v becomes lo, hi its TF32 high part
template <bool kInt, int N>
__device__ __forceinline__ void split_regs(uint32_t (&v)[N][4],
                                           uint32_t (&hi)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32<kInt>(v[i][e], hi[i][e], v[i][e]);
}

// the descriptor of a K-major tile in the 32-byte swizzle (TMA's
// SWIZZLE_32B): 32-byte rows, 8-row atoms of 256 bytes, one after another
// along N (stride byte offset 256), layout type 3
__device__ __forceinline__ uint64_t desc_b32(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// m64n64k8 in TF32 with A from registers (each warp's 16 rows: a[0] row
// g, k t; a[1] row g+8, k t; a[2] row g, k t+4; a[3] row g+8, k t+4, for
// g = lane/4, t = lane%4) and B K-major from shared memory: D = A*B, plus
// D if `accumulate`, in f32 registers (TF32 takes no transpose bits)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"((int)accumulate));
}

// product `prod` of a 3xTF32 product's three, small terms first (A_lo*B_hi,
// A_hi*B_lo, A_hi*B_hi), into D, added to D if `accumulate`
__device__ __forceinline__ void wgmma_part(float (&d)[32],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint64_t b_hi, uint64_t b_lo,
                                           int prod, bool accumulate) {
  wgmma_tf32(d, prod == 0 ? a_lo : a_hi, prod == 1 ? b_lo : b_hi,
             accumulate);
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__host__ __device__ constexpr int f32_dx_slot(int nb) {
  return HF_DX_RMAX * 32 + 16 * nb * 2048;  // A rows; 8 taps x (hi, lo) B
}

__host__ __device__ constexpr int f32_dx_smem_bytes(int nb) {
  return HF_DX_STAGES * f32_dx_slot(nb) + HF_DX_STAGES * 16 + 1024;
}

// dk: a slot holds the input sub-box and the block's cotangent rows, each
// as two 32-channel halves of 128-byte rows; then the transposed cotangent
// (hi and lo, K blocks of 32 positions x 64 rows of 128 bytes)
constexpr int HF_XH = HF_DK_RMAX * 128;
constexpr int HF_GH = HF_BP * 128;
constexpr int HF_DK_SLOT = 2 * HF_XH + 2 * HF_GH;
constexpr int HF_BT = (HF_BP / 32) * 64 * 128;

__host__ __device__ constexpr int f32_dk_smem_bytes() {
  return HF_DK_STAGES * HF_DK_SLOT + 2 * HF_BT + HF_DK_STAGES * 8 +
         HF_BP * 4 + 1024;
}

// dx in f32 on one block of HF_BM positions and 64*NB input channels: the
// bf16 halo kernel's walk (tc::k1_dx_bf16_halo) with units of (phase, 8
// output channels).  Per unit the phase's cotangent sub-box of those
// channels (R rows of 32 bytes, one TMA box striding 2 over the full-res
// axes, 32-byte swizzle) and, for each of the 8 taps, the tap's offset of
// the weights in TF32 hi and lo parts, wt[part, ci0.., off*Cout + c0..]
// (8 x 64*NB boxes of map_w: K-major, which TF32's wgmma needs for B).
// Tap (p, q, r) of position (in, id, ih, iw) reads sub-box row (in, id+1-p,
// ih+1-q, iw+1-r) by ldmatrix, which on f32 rows gives the tf32 A fragment
// of a k8 step; each value is split into hi and lo in registers and each
// product taken as three TF32 wgmmas.  The tensor cores round their f32
// sums toward zero, so an error grows with the number of wgmmas summed into
// one accumulator: each unit's products start a fresh accumulator, and at
// the unit's end it is added to the thread's f32 sums (rounded to nearest).
// A producer warp issues the TMA; the cluster's CTAs take contiguous ranges
// of the units and sum their f32 tiles through distributed shared memory
// in rank order.
template <int NB>
__global__ void __launch_bounds__(tc::HB_CTA_THREADS, 1)
k1_dx_f32_halo(const __grid_constant__ CUtensorMap map_g,
               const __grid_constant__ CUtensorMap map_w,
               float* __restrict__ dx, int B, int D, int H, int W, int Cin,
               int Cout, Blocks bl, int splits) {
  constexpr int A_BYTES = HF_DX_RMAX * 32;
  constexpr int B_TILE = NB * 2048;  // 64*NB rows of 8 floats
  constexpr int SLOT = f32_dx_slot(NB);
  constexpr int BN = 64 * NB, PITCH = BN + 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full = base + HF_DX_STAGES * SLOT;
  const uint32_t empty = full + 8 * HF_DX_STAGES;

  const int split = (int)tc::cluster_rank();
  const int ci0 = blockIdx.y * BN;
  int n0, d0, h0, w0;
  bl.origin(blockIdx.z, n0, d0, h0, w0);
  const int SD = bl.td + 1, SH = bl.th + 1, SW = bl.tw + 1;
  const int R = bl.tn * SD * SH * SW;
  const int P = bl.tn * bl.td * bl.th * bl.tw;

  if (threadIdx.x == 0) {
    for (int i = 0; i < HF_DX_STAGES; ++i) {
      tc::mbar_init(full + 8 * i, 1);
      tc::mbar_init(empty + 8 * i, tc::HB_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int lane = threadIdx.x & 31;
  const int kc = lane >> 4;
  int rho0;
  {
    const int m = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int t = m < P ? m : 0;  // rows past the block read a real row, unstored
    const int iw = t % bl.tw;
    t /= bl.tw;
    const int ih = t % bl.th;
    t /= bl.th;
    const int id = t % bl.td;
    rho0 = (((t / bl.td) * SD + id + 1) * SH + ih + 1) * SW + iw + 1;
  }
  __syncthreads();

  const int U = 8 * (Cout / HF_CO);
  int u0, u1;
  bwd::split_range(U, splits, split, u0, u1);
  const int NU = u1 - u0;

  // unit i's boxes into ring slot `slot`, by the producer: the sub-box, then
  // per tap the hi and lo weights of the tap's offset
  auto load = [&](int i, int slot) {
    const int u = u0 + i, phase = u & 7, c0 = (u >> 3) * HF_CO;
    const int a = phase >> 2, b = (phase >> 1) & 1, c = phase & 1;
    const uint32_t dst = base + slot * SLOT, bar = full + 8 * slot;
    tc::mbar_expect(bar, R * 32 + 16 * B_TILE);
    tc::tma_load_5d(dst, &map_g, bar, c0, 2 * w0 - c, 2 * h0 - b, 2 * d0 - a,
                    n0);
#pragma unroll
    for (int tap = 0; tap < 8; ++tap) {
      const int off = 16 * (2 * (tap >> 2) + a) +
                      4 * (2 * ((tap >> 1) & 1) + b) + 2 * (tap & 1) + c;
#pragma unroll
      for (int part = 0; part < 2; ++part)
        tc::tma_load_3d(dst + A_BYTES + (2 * tap + part) * B_TILE, &map_w,
                        bar, off * Cout + c0, ci0, part);
    }
  };

  float acc[NB][32], sum[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = sum[j][i] = 0.0f;
  uint32_t alo[2][2][4], ahi[2][2][4];

  if (warp_id == tc::HB_THREADS / 32) {
    // the producer: unit i into slot i % HF_DX_STAGES once the consumers
    // have released the unit HF_DX_STAGES back
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < NU; ++i) {
        const int slot = i % HF_DX_STAGES;
        if (i >= HF_DX_STAGES)
          tc::mbar_wait(empty + 8 * slot, (i / HF_DX_STAGES - 1) & 1);
        load(i, slot);
      }
    __syncwarp();
  } else {
    // a unit's wgmmas are four groups of two taps, each on its own A
    // registers (group parity), at most one group in flight; the first
    // wgmma of a unit into each accumulator starts it afresh
    for (int i = 0; i < NU; ++i) {
      const int slot = i % HF_DX_STAGES;
      tc::mbar_wait(full + 8 * slot, (i / HF_DX_STAGES) & 1);
      const uint32_t a_sub = base + slot * SLOT;
      const uint32_t b_sub = a_sub + A_BYTES;
#pragma unroll
      for (int grp = 0; grp < 4; ++grp) {
        const int par = grp & 1;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int tap = grp * 2 + t;
          const int rho = rho0 - ((tap >> 2) * SH * SW +
                                  ((tap >> 1) & 1) * SW + (tap & 1));
          tc::ldsm_x4(alo[par][t],
                      a_sub + rho * 32 + ((kc ^ ((rho >> 2) & 1)) << 4));
        }
        split_regs<false>(alo[par], ahi[par]);
        tc::fence_regs(alo[par]);
        tc::fence_regs(ahi[par]);
#pragma unroll
        for (int j = 0; j < NB; ++j) tc::fence_acc(acc[j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int prod = 0; prod < 3; ++prod)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int j = 0; j < NB; ++j) {
              const uint32_t bt =
                  b_sub + 2 * (grp * 2 + t) * B_TILE + j * 2048;
              wgmma_part(acc[j], ahi[par][t], alo[par][t], desc_b32(bt),
                         desc_b32(bt + B_TILE), prod,
                         grp > 0 || prod > 0 || t > 0);
            }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < NB; ++j) tc::fence_acc(acc[j]);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        tc::fence_acc(acc[j]);
#pragma unroll
        for (int e = 0; e < 32; ++e) sum[j][e] += acc[j][e];
      }
      tc::mbar_arrive(empty + 8 * slot);  // the unit's slot is read
    }
  }
  __syncthreads();  // every box has landed and been read

  float* stage = reinterpret_cast<float*>(gbase);
#pragma unroll
  for (int h = 0; h < 2 * (warp_id < tc::HB_THREADS / 32); ++h) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(stage + r * PITCH + nb * 64 + 8 * j +
                                   2 * (lane & 3)) =
            make_float2(sum[nb][4 * j + 2 * h], sum[nb][4 * j + 2 * h + 1]);
  }
  tc::cluster_sync();

  // rank `split` sums its rows of the tile over the cluster's CTAs in rank
  // order and stores them
  int r0, r1;
  bwd::split_range(HF_BM, splits, split, r0, r1);
  for (int idx = threadIdx.x; idx < (r1 - r0) * (BN / 4); idx += blockDim.x) {
    const int row = r0 + idx / (BN / 4), c4 = idx % (BN / 4);
    if (row >= P) continue;
    int t = row;
    const int w = w0 + t % bl.tw;
    t /= bl.tw;
    const int h = h0 + t % bl.th;
    t /= bl.th;
    const int d = d0 + t % bl.td;
    const int n = n0 + t / bl.td;
    if (n >= B || d >= D || h >= H || w >= W) continue;
    const uint32_t off = base + (row * PITCH + 4 * c4) * 4;
    float4 s = tc::ld_cluster4(off, 0);
    for (int q = 1; q < splits; ++q) {
      const float4 v = tc::ld_cluster4(off, q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(
        dx + ((((size_t)n * D + d) * H + h) * W + w) * Cin + ci0 + 4 * c4) = s;
  }
  tc::cluster_sync();  // no CTA leaves while another reads its shared memory
}

// dk in f32 on one phase, half of its taps (p = the CTA's half; warpgroup w
// takes q = w, r = 0 and 1), 64 input channels ci0.. and 64 output
// channels co0..: the bf16 halo kernel's walk (tc::k1_dk_bf16_halo) over
// position blocks of at most HF_BP.  Per block the phase's input sub-box
// and the block's cotangent rows arrive by TMA, each as two 32-channel
// boxes in the 128-byte swizzle.  The cotangent rows are N-major as B (Cout
// is contiguous), and TF32's wgmma reads B only K-major, so one pass
// transposes them into hi and lo tiles of 64 rows (co) by 32 positions, in
// the swizzle the descriptor names; the pass serves the CTA's taps, and the
// first Cin tile's p = 0 CTAs also sum the rows' columns there (the bias
// gradient's share).  A (ci, position) comes by 8-byte shared loads at each
// tap's window: logical row g of a warp's 16 is channel 2g, row g + 8
// channel 2g + 1, so that one load gives the two rows of a k column; the
// epilogue writes the rows back in channel order.  Each block's products
// start fresh accumulators, added to the thread's f32 sums at the block's
// end (the tensor cores round toward zero: see k1_dx_f32_halo); two taps a
// warpgroup leave the registers for both.  Splits as in bf16: the
// cluster's CTAs sum their 4 f32 tiles and bias sums in rank order into
// dk2[phase][tap][ci][co] and dbp[phase][co].
__global__ void __launch_bounds__(tc::HB_THREADS, 1)
k1_dk_f32_halo(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_g,
               float* __restrict__ dk2, float* __restrict__ dbp, int B, int D,
               int H, int W, int Cin, int Cout, Blocks bl, int splits) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bt_hi = base + HF_DK_STAGES * HF_DK_SLOT;
  const uint32_t bt_lo = bt_hi + HF_BT;
  const uint32_t full = bt_lo + HF_BT;  // a slot's copies landed
  int* qrho = reinterpret_cast<int*>(gbase + (full - base) +
                                     HF_DK_STAGES * 8);

  const int split = (int)tc::cluster_rank();
  const int co_tiles = Cout / 64;
  const int ci0 = (blockIdx.y / co_tiles) * 64;
  const int co0 = (blockIdx.y % co_tiles) * 64;
  const int phase = blockIdx.z >> 1, p = blockIdx.z & 1;
  const bool db_cta = ci0 == 0 && p == 0 && dbp != nullptr;
  const int a = phase >> 2, b = (phase >> 1) & 1, c = phase & 1;
  const int SD = bl.td + 1, SH = bl.th + 1, SW = bl.tw + 1;
  const int R = bl.tn * SD * SH * SW;
  const int P = bl.tn * bl.td * bl.th * bl.tw;
  const int nblk =
      ((B + bl.tn - 1) / bl.tn) * bl.nbd * bl.nbh * bl.nbw;

  // each block position's sub-box row at tap (0, 0, 0)
  for (int q = threadIdx.x; q < HF_BP; q += blockDim.x) {
    int t = q < P ? q : 0;
    const int iw = t % bl.tw;
    t /= bl.tw;
    const int ih = t % bl.th;
    t /= bl.th;
    const int id = t % bl.td;
    qrho[q] = (((t / bl.td) * SD + id) * SH + ih) * SW + iw;
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < HF_DK_STAGES; ++i) tc::mbar_init(full + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int b0, b1;
  bwd::split_range(nblk, splits, split, b0, b1);
  const int NU = b1 - b0;

  // block i's boxes into ring slot `slot`, by thread 0
  auto load = [&](int i, int slot) {
    int n0, d0, h0, w0;
    bl.origin(b0 + i, n0, d0, h0, w0);
    const uint32_t dst = base + slot * HF_DK_SLOT, bar = full + 8 * slot;
    tc::mbar_expect(bar, 2 * (R + P) * 128);
#pragma unroll
    for (int hc = 0; hc < 2; ++hc) {
      tc::tma_load_5d(dst + hc * HF_XH, &map_x, bar, ci0 + 32 * hc,
                      w0 + c - 1, h0 + b - 1, d0 + a - 1, n0);
      tc::tma_load_5d(dst + 2 * HF_XH + hc * HF_GH, &map_g, bar,
                      co0 + 32 * hc, 2 * w0 + c, 2 * h0 + b, 2 * d0 + a, n0);
    }
  };

  float acc[2][32], sum[2][32];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = sum[t][i] = 0.0f;
  uint32_t alo[2][2][4], ahi[2][2][4];
  float dbsum = 0.0f;  // column threadIdx % 64
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int lane = threadIdx.x & 31;
  const int tap_shift = p * SH * SW + wg * SW;  // taps (p, q = wg, r)
  // this lane's channels 2g, 2g + 1 of the warp's 16: which 32-channel
  // half, its 16-byte chunk there and the byte inside the chunk
  const int g = lane >> 2, kt = lane & 3;
  const uint32_t a_half = (warp >> 1) * HF_XH;
  const int a_chunk = 4 * (warp & 1) + (g >> 1);
  const int a_byte = 8 * (g & 1);

  if (threadIdx.x == 0)
    for (int s = 0; s < HF_DK_STAGES - 1 && s < NU; ++s) load(s, s);
  for (int i = 0; i < NU; ++i) {
    // every thread is done with block i - 1: its slot's reads, and (each
    // warpgroup waited for its wgmmas) the transposed tiles
    __syncthreads();
    if (threadIdx.x == 0 && i + HF_DK_STAGES - 1 < NU)
      load(i + HF_DK_STAGES - 1, (i + HF_DK_STAGES - 1) % HF_DK_STAGES);
    tc::mbar_wait(full + 8 * (i % HF_DK_STAGES), (i / HF_DK_STAGES) & 1);
    const uint32_t a_sub = base + (i % HF_DK_STAGES) * HF_DK_SLOT;
    const uint8_t* graw = gbase + (a_sub - base) + 2 * HF_XH;

    // the transpose: item (n, j, kb) takes positions 32kb + 4j .. + 3 of
    // channel n (0 past the block) into row n, chunk j of K block kb
#pragma unroll
    for (int e = 0; e < HF_BP * 64 / 4 / tc::HB_THREADS; ++e) {
      const int it = threadIdx.x + e * tc::HB_THREADS;
      const int n = it & 63, j = (it >> 6) & 7, kb = it >> 9;
      const int f = n & 31;
      uint32_t v[1][4], hi[1][4];
#pragma unroll
      for (int z = 0; z < 4; ++z) {
        const int q = 32 * kb + 4 * j + z;
        v[0][z] = q < P ? *reinterpret_cast<const uint32_t*>(
                              graw + (n >> 5) * HF_GH + q * 128 +
                              (((f >> 2) ^ (q & 7)) << 4) + (f & 3) * 4)
                        : 0u;
        if (db_cta) dbsum += __uint_as_float(v[0][z]);
      }
      split_regs<true>(v, hi);
      const uint32_t o = kb * (64 * 128) + n * 128 + ((j ^ (n & 7)) << 4);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       bt_hi + o),
                   "r"(hi[0][0]), "r"(hi[0][1]), "r"(hi[0][2]), "r"(hi[0][3])
                   : "memory");
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       bt_lo + o),
                   "r"(v[0][0]), "r"(v[0][1]), "r"(v[0][2]), "r"(v[0][3])
                   : "memory");
    }
    // make the tiles visible to the async proxy that wgmma reads through
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // k8 step s: positions 8s + t and 8s + t + 4 of the warpgroup's 2 taps
    // make one group of 6 wgmmas, on A registers of parity s % 2 (at most
    // one group stays in flight)
#pragma unroll
    for (int s = 0; s < HF_BP / 8; ++s) {
      const int rq0 = qrho[8 * s + kt] + tap_shift;
      const int rq1 = qrho[8 * s + kt + 4] + tap_shift;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int r0 = rq0 + r, r1 = rq1 + r;
        const uint2 p0 = lds64(a_sub + a_half + r0 * 128 +
                               ((a_chunk ^ (r0 & 7)) << 4) + a_byte);
        const uint2 p1 = lds64(a_sub + a_half + r1 * 128 +
                               ((a_chunk ^ (r1 & 7)) << 4) + a_byte);
        alo[s & 1][r][0] = p0.x;
        alo[s & 1][r][1] = p0.y;
        alo[s & 1][r][2] = p1.x;
        alo[s & 1][r][3] = p1.y;
      }
      split_regs<true>(alo[s & 1], ahi[s & 1]);
      tc::fence_regs(alo[s & 1]);
      tc::fence_regs(ahi[s & 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r) tc::fence_acc(acc[r]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t kofs = (s >> 2) * (64 * 128);
      const uint64_t dh = tc::desc(bt_hi + kofs) + 2 * (s & 3);
      const uint64_t dl = tc::desc(bt_lo + kofs) + 2 * (s & 3);
#pragma unroll
      for (int prod = 0; prod < 3; ++prod)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          wgmma_part(acc[r], ahi[s & 1][r], alo[s & 1][r], dh, dl, prod,
                     s > 0 || prod > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) tc::fence_acc(acc[r]);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tc::fence_acc(acc[r]);
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[r][e] += acc[r][e];
    }
  }
  __syncthreads();

  // the 4 f32 tiles, row (local tap 2*wg + r, ci) of 64 columns, into the
  // idle ring (row g of a warp's 16 is channel 2g, row g + 8 channel
  // 2g + 1); then the 4 row groups' bias sums
  float* stage = reinterpret_cast<float*>(gbase);
  float* dbs = stage + 4 * 64 * tc::HB_PITCH;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (wg * 2 + r) * 64 + warp * 16 + 2 * g + h;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(stage + row * tc::HB_PITCH + 8 * j +
                                   2 * kt) =
            make_float2(sum[r][4 * j + 2 * h], sum[r][4 * j + 2 * h + 1]);
    }
  dbs[threadIdx.x] = dbsum;
  tc::cluster_sync();

  int r0, r1;
  bwd::split_range(4 * 64, splits, split, r0, r1);
  for (int idx = threadIdx.x; idx < (r1 - r0) * 16; idx += blockDim.x) {
    const int row = r0 + idx / 16, c4 = idx % 16;
    const uint32_t off = base + (row * tc::HB_PITCH + 4 * c4) * 4;
    float4 s = tc::ld_cluster4(off, 0);
    for (int q = 1; q < splits; ++q) {
      const float4 v = tc::ld_cluster4(off, q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int tap = 4 * p + (row >> 6), ci = row & 63;
    *reinterpret_cast<float4*>(
        dk2 + (((size_t)phase * 8 + tap) * Cin + ci0 + ci) * Cout + co0 +
        4 * c4) = s;
  }
  if (db_cta && split == 0 && threadIdx.x < 64) {
    const uint32_t off = base + (4 * 64 * tc::HB_PITCH + threadIdx.x) * 4;
    float s = 0.0f;
    for (int q = 0; q < splits; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k) s += tc::ld_cluster(off + k * 256, q);
    dbp[phase * Cout + co0 + threadIdx.x] = s;
  }
  tc::cluster_sync();
}

// The f32 halo dx kernel's weights in one pass: wt[part][ci][off*Cout + co]
// = the TF32 hi (part 0) or lo (part 1) of kp[phase][co][tap*Cin + ci], off
// = 16*(2p + a) + 4*(2q + b) + 2r + c for phase (a, b, c) and tap (p, q,
// r) (pack_backward_kernels() and split_tf32() in ops/upsample_conv.py).
// A block transposes a 32 x 32 tile of (co, ci) of one (phase, tap) through
// shared memory, so that both the reads (ci) and the writes (co) are
// contiguous; it is bound by its bytes (read kp once, write two parts).
__global__ void __launch_bounds__(256)
k1_pack_tf32(const float* __restrict__ kp, float* __restrict__ wt, int Cin,
             int Cout) {
  __shared__ float tile[32][33];
  const int pt = blockIdx.z;  // phase * 8 + tap
  const int phase = pt >> 3, tap = pt & 7;
  const int a = phase >> 2, b = (phase >> 1) & 1, c = phase & 1;
  const int off = 16 * (2 * (tap >> 2) + a) + 4 * (2 * ((tap >> 1) & 1) + b) +
                  2 * (tap & 1) + c;
  const int co0 = blockIdx.y * 32, ci0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int co = co0 + ty + 8 * k;
    tile[ty + 8 * k][tx] =
        kp[((size_t)phase * Cout + co) * 8 * Cin + (size_t)tap * Cin + ci0 +
           tx];
  }
  __syncthreads();
  const size_t plane = (size_t)Cin * 64 * Cout;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ci = ci0 + ty + 8 * k;
    uint32_t hi, lo;
    split_tf32<false>(__float_as_uint(tile[tx][ty + 8 * k]), hi, lo);
    const size_t o = (size_t)ci * 64 * Cout + (size_t)off * Cout + co0 + tx;
    wt[o] = __uint_as_float(hi);
    wt[plane + o] = __uint_as_float(lo);
  }
}

// ------------------ forward, f32: halo boxes, 3xTF32 wgmma (k1_f32_halo)

// The forward's limits: a phase's sub-box rows (32 bytes each), ring
// stages, output channels a work item, and a unit's weights in bytes (8
// taps x (hi, lo) x 64 rows of 8 floats)
constexpr int HF_FW_RMAX = 768;
constexpr int HF_FW_STAGES = 4;
constexpr int HF_FW_BN = 64;
constexpr int HF_FW_B = 16 * HF_FW_BN * 32;

__host__ __device__ constexpr int f32_fw_slot() {
  return HF_FW_RMAX * 32 + HF_FW_B;
}

__host__ __device__ constexpr int f32_fw_smem_bytes() {
  return HF_FW_STAGES * f32_fw_slot() + HF_FW_STAGES * 16 + 1024;
}

// a contiguous copy of `bytes` from device memory into shared memory,
// counted on an mbarrier like a TMA box
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// K1's forward in f32: the halo walk of k1_dx_f32_halo with the roles of
// the operands swapped.  A work item is one phase (a, b, c), one block of
// at most BM = 64 * NWG positions (tn, td, th, tw) and 64 output
// channels co0..; items are ordered phase fastest, then block, then the
// channel tile, so that the 8 phases of a block, which read the same input
// rows, run together, and the CTAs at work share one tile's weights.  The
// kernel is persistent: a CTA an SM walks the items gridDim.x apart, and
// its producer warp runs on into the next item while the consumers store
// the last one.  An item's reduction runs over units of 8 input channels
// c0..: per unit the phase's input sub-box of those channels (x at (d0 + a
// - 1 + ld, ...), R rows of 32 bytes, zero outside the input: one TMA box,
// 32-byte swizzle) and the unit's weights, 8 taps x (hi, lo) tiles of 64
// rows (co) by 8 floats (k), K-major as TF32's wgmma needs B, laid out and
// swizzled by k1_pack_fwd_tf32 so that they are one bulk copy.  Tap (p, q,
// r) of position (in, id, ih, iw) reads sub-box row (in, id+p, ih+q, iw+r)
// by ldmatrix, which on f32 rows gives the tf32 A fragment of a k8 step;
// A is split into hi and lo in registers, and each product taken as three
// TF32 wgmmas.  Consumer warpgroup w holds rows 64w.. of the tile (two
// tiles a warpgroup would need 168 registers, and spilled).  Each unit's
// products start a fresh accumulator, added at the unit's end to the
// thread's f32 sums (the tensor cores round their sums toward zero); the
// epilogue adds the bias and stores straight into the interleaved output.
template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
k1_f32_halo(const __grid_constant__ CUtensorMap map_x,
            const float* __restrict__ wf, const float* __restrict__ bias,
            float* __restrict__ out, int B, int D, int H, int W, int Cin,
            int Cout, Blocks bl) {
  constexpr int CONSUMERS = NWG * 128;
  constexpr int A_BYTES = HF_FW_RMAX * 32;
  constexpr int SLOT = f32_fw_slot();
  constexpr int STAGES = HF_FW_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * SLOT, empty = full + 8 * STAGES;

  const int SD = bl.td + 1, SH = bl.th + 1, SW = bl.tw + 1;
  const int R = bl.tn * SD * SH * SW;
  const int P = bl.tn * bl.td * bl.th * bl.tw;
  const int nblk = ((B + bl.tn - 1) / bl.tn) * bl.nbd * bl.nbh * bl.nbw;
  const int items = 8 * nblk * (Cout / HF_FW_BN);
  const int U = Cin / 8;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      tc::mbar_init(full + 8 * i, 1);
      tc::mbar_init(empty + 8 * i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (warp_id == CONSUMERS / 32) {
    // the producer: the k-th unit of this CTA into slot k % STAGES once
    // the consumers have released the unit STAGES back
    if (lane == 0) {
      int k = 0;
      for (int wi = blockIdx.x; wi < items; wi += gridDim.x) {
        const int phase = wi & 7, rest = wi >> 3;
        int n0, d0, h0, w0;
        bl.origin(rest % nblk, n0, d0, h0, w0);
        const int a = phase >> 2, b = (phase >> 1) & 1, c = phase & 1;
        const float* wu =
            wf + (size_t)((rest / nblk) * 8 + phase) * U * (HF_FW_B / 4);
        for (int u = 0; u < U; ++u, ++k) {
          const int slot = k % STAGES;
          if (k >= STAGES)
            tc::mbar_wait(empty + 8 * slot, (k / STAGES - 1) & 1);
          const uint32_t dst = base + slot * SLOT, bar = full + 8 * slot;
          tc::mbar_expect(bar, R * 32 + HF_FW_B);
          tc::tma_load_5d(dst, &map_x, bar, 8 * u, w0 + c - 1, h0 + b - 1,
                          d0 + a - 1, n0);
          bulk_load(dst + A_BYTES, wu + (size_t)u * (HF_FW_B / 4), HF_FW_B,
                    bar);
        }
      }
    }
    __syncwarp();
    return;
  }

  // the consumers: this lane's ldmatrix row (position m of the warp's 16)
  // at tap (0, 0, 0), and its 16-byte chunk kc
  const int wg = warp_id >> 2, warp = warp_id & 3;
  const int kc = lane >> 4;
  int rho0;
  {
    const int m = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int q = m < P ? m : 0;  // rows past the block read a real row, unstored
    const int iw = q % bl.tw;
    q /= bl.tw;
    const int ih = q % bl.th;
    q /= bl.th;
    const int id = q % bl.td;
    rho0 = (((q / bl.td) * SD + id) * SH + ih) * SW + iw;
  }

  float acc[32], sum[32];
  uint32_t alo[2][1][4], ahi[2][1][4];
  int k = 0;
  for (int wi = blockIdx.x; wi < items; wi += gridDim.x) {
    const int phase = wi & 7, rest = wi >> 3;
    const int co0 = (rest / nblk) * HF_FW_BN;
    int n0, d0, h0, w0;
    bl.origin(rest % nblk, n0, d0, h0, w0);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = sum[e] = 0.0f;

    for (int u = 0; u < U; ++u, ++k) {
      const int slot = k % STAGES;
      tc::mbar_wait(full + 8 * slot, (k / STAGES) & 1);
      const uint32_t a_sub = base + slot * SLOT;
      const uint32_t b_sub = a_sub + A_BYTES;
      // a tap's wgmmas are one group, on A registers of the tap's parity:
      // at most one group stays in flight, so the registers an ldmatrix
      // refills were last read two groups back
#pragma unroll
      for (int tap = 0; tap < 8; ++tap) {
        const int par = tap & 1;
        const int shift =
            (tap >> 2) * SH * SW + ((tap >> 1) & 1) * SW + (tap & 1);
        const int rho = rho0 + shift;
        tc::ldsm_x4(alo[par][0],
                    a_sub + rho * 32 + ((kc ^ ((rho >> 2) & 1)) << 4));
        split_regs<true>(alo[par], ahi[par]);
        tc::fence_regs(alo[par]);
        tc::fence_regs(ahi[par]);
        tc::fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        const uint32_t bt = b_sub + 2 * tap * 2048;
#pragma unroll
        for (int prod = 0; prod < 3; ++prod)
          wgmma_part(acc, ahi[par][0], alo[par][0], desc_b32(bt),
                     desc_b32(bt + 2048), prod, tap > 0 || prod > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        tc::fence_acc(acc);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      tc::fence_acc(acc);
#pragma unroll
      for (int e = 0; e < 32; ++e) sum[e] += acc[e];
      tc::mbar_arrive(empty + 8 * slot);  // the unit's slot is read
    }

    // epilogue: register 4j + 2h + e of (warp, lane) holds row warp*16 +
    // lane/4 + 8h, column 8j + 2*(lane%4) + e of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int q = wg * 64 + warp * 16 + (lane >> 2) + 8 * h;
      if (q >= P) continue;
      const int iw = w0 + q % bl.tw;
      q /= bl.tw;
      const int ih = h0 + q % bl.th;
      q /= bl.th;
      const int id = d0 + q % bl.td;
      const int in = n0 + q / bl.td;
      if (in >= B || id >= D || ih >= H || iw >= W) continue;
      float* dst = out +
                   out_row(make_int4(in, id, ih, iw), phase, D, H, W, Cout) +
                   co0 + 2 * (lane & 3);
      const float* bb = bias + co0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(bb + 8 * j);
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(sum[4 * j + 2 * h] + bv.x,
                        sum[4 * j + 2 * h + 1] + bv.y);
      }
    }
  }
}

// The forward halo kernel's weights in one pass: for each (channel tile,
// phase, unit of 8 input channels, tap), the tap's TF32 hi then lo tile of
// kp[phase][co0 + r][tap*Cin + 8u + k], r < 64, k < 8, each 64 rows of 32
// bytes in the 32-byte swizzle (16-byte chunk kc of row r at kc ^ (r/4 %
// 2)), so that a unit's 32 KB are one contiguous copy
// (pack_phase_kernels_tf32() in ops/upsample_conv.py is the plain
// version).  A thread takes 8 input channels of one (phase, co, tap): its
// reads are 32 contiguous bytes, next to its neighbours'.
__global__ void __launch_bounds__(256)
k1_pack_fwd_tf32(const float* __restrict__ kp, float* __restrict__ wf,
                 int Cin, int Cout) {
  const int U = Cin / 8;
  const long long n = 64LL * Cout * U;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int u = (int)(i % U);
    long long t = i / U;
    const int tap = (int)(t & 7);
    t >>= 3;
    const int co = (int)(t % Cout), phase = (int)(t / Cout);
    const float4* src = reinterpret_cast<const float4*>(
        kp + ((size_t)phase * Cout + co) * 8 * Cin + (size_t)tap * Cin +
        8 * u);
    uint32_t v[8], hi[8], lo[8];
    const float4 v0 = src[0], v1 = src[1];
    v[0] = __float_as_uint(v0.x), v[1] = __float_as_uint(v0.y);
    v[2] = __float_as_uint(v0.z), v[3] = __float_as_uint(v0.w);
    v[4] = __float_as_uint(v1.x), v[5] = __float_as_uint(v1.y);
    v[6] = __float_as_uint(v1.z), v[7] = __float_as_uint(v1.w);
#pragma unroll
    for (int e = 0; e < 8; ++e) split_tf32<false>(v[e], hi[e], lo[e]);
    const int r = co & 63, sw = (r >> 2) & 1;
    uint4* tile = reinterpret_cast<uint4*>(
        wf + ((((size_t)((co >> 6) * 8 + phase) * U + u) * 8 + tap) * 2) *
                 512 +
        r * 8);
    tile[sw] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    tile[sw ^ 1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    tile[128 + sw] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    tile[128 + (sw ^ 1)] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
  }
}

}  // namespace tf

// ----------------------- backward, FMA: any width, misaligned operands

namespace bfma {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;  // 4 x 4 a thread
constexpr int PITCH = 68;  // floats per smem row; keeps float4 reads aligned

using general::from_float;
using general::to_float;

// dx in exact FMA, for any widths: scalar loads masked by element.
template <typename T>
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

// dk in exact FMA, for any widths: per CTA one phase, 64 rows of (tap, ci)
// (rows may straddle taps; scalar loads), 64 output channels, one split of
// the positions in slices of BK
template <typename T>
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

// ----------------------------------------------------- backward launchers

// A split count must leave every split at least one slice.
bool bad_splits(int splits, long long slices) {
  return splits < 1 || splits > slices;
}

// A launch with thread-block clusters of `cluster` CTAs along x.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid,
                             int threads, int smem, int cluster,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The block grid of a halo kernel, or false if the block does not fit it:
// extents >= 1 and inside the tensor, at most `positions` positions and
// `rows` sub-box rows, tn < 256 (packed in 8 bits), blocks < 65536.
bool halo_blocks(int B, int D, int H, int W, int tn, int td, int th, int tw,
                 int positions, int rows, tc::Blocks& bl, long long& count) {
  if (tn < 1 || td < 1 || th < 1 || tw < 1 || tn > 255 || tn > B ||
      td > D || th > H || tw > W ||
      (long long)tn * td * th * tw > positions ||
      (long long)tn * (td + 1) * (th + 1) * (tw + 1) > rows)
    return false;
  bl = tc::Blocks{tn, td, th, tw, (D + td - 1) / td, (H + th - 1) / th,
                  (W + tw - 1) / tw};
  count = (long long)((B + tn - 1) / tn) * bl.nbd * bl.nbh * bl.nbw;
  return count < 65536;
}

// cuTensorMapEncodeTiled, reached through the runtime (the library links
// no libcuda); null where the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The driver's encoder needs a current context, and the runtime binds a
// device's primary context to a thread lazily: on a thread that has made
// no such call yet (autograd's worker thread, at the first backward), the
// encoder failed with CUDA_ERROR_INVALID_CONTEXT.  cudaSetDevice binds it.
cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaSetDevice(dev) : err;
}

// The tensor map of a contiguous bf16 or f32 tensor of `rank` dims
// (innermost first), its box, the box's element strides and swizzle; boxes
// read 0 outside the tensor.
bool tensor_map(CUtensorMap* map, bool f32, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint32_t* box,
                const cuuint32_t* steps, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4], bytes = f32 ? 4 : 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  return encode(map,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                rank, const_cast<void*>(ptr), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB>
int launch_dx_halo(const void* g, const void* kp, void* dx, int B, int D,
                   int H, int W, int Cin, int Cout, const tc::Blocks& bl,
                   long long blocks, int splits, cudaStream_t stream) {
  // the cotangent (Cout, 2W, 2H, 2D, B), a phase's sub-grid a box of 16
  // channels; the weights kp (8*Cin, Cout, 8), boxes of 64 x 16
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_g, map_k;
  const cuuint64_t gdims[5] = {(cuuint64_t)Cout, 2ull * W, 2ull * H,
                               2ull * D, (cuuint64_t)B};
  const cuuint32_t gbox[5] = {tc::HB_CO, 2u * (bl.tw + 1), 2u * (bl.th + 1),
                              2u * (bl.td + 1), (cuuint32_t)bl.tn};
  const cuuint32_t gsteps[5] = {1, 2, 2, 2, 1};
  const cuuint64_t kdims[3] = {8ull * Cin, (cuuint64_t)Cout, 8};
  const cuuint32_t kbox[3] = {64, tc::HB_CO, 1}, ksteps[3] = {1, 1, 1};
  if (!tensor_map(&map_g, false, g, 5, gdims, gbox, gsteps,
                  CU_TENSOR_MAP_SWIZZLE_32B) ||
      !tensor_map(&map_k, false, kp, 3, kdims, kbox, ksteps,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = tc::dx_smem_bytes(NB);
  static SmemLimit limit;
  err = limit.ensure(tc::k1_dx_bf16_halo<NB>, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(
      tc::k1_dx_bf16_halo<NB>,
      dim3((unsigned)splits, (unsigned)(Cin / (64 * NB)), (unsigned)blocks),
      tc::HB_CTA_THREADS, smem, splits, stream, map_g, map_k, static_cast<__nv_bfloat16*>(dx), B,
      D, H, W, Cin, Cout, bl, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_dk_halo(const void* x, const void* g, void* dk2, void* dbp, int B,
                   int D, int H, int W, int Cin, int Cout,
                   const tc::Blocks& bl, int splits, cudaStream_t stream) {
  // the input (Cin, W, H, D, B), a phase's sub-box a box of 64 channels;
  // the cotangent (Cout, 2W, 2H, 2D, B), a block's rows of one phase a box
  // of 64 channels striding 2
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x, map_g;
  const cuuint64_t xdims[5] = {(cuuint64_t)Cin, (cuuint64_t)W,
                               (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint32_t xbox[5] = {64, (cuuint32_t)bl.tw + 1,
                              (cuuint32_t)bl.th + 1, (cuuint32_t)bl.td + 1,
                              (cuuint32_t)bl.tn};
  const cuuint32_t xsteps[5] = {1, 1, 1, 1, 1};
  const cuuint64_t gdims[5] = {(cuuint64_t)Cout, 2ull * W, 2ull * H,
                               2ull * D, (cuuint64_t)B};
  const cuuint32_t gbox[5] = {64, 2u * bl.tw, 2u * bl.th, 2u * bl.td,
                              (cuuint32_t)bl.tn};
  const cuuint32_t gsteps[5] = {1, 2, 2, 2, 1};
  if (!tensor_map(&map_x, false, x, 5, xdims, xbox, xsteps,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&map_g, false, g, 5, gdims, gbox, gsteps,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = tc::dk_smem_bytes();
  static SmemLimit limit;
  err = limit.ensure(tc::k1_dk_bf16_halo, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(
      tc::k1_dk_bf16_halo,
      dim3((unsigned)splits, (unsigned)((Cin / 64) * (Cout / 64)), 8),
      tc::HB_THREADS, smem, splits, stream, map_x, map_g, static_cast<float*>(dk2),
      static_cast<float*>(dbp), B, D, H, W, Cin, Cout, bl, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NB>
int launch_dx_f32_halo(const void* g, const void* wt, void* dx, int B, int D,
                       int H, int W, int Cin, int Cout, const tc::Blocks& bl,
                       long long blocks, int splits, cudaStream_t stream) {
  // the cotangent (Cout, 2W, 2H, 2D, B), a phase's sub-grid a box of 8
  // channels; the weights' TF32 parts wt (64*Cout, Cin, 2), boxes of 8 x
  // 64*NB
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_g, map_w;
  const cuuint64_t gdims[5] = {(cuuint64_t)Cout, 2ull * W, 2ull * H,
                               2ull * D, (cuuint64_t)B};
  const cuuint32_t gbox[5] = {tf::HF_CO, 2u * (bl.tw + 1), 2u * (bl.th + 1),
                              2u * (bl.td + 1), (cuuint32_t)bl.tn};
  const cuuint32_t gsteps[5] = {1, 2, 2, 2, 1};
  const cuuint64_t wdims[3] = {64ull * Cout, (cuuint64_t)Cin, 2};
  const cuuint32_t wbox[3] = {tf::HF_CO, 64u * NB, 1}, wsteps[3] = {1, 1, 1};
  if (!tensor_map(&map_g, true, g, 5, gdims, gbox, gsteps,
                  CU_TENSOR_MAP_SWIZZLE_32B) ||
      !tensor_map(&map_w, true, wt, 3, wdims, wbox, wsteps,
                  CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = tf::f32_dx_smem_bytes(NB);
  static SmemLimit limit;
  err = limit.ensure(tf::k1_dx_f32_halo<NB>, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(
      tf::k1_dx_f32_halo<NB>,
      dim3((unsigned)splits, (unsigned)(Cin / (64 * NB)), (unsigned)blocks),
      tc::HB_CTA_THREADS, smem, splits, stream, map_g, map_w,
      static_cast<float*>(dx), B, D, H, W, Cin, Cout, bl, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_dk_f32_halo(const void* x, const void* g, void* dk2, void* dbp,
                       int B, int D, int H, int W, int Cin, int Cout,
                       const tc::Blocks& bl, int splits, cudaStream_t stream) {
  // the input (Cin, W, H, D, B), a phase's sub-box two boxes of 32
  // channels; the cotangent (Cout, 2W, 2H, 2D, B), a block's rows of one
  // phase two boxes of 32 channels striding 2
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x, map_g;
  const cuuint64_t xdims[5] = {(cuuint64_t)Cin, (cuuint64_t)W,
                               (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint32_t xbox[5] = {32, (cuuint32_t)bl.tw + 1,
                              (cuuint32_t)bl.th + 1, (cuuint32_t)bl.td + 1,
                              (cuuint32_t)bl.tn};
  const cuuint32_t xsteps[5] = {1, 1, 1, 1, 1};
  const cuuint64_t gdims[5] = {(cuuint64_t)Cout, 2ull * W, 2ull * H,
                               2ull * D, (cuuint64_t)B};
  const cuuint32_t gbox[5] = {32, 2u * bl.tw, 2u * bl.th, 2u * bl.td,
                              (cuuint32_t)bl.tn};
  const cuuint32_t gsteps[5] = {1, 2, 2, 2, 1};
  if (!tensor_map(&map_x, true, x, 5, xdims, xbox, xsteps,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&map_g, true, g, 5, gdims, gbox, gsteps,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = tf::f32_dk_smem_bytes();
  static SmemLimit limit;
  err = limit.ensure(tf::k1_dk_f32_halo, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_clustered(
      tf::k1_dk_f32_halo,
      dim3((unsigned)splits, (unsigned)((Cin / 64) * (Cout / 64)), 16),
      tc::HB_THREADS, smem, splits, stream, map_x, map_g,
      static_cast<float*>(dk2), static_cast<float*>(dbp), B, D, H, W, Cin,
      Cout, bl, splits);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NWG>
int launch_f32_halo(const void* x, const void* wf, const void* bias,
                    void* out, int B, int D, int H, int W, int Cin, int Cout,
                    const tc::Blocks& bl, long long blocks,
                    cudaStream_t stream) {
  // the input (Cin, W, H, D, B), a phase's sub-box a box of 8 channels
  cudaError_t err = bind_context();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_x;
  const cuuint64_t xdims[5] = {(cuuint64_t)Cin, (cuuint64_t)W,
                               (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint32_t xbox[5] = {8, (cuuint32_t)bl.tw + 1,
                              (cuuint32_t)bl.th + 1, (cuuint32_t)bl.td + 1,
                              (cuuint32_t)bl.tn};
  const cuuint32_t xsteps[5] = {1, 1, 1, 1, 1};
  if (!tensor_map(&map_x, true, x, 5, xdims, xbox, xsteps,
                  CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = tf::f32_fw_smem_bytes();
  static SmemLimit limit;
  err = limit.ensure(tf::k1_f32_halo<NWG>, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one CTA an SM, or one an item if there are fewer
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long items = 8 * blocks * (Cout / tf::HF_FW_BN);
  tf::k1_f32_halo<NWG>
      <<<(unsigned)(items < sms ? items : sms), NWG * 128 + 32, smem,
         stream>>>(map_x, static_cast<const float*>(wf),
                   static_cast<const float*>(bias), static_cast<float*>(out),
                   B, D, H, W, Cin, Cout, bl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx_fma(const void* g, const void* wb, void* dx, void* part, int B,
                  int D, int H, int W, int Cin, int Cout, int bm, int bn,
                  int splits, void* stream) {
  using namespace bfma;
  const long long M = (long long)B * D * H * W;
  if (bm != BM || bn != BN ||
      bad_splits(splits, 64LL * ((Cout + BK - 1) / BK)))
    return (int)cudaErrorInvalidValue;
  k1_dx_fma<T>
      <<<(unsigned)(((M + BM - 1) / BM) * ((Cin + BN - 1) / BN) * splits),
         THREADS, 0, (cudaStream_t)stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(wb),
          static_cast<T*>(dx), static_cast<float*>(part), B, D, H, W, Cin,
          Cout, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dk_fma(const void* x, const void* g, void* part, int B, int D,
                  int H, int W, int Cin, int Cout, int bm, int bn, int splits,
                  void* stream) {
  using namespace bfma;
  const long long M = (long long)B * D * H * W;
  if (bm != BM || bn != BN || bad_splits(splits, (M + BK - 1) / BK))
    return (int)cudaErrorInvalidValue;
  k1_dk_fma<T>
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

// the f32 halo forward's weight split: kp into wf
int launch_pack_fwd(const void* kp, void* wf, int Cin, int Cout,
                    cudaStream_t stream) {
  tf::k1_pack_fwd_tf32<<<pass_grid(64LL * Cout * (Cin / 8)), 256, 0,
                         stream>>>(static_cast<const float*>(kp),
                                   static_cast<float*>(wf), Cin, Cout);
  return (int)cudaGetLastError();
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
// contiguous on the current device.  The fast entry takes bf16 only, with
// 16-byte aligned x, kp and bias and Cin % 64 == 0, and the tile (bm, bn),
// one of 128 x 128, 128 x 64, 64 x 64, with Cout % bn == 0.
int prdisagg_upsample2_conv3_fast_bf16(const void* x, const void* kp,
                                       const void* bias, void* out, int B,
                                       int D, int H, int W, int Cin, int Cout,
                                       int bm, int bn, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (Cin % tc::BK != 0 || Cout % bn != 0) return (int)cudaErrorInvalidValue;
  if (bm == 128 && bn == 128)
    return launch_bf16<128, 128>(x, kp, bias, out, B, D, H, W, Cin, Cout, st);
  if (bm == 128 && bn == 64)
    return launch_bf16<128, 64>(x, kp, bias, out, B, D, H, W, Cin, Cout, st);
  if (bm == 64 && bn == 64)
    return launch_bf16<64, 64>(x, kp, bias, out, B, D, H, W, Cin, Cout, st);
  return (int)cudaErrorInvalidValue;
}

// The f32 halo forward, two launches: kp's TF32 parts into the workspace
// wf (2 * 8 * Cout * 8 * Cin floats) by k1_pack_fwd_tf32, then the
// kernel.  x, kp, bias and out as above, f32, all contiguous on the
// current device and 16-byte aligned, Cin % 8 == 0, Cout % 64 == 0.  The
// tile bm (256, 192 or 128 positions) and the block (tn, td, th, tw) of at
// most bm positions come from k1_plan().
int prdisagg_upsample2_conv3_halo_f32(const void* x, const void* kp,
                                      void* wf, const void* bias, void* out,
                                      int B, int D, int H, int W, int Cin,
                                      int Cout, int bm, int tn, int td,
                                      int th, int tw, void* stream) {
  tc::Blocks bl;
  long long blocks;
  if (Cin % 8 != 0 || Cout % tf::HF_FW_BN != 0 ||
      (bm != 256 && bm != 192 && bm != 128) ||
      !halo_blocks(B, D, H, W, tn, td, th, tw, bm, tf::HF_FW_RMAX, bl,
                   blocks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_pack_fwd(kp, wf, Cin, Cout, st);
  if (err != 0) return err;
  if (bm == 256)
    return launch_f32_halo<4>(x, wf, bias, out, B, D, H, W, Cin, Cout, bl,
                              blocks, st);
  if (bm == 192)
    return launch_f32_halo<3>(x, wf, bias, out, B, D, H, W, Cin, Cout, bl,
                              blocks, st);
  return launch_f32_halo<2>(x, wf, bias, out, B, D, H, W, Cin, Cout, bl,
                            blocks, st);
}

// wf for prdisagg_upsample2_conv3_halo_f32 from kp (8 phases, Cout, 8*Cin)
// f32: (Cout/64, 8, Cin/8, 8, 2, 64, 8) f32, 2 * 8 * Cout * 8 * Cin floats.
// Cin % 8 == 0, Cout % 64 == 0, kp 16-byte aligned.
int prdisagg_k1_pack_fwd_tf32(const void* kp, void* wf, int Cin, int Cout,
                              void* stream) {
  if (Cin % 8 != 0 || Cout % tf::HF_FW_BN != 0 || Cin < 8)
    return (int)cudaErrorInvalidValue;
  return launch_pack_fwd(kp, wf, Cin, Cout, (cudaStream_t)stream);
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

// K1's backward, bf16 on the halo kernels.  g (B, 2D, 2H, 2W, Cout) and
// x (B, D, H, W, Cin) bf16; kp (8 phases, Cout, 8*Cin) bf16, the forward's
// packing by pack_phase_kernels(), read in place; dx (B, D, H, W, Cin) bf16;
// dk2 (8 phases, 8 taps, Cin, Cout) f32 and dbp (8 phases, Cout) f32 (may
// be null: no bias sums) for prdisagg_k1_dk_fold.  All contiguous on the
// current device and 16-byte aligned, Cin and Cout multiples of 64.  The
// block (tn, td, th, tw) and the cluster size `splits` (1..8, at most the
// reduction's units) come from k1_backward_plan().
int prdisagg_k1_dx_halo_bf16(const void* g, const void* kp, void* dx, int B,
                             int D, int H, int W, int Cin, int Cout, int tn,
                             int td, int th, int tw, int splits,
                             void* stream) {
  tc::Blocks bl;
  long long blocks;
  if (Cin % 64 != 0 || Cout % 64 != 0 || splits < 1 ||
      splits > tc::MAX_CLUSTER || splits > 8 * (Cout / tc::HB_CO) ||
      !halo_blocks(B, D, H, W, tn, td, th, tw, tc::HB_BM, tc::DX_RMAX, bl,
                   blocks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return Cin % 128 == 0
             ? launch_dx_halo<2>(g, kp, dx, B, D, H, W, Cin, Cout, bl, blocks,
                                 splits, st)
             : launch_dx_halo<1>(g, kp, dx, B, D, H, W, Cin, Cout, bl, blocks,
                                 splits, st);
}

int prdisagg_k1_dk_halo_bf16(const void* x, const void* g, void* dk2,
                             void* dbp, int B, int D, int H, int W, int Cin,
                             int Cout, int tn, int td, int th, int tw,
                             int splits, void* stream) {
  tc::Blocks bl;
  long long blocks;
  if (Cin % 64 != 0 || Cout % 64 != 0 || splits < 1 ||
      splits > tc::MAX_CLUSTER ||
      !halo_blocks(B, D, H, W, tn, td, th, tw, tc::HB_BP, tc::DK_RMAX, bl,
                   blocks) ||
      splits > blocks)
    return (int)cudaErrorInvalidValue;
  return launch_dk_halo(x, g, dk2, dbp, B, D, H, W, Cin, Cout, bl, splits,
                        (cudaStream_t)stream);
}

// K1's backward, f32 on the halo kernels.  g (B, 2D, 2H, 2W, Cout) and
// x (B, D, H, W, Cin) f32; wt (2, Cin, 64*Cout) f32, the TF32 hi and lo
// parts of pack_backward_kernels()'s weights (split_tf32(), k = off*Cout +
// co); dx (B, D, H, W, Cin) f32; dk2 and dbp as for bf16.  All contiguous
// on the current device and 16-byte aligned, Cin and Cout multiples of 64.
// The block and the cluster size `splits` (1..8, at most the reduction's
// units) come from k1_backward_plan().
int prdisagg_k1_dx_halo_f32(const void* g, const void* wt, void* dx, int B,
                            int D, int H, int W, int Cin, int Cout, int tn,
                            int td, int th, int tw, int splits,
                            void* stream) {
  tc::Blocks bl;
  long long blocks;
  if (Cin % 64 != 0 || Cout % 64 != 0 || splits < 1 ||
      splits > tc::MAX_CLUSTER || splits > 8 * (Cout / tf::HF_CO) ||
      !halo_blocks(B, D, H, W, tn, td, th, tw, tf::HF_BM, tf::HF_DX_RMAX, bl,
                   blocks))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return Cin % 128 == 0
             ? launch_dx_f32_halo<2>(g, wt, dx, B, D, H, W, Cin, Cout, bl,
                                     blocks, splits, st)
             : launch_dx_f32_halo<1>(g, wt, dx, B, D, H, W, Cin, Cout, bl,
                                     blocks, splits, st);
}

// wt (2, Cin, 64*Cout) f32 for prdisagg_k1_dx_halo_f32 from the forward's
// packing kp (8 phases, Cout, 8*Cin) f32: pack_backward_kernels() split by
// split_tf32() in one pass.  Cin and Cout multiples of 32.
int prdisagg_k1_pack_tf32(const void* kp, void* wt, int Cin, int Cout,
                          void* stream) {
  if (Cin % 32 != 0 || Cout % 32 != 0 || Cin < 32 || Cout < 32)
    return (int)cudaErrorInvalidValue;
  tf::k1_pack_tf32<<<dim3((unsigned)(Cin / 32), (unsigned)(Cout / 32), 64),
                     256, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(kp), static_cast<float*>(wt), Cin, Cout);
  return (int)cudaGetLastError();
}

int prdisagg_k1_dk_halo_f32(const void* x, const void* g, void* dk2,
                            void* dbp, int B, int D, int H, int W, int Cin,
                            int Cout, int tn, int td, int th, int tw,
                            int splits, void* stream) {
  tc::Blocks bl;
  long long blocks;
  if (Cin % 64 != 0 || Cout % 64 != 0 || splits < 1 ||
      splits > tc::MAX_CLUSTER ||
      !halo_blocks(B, D, H, W, tn, td, th, tw, tf::HF_BP, tf::HF_DK_RMAX, bl,
                   blocks) ||
      splits > blocks)
    return (int)cudaErrorInvalidValue;
  return launch_dk_f32_halo(x, g, dk2, dbp, B, D, H, W, Cin, Cout, bl,
                            splits, (cudaStream_t)stream);
}

// K1's backward at any widths (and on misaligned operands), on the FMA
// kernels.  g and x as above in one dtype; wb (Cin, 64*Cout) of that
// dtype, packed by pack_backward_kernels(); dx of that dtype, written when
// splits == 1, else part (splits, B*D*H*W, Cin) f32 for
// prdisagg_k1_dx_reduce_*; dk's part (splits, 8 phases, 8*Cin, Cout) f32
// for prdisagg_k1_dk_fold.  All contiguous on the current device.  Tiles
// (64, 64) and splits come from k1_backward_plan().
int prdisagg_k1_dx_general_f32(const void* g, const void* wb, void* dx,
                               void* part, int B, int D, int H, int W,
                               int Cin, int Cout, int bm, int bn, int splits,
                               void* stream) {
  return launch_dx_fma<float>(g, wb, dx, part, B, D, H, W, Cin, Cout, bm,
                              bn, splits, stream);
}

int prdisagg_k1_dx_general_bf16(const void* g, const void* wb, void* dx,
                                void* part, int B, int D, int H, int W,
                                int Cin, int Cout, int bm, int bn, int splits,
                                void* stream) {
  return launch_dx_fma<__nv_bfloat16>(g, wb, dx, part, B, D, H, W, Cin,
                                      Cout, bm, bn, splits, stream);
}

int prdisagg_k1_dk_general_f32(const void* x, const void* g, void* part,
                               int B, int D, int H, int W, int Cin, int Cout,
                               int bm, int bn, int splits, void* stream) {
  return launch_dk_fma<float>(x, g, part, B, D, H, W, Cin, Cout, bm, bn,
                              splits, stream);
}

int prdisagg_k1_dk_general_bf16(const void* x, const void* g, void* part,
                                int B, int D, int H, int W, int Cin, int Cout,
                                int bm, int bn, int splits, void* stream) {
  return launch_dk_fma<__nv_bfloat16>(x, g, part, B, D, H, W, Cin, Cout,
                                      bm, bn, splits, stream);
}

int prdisagg_k1_dx_reduce_f32(const void* part, void* dx, long long n,
                              int splits, void* stream) {
  return launch_dx_reduce<float>(part, dx, n, splits, stream);
}

int prdisagg_k1_dx_reduce_bf16(const void* part, void* dx, long long n,
                               int splits, void* stream) {
  return launch_dx_reduce<__nv_bfloat16>(part, dx, n, splits, stream);
}

// dk (3, 3, 3, Cin, Cout) f32 from dk's part; with dbp (8 phases, Cout)
// f32, also db (Cout,) f32, its sum over the phases in order
int prdisagg_k1_dk_fold(const void* part, void* dk, int Cin, int Cout,
                        int splits, const void* dbp, void* db, void* stream) {
  if (splits < 1 || (dbp != nullptr) != (db != nullptr))
    return (int)cudaErrorInvalidValue;
  bwd::k1_dk_fold<<<pass_grid(27LL * Cin * Cout), 256, 0,
                    (cudaStream_t)stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dk), Cin, Cout,
      splits, static_cast<const float*>(dbp), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

const char* prdisagg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
