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
// M = B*D*H*W low-res positions, N = Cout and K = 8 taps * Cin.
//
// What bounds it on this card: operations.  A stage does 2*64*B*D*H*W*Cin*Cout
// FLOPs on (B*D*H*W*Cin + 64*Cin*Cout) inputs and writes 8*B*D*H*W*Cout values,
// so even stage 0 of the flagship generator (Cin = Cout = 256) does ~64 FLOPs
// per byte moved, and the larger stages more.  Against the float32 FMA peak
// (67 TFLOP/s) the f32 path is compute-bound at every generator stage.
//
// Design (deliberately simple):
//   * grid = (M tiles of 128 positions, N tiles of 64 channels, 8 phases);
//     256 threads, each accumulating an 8x4 f32 tile in registers;
//   * the reduction walks the 8 taps and, inside each tap, Cin in slices of
//     32, staging a 128x32 slice of input windows and a 32x64 slice of folded
//     weights in shared memory, so the folded weights never have to fit
//     (stage 0 holds 2 MB of them in f32);
//   * input windows are read straight from the unpadded NDHWC tensor with
//     out-of-range taps masked to zero: no padded copy is made;
//   * operands are converted to f32 on the way into shared memory (f32 or
//     bf16 in global memory), products use f32 FMA, bias is added in the
//     epilogue, and results are stored directly into the interleaved
//     (B, 2D, 2H, 2W, Cout) layout, so no transpose pass follows.
// What it leaves on the table: tensor cores (wgmma in bf16/TF32), TMA and a
// multi-stage cp.async pipeline overlapping loads with FMAs, and vector
// stores in the epilogue.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
upsample2_conv3_kernel(const T* __restrict__ x, const T* __restrict__ k2,
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

  const T* k_phase = k2 + (size_t)phase * 8 * Cin * Cout;
  for (int tap = 0; tap < 8; ++tap) {
    // input offset of this tap: padded index (d + a + p) is input index - 1
    const int od = pa + (tap >> 2) - 1;
    const int oh = pb + ((tap >> 1) & 1) - 1;
    const int ow = pc + (tap & 1) - 1;
    const T* k_tap = k_phase + (size_t)tap * Cin * Cout;
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
        float4 w4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ck < Cin) {
          const T* src = k_tap + (size_t)ck * Cout;
          const int co = n0 + b_c;
          if (co + 0 < Cout) w4.x = to_float(src[co + 0]);
          if (co + 1 < Cout) w4.y = to_float(src[co + 1]);
          if (co + 2 < Cout) w4.z = to_float(src[co + 2]);
          if (co + 3 < Cout) w4.w = to_float(src[co + 3]);
        }
        *reinterpret_cast<float4*>(&Bs[kr][b_c]) = w4;
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
int launch(const void* x, const void* k2, const void* bias, void* out, int B,
           int D, int H, int W, int Cin, int Cout, void* stream) {
  const long long M = (long long)B * D * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN),
                  8);
  upsample2_conv3_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k2),
      static_cast<const float*>(bias), static_cast<T*>(out), B, D, H, W, Cin,
      Cout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, D, H, W, Cin), k2 (8, 8, Cin, Cout), bias (Cout,) f32,
// out (B, 2D, 2H, 2W, Cout); all contiguous, on the current device.
int prdisagg_upsample2_conv3_f32(const void* x, const void* k2,
                                 const void* bias, void* out, int B, int D,
                                 int H, int W, int Cin, int Cout,
                                 void* stream) {
  return launch<float>(x, k2, bias, out, B, D, H, W, Cin, Cout, stream);
}

int prdisagg_upsample2_conv3_bf16(const void* x, const void* k2,
                                  const void* bias, void* out, int B, int D,
                                  int H, int W, int Cin, int Cout,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, k2, bias, out, B, D, H, W, Cin, Cout,
                               stream);
}

const char* prdisagg_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
