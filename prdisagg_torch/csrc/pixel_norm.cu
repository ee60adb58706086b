// Pixel-norm and leaky ReLU in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes the chain as plain jnp
// (prdisagg_tpu/ops/core.py pixel_norm, leaky_relu) and XLA fuses it.  In
// PyTorch the same chain is four full-tensor kernels (the square, the mean
// over channels, the broadcast product, the leaky ReLU), which read and
// write the stage's output 3.3 times as often as the function needs.  This
// kernel computes
//
//   y = leaky_relu(x * rsqrt(mean(x^2, channels) + eps), leak)
//
// for a channels-last float32 tensor of P positions of C channels each,
// with the statistic accumulated in float32, in registers.
//
// What bounds it on this card: bytes, one read and one write of the
// tensor.  The least time is 2 * P*C * 4 bytes over the 3.35 TB/s of
// HBM3; there are ~5 operations a float.
//
// Design:
//   * one position's C channels are contiguous (C*4 bytes: 1,024, 512 and
//     256 at C 256, 128 and 64); a group of L lanes of one warp (L a power
//     of two, up to 32) takes one position, each lane VPL 16-byte loads of
//     it: two a lane at C 256 (L 32), one at C 128 (L 32) and C 64 (L 16,
//     two positions a warp).  Consecutive lanes read consecutive 16 bytes,
//     so a warp reads 512 contiguous bytes a load;
//   * a lane loads ITEMS positions' values (VPL * ITEMS = 4 float4s at the
//     main path's widths) before it reduces any, so each thread keeps 64
//     bytes in flight: some 8 MB across the card at four blocks an SM,
//     above the ~3.4 MB that HBM's rate times its latency asks for;
//   * the sum of squares is reduced across the group by width-limited warp
//     shuffles, then every lane scales and activates its own values in
//     registers and stores them: no shared memory;
//   * a grid-stride loop over warps of positions, with a grid sized to
//     fill the SMs; the loop's bound is a warp's, so that every lane of a
//     warp takes part in each shuffle, and lanes past the last position
//     load zeros and store nothing;
//   * 64-bit offsets: a 64x64 stage output at B 512 holds 3.2e9 floats.
// C may be any multiple of 4 up to MAX_CHANNELS (256, the configurations'
// widest stage): one or two float4s a lane.
//
// Launch: prdisagg_pixel_norm_leaky runs on the caller's stream, allocates
// nothing, does not synchronise (so it can be captured in a CUDA graph),
// and returns cudaGetLastError(), or cudaErrorInvalidValue for a width or
// an alignment it does not take.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_VPL = 2;  // float4s a lane: C up to 32 * 2 * 4
constexpr int MAX_CHANNELS = 32 * MAX_VPL * 4;

template <int VPL, int ITEMS>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
pixel_norm_leaky(const float4* __restrict__ x, float4* __restrict__ y,
                 long long positions, int v, int lanes, float inv_c,
                 float eps, float leak) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);      // lane within the group
  const int per_warp = 32 / lanes;         // positions a warp a slot
  const int slot_pos = lane / lanes;
  const long long warp0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * THREADS) >> 5;
  for (long long w = warp0; w * per_warp < positions; w += warps * ITEMS) {
    float4 val[ITEMS][VPL];
    float ss[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = (w + i * warps) * per_warp + slot_pos;
      const float4* src = x + p * v;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int k = sub + j * lanes;
        val[i][j] = p < positions && k < v ? __ldg(src + k)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const float4 q = val[i][j];
        s = fmaf(q.x, q.x, s);
        s = fmaf(q.y, q.y, s);
        s = fmaf(q.z, q.z, s);
        s = fmaf(q.w, q.w, s);
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off, lanes);
      }
      ss[i] = rsqrtf(s * inv_c + eps);
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const long long p = (w + i * warps) * per_warp + slot_pos;
      if (p >= positions) continue;
      float4* dst = y + p * v;
      const float r = ss[i];
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int k = sub + j * lanes;
        if (k < v) {
          float4 q = val[i][j];
          q.x *= r;
          q.y *= r;
          q.z *= r;
          q.w *= r;
          q.x = q.x > 0.f ? q.x : q.x * leak;
          q.y = q.y > 0.f ? q.y : q.y * leak;
          q.z = q.z > 0.f ? q.z : q.z * leak;
          q.w = q.w > 0.f ? q.w : q.w * leak;
          dst[k] = q;
        }
      }
    }
  }
}

template <int VPL, int ITEMS>
void launch(const float4* x, float4* y, long long positions, int v,
            int lanes, float inv_c, float eps, float leak, int sms,
            cudaStream_t stream) {
  // the fewest passes of the grid-stride loop that a full grid needs, then
  // the fewest blocks that cover the positions in as many passes, so that
  // the last pass is as full as the others
  constexpr long long WARPS = THREADS / 32;
  const long long slots = (positions + 32 / lanes - 1) / (32 / lanes);
  const long long full = (long long)sms * BLOCKS_PER_SM * WARPS * ITEMS;
  const long long passes = (slots + full - 1) / full;
  const long long warps = (slots + passes * ITEMS - 1) / (passes * ITEMS);
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  pixel_norm_leaky<VPL, ITEMS><<<blocks, THREADS, 0, stream>>>(
      x, y, positions, v, lanes, inv_c, eps, leak);
}

}  // namespace

extern "C" {

// y = leaky_relu(x * rsqrt(mean(x^2, last axis) + eps), leak) over x of
// `positions` rows of `channels` float32, both contiguous and 16-byte
// aligned, on `stream`; `sms` sizes the grid.  Returns a cudaError.
int prdisagg_pixel_norm_leaky(const void* x, void* y, long long positions,
                              int channels, float eps, float leak, int sms,
                              void* stream) {
  if (channels < 4 || channels % 4 != 0 || channels > MAX_CHANNELS ||
      positions < 0 || sms < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (positions == 0) return 0;
  const int v = channels / 4;  // float4s a position
  int lanes = 1;
  while (lanes < 32 && lanes < v) lanes <<= 1;
  const int vpl = (v + lanes - 1) / lanes;
  const float inv_c = 1.0f / (float)channels;
  const auto* xs = static_cast<const float4*>(x);
  auto* ys = static_cast<float4*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vpl == 1) {
    launch<1, 4>(xs, ys, positions, v, lanes, inv_c, eps, leak, sms, s);
  } else {
    launch<MAX_VPL, 2>(xs, ys, positions, v, lanes, inv_c, eps, leak, sms,
                       s);
  }
  return (int)cudaGetLastError();
}

const char* prdisagg_pixel_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
