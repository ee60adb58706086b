// Random patch gather from the device-resident radar tensor, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel prdisagg_tpu/ops/pallas_gather.py::_make_kernel
// (launched by gather_patches_pallas).  It computes the same function,
//
//   out[b, h, r, c] = data[t_b, h, y_b + r, x_b + c]
//
// for B index rows (t, y, x) over a (D, nh, ny, nx) float32 tensor: a copy,
// with no arithmetic on the values, so the output is bit-exact.
//
// What bounds it on this card: bytes.  It reads B*nh*nd*nd floats and
// writes as many; there are no operations to speak of.  The least time is
// 2 * B*nh*nd^2 * 4 bytes over the 3.35 TB/s of HBM3.
//
// Design (deliberately simple):
//   * grid = (B patches, ceil(nh / 8) hour blocks), 256 threads; each block
//     reads its own index row (the TPU kernel prefetches them as scalars);
//   * threads walk the (hour, row, column) elements of the block's hours
//     with consecutive threads on consecutive columns, so a warp reads whole
//     64-byte rows of a 16-wide patch and writes one contiguous run;
//   * 16-byte loads and stores when the patch's x offset, nx and nd are
//     multiples of 4 (the sweep's stride makes x a multiple of 16), scalar
//     ones otherwise;
//   * data is read in place.  Unlike the TPU kernel it needs neither y % 8
//     alignment nor a 128-lane padding of x: a CUDA thread addresses any
//     float.
// What it leaves on the table: TMA bulk copies, and gathering several
// patches per block to amortise the index load at nh = 1.
//
// Launch contract: runs on the caller's stream, allocates nothing, does not
// synchronise, does not check that the index rows are in range (the caller
// validates them once), and returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int HOURS_PER_BLOCK = 8;

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const float* __restrict__ data,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int nh, int ny, int nx, int nd, int vec_ok) {
  const int b = blockIdx.x;
  const int h0 = blockIdx.y * HOURS_PER_BLOCK;
  const int hn = min(HOURS_PER_BLOCK, nh - h0);
  const int t = idx[3 * b];
  const int y = idx[3 * b + 1];
  const int x = idx[3 * b + 2];
  const long long plane = (long long)ny * nx;  // stride of one hour
  const float* src =
      data + ((long long)t * nh + h0) * plane + (long long)y * nx + x;
  float* dst = out + ((long long)b * nh + h0) * nd * nd;

  if (vec_ok && (x & 3) == 0) {
    const int q = nd >> 2;  // float4s per patch row
    const int n = hn * nd * q;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c = i % q;
      const int r = (i / q) % nd;
      const int h = i / (q * nd);
      dst4[i] = __ldg(reinterpret_cast<const float4*>(
                          src + h * plane + (long long)r * nx) + c);
    }
  } else {
    const int n = hn * nd * nd;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c = i % nd;
      const int r = (i / nd) % nd;
      const int h = i / (nd * nd);
      dst[i] = __ldg(src + h * plane + (long long)r * nx + c);
    }
  }
}

}  // namespace

extern "C" {

// data (D, nh, ny, nx) f32, idx (B, 3) int32 rows (t, y, x), out
// (B, nh, nd, nd) f32; all contiguous, on the current device.  vec_ok: the
// caller has checked nx % 4 == 0, nd % 4 == 0 and 16-byte aligned data and
// out.
int prdisagg_gather_patches_f32(const void* data, const void* idx, void* out,
                                int B, int nh, int ny, int nx, int nd,
                                int vec_ok, void* stream) {
  const dim3 grid((unsigned)B,
                  (unsigned)((nh + HOURS_PER_BLOCK - 1) / HOURS_PER_BLOCK));
  gather_patches_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(data), static_cast<const int*>(idx),
      static_cast<float*>(out), nh, ny, nx, nd, vec_ok);
  return (int)cudaGetLastError();
}

const char* prdisagg_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
