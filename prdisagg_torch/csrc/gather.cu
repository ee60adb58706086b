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
// 2 * B*nh*nd^2 * 4 bytes over the 3.35 TB/s of HBM3.  Reaching it takes
// about 3.4 MB in flight across the card (3.35 TB/s times a microsecond of
// memory latency), and a short chain of dependent round trips at the train
// step's small batches.
//
// Design:
//   * grid = (B patches, ceil(nh / 8) hour blocks), 128 threads; each block
//     reads its own index row, then copies out[b, h0:h0+8], a contiguous
//     run of (hour, row, column) elements, with consecutive threads on
//     consecutive columns: a warp reads whole rows of the patch and writes
//     one contiguous run;
//   * 16-byte loads and stores when the patch's x offset, nx, nd and the
//     base are multiples of 4 floats (the sweep's stride makes x a multiple
//     of 16).  Each thread loads UNROLL of them into registers before it
//     stores any, so a block of the train step (8 hours of a 16 x 16 patch,
//     512 float4s) has every load in flight at once and pays one round
//     trip: all 3.9 MB of one step's 160 patches are requested together,
//     and a wave of the bulk and 64 x 64 gathers keeps several times more
//     bytes in flight than one float4 per thread would;
//   * scalar loads otherwise, one per thread per pass;
//   * data is read in place.  Unlike the TPU kernel it needs neither y % 8
//     alignment nor a 128-lane padding of x: a CUDA thread addresses any
//     float.
// What holds it back (PERF.md, K2 by shape): at nd 16 a patch row is 64
// bytes at a 1 KB stride, and HBM serves such scattered reads well below
// its streaming rate; at the train step's sizes the launch and the
// dependent index-row load are a fixed ~2 us.  A TMA variant (box loads on
// a shared-memory ring, bulk stores) was measured slower at every shape
// the port gathers, so the kernel stays on plain loads.
//
// Launch: prdisagg_gather_prepare fills a record of what a source, its
// patch size and the batch fix, once; each prdisagg_gather_launch passes
// four pointers.  A launch runs on the caller's stream, allocates nothing,
// does not synchronise, does not check that the index rows are in range
// (the caller validates them once), and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 128;
constexpr int HOURS_PER_BLOCK = 8;
constexpr int UNROLL = 4;  // float4s each thread loads before it stores

__global__ void __launch_bounds__(THREADS)
k2_gather(const float* __restrict__ data, const int* __restrict__ idx,
          float* __restrict__ out, int nh, int ny, int nx, int nd,
          int vec_ok) {
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
    for (int base = threadIdx.x; base < n; base += THREADS * UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < n) {
          const int c = i % q;
          const int r = (i / q) % nd;
          const int h = i / (q * nd);
          v[u] = __ldg(reinterpret_cast<const float4*>(
                           src + h * plane + (long long)r * nx) + c);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i < n) dst4[i] = v[u];
      }
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

// Everything a launch needs but the index rows, the output and the stream.
struct GatherLaunch {
  const float* data;
  int B, nh, ny, nx, nd;
  int vec_ok;
};

}  // namespace

extern "C" {

// Bytes of a launch record, for the caller to allocate.
int prdisagg_gather_record_bytes() { return (int)sizeof(GatherLaunch); }

// Fill the caller's launch record `rec_out` for gathers of B patches of nd x
// nd from data (D, nh, ny, nx) f32, contiguous.  Returns a cudaError.
int prdisagg_gather_prepare(void* rec_out, const void* data, int B, int nh,
                            int ny, int nx, int nd) {
  if (B < 1 || nh < 1 || nd < 1 || nd > ny || nd > nx) {
    return (int)cudaErrorInvalidValue;
  }
  GatherLaunch r{};
  r.data = static_cast<const float*>(data);
  r.B = B;
  r.nh = nh;
  r.ny = ny;
  r.nx = nx;
  r.nd = nd;
  r.vec_ok = nx % 4 == 0 && nd % 4 == 0 &&
             reinterpret_cast<uintptr_t>(data) % 16 == 0;
  std::memcpy(rec_out, &r, sizeof(r));
  return 0;
}

// Launch the kernel of a prepared record on idx (B, 3) int32 rows (t, y, x)
// into out (B, nh, nd, nd) f32, both contiguous, out 16-byte aligned.
int prdisagg_gather_launch(const void* rec, const void* idx, void* out,
                           void* stream) {
  GatherLaunch r;
  std::memcpy(&r, rec, sizeof(r));  // the caller's buffer may be unaligned
  const dim3 grid((unsigned)r.B,
                  (unsigned)((r.nh + HOURS_PER_BLOCK - 1) / HOURS_PER_BLOCK));
  k2_gather<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      r.data, static_cast<const int*>(idx), static_cast<float*>(out), r.nh,
      r.ny, r.nx, r.nd, r.vec_ok);
  return (int)cudaGetLastError();
}

const char* prdisagg_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
