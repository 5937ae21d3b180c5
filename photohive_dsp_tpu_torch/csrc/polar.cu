// K7+K8: per image and polar bin, the sum of g(x) over a power spectrum,
// g(x) = 0 if x < 1 else logf(x) (the reference's log normalisation with
// the per-image gain left to the caller).
//
// Replace (photohive_dsp_tpu/ops/pallas_kernels.py):
//   K7 polar_bin_sums_local, log_gate=True (_polar_local_kernel): per-chunk
//      bin sums against a local bin dictionary, as bf16-split MXU products
//   K8 polar_bin_sums (_polar_kernel): the global one-hot combine of K7's
//      per-chunk partials
//
// What bounds it on an H100: bytes.  Each pixel reads 4 B of spectrum and
// 4 B of bin id (the id table is shared by the batch, so it is read from
// device memory once and from L2 after); at B=4 1080x1920 that is 16.6 MB
// + 4.2 MB, 6.2 us at 3.35 TB/s.  One logf and one shared-memory atomic
// per pixel above the gate add no device-memory traffic.
//
// Design.  The MXU's one-hot trick and its separate combine step do not
// apply: a block owns a run of one image's pixels and keeps the whole A*R
// table in shared memory (72x40 bins: 23 KB), adds each gated pixel with a
// shared-memory atomic, and flushes its nonzero slots into a per-image
// accumulator in device memory with 64-bit integer atomics; a second small
// kernel converts it.  A table above kSharedBudget (e.g. 360x100 bins,
// 288 KB) takes the in-kernel global-atomics branch instead.  Every value
// is added as 64-bit fixed point (28 fraction bits, rounded to nearest
// once), so the sums are exact, order-free and the same from run to run;
// g < 89 for any finite float32, so 2^28 * 89 * 1.2e8 pixels stays below
// 2^64.  The plain version (ops/polar_kernels.py) uses the same fixed point.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kPixelsPerBlock = kThreads * 64;
constexpr double kFixedOne = 268435456.0;  // 2^28
constexpr size_t kSharedBudget = 160 * 1024;

typedef unsigned long long u64;

template <bool kShared>
__global__ void polar_lognorm_kernel(const float* __restrict__ mag2,
                                     const int* __restrict__ bin_ids,
                                     long long pixels, int num_bins,
                                     u64* __restrict__ acc) {
  extern __shared__ u64 tab[];
  if (kShared) {
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) tab[i] = 0ull;
    __syncthreads();
  }
  const int b = blockIdx.y;
  const float* img = mag2 + static_cast<long long>(b) * pixels;
  u64* out = acc + static_cast<long long>(b) * num_bins;
  const long long start = blockIdx.x * kPixelsPerBlock;
  const long long end =
      start + kPixelsPerBlock < pixels ? start + kPixelsPerBlock : pixels;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    const float x = img[i];
    const int id = __ldg(&bin_ids[i]);
    if (x < 1.0f || static_cast<unsigned>(id) >= static_cast<unsigned>(num_bins)) {
      continue;
    }
    const u64 g = __double2ull_rn(static_cast<double>(logf(x)) * kFixedOne);
    if (kShared) {
      atomicAdd(&tab[id], g);
    } else {
      atomicAdd(&out[id], g);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < num_bins; i += blockDim.x) {
      if (tab[i]) atomicAdd(&out[i], tab[i]);
    }
  }
}

__global__ void polar_finish(const u64* __restrict__ acc, long long total,
                             float* __restrict__ sums) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i < total) {
    sums[i] = static_cast<float>(static_cast<double>(acc[i]) / kFixedOne);
  }
}

}  // namespace

// mag2: (batch, pixels) float32; bin_ids: (pixels,) int32, ids outside
// [0, num_bins) dropped; acc: (batch, num_bins) 64-bit scratch; sums:
// (batch, num_bins) float32, or nullptr to leave the fixed-point sums in acc
// (a caller that adds them across ranks first).  Returns the cudaError_t of
// the launches.
extern "C" int ph_polar_bin_sums_lognorm(const void* mag2, const void* bin_ids,
                                         int batch, long long pixels,
                                         int num_bins, void* acc, void* sums,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* a = static_cast<u64*>(acc);
  const long long total = static_cast<long long>(batch) * num_bins;
  cudaError_t err = cudaMemsetAsync(a, 0, total * sizeof(u64), st);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((pixels + kPixelsPerBlock - 1) /
                                        kPixelsPerBlock),
                  batch);
  const size_t bytes = static_cast<size_t>(num_bins) * sizeof(u64);
  const float* m = static_cast<const float*>(mag2);
  const int* ids = static_cast<const int*>(bin_ids);
  if (bytes <= kSharedBudget) {
    if (bytes > 48 * 1024) {
      err = cudaFuncSetAttribute(polar_lognorm_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
    }
    polar_lognorm_kernel<true><<<grid, kThreads, bytes, st>>>(m, ids, pixels,
                                                             num_bins, a);
  } else {
    polar_lognorm_kernel<false><<<grid, kThreads, 0, st>>>(m, ids, pixels,
                                                          num_bins, a);
  }
  if (sums) {
    polar_finish<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                   kThreads, 0, st>>>(a, total, static_cast<float*>(sums));
  }
  return cudaGetLastError();
}
