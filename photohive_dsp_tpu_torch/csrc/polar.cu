// K7+K8: per image and polar bin, the sum of g(x) over a power spectrum,
// g(x) = 0 if x < 1 else logf(x) (the reference's log normalisation before
// the per-image gain), and the per-image maximum of the spectrum; then, by
// choice, the normalised bin means: the sums times the gain
// 1 / (2 log(sqrt(max) + 1)), over each bin's pixel count.
//
// Replace (photohive_dsp_tpu/ops/pallas_kernels.py):
//   K7 polar_bin_sums_local, log_gate=True (_polar_local_kernel): per-chunk
//      bin sums against a local bin dictionary, as bf16-split MXU products
//   K8 polar_bin_sums (_polar_kernel): the global one-hot combine of K7's
//      per-chunk partials
// and the blur tail around them (pallas_fft.blur_bins_scrambled_lognorm:
// the maximum, the gain and the means).
//
// What bounds it on an H100: bytes.  Each pixel reads 4 B of spectrum and
// 4 B of bin id (the id table is shared by the batch, so it is read from
// device memory once and from L2 after); at B=4 1080x1920 that is 16.6 MB
// + 4.2 MB, 6.2 us at 3.35 TB/s.  One logf a pixel adds no device-memory
// traffic.
//
// Design.  The MXU's one-hot trick and its separate combine step do not
// apply: a block owns a run of one image's pixels (one wave of blocks over
// the batch: one_wave.cuh), keeps the whole A*R table in shared memory
// (72x40 bins: 23 KB), and flushes its nonzero bins into a per-image
// accumulator in device memory with 64-bit integer atomics; a finishing
// kernel converts it.  Every value is added as 64-bit fixed point (28 fraction bits,
// rounded to nearest once), so the sums are exact, order-free and the same
// from run to run; g < 89 for any finite float32, so 2^28 * 89 * 1.2e8
// pixels stays below 2^64.  The plain version (ops/polar_kernels.py) uses
// the same fixed point.
//
// The adds.  The table keeps each 64-bit sum as two 32-bit words that
// native 32-bit shared-memory atomics add exactly (add64: the add that
// wraps the low word carries into the high one, about once in 16 adds of
// a value below 2^28 * 89); sm_90's 64-bit shared atomicAdd is a
// compare-and-swap loop, which the lanes of a warp on one bin (neighbours
// in a spectrum row mostly are) retried in turn.  Lanes on one bin cost
// the native atomic little, so the adds are not grouped: a segmented warp
// sum over runs of one bin before the add was slower (PERF.md).  A table
// above kSharedBudget (e.g. 360x100 bins, 288 KB) adds with 64-bit atomics
// in device memory.
//
// The maximum rides along: |X|^2 >= 0, and the bits of floats >= 0 order
// as unsigned integers, so each warp's maximum goes into the image's word
// with one atomicMax (a value <= 0 counts as +0).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "one_wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;
constexpr float kFixedOne = 268435456.0f;  // 2^28
constexpr size_t kSharedBudget = 160 * 1024;
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

// x into the 64-bit sum held as the 32-bit words lo and hi: the add that
// wraps lo sees it in the old value it returns and carries into hi, so
// hi * 2^32 + lo is the exact sum in any order.
__device__ __forceinline__ void add64(unsigned* lo, unsigned* hi, u64 x) {
  const unsigned xl = static_cast<unsigned>(x);
  const unsigned old = atomicAdd(lo, xl);
  const unsigned xh = static_cast<unsigned>(x >> 32) + (old + xl < old);
  if (xh) atomicAdd(hi, xh);
}

template <bool kShared>
__device__ __forceinline__ void add_bin(unsigned* tab, u64* out, int nb,
                                        int id, u64 x) {
  if (kShared) {
    add64(&tab[id], &tab[nb + id], x);
  } else {
    atomicAdd(&out[id], x);
  }
}

// Block (x, b) takes pixels [x run, (x + 1) run) of image b, run a
// multiple of kVec * kThreads, in warp-uniform steps of 32 x kVec adjacent
// pixels.  Shared table (kShared): the low words of the nb sums, then the
// high words.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    polar_lognorm_kernel(const float* __restrict__ mag2,
                         const int* __restrict__ bin_ids, long long pixels,
                         int nb, bool vec, long long run,
                         u64* __restrict__ acc, unsigned* __restrict__ mx) {
  extern __shared__ unsigned tab[];
  if (kShared) {
    for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) tab[i] = 0u;
    __syncthreads();
  }
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float* img = mag2 + static_cast<long long>(b) * pixels;
  u64* out = acc + static_cast<long long>(b) * nb;
  const long long start = blockIdx.x * run;
  const long long end = start + run < pixels ? start + run : pixels;
  unsigned top = 0u;
  for (long long w0 = start + 32LL * kVec * (threadIdx.x >> 5); w0 < end;
       w0 += 32LL * kVec * kWarps) {
    const long long i = w0 + kVec * lane;
    float x[kVec];
    int id[kVec];
    if (vec && i + kVec <= end) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(img + i));
      const int4 iv = __ldg(reinterpret_cast<const int4*>(bin_ids + i));
      x[0] = xv.x, x[1] = xv.y, x[2] = xv.z, x[3] = xv.w;
      id[0] = iv.x, id[1] = iv.y, id[2] = iv.z, id[3] = iv.w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        x[j] = i + j < end ? img[i + j] : 0.0f;
        id[j] = i + j < end ? __ldg(&bin_ids[i + j]) : -1;
      }
    }
    // key: the bin, -1 for a pixel that adds to none; g: its fixed-point
    // value, 0 below the gate.
    int key[kVec];
    u64 g[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      top = x[j] > 0.0f ? max(top, __float_as_uint(x[j])) : top;
      key[j] = static_cast<unsigned>(id[j]) < static_cast<unsigned>(nb)
                   ? id[j] : -1;
      // g * 2^28 is exact in float32, so rounding it to an integer is the
      // plain version's round(float64(g) * 2^28).
      g[j] = x[j] >= 1.0f && key[j] >= 0
                 ? __float2ull_rn(__fmul_rn(logf(x[j]), kFixedOne))
                 : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (g[j]) add_bin<kShared>(tab, out, nb, key[j], g[j]);
    }
  }
  top = __reduce_max_sync(kFull, top);
  if (lane == 0 && top) atomicMax(&mx[b], top);
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const u64 x = (static_cast<u64>(tab[nb + i]) << 32) + tab[i];
      if (x) atomicAdd(&out[i], x);
    }
  }
}

// sums: the float32 sums (counts == nullptr), or the bin means with the
// gain, in the torch ops' float32 order (ops/polar_kernels
// lognorm_gain / bin_means): denom = 2 log(sqrt(max) + 1), gain = 1 / denom
// where denom > 0 (else 0), mean = sum * gain / max(count, 1) where
// count > 0 (else 0).
__global__ void polar_finish(const u64* __restrict__ acc,
                             const unsigned* __restrict__ mx, int nb,
                             long long total, const int* __restrict__ counts,
                             float* __restrict__ out) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const float s =
      static_cast<float>(static_cast<double>(acc[i]) / 268435456.0);
  if (!counts) {
    out[i] = s;
    return;
  }
  const float m = __uint_as_float(mx[i / nb]);
  const float denom = __fmul_rn(2.0f, logf(__fadd_rn(sqrtf(m), 1.0f)));
  const float gain = denom > 0.0f ? __fdiv_rn(1.0f, fmaxf(denom, 1e-30f))
                                  : 0.0f;
  const int n = counts[i % nb];
  out[i] = n > 0 ? __fdiv_rn(__fmul_rn(s, gain),
                             fmaxf(static_cast<float>(n), 1.0f))
                 : 0.0f;
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

// mag2: (batch, pixels) float32, finite; bin_ids: (pixels,) int32, ids
// outside [0, num_bins) dropped; acc: (batch, num_bins) 64-bit scratch; mx:
// (batch,) 32-bit, the bits of each image's maximum (at least +0).  out:
// nullptr leaves the fixed-point sums in acc (a caller that adds them
// across ranks first); with bin_counts ((num_bins,) int32) it gets the
// normalised bin means, else the float32 sums, (batch, num_bins).  Returns
// the cudaError_t of the launches.
extern "C" int ph_polar_lognorm(const void* mag2, const void* bin_ids,
                                int batch, long long pixels, int num_bins,
                                const void* bin_counts, void* acc, void* mx,
                                void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* a = static_cast<u64*>(acc);
  unsigned* m = static_cast<unsigned*>(mx);
  const long long total = static_cast<long long>(batch) * num_bins;
  cudaError_t err = cudaMemsetAsync(a, 0, total * sizeof(u64), st);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(m, 0, batch * sizeof(unsigned), st);
  }
  if (err != cudaSuccess) return err;
  const float* x = static_cast<const float*>(mag2);
  const int* ids = static_cast<const int*>(bin_ids);
  const bool vec = pixels % kVec == 0 && aligned(x, 16) && aligned(ids, 16);
  const size_t bytes = 2 * static_cast<size_t>(num_bins) * sizeof(unsigned);
  if (batch > 0 && pixels > 0) {
    dim3 grid;
    long long run = 0;
    if (bytes <= kSharedBudget) {
      auto kernel = polar_lognorm_kernel<true>;
      if (bytes > 48 * 1024) {
        err = cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
      }
      if (err == cudaSuccess) {
        err = one_wave<kThreads, kVec>(kernel, bytes, batch, pixels, pixels,
                                       &grid, &run);
      }
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, bytes, st>>>(x, ids, pixels, num_bins, vec,
                                            run, a, m);
    } else {
      auto kernel = polar_lognorm_kernel<false>;
      err = one_wave<kThreads, kVec>(kernel, 0, batch, pixels, pixels, &grid,
                                     &run);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, 0, st>>>(x, ids, pixels, num_bins, vec, run,
                                        a, m);
    }
  }
  if (out && total > 0) {
    polar_finish<<<static_cast<unsigned>((total + kThreads - 1) / kThreads),
                   kThreads, 0, st>>>(a, m, num_bins, total,
                                      static_cast<const int*>(bin_counts),
                                      static_cast<float*>(out));
  }
  return cudaGetLastError();
}
