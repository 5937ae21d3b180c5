// Palette kernels: the cell histogram with the saturation sum (K1, and K9
// on flat HSV) and the per-slot palette sums at q=1 (K3) and q>1 (K4, and
// K10 on flat HSV).
//
// Replace (photohive_dsp_tpu/ops/pallas_kernels_bf16.py):
//   K1 cell_counts_s_from_rgb   (_cell_counts_rgb_kernel_bf16)
//   K3 palette_sums_by_k_rgb_q1 (_palette_rgb_q1_kernel_bf16)
//   K4 palette_sums_by_k_rgb    (_palette_rgb_kernel_bf16)
// and (photohive_dsp_tpu/ops/pallas_kernels.py):
//   K9  cell_counts_from_hsv    (_cell_counts_hsv_kernel)
//   K10 palette_sums_by_k       (_palette_kernel)
// K9 and K10 are the same kernels as K1 and K4 fed by a flat-HSV pixel
// source (HsvPixels below): (B, P) float32 h, s, v planes in which a hue
// below 0 marks a pixel that counts for nothing (the row-sharded report's
// padded rows).  Such a pixel is skipped before any table is touched, so a
// sentinel tail changes no bit of the outputs.
//
// What bounds them on an H100: each pixel costs three loads (3 B as u8,
// 12 B as f32), then ~60 float ops including four IEEE divisions for HSV and
// the cell id, then shared-memory atomics (K1: one; K3/K4: four).  A 1080p
// frame reads 6.2 MB (u8) or 24.9 MB (f32), a few microseconds at 3.35 TB/s,
// so the kernels are bound by instruction issue and by atomic conflicts in
// shared memory when many pixels of a warp share a cell (flat images).
//
// Design.  The TPU kernels turned the histogram and the sums into one-hot
// matrix products on the MXU, with bf16 splits to keep them exact.  Here
// each pixel adds directly into a per-block table in shared memory, and the
// candidate tables a pixel reads (K4: its cell's <= q tie candidates and
// the candidate centres; K3: its cell's slot and hue offset) sit in shared
// memory too.  A block covers a contiguous run of one image's pixels
// (grid = pixel runs x images); it flushes its nonzero table entries into a
// per-image accumulator in device memory with 64-bit integer atomics, and
// for K1, K3 and K4 a second small kernel converts the accumulator to the
// outputs; K9 and K10 return the accumulator itself.
//
// The flat-HSV kernels read 12 B per real pixel (4 B per sentinel pixel)
// and skip the HSV arithmetic; they stay bound by the cell-id divisions
// and the shared-memory atomics.
//
// Every sum is exact and order-free: counts are integers, and hue, s and v
// (all >= 0 and <= 360) are added as 64-bit fixed point with 28 fraction
// bits (each value rounded to nearest, error <= 2^-29 per pixel).  So the
// outputs are the same from run to run and for any block split, and the
// 64-bit accumulators hold up to 2^64 / (360 * 2^28) ~ 1.9e8 pixels per
// image, more than config.MAX_NUM_PIXELS.  The TPU kernels summed in
// float32; the results agree to float32 rounding.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hsv_cells.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kPixelsPerBlock = kThreads * 32;
constexpr double kFixedOne = 268435456.0;  // 2^28
// Shared memory a block may take for K4's candidate table before the
// table is read from device memory instead (huge configs: C=2164 has up to
// 728 candidates per cell).
constexpr size_t kSharedBudget = 160 * 1024;

typedef unsigned long long u64;

__device__ __forceinline__ u64 to_fixed(float x) {
  return __double2ull_rn(static_cast<double>(x) * kFixedOne);
}

__device__ __forceinline__ float from_fixed(u64 x) {
  return static_cast<float>(static_cast<double>(x) / kFixedOne);
}

__device__ __forceinline__ float wrap360(float t) {
  return t > 360.0f ? __fsub_rn(t, 360.0f)
                    : (t < 0.0f ? __fadd_rn(t, 360.0f) : t);
}

// Pixel sources.  load() gives pixel i of image b as (h, s, v, cell) and
// returns false for a pixel that counts for nothing.
//
// Planar RGB, (B, 3, P) uint8 or float32: every pixel is real.
template <typename T>
struct RgbPixels {
  const T* rgb;
  long long pixels;
  __device__ __forceinline__ bool load(int b, long long i, const CellParams& p,
                                       float& h, float& s, float& v,
                                       int& cell) const {
    pixel_hsv_cell(rgb + static_cast<long long>(b) * 3 * pixels, pixels, i, p,
                   h, s, v, cell);
    return true;
  }
};

// Flat HSV, three (B, P) float32 planes; a hue below 0 (or NaN) is the
// sentinel of a pixel outside the image.
struct HsvPixels {
  const float* h;
  const float* s;
  const float* v;
  long long pixels;
  __device__ __forceinline__ bool load(int b, long long i, const CellParams& p,
                                       float& hh, float& ss, float& vv,
                                       int& cell) const {
    const long long j = static_cast<long long>(b) * pixels + i;
    hh = h[j];
    if (!(hh >= 0.0f)) return false;
    ss = s[j];
    vv = v[j];
    cell = hsv_cell(hh, ss, vv, p);
    return true;
  }
};

// ----------------------------------------------------------- K1 / K9 ---
// acc: (B, C + 1) u64 = [count per cell..., fixed-point sum of s].
template <typename Src>
__global__ void cell_counts_s_kernel(Src src, CellParams p,
                                     u64* __restrict__ acc) {
  extern __shared__ u64 smem[];
  const int c = p.num_cells;
  unsigned int* cnt = reinterpret_cast<unsigned int*>(smem);
  for (int i = threadIdx.x; i < c; i += blockDim.x) cnt[i] = 0u;
  __syncthreads();

  const int b = blockIdx.y;
  const long long pixels = src.pixels;
  const long long start = blockIdx.x * kPixelsPerBlock;
  const long long end =
      start + kPixelsPerBlock < pixels ? start + kPixelsPerBlock : pixels;
  u64 s_fx = 0;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    float h, s, v;
    int cell;
    if (!src.load(b, i, p, h, s, v, cell)) continue;
    atomicAdd(&cnt[cell], 1u);
    s_fx += to_fixed(s);
  }
  for (int o = 16; o > 0; o >>= 1) s_fx += __shfl_down_sync(0xffffffffu, s_fx, o);
  __syncthreads();

  u64* out = acc + static_cast<long long>(b) * (c + 1);
  if ((threadIdx.x & 31) == 0 && s_fx) atomicAdd(&out[c], s_fx);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    if (cnt[i]) atomicAdd(&out[i], static_cast<u64>(cnt[i]));
  }
}

__global__ void cell_counts_s_finish(const u64* __restrict__ acc, int c,
                                     int* __restrict__ counts,
                                     float* __restrict__ s_sum) {
  const int b = blockIdx.x;
  const u64* row = acc + static_cast<long long>(b) * (c + 1);
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    counts[static_cast<long long>(b) * c + i] = static_cast<int>(row[i]);
  }
  if (threadIdx.x == 0) s_sum[b] = from_fixed(row[c]);
}

// ------------------------------------------------------- K3 / K4 / K10 -
// acc: (B, C, 4) u64 = per valid-order slot [hue, s, v, count], the first
// three in fixed point.  kQ1 selects K3 (slot and offset are functions of
// the cell) or K4 / K10 (first minimum distance over the cell's
// candidates).
template <typename Src, bool kQ1>
__global__ void palette_sums_kernel(Src src, CellParams p,
                                    const int* __restrict__ cell_tab,
                                    const float* __restrict__ val_tab, int q,
                                    bool tab_in_shared,
                                    u64* __restrict__ acc) {
  extern __shared__ u64 smem[];
  const int c = p.num_cells;
  const int b = blockIdx.y;
  // Shared layout: sums (3C u64) | counts (C u32) | values | cell table.
  u64* sums = smem;
  unsigned int* cnt = reinterpret_cast<unsigned int*>(sums + 3 * c);
  float* vals = reinterpret_cast<float*>(cnt + c);
  // K3: vals = hue offset per cell (C); K4: centres by slot (h | s | v).
  const int n_vals = kQ1 ? c : 3 * c;
  int* tab_sh = reinterpret_cast<int*>(vals + n_vals);
  const int tab_len = kQ1 ? c : c * q;
  const int* gtab = cell_tab + static_cast<long long>(b) * tab_len;
  const float* gval = val_tab + static_cast<long long>(b) * n_vals;

  for (int i = threadIdx.x; i < 3 * c; i += blockDim.x) sums[i] = 0ull;
  for (int i = threadIdx.x; i < c; i += blockDim.x) cnt[i] = 0u;
  if (kQ1) {
    for (int i = threadIdx.x; i < c; i += blockDim.x) vals[i] = gval[i];
  } else {
    // (C, 3) row-major centres -> three planes.
    for (int i = threadIdx.x; i < 3 * c; i += blockDim.x) {
      vals[(i % 3) * c + i / 3] = gval[i];
    }
  }
  if (tab_in_shared) {
    for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab_sh[i] = gtab[i];
  }
  const int* tab = tab_in_shared ? tab_sh : gtab;
  __syncthreads();

  const long long pixels = src.pixels;
  const long long start = blockIdx.x * kPixelsPerBlock;
  const long long end =
      start + kPixelsPerBlock < pixels ? start + kPixelsPerBlock : pixels;
  for (long long i = start + threadIdx.x; i < end; i += blockDim.x) {
    float h, s, v;
    int cell;
    if (!src.load(b, i, p, h, s, v, cell)) continue;
    int k;
    float off;
    if (kQ1) {
      k = tab[cell];
      off = vals[cell];
    } else {
      // Distance in the exact float32 op order of
      // photohive_dsp_tpu/ops/quantize.py:364-371; candidates ascend in
      // valid order with sentinels (>= C) last, so the strict < keeps the
      // first minimum, the reference's tie rule.
      const int* row = tab + static_cast<long long>(cell) * q;
      float best = INFINITY;
      k = c;
      for (int j = 0; j < q; ++j) {
        const int kk = row[j];
        if (kk >= c) break;
        float hd = fabsf(__fsub_rn(h, vals[kk]));
        hd = hd > 180.0f ? __fsub_rn(360.0f, hd) : hd;
        hd = __fmul_rn(hd, p.inv360);
        const float sd = __fsub_rn(s, vals[c + kk]);
        const float vd = __fsub_rn(v, vals[2 * c + kk]);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(hd, hd), __fmul_rn(sd, sd)),
                                  __fmul_rn(vd, vd));
        if (d < best) {
          best = d;
          k = kk;
        }
      }
      off = k < c ? __fsub_rn(180.0f, vals[k]) : 0.0f;
    }
    if (k < c) {
      atomicAdd(&cnt[k], 1u);
      atomicAdd(&sums[k], to_fixed(wrap360(__fadd_rn(h, off))));
      atomicAdd(&sums[c + k], to_fixed(s));
      atomicAdd(&sums[2 * c + k], to_fixed(v));
    }
  }
  __syncthreads();

  u64* out = acc + static_cast<long long>(b) * c * 4;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    if (!cnt[k]) continue;
    atomicAdd(&out[4 * k + 0], sums[k]);
    atomicAdd(&out[4 * k + 1], sums[c + k]);
    atomicAdd(&out[4 * k + 2], sums[2 * c + k]);
    atomicAdd(&out[4 * k + 3], static_cast<u64>(cnt[k]));
  }
}

__global__ void palette_sums_finish(const u64* __restrict__ acc, int c,
                                    float* __restrict__ sums) {
  const long long base = static_cast<long long>(blockIdx.x) * c * 4;
  for (int i = threadIdx.x; i < 4 * c; i += blockDim.x) {
    const u64 x = acc[base + i];
    sums[base + i] = (i & 3) == 3 ? static_cast<float>(x) : from_fixed(x);
  }
}

dim3 pixel_grid(int batch, long long pixels) {
  return dim3(static_cast<unsigned>((pixels + kPixelsPerBlock - 1) /
                                    kPixelsPerBlock),
              static_cast<unsigned>(batch));
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// sums_out == nullptr (K10) leaves the result in acc (fixed point).
template <typename Src, bool kQ1>
cudaError_t launch_palette_sums(Src src, int batch, const CellParams& p,
                                const int* cell_tab, const float* val_tab,
                                int q, float* sums_out, u64* acc,
                                cudaStream_t stream) {
  const int c = p.num_cells;
  const size_t base = 3 * c * sizeof(u64) + c * sizeof(unsigned int) +
                      (kQ1 ? c : 3 * c) * sizeof(float);
  const size_t tab = (kQ1 ? c : static_cast<size_t>(c) * q) * sizeof(int);
  const bool tab_in_shared = base + tab <= kSharedBudget;
  const size_t bytes = base + (tab_in_shared ? tab : 0);
  auto kernel = palette_sums_kernel<Src, kQ1>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(batch) * c * 4 * sizeof(u64),
                        stream);
  if (err != cudaSuccess) return err;
  kernel<<<pixel_grid(batch, src.pixels), kThreads, bytes, stream>>>(
      src, p, cell_tab, val_tab, q, tab_in_shared, acc);
  if (sums_out) palette_sums_finish<<<batch, kThreads, 0, stream>>>(acc, c, sums_out);
  return cudaGetLastError();
}

// counts == nullptr (K9) leaves the result in acc (fixed point).
template <typename Src>
cudaError_t launch_cell_counts_s(Src src, int batch, const CellParams& p,
                                 int* counts, float* s_sum, u64* acc,
                                 cudaStream_t stream) {
  const int c = p.num_cells;
  const size_t bytes = c * sizeof(unsigned int);
  auto kernel = cell_counts_s_kernel<Src>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(batch) * (c + 1) * sizeof(u64),
                        stream);
  if (err != cudaSuccess) return err;
  kernel<<<pixel_grid(batch, src.pixels), kThreads, bytes, stream>>>(src, p, acc);
  if (counts) {
    cell_counts_s_finish<<<batch, kThreads, 0, stream>>>(acc, c, counts, s_sum);
  }
  return cudaGetLastError();
}

template <typename T>
RgbPixels<T> rgb_pixels(const void* rgb, long long pixels) {
  return RgbPixels<T>{static_cast<const T*>(rgb), pixels};
}

HsvPixels hsv_pixels(const void* h, const void* s, const void* v,
                     long long pixels) {
  return HsvPixels{static_cast<const float*>(h), static_cast<const float*>(s),
                   static_cast<const float*>(v), pixels};
}

}  // namespace

// C entry points (bound with ctypes in ops/_cuda.py).  Each returns the
// cudaError_t of its launches.  The RGB input is (B, 3, pixels) planar,
// contiguous, uint8 (is_u8) or float32; the HSV input three contiguous
// (B, pixels) float32 planes.
extern "C" int ph_cell_counts_s(const void* rgb, int is_u8, int batch,
                                long long pixels, const CellParams* p,
                                void* counts, void* s_sum, void* acc,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cnt = static_cast<int*>(counts);
  float* ss = static_cast<float*>(s_sum);
  u64* a = static_cast<u64*>(acc);
  return is_u8 ? launch_cell_counts_s(rgb_pixels<uint8_t>(rgb, pixels), batch,
                                      *p, cnt, ss, a, st)
               : launch_cell_counts_s(rgb_pixels<float>(rgb, pixels), batch,
                                      *p, cnt, ss, a, st);
}

// K9 and K10 leave their results in the accumulators (fixed point), which
// the row-sharded report adds across ranks before converting them.
// acc: (B, C + 1) u64, the counts, then the saturation sum.
extern "C" int ph_cell_counts_hsv(const void* h, const void* s, const void* v,
                                  int batch, long long pixels,
                                  const CellParams* p, void* acc,
                                  void* stream) {
  return launch_cell_counts_s(hsv_pixels(h, s, v, pixels), batch, *p, nullptr,
                              nullptr, static_cast<u64*>(acc),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int ph_palette_sums_q1(const void* rgb, int is_u8, int batch,
                                  long long pixels, const CellParams* p,
                                  const void* slot_of_cell,
                                  const void* offset_of_cell, void* sums,
                                  void* acc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(slot_of_cell);
  const float* off = static_cast<const float*>(offset_of_cell);
  float* out = static_cast<float*>(sums);
  u64* a = static_cast<u64*>(acc);
  return is_u8 ? launch_palette_sums<RgbPixels<uint8_t>, true>(
                     rgb_pixels<uint8_t>(rgb, pixels), batch, *p, tab, off, 1,
                     out, a, st)
               : launch_palette_sums<RgbPixels<float>, true>(
                     rgb_pixels<float>(rgb, pixels), batch, *p, tab, off, 1,
                     out, a, st);
}

extern "C" int ph_palette_sums(const void* rgb, int is_u8, int batch,
                               long long pixels, const CellParams* p,
                               const void* cand, int q,
                               const void* centers_by_k, void* sums, void* acc,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tab = static_cast<const int*>(cand);
  const float* ctr = static_cast<const float*>(centers_by_k);
  float* out = static_cast<float*>(sums);
  u64* a = static_cast<u64*>(acc);
  return is_u8 ? launch_palette_sums<RgbPixels<uint8_t>, false>(
                     rgb_pixels<uint8_t>(rgb, pixels), batch, *p, tab, ctr, q,
                     out, a, st)
               : launch_palette_sums<RgbPixels<float>, false>(
                     rgb_pixels<float>(rgb, pixels), batch, *p, tab, ctr, q,
                     out, a, st);
}

// acc: (B, C, 4) u64.
extern "C" int ph_palette_sums_hsv(const void* h, const void* s, const void* v,
                                   int batch, long long pixels,
                                   const CellParams* p, const void* cand, int q,
                                   const void* centers_by_k, void* acc,
                                   void* stream) {
  return launch_palette_sums<HsvPixels, false>(
      hsv_pixels(h, s, v, pixels), batch, *p, static_cast<const int*>(cand),
      static_cast<const float*>(centers_by_k), q, nullptr,
      static_cast<u64*>(acc), static_cast<cudaStream_t>(stream));
}
