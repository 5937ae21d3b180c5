// K6: |rfft2|^2 of a batch of images, as two kernels: the row pass (K6a)
// and the column pass with the squared magnitude (K6b).
//
// Replace (photohive_dsp_tpu/ops/pallas_fft.py, magnitude2_scrambled):
//   K6a _row_fft_kernel  (lane DIF ladder + pruned group DFT)
//   K6b _col_fft_kernel / _col_fft_kernel_factored (tile FFT + sublane
//       ladder + |X|^2)
//
// What bounds them on an H100: bytes.  At 1080x1920 one image is 8.3 MB of
// float32 luma in, 8.3 MB of complex half spectrum between the passes and
// 4.2 MB of |X|^2 out; ~5 n log2 n float ops per length-n transform make
// ~0.11 GFLOP per image, under 2 us at 67 TFLOP/s, against ~6 us to move
// 20.8 MB at 3.35 TB/s.  So each pass should read and write every element
// once, with the stages in shared memory.
//
// Design.  The TPU kernels were shaped by the (8, 128) vreg tiling: a
// radix-2 ladder across lanes and sublanes whose bit-reversed output was
// absorbed by permuted polar tables.  Here each transform runs as a
// mixed-radix Stockham FFT in shared memory (natural order in and out,
// two ping-pong buffers, one __syncthreads per stage), with a templated
// r-point DFT for r in {2, 3, 4, 5, 7, 11, 13} and every twiddle read from
// the plan's float64-derived float32 table (ops/fft_plan.py); no __sinf,
// no fast math, and the library is built --fmad=false, so the plain
// version (ops/fft_kernels.py) repeats each float32 operation in order.
//   * K6a: one block per pair of real rows packed as one complex row (two
//     real FFTs for one complex FFT), split into the two half spectra in
//     the epilogue; loads and stores are row-contiguous.
//   * K6b: one block per tile of `lanes` adjacent columns of one image
//     (4 at H <= 1600, e.g. 1080p), so each row of the tile is one 32-byte
//     sector of the half spectrum; |X|^2 in the epilogue.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
// Shared memory a column tile aims for (two buffers of H x lanes complex),
// so that two blocks fit on one SM.
constexpr size_t kColSharedTarget = 100 * 1024;

}  // namespace

// Mirror of ops/_cuda.FftStages (same field order).
struct FftStages {
  int n;
  int count;
  int radix[kMaxStages];
};

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y)),
                     __fadd_rn(__fmul_rn(a.x, w.y), __fmul_rn(a.y, w.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// One Stockham stage of radix R after span ns on `lanes` interleaved
// sequences (element i of lane l at i * lanes + l):
//   j < n/R, k = j % ns:  v_q = src[j + q n/R] * W_{ns R}^{q k}
//   dst[(j - k) R + k + t ns] = sum_q v_q W_R^{q t}
template <int R>
__device__ void stage(const float2* __restrict__ src, float2* __restrict__ dst,
                      int n, int ns, int lanes, int lane_bits,
                      const float2* __restrict__ tw) {
  const int m = n / R;
  const int tw_step = n / (ns * R);
  float2 wr[R];
#pragma unroll
  for (int u = 0; u < R; ++u) wr[u] = __ldg(&tw[u * m]);
  for (int item = threadIdx.x; item < m * lanes; item += blockDim.x) {
    const int l = item & (lanes - 1);
    const int j = item >> lane_bits;
    const int k = j % ns;
    float2 v[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      v[q] = src[(j + q * m) * lanes + l];
      if (q > 0 && k > 0) v[q] = cmul(v[q], __ldg(&tw[q * k * tw_step]));
    }
    const int base = (j - k) * R + k;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      float2 acc = v[0];
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const int u = (q * t) % R;
        acc = cadd(acc, u == 0 ? v[q] : cmul(v[q], wr[u]));
      }
      dst[(base + t * ns) * lanes + l] = acc;
    }
  }
}

// Runs every stage; the input is in a, b is scratch of the same size.
// Returns the buffer that holds the transform (natural order).
__device__ float2* run_stages(float2* a, float2* b, const FftStages& st,
                              int lanes, int lane_bits,
                              const float2* __restrict__ tw) {
  int ns = 1;
  for (int s = 0; s < st.count; ++s) {
    const int r = st.radix[s];
    switch (r) {
      case 2: stage<2>(a, b, st.n, ns, lanes, lane_bits, tw); break;
      case 3: stage<3>(a, b, st.n, ns, lanes, lane_bits, tw); break;
      case 4: stage<4>(a, b, st.n, ns, lanes, lane_bits, tw); break;
      case 5: stage<5>(a, b, st.n, ns, lanes, lane_bits, tw); break;
      case 7: stage<7>(a, b, st.n, ns, lanes, lane_bits, tw); break;
      case 11: stage<11>(a, b, st.n, ns, lanes, lane_bits, tw); break;
      default: stage<13>(a, b, st.n, ns, lanes, lane_bits, tw); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    ns *= r;
  }
  return a;
}

// ---------------------------------------------------------------- K6a ---
// x: (rows, n) float32; out: (rows, half) float2.  Block p transforms
// z = x[2p] + i x[2p+1] (x[2p+1] = 0 past the last row).
__global__ void fft_rows_kernel(const float* __restrict__ x, int rows,
                                FftStages st, const float2* __restrict__ tw,
                                float2* __restrict__ out) {
  extern __shared__ float2 smem[];
  const int n = st.n;
  const int half = n / 2 + 1;
  const long long r0 = 2LL * blockIdx.x;
  const bool has1 = r0 + 1 < rows;
  const float* x0 = x + r0 * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    smem[i] = make_float2(x0[i], has1 ? x0[n + i] : 0.0f);
  }
  __syncthreads();
  const float2* z = run_stages(smem, smem + n, st, 1, 0, tw);
  float2* o0 = out + r0 * half;
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const float2 zk = z[k];
    const float2 zc = z[k == 0 ? 0 : n - k];   // Z[-k], conjugated below
    o0[k] = make_float2(__fmul_rn(__fadd_rn(zk.x, zc.x), 0.5f),
                        __fmul_rn(__fsub_rn(zk.y, zc.y), 0.5f));
    if (has1) {
      o0[half + k] = make_float2(__fmul_rn(__fadd_rn(zk.y, zc.y), 0.5f),
                                 __fmul_rn(__fsub_rn(zc.x, zk.x), 0.5f));
    }
  }
}

// ---------------------------------------------------------------- K6b ---
// spec: (B, H, half) float2; mag2: (B, H, half) float32.  Block (tile, b)
// transforms columns [tile * lanes, tile * lanes + lanes) of image b.
__global__ void fft_cols_kernel(const float2* __restrict__ spec, int half,
                                FftStages st, const float2* __restrict__ tw,
                                int lanes, int lane_bits,
                                float* __restrict__ mag2) {
  extern __shared__ float2 smem[];
  const int h = st.n;
  const int c0 = blockIdx.x * lanes;
  const long long img = static_cast<long long>(blockIdx.y) * h * half;
  for (int item = threadIdx.x; item < h * lanes; item += blockDim.x) {
    const int c = c0 + (item & (lanes - 1));
    const long long i = item >> lane_bits;
    smem[item] = c < half ? spec[img + i * half + c] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const float2* y = run_stages(smem, smem + h * lanes, st, lanes, lane_bits,
                               tw);
  for (int item = threadIdx.x; item < h * lanes; item += blockDim.x) {
    const int c = c0 + (item & (lanes - 1));
    const long long i = item >> lane_bits;
    if (c < half) {
      const float2 v = y[item];
      mag2[img + i * half + c] =
          __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    }
  }
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// C entry points (bound with ctypes in ops/_cuda.py).  Each returns the
// cudaError_t of its launch; tensors are contiguous float32.

// pgm: (rows, n) -> spec: (rows, n/2 + 1, 2).
extern "C" int ph_fft_rows(const void* pgm, int rows, const FftStages* st,
                           const void* twiddles, void* spec, void* stream) {
  const size_t bytes = 2 * static_cast<size_t>(st->n) * sizeof(float2);
  cudaError_t err = allow_shared(fft_rows_kernel, bytes);
  if (err != cudaSuccess) return err;
  fft_rows_kernel<<<(rows + 1) / 2, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pgm), rows, *st,
      static_cast<const float2*>(twiddles), static_cast<float2*>(spec));
  return cudaGetLastError();
}

// spec: (batch, H, half, 2) -> mag2: (batch, H, half), H = st->n.
extern "C" int ph_fft_cols(const void* spec, int batch, int half,
                           const FftStages* st, const void* twiddles,
                           void* mag2, void* stream) {
  int lanes = 4;
  int lane_bits = 2;
  while (lanes > 1 && 2 * static_cast<size_t>(st->n) * lanes * sizeof(float2) >
                          kColSharedTarget) {
    lanes >>= 1;
    --lane_bits;
  }
  const size_t bytes = 2 * static_cast<size_t>(st->n) * lanes * sizeof(float2);
  cudaError_t err = allow_shared(fft_cols_kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((half + lanes - 1) / lanes, batch);
  fft_cols_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), half, *st,
      static_cast<const float2*>(twiddles), lanes, lane_bits,
      static_cast<float*>(mag2));
  return cudaGetLastError();
}
