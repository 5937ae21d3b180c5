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
// the plan's float64-derived float32 tables (ops/fft_plan.py); no __sinf,
// no fast math, and the library is built --fmad=false, so the plain
// version (ops/fft_kernels.py) repeats each float32 operation in order.
//   * K6a: two real rows packed as one complex row (two real FFTs for one
//     complex FFT), split into the two half spectra in the epilogue.  A
//     block of 256 threads keeps `pairs` row pairs in flight (one group of
//     256 / pairs threads each) and walks over the row pairs of the whole
//     batch (a grid of as many blocks as the card holds at once), so it
//     stages the per-stage twiddle table (fft_plan.stage_twiddle_table:
//     stage after stage, [q][k], the same float32 values as the full table)
//     in shared memory once and every stage reads its twiddles
//     contiguously, with no index modulo.  Two adjacent stages whose
//     radices multiply to at most 16 (4x4, 4x2, 3x5, ...) run as one pass:
//     a thread holds the R1 R2 values that the two stages exchange only
//     among themselves in registers, so 1920 = 4.4.4.2.3.5 takes three
//     passes through shared memory, not six.  The buffers are XOR-swizzled
//     in blocks of 16 (swz), so the stride-16 writes of a first pass and
//     the contiguous reads meet no bank conflicts, at no extra memory.  An
//     item's position comes from (a, k) counters stepped per item instead
//     of a division.  The radix-2 and radix-4 DFTs multiply only by the
//     exact 1, -i, -1, i, so they are written as additions in the same
//     order (the same nonzero bits).  The first pass (span 1, no twiddles
//     before it) reads its items straight from the two rows, so the rows
//     are never staged as such.  Registers are capped at 80 a thread so
//     that three blocks fit an SM.
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
// K6a: blocks an SM should hold (registers are capped for it: 80 a
// thread; the radix-11 and -13 paths spill a little), at most this many
// row pairs a block, and the shared memory a block aims for (its buffers
// and the stage twiddles), so that kRowBlocksPerSm blocks fit an SM.
constexpr int kRowBlocksPerSm = 3;
constexpr int kMaxRowPairs = 4;
constexpr size_t kRowSharedTarget = 75 * 1024;
// The shared memory a block may take on an H100.
constexpr size_t kMaxShared = 232448;

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
// Adjacent stages of radices r1, r2 that one thread runs as one pass in
// registers (fft_plan.FUSED_PAIRS: r1 r2 <= 16, in the order the plan
// gives its radices).  Which stages fuse changes no bit of the output,
// only the passes through shared memory.
__host__ __device__ constexpr bool fused_pair(int r1, int r2) {
  return (r1 == 4 && (r2 == 4 || r2 == 2 || r2 == 3)) ||
         (r1 == 2 && (r2 == 3 || r2 == 5 || r2 == 7)) ||
         (r1 == 3 && (r2 == 3 || r2 == 5));
}

// Where element i of a row buffer sits: XOR-swizzled within its block of
// 16, so that a pass's stride-16 (or -8) writes and its contiguous reads
// meet no bank conflicts; a buffer holds n rounded up to 16.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 4) & 15); }

// W_R^u = tw[u n / R] for the R-point DFT (none for R = 1, 2, 4).
template <int R>
__device__ __forceinline__ void dft_twiddles(float2 (&wr)[R],
                                             const float2* __restrict__ tw,
                                             int n) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    wr[u] = R == 1 || R == 2 || R == 4 ? float2{} : __ldg(&tw[u * (n / R)]);
  }
}

// The R-point DFT of v into y, y_t = v_0 + sum_{q>=1} v_q W_R^{qt} added in
// ascending q.  For R = 2 and 4, W_R^u is exactly 1, -i, -1 or i, and the
// product is the swap and negation that cmul gives for those values.
template <int R>
__device__ __forceinline__ void dft(const float2 (&v)[R], const float2 (&wr)[R],
                                    float2 (&y)[R]) {
  if constexpr (R == 2) {
    y[0] = cadd(v[0], v[1]);
    y[1] = make_float2(__fsub_rn(v[0].x, v[1].x), __fsub_rn(v[0].y, v[1].y));
  } else if constexpr (R == 4) {
    // u = q t mod 4: W^1 = -i, W^2 = -1, W^3 = i.
    y[0] = cadd(cadd(cadd(v[0], v[1]), v[2]), v[3]);
    y[1] = make_float2(
        __fsub_rn(__fsub_rn(__fadd_rn(v[0].x, v[1].y), v[2].x), v[3].y),
        __fadd_rn(__fsub_rn(__fsub_rn(v[0].y, v[1].x), v[2].y), v[3].x));
    y[2] = make_float2(
        __fsub_rn(__fadd_rn(__fsub_rn(v[0].x, v[1].x), v[2].x), v[3].x),
        __fsub_rn(__fadd_rn(__fsub_rn(v[0].y, v[1].y), v[2].y), v[3].y));
    y[3] = make_float2(
        __fadd_rn(__fsub_rn(__fsub_rn(v[0].x, v[1].y), v[2].x), v[3].y),
        __fsub_rn(__fsub_rn(__fadd_rn(v[0].y, v[1].x), v[2].y), v[3].x));
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      float2 acc = v[0];
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const int u = (q * t) % R;
        acc = cadd(acc, u == 0 ? v[q] : cmul(v[q], wr[u]));
      }
      y[t] = acc;
    }
  }
}

// One pass of the row FFT after span ns: the Stockham stage of radix R1,
// then (R2 > 1) the stage of radix R2 after span ns R1, with no exchange
// between them.  Stage s's butterfly j = a ns + k reads x[j + q n/R1]
// (times stw[ns - 1 + (q - 1) ns + k], skipped at k = 0) and writes
// y[a ns R1 + t ns + k]; stage s+1's butterflies t ns + k + a' ns R1, t <
// R1, read exactly the outputs of stage s's butterflies g + p n/(R1 R2), p
// < R2, g = a' ns + k.  So item g does those R2 DFTs of R1 points, then R1
// DFTs of R2 points (times stw[ns R1 - 1 + (p - 1) ns R1 + t ns + k],
// skipped where t ns + k = 0), and writes y[a' ns R1 R2 + t' ns R1 + t ns +
// k]: each output gets the operations of stockham_plain in its order.  The
// first pass (kRows, ns = 1, no twiddles before it) reads the pair z = x0 +
// i x1 straight from the rows (x1 == nullptr: zeros).  Items g = t0, t0 +
// nt, ... of n / (R1 R2).
template <int R1, int R2, bool kRows>
__device__ void row_pass(const float* __restrict__ x0,
                         const float* __restrict__ x1,
                         const float2* __restrict__ src,
                         float2* __restrict__ dst, int n, int ns,
                         const float2* __restrict__ stw,
                         const float2* __restrict__ tw, int t0, int nt) {
  const int m1 = n / R1;
  const int items = n / (R1 * R2);
  const int ns1 = ns * R1;
  const float2* stw1 = stw + (ns - 1);
  const float2* stw2 = stw + (ns1 - 1);
  float2 w1[R1];
  float2 w2[R2];
  dft_twiddles<R1>(w1, tw, n);
  dft_twiddles<R2>(w2, tw, n);
  // g = a ns + k, stepped by nt without a division.
  const int dk = nt % ns;
  const int da = nt / ns;
  int k = t0 % ns;
  int a = t0 / ns;
  for (int g = t0; g < items; g += nt) {
    float2 u[R2][R1];
#pragma unroll
    for (int p = 0; p < R2; ++p) {
      const int j = g + p * items;
      float2 v[R1];
#pragma unroll
      for (int q = 0; q < R1; ++q) {
        const int i = j + q * m1;
        if constexpr (kRows) {
          v[q] = make_float2(__ldcs(&x0[i]), x1 ? __ldcs(&x1[i]) : 0.0f);
        } else {
          v[q] = src[swz(i)];
          if (q > 0 && k > 0) v[q] = cmul(v[q], stw1[(q - 1) * ns + k]);
        }
      }
      dft<R1>(v, w1, u[p]);
    }
    const int base = a * ns1 * R2 + k;
#pragma unroll
    for (int t = 0; t < R1; ++t) {
      if constexpr (R2 == 1) {
        dst[swz(base + t * ns)] = u[0][t];
      } else {
        const int k2 = t * ns + k;
        float2 v[R2];
#pragma unroll
        for (int p = 0; p < R2; ++p) {
          v[p] = u[p][t];
          if (p > 0 && k2 > 0) v[p] = cmul(v[p], stw2[(p - 1) * ns1 + k2]);
        }
        float2 y[R2];
        dft<R2>(v, w2, y);
#pragma unroll
        for (int tt = 0; tt < R2; ++tt) dst[swz(base + tt * ns1 + t * ns)] = y[tt];
      }
    }
    k += dk;
    a += da;
    if (k >= ns) {
      k -= ns;
      ++a;
    }
  }
}

// row_pass for the radices of one pass (r2 = 1: a single stage), with one
// switch outside the butterfly loop.  kWide: the plan has a radix of 7, 11
// or 13; a kernel without (every shape of 2, 3 and 5 alone) leaves their
// code out, so that their registers do not bound its own.
template <bool kRows, bool kWide>
__device__ void row_pass_of(int r1, int r2, const float* __restrict__ x0,
                            const float* __restrict__ x1,
                            const float2* __restrict__ src,
                            float2* __restrict__ dst, int n, int ns,
                            const float2* __restrict__ stw,
                            const float2* __restrict__ tw, int t0, int nt) {
#define PH_ROW_PASS(A, B) \
  row_pass<A, B, kRows>(x0, x1, src, dst, n, ns, stw, tw, t0, nt)
  switch (r1 * 16 + r2) {
    case 4 * 16 + 4: PH_ROW_PASS(4, 4); break;
    case 4 * 16 + 2: PH_ROW_PASS(4, 2); break;
    case 4 * 16 + 3: PH_ROW_PASS(4, 3); break;
    case 2 * 16 + 3: PH_ROW_PASS(2, 3); break;
    case 2 * 16 + 5: PH_ROW_PASS(2, 5); break;
    case 3 * 16 + 3: PH_ROW_PASS(3, 3); break;
    case 3 * 16 + 5: PH_ROW_PASS(3, 5); break;
    case 2 * 16 + 1: PH_ROW_PASS(2, 1); break;
    case 3 * 16 + 1: PH_ROW_PASS(3, 1); break;
    case 4 * 16 + 1: PH_ROW_PASS(4, 1); break;
    case 5 * 16 + 1: PH_ROW_PASS(5, 1); break;
    default:
      if constexpr (kWide) {
        switch (r1 * 16 + r2) {
          case 2 * 16 + 7: PH_ROW_PASS(2, 7); break;
          case 7 * 16 + 1: PH_ROW_PASS(7, 1); break;
          case 11 * 16 + 1: PH_ROW_PASS(11, 1); break;
          default: PH_ROW_PASS(13, 1); break;
        }
      }
      break;
  }
#undef PH_ROW_PASS
}

// The radix of the stage run with stage s in one pass, or 1.
__host__ __device__ inline int pass_partner(const FftStages& st, int s) {
  return s + 1 < st.count && fused_pair(st.radix[s], st.radix[s + 1])
             ? st.radix[s + 1]
             : 1;
}

// x: (rows, n) float32; out: (rows, half) float2.  Row pair p transforms
// z = x[2p] + i x[2p+1] (x[2p+1] = 0 past the last row).  Group g of the
// block's `pairs` groups takes pairs blockIdx.x * pairs + g, then the same
// plus gridDim.x * pairs, and so on.  Shared memory: the stage twiddles
// (tw_len float2, when stw_shared) | per group two buffers of seq float2
// (n rounded up to 16, swizzled by swz).
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kRowBlocksPerSm)
    fft_rows_kernel(const float* __restrict__ x, int rows, FftStages st,
                    const float2* __restrict__ tw,
                    const float2* __restrict__ stage_tw, int tw_len,
                    bool stw_shared, int seq, int pairs,
                    float2* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int n = st.n;
  const int half = n / 2 + 1;
  const int nt = blockDim.x / pairs;
  const int g = threadIdx.x / nt;
  const int t0 = threadIdx.x - g * nt;
  if (stw_shared) {
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) smem[i] = stage_tw[i];
  }
  const float2* stw = stw_shared ? smem : stage_tw;
  float2* const buf = smem + (stw_shared ? tw_len : 0) + 2LL * g * seq;
  const long long n_pairs = (rows + 1) / 2;
  for (long long p0 = static_cast<long long>(blockIdx.x) * pairs; p0 < n_pairs;
       p0 += static_cast<long long>(gridDim.x) * pairs) {
    const long long pair = p0 + g;
    const bool live = pair < n_pairs;   // uniform over the group
    const long long r0 = 2 * pair;
    const bool has1 = r0 + 1 < rows;
    const float* x0 = x + r0 * n;
    const float* x1 = has1 ? x0 + n : nullptr;
    float2* z = buf;
    float2* y = buf + seq;
    if (live && st.count == 0 && t0 == 0) {
      z[0] = make_float2(x0[0], x1 ? x1[0] : 0.0f);
    }
    int ns = 1;
    for (int s = 0; s < st.count;) {
      const int r1 = st.radix[s];
      const int r2 = pass_partner(st, s);
      if (live) {
        if (s == 0) {
          row_pass_of<true, kWide>(r1, r2, x0, x1, nullptr, z, n, ns, stw, tw,
                                   t0, nt);
        } else {
          row_pass_of<false, kWide>(r1, r2, nullptr, nullptr, z, y, n, ns,
                                    stw, tw, t0, nt);
        }
      }
      __syncthreads();
      if (s > 0) {
        float2* t = z;
        z = y;
        y = t;
      }
      ns *= r1 * r2;
      s += r2 > 1 ? 2 : 1;
    }
    if (live) {
      float2* o0 = out + r0 * half;
      for (int k = t0; k < half; k += nt) {
        const float2 zk = z[swz(k)];
        const float2 zc = z[swz(k == 0 ? 0 : n - k)];   // Z[-k], conjugated below
        __stcs(&o0[k], make_float2(__fmul_rn(__fadd_rn(zk.x, zc.x), 0.5f),
                                   __fmul_rn(__fsub_rn(zk.y, zc.y), 0.5f)));
        if (has1) {
          __stcs(&o0[half + k],
                 make_float2(__fmul_rn(__fadd_rn(zk.y, zc.y), 0.5f),
                             __fmul_rn(__fsub_rn(zc.x, zk.x), 0.5f)));
        }
      }
    }
    __syncthreads();   // the next pairs' loads overwrite the buffers
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

// pgm: (rows, n) -> spec: (rows, n/2 + 1, 2).  stage_twiddles: the plan's
// (n - 1, 2) per-stage table.
extern "C" int ph_fft_rows(const void* pgm, int rows, const FftStages* st,
                           const void* twiddles, const void* stage_twiddles,
                           void* spec, void* stream) {
  const int n = st->n;
  // A row buffer: n rounded up to the swizzle's blocks of 16 (so at most
  // MAX_LENGTH = 14528, a multiple of 16, when n is).
  const int seq = (n + 15) & ~15;
  const size_t pair_bytes = 2 * static_cast<size_t>(seq) * sizeof(float2);
  // Even, so that the buffers after the table stay 16-byte aligned.
  const int tw_len = n & ~1;
  const size_t tw_bytes = tw_len * sizeof(float2);
  const bool stw_shared = tw_bytes + pair_bytes <= kMaxShared;
  const size_t base = stw_shared ? tw_bytes : 0;
  // The most items of one pass: a group of 256 / pairs threads should do
  // each pass in at most two rounds.
  int most = 1;
  bool wide = false;
  for (int s = 0; s < st->count; ++s) wide = wide || st->radix[s] > 5;
  auto kernel = wide ? fft_rows_kernel<true> : fft_rows_kernel<false>;
  for (int s = 0; s < st->count;) {
    const int r2 = pass_partner(*st, s);
    const int items = n / (st->radix[s] * r2);
    most = items > most ? items : most;
    s += r2 > 1 ? 2 : 1;
  }
  // The most row pairs (1, 2 or 4) whose buffers fit kRowSharedTarget.
  int pairs = kMaxRowPairs;
  while (pairs > 1 && (base + pairs * pair_bytes > kRowSharedTarget ||
                       2 * (kThreads / pairs) < most)) {
    pairs >>= 1;
  }
  const size_t bytes = base + pairs * pair_bytes;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  const long long groups = ((rows + 1) / 2 + pairs - 1) / pairs;
  const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(groups < resident ? groups : resident);
  if (grid == 0) return cudaSuccess;
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pgm), rows, *st,
      static_cast<const float2*>(twiddles),
      static_cast<const float2*>(stage_twiddles), tw_len, stw_shared, seq,
      pairs, static_cast<float2*>(spec));
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
