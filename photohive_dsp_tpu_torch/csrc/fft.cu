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
//   * K6b: one block of 512 threads per tile of `lanes` adjacent columns
//     of one image, one block an SM (fft_plan.col_tile: 8 columns at H =
//     1080, so a row of the tile is two full 32-byte sectors of the half
//     spectrum and one of |X|^2; 4 at 2160; 1 past ~5800), with K6a's
//     passes run on each column of the tile: two stages a pass in
//     registers, the per-stage twiddle table in shared memory (in device
//     memory past ~9700), (a, k) counters.  The first pass reads its
//     values straight from the half spectrum and the last writes |X|^2
//     straight to mag2 (streaming loads and stores), so a tile goes
//     through shared memory only between passes: twice at 1080 =
//     (4,2)(3,3)(3,5), where the first design went through it eight
//     times (a load, six stages, a store).  The two tile buffers
//     interleave the columns, their rows XOR-swizzled within a 128-byte
//     line (col_at).  What bounds it is the column access itself: a copy
//     of the half spectrum to |X|^2 in the same tile order, with no FFT,
//     takes ~80% of its time (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStages = 16;
// K6b: threads a block (fft_plan.COL_THREADS), one block an SM.
constexpr int kColThreads = 512;
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
    __syncthreads();   // a fused first pass reads its second stage's part
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
// Where element i of column l sits in a tile buffer of 2^lane_bits
// interleaved columns (i * lanes + l before the swizzle): row i is
// XOR-swizzled by its bits 3 and 4 within its group of 16 / lanes rows
// (one 128-byte line), so that the stride-8 and stride-16 writes of a
// first pass and the contiguous reads of the next meet (almost) no bank
// conflicts, at no extra memory (fft_plan.col_tile rounds a buffer up to
// a line).
__device__ __forceinline__ int col_at(int i, int l, int lane_bits) {
  return ((i ^ (((i >> 3) ^ (i >> 4)) & ((16 >> lane_bits) - 1)))
          << lane_bits) | l;
}

// One thread's view of a pass over a column tile: its column l, and its
// first butterfly g0 and step ng in the pass.
struct ColPass {
  const float2* col;   // the half spectrum at (row 0, this column)
  float* out;          // mag2 at (row 0, this column)
  const float2* src;   // the tile buffer a pass reads (not the first)
  float2* dst;         // the tile buffer a pass writes (not the last)
  const float2* stw;   // the stage twiddles
  const float2* tw;    // the full twiddle table
  int half, l, lane_bits, n, ns, g0, ng;
};

// row_pass's arithmetic on the thread's column of a tile: item g of the
// pass after span ns, the same float32 operations in the same order.
// kFirst (ns = 1): the values come straight from the half spectrum, rows
// `half` apart; kLast: |y|^2 goes straight to mag2, else y to the tile
// buffer.
template <int R1, int R2, bool kFirst, bool kLast>
__device__ void col_pass(const ColPass& p) {
  const int n = p.n;
  const int ns = p.ns;
  const int m1 = n / R1;
  const int items = n / (R1 * R2);
  const int ns1 = ns * R1;
  const float2* stw1 = p.stw + (ns - 1);
  const float2* stw2 = p.stw + (ns1 - 1);
  float2 w1[R1];
  float2 w2[R2];
  dft_twiddles<R1>(w1, p.tw, n);
  dft_twiddles<R2>(w2, p.tw, n);
  auto put = [&](int i, float2 y) {
    if constexpr (kLast) {
      __stcs(&p.out[static_cast<size_t>(i) * p.half],
             __fadd_rn(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y)));
    } else {
      p.dst[col_at(i, p.l, p.lane_bits)] = y;
    }
  };
  const int dk = p.ng % ns;
  const int da = p.ng / ns;
  int k = p.g0 % ns;
  int a = p.g0 / ns;
  for (int g = p.g0; g < items; g += p.ng) {
    float2 u[R2][R1];
#pragma unroll
    for (int q2 = 0; q2 < R2; ++q2) {
      const int j = g + q2 * items;
      float2 v[R1];
#pragma unroll
      for (int q = 0; q < R1; ++q) {
        const int i = j + q * m1;
        if constexpr (kFirst) {
          v[q] = __ldcs(&p.col[static_cast<size_t>(i) * p.half]);
        } else {
          v[q] = p.src[col_at(i, p.l, p.lane_bits)];
          if (q > 0 && k > 0) v[q] = cmul(v[q], stw1[(q - 1) * ns + k]);
        }
      }
      dft<R1>(v, w1, u[q2]);
    }
    const int base = a * ns1 * R2 + k;
#pragma unroll
    for (int t = 0; t < R1; ++t) {
      if constexpr (R2 == 1) {
        put(base + t * ns, u[0][t]);
      } else {
        const int k2 = t * ns + k;
        float2 v[R2];
#pragma unroll
        for (int q2 = 0; q2 < R2; ++q2) {
          v[q2] = u[q2][t];
          if (q2 > 0 && k2 > 0) v[q2] = cmul(v[q2], stw2[(q2 - 1) * ns1 + k2]);
        }
        float2 y[R2];
        dft<R2>(v, w2, y);
#pragma unroll
        for (int tt = 0; tt < R2; ++tt) put(base + tt * ns1 + t * ns, y[tt]);
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

// col_pass for the radices of one pass, as row_pass_of.
template <bool kFirst, bool kLast, bool kWide>
__device__ void col_pass_radices(int r1, int r2, const ColPass& p) {
#define PH_COL_PASS(A, B) col_pass<A, B, kFirst, kLast>(p)
  switch (r1 * 16 + r2) {
    case 4 * 16 + 4: PH_COL_PASS(4, 4); break;
    case 4 * 16 + 2: PH_COL_PASS(4, 2); break;
    case 4 * 16 + 3: PH_COL_PASS(4, 3); break;
    case 2 * 16 + 3: PH_COL_PASS(2, 3); break;
    case 2 * 16 + 5: PH_COL_PASS(2, 5); break;
    case 3 * 16 + 3: PH_COL_PASS(3, 3); break;
    case 3 * 16 + 5: PH_COL_PASS(3, 5); break;
    case 2 * 16 + 1: PH_COL_PASS(2, 1); break;
    case 3 * 16 + 1: PH_COL_PASS(3, 1); break;
    case 4 * 16 + 1: PH_COL_PASS(4, 1); break;
    case 5 * 16 + 1: PH_COL_PASS(5, 1); break;
    default:
      if constexpr (kWide) {
        switch (r1 * 16 + r2) {
          case 2 * 16 + 7: PH_COL_PASS(2, 7); break;
          case 7 * 16 + 1: PH_COL_PASS(7, 1); break;
          case 11 * 16 + 1: PH_COL_PASS(11, 1); break;
          default: PH_COL_PASS(13, 1); break;
        }
      }
      break;
  }
#undef PH_COL_PASS
}

// spec: (B, H, half) float2; mag2: (B, H, half) float32.  Block (tile, b)
// transforms columns [tile * lanes, tile * lanes + lanes) of image b in
// passes of one or two stages (pass_partner, as K6a): the first reads its
// values straight from spec, the last writes |X|^2 straight to mag2 (a
// row of the tile is 64 bytes of spec at 8 lanes, two sectors), and the
// passes between go through two tile buffers (col_at).  Shared memory
// (fft_plan.col_tile): the stage twiddles (tw_len float2, when
// stw_shared) | two buffers of seq float2.  Thread t takes column t %
// lanes and every (blockDim.x / lanes)-th butterfly of a pass from t /
// lanes; the threads of a column past half sit the passes out.
template <bool kWide>
__global__ void __launch_bounds__(kColThreads, 1)
    fft_cols_kernel(const float2* __restrict__ spec, int half, FftStages st,
                    const float2* __restrict__ tw,
                    const float2* __restrict__ stage_tw, int tw_len,
                    bool stw_shared, int seq, int lane_bits,
                    float* __restrict__ mag2) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int n = st.n;
  if (stw_shared) {
    for (int i = threadIdx.x; i < n - 1; i += blockDim.x) smem[i] = stage_tw[i];
    __syncthreads();
  }
  float2* x = smem + (stw_shared ? tw_len : 0);
  float2* y = x + seq;
  const int l = threadIdx.x & ((1 << lane_bits) - 1);
  const int c = (blockIdx.x << lane_bits) + l;
  const bool live = c < half;
  const size_t at = static_cast<size_t>(blockIdx.y) * n * half + c;
  ColPass p{spec + at, mag2 + at, x, x, stw_shared ? smem : stage_tw, tw,
            half, l, lane_bits, n, 1,
            static_cast<int>(threadIdx.x >> lane_bits),
            static_cast<int>(blockDim.x >> lane_bits)};
  if (st.count == 0) {
    if (live && p.g0 == 0) {
      const float2 v = __ldcs(p.col);
      __stcs(p.out, __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
    }
    return;
  }
  for (int s = 0; s < st.count;) {
    const int r1 = st.radix[s];
    const int r2 = pass_partner(st, s);
    const int next = s + (r2 > 1 ? 2 : 1);
    const bool last = next == st.count;
    if (live) {
      if (s == 0) {
        if (last) {
          col_pass_radices<true, true, kWide>(r1, r2, p);
        } else {
          col_pass_radices<true, false, kWide>(r1, r2, p);
        }
      } else if (last) {
        col_pass_radices<false, true, kWide>(r1, r2, p);
      } else {
        col_pass_radices<false, false, kWide>(r1, r2, p);
      }
    }
    if (last) break;
    __syncthreads();
    // The first pass wrote x; each later one reads x and writes y.
    if (s > 0) {
      float2* t = x;
      x = y;
      y = t;
    }
    p.src = x;
    p.dst = y;
    p.ns *= r1 * r2;
    s = next;
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

// Mirror of ops/_cuda.ColTile: fft_plan.col_tile of the column length.
struct ColTile {
  int lane_bits;
  int stw_shared;
  int tw_len;
  int seq;
  int bytes;
};

// spec: (batch, H, half, 2) -> mag2: (batch, H, half), H = st->n.
// stage_twiddles: the plan's (H - 1, 2) per-stage table.
extern "C" int ph_fft_cols(const void* spec, int batch, int half,
                           const FftStages* st, const void* twiddles,
                           const void* stage_twiddles, const ColTile* tile,
                           void* mag2, void* stream) {
  if (tile->bytes > static_cast<int>(kMaxShared)) return cudaErrorInvalidValue;
  bool wide = false;
  for (int s = 0; s < st->count; ++s) wide = wide || st->radix[s] > 5;
  auto kernel = wide ? fft_cols_kernel<true> : fft_cols_kernel<false>;
  cudaError_t err = allow_shared(kernel, tile->bytes);
  if (err != cudaSuccess) return err;
  const int lanes = 1 << tile->lane_bits;
  const dim3 grid((half + lanes - 1) / lanes, batch);
  if (grid.x == 0 || grid.y == 0) return cudaSuccess;
  kernel<<<grid, kColThreads, tile->bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(spec), half, *st,
      static_cast<const float2*>(twiddles),
      static_cast<const float2*>(stage_twiddles), tile->tw_len,
      tile->stw_shared != 0, tile->seq, tile->lane_bits,
      static_cast<float*>(mag2));
  return cudaGetLastError();
}
