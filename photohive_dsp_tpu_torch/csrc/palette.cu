// Palette kernels: the cell histogram with the saturation sum (K1, and K9
// on flat HSV, K15 on precomputed cell ids) and the per-slot palette sums at
// q=1 (K3), q>1 (K4, and K10 on flat HSV) and over each cell's allowed
// parents (K14, C-wide, flat HSV).
//
// Replace (photohive_dsp_tpu/ops/pallas_kernels_bf16.py):
//   K1 cell_counts_s_from_rgb   (_cell_counts_rgb_kernel_bf16)
//   K3 palette_sums_by_k_rgb_q1 (_palette_rgb_q1_kernel_bf16)
//   K4 palette_sums_by_k_rgb    (_palette_rgb_kernel_bf16)
// and (photohive_dsp_tpu/ops/pallas_kernels.py):
//   K9  cell_counts_from_hsv    (_cell_counts_hsv_kernel)
//   K10 palette_sums_by_k       (_palette_kernel)
//   K11 cell_counts_s_from_rgb  (_cell_counts_rgb_kernel, float32 RGB)
//   K12 palette_sums_by_k_rgb_q1 (_palette_rgb_q1_kernel, float32 RGB)
//   K13 palette_sums_by_k_rgb   (_palette_rgb_kernel, float32 RGB)
//   K15 cell_counts_batched     (_cell_counts_kernel)
// and (photohive_dsp_tpu/ops/pallas_kernels_cwide.py):
//   K14 palette_sums_by_k_cwide (_palette_kernel_cwide)
// The TPU's "candidate" kernels K11-K13 and its bf16 kernels K1, K3 and K4
// have one specification (exact counts, first-minimum tie-breaks) and
// differ only in how they split MXU operands; here both are the float32
// instantiations (RgbPixels<float>) of the one kernel per function, which
// also takes uint8.  K9 and K10 are the same kernels as K1 and K4 fed by a
// flat-HSV pixel source (HsvPixels below): (B, P) float32 h, s, v planes in
// which a hue below 0 marks a pixel that counts for nothing (the
// row-sharded report's padded rows).  Such a pixel is skipped before any
// table is touched, so a sentinel tail changes no bit of the outputs.  K15
// is K1's kernel fed precomputed cell ids (CellIdPixels); an id outside
// [0, C) counts for nothing.
//
// K14 is K10 with the candidate table replaced by each cell's allowed
// parents as a bitmask (ceil(C/32) words per cell): a pixel walks the set
// bits of its cell's row in ascending slot order, so it needs no q tier
// and no tier read on the host.  Where K10 and K14 see the same candidates
// their accumulators are equal bit for bit.  A cell with no allowed parent
// (which parent_assignment_from_order never makes for a populated cell)
// sends its pixels to slot 0, as the TPU kernel's finite masking does;
// K10 drops them.
//
// What bounds them on an H100: each pixel costs three loads (3 B as u8,
// 12 B as f32), then ~60 float ops including two IEEE divisions for HSV
// (the cell id takes none: hsv_cells.cuh bin_index), then its adds into
// the tables.  A 1080p frame reads 6.2 MB (u8) or 24.9 MB (f32), a few
// microseconds at 3.35 TB/s, so the kernels are bound by instruction rate
// and by the adds into shared memory when many pixels share a cell (flat
// images).
//
// Design.  The TPU kernels turned the histogram and the sums into one-hot
// matrix products on the MXU, with bf16 splits to keep them exact.  Here
// each pixel adds directly into a table in shared memory, and the
// candidate tables a pixel reads (K4: its cell's <= q tie candidates and
// the candidate centres; K3: its cell's slot and hue offset) sit in shared
// memory too.  A block covers a contiguous run of one image's pixels
// (grid = pixel runs x images); it flushes its nonzero table entries into a
// per-image accumulator in device memory with 64-bit integer atomics, and
// for K1, K3 and K4 a second small kernel converts the accumulator to the
// outputs; K9, K10 and K14 return the accumulator itself.  Each thread
// takes 4 adjacent pixels at a time (one 4-byte load per uint8 plane, one
// float4 per float plane, where the pixel count is a multiple of 4), and
// uint8 decodes through a table of x / 255 in shared memory.  The grid is
// one wave of the blocks the card holds at once (one_wave.cuh).
//
// K1/K9/K11/K15 (cell_counts_s_kernel) add one count a pixel with a
// native 32-bit shared-memory atomic.
//
// K3/K4/K10/K14 (palette_sums_kernel) add four values a pixel (three
// 64-bit sums and a count), so their adds are what they spend.  On sm_90 a
// 64-bit shared-memory atomicAdd is a compare-and-swap loop (SASS
// ATOMS.CAST.SPIN.64), which lanes of a warp on one slot retry in turn.
// So each 64-bit sum is kept in 32-bit words that native 32-bit atomics
// add exactly (add64: the add that wraps the low word carries into the
// high word; the hue's top bits have a word of their own, so that carries
// stay rare).  A warp whose 32 pixels of a step share one slot sums them
// first with 32-bit warp reductions (exact on 27-bit splits) and adds
// once; other warps add pixel by pixel, with native atomics.  Each thread
// finds the slots of its 4 pixels before the warp adds, so the warp waits
// for its longest candidate walk once a step.  A K4/K10 pixel reads each
// candidate's centre as one float4.
//
// The flat-HSV kernels read 12 B per real pixel (4 B per sentinel pixel)
// and skip the HSV arithmetic.  K14's bitmask is C * ceil(C/32) words
// (1.8 KB at C=112) and sits in shared memory like K4's candidate table;
// past kSharedBudget (C=2164: 585 KB) it is read from device memory, as
// K4's table is.  K15 reads 4 B per id and adds as K1 does.
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
#include "one_wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Pixels a thread takes at a time.
constexpr int kVec = 4;
constexpr float kFixedOne = 268435456.0f;  // 2^28
// Shared memory a block may take for K4's candidate table (or K14's
// bitmask) before the table is read from device memory instead (huge
// configs: C=2164 has up to 728 candidates per cell).
constexpr size_t kSharedBudget = 160 * 1024;
// A fixed-point value is below 360 * 2^28 < 2^37; its low kSplitBits and
// the rest each sum over a warp's 32 lanes without wrapping 32 bits.
constexpr int kSplitBits = 27;

typedef unsigned long long u64;

// x * 2^28 is exact in float32, so rounding it to the nearest integer
// (ties to even) is the plain version's round(float64(x) * 2^28).
__device__ __forceinline__ u64 to_fixed(float x) {
  return __float2ull_rn(__fmul_rn(x, kFixedOne));
}

__device__ __forceinline__ float from_fixed(u64 x) {
  return static_cast<float>(static_cast<double>(x) / 268435456.0);
}

__device__ __forceinline__ float wrap360(float t) {
  return t > 360.0f ? __fsub_rn(t, 360.0f)
                    : (t < 0.0f ? __fadd_rn(t, 360.0f) : t);
}

// One pixel as a source gives it; real is false for a pixel that counts
// for nothing (past the end, a hue sentinel, an id outside [0, C)).
struct Pixel {
  float h, s, v;
  int cell;
  bool real;
};

// What a pixel source reads: the cell thresholds (CellBounds) and, for
// uint8, the decode table in shared memory.
struct FrontEnd {
  CellBounds bounds;
  const float* unit;
};

// Pixel sources.  load4() gives pixels i..i+3 of image b (i a multiple of
// kVec); pixels at or past `end` are not real.  With vec, the planes are
// read with one 4-pixel load each (the pixel count is a multiple of 4 and
// the planes aligned).  kUnitFloats: the floats of the decode table the
// source needs; kBounds: whether it needs the cell thresholds (and has a
// saturation to sum).
//
// Planar RGB, (B, 3, P) uint8 or float32: every pixel is real.  uint8
// decodes through fe.unit (fill_unit_table).
template <typename T>
struct RgbPixels {
  static constexpr int kUnitFloats = sizeof(T) == 1 ? 256 : 0;
  static constexpr bool kBounds = true;
  const T* rgb;
  long long pixels;
  bool vec;
  __device__ __forceinline__ void load4(int b, long long i, long long end,
                                        const CellParams& p,
                                        const FrontEnd& fe,
                                        Pixel (&px)[kVec]) const {
    const T* img = rgb + static_cast<long long>(b) * 3 * pixels;
    float c[3][kVec];
    if (vec && i + kVec <= end) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        if constexpr (kUnitFloats > 0) {
          const unsigned w =
              *reinterpret_cast<const unsigned*>(img + ch * pixels + i);
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            c[ch][j] = fe.unit[(w >> (8 * j)) & 255u];
          }
        } else {
          const float4 w =
              __ldg(reinterpret_cast<const float4*>(img + ch * pixels + i));
          c[ch][0] = w.x;
          c[ch][1] = w.y;
          c[ch][2] = w.z;
          c[ch][3] = w.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const T x = i + j < end ? img[ch * pixels + i + j] : T(0);
          if constexpr (kUnitFloats > 0) {
            c[ch][j] = fe.unit[x];
          } else {
            c[ch][j] = x;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      px[j].real = i + j < end;
      rgb_hsv_cell(c[0][j], c[1][j], c[2][j], p, fe.bounds, px[j].h,
                   px[j].s, px[j].v, px[j].cell);
    }
  }
};

// Flat HSV, three (B, P) float32 planes; a hue below 0 (or NaN) is the
// sentinel of a pixel outside the image.
struct HsvPixels {
  static constexpr int kUnitFloats = 0;
  static constexpr bool kBounds = true;
  const float* h;
  const float* s;
  const float* v;
  long long pixels;
  bool vec;
  __device__ __forceinline__ void load4(int b, long long i, long long end,
                                        const CellParams& p,
                                        const FrontEnd& fe,
                                        Pixel (&px)[kVec]) const {
    const long long o = static_cast<long long>(b) * pixels + i;
    if (vec && i + kVec <= end) {
      const float4 hh = __ldg(reinterpret_cast<const float4*>(h + o));
      const float4 ss = __ldg(reinterpret_cast<const float4*>(s + o));
      const float4 vv = __ldg(reinterpret_cast<const float4*>(v + o));
      px[0] = Pixel{hh.x, ss.x, vv.x, 0, true};
      px[1] = Pixel{hh.y, ss.y, vv.y, 0, true};
      px[2] = Pixel{hh.z, ss.z, vv.z, 0, true};
      px[3] = Pixel{hh.w, ss.w, vv.w, 0, true};
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        px[j] = i + j < end ? Pixel{h[o + j], s[o + j], v[o + j], 0, true}
                            : Pixel{-1.0f, 0.0f, 0.0f, 0, false};
      }
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      px[j].real = px[j].real && px[j].h >= 0.0f;
      if (px[j].real) {
        px[j].cell = hsv_cell(px[j].h, px[j].s, px[j].v, p, fe.bounds);
      }
    }
  }
};

// Precomputed cell ids, (B, P) int32: an id outside [0, C) counts for
// nothing.  No saturation (s = 0).
struct CellIdPixels {
  static constexpr int kUnitFloats = 0;
  static constexpr bool kBounds = false;
  const int* ids;
  long long pixels;
  bool vec;
  __device__ __forceinline__ void load4(int b, long long i, long long end,
                                        const CellParams& p,
                                        const FrontEnd&,
                                        Pixel (&px)[kVec]) const {
    const long long o = static_cast<long long>(b) * pixels + i;
    int id[kVec];
    if (vec && i + kVec <= end) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(ids + o));
      id[0] = w.x;
      id[1] = w.y;
      id[2] = w.z;
      id[3] = w.w;
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) id[j] = i + j < end ? ids[o + j] : -1;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      px[j] = Pixel{0.0f, 0.0f, 0.0f, id[j],
                    i + j < end && id[j] >= 0 && id[j] < p.num_cells};
    }
  }
};

constexpr unsigned kFull = 0xffffffffu;

// The floats a kernel's front end takes in shared memory: the decode
// table, then the thresholds padded to a whole float4.
template <typename Src>
__host__ __device__ __forceinline__ int front_end_floats(const CellParams& p) {
  return Src::kUnitFloats + (Src::kBounds ? (bounds_len(p) + 3) & ~3 : 0);
}

// Fills the front end at sh (front_end_floats) and synchronises the block
// (after the caller's own fills); returns what this thread reads.
template <typename Src>
__device__ __forceinline__ FrontEnd fill_front_end(const CellParams& p,
                                                   float* sh) {
  if (Src::kUnitFloats) fill_unit_table(sh);
  float* bounds = sh + Src::kUnitFloats;
  if (Src::kBounds) fill_bounds(p, bounds);
  __syncthreads();
  return FrontEnd{Src::kBounds ? cell_bounds(p, bounds) : CellBounds{}, sh};
}

// ----------------------------------------------------- K1 / K9 / K15 ---
// acc: (B, C + 1) u64 = [count per cell..., fixed-point sum of s].  Shared
// layout: the front end (front_end_floats) | counts (C u32).  Block (x, b)
// takes pixels [x run, (x + 1) run) of image b, run a multiple of kVec *
// kThreads, in warp-uniform steps of 32 x kVec adjacent pixels.
template <typename Src>
__global__ void __launch_bounds__(kThreads)
    cell_counts_s_kernel(Src src, CellParams p, long long run,
                         u64* __restrict__ acc) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int c = p.num_cells;
  unsigned* cnt = reinterpret_cast<unsigned*>(sh + front_end_floats<Src>(p));
  for (int i = threadIdx.x; i < c; i += blockDim.x) cnt[i] = 0u;
  const FrontEnd fe = fill_front_end<Src>(p, sh);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const long long pixels = src.pixels;
  const long long start = blockIdx.x * run;
  const long long end = start + run < pixels ? start + run : pixels;
  u64 s_fx = 0;
  for (long long w0 = start + 32LL * kVec * warp; w0 < end;
       w0 += 32LL * kVec * kWarps) {
    Pixel px[kVec];
    src.load4(b, w0 + kVec * (threadIdx.x & 31), end, p, fe, px);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (!px[j].real) continue;
      // A native 32-bit shared atomic: lanes on one counter cost little
      // (a one-colour batch is no slower than noise), so the adds are not
      // grouped (PERF.md).
      atomicAdd(&cnt[px[j].cell], 1u);
      if (Src::kBounds) s_fx += to_fixed(px[j].s);
    }
  }
  for (int o = 16; o > 0; o >>= 1) s_fx += __shfl_down_sync(kFull, s_fx, o);
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
  if (threadIdx.x == 0 && s_sum) s_sum[b] = from_fixed(row[c]);
}

// ------------------------------------------------- K3 / K4 / K10 / K14 -
// acc: (B, C, 4) u64 = per valid-order slot [hue, s, v, count], the first
// three in fixed point.  How a pixel finds its slot:
enum SlotRule {
  kSlotOfCell,  // K3: slot and hue offset are functions of the cell
  kCandidates,  // K4 / K10: first minimum over the cell's q candidates
  kAllowedBits  // K14: first minimum over the set bits of the cell's row
};

// The sum of x over the warp's 32 lanes, exact for x < 2^37 (two 32-bit
// reductions of a 27-bit split).
__device__ __forceinline__ u64 warp_sum(u64 x) {
  constexpr unsigned kLow = (1u << kSplitBits) - 1u;
  const unsigned lo = __reduce_add_sync(kFull, static_cast<unsigned>(x) & kLow);
  const unsigned hi = __reduce_add_sync(kFull, static_cast<unsigned>(x >> kSplitBits));
  return (static_cast<u64>(hi) << kSplitBits) + lo;
}

// x into the 64-bit sum held as the 32-bit words lo and hi, with 32-bit
// shared-memory atomics (the 64-bit ones are compare-and-swap loops on
// sm_90): the add that wraps lo sees it in the old value it returns and
// carries into hi, so hi * 2^32 + lo is the exact sum in any order.
__device__ __forceinline__ void add64(unsigned* lo, unsigned* hi, u64 x) {
  const unsigned xl = static_cast<unsigned>(x);
  const unsigned old = atomicAdd(lo, xl);
  const unsigned xh = static_cast<unsigned>(x >> 32) + (old + xl < old);
  if (xh) atomicAdd(hi, xh);
}

// The block's sum table, words [w][k] for slot k < C: the hue as its low
// kHueBits bits (words 0 and 1, add64) and the rest (word 2: a hue below
// 2^37 leaves at most 9 bits a pixel, summed in 32 bits for up to
// kMaxRun pixels), s (words 3, 4) and v (words 5, 6) by add64, and the
// count (word 7).  Splitting the hue so keeps its low word's carries as
// rare as those of s and v (a value below 2^28 wraps 2^32 once in ~32
// adds), so a pixel costs five 32-bit atomics and seldom a sixth.
constexpr int kTableWords = 8;
constexpr int kHueBits = 28;
constexpr long long kMaxRun = 1LL << 22;   // 360 * 2^22 < 2^32

__device__ __forceinline__ void add_slot(unsigned* t, int c, int k, u64 h,
                                         u64 s, u64 v, unsigned n) {
  add64(&t[k], &t[c + k], h & ((1ull << kHueBits) - 1ull));
  atomicAdd(&t[2 * c + k], static_cast<unsigned>(h >> kHueBits));
  add64(&t[3 * c + k], &t[4 * c + k], s);
  add64(&t[5 * c + k], &t[6 * c + k], v);
  atomicAdd(&t[7 * c + k], n);
}

__device__ __forceinline__ u64 word_pair(const unsigned* t, int c, int w,
                                         int k) {
  return (static_cast<u64>(t[(w + 1) * c + k]) << 32) + t[w * c + k];
}

// One pixel of each lane of the warp into table t: slot k (-1: none) gets
// the fixed-point values h, s, v and a count.  A warp whose lanes are all
// on one slot sums its values (warp_sum) and adds them once; otherwise
// each lane adds its own.  So a flat region costs one update a warp and
// noise one a pixel.  (Grouping any lanes that share a slot, by a loop
// over the warp's distinct slots, cost more on noise than it saved on
// edges: PERF.md.)
__device__ __forceinline__ void add_pixel(int k, u64 h, u64 s, u64 v,
                                          unsigned* t, int c) {
  const int k0 = __shfl_sync(kFull, k, 0);
  if (__all_sync(kFull, k == k0)) {
    if (k0 < 0) return;
    const u64 gh = warp_sum(h);
    const u64 gs = warp_sum(s);
    const u64 gv = warp_sum(v);
    if ((threadIdx.x & 31) == 0) add_slot(t, c, k0, gh, gs, gv, 32u);
    return;
  }
  if (k >= 0) add_slot(t, c, k, h, s, v, 1u);
}

// Shared layout: the sum table (kTableWords C u32) | front end
// (front_end_floats: the uint8 decode, 256 floats, and the thresholds) |
// values (K3: the hue offset of each cell; else the centre of
// each slot as float4 h, s, v, 0) | cell table.  Block (x, b) takes
// pixels [x run, (x + 1) run) of image b, run a multiple of kVec *
// kThreads and at most kMaxRun.
template <typename Src, int kRule>
__global__ void __launch_bounds__(kThreads)
    palette_sums_kernel(Src src, CellParams p, const int* __restrict__ cell_tab,
                        const float* __restrict__ val_tab, int q,
                        bool tab_in_shared, long long run,
                        u64* __restrict__ acc) {
  constexpr bool kQ1 = kRule == kSlotOfCell;
  extern __shared__ float4 smem4[];
  const int c = p.num_cells;
  const int b = blockIdx.y;
  unsigned* table = reinterpret_cast<unsigned*>(smem4);
  float* front = reinterpret_cast<float*>(table + kTableWords * c);
  float* vals = front + front_end_floats<Src>(p);
  const float4* ctr = reinterpret_cast<const float4*>(vals);
  // The cell table has q entries a cell (K14: q bitmask words).
  int* tab_sh = reinterpret_cast<int*>(vals + (kQ1 ? c : 4 * c));
  const int tab_len = kQ1 ? c : c * q;
  const int* gtab = cell_tab + static_cast<long long>(b) * tab_len;
  const float* gval = val_tab + static_cast<long long>(b) * (kQ1 ? c : 3 * c);

  for (int i = threadIdx.x; i < kTableWords * c; i += blockDim.x) table[i] = 0u;
  const FrontEnd fe = fill_front_end<Src>(p, front);
  if (kQ1) {
    for (int i = threadIdx.x; i < c; i += blockDim.x) vals[i] = gval[i];
  } else {
    // (C, 3) row-major centres -> (C, 4).
    for (int i = threadIdx.x; i < 4 * c; i += blockDim.x) {
      vals[i] = (i & 3) == 3 ? 0.0f : gval[(i >> 2) * 3 + (i & 3)];
    }
  }
  if (tab_in_shared) {
    for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab_sh[i] = gtab[i];
  }
  const int* tab = tab_in_shared ? tab_sh : gtab;
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const long long pixels = src.pixels;
  const long long start = blockIdx.x * run;
  const long long end = start + run < pixels ? start + run : pixels;
  // Warp-uniform steps: the warp's lanes take 32 x kVec adjacent pixels.
  for (long long w0 = start + 32LL * kVec * warp; w0 < end;
       w0 += 32LL * kVec * kWarps) {
    Pixel px[kVec];
    src.load4(b, w0 + kVec * (threadIdx.x & 31), end, p, fe, px);
    // The slots of the lane's kVec pixels first, then the warp's adds: the
    // warp waits for its longest candidate walk once a step, not once a
    // pixel.
    int slot[kVec];
    float off[kVec];
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) {
      const float h = px[jj].h, s = px[jj].s, v = px[jj].v;
      const int cell = px[jj].cell;
      int k = c;
      off[jj] = 0.0f;
      if (px[jj].real) {
        if (kQ1) {
          k = tab[cell];
          off[jj] = vals[cell];
        } else {
          // Distance in the exact float32 op order of
          // photohive_dsp_tpu/ops/quantize.py:364-371; slots are visited
          // in ascending valid order, so the strict < keeps the first
          // minimum, the reference's tie rule.
          float best = INFINITY;
          auto visit = [&](int kk) {
            const float4 m = ctr[kk];
            float hd = fabsf(__fsub_rn(h, m.x));
            hd = hd > 180.0f ? __fsub_rn(360.0f, hd) : hd;
            hd = __fmul_rn(hd, p.inv360);
            const float sd = __fsub_rn(s, m.y);
            const float vd = __fsub_rn(v, m.z);
            const float d = __fadd_rn(
                __fadd_rn(__fmul_rn(hd, hd), __fmul_rn(sd, sd)),
                __fmul_rn(vd, vd));
            if (d < best) {
              best = d;
              k = kk;
            }
          };
          const int* row = tab + static_cast<long long>(cell) * q;
          if (kRule == kCandidates) {
            // Candidates ascend with sentinels (>= C) last.  A cell with
            // one candidate has no tie to break: the first minimum of one
            // finite distance is that candidate.
            // The next candidate is read before this one's distance, so a
            // step waits for one shared-memory load, not two.
            if (q == 1 || row[1] >= c) {
              k = row[0] < c ? row[0] : c;
            } else {
              int kk = row[0];
              for (int j = 1; kk < c; ++j) {
                const int next = j < q ? row[j] : c;
                visit(kk);
                kk = next;
              }
            }
          } else {
            for (int w = 0; w < q; ++w) {
              for (unsigned bits = static_cast<unsigned>(row[w]); bits;
                   bits &= bits - 1u) {
                visit(32 * w + __ffs(static_cast<int>(bits)) - 1);
              }
            }
            // An empty row: slot 0, as the TPU kernel's finite mask gives.
            if (k == c) k = 0;
          }
          off[jj] = k < c ? __fsub_rn(180.0f, ctr[k].x) : 0.0f;
        }
      }
      slot[jj] = k >= 0 && k < c ? k : -1;
    }
#pragma unroll
    for (int jj = 0; jj < kVec; ++jj) {
      const bool add = slot[jj] >= 0;
      add_pixel(slot[jj],
                add ? to_fixed(wrap360(__fadd_rn(px[jj].h, off[jj]))) : 0ull,
                add ? to_fixed(px[jj].s) : 0ull,
                add ? to_fixed(px[jj].v) : 0ull, table, c);
    }
  }
  __syncthreads();

  u64* out = acc + static_cast<long long>(b) * c * 4;
  for (int k = threadIdx.x; k < c; k += blockDim.x) {
    const unsigned n = table[7 * c + k];
    if (!n) continue;
    atomicAdd(&out[4 * k + 0],
              word_pair(table, c, 0, k) +
                  (static_cast<u64>(table[2 * c + k]) << kHueBits));
    atomicAdd(&out[4 * k + 1], word_pair(table, c, 3, k));
    atomicAdd(&out[4 * k + 2], word_pair(table, c, 5, k));
    atomicAdd(&out[4 * k + 3], static_cast<u64>(n));
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

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// sums_out == nullptr (K10, K14) leaves the result in acc (fixed point).
template <typename Src, int kRule>
cudaError_t launch_palette_sums(Src src, int batch, const CellParams& p,
                                const int* cell_tab, const float* val_tab,
                                int q, float* sums_out, u64* acc,
                                cudaStream_t stream) {
  constexpr bool kQ1 = kRule == kSlotOfCell;
  const int c = p.num_cells;
  const size_t base =
      (kTableWords * c + front_end_floats<Src>(p) + (kQ1 ? c : 4 * c)) *
      sizeof(float);
  const size_t tab = (kQ1 ? c : static_cast<size_t>(c) * q) * sizeof(int);
  const bool tab_in_shared = base + tab <= kSharedBudget;
  const size_t bytes = base + (tab_in_shared ? tab : 0);
  auto kernel = palette_sums_kernel<Src, kRule>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(batch) * c * 4 * sizeof(u64),
                        stream);
  if (err != cudaSuccess) return err;
  if (batch > 0 && src.pixels > 0) {
    dim3 grid;
    long long run = 0;
    err = one_wave<kThreads, kVec>(kernel, bytes, batch, src.pixels, kMaxRun,
                                   &grid, &run);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(src, p, cell_tab, val_tab, q,
                                              tab_in_shared, run, acc);
  }
  if (sums_out) palette_sums_finish<<<batch, kThreads, 0, stream>>>(acc, c, sums_out);
  return cudaGetLastError();
}

// counts == nullptr (K9) leaves the result in acc (fixed point); s_sum ==
// nullptr (K15) writes the counts alone.
template <typename Src>
cudaError_t launch_cell_counts_s(Src src, int batch, const CellParams& p,
                                 int* counts, float* s_sum, u64* acc,
                                 cudaStream_t stream) {
  const int c = p.num_cells;
  const size_t bytes = (front_end_floats<Src>(p) + c) * sizeof(float);
  auto kernel = cell_counts_s_kernel<Src>;
  cudaError_t err = allow_shared(kernel, bytes);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(acc, 0, static_cast<size_t>(batch) * (c + 1) * sizeof(u64),
                        stream);
  if (err != cudaSuccess) return err;
  if (batch > 0 && src.pixels > 0) {
    dim3 grid;
    long long run = 0;
    // A block's counts are 32-bit: at most 2^32 - 1 pixels a run.
    err = one_wave<kThreads, kVec>(kernel, bytes, batch, src.pixels,
                                   1LL << 31, &grid, &run);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(src, p, run, acc);
  }
  if (counts) {
    cell_counts_s_finish<<<batch, kThreads, 0, stream>>>(acc, c, counts, s_sum);
  }
  return cudaGetLastError();
}

bool aligned(const void* ptr, size_t bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

template <typename T>
RgbPixels<T> rgb_pixels(const void* rgb, long long pixels) {
  return RgbPixels<T>{static_cast<const T*>(rgb), pixels,
                      pixels % kVec == 0 && aligned(rgb, kVec * sizeof(T))};
}

HsvPixels hsv_pixels(const void* h, const void* s, const void* v,
                     long long pixels) {
  const bool vec = pixels % kVec == 0 && aligned(h, 16) && aligned(s, 16) &&
                   aligned(v, 16);
  return HsvPixels{static_cast<const float*>(h), static_cast<const float*>(s),
                   static_cast<const float*>(v), pixels, vec};
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
  return is_u8 ? launch_palette_sums<RgbPixels<uint8_t>, kSlotOfCell>(
                     rgb_pixels<uint8_t>(rgb, pixels), batch, *p, tab, off, 1,
                     out, a, st)
               : launch_palette_sums<RgbPixels<float>, kSlotOfCell>(
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
  return is_u8 ? launch_palette_sums<RgbPixels<uint8_t>, kCandidates>(
                     rgb_pixels<uint8_t>(rgb, pixels), batch, *p, tab, ctr, q,
                     out, a, st)
               : launch_palette_sums<RgbPixels<float>, kCandidates>(
                     rgb_pixels<float>(rgb, pixels), batch, *p, tab, ctr, q,
                     out, a, st);
}

// acc: (B, C, 4) u64.
extern "C" int ph_palette_sums_hsv(const void* h, const void* s, const void* v,
                                   int batch, long long pixels,
                                   const CellParams* p, const void* cand, int q,
                                   const void* centers_by_k, void* acc,
                                   void* stream) {
  return launch_palette_sums<HsvPixels, kCandidates>(
      hsv_pixels(h, s, v, pixels), batch, *p, static_cast<const int*>(cand),
      static_cast<const float*>(centers_by_k), q, nullptr,
      static_cast<u64*>(acc), static_cast<cudaStream_t>(stream));
}

// K14: allowed: (B, C, words) int32, bit k of word k / 32 of row cell set
// when slot k is an allowed parent of the cell.  acc: (B, C, 4) u64.
extern "C" int ph_palette_sums_cwide(const void* h, const void* s,
                                     const void* v, int batch,
                                     long long pixels, const CellParams* p,
                                     const void* allowed, int words,
                                     const void* centers_by_k, void* acc,
                                     void* stream) {
  return launch_palette_sums<HsvPixels, kAllowedBits>(
      hsv_pixels(h, s, v, pixels), batch, *p, static_cast<const int*>(allowed),
      static_cast<const float*>(centers_by_k), words, nullptr,
      static_cast<u64*>(acc), static_cast<cudaStream_t>(stream));
}

// K15: cells: (B, pixels) int32; counts: (B, C) int32; acc: (B, C + 1) u64
// scratch.
extern "C" int ph_cell_counts_ids(const void* cells, int batch,
                                  long long pixels, int num_cells,
                                  void* counts, void* acc, void* stream) {
  CellParams p{};
  p.num_cells = num_cells;
  return launch_cell_counts_s(
      CellIdPixels{static_cast<const int*>(cells), pixels,
                   pixels % kVec == 0 && aligned(cells, 16)},
      batch, p,
      static_cast<int*>(counts), nullptr, static_cast<u64*>(acc),
      static_cast<cudaStream_t>(stream));
}
