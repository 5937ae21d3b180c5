// Shared per-pixel front end of the palette kernels: planar u8 or f32 RGB
// -> HSV -> octree cell id.
//
// Every palette kernel derives its cell ids through hsv_cell(): the RGB
// kernels (cell_counts_s, palette_sums q=1, palette_sums q>1) by way of
// rgb_hsv_cell(), the flat-HSV ones (cell_counts_hsv, palette_sums_hsv)
// directly, so a pixel on a cell boundary can never land in one cell for
// the counts and another for the sums.  The HSV arithmetic is op-for-op the
// JAX package's _hsv_rows (photohive_dsp_tpu/ops/pallas_kernels.py:685-711)
// and the XLA colorspace.rgb_to_hsv: IEEE division and round-to-nearest
// adds and multiplies, spelled with __f*_rn so no FMA contraction can change
// a bit (the library is also built --fmad=false).  The hue takes one
// division whichever channel is the maximum: the three branches of the
// reference differ only in which difference they divide and which offset
// they add, so both are selected first.  u8 decodes as __fdiv_rn(x, 255):
// correctly rounded, hence equal to the JAX package's division-free
// u8_to_unit_f32; the kernels read it from a table in shared memory filled
// with those divisions (fill_unit_table).
//
// The cell id (quantize.assign_cells, pallas_kernels.py:478-501) takes
// three indices, each trunc(clip(RN(RN(x - base) * RN(1 / L)), 0, clip)):
// the cell id is XLA's x * f32(1/L), like div_const (ops/stats.py), as
// the JAX package computes it under jax.jit.  Each index is a function of
// one float32 that never decreases as x grows.  So it equals the number
// of thresholds t_1 <= ... <= t_top that x reaches, t_k the least float32
// whose index is k or more (computed on the host from the same float32
// operations: ops/palette_kernels.index_bounds).  An index of at most
// kRegBounds (v and s at the usual grids) is counted against thresholds
// held in registers; a larger one (the hue) is guessed by bin_index()
// from that multiply rounded to the nearest integer, which is within one
// of it, and the guess corrected by the two thresholds around it, read
// from shared memory.  No division and no float-to-int conversion, which
// share the SM's slow pipe with the HSV divisions, and few shared-memory
// reads, which the palette-sums kernel's candidate walks need.
#pragma once

#include <stdint.h>

// Mirror of ops/_cuda.CellParams (same field order).
struct CellParams {
  float black_thresh, gray_thresh;
  float inv_lv, inv_ls, inv_lh;  // RN(1 / float32(cell_L*)): the index guess
  float max_sv;                  // 0.999999, the reference's S and V clamp
  float inv360;                  // float32(1/360), the tie-break hue scale
  int v_top, s_top, h_top;       // trunc(partitions - 1e-6): largest index
  int s_partitions, v_partitions, gray_start, black_id, num_cells;
  // Device array of the thresholds, [v | s | h], top + 2 floats each:
  // -inf, t_1, ..., t_top, NaN (no float reaches NaN).
  const float* bounds;
};

// Floats of CellParams::bounds.
__host__ __device__ __forceinline__ int bounds_len(const CellParams& p) {
  return p.v_top + p.s_top + p.h_top + 6;
}

// The thresholds into shared memory (bounds_len floats).
__device__ __forceinline__ void fill_bounds(const CellParams& p, float* sh) {
  for (int i = threadIdx.x; i < bounds_len(p); i += blockDim.x) {
    sh[i] = p.bounds[i];
  }
}

// unit[x] = x / 255, correctly rounded, for every uint8 x.
__device__ __forceinline__ void fill_unit_table(float* unit) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unit[i] = __fdiv_rn(static_cast<float>(i), 255.0f);
  }
}

// The thresholds a thread finds cell ids with: v's and s's first
// kRegBounds in registers (NaN past the top: no float reaches NaN), and
// all three sets in shared memory (fill_bounds).
constexpr int kRegBounds = 3;
struct CellBounds {
  float v[kRegBounds], s[kRegBounds];
  const float* tv;
  const float* ts;
  const float* th;
};

// After fill_bounds and a barrier: the thresholds at sh.
__device__ __forceinline__ CellBounds cell_bounds(const CellParams& p,
                                                  const float* sh) {
  CellBounds b;
  b.tv = sh;
  b.ts = b.tv + p.v_top + 2;
  b.th = b.ts + p.s_top + 2;
  const float nan = __int_as_float(0x7fffffff);
#pragma unroll
  for (int i = 0; i < kRegBounds; ++i) {
    b.v[i] = i < p.v_top ? b.tv[i + 1] : nan;
    b.s[i] = i < p.s_top ? b.ts[i + 1] : nan;
  }
  return b;
}

// trunc(clip(RN(RN(x - base) * inv), 0, clip)) as the count of t[1..top]
// that x reaches; t = [-inf, t_1, ..., t_top, NaN].  The guess rounds
// (x - base) * inv to an integer in [0, top] (the 2^23 add), which is
// within one of the index, and the two thresholds around it correct it; a
// NaN x gives 0, as fmaxf does in the clip.
__device__ __forceinline__ int bin_index(float x, float base, float inv,
                                         int top, const float* t) {
  float q = __fmul_rn(__fsub_rn(x, base), inv);
  q = fminf(fmaxf(q, 0.0f), static_cast<float>(top));
  const int k = __float_as_int(__fadd_rn(q, 8388608.0f)) - 0x4B000000;
  return k + (x >= t[k + 1] ? 1 : 0) - (x < t[k] ? 1 : 0);
}

// The count of the thresholds r (NaN-padded) that x reaches.
__device__ __forceinline__ int reg_index(float x,
                                         const float (&r)[kRegBounds]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < kRegBounds; ++i) k += x >= r[i] ? 1 : 0;
  return k;
}

// Octree cell of one HSV pixel (quantize.assign_cells).  (Choosing the
// register or the guessed index once a block, by a template of the pixel
// loop, was no faster: PERF.md.)
__device__ __forceinline__ int hsv_cell(float h, float s, float v,
                                        const CellParams& p,
                                        const CellBounds& b) {
  const int vi = p.v_top <= kRegBounds
                     ? reg_index(v, b.v)
                     : bin_index(v, p.black_thresh, p.inv_lv, p.v_top, b.tv);
  const int si = p.s_top <= kRegBounds
                     ? reg_index(s, b.s)
                     : bin_index(s, p.gray_thresh, p.inv_ls, p.s_top, b.ts);
  const int hi = bin_index(h, 0.0f, p.inv_lh, p.h_top, b.th);
  const int color_id = (hi * p.s_partitions + si) * p.v_partitions + vi;
  // The reference's premature int cast sends every gray pixel to the
  // first gray cell (src/color_quantization.c:136).
  return v < p.black_thresh ? p.black_id
                            : (s < p.gray_thresh ? p.gray_start : color_id);
}

// HSV and octree cell of one pixel of unit RGB (colorspace.rgb_to_hsv).
__device__ __forceinline__ void rgb_hsv_cell(float r, float g, float b,
                                             const CellParams& p,
                                             const CellBounds& bounds,
                                             float& h,
                                             float& s, float& v, int& cell) {
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float delta = __fsub_rn(mx, mn);
  const float safe = delta == 0.0f ? 1.0f : delta;
  // Branch order on ties: delta==0, then max==r, then max==g, else b:
  // 60 (g - b) / d, 60 (2 + (b - r) / d), 60 (4 + (r - g) / d).
  const bool is_r = mx == r;
  const bool is_g = !is_r && mx == g;
  const float num = is_r ? __fsub_rn(g, b)
                         : (is_g ? __fsub_rn(b, r) : __fsub_rn(r, g));
  const float q = __fdiv_rn(num, safe);
  float hh = __fmul_rn(60.0f, is_r ? q : __fadd_rn(is_g ? 2.0f : 4.0f, q));
  if (delta == 0.0f) hh = 0.0f;
  if (hh < 0.0f) hh = __fadd_rn(hh, 360.0f);
  if (hh > 360.0f) hh = __fsub_rn(hh, 360.0f);
  h = hh;
  v = mx == 1.0f ? p.max_sv : mx;
  const float sq = __fdiv_rn(delta, mx == 0.0f ? 1.0f : mx);
  s = mx == 0.0f ? 0.0f : (delta == mx ? p.max_sv : sq);
  cell = hsv_cell(h, s, v, p, bounds);
}
