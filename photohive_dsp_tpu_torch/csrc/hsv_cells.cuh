// Shared per-pixel front end of the palette kernels: planar u8 or f32 RGB
// -> HSV -> octree cell id.
//
// Every palette kernel derives its cell ids through hsv_cell(): the RGB
// kernels (cell_counts_s, palette_sums q=1, palette_sums q>1) by way of
// pixel_hsv_cell(), the flat-HSV ones (cell_counts_hsv, palette_sums_hsv)
// directly, so a pixel on a cell boundary can never land in one cell for
// the counts and another for the sums.  The arithmetic is
// op-for-op the JAX package's _hsv_rows / _cell_ids_row
// (photohive_dsp_tpu/ops/pallas_kernels.py:685-711, :478-501) and the XLA
// colorspace.rgb_to_hsv / quantize.assign_cells: IEEE division and
// round-to-nearest adds and multiplies, spelled with __f*_rn so no FMA
// contraction can change a bit (the library is also built --fmad=false).
// u8 decodes as __fdiv_rn(x, 255): correctly rounded, hence equal to the
// JAX package's division-free u8_to_unit_f32.
#pragma once

#include <stdint.h>

// Mirror of ops/_cuda.CellParams (same field order).
struct CellParams {
  float black_thresh, gray_thresh;
  float cell_lv, cell_ls, cell_lh;
  float v_clip, s_clip, h_clip;  // partitions - 1e-6, as float32
  float max_sv;                  // 0.999999, the reference's S and V clamp
  float inv360;                  // float32(1/360), the tie-break hue scale
  int s_partitions, v_partitions, gray_start, black_id, num_cells;
};

__device__ __forceinline__ float unit_value(float x) { return x; }
__device__ __forceinline__ float unit_value(uint8_t x) {
  return __fdiv_rn(static_cast<float>(x), 255.0f);
}

// jnp.clip(x, 0, hi).astype(int32): max, then min, then truncation.
__device__ __forceinline__ int clip_index(float x, float hi) {
  return static_cast<int>(fminf(fmaxf(x, 0.0f), hi));
}

// Octree cell of one HSV pixel (quantize.assign_cells).
__device__ __forceinline__ int hsv_cell(float h, float s, float v,
                                        const CellParams& p) {
  const int vi = clip_index(
      __fdiv_rn(__fsub_rn(v, p.black_thresh), p.cell_lv), p.v_clip);
  const int si = clip_index(
      __fdiv_rn(__fsub_rn(s, p.gray_thresh), p.cell_ls), p.s_clip);
  const int hi = clip_index(__fdiv_rn(h, p.cell_lh), p.h_clip);
  const int color_id = (hi * p.s_partitions + si) * p.v_partitions + vi;
  // The reference's premature int cast sends every gray pixel to the
  // first gray cell (src/color_quantization.c:136).
  return v < p.black_thresh ? p.black_id
                            : (s < p.gray_thresh ? p.gray_start : color_id);
}

template <typename T>
__device__ __forceinline__ void pixel_hsv_cell(const T* img, long long plane,
                                               long long i,
                                               const CellParams& p, float& h,
                                               float& s, float& v,
                                               int& cell) {
  const float r = unit_value(img[i]);
  const float g = unit_value(img[plane + i]);
  const float b = unit_value(img[2 * plane + i]);
  const float mx = fmaxf(fmaxf(r, g), b);
  const float mn = fminf(fminf(r, g), b);
  const float delta = __fsub_rn(mx, mn);
  const float safe = delta == 0.0f ? 1.0f : delta;
  // Branch order on ties: delta==0, then max==r, then max==g, else b.
  float hh;
  if (delta == 0.0f) {
    hh = 0.0f;
  } else if (mx == r) {
    hh = __fmul_rn(60.0f, __fdiv_rn(__fsub_rn(g, b), safe));
  } else if (mx == g) {
    hh = __fmul_rn(60.0f, __fadd_rn(2.0f, __fdiv_rn(__fsub_rn(b, r), safe)));
  } else {
    hh = __fmul_rn(60.0f, __fadd_rn(4.0f, __fdiv_rn(__fsub_rn(r, g), safe)));
  }
  if (hh < 0.0f) hh = __fadd_rn(hh, 360.0f);
  if (hh > 360.0f) hh = __fsub_rn(hh, 360.0f);
  h = hh;
  v = mx == 1.0f ? p.max_sv : mx;
  s = mx == 0.0f ? 0.0f : (delta == mx ? p.max_sv : __fdiv_rn(delta, mx));
  cell = hsv_cell(h, s, v, p);
}
