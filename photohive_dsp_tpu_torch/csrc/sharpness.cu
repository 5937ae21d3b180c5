// K5: crop-box sharpness sums.  For each image and each of its 10 box
// slots [top, bottom, left, right):
//   s1 = sum over the box of pgm * (9 - rows_in * cols_in), the telescoped
//        ring weights of the crop's zero-padded Laplacian (0 inside, so only
//        the 1-px border ring counts; ops/sharpness._ring_weight_map);
//   s2 = sum over the box of the squared zero-padded 3x3 Laplacian of the
//        masked crop (a neighbour outside the box counts as 0).
// The caller finishes with mean = s1/n, var = s2/n - mean^2, var/mean.
//
// Replaces photohive_dsp_tpu/ops/pallas_sharpness.py sharpness_sums
// (_sharp_kernel).  The TPU kernel walks a sequential grid of 8-row tiles,
// reads three overlapping 8-row blocks for its halo, evaluates all 10 boxes
// over the full width with masks and carries (8, 128) accumulators from
// step to step.
//
// What bounds it on an H100: bytes, at the bound; in practice the float32
// instructions and one warp's walk down its rows.  The function has to read
// the luma in and around the boxes once, at most B*H*W*4 bytes (8.3 MB per
// 1080x1920 frame, 2.5 us at 3.35 TB/s); it does about 16 float32
// operations per pixel of box area.
//
// Design: one launch, work only under the boxes.  A box's pixels on the
// rows handed in split into items of 128 columns (strips start at the box's
// first column, rounded down to a multiple of 4 where rows are 16-byte
// aligned) by `seg` rows; tests/test_torch_sharpness_schedule.py mirrors
// the split.  A persistent grid of warps walks the items of all boxes of all
// images: each block first copies the boxes to shared memory, picks seg so
// that the items about match the grid's warps (the boxes' strip-rows over
// the warps, within [kMinSegRows, kMaxSegRows]) and lays the boxes' item
// counts out as a prefix (block 0 also writes the zero sums of boxes with
// no item); then each warp takes items in grid stride and finds an item's
// box by bisection.  In an item, lane l holds columns 4l..4l+3 of the strip
// and walks down its rows as a vertical sliding window: it reads each row
// once (one 16-byte load, or four scalar loads where rows are not 16-byte
// aligned: width 1001), kAhead rows ahead, gets the columns just left and
// right of its four from its neighbour lanes (__shfl; lanes 0 and 31 read
// the strip's edge columns themselves) and keeps the row triples of three
// rows in registers.  Pixels outside the image read 0, the reference's zero
// padding; the rows just above and below the rows handed in come from an
// optional halo (the neighbouring ranks' edge rows in the row-sharded
// report).  Each pixel's stencil keeps the TPU kernel's float32 operation
// order: row triples (l + c) + r, then (up + mid) + down, then 9x - box,
// with the box's edges as masks.  Most pixels need no mask: a strip whose
// columns and their neighbours all lie in the box runs without column
// masks, and a row whose neighbours both lie in the box without row masks
// (the same operations, with the masks' values known).
//
// Sums: a lane adds each of its columns' pixels in float32 (at most
// kMaxSegRows a column), adds its 4 columns in float64, and the warp adds
// its lanes in a fixed shuffle order into the item's float64 partial.  The
// warp then takes a ticket of its box (a releasing atom.inc, which wraps to
// 0 on the box's last item, so the tickets are zero again after every
// launch); the warp that takes the last ticket adds the box's partials in
// item order, its loads 8 a lane at a time.
// No float atomics, so the result is the same from launch to launch.  Box
// coordinates are global rows: row_offset shifts the local rows, so a box
// that spans ranks splits exactly into per-rank sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxes = 10;
constexpr int kLanes = 32;
constexpr int kVec = 4;                        // columns a lane
constexpr int kStripCols = kLanes * kVec;      // mirrored in
constexpr int kMinSegRows = 8;                 // ops/sharpness_kernels.py
constexpr int kMaxSegRows = 64;
constexpr int kWarps = 4;                      // warps a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kAhead = 4;                      // rows loaded ahead
constexpr int kCombine = 8;                    // partials a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

// A box's part on the rows handed in: local rows [y0, y1), columns
// [x0, x1), strips of kStripCols columns from xs; all zero where the box
// misses these rows.
struct Span {
  int y0, y1, x0, x1, xs, strips;
  __device__ int rows() const { return y1 - y0; }
  __device__ int items(int seg) const {
    return strips * ((rows() + seg - 1) / seg);
  }
};

__device__ Span box_span(const int* bx, int height, int width, int row_offset,
                         bool vec_rows) {
  Span sp{};
  const int y0 = max(bx[0] - row_offset, 0);
  const int y1 = min(bx[1] - row_offset, height);
  const int x0 = max(bx[2], 0);
  const int x1 = min(bx[3], width);
  if (y0 >= y1 || x0 >= x1) return sp;
  sp.y0 = y0;
  sp.y1 = y1;
  sp.x0 = x0;
  sp.x1 = x1;
  sp.xs = vec_rows ? (x0 & ~(kVec - 1)) : x0;
  sp.strips = (x1 - sp.xs + kStripCols - 1) / kStripCols;
  return sp;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  return x;
}

// One row of a lane's window: its four values and the columns just left
// and right of them.
struct Row {
  float4 v;
  float left, right;
};

__device__ __forceinline__ float at(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The row triples (l + c) + r of a lane's four columns, a neighbour outside
// the box (lf/rt false) counting as 0; with kMasks false every neighbour is
// in the box.  Every lane of the warp calls it.
template <bool kMasks>
__device__ __forceinline__ float4 triples(const Row& row, int lane,
                                          const bool (&lf)[kVec],
                                          const bool (&rt)[kVec]) {
  float lv = __shfl_up_sync(kFull, row.v.w, 1);
  float rv = __shfl_down_sync(kFull, row.v.x, 1);
  if (lane == 0) lv = row.left;
  if (lane == kLanes - 1) rv = row.right;
  const float x[kVec + 2] = {lv, row.v.x, row.v.y, row.v.z, row.v.w, rv};
  float t[kVec];
#pragma unroll
  for (int c = 0; c < kVec; ++c) {
    t[c] = __fadd_rn(__fadd_rn(!kMasks || lf[c] ? x[c] : 0.0f, x[c + 1]),
                     !kMasks || rt[c] ? x[c + 2] : 0.0f);
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

// What a lane needs to walk an item: its image, its columns and masks.
struct Lane {
  const float* img;
  const float* hal;       // the image's halo rows, or null
  int height, width, xc;  // xc: the lane's first column
  bool own, need_l, need_r;
  bool in[kVec], lf[kVec], rt[kVec];
  float cols_in[kVec];
  float w_in[kVec];       // 9 - 3 * cols_in: the weight where rows_in = 3
};

// Row y of the lane's columns, predicated rather than branched; a row
// outside the image and its halo reads as zeros.  An owning lane's first
// column is inside the image (xc < x1 <= width).
template <bool kVecRows>
__device__ __forceinline__ Row load_row(const Lane& ln, int y) {
  Row row{make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0.0f, 0.0f};
  const float* rp =
      y >= 0 && y < ln.height ? ln.img + static_cast<long long>(y) * ln.width
      : ln.hal == nullptr     ? nullptr
      : y == -1               ? ln.hal
      : y == ln.height        ? ln.hal + ln.width
                              : nullptr;
  if (rp != nullptr) {
    const int xc = ln.xc;
    if (kVecRows) {
      if (ln.own) row.v = __ldg(reinterpret_cast<const float4*>(rp + xc));
    } else {
      if (ln.own) row.v.x = __ldg(rp + xc);
      if (ln.own && xc + 1 < ln.width) row.v.y = __ldg(rp + xc + 1);
      if (ln.own && xc + 2 < ln.width) row.v.z = __ldg(rp + xc + 2);
      if (ln.own && xc + 3 < ln.width) row.v.w = __ldg(rp + xc + 3);
    }
    if (ln.need_l) row.left = __ldg(rp + xc - 1);
    if (ln.need_r) row.right = __ldg(rp + xc + kVec);
  }
  return row;
}

// Rows [r0, r1) of an item: a1, a2 += each pixel's s1 and s2 terms.  kMasks
// false: the strip's columns and their neighbours all lie in the box.  The
// window streams rows r0 - 1 .. r1 in batches of kAhead loads; row y - 1
// is done once row y is in.  Rows r0 - 1 and r1 are read only where the
// box goes on past the item's rows.
template <bool kVecRows, bool kMasks>
__device__ __forceinline__ void walk(const Lane& ln, int lane, int r0, int r1,
                                     int row_offset, int top, int bottom,
                                     float (&a1)[kVec], float (&a2)[kVec]) {
  const bool above = row_offset + r0 - 1 >= top;
  const int last = row_offset + r1 < bottom ? r1 : r1 - 1;
  float4 t_up = make_float4(0.0f, 0.0f, 0.0f, 0.0f), t_mid = t_up, mid = t_up;
  for (int base = r0 - 1; base <= r1; base += kAhead) {
    Row next[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int y = base + u;
      next[u] = y <= last && (y >= r0 || above) ? load_row<kVecRows>(ln, y)
                                                 : Row{};
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int y = base + u;
      if (y > r1) break;
      const float4 t_dn = triples<kMasks>(next[u], lane, ln.lf, ln.rt);
      const int gy = row_offset + y - 1;   // the row done: y - 1
      const bool up = gy - 1 >= top;
      const bool dn = gy + 1 < bottom;
      if (y < r0 + 1) {
        // the window fills: rows r0 - 1 and r0
      } else if (up && dn) {
        // rows_in = 3: no row masks, the weight w_in.
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float xv = at(mid, c);
          const float box3 = __fadd_rn(__fadd_rn(at(t_up, c), at(t_mid, c)),
                                       at(t_dn, c));
          const float resp = __fsub_rn(__fmul_rn(9.0f, xv), box3);
          const float sq = __fadd_rn(a2[c], __fmul_rn(resp, resp));
          const float wx = __fadd_rn(a1[c], __fmul_rn(xv, ln.w_in[c]));
          a2[c] = !kMasks || ln.in[c] ? sq : a2[c];
          a1[c] = !kMasks || ln.in[c] ? wx : a1[c];
        }
      } else {
        const float rows_in = __fadd_rn(__fadd_rn(up ? 1.0f : 0.0f, 1.0f),
                                        dn ? 1.0f : 0.0f);
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          const float xv = at(mid, c);
          const float box3 = __fadd_rn(
              __fadd_rn(up ? at(t_up, c) : 0.0f, at(t_mid, c)),
              dn ? at(t_dn, c) : 0.0f);
          const float resp = __fsub_rn(__fmul_rn(9.0f, xv), box3);
          const float wgt =
              __fsub_rn(9.0f, __fmul_rn(rows_in, ln.cols_in[c]));
          const float sq = __fadd_rn(a2[c], __fmul_rn(resp, resp));
          const float wx = __fadd_rn(a1[c], __fmul_rn(xv, wgt));
          a2[c] = !kMasks || ln.in[c] ? sq : a2[c];
          a1[c] = !kMasks || ln.in[c] ? wx : a1[c];
        }
      }
      t_up = t_mid;
      t_mid = t_dn;
      mid = next[u].v;
    }
  }
}

// pgm: (B, H, W); halo: (B, 2, W) or null; boxes: (B, 10, 4);
// partial: a float64 pair per item; tickets: B*10, zero between launches;
// sums: (B, 10, 2).  Dynamic shared memory: the boxes (B*10*4 ints) and the
// item prefix (B*10 + 1 ints).  kVecRows: the rows are 16-byte aligned
// (width a multiple of 4).
template <bool kVecRows>
__global__ void __launch_bounds__(kThreads)
sharpness_kernel(const float* __restrict__ pgm, const float* __restrict__ halo,
                 int batch, int height, int width, int row_offset,
                 const int* __restrict__ boxes, double2* __restrict__ partial,
                 unsigned* __restrict__ tickets, double* __restrict__ sums) {
  extern __shared__ int box[];   // (nb, 4), then pre
  __shared__ int seg_rows;
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int nb = batch * kBoxes;
  int* pre = box + 4 * nb;       // pre[s]: the first item of box slot s
  for (int e = threadIdx.x; e < 4 * nb; e += kThreads) box[e] = boxes[e];
  __syncthreads();
  if (warp == 0) {
    // seg: the boxes' strip-rows over the grid's warps, within bounds.
    long long strip_rows = 0;
    for (int s = lane; s < nb; s += kLanes) {
      const Span sp = box_span(box + 4 * s, height, width, row_offset,
                               kVecRows);
      strip_rows += static_cast<long long>(sp.strips) * sp.rows();
    }
    for (int o = 16; o > 0; o >>= 1) {
      strip_rows += __shfl_xor_sync(kFull, strip_rows, o);
    }
    const long long warps = static_cast<long long>(gridDim.x) * kWarps;
    const int seg = static_cast<int>(
        min(max((strip_rows + warps - 1) / warps,
                static_cast<long long>(kMinSegRows)),
            static_cast<long long>(kMaxSegRows)));
    int carry = 0;
    for (int base = 0; base < nb; base += kLanes) {
      const int s = base + lane;
      const int n = s < nb ? box_span(box + 4 * s, height, width, row_offset,
                                      kVecRows).items(seg)
                           : 0;
      if (blockIdx.x == 0 && s < nb && n == 0) {
        sums[2LL * s] = 0.0;
        sums[2LL * s + 1] = 0.0;
      }
      int incl = n;
      for (int o = 1; o < kLanes; o <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      if (s < nb) pre[s + 1] = carry + incl;
      carry += __shfl_sync(kFull, incl, kLanes - 1);
    }
    if (lane == 0) {
      pre[0] = 0;
      seg_rows = seg;
    }
  }
  __syncthreads();
  const int total = pre[nb];
  const int seg = seg_rows;

  for (int item = blockIdx.x * kWarps + warp; item < total;
       item += gridDim.x * kWarps) {
    int lo = 0, hi = nb;   // pre[lo] <= item < pre[hi]
    while (hi - lo > 1) {
      const int m = (lo + hi) >> 1;
      if (pre[m] <= item) lo = m; else hi = m;
    }
    const int s = lo;
    const int* bx = box + 4 * s;
    const int top = bx[0], bottom = bx[1], left = bx[2], right = bx[3];
    const Span sp = box_span(bx, height, width, row_offset, kVecRows);
    const int j = item - pre[s];
    const int r0 = sp.y0 + (j / sp.strips) * seg;
    const int r1 = min(r0 + seg, sp.y1);
    const int first = sp.xs + (j % sp.strips) * kStripCols;
    const int b = s / kBoxes;

    Lane ln;
    ln.img = pgm + static_cast<long long>(b) * height * width;
    ln.hal = halo ? halo + 2LL * b * width : nullptr;
    ln.height = height;
    ln.width = width;
    ln.xc = first + kVec * lane;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      const int x = ln.xc + c;
      ln.in[c] = x >= sp.x0 && x < sp.x1;
      ln.lf[c] = x - 1 >= left;
      ln.rt[c] = x + 1 < right;
      ln.cols_in[c] = __fadd_rn(__fadd_rn(ln.lf[c] ? 1.0f : 0.0f, 1.0f),
                                ln.rt[c] ? 1.0f : 0.0f);
      ln.w_in[c] = __fsub_rn(9.0f, __fmul_rn(3.0f, ln.cols_in[c]));
    }
    // Which loads this lane makes: its own columns if any is in the box,
    // the strip's edge columns (lanes 0 and 31) if the stencil needs them.
    ln.own = ln.xc < sp.x1 && ln.xc + kVec > sp.x0;
    ln.need_l = lane == 0 && ln.xc - 1 >= left && ln.xc - 1 >= 0;
    ln.need_r = lane == kLanes - 1 && ln.xc + kVec < right &&
                ln.xc + kVec < width;
    // No column masks where every column of the strip is in the box and so
    // are its neighbours (a neighbour past the image reads 0 either way).
    const bool unmasked = first - 1 >= left && first + kStripCols <= sp.x1 &&
                          first + kStripCols < right;

    float a1[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    float a2[kVec] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (unmasked) {
      walk<kVecRows, false>(ln, lane, r0, r1, row_offset, top, bottom, a1, a2);
    } else {
      walk<kVecRows, true>(ln, lane, r0, r1, row_offset, top, bottom, a1, a2);
    }

    double d1 = 0.0, d2 = 0.0;
#pragma unroll
    for (int c = 0; c < kVec; ++c) {
      d1 += static_cast<double>(a1[c]);
      d2 += static_cast<double>(a2[c]);
    }
    d1 = warp_sum(d1);
    d2 = warp_sum(d2);
    unsigned ticket = 0;
    const int n = sp.items(seg);
    if (lane == 0) {
      // The ticket releases the partial: the warp that takes the last one
      // sees every partial of the box.
      partial[item] = make_double2(d1, d2);
      asm volatile("atom.release.gpu.global.inc.u32 %0, [%1], %2;"
                   : "=r"(ticket)
                   : "l"(tickets + s), "r"(static_cast<unsigned>(n - 1))
                   : "memory");
    }
    ticket = __shfl_sync(kFull, ticket, 0);
    if (ticket == static_cast<unsigned>(n - 1)) {
      // The box's last item: lane 0's fence after its ticket, then the
      // warp's barrier, order every lane's reads after the box's partials.
      __threadfence();
      __syncwarp();
      // Lane l adds items l, l + 32, ... in order; the loads go out 8 at a
      // time (an absent item adds +0, which changes no sum).
      const double2* part = partial + pre[s];
      double s1 = 0.0, s2 = 0.0;
      for (int k0 = lane; k0 < n; k0 += kCombine * kLanes) {
        double2 p[kCombine];
#pragma unroll
        for (int q = 0; q < kCombine; ++q) {
          const int k = k0 + q * kLanes;
          p[q] = k < n ? __ldcg(part + k) : make_double2(0.0, 0.0);
        }
#pragma unroll
        for (int q = 0; q < kCombine; ++q) {
          s1 += p[q].x;
          s2 += p[q].y;
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        sums[2LL * s] = s1;
        sums[2LL * s + 1] = s2;
      }
    }
  }
}

template <bool kVecRows>
cudaError_t launch(const float* pgm, const float* halo, int batch, int height,
                   int width, int row_offset, const int* boxes,
                   long long items, double2* partial, unsigned* tickets,
                   double* sums, cudaStream_t stream) {
  const size_t bytes =
      (static_cast<size_t>(batch) * kBoxes * 5 + 1) * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(sharpness_kernel<kVecRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sharpness_kernel<kVecRows>, kThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  // One wave of blocks, fewer where the items cannot fill it.
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long needed = (items + kWarps - 1) / kWarps;
  if (needed < blocks) blocks = needed > 0 ? needed : 1;
  sharpness_kernel<kVecRows>
      <<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
          pgm, halo, batch, height, width, row_offset, boxes, partial,
          tickets, sums);
  return cudaGetLastError();
}

}  // namespace

// pgm: (batch, height, width) float32; halo: (batch, 2, width) float32, the
// rows just above and below, or nullptr for zeros; boxes: (batch, 10, 4)
// int32 in global rows (local row y is global row row_offset + y), empty
// slots all zero; vec: rows (and the halo's) 16-byte aligned; partial: a
// float64 pair for each of at most `items` items
// (ops/sharpness_kernels.max_items); tickets: batch * 10 uint32, zero (and
// zero again after the launch); sums: (batch, 10, 2) float64 [s1, s2].
// Returns the cudaError_t of the launch.
extern "C" int ph_sharpness_sums(const void* pgm, const void* halo, int batch,
                                 int height, int width, int row_offset,
                                 const void* boxes, int vec, long long items,
                                 void* partial, void* tickets, void* sums,
                                 void* stream) {
  auto run = vec ? launch<true> : launch<false>;
  return run(static_cast<const float*>(pgm), static_cast<const float*>(halo),
             batch, height, width, row_offset, static_cast<const int*>(boxes),
             items, static_cast<double2*>(partial),
             static_cast<unsigned*>(tickets), static_cast<double*>(sums),
             static_cast<cudaStream_t>(stream));
}
