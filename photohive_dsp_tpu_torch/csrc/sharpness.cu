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
// What bounds it on an H100: bytes.  The function has to read the luma in
// and around the boxes once, at most B*H*W*4 bytes (8.3 MB per 1080x1920
// frame, 2.5 us at 3.35 TB/s); it does about 16 float32 operations per
// pixel of box area, well under the card's float32 rate.
//
// Design.  Blocks run in any order and carry nothing: one block per (image,
// 32x128 tile).  A tile that meets no box of its image returns after
// writing zero partials, so only the tiles under the boxes read the luma.
// The others stage their rows and columns plus a 1-pixel halo in shared
// memory once, with consecutive threads on consecutive columns; pixels
// outside the image read 0, the reference's zero padding, and the two rows
// just above and below the rows handed in come from an optional halo (the
// neighbouring ranks' edge rows in the row-sharded report).  For each box
// that meets the tile the threads then visit only the pixels of the
// intersection, each evaluating the masked 3x3 stencil in the TPU kernel's
// float32 operation order (row triples (l + c) + r, then (up + mid) + down,
// then 9x - box).  The tiles are 2-D because a full-width row tile of a
// 7680-px frame would not fit in shared memory.
//
// Sums: each thread adds its pixels in float32, as the TPU kernel does; the
// block combines the threads' partials in float64 in a fixed order and
// writes one (10, 2) partial per tile to a (B, tiles, 10, 2) scratch; a
// second small kernel adds the tiles in a fixed order.  No float atomics,
// so the result is the same from run to run.  Box coordinates are global
// rows: row_offset shifts the local rows, so a box that spans ranks splits
// exactly into per-rank sums.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxes = 10;
constexpr int kTileRows = 32;   // mirrored in ops/sharpness_kernels.py
constexpr int kTileCols = 128;
constexpr int kThreads = 256;
constexpr int kPitch = kTileCols + 2;
constexpr int kRowsPerPass = kThreads / kTileCols;
constexpr int kWarps = kThreads / 32;

struct Box {
  int top, bottom, left, right;
};

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// partial: (B, tiles, 10, 2) float64, tiles = tiles_y * tiles_x.
__global__ void sharpness_tiles(const float* __restrict__ pgm,
                                const float* __restrict__ halo, int height,
                                int width, int row_offset,
                                const int* __restrict__ boxes, int tiles_x,
                                double* __restrict__ partial) {
  __shared__ float tile[(kTileRows + 2) * kPitch];
  __shared__ Box box[kBoxes];
  __shared__ double red[kWarps][2];

  const int b = blockIdx.y;
  const int t = blockIdx.x;
  const int y0 = (t / tiles_x) * kTileRows;  // local rows [y0, y1)
  const int x0 = (t % tiles_x) * kTileCols;  // columns [x0, x1)
  const int y1 = min(y0 + kTileRows, height);
  const int x1 = min(x0 + kTileCols, width);
  if (threadIdx.x < kBoxes) {
    const int* bx = boxes + (static_cast<long long>(b) * kBoxes + threadIdx.x) * 4;
    box[threadIdx.x] = Box{bx[0], bx[1], bx[2], bx[3]};
  }
  __syncthreads();

  // Boxes that meet this tile: the same mask in every thread.
  unsigned meets = 0;
  for (int k = 0; k < kBoxes; ++k) {
    const Box& bx = box[k];
    if (bx.top < row_offset + y1 && bx.bottom > row_offset + y0 &&
        bx.left < x1 && bx.right > x0) {
      meets |= 1u << k;
    }
  }
  double* out = partial + (static_cast<long long>(b) * gridDim.x + t) * kBoxes * 2;
  if (!meets) {
    if (threadIdx.x < 2 * kBoxes) out[threadIdx.x] = 0.0;
    return;
  }

  // Stage rows y0-1 .. y0+kTileRows and columns x0-1 .. x0+kTileCols.
  const float* img = pgm + static_cast<long long>(b) * height * width;
  const float* hal = halo ? halo + static_cast<long long>(b) * 2 * width : nullptr;
  for (int e = threadIdx.x; e < (kTileRows + 2) * kPitch; e += kThreads) {
    const int y = y0 - 1 + e / kPitch;
    const int x = x0 - 1 + e % kPitch;
    float val = 0.0f;
    if (x >= 0 && x < width) {
      if (y >= 0 && y < height) {
        val = img[static_cast<long long>(y) * width + x];
      } else if (hal && y == -1) {
        val = hal[x];
      } else if (hal && y == height) {
        val = hal[width + x];
      }
    }
    tile[e] = val;
  }
  __syncthreads();

  const int c = threadIdx.x % kTileCols;
  const int x = x0 + c;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < kBoxes; ++k) {
    if (!(meets >> k & 1u)) {
      if (threadIdx.x == 0) out[2 * k] = out[2 * k + 1] = 0.0;
      continue;
    }
    const Box bx = box[k];
    float a1 = 0.0f, a2 = 0.0f;
    const bool col_in = x < x1 && x >= bx.left && x < bx.right;
    if (col_in) {
      const bool lf = x - 1 >= bx.left;
      const bool rt = x + 1 < bx.right;
      // Rows of the tile inside the box.
      const int r_lo = max(bx.top - row_offset - y0, 0);
      const int r_hi = min(bx.bottom - row_offset, y1) - y0;
      for (int r = threadIdx.x / kTileCols; r < r_hi; r += kRowsPerPass) {
        if (r < r_lo) continue;
        const int gy = row_offset + y0 + r;
        const bool up = gy - 1 >= bx.top;
        const bool dn = gy + 1 < bx.bottom;
        const float* mid = tile + (r + 1) * kPitch + c + 1;
        const float xc = mid[0];
        auto triple = [&](const float* q) {
          return __fadd_rn(__fadd_rn(lf ? q[-1] : 0.0f, q[0]), rt ? q[1] : 0.0f);
        };
        const float t_up = up ? triple(mid - kPitch) : 0.0f;
        const float t_mid = triple(mid);
        const float t_dn = dn ? triple(mid + kPitch) : 0.0f;
        const float box3 = __fadd_rn(__fadd_rn(t_up, t_mid), t_dn);
        const float resp = __fsub_rn(__fmul_rn(9.0f, xc), box3);
        a2 = __fadd_rn(a2, __fmul_rn(resp, resp));
        const float rows_in = (up ? 1.0f : 0.0f) + 1.0f + (dn ? 1.0f : 0.0f);
        const float cols_in = (lf ? 1.0f : 0.0f) + 1.0f + (rt ? 1.0f : 0.0f);
        const float wgt = __fsub_rn(9.0f, __fmul_rn(rows_in, cols_in));
        a1 = __fadd_rn(a1, __fmul_rn(xc, wgt));
      }
    }
    const double w1 = warp_sum(static_cast<double>(a1));
    const double w2 = warp_sum(static_cast<double>(a2));
    if (lane == 0) {
      red[warp][0] = w1;
      red[warp][1] = w2;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      double s = 0.0;
      for (int i = 0; i < kWarps; ++i) s += red[i][threadIdx.x];
      out[2 * k + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// One block per image: thread i adds tiles i, i + kThreads, ... for all 20
// sums, then the block adds the threads' sums in a fixed order.
__global__ void sharpness_combine(const double* __restrict__ partial, int tiles,
                                  double* __restrict__ sums) {
  __shared__ double red[kWarps][2 * kBoxes];
  const int b = blockIdx.x;
  const double* src = partial + static_cast<long long>(b) * tiles * 2 * kBoxes;
  double acc[2 * kBoxes];
#pragma unroll
  for (int j = 0; j < 2 * kBoxes; ++j) acc[j] = 0.0;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
#pragma unroll
    for (int j = 0; j < 2 * kBoxes; ++j) acc[j] += src[t * 2 * kBoxes + j];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2 * kBoxes; ++j) {
    const double w = warp_sum(acc[j]);
    if (lane == 0) red[warp][j] = w;
  }
  __syncthreads();
  if (threadIdx.x < 2 * kBoxes) {
    double s = 0.0;
    for (int i = 0; i < kWarps; ++i) s += red[i][threadIdx.x];
    sums[static_cast<long long>(b) * 2 * kBoxes + threadIdx.x] = s;
  }
}

}  // namespace

// pgm: (batch, height, width) float32; halo: (batch, 2, width) float32, the
// rows just above and below, or nullptr for zeros; boxes: (batch, 10, 4)
// int32 in global rows (local row y is global row row_offset + y), empty
// slots all zero; partial: (batch, tiles, 10, 2) float64 scratch; sums:
// (batch, 10, 2) float64 [s1, s2].  Returns the cudaError_t of the launches.
extern "C" int ph_sharpness_sums(const void* pgm, const void* halo, int batch,
                                 int height, int width, int row_offset,
                                 const void* boxes, void* partial, void* sums,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles_x = (width + kTileCols - 1) / kTileCols;
  const int tiles = ((height + kTileRows - 1) / kTileRows) * tiles_x;
  double* part = static_cast<double*>(partial);
  sharpness_tiles<<<dim3(tiles, batch), kThreads, 0, st>>>(
      static_cast<const float*>(pgm), static_cast<const float*>(halo), height,
      width, row_offset, static_cast<const int*>(boxes), tiles_x, part);
  sharpness_combine<<<batch, kThreads, 0, st>>>(part, tiles,
                                                static_cast<double*>(sums));
  return cudaGetLastError();
}
