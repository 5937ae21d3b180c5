// K2: the reference's insertion argsort with the truncating float32 margin
// comparator (src/utilities.c:132-153, src/color_quantization.c:601-611):
// element i moves left past every element j with sal[j] - sal[i] <= -1.
//
// Replaces photohive_dsp_tpu/ops/pallas_kernels.py margin_sort
// (_sort_kernel), which unrolled its C-1 steps and so served only C <= 512.
//
// What bounds it: the C-1 insertion steps depend on each other (the margin
// comparator is not transitive, so no parallel sorting network gives the
// insertion-sort order), so the latency is C-1 dependent steps; the data, C
// floats per image, is tiny.
//
// Design: track positions, move nothing.  Before step i the sorted prefix
// holds exactly the elements 0..i-1, each at its position posn[e].  Element
// i's blockers are the e < i with !(sal[e] - sal[i] <= -1): a set that
// depends on the saliencies alone, not on the arrangement.  The insertion
// point is pos = 1 + max(posn[e] over the blockers) (0 with none), and the
// shift right of [pos, i-1] is posn[e] += (posn[e] >= pos) for every e < i;
// then posn[i] = pos.  At the end order[posn[e]] = e.  An element not yet
// placed holds posn -1, the max's identity, which no update moves, so a
// step needs no e < i test.
//
// Element e lives in lane e % 32 of warp (e / 32) % kWarps, register
// (e / 32) / kWarps, its saliency and position in registers.  A step's
// blocker mask needs only sal[i], so it is off the dependency chain; the
// chain is a lane-local max over the masked positions (a tree of depth
// log2 kRegs), one __reduce_max_sync (redux.sync), with several warps a
// max through shared memory behind one barrier, and one compare-and-add a
// register.  With one warp there is no shared memory and no __syncwarp in
// the loop.  The kernel is instantiated per (kWarps, kRegs) bucket so the
// register arrays unroll; ops/margin_sort.sort_layout picks the bucket:
// one warp up to C = 512, a block of 4 warps up to 2176 (h_partitions=360
// gives C = 2164), 16 or 32 warps beyond, up to 32768.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

template <int kWarps, int kRegs>
__global__ void __launch_bounds__(kWarps * kWarp)
margin_sort_kernel(const float* __restrict__ sal, int c,
                   int* __restrict__ order_out) {
  // With several warps, sal[i] of a step is read from shared memory (its
  // owner's register is out of the other warps' reach); red holds each
  // warp's max of a step, double-buffered so one barrier a step suffices.
  extern __shared__ float ssal[];
  __shared__ int red[2][kWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const float* row = sal + static_cast<long long>(blockIdx.x) * c;
  float s[kRegs];
  int p[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int e = (r * kWarps + warp) * kWarp + lane;
    s[r] = e < c ? row[e] : 0.0f;
    p[r] = -1;
    if (kWarps > 1 && e < c) ssal[e] = s[r];
  }
  if (kWarps > 1) __syncthreads();

  int parity = 0;
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    for (int w = 0; w < kWarps; ++w) {
      const int base = (r * kWarps + w) * kWarp;
      if (base >= c) break;
      // Unrolled by 8, so a step's blocker mask (sal alone) is computed
      // ahead, off the chain of the steps before it.
#pragma unroll 8
      for (int l = 0; l < kWarp; ++l) {
        const int i = base + l;
        if (i >= c) break;
        const float si = kWarps == 1 ? __shfl_sync(kFull, s[r], l) : ssal[i];
        int m[kRegs];
#pragma unroll
        for (int q = 0; q < kRegs; ++q) {
          m[q] = !(__fsub_rn(s[q], si) <= -1.0f) ? p[q] : -1;
        }
#pragma unroll
        for (int step = 1; step < kRegs; step *= 2) {
#pragma unroll
          for (int q = 0; q + step < kRegs; q += 2 * step) {
            m[q] = max(m[q], m[q + step]);
          }
        }
        int last = __reduce_max_sync(kFull, m[0]);
        if (kWarps > 1) {
          if (lane == 0) red[parity][warp] = last;
          __syncthreads();
#pragma unroll
          for (int v = 0; v < kWarps; ++v) last = max(last, red[parity][v]);
          parity ^= 1;
        }
        // The blockers' last position is `last`; the run after it moves
        // one slot right and i takes the freed slot.
#pragma unroll
        for (int q = 0; q < kRegs; ++q) p[q] += p[q] > last ? 1 : 0;
        if (warp == w && lane == l) p[r] = last + 1;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRegs; ++r) {
    const int e = (r * kWarps + warp) * kWarp + lane;
    if (e < c) order_out[static_cast<long long>(blockIdx.x) * c + p[r]] = e;
  }
}

template <int kWarps, int kRegs>
cudaError_t launch(const float* sal, int batch, int c, int* order_out,
                   cudaStream_t stream) {
  const size_t bytes =
      kWarps > 1 ? static_cast<size_t>(kWarps) * kWarp * kRegs * sizeof(float)
                 : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        margin_sort_kernel<kWarps, kRegs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  margin_sort_kernel<kWarps, kRegs>
      <<<batch, kWarps * kWarp, bytes, stream>>>(sal, c, order_out);
  return cudaGetLastError();
}

// An empty kernel of one warp: the floor any launch pays, timed beside K2.
__global__ void empty_kernel() {}

}  // namespace

// (B, C) float32 saliencies -> (B, C) int32 argsort, with the (warps,
// registers) bucket of ops/margin_sort.sort_layout(C); returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a bucket that is not
// instantiated or too small for C).
extern "C" int ph_margin_sort(const void* sal, int batch, int c, int warps,
                              int regs, void* order_out, void* stream) {
  if (static_cast<long long>(warps) * kWarp * regs < c) {
    return cudaErrorInvalidValue;
  }
  const float* s = static_cast<const float*>(sal);
  int* o = static_cast<int*>(order_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PH_BUCKET(W, R) \
  if (warps == W && regs == R) return launch<W, R>(s, batch, c, o, st);
  PH_BUCKET(1, 1)
  PH_BUCKET(1, 2)
  PH_BUCKET(1, 4)
  PH_BUCKET(1, 8)
  PH_BUCKET(1, 16)
  PH_BUCKET(4, 5)
  PH_BUCKET(4, 9)
  PH_BUCKET(4, 17)
  PH_BUCKET(16, 9)
  PH_BUCKET(16, 32)
  PH_BUCKET(32, 32)
#undef PH_BUCKET
  return cudaErrorInvalidValue;
}

// Launches the empty kernel on `stream`; returns the cudaError_t.
extern "C" int ph_empty_kernel(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
