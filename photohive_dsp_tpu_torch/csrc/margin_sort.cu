// K2: the reference's insertion argsort with the truncating float32 margin
// comparator (src/utilities.c:132-153, src/color_quantization.c:601-611):
// element i moves left past every element j with sal[j] - sal[i] <= -1.
//
// Replaces photohive_dsp_tpu/ops/pallas_kernels.py margin_sort
// (_sort_kernel), which unrolled its C-1 steps and so served only C <= 512.
//
// What bounds it: the C-1 insertion steps depend on each other (the margin
// comparator is not transitive, so no parallel sorting network gives the
// insertion-sort order), so the latency is C-1 steps of a few shared-memory
// passes; the data, C floats per image, is tiny.  Design: one warp per
// image, saliencies and the order in shared memory.  Each step scans the
// sorted prefix from the right 32 elements at a time and finds the last
// blocker with one __ballot_sync, then the warp shifts the run it passes one
// slot right, 32 elements at a time.  No step has a size limit, so every
// legal C (up to 2164 at h_partitions=360) takes this kernel.
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__global__ void margin_sort_kernel(const float* __restrict__ sal, int c,
                                   int* __restrict__ order_out) {
  extern __shared__ float smem[];
  float* so = smem;                               // saliencies, sorted order
  int* ord = reinterpret_cast<int*>(smem + c);    // cell ids, sorted order
  const int lane = threadIdx.x;
  const float* row = sal + static_cast<long long>(blockIdx.x) * c;
  for (int i = lane; i < c; i += kWarp) {
    so[i] = row[i];
    ord[i] = i;
  }
  __syncwarp();

  for (int i = 1; i < c; ++i) {
    const float si = so[i];
    const int ei = ord[i];
    // Final position: just past the last j < i that does NOT satisfy the
    // margin condition (same float32 subtraction as the reference).
    int pos = 0;
    for (int top = i - 1; top >= 0; top -= kWarp) {
      const int j = top - lane;
      const bool blocker = j >= 0 && !(__fsub_rn(so[j], si) <= -1.0f);
      const unsigned mask = __ballot_sync(0xffffffffu, blocker);
      if (mask) {
        pos = top - (__ffs(mask) - 1) + 1;
        break;
      }
    }
    // Shift [pos, i-1] one slot right, highest chunk first.
    for (int top = i - 1; top >= pos; top -= kWarp) {
      const int j = top - lane;
      const bool active = j >= pos;
      float sv = 0.0f;
      int ov = 0;
      if (active) {
        sv = so[j];
        ov = ord[j];
      }
      __syncwarp();
      if (active) {
        so[j + 1] = sv;
        ord[j + 1] = ov;
      }
      __syncwarp();
    }
    if (lane == 0) {
      so[pos] = si;
      ord[pos] = ei;
    }
    __syncwarp();
  }
  for (int i = lane; i < c; i += kWarp) {
    order_out[static_cast<long long>(blockIdx.x) * c + i] = ord[i];
  }
}

}  // namespace

// (B, C) float32 saliencies -> (B, C) int32 argsort; returns the
// cudaError_t of the launch.
extern "C" int ph_margin_sort(const void* sal, int batch, int c,
                              void* order_out, void* stream) {
  const size_t bytes = static_cast<size_t>(c) * (sizeof(float) + sizeof(int));
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        margin_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  margin_sort_kernel<<<batch, kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sal), c, static_cast<int*>(order_out));
  return cudaGetLastError();
}
