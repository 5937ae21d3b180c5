// The grid of a kernel that walks runs of pixels: one wave of the blocks
// the card holds at once, so each block's set-up (zeroing its tables,
// filling its lookup tables) and its flush into device memory are paid
// once per SM slot, not once per fixed-size run.
#pragma once

#include <cuda_runtime.h>

// As many runs an image as the card holds blocks of `kernel` (kThreads
// threads, `bytes` of dynamic shared memory) over the batch, each a whole
// number of the block's steps (kThreads x kVec pixels), at most max_run
// pixels.  Sets the grid (runs x batch) and the run.
template <int kThreads, int kVec, typename Kernel>
cudaError_t one_wave(Kernel kernel, size_t bytes, int batch, long long pixels,
                     long long max_run, dim3* grid, long long* run) {
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  constexpr long long kStep = static_cast<long long>(kVec) * kThreads;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long runs = (resident + batch - 1) / batch;
  long long r = (pixels + runs - 1) / runs;
  r = (r + kStep - 1) / kStep * kStep;
  *run = r < max_run ? r : max_run;
  *grid = dim3(static_cast<unsigned>((pixels + *run - 1) / *run),
               static_cast<unsigned>(batch));
  return cudaSuccess;
}
