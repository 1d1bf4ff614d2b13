// Host-side launch facts of the persistent kernels, looked up once per
// device: the card's SM count, and per kernel instance the dynamic shared
// memory its limit was raised to and the blocks an SM holds at a size.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace launch_util {

constexpr int MAX_DEVICES = 64;

// the multiprocessor count of device dev (asked once per device)
inline cudaError_t sm_count(int dev, int* out) {
  static int n_sms[MAX_DEVICES];     // 0: the device not seen yet
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidValue;
  if (!n_sms[dev]) {
    int n = 0;
    const cudaError_t err =
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    n_sms[dev] = n;
  }
  *out = n_sms[dev];
  return cudaSuccess;
}

// what one kernel instance keeps per device: the largest dynamic shared
// memory its limit was raised to, and the resident blocks an SM holds at
// the last WAYS sizes it was launched with (a kernel whose tables live in
// shared memory has one size per spec)
struct Resident {
  static constexpr int WAYS = 4;
  size_t reserved[MAX_DEVICES];
  size_t smem[MAX_DEVICES][WAYS];
  int blocks[MAX_DEVICES][WAYS];     // 0: the way is empty
  int next[MAX_DEVICES];
};

// the grid of a persistent kernel on the current device: the least of
// want and the blocks the card holds at once at `threads` threads and
// `smem` dynamic bytes
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                            long want, Resident& r, unsigned* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  for (int k = 0; k < Resident::WAYS; ++k)
    if (r.blocks[dev][k] && r.smem[dev][k] == smem) per_sm = r.blocks[dev][k];
  if (!per_sm) {
    if (smem > 48 * 1024 && smem > r.reserved[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      r.reserved[dev] = smem;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int k = r.next[dev];
    r.smem[dev][k] = smem;
    r.blocks[dev][k] = per_sm;
    r.next[dev] = (k + 1) % Resident::WAYS;
  }
  const long resident = (long)per_sm * sms;
  *grid = (unsigned)(want < resident ? want : resident);
  return cudaSuccess;
}

}  // namespace launch_util
