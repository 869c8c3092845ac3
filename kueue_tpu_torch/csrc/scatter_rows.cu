// Kernel scatter_rows: the resident usage row update.
//
// Replaces the jitted _scatter_rows of kueue_tpu/core/solver.py:504-518
// (the same function as kueue_tpu/core/encode.py:334-344):
// usage[idx[i], :] = rows[i, :], in place on the device-resident leaf
// usage buffer (the JAX version donates the buffer for the same
// effect). One thread per element, grid-striding. The caller pads idx
// by repeating its first changed row with the same data, so duplicate
// writes store equal values and the result is the same in any order.
// Indices as the JAX scatter takes them: a negative one counts from
// the end, one still outside [0, N) is dropped.
//
// What bounds it: bytes, n*FR*8 read and written plus n*4 of indices
// (the headline's few changed rows are a few kilobytes, so a launch is
// latency, not bandwidth).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void scatter(long long* usage, const int* idx, const long long* rows,
                        int n_rows, int n, int fr) {
  const size_t total = (size_t)n * fr;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const size_t i = t / fr, j = t % fr;
    int r = idx[i];
    if (r < 0) r += n_rows;
    if (r < 0 || r >= n_rows) continue;
    usage[(size_t)r * fr + j] = rows[t];
  }
}

}  // namespace

extern "C" int scatter_rows(void* usage, const void* idx, const void* rows, int n_rows,
                            int n, int fr, void* stream) {
  const size_t total = (size_t)n * fr;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 1024
                               ? (total + threads - 1) / threads
                               : 1024);
  scatter<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (long long*)usage, (const int*)idx, (const long long*)rows, n_rows, n, fr);
  return (int)cudaGetLastError();
}
