// The read floor of tools/mm_ab.py: one pass that reads a buffer once from
// device memory, 16 bytes a load, four loads in flight a thread, and writes
// nothing (a word only if the data's xor hits a constant).  Its time is the
// least a kernel that must read the same bytes can take under the same
// timer.  A measuring aid, not a kernel of the port.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256)
read_floor_kernel(const uint4* __restrict__ p, size_t n, unsigned* __restrict__ out) {
  unsigned acc = 0;
  const size_t stride = static_cast<size_t>(gridDim.x) * 256;
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < n; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = i + u * stride < n ? p[i + u * stride] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x9e3779b9u) *out = acc;
}

// Reads n16 16-byte words at p with `blocks` blocks of 256 threads.
extern "C" int read_floor_launch(const void* p, size_t n16, void* out, int blocks,
                                 void* stream) {
  read_floor_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(p), n16, static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
