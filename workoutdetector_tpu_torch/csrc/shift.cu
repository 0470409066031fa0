// TSM temporal shift on a flat (frames = B*T, H*W, C) tensor.
//
// Replaces workoutdetector_tpu/ops/pallas/shift.py: temporal_shift_pallas
// (_shift_kernel). out[:, t, .., :f] = x[:, t+1] (zero at t = T-1),
// out[:, t, .., f:2f] = x[:, t-1] (zero at t = 0), the other channels copied;
// f = fold, and the shift never crosses a clip. With `reverse` the two
// directions swap (out[.., :f] = x[t-1], out[.., f:2f] = x[t+1], zero at the
// opposite ends): that is S^T, the shift's backward.
//
// Bound on the H100: bytes. It reads x once and writes y once and does no
// arithmetic, so 2 * numel * itemsize over 3.35 TB/s is the floor. Design:
// one thread per 16-byte vector (8 bf16 channels) when C and fold allow it,
// neighbouring threads on neighbouring addresses, each vector taken from its
// own frame or from frame t+-1 at the same pixel. The TPU kernel's
// all-T VMEM slab is not needed: a thread reads the one vector it writes.
// Written in CUDA C++ rather than Triton so the whole port builds with one
// toolchain; it is a pure copy, so either route reaches the same bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V, typename Idx>
__global__ void shift_kernel(const V* __restrict__ x, V* __restrict__ y,
                             Idx total, Idx frame_units, int T, int CU,
                             int FU, bool reverse) {
  const Idx stride = (Idx)gridDim.x * blockDim.x;
  for (Idx i = (Idx)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int cu = (int)(i % (Idx)CU);
    const int t = (int)((i / frame_units) % (Idx)T);
    V v{};
    // fold cu < FU reads frame t+1 (t-1 reversed), the next fold the other
    const bool ahead = (cu < FU) != reverse;
    if (cu < 2 * FU) {
      if (ahead) {
        if (t != T - 1) v = x[i + frame_units];
      } else {
        if (t != 0) v = x[i - frame_units];
      }
    } else {
      v = x[i];
    }
    y[i] = v;
  }
}

template <typename V>
cudaError_t launch(const void* x, void* y, int64_t frames, int64_t inner,
                   int T, int C, int fold, int elem_bytes, bool reverse,
                   cudaStream_t stream) {
  const int unit = (int)sizeof(V);
  const int CU = C * elem_bytes / unit, FU = fold * elem_bytes / unit;
  const int64_t frame_units = inner * CU;
  const int64_t total = frames * frame_units;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  if (total < ((int64_t)1 << 31)) {
    shift_kernel<V, uint32_t><<<blocks, threads, 0, stream>>>(
        (const V*)x, (V*)y, (uint32_t)total, (uint32_t)frame_units, T, CU, FU, reverse);
  } else {
    shift_kernel<V, int64_t><<<blocks, threads, 0, stream>>>(
        (const V*)x, (V*)y, total, frame_units, T, CU, FU, reverse);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* wd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, y: contiguous (frames, inner, C) of elem_bytes-wide elements;
// reverse != 0 applies S^T.
extern "C" int wd_temporal_shift(const void* x, void* y, int64_t frames,
                                 int64_t inner, int T, int C, int fold,
                                 int elem_bytes, int reverse, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec16 = (C * elem_bytes) % 16 == 0 &&
                     (fold * elem_bytes) % 16 == 0 &&
                     ((uintptr_t)x % 16) == 0 && ((uintptr_t)y % 16) == 0;
  const bool rev = reverse != 0;
  if (vec16) return (int)launch<uint4>(x, y, frames, inner, T, C, fold, elem_bytes, rev, s);
  if (elem_bytes == 4) return (int)launch<uint32_t>(x, y, frames, inner, T, C, fold, 4, rev, s);
  if (elem_bytes == 2) return (int)launch<uint16_t>(x, y, frames, inner, T, C, fold, 2, rev, s);
  return (int)cudaErrorInvalidValue;
}
