// K4 `path_quality`: the saturating Q16.16 product fold that pre-ranks a
// path search's candidate paths, one thread per row (sm_90a).
//
// Replaces stellard_tpu/ops/pathq_jax.py::path_quality_kernel (with
// _qmul and _fold), reached through parallel/mesh.py::sharded_path_quality
// and crypto/backend.py::PathQualityEvaluator. Row b of a [B, H] u32 rate
// matrix holds a candidate path's per-hop Q16.16 rates (identity-padded);
// its composite is acc = 1.0, then acc = qmul(acc, rates[b][h]) for
// h = 0 .. H-1 in that order. Lower is better.
//
// qmul(a, b) = min((a * b) >> 16, 2^32 - 1). The TPU form builds the
// product from 16-bit limbs with carry checks, because JAX's default
// configuration has no 64-bit integers; the limb sum equals the 64-bit
// product shifted right by 16, and its saturation fires exactly when that
// value leaves 32 bits (tests/test_torch_pathq.py holds the two forms
// equal). Here one 32x32->64 multiply, a compare and a select do it. The
// truncating shift makes the fold non-associative, so the hop order is
// kept: it is part of the byte-identity contract with the JAX package.
//
// What bounds it on an H100: bytes. A row is 32 bytes in and 4 out for
// about forty integer operations, far below the card's operations-per-byte
// balance. A row of eight hops is read as two 16-byte loads; any other
// width, or a row that is not 16-byte aligned, is read a word at a time.
// Any B is allowed: the tail threads of the last block return at once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t Q16_ONE = 1u << 16;
constexpr unsigned long long Q16_MAX = 0xFFFFFFFFull;

__device__ __forceinline__ uint32_t qmul(uint32_t a, uint32_t b) {
  const unsigned long long p = ((unsigned long long)a * b) >> 16;
  return p > Q16_MAX ? (uint32_t)Q16_MAX : (uint32_t)p;
}

__global__ void __launch_bounds__(THREADS)
path_quality_kernel(const uint32_t* __restrict__ rates,
                    uint32_t* __restrict__ out, int n, int hops, int vec4) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* r = rates + row * hops;
  uint32_t acc = Q16_ONE;
  if (vec4) {
    const uint4* r4 = reinterpret_cast<const uint4*>(r);
    for (int q = 0; q < hops / 4; q++) {
      const uint4 v = r4[q];
      acc = qmul(acc, v.x);
      acc = qmul(acc, v.y);
      acc = qmul(acc, v.z);
      acc = qmul(acc, v.w);
    }
  } else {
    for (int h = 0; h < hops; h++) acc = qmul(acc, r[h]);
  }
  out[row] = acc;
}

}  // namespace

// rates: [n, hops] u32, contiguous; out: [n] u32. vec4: read each row as
// 16-byte loads (the caller checks hops % 4 == 0 and 16-byte alignment).
extern "C" int path_quality_launch(const void* rates, void* out, int n,
                                   int hops, int vec4, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + THREADS - 1) / THREADS;
  path_quality_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)rates, (uint32_t*)out, n, hops, vec4);
  return (int)cudaGetLastError();
}
