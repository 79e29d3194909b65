// K2 and K3: SHA-512 for the SHAMap seal, one thread per message (sm_90a).
//
// K2 `sha512_masked` replaces stellard_tpu/ops/treehash_jax.py::
// sha512_blocks_masked (and through it tree_leaf_body and the flat
// TpuHasher._hash_msgs batches): row b of a [B, NB, 32] u32 block array
// holds nblocks[b] pre-padded blocks; its digest state goes to `out`
// (16 words a row, or the first 8 into the resident digest buffer).
//
// K3 `tree_inner_level` replaces the inner level of stellard_tpu/parallel/
// mesh.py::sharded_tree_kernels (inner_body): for each of N inner nodes it
// assembles the 516-byte HP_INNER_NODE payload (5 blocks) from a host
// template, replacing child slot c with the digest found at row
// child_rows[i][c] of the resident [cap, 8] buffer (-1: keep the template's
// known hash), compresses it, and writes the node's digest to
// buf[offset + i]. The host-built scatter program of the TPU version
// (and its duplicate-entry padding) is gone: the kernel gathers by row.
//
// What bounds it on an H100: integer operations. A 128-byte block costs
// 80 rounds plus a 64-step message schedule, about 5,000 32-bit integer
// operations (64-bit adds, rotates and logic ops each take two or more)
// against 128 bytes read, far above the card's ops-per-byte balance.
//
// What the design does about it: the TPU form split every 64-bit word
// into (hi, lo) u32 lanes because its vector unit is 32-bit. Here each
// thread keeps native 64-bit words in registers, runs the schedule in a
// 16-word rolling window, and takes its own row's block count as the loop
// bound, so padding rows (nblocks = 0) cost nothing but the store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

__constant__ u64 K[80] = {
    0x428A2F98D728AE22ULL, 0x7137449123EF65CDULL, 0xB5C0FBCFEC4D3B2FULL,
    0xE9B5DBA58189DBBCULL, 0x3956C25BF348B538ULL, 0x59F111F1B605D019ULL,
    0x923F82A4AF194F9BULL, 0xAB1C5ED5DA6D8118ULL, 0xD807AA98A3030242ULL,
    0x12835B0145706FBEULL, 0x243185BE4EE4B28CULL, 0x550C7DC3D5FFB4E2ULL,
    0x72BE5D74F27B896FULL, 0x80DEB1FE3B1696B1ULL, 0x9BDC06A725C71235ULL,
    0xC19BF174CF692694ULL, 0xE49B69C19EF14AD2ULL, 0xEFBE4786384F25E3ULL,
    0x0FC19DC68B8CD5B5ULL, 0x240CA1CC77AC9C65ULL, 0x2DE92C6F592B0275ULL,
    0x4A7484AA6EA6E483ULL, 0x5CB0A9DCBD41FBD4ULL, 0x76F988DA831153B5ULL,
    0x983E5152EE66DFABULL, 0xA831C66D2DB43210ULL, 0xB00327C898FB213FULL,
    0xBF597FC7BEEF0EE4ULL, 0xC6E00BF33DA88FC2ULL, 0xD5A79147930AA725ULL,
    0x06CA6351E003826FULL, 0x142929670A0E6E70ULL, 0x27B70A8546D22FFCULL,
    0x2E1B21385C26C926ULL, 0x4D2C6DFC5AC42AEDULL, 0x53380D139D95B3DFULL,
    0x650A73548BAF63DEULL, 0x766A0ABB3C77B2A8ULL, 0x81C2C92E47EDAEE6ULL,
    0x92722C851482353BULL, 0xA2BFE8A14CF10364ULL, 0xA81A664BBC423001ULL,
    0xC24B8B70D0F89791ULL, 0xC76C51A30654BE30ULL, 0xD192E819D6EF5218ULL,
    0xD69906245565A910ULL, 0xF40E35855771202AULL, 0x106AA07032BBD1B8ULL,
    0x19A4C116B8D2D0C8ULL, 0x1E376C085141AB53ULL, 0x2748774CDF8EEB99ULL,
    0x34B0BCB5E19B48A8ULL, 0x391C0CB3C5C95A63ULL, 0x4ED8AA4AE3418ACBULL,
    0x5B9CCA4F7763E373ULL, 0x682E6FF3D6B2B8A3ULL, 0x748F82EE5DEFB2FCULL,
    0x78A5636F43172F60ULL, 0x84C87814A1F0AB72ULL, 0x8CC702081A6439ECULL,
    0x90BEFFFA23631E28ULL, 0xA4506CEBDE82BDE9ULL, 0xBEF9A3F7B2C67915ULL,
    0xC67178F2E372532BULL, 0xCA273ECEEA26619CULL, 0xD186B8C721C0C207ULL,
    0xEADA7DD6CDE0EB1EULL, 0xF57D4F7FEE6ED178ULL, 0x06F067AA72176FBAULL,
    0x0A637DC5A2C898A6ULL, 0x113F9804BEF90DAEULL, 0x1B710B35131C471BULL,
    0x28DB77F523047D84ULL, 0x32CAAB7B40C72493ULL, 0x3C9EBE0A15C9BEBCULL,
    0x431D67C49C100D4CULL, 0x4CC5D4BECB3E42B6ULL, 0x597F299CFC657E2AULL,
    0x5FCB6FAB3AD6FAECULL, 0x6C44198C4A475817ULL};

__constant__ u64 IV[8] = {
    0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
    0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
    0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL};

__device__ __forceinline__ u64 rotr(u64 x, int n) {
  return (x >> n) | (x << (64 - n));
}

// one compression of the 16-word block w (clobbered: it is the schedule)
__device__ void compress(u64 st[8], u64 w[16]) {
  u64 a = st[0], b = st[1], c = st[2], d = st[3];
  u64 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 80; t++) {
    u64 wt;
    if (t < 16) {
      wt = w[t];
    } else {
      u64 w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      u64 s0 = rotr(w15, 1) ^ rotr(w15, 8) ^ (w15 >> 7);
      u64 s1 = rotr(w2, 19) ^ rotr(w2, 61) ^ (w2 >> 6);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    u64 t1 = h + (rotr(e, 14) ^ rotr(e, 18) ^ rotr(e, 41)) +
             ((e & f) ^ (~e & g)) + K[t] + wt;
    u64 t2 = (rotr(a, 28) ^ rotr(a, 34) ^ rotr(a, 39)) +
             ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// 32 u32 (hi, lo) words -> 16 u64
__device__ __forceinline__ void load_block(const uint32_t* src, u64 w[16]) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint4 q = s4[k];
    w[2 * k] = ((u64)q.x << 32) | q.y;
    w[2 * k + 1] = ((u64)q.z << 32) | q.w;
  }
}

__device__ __forceinline__ void init_state(u64 st[8]) {
#pragma unroll
  for (int k = 0; k < 8; k++) st[k] = IV[k];
}

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sha512_masked_kernel(const uint32_t* __restrict__ blocks,
                     const int32_t* __restrict__ nblocks, int n, int nb,
                     uint32_t* __restrict__ out, int out_stride,
                     int out_words) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  u64 st[8];
  init_state(st);
  int count = nblocks[idx];
  count = count < 0 ? 0 : (count > nb ? nb : count);
  const uint32_t* row = blocks + (size_t)idx * nb * 32;
  for (int i = 0; i < count; i++) {
    u64 w[16];
    load_block(row + 32 * i, w);
    compress(st, w);
  }
  uint32_t* dst = out + (size_t)idx * out_stride;
  for (int k = 0; k < out_words / 2; k++) {
    dst[2 * k] = (uint32_t)(st[k] >> 32);
    dst[2 * k + 1] = (uint32_t)st[k];
  }
}

constexpr int INNER_WORDS = 5 * 32;

__global__ void __launch_bounds__(THREADS)
tree_inner_level_kernel(uint32_t* __restrict__ buf,
                        const uint32_t* __restrict__ tmpl,
                        const int32_t* __restrict__ child_rows, int n,
                        int offset) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const uint32_t* t = tmpl + (size_t)idx * INNER_WORDS;
  const int32_t* rows = child_rows + (size_t)idx * 16;
  // payload word j (u32, big-endian byte order): word 0 is the prefix,
  // child c's digest is words 1 + 8c .. 8 + 8c, then padding
  auto word = [&](int j) -> uint32_t {
    if (j >= 1 && j <= 128) {
      int c = (j - 1) >> 3;
      int r = rows[c];
      if (r >= 0) return buf[(size_t)r * 8 + ((j - 1) & 7)];
    }
    return t[j];
  };
  u64 st[8];
  init_state(st);
  for (int blk = 0; blk < 5; blk++) {
    u64 w[16];
#pragma unroll
    for (int k = 0; k < 16; k++) {
      int j = blk * 32 + 2 * k;
      w[k] = ((u64)word(j) << 32) | word(j + 1);
    }
    compress(st, w);
  }
  uint32_t* dst = buf + (size_t)(offset + idx) * 8;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    dst[2 * k] = (uint32_t)(st[k] >> 32);
    dst[2 * k + 1] = (uint32_t)st[k];
  }
}

}  // namespace

extern "C" int sha512_masked_launch(const void* blocks, const void* nblocks,
                                    int n, int nb, void* out, int out_stride,
                                    int out_words, void* stream) {
  if (n <= 0) return 0;
  int grid = (n + THREADS - 1) / THREADS;
  sha512_masked_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)blocks, (const int32_t*)nblocks, n, nb,
      (uint32_t*)out, out_stride, out_words);
  return (int)cudaGetLastError();
}

extern "C" int tree_inner_level_launch(void* buf, const void* tmpl,
                                       const void* child_rows, int n,
                                       int offset, void* stream) {
  if (n <= 0) return 0;
  int grid = (n + THREADS - 1) / THREADS;
  tree_inner_level_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (uint32_t*)buf, (const uint32_t*)tmpl, (const int32_t*)child_rows, n,
      offset);
  return (int)cudaGetLastError();
}
