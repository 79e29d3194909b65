// K1: batched Ed25519 verification, four lanes per signature (sm_90a).
//
// Replaces the TPU kernel stellard_tpu/ops/ed25519_pallas.py::_kernel
// (launched by _call, wrapped by verify_kernel_pallas) and its XLA twin
// stellard_tpu/ops/ed25519_jax.py::verify_kernel, and, with a count, the
// shard body of stellard_tpu/parallel/mesh.py::verify_and_count. Verdict,
// bit for bit the JAX package's final check in either of its modes
// (STELLARD_VERIFY_CHECK, a runtime argument here):
//
//   bytes: accept iff s_canonical && A decodes && encode([S]B + [h](-A)) == R
//   point: accept iff s_canonical && A decodes && R decodes && y_r < p
//          && X == x_r * Z && Y == y_r * Z for (X, Y, Z) = [S]B + [h](-A)
//
// with h = SHA512(R || A || M) mod l computed on the host. A's y is taken
// mod p (a non-canonical y is NOT rejected, as in the JAX decoder); x = 0
// with the sign bit set is rejected. In bytes mode R is compared as raw
// bytes, so a non-canonical R never matches the canonical encoding; in
// point mode R is decoded like A and y_r < p is tested explicitly, which
// replaces the final inversion by a second square-root chain.
//
// The count (the psum of verify_and_count's per-device valid counts, kept
// on the device): when `count` is not null, the last phase's warp adds its
// block's accepted signatures to *count with one atomicAdd of its ballot.
//
// What bounds it on an H100: integer instruction issue. A signature needs
// about 3,500 field multiplies and squarings (256 doublings, about 120
// cached additions, two ~255-squaring exponentiations), each a few hundred
// 32-bit integer instructions in radix 2^51; its input is 129 bytes, so
// memory is never the limit. One thread a signature left a 16,384 chunk
// with about 4 warps an SM, each a long chain of dependent products, too
// few to keep the integer pipes busy.
//
// What this design does about it:
//
// - A group of G = 4 consecutive lanes walks one signature; lane k owns
//   extended coordinate k of the running point (X, Y, Z, T). A doubling
//   (dbl-2008-hwcd) or cached addition (add-2008-hwcd-3) is two stages of
//   four independent products, one a lane: the squares of X, Y, Z and
//   X+Y (or the four cached products), then E*F, G*H, F*G, E*H. Between
//   stages the group swaps limbs with shuffles masked to its own lanes;
//   E, F, G and H are formed on every lane. A chunk thus gives four times
//   the warps, and each lane's chain is a quarter as long.
// - The decode's exponentiation and the final inversion are single chains:
//   they run in phases of their own, one thread a signature in the first
//   warp of the block, so that they are issued once a signature and not
//   once a lane.
// - Both scalars are recoded in the kernel into signed 4-bit digits in
//   [-8, 7], so each table holds the multiples 1..8. A negative digit
//   selects the same entry and swaps the roles of the Y+X / Y-X products
//   and the sign of the 2dT product, so each lane reads only its own
//   coordinate of an entry.
// - B's 8 cached multiples sit in shared memory once per block; each lane
//   keeps its coordinate of the 8 multiples of -A in a shared-memory slice
//   of its own. No table lives in registers or local memory, every field
//   function is inlined with its operands by value, and the point formulas
//   need no carry passes (limb bounds below), so ptxas reports no stack.
//
// The field is radix 2^51 (five 64-bit limbs); the walk follows
// native/src/ed25519_verify.cc with signed digits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr u64 MASK51 = (1ULL << 51) - 1;

struct Fe {
  u64 v[5];  // radix-2^51, little-endian limbs, loosely reduced
};

struct U128 {
  u64 lo, hi;
};

__device__ __forceinline__ void mac(U128& acc, u64 a, u64 b) {
  u64 lo = a * b;
  u64 hi = __umul64hi(a, b);
  acc.lo += lo;
  acc.hi += hi + (acc.lo < lo ? 1ULL : 0ULL);
}

__device__ __forceinline__ void add_small(U128& acc, u64 c) {
  acc.lo += c;
  acc.hi += (acc.lo < c ? 1ULL : 0ULL);
}

__device__ __forceinline__ u64 shr51(const U128& x) {
  return (x.lo >> 51) | (x.hi << 13);
}

__device__ __forceinline__ Fe fe_zero() { return Fe{{0, 0, 0, 0, 0}}; }
__device__ __forceinline__ Fe fe_one() { return Fe{{1, 0, 0, 0, 0}}; }

__device__ __forceinline__ Fe fe_add(Fe a, Fe b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = a.v[i] + b.v[i];
  return r;
}

// a - b + 2p: limbs stay non-negative for carry-reduced b
__device__ __forceinline__ Fe fe_sub(Fe a, Fe b) {
  Fe r;
  r.v[0] = a.v[0] + 2 * ((1ULL << 51) - 19) - b.v[0];
#pragma unroll
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + 2 * MASK51 - b.v[i];
  return r;
}

// a - b - c + 4p: limbs stay non-negative when b + c < 4p limb by limb,
// as for two products, or a product and twice one
__device__ __forceinline__ Fe fe_sub2(Fe a, Fe b, Fe c) {
  Fe r;
  r.v[0] = a.v[0] + 4 * ((1ULL << 51) - 19) - b.v[0] - c.v[0];
#pragma unroll
  for (int i = 1; i < 5; i++) r.v[i] = a.v[i] + 4 * MASK51 - b.v[i] - c.v[i];
  return r;
}

// one carry pass: limbs back to ~51 bits (top carry folds x19 into limb 0)
__device__ __forceinline__ Fe fe_carry(Fe r) {
  u64 c;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
  c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
  c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
  c = r.v[4] >> 51; r.v[4] &= MASK51; r.v[0] += c * 19;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  return r;
}

// the five 128-bit column sums of a product -> loosely reduced limbs
__device__ __forceinline__ Fe fe_carry_wide(U128 r0, U128 r1, U128 r2,
                                            U128 r3, U128 r4) {
  Fe out;
  u64 c;
  out.v[0] = r0.lo & MASK51; c = shr51(r0); add_small(r1, c);
  out.v[1] = r1.lo & MASK51; c = shr51(r1); add_small(r2, c);
  out.v[2] = r2.lo & MASK51; c = shr51(r2); add_small(r3, c);
  out.v[3] = r3.lo & MASK51; c = shr51(r3); add_small(r4, c);
  out.v[4] = r4.lo & MASK51; c = shr51(r4);
  out.v[0] += c * 19;
  c = out.v[0] >> 51; out.v[0] &= MASK51; out.v[1] += c;
  return out;
}

// 25 products; limbs above 2^51 wrap to the bottom times 19
__device__ __forceinline__ Fe fe_mul(Fe a, Fe b) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 b0 = b.v[0], b1 = b.v[1], b2 = b.v[2], b3 = b.v[3], b4 = b.v[4];
  const u64 b1_19 = b1 * 19, b2_19 = b2 * 19, b3_19 = b3 * 19,
            b4_19 = b4 * 19;
  U128 r0 = {0, 0}, r1 = {0, 0}, r2 = {0, 0}, r3 = {0, 0}, r4 = {0, 0};
  mac(r0, a0, b0); mac(r0, a1, b4_19); mac(r0, a2, b3_19);
  mac(r0, a3, b2_19); mac(r0, a4, b1_19);
  mac(r1, a0, b1); mac(r1, a1, b0); mac(r1, a2, b4_19);
  mac(r1, a3, b3_19); mac(r1, a4, b2_19);
  mac(r2, a0, b2); mac(r2, a1, b1); mac(r2, a2, b0);
  mac(r2, a3, b4_19); mac(r2, a4, b3_19);
  mac(r3, a0, b3); mac(r3, a1, b2); mac(r3, a2, b1);
  mac(r3, a3, b0); mac(r3, a4, b4_19);
  mac(r4, a0, b4); mac(r4, a1, b3); mac(r4, a2, b2);
  mac(r4, a3, b1); mac(r4, a4, b0);
  return fe_carry_wide(r0, r1, r2, r3, r4);
}

// 15 products: each cross product a_i a_j (i != j) once with one factor
// doubled. The column sums are fe_mul(a, a)'s exactly, so the limbs are
// too.
__device__ __forceinline__ Fe fe_sq(Fe a) {
  const u64 a0 = a.v[0], a1 = a.v[1], a2 = a.v[2], a3 = a.v[3], a4 = a.v[4];
  const u64 d0 = 2 * a0, d1 = 2 * a1, d2 = 2 * a2, d3 = 2 * a3;
  const u64 a3_19 = a3 * 19, a4_19 = a4 * 19;
  U128 r0 = {0, 0}, r1 = {0, 0}, r2 = {0, 0}, r3 = {0, 0}, r4 = {0, 0};
  mac(r0, a0, a0); mac(r0, d1, a4_19); mac(r0, d2, a3_19);
  mac(r1, d0, a1); mac(r1, d2, a4_19); mac(r1, a3, a3_19);
  mac(r2, d0, a2); mac(r2, a1, a1); mac(r2, d3, a4_19);
  mac(r3, d0, a3); mac(r3, d1, a2); mac(r3, a4, a4_19);
  mac(r4, d0, a4); mac(r4, d1, a3); mac(r4, a2, a2);
  return fe_carry_wide(r0, r1, r2, r3, r4);
}

__device__ __forceinline__ Fe fe_sqn(Fe a, int n) {
#pragma unroll 1
  for (int i = 0; i < n; i++) a = fe_sq(a);
  return a;
}

// canonical representative in [0, p), every limb < 2^51
__device__ __forceinline__ Fe fe_freeze(Fe a) {
  Fe r = fe_carry(fe_carry(a));
  // q = 1 iff r >= p, i.e. r + 19 carries out of bit 255
  u64 q = (r.v[0] + 19) >> 51;
  q = (r.v[1] + q) >> 51;
  q = (r.v[2] + q) >> 51;
  q = (r.v[3] + q) >> 51;
  q = (r.v[4] + q) >> 51;
  r.v[0] += 19 * q;
  u64 c;
  c = r.v[0] >> 51; r.v[0] &= MASK51; r.v[1] += c;
  c = r.v[1] >> 51; r.v[1] &= MASK51; r.v[2] += c;
  c = r.v[2] >> 51; r.v[2] &= MASK51; r.v[3] += c;
  c = r.v[3] >> 51; r.v[3] &= MASK51; r.v[4] += c;
  r.v[4] &= MASK51;  // drops q * 2^255
  return r;
}

__device__ __forceinline__ bool fe_is_zero(Fe a) {
  Fe f = fe_freeze(a);
  return (f.v[0] | f.v[1] | f.v[2] | f.v[3] | f.v[4]) == 0;
}

__device__ __forceinline__ bool fe_eq(Fe a, Fe b) {
  return fe_is_zero(fe_sub(a, b));
}

__device__ __forceinline__ Fe fe_neg(Fe a) { return fe_sub(fe_zero(), a); }

__device__ __forceinline__ int fe_parity(Fe a) {
  return (int)(fe_freeze(a).v[0] & 1);
}

// 8 LE u32 words -> limbs; bit 255 dropped (value < 2^255, maybe >= p)
__device__ __forceinline__ Fe fe_from_words(const uint32_t w[8]) {
  u64 q0 = (u64)w[0] | ((u64)w[1] << 32);
  u64 q1 = (u64)w[2] | ((u64)w[3] << 32);
  u64 q2 = (u64)w[4] | ((u64)w[5] << 32);
  u64 q3 = ((u64)w[6] | ((u64)w[7] << 32)) & 0x7FFFFFFFFFFFFFFFULL;
  Fe r;
  r.v[0] = q0 & MASK51;
  r.v[1] = ((q0 >> 51) | (q1 << 13)) & MASK51;
  r.v[2] = ((q1 >> 38) | (q2 << 26)) & MASK51;
  r.v[3] = ((q2 >> 25) | (q3 << 39)) & MASK51;
  r.v[4] = q3 >> 12;
  return r;
}

// canonical limbs -> 8 LE u32 words
__device__ __forceinline__ void fe_to_words(Fe a, uint32_t w[8]) {
  Fe f = fe_freeze(a);
  u64 q0 = f.v[0] | (f.v[1] << 51);
  u64 q1 = (f.v[1] >> 13) | (f.v[2] << 38);
  u64 q2 = (f.v[2] >> 26) | (f.v[3] << 25);
  u64 q3 = (f.v[3] >> 39) | (f.v[4] << 12);
  w[0] = (uint32_t)q0; w[1] = (uint32_t)(q0 >> 32);
  w[2] = (uint32_t)q1; w[3] = (uint32_t)(q1 >> 32);
  w[4] = (uint32_t)q2; w[5] = (uint32_t)(q2 >> 32);
  w[6] = (uint32_t)q3; w[7] = (uint32_t)(q3 >> 32);
}

// (a^(2^250 - 1), a^11): the core of the curve25519 addition chains
__device__ __forceinline__ void chain_250(Fe a, Fe* z250, Fe* z11) {
  Fe z2 = fe_sq(a);
  Fe z9 = fe_mul(fe_sqn(z2, 2), a);
  *z11 = fe_mul(z9, z2);
  Fe z5 = fe_mul(fe_sq(*z11), z9);
  Fe z10 = fe_mul(fe_sqn(z5, 5), z5);
  Fe z20 = fe_mul(fe_sqn(z10, 10), z10);
  Fe z40 = fe_mul(fe_sqn(z20, 20), z20);
  Fe z50 = fe_mul(fe_sqn(z40, 10), z10);
  Fe z100 = fe_mul(fe_sqn(z50, 50), z50);
  Fe z200 = fe_mul(fe_sqn(z100, 100), z100);
  *z250 = fe_mul(fe_sqn(z200, 50), z50);
}

__device__ __forceinline__ Fe fe_invert(Fe a) {  // a^(p-2)
  Fe z250, z11;
  chain_250(a, &z250, &z11);
  return fe_mul(fe_sqn(z250, 5), z11);
}

__device__ __forceinline__ Fe fe_pow_p58(Fe a) {  // a^((p-5)/8)
  Fe z250, z11;
  chain_250(a, &z250, &z11);
  return fe_mul(fe_sqn(z250, 2), a);
}

// curve constants (radix-2^51 limbs of d, 2d, sqrt(-1))
__constant__ u64 C_D[5] = {929955233495203ULL, 466365720129213ULL,
                           1662059464998953ULL, 2033849074728123ULL,
                           1442794654840575ULL};
__constant__ u64 C_D2[5] = {1859910466990425ULL, 932731440258426ULL,
                            1072319116312658ULL, 1815898335770999ULL,
                            633789495995903ULL};
__constant__ u64 C_SQRTM1[5] = {1718705420411056ULL, 234908883556509ULL,
                                2233514472574048ULL, 2117202627021982ULL,
                                765476049583133ULL};

__device__ __forceinline__ Fe load_const(const u64* c) {
  return Fe{{c[0], c[1], c[2], c[3], c[4]}};
}

// a field element in column col of a limb-major [5][N] table (shared
// memory, one column a signature)
template <int N>
__device__ __forceinline__ void put_fe(u64 (*dst)[N], int col, Fe a) {
#pragma unroll
  for (int l = 0; l < 5; l++) dst[l][col] = a.v[l];
}

template <int N>
__device__ __forceinline__ Fe get_fe(const u64 (*src)[N], int col) {
  Fe a;
#pragma unroll
  for (int l = 0; l < 5; l++) a.v[l] = src[l][col];
  return a;
}

// decode an encoded point the way the JAX package does: y mod p, x from
// the curve equation, reject non-residues and x = 0 with the sign bit.
// -> false, or true with the affine x and y in xs[.][col], ys[.][col].
// y and u*v^3 wait in those slots across the exponentiation, and u and v
// are recomputed after it, so that few values stay live in registers.
template <int N>
__device__ __forceinline__ bool ge_decode(const uint32_t w[8],
                                          u64 (*xs)[N], u64 (*ys)[N],
                                          int col) {
  int sign = (int)(w[7] >> 31);
  Fe y = fe_from_words(w);
  put_fe(ys, col, y);
  Fe y2 = fe_sq(y);
  Fe u = fe_carry(fe_sub(y2, fe_one()));
  Fe v = fe_carry(fe_add(fe_mul(y2, load_const(C_D)), fe_one()));
  Fe v3 = fe_mul(fe_sq(v), v);
  Fe uv3 = fe_mul(u, v3);
  put_fe(xs, col, uv3);
  Fe x = fe_pow_p58(fe_mul(fe_mul(uv3, v3), v));  // (u v^7)^((p-5)/8)
  // a compiler barrier: reload the slots rather than keep their values
  // (and what was derived from them) live across the exponentiation
  asm volatile("" ::: "memory");
  x = fe_mul(get_fe<N>(xs, col), x);
  y2 = fe_sq(get_fe<N>(ys, col));
  u = fe_carry(fe_sub(y2, fe_one()));
  v = fe_carry(fe_add(fe_mul(y2, load_const(C_D)), fe_one()));
  Fe vxx = fe_mul(v, fe_sq(x));
  if (!fe_eq(vxx, u)) {
    if (!fe_eq(vxx, fe_neg(u))) return false;  // not on the curve
    x = fe_mul(x, load_const(C_SQRTM1));
  }
  if (fe_is_zero(x)) {
    if (sign) return false;
  } else if (fe_parity(x) != sign) {
    x = fe_neg(x);
  }
  put_fe(xs, col, fe_carry(x));
  return true;
}

// --------------------------------------------------------------------------
// the lane group: G lanes a signature, lane k holding coordinate k
//
// Limb bounds in the walk: every coordinate of the running point and every
// stage-1 product comes out of fe_mul or fe_sq, so its limbs are below
// 2^51 + 2^12; the sums and differences formed from them below stay under
// 2^54, which fe_mul and fe_sq take as inputs without overflow (column
// sums under 2^115). So the point formulas need no carry passes.

constexpr int G = 4;      // lanes a signature, one a coordinate
constexpr int SIGS = 32;  // signatures a block
constexpr int THREADS = SIGS * G;
// a block's 48.7 KB of shared memory lets 4 blocks share an SM, enough to
// hold a 16,384-signature chunk (512 blocks on 132 SMs) in one wave
constexpr int MIN_BLOCKS = 4;

struct Group {
  int lane;       // 0..G-1
  unsigned mask;  // the group's own lanes within the warp
};

// A point in extended coordinates (X, Y, Z, T), a cached entry
// (Y+X, Y-X, 2Z, 2dT), or the four products of a stage is one Fe a lane:
// lane k holds coordinate k.

// coordinate k of v, from lane k of the group; every lane of the group
// must call it
__device__ __forceinline__ Fe take(Fe v, int k, const Group& g) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 5; i++) r.v[i] = __shfl_sync(g.mask, v.v[i], k, G);
  return r;
}

// the second stage of both formulas: coordinate k of (E*F, G*H, F*G, E*H)
__device__ __forceinline__ Fe ge_finish(Fe e, Fe f, Fe gg, Fe h,
                                        const Group& g) {
  const int k = g.lane;
  return fe_mul(k == 0 || k == 3 ? e : (k == 1 ? gg : f),
                k == 0 ? f : (k == 2 ? gg : h));
}

// p = 2p (dbl-2008-hwcd, a = -1): X^2, Y^2, Z^2, (X+Y)^2, then ge_finish
__device__ __forceinline__ void ge_double(Fe& p, const Group& g) {
  Fe x = take(p, 0, g), y = take(p, 1, g);
  Fe s = fe_sq(g.lane == 3 ? fe_add(x, y) : p);
  Fe a = take(s, 0, g), b = take(s, 1, g), zz = take(s, 2, g),
     xy2 = take(s, 3, g);
  Fe e = fe_sub2(xy2, a, b);                  // E = (X+Y)^2 - A - B
  Fe gg = fe_sub(b, a);                       // G = aA + B = B - A
  Fe f = fe_sub2(b, a, fe_add(zz, zz));       // F = G - 2Z^2
  Fe h = fe_sub2(fe_zero(), a, b);            // H = aA - B = -A - B
  p = ge_finish(e, f, gg, h, g);
}

// p += q, or p -= q when neg (add-2008-hwcd-3, a = -1), q cached. Lane k
// multiplies by its own coordinate of q: -q is (Y-X, Y+X, 2Z, -2dT), so a
// negative digit swaps which of lanes 0 and 1 takes Y+X and which Y-X,
// and flips the sign of the 2dT product where it is used.
__device__ __forceinline__ void ge_add(Fe& p, Fe q, bool neg,
                                       const Group& g) {
  Fe x = take(p, 0, g), y = take(p, 1, g);
  const int k = g.lane;
  Fe m = fe_mul(k >= 2 ? p : ((k == 0) != neg ? fe_add(y, x) : fe_sub(y, x)),
                q);
  // m = (B, A, D, C) for +q and (A, B, D, -C) for -q
  Fe m0 = take(m, 0, g), m1 = take(m, 1, g), d = take(m, 2, g),
     c = take(m, 3, g);
  Fe e = neg ? fe_sub(m1, m0) : fe_sub(m0, m1);  // E = B - A
  Fe h = fe_add(m0, m1);                         // H = B + A
  Fe f = neg ? fe_add(d, c) : fe_sub(d, c);      // F = D - C
  Fe gg = neg ? fe_sub(d, c) : fe_add(d, c);     // G = D + C
  p = ge_finish(e, f, gg, h, g);
}

// the cached form (Y+X, Y-X, 2Z, 2dT) of p, lane k's coordinate k
__device__ __forceinline__ Fe ge_cached(Fe p, const Group& g) {
  Fe x = take(p, 0, g), y = take(p, 1, g);
  const int k = g.lane;
  return k == 0   ? fe_add(y, x)
         : k == 1 ? fe_sub(y, x)
         : k == 2 ? fe_add(p, p)
                  : fe_mul(p, load_const(C_D2));
}

// scalar < 2^253 -> its signed radix-16 digits in [-8, 7], in place: add
// 8 to every nibble (the digits of s + 0x88..8 are those of s plus 8, and
// s + 0x88..8 < 2^256); next_digit subtracts it again
__device__ __forceinline__ void recode(uint32_t w[8]) {
  u64 c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    u64 t = (u64)w[k] + 0x88888888ULL + c;
    w[k] = (uint32_t)t;
    c = t >> 32;
  }
}

// the most significant remaining digit; shifts the words left a nibble
__device__ __forceinline__ int next_digit(uint32_t w[8]) {
  int d = (int)(w[7] >> 28) - 8;
#pragma unroll
  for (int k = 7; k > 0; k--) w[k] = (w[k] << 4) | (w[k - 1] >> 28);
  w[0] <<= 4;
  return d;
}

// y (sign bit masked) of 8 LE u32 words is below p = 2^255 - 19
__device__ __forceinline__ bool words_lt_p(const uint32_t w[8]) {
  if ((w[7] & 0x7FFFFFFFu) != 0x7FFFFFFFu) return true;
#pragma unroll
  for (int k = 6; k > 0; k--)
    if (w[k] != 0xFFFFFFFFu) return true;
  return w[0] < 0xFFFFFFEDu;
}

// Three phases a block, 32 signatures each, split by __syncthreads (no
// thread leaves before the last): the first warp decodes A, one thread a
// signature; every group builds its table of -A and walks; the first warp
// makes the final check, one thread a signature: in bytes mode it inverts
// Z, encodes and compares; in point mode it decodes R into a_xy (dead
// once phase 2 has built the tables: a slot of its own would pass the
// 48 KB of static shared memory) and compares projectively. The
// exponentiations thus run once a signature, not once a lane.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ed25519_verify_kernel(const uint32_t* __restrict__ a_words,
                      const uint32_t* __restrict__ r_words,
                      const uint32_t* __restrict__ s_words,
                      const uint32_t* __restrict__ h_words,
                      const uint8_t* __restrict__ s_canonical,
                      const u64* __restrict__ base_table,
                      uint8_t* __restrict__ out, int n, int point_check,
                      int* __restrict__ count) {
  // B's cached multiples 1..8 as (Y+X, Y-X, 2Z, 2dT), for the whole block
  __shared__ u64 btab[8][4][5];
  // each lane's coordinate of -A's cached multiples 1..8, by thread so a
  // warp's accesses fall in distinct banks
  __shared__ u64 ntab[8][5][THREADS];
  __shared__ u64 a_xy[2][5][SIGS];  // A's affine x and y, from the decode
  __shared__ u64 q_xyz[3][5][SIGS];  // the walk's X, Y, Z
  __shared__ bool ok[SIGS];          // S canonical and A decoded
  // base_table's rows are (Y+X, Y-X, 2dT, 2Z), multiples 1..15
  for (int i = threadIdx.x; i < 8 * 4 * 5; i += THREADS) {
    int r = i / 20, c = (i / 5) % 4, l = i % 5;
    btab[r][c][l] = base_table[(r * 4 + (c < 2 ? c : 5 - c)) * 5 + l];
  }
  const int t = threadIdx.x;
  if (t < SIGS) {
    const int idx = blockIdx.x * SIGS + t;
    bool good = false;
    if (idx < n && s_canonical[idx]) {
      uint32_t aw[8];
#pragma unroll
      for (int k = 0; k < 8; k++) aw[k] = a_words[8 * idx + k];
      good = ge_decode(aw, a_xy[0], a_xy[1], t);
    }
    ok[t] = good;
  }
  __syncthreads();

  const int sig = t / G;
  if (ok[sig]) {
    const int idx = blockIdx.x * SIGS + sig;
    Group g;
    g.lane = t % G;
    g.mask = ((1u << G) - 1) << ((t % 32) & ~(G - 1));
    // -A = (-x, y, 1, -xy); its cached multiples 1..8 into ntab
    auto put = [&](int e, Fe p) { put_fe(ntab[e], t, ge_cached(p, g)); };
    auto get = [&](int e) { return get_fe(ntab[e], t); };
    Fe nx = fe_carry(fe_neg(get_fe(a_xy[0], sig))), ay = get_fe(a_xy[1], sig);
    Fe p = g.lane == 0   ? nx
           : g.lane == 1 ? ay
           : g.lane == 2 ? fe_one()
                         : fe_mul(nx, ay);
    Fe q;
    // entry e holds (e+1)(-A); at most two multiples live at a time
    put(0, p);
    ge_double(p, g); put(1, p);                 // 2
    q = p; ge_add(q, get(0), false, g); put(2, q);  // 3
    ge_double(p, g); put(3, p);                 // 4
    ge_double(q, g); put(5, q);                 // 6
    ge_add(q, get(0), false, g); put(6, q);     // 7
    q = p; ge_add(q, get(0), false, g); put(4, q);  // 5
    ge_double(p, g); put(7, p);                 // 8

    uint32_t sd[8], hd[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      sd[k] = s_words[8 * idx + k];
      hd[k] = h_words[8 * idx + k];
    }
    recode(sd);
    recode(hd);

    // Straus: R' = [s]B + [h](-A), MSB-first signed 4-bit digits
    p = (g.lane == 1 || g.lane == 2) ? fe_one() : fe_zero();
#pragma unroll 1
    for (int i = 0; i < 64; i++) {
#pragma unroll 1
      for (int d = 0; d < 4; d++) ge_double(p, g);
      int ds = next_digit(sd), dh = next_digit(hd);
      if (ds != 0) {
        const u64* e = btab[(ds < 0 ? -ds : ds) - 1][g.lane];
        ge_add(p, Fe{{e[0], e[1], e[2], e[3], e[4]}}, ds < 0, g);
      }
      if (dh != 0) ge_add(p, get((dh < 0 ? -dh : dh) - 1), dh < 0, g);
    }
    if (g.lane < 3) put_fe(q_xyz[g.lane], sig, p);
  }
  __syncthreads();

  // the final check against R; the whole first warp takes part (SIGS is
  // a warp), so that its ballot may count the block's accepted lanes
  if (t < SIGS) {
    const int idx = blockIdx.x * SIGS + t;
    bool eq = false;
    if (idx < n && ok[t]) {
      uint32_t rw[8];
#pragma unroll
      for (int k = 0; k < 8; k++) rw[k] = r_words[8 * idx + k];
      if (point_check) {
        if (words_lt_p(rw) && ge_decode(rw, a_xy[0], a_xy[1], t)) {
          Fe z = get_fe(q_xyz[2], t);
          eq = fe_eq(get_fe(q_xyz[0], t), fe_mul(get_fe(a_xy[0], t), z)) &&
               fe_eq(get_fe(q_xyz[1], t), fe_mul(get_fe(a_xy[1], t), z));
        }
      } else {
        Fe zi = fe_invert(get_fe(q_xyz[2], t));
        uint32_t enc[8];
        fe_to_words(fe_mul(get_fe(q_xyz[1], t), zi), enc);
        enc[7] |= (uint32_t)fe_parity(fe_mul(get_fe(q_xyz[0], t), zi)) << 31;
        eq = true;
#pragma unroll
        for (int k = 0; k < 8; k++) eq = eq && (enc[k] == rw[k]);
      }
    }
    if (idx < n) out[idx] = eq ? 1 : 0;
    if (count != nullptr) {
      const unsigned accepted = __ballot_sync(0xFFFFFFFFu, eq);
      if (t == 0 && accepted != 0u) atomicAdd(count, (int)__popc(accepted));
    }
  }
}

}  // namespace

// point_check: 0 for the bytes final check, 1 for the point one; count:
// a device int that the accepted signatures are added to, or null
extern "C" int ed25519_verify_launch(const void* a_words, const void* r_words,
                                     const void* s_bytes, const void* h_bytes,
                                     const void* s_canonical,
                                     const void* base_table, void* out, int n,
                                     int point_check, void* count,
                                     void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + SIGS - 1) / SIGS;
  ed25519_verify_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a_words, (const uint32_t*)r_words,
      (const uint32_t*)s_bytes, (const uint32_t*)h_bytes,
      (const uint8_t*)s_canonical, (const u64*)base_table, (uint8_t*)out, n,
      point_check, (int*)count);
  return (int)cudaGetLastError();
}
