"""K1's own CUDA source, run on the CPU; and K1's bound count.

The text of ``csrc/ed25519_verify.cu`` up to its ``extern "C"`` launcher
is compiled as C++20 by ``g++`` against the shim below (a stand-in
``cuda_runtime.h``): ``__device__`` and friends are defined away,
``__shared__`` becomes block-shared static storage, ``__umul64hi`` goes
through ``__int128``, and each block's threads run as host threads, with
``__syncthreads`` and the lane group's shuffle backed by barriers. A
shuffle whose partner lane has left deadlocks there as it would misbehave
on the card, so the binary runs under its own timeout; a shuffle with a
mask or width other than its group's own lanes aborts.

The kernel's verdicts are held to the plain version (``verify_kernel_ref``)
and the RFC 8032 oracle on three batches: the adversarial corpus and
random signed lanes, with an early-exit lane (S >= l or an undecodable
key) in every warp, filling neither its last warp nor its last block;
one signature, so that 31 of its block's 32 groups lie past the batch;
and lanes that all exit early, so that no group of a block walks.

``test_k1_ops_counts_by_hand`` checks ``chip_smoke.k1_ops`` against a
count worked out by hand.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from stellard_tpu_torch.ops import ed25519_cuda as K1
from stellard_tpu_torch.ops import ed25519_ref as ref
from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref
from stellard_tpu_torch.ops.ed25519_cases import adversarial_cases

SRC = Path(__file__).resolve().parent.parent / "stellard_tpu_torch" / "csrc" / "ed25519_verify.cu"
RUN_TIMEOUT_S = 120

SHIM = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)

struct dim3 { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;

inline unsigned long long __umul64hi(unsigned long long a, unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}

// one block at a time: its barrier and its lane groups' mailboxes; the
// group width is the kernel's (main() sets it)
inline int shim_lanes;
struct ShimGroup {
  std::barrier<> bar{shim_lanes};
  unsigned long long slot[2][32];
  int phase[32] = {};
};
inline std::unique_ptr<std::barrier<>> shim_block_bar;
inline std::vector<std::unique_ptr<ShimGroup>> shim_groups;

inline void __syncthreads() { shim_block_bar->arrive_and_wait(); }

// the group shuffle: write, wait for the group's lanes, read; two slots
// alternate, so one barrier a shuffle suffices
template <class T>
T __shfl_sync(unsigned mask, T v, int src, int width) {
  const unsigned w = shim_lanes, t = threadIdx.x;
  if (width != (int)w || mask != (((1u << w) - 1) << ((t % 32) & ~(w - 1)))) {
    std::fprintf(stderr, "shuffle by thread %u: mask %x width %d\n", t, mask, width);
    std::abort();
  }
  ShimGroup& g = *shim_groups[t / w];
  int me = t % w, ph = g.phase[me];
  g.phase[me] ^= 1;
  g.slot[ph][me] = (unsigned long long)v;
  g.bar.arrive_and_wait();
  return (T)g.slot[ph][src % w];
}
"""

# stdin: n, then a/r words, s/h bytes, s_canonical, the [15,4,5] u64
# table; stdout: n verdict characters
MAIN = r"""
#include <iostream>
#include <iterator>

int main() {
  std::vector<char> in((std::istreambuf_iterator<char>(std::cin)), {});
  const char* p = in.data();
  int n;
  std::memcpy(&n, p, 4); p += 4;
  auto take = [&](size_t bytes) { const char* q = p; p += bytes; return q; };
  const uint32_t* aw = (const uint32_t*)take(32 * n);
  const uint32_t* rw = (const uint32_t*)take(32 * n);
  const uint32_t* sw = (const uint32_t*)take(32 * n);
  const uint32_t* hw = (const uint32_t*)take(32 * n);
  const uint8_t* sc = (const uint8_t*)take(n);
  const u64* tab = (const u64*)take(15 * 4 * 5 * 8);
  std::vector<uint8_t> out(n, 2);
  blockDim.x = THREADS;
  shim_lanes = G;
  for (int b = 0; b * SIGS < n; b++) {
    blockIdx.x = b;
    shim_block_bar = std::make_unique<std::barrier<>>(THREADS);
    shim_groups.clear();
    for (int i = 0; i < THREADS / G; i++) shim_groups.push_back(std::make_unique<ShimGroup>());
    std::vector<std::thread> threads;
    for (int t = 0; t < THREADS; t++)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        ed25519_verify_kernel(aw, rw, sw, hw, sc, tab, out.data(), n);
      });
    for (auto& th : threads) th.join();
  }
  for (int i = 0; i < n; i++) std::putchar('0' + out[i]);
  return 0;
}
"""


def _compile(tmp: Path) -> Path:
    """g++ on the kernel's text up to its launcher, with the shim and MAIN."""
    text = SRC.read_text()
    cut = text.index('extern "C"')
    (tmp / "cuda_runtime.h").write_text(SHIM)
    src = tmp / "k1.cc"
    src.write_text("#include <cstring>\n" + text[:cut] + MAIN)
    binary = tmp / "k1"
    run = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-pthread", f"-I{tmp}", "-o", str(binary), str(src)],
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, f"g++ failed:\n{run.stdout}{run.stderr}"
    return binary


def _undecodable_key(rng) -> bytes:
    while True:
        k = rng.bytes(32)
        if ref.pt_decompress(k) is None:
            return k


def _lanes():
    """The corpus and 60 random signed lanes, with an early-exit lane
    inserted at position 5 of every eight (one warp at four lanes a
    signature): 108 signatures."""
    rng = np.random.default_rng(23)
    cases = [(p, m, s) for _, p, m, s in adversarial_cases(seed=11)]
    for _ in range(60):
        sk = rng.bytes(32)
        pk = ref.derive_public(sk)
        m = rng.bytes(32)
        sig = bytearray(ref.sign(sk, pk, m))
        if rng.random() < 0.3:
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        cases.append((pk, m, bytes(sig)))
    out = []
    for p, m, s in cases:
        if len(out) % 8 == 5:
            pk, mm, good = cases[len(out) % 20 + 14]
            if len(out) % 16 == 5:  # S + l: not canonical
                v = int.from_bytes(good[32:], "little") + ref.L
                out.append((pk, mm, good[:32] + v.to_bytes(32, "little")))
            else:
                out.append((_undecodable_key(rng), mm, good))
        out.append((p, m, s))
    return out


def _signed(rng):
    sk = rng.bytes(32)
    pk = ref.derive_public(sk)
    m = rng.bytes(32)
    return pk, m, ref.sign(sk, pk, m)


def _batch(kind: str):
    if kind == "mixed":
        return _lanes()
    rng = np.random.default_rng(29)
    if kind == "one":
        return [_signed(rng)]
    out = []  # "early": 37 lanes, S + l or an undecodable key each
    for i in range(37):
        pk, m, sig = _signed(rng)
        if i % 2:
            out.append((_undecodable_key(rng), m, sig))
        else:
            v = int.from_bytes(sig[32:], "little") + ref.L
            out.append((pk, m, sig[:32] + v.to_bytes(32, "little")))
    return out


@pytest.fixture(scope="module")
def k1_binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: K1's source cannot be compiled on the host")
    return _compile(tmp_path_factory.mktemp("k1_host"))


@pytest.mark.parametrize("kind", ["mixed", "one", "early"])
def test_kernel_source_matches_plain_and_oracle(k1_binary, kind):
    lanes_in = _batch(kind)
    n = len(lanes_in)
    pubs, msgs, sigs = (list(t) for t in zip(*lanes_in))
    batch = prepare_batch(pubs, msgs, sigs)
    early = ~batch["s_canonical"] | np.array([ref.pt_decompress(p) is None for p in pubs])
    if kind == "mixed":
        assert n % 8 and n % 32
        assert early.reshape(-1)[: n // 8 * 8].reshape(-1, 8).any(axis=1).all()
    assert early.all() == (kind == "early")

    blob = np.int32(n).tobytes() + b"".join(
        np.ascontiguousarray(batch[k]).tobytes()
        for k in ("a_words", "r_words", "s_bytes", "h_bytes")
    ) + batch["s_canonical"].astype(np.uint8).tobytes() + K1.base_table_np().tobytes()
    run = subprocess.run([str(k1_binary)], input=blob, capture_output=True,
                         timeout=RUN_TIMEOUT_S)
    assert run.returncode == 0, run.stderr.decode()
    got = np.frombuffer(run.stdout, np.uint8) - ord("0")
    assert got.shape == (n,) and set(got.tolist()) <= {0, 1}

    plain = verify_kernel_ref(**to_tensors(batch, "cpu")).numpy()
    oracle = np.array([ref.verify(p, m, s) for p, m, s in lanes_in])
    assert np.array_equal(got.astype(bool), plain)
    assert np.array_equal(got.astype(bool), oracle)
    if kind == "mixed":
        assert 0 < oracle.sum() < n
    else:
        assert oracle.sum() == (kind == "one")


def test_k1_ops_counts_by_hand():
    """Four lanes: S not canonical (nothing counted); an undecodable key
    (the decode only); and two decoding lanes whose scalars make the
    unsigned nibbles win once and the signed digits once. Per scalar the
    count takes the fewer nonzero digits of the two forms."""
    assert (chip_smoke.FE_MUL_OPS, chip_smoke.FE_SQ_OPS) == (128, 72)
    decode = 19 * 128 + 255 * 72      # 20,792
    table = 48 * 128 + 16 * 72        # 4 doublings, 3 additions, 8 cached
    walk = 1024 * 128 + 1024 * 72     # 256 doublings
    encode = 13 * 128 + 254 * 72      # inversion, x and y
    add = 8 * 128

    def scalar(v):
        return np.frombuffer(v.to_bytes(32, "little"), np.uint8)

    rng = np.random.default_rng(0)
    good = ref.derive_public(bytes(32))
    batch = {
        "a_words": np.frombuffer(good * 2 + _undecodable_key(rng) + good, "<u4")
        .reshape(4, 8),
        "s_canonical": np.array([True, True, True, False]),
        # lane 0: S = 0xFFFF has 4 nonzero nibbles, signed digits
        #   (-1, 0, 0, 0, 1): 2; h = 0x0F0F: nibbles 2, digits
        #   (-1, 1, -1, 1): 4. Lane 1: S = 0x1234: 4 and 4; h = 0: 0.
        "s_bytes": np.stack([scalar(0xFFFF), scalar(0x1234), scalar(5), scalar(5)]),
        "h_bytes": np.stack([scalar(0x0F0F), scalar(0), scalar(5), scalar(5)]),
    }
    want = 3 * decode + 2 * (table + walk + encode) + (2 + 2 + 4 + 0) * add
    assert chip_smoke.k1_ops(batch) == want == 3 * 20792 + 2 * 232_048 + 8 * 1024
