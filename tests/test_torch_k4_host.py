"""K4's own CUDA source (``csrc/path_quality.cu``), run on the CPU.

The text of the source up to its ``extern "C"`` launcher is compiled by
``g++`` against test_torch_k1_host's CUDA shim (``__device__`` and
friends defined away, ``uint4`` a 16-byte struct); each block's threads
run one after another on the host. The kernel's composites are held to
``path_quality_host`` on a batch that fills neither its last warp nor
its last block, on one row, on an empty batch, and on rows of a width
that is not a multiple of four (the word-at-a-time path). Tolerance:
zero.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from stellard_tpu_torch.ops.pathq import Q16_MAX, Q16_ONE, path_quality_host
from test_torch_k1_host import SHIM

SRC = Path(__file__).resolve().parent.parent / "stellard_tpu_torch" / "csrc" / "path_quality.cu"

# stdin: n, hops, vec4, then n*hops u32; stdout: n u32 composites
MAIN = r"""
#include <cstring>
#include <iostream>
#include <iterator>

int main() {
  std::vector<char> in((std::istreambuf_iterator<char>(std::cin)), {});
  int hdr[3];
  std::memcpy(hdr, in.data(), sizeof hdr);
  const int n = hdr[0], hops = hdr[1], vec4 = hdr[2];
  std::vector<uint4> rows((size_t)n * hops / 4 + 1);  // 16-byte aligned
  std::memcpy(rows.data(), in.data() + sizeof hdr, (size_t)n * hops * 4);
  std::vector<uint32_t> out(n, 0xDEADBEEFu);
  blockDim.x = THREADS;
  for (int b = 0; b * THREADS < n || (n == 0 && b == 0); b++) {
    blockIdx.x = b;
    for (unsigned t = 0; t < THREADS; t++) {
      threadIdx.x = t;
      path_quality_kernel((const uint32_t*)rows.data(), out.data(), n, hops, vec4);
    }
  }
  std::fwrite(out.data(), 4, n, stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def k4_binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: K4's source cannot be compiled on the host")
    tmp = tmp_path_factory.mktemp("k4_host")
    text = SRC.read_text()
    (tmp / "cuda_runtime.h").write_text(SHIM)
    src = tmp / "k4.cc"
    src.write_text(text[: text.index('extern "C"')] + MAIN)
    binary = tmp / "k4"
    run = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-pthread", f"-I{tmp}", "-o", str(binary), str(src)],
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, f"g++ failed:\n{run.stdout}{run.stderr}"
    return binary


def _run(binary, rates: np.ndarray, vec4: int) -> np.ndarray:
    n, hops = rates.shape
    stdin = np.array([n, hops, vec4], np.int32).tobytes() + rates.astype("<u4").tobytes()
    r = subprocess.run([str(binary)], input=stdin, capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return np.frombuffer(r.stdout, "<u4")


def _rates(n: int, hops: int, seed: int) -> np.ndarray:
    """Random u32 rows, with identity rows, saturating rows and rows of
    rates near 1.0 (the book phase's shape) mixed in."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 2**32, (n, hops), dtype=np.uint64).astype(np.uint32)
    r[::7] = Q16_ONE
    r[3::11] = Q16_MAX
    near = rng.integers(Q16_ONE - 3000, Q16_ONE + 3000, (n, hops), dtype=np.int64)
    r[5::4] = near[5::4].astype(np.uint32)
    return r


@pytest.mark.parametrize("n,hops,vec4", [
    (300, 8, 1),   # 256 + 44: neither the last warp nor the last block is full
    (300, 8, 0),
    (1, 8, 1),
    (0, 8, 1),
    (77, 3, 0),    # width not a multiple of four: one word at a time
    (33, 12, 1),
])
def test_kernel_source_matches_host_arm(k4_binary, n, hops, vec4):
    rates = _rates(n, hops, seed=n + hops)
    got = _run(k4_binary, rates, vec4)
    assert got.shape == (n,)
    np.testing.assert_array_equal(got, path_quality_host(rates))
    if n > 20:
        assert (got == Q16_MAX).any() and (got < Q16_MAX).any()
