"""The port's two final-check modes (STELLARD_VERIFY_CHECK=bytes|point),
twin of tests/test_verify_check_modes.py.

``ops/ed25519.py`` reads the knob once at import, as the JAX package's
``ed25519_jax.py`` does, so each mode runs in a subprocess. In ``point``
mode the plain version (and K1's wrapper on CPU tensors, and the
verifier over four CPU shards) gives the oracle's verdicts on the
JAX test's corpus and on ``ops/ed25519_cases.py``'s, equal to ``bytes``
mode's, the small-order forgery (which ref10 accepts) accepted; any
other value raises the JAX package's error. One slow case holds the
port's point mode to the JAX XLA kernel's.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent

# the corpora and their verdicts under the mode the environment sets
_RUNNER = r'''
import os, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
import numpy as np
import torch
from stellard_tpu_torch.crypto.backend import CudaVerifier, VerifyRequest
from stellard_tpu_torch.ops import ed25519 as E
from stellard_tpu_torch.ops import ed25519_cuda as K1
from stellard_tpu_torch.ops import ed25519_ref as ref
from stellard_tpu_torch.ops.ed25519_cases import adversarial_cases
from test_torch_ed25519 import _check_modes_corpus

mode = os.environ.get("STELLARD_VERIFY_CHECK", "bytes")
assert E.VERIFY_CHECK == mode
kinds, cp, cm, cs = (list(t) for t in zip(*adversarial_cases(seed=11, n_random=12)))
corpora = {"check_modes": _check_modes_corpus(), "cases": (cp, cm, cs)}
for name, (pubs, msgs, sigs) in corpora.items():
    oracle = np.array([len(m) == 32 and ref.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)])
    t = E.to_tensors(E.prepare_batch(pubs, msgs, sigs), "cpu")
    count = torch.zeros(1, dtype=torch.int32)
    got = K1.verify(**t, count=count).numpy()   # the process's mode
    other = E.verify_kernel_ref(**t, check="bytes" if mode == "point" else "point").numpy()
    shards = CudaVerifier(mesh="4", device="cpu", devices=["cpu"] * 4).verify_batch(
        [VerifyRequest(*x) for x in zip(pubs, msgs, sigs)])
    assert np.array_equal(got, oracle), (name, mode, np.nonzero(got != oracle)[0].tolist())
    assert np.array_equal(got, other), (name, "modes differ")
    assert np.array_equal(shards, oracle), (name, "four shards")
    assert int(count) == int(oracle.sum())
    ident = (1).to_bytes(32, "little")
    forged = [i for i, (p, s) in enumerate(zip(pubs, sigs)) if p == ident and s == ident + bytes(32)]
    assert forged and got[forged].all(), "the small-order forgery is accepted"
    print("OK", mode, name, len(pubs), int(oracle.sum()))
'''


def _run(env_mode, code: str = _RUNNER):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.pop("STELLARD_VERIFY_CHECK", None)
    if env_mode is not None:
        env["STELLARD_VERIFY_CHECK"] = env_mode
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, "-u", "-c", code % {"repo": str(REPO), "tests": str(TESTS)}],
        env=env, capture_output=True, text=True, timeout=600, cwd=str(REPO),
    )


@pytest.mark.parametrize("mode", [None, "bytes", "point"])
def test_mode_matches_oracle_and_the_other_mode(mode):
    r = _run(mode)
    assert r.returncode == 0, (mode, r.stdout[-2000:], r.stderr[-3000:])
    want = mode or "bytes"
    assert f"OK {want} check_modes 32" in r.stdout and f"OK {want} cases" in r.stdout


def test_any_other_value_raises_the_jax_packages_error():
    """The port and the JAX package refuse an unknown mode at import with
    the same message."""
    code = ("import sys\nsys.path.insert(0, %(repo)r)\n"
            "import {mod}\n")
    msgs = []
    for mod in ("stellard_tpu_torch.ops.ed25519", "stellard_tpu.ops.ed25519_jax"):
        r = _run("Point", code.replace("{mod}", mod))
        assert r.returncode != 0
        last = r.stderr.strip().splitlines()[-1]
        assert last.startswith("ValueError"), r.stderr[-2000:]
        msgs.append(last)
    assert msgs[0] == msgs[1] == \
        "ValueError: STELLARD_VERIFY_CHECK='Point': expected 'bytes' or 'point'"


_JAX_RUNNER = r'''
import os, sys
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(tests)r)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from stellard_tpu.ops import ed25519_jax as J
from stellard_tpu_torch.ops import ed25519 as E
from test_torch_ed25519 import _check_modes_corpus

assert J._VERIFY_CHECK == E.VERIFY_CHECK == "point"
pubs, msgs, sigs = _check_modes_corpus()
want = np.asarray(J.verify_kernel(**J.prepare_batch(pubs, msgs, sigs)))
got = E.verify_kernel_ref(**E.to_tensors(E.prepare_batch(pubs, msgs, sigs), "cpu")).numpy()
assert np.array_equal(got, want), np.nonzero(got != want)[0].tolist()
print("OK jax point", int(want.sum()))
'''


@pytest.mark.slow  # compiles the JAX XLA kernel in point mode: minutes on the CPU
def test_point_mode_matches_the_jax_xla_kernel_in_point_mode():
    r = _run("point", _JAX_RUNNER)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    assert "OK jax point" in r.stdout
