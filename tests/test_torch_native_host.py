"""The port's native host code against the JAX package's, on the CPU.

The port builds native/src/{sha512,ed25519_host,ed25519_verify}.cc into
one library of its own (``stellard_tpu_torch.native.load_host``) and
serves K1's host prep (h = SHA512(R||A||M) mod l), the ``native`` and
``openssl`` host verifiers and the ``cpu`` verifier that resolves between
them (``STELLARD_HOST_VERIFY``); the ``cpp`` hasher is hashlib's. Each is
held against the JAX package's function on the same inputs and against
the Python mirror it replaces. Tolerance zero: these are bytes and
verdicts. Needs ``g++``; a test that needs the library skips without it.

One verdict differs from the JAX package on purpose: every port verifier
rejects a key whose y encoding is >= p (``ed25519_ref.key_is_canonical``),
where the JAX package splits (its C++ verifier rejects such a key, its
kernel and the `cryptography` wheel accept it).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest

import __graft_entry__ as graft
import stellard_tpu.crypto.backend as jax_backend
import stellard_tpu.native as jax_native
import stellard_tpu.protocol.keys as jax_keys
import stellard_tpu_torch.crypto.backend as port_backend
import stellard_tpu_torch.native as port_native
import stellard_tpu_torch.protocol.keys as port_keys
from stellard_tpu_torch.ops import ed25519 as port_ed
from stellard_tpu.ops import ed25519_ref as jax_ref
from stellard_tpu_torch.ops import ed25519_ref as ref
from stellard_tpu_torch.ops.ed25519_cases import adversarial_cases
from test_crypto_plane import _make_cases

L = ref.L
FLOOD = 32_768
DISTINCT = 4_096

pytestmark = pytest.mark.skipif(port_native.load_host() is None,
                                reason="no C++ compiler: the host library does not build")


def signed(n: int, seed: int):
    """n distinct (key, 32-byte hash, signature) triples."""
    rng = np.random.default_rng(seed)
    keys = [port_keys.KeyPair.from_seed(rng.bytes(32)) for _ in range(64)]
    msgs = [rng.bytes(32) for _ in range(n)]
    pubs = [keys[i % 64].public for i in range(n)]
    sigs = [keys[i % 64].sign(m) for i, m in enumerate(msgs)]
    return pubs, msgs, sigs


@pytest.fixture(scope="module")
def flood():
    """The smoke's flood shape: 4,096 distinct signed pairs tiled to
    32,768, every 97th signature's R bit-flipped."""
    pubs, msgs, sigs = signed(DISTINCT, seed=1)
    reps = FLOOD // DISTINCT
    pubs, msgs, sigs = pubs * reps, msgs * reps, list(sigs * reps)
    for i in range(0, FLOOD, 97):
        sigs[i] = bytes([sigs[i][0] ^ 1]) + sigs[i][1:]
    return pubs, msgs, sigs


def h_by_all(pubs, msgs, sigs):
    """h of every signature by the port's native prep, its Python
    mirror and the JAX package's native prep."""
    n = len(pubs)
    rs = b"".join(s[:32] for s in sigs)
    pk = b"".join(pubs)
    native = port_native.Ed25519HostPrep().h_batch(rs, pk, msgs, n)
    mirror = port_ed._h_scalars(rs, pubs, msgs)
    jax = jax_native.Ed25519HostPrep().h_batch(rs, pk, msgs, n)
    return native, mirror, jax


# -- h prep ------------------------------------------------------------------


def test_native_h_equals_hashlib_on_the_flood(flood):
    native, mirror, jax = h_by_all(*flood)
    assert native.shape == (FLOOD, 32) and native.dtype == np.uint8
    assert np.array_equal(native, mirror)
    assert np.array_equal(native, jax)


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 1000])
def test_native_h_equals_hashlib_at_each_message_length(length):
    rng = np.random.default_rng(length)
    n = 33
    pubs = [rng.bytes(32) for _ in range(n)]
    msgs = [rng.bytes(length) for _ in range(n)]
    sigs = [rng.bytes(64) for _ in range(n)]
    native, mirror, jax = h_by_all(pubs, msgs, sigs)
    assert np.array_equal(native, mirror) and np.array_equal(native, jax)
    want = [int.from_bytes(hashlib.sha512(s[:32] + p + m).digest(), "little") % L
            for p, m, s in zip(pubs, msgs, sigs)]
    assert [int.from_bytes(row.tobytes(), "little") for row in native] == want


def test_prepare_batch_is_the_same_with_the_native_prep_and_without(flood, monkeypatch):
    pubs, msgs, sigs = (x[:2048] for x in flood)
    pubs, sigs = list(pubs), list(sigs)
    pubs[5], sigs[9] = b"\x01" * 31, b"\x02" * 63  # malformed rows
    assert port_ed._native_prep() is not None
    with_native = port_ed.prepare_batch(pubs, msgs, sigs)
    monkeypatch.setattr(port_ed, "_native_prep", lambda: None)
    without = port_ed.prepare_batch(pubs, msgs, sigs)
    assert with_native.keys() == without.keys()
    for k in with_native:
        assert np.array_equal(with_native[k], without[k]), k


def test_sc_reduce_batch_equals_python_mod_l():
    rng = np.random.default_rng(5)
    values = [0, 1, L - 1, L, L + 1, 2 * L, (1 << 252), (1 << 256) - 1,
              (1 << 512) - 1, L * ((1 << 259) - 1), L * (1 << 258) + L - 1]
    values += [int.from_bytes(rng.bytes(64), "little") for _ in range(512)]
    wide = b"".join(v.to_bytes(64, "little") for v in values)
    got = port_native.Ed25519HostPrep().sc_reduce(wide, len(values))
    assert [int.from_bytes(row.tobytes(), "little") for row in got] == [v % L for v in values]


# -- host verifiers ----------------------------------------------------------


def corpora() -> dict:
    adv = [(p, m, s) for _, p, m, s in adversarial_cases(seed=11, n_random=42)]
    graft_p, graft_m, graft_s = graft._raw_batch(16)
    graft_s = list(graft_s)
    graft_s[3] = graft_s[3][:40] + bytes([graft_s[3][40] ^ 4]) + graft_s[3][41:]
    return {"adversarial": adv, "crypto_plane": _make_cases(48),
            "graft_entry": list(zip(graft_p, graft_m, graft_s))}


def noncanonical(cases) -> np.ndarray:
    return np.array([len(p) == 32 and not ref.key_is_canonical(p) for p, _, _ in cases])


@pytest.mark.parametrize("corpus", ["adversarial", "crypto_plane", "graft_entry"])
def test_host_verifiers_agree_with_the_jax_package(corpus, monkeypatch):
    """Every port host verifier gives the port oracle's verdicts, and its
    JAX twin's but on a key whose y encoding is >= p: the JAX package's
    `cryptography` path accepts the corpus's small-order forgery on such
    a key, which its C++ verifier rejects; every port verifier rejects
    it."""
    cases = corpora()[corpus]
    want = np.array([len(m) == 32 and ref.verify(p, m, s) for p, m, s in cases])
    jax_oracle = np.array([len(m) == 32 and jax_ref.verify(p, m, s) for p, m, s in cases])
    assert np.array_equal(want, jax_oracle & ~noncanonical(cases))
    preq = [port_backend.VerifyRequest(p, m, s) for p, m, s in cases]
    jreq = [jax_backend.VerifyRequest(p, m, s) for p, m, s in cases]
    got = {
        "native": (port_backend.make_verifier("native").verify_batch(preq),
                   jax_backend.make_verifier("native").verify_batch(jreq), want),
        "openssl": (port_backend.make_verifier("openssl", threads=4).verify_batch(preq),
                    jax_backend.make_verifier("openssl").verify_batch(jreq), jax_oracle),
    }
    # without the `cryptography` wheel `openssl` is keys.verify_signature
    # over the native single verify, in both packages
    native_calls = []
    real = port_native.Ed25519NativeVerify.verify_batch

    def counted(self, *a):
        native_calls.append(len(a[0]))
        return real(self, *a)

    monkeypatch.setattr(port_native.Ed25519NativeVerify, "verify_batch", counted)
    for keys in (port_keys, jax_keys):
        monkeypatch.setattr(keys, "HAVE_CRYPTOGRAPHY", False)
    monkeypatch.setattr(jax_keys, "_FALLBACK_VERIFY", None)
    got["openssl, no wheel"] = (port_backend.make_verifier("openssl").verify_batch(preq),
                                jax_backend.make_verifier("openssl").verify_batch(jreq), want)
    assert native_calls and set(native_calls) == {1}
    for name, (port, jax, jax_want) in got.items():
        assert np.array_equal(port, want), name
        assert np.array_equal(jax, jax_want), name
    assert 0 < want.sum() < len(cases)
    if corpus == "adversarial":
        differs = [k for (k, *_), a, b in zip(adversarial_cases(seed=11, n_random=42),
                                                jax_oracle, want) if a != b]
        assert differs == ["noncanonical_key_forgery"]


def test_a_noncanonical_key_splits_the_jax_package_and_no_port_verifier(monkeypatch):
    """The corpus's small-order forgery on a key whose y is p + 1, through
    every verifier of both packages: the JAX package's kernel (as its
    plain reference runs on the CPU) and `cryptography` path accept it
    and its C++ verifier rejects it; the port's K1 (its plain version),
    its `native`, `openssl` and `cpu` host verifiers, its single check
    with and without the wheel, and a cost-routed verify plane's host
    arm all reject it, beside a valid signature they all accept."""
    import stellard_tpu.ops.ed25519_jax as jax_ed
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.ops import ed25519_cuda

    by_kind = {k: (p, m, s) for k, p, m, s in adversarial_cases(seed=11, n_random=0)}
    forged, valid = by_kind["noncanonical_key_forgery"], by_kind["valid"]
    assert not ref.key_is_canonical(forged[0]) and jax_ref.verify(*forged)
    pair = [forged, valid]
    pubs, msgs, sigs = (list(t) for t in zip(*pair))

    jax_k1 = np.asarray(jax_ed.verify_kernel(**jax_ed.prepare_batch(pubs, msgs, sigs)))
    jreq = [jax_backend.VerifyRequest(*c) for c in pair]
    jax = {"kernel": jax_k1.tolist(),
           "native": jax_backend.make_verifier("native").verify_batch(jreq).tolist(),
           "openssl": jax_backend.make_verifier("openssl").verify_batch(jreq).tolist()}
    assert jax == {"kernel": [True, True], "native": [False, True], "openssl": [True, True]}

    preq = [port_backend.VerifyRequest(*c) for c in pair]
    k1 = ed25519_cuda.verify(**port_ed.to_tensors(port_ed.prepare_batch(pubs, msgs, sigs), "cpu"))
    port = {"k1": k1.tolist(), "single": [port_keys.verify_signature(*c) for c in pair]}
    for name in ("native", "openssl", "cpu"):
        port[name] = port_backend.make_verifier(name).verify_batch(preq).tolist()
    plane = VerifyPlane(backend="cuda", min_device_batch=8, backend_opts={"device": "cpu"})
    try:
        port["plane host arm"] = plane.verify_many(preq).tolist()
        assert plane.device_batches == 0
    finally:
        plane.stop()
    monkeypatch.setattr(port_keys, "HAVE_CRYPTOGRAPHY", False)
    port["single, no wheel"] = [port_keys.verify_signature(*c) for c in pair]
    assert all(v == [False, True] for v in port.values()), port


@pytest.mark.parametrize("choice", ["auto", "", "native", "NATIVE", "python", "openssl"])
def test_cpu_resolves_as_the_jax_factory(choice, monkeypatch):
    monkeypatch.setenv("STELLARD_HOST_VERIFY", choice)
    port = port_backend.make_verifier("cpu")
    jax = jax_backend.make_verifier("cpu")
    assert (port.name, port.impl) == (jax.name, jax.impl)
    assert port.impl == ("openssl" if choice in ("python", "openssl") else "native")


def test_an_unknown_host_verify_choice_raises_in_both(monkeypatch):
    monkeypatch.setenv("STELLARD_HOST_VERIFY", "fastest")
    for backend in (port_backend, jax_backend):
        with pytest.raises(ValueError, match="STELLARD_HOST_VERIFY"):
            backend.make_verifier("cpu")


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """The loader with an empty build directory and no compiler."""
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(port_native, "_compiler", lambda: None)
    monkeypatch.setattr(port_native, "_loaded", {})
    monkeypatch.setattr(port_native, "_why", {})


def test_without_a_compiler_native_raises_and_cpu_falls_to_openssl(no_compiler, monkeypatch):
    monkeypatch.delenv("STELLARD_HOST_VERIFY", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port_backend.make_verifier("native")
    assert isinstance(port_backend.make_hasher("cpp"), port_backend.CpuHasher)
    assert port_backend.make_verifier("cpu").impl == "openssl"
    monkeypatch.setenv("STELLARD_HOST_VERIFY", "native")
    with pytest.raises(RuntimeError):
        port_backend.make_verifier("cpu")
    assert port_native.load_stser() is None and port_native.load_native() is None
    assert all(v.startswith("unavailable: no C++ compiler")
               for v in port_native.status().values())
    assert not port_native.native_available()


def test_host_checks_are_counted_by_every_host_verifier(monkeypatch):
    from stellard_tpu_torch.node.verifyplane import VerifyPlane

    cases = corpora()["adversarial"]
    reqs = [port_backend.VerifyRequest(p, m, s) for p, m, s in cases]
    monkeypatch.setattr(port_keys, "host_verifies", 0)
    port_backend.make_verifier("native").verify_batch(reqs)
    assert port_keys.host_verifies == len(reqs)
    port_backend.make_verifier("openssl").verify_batch(reqs)
    assert port_keys.host_verifies == 2 * len(reqs)
    plane = VerifyPlane(backend="cpu", window_ms=1.0)
    try:
        assert plane.get_json()["host_impl"] == "native"
        plane.verify_many(reqs)
    finally:
        plane.stop()
    assert port_keys.host_verifies == 3 * len(reqs)


# -- the cpp hasher ------------------------------------------------------------


@pytest.mark.parametrize("leaf_type", ["ACCOUNT_STATE", "TX_MD", "TX_NM"])
def test_cpp_roots_equal_cpu_hasher_roots(leaf_type):
    """The port serves `cpp` with hashlib: its roots equal the `cpu`
    hasher's and the JAX package's C hasher's."""
    import stellard_tpu.state.shamap as jax_shamap
    import stellard_tpu_torch.state.shamap as port_shamap

    rng = np.random.default_rng(9)
    items = [(rng.bytes(32), rng.bytes(int(rng.integers(1, 300)))) for _ in range(700)]
    roots = {}
    for name, sm, hasher in (
        ("cpu", port_shamap, port_backend.make_hasher("cpu")),
        ("cpp", port_shamap, port_backend.make_hasher("cpp")),
        ("jax cpp", jax_shamap, jax_backend.make_hasher("cpp")),
    ):
        m = sm.SHAMap(getattr(sm.TNType, leaf_type), hash_batch=hasher)
        m.bulk_update([sm.SHAMapItem(t, d) for t, d in items])
        roots[name] = m.get_hash()
    assert len(set(roots.values())) == 1, roots
    payloads = [os.urandom(n) for n in (0, 1, 111, 112, 128, 1000)]
    prefixes = [0, 1, 0x4D4C4E00, 0xFFFFFFFF, 0x54584E00, 0x534E4400]
    cpp = port_backend.make_hasher("cpp")
    assert cpp.prefix_hash_batch(prefixes, payloads) == [
        hashlib.sha512(p.to_bytes(4, "big") + d).digest()[:32]
        for p, d in zip(prefixes, payloads)]
    assert cpp.host_nodes == len(payloads)


# -- the config ----------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "[signature_backend]\ntype=native", "[signature_backend]\ntype=openssl",
    "[signature_backend]\ntype=cpu", "[hash_backend]\ntype=cpp", "[hash_backend]\ntype=CPP",
])
def test_config_takes_the_host_backends_as_the_jax_config(text):
    from stellard_tpu.node.config import Config as JaxConfig
    from stellard_tpu_torch.node.config import Config

    port, jax = Config.from_ini(text), JaxConfig.from_ini(text)
    assert (port.signature_backend, port.hash_backend)[text.startswith("[hash")] == \
        (jax.signature_backend, jax.hash_backend)[text.startswith("[hash")]


@pytest.mark.parametrize("text", [
    "[signature_backend]\ntype=cpp", "[hash_backend]\ntype=native",
    "[hash_backend]\ntype=openssl", "[signature_backend]\ntype=native\nmesh=2",
    "[signature_backend]\ntype=openssl\ndevice=cuda",
])
def test_config_refuses_a_host_backend_in_the_wrong_place(text):
    from stellard_tpu_torch.node.config import Config

    with pytest.raises(ValueError):
        Config.from_ini(text)


@pytest.mark.parametrize("value", ["KERNEL_TUNING.json", "tuning/verify.json"])
def test_kernel_tuning_raises_with_the_section_name(value):
    from stellard_tpu_torch.node.config import Config

    with pytest.raises(ValueError, match=r"\[kernel_tuning\]"):
        Config.from_ini(f"[kernel_tuning]\n{value}")
    with pytest.raises(ValueError, match=r"\[kernel_tuning\]"):
        Config(kernel_tuning=value).check_ported()
    for off in ("none", "off", "NONE"):
        Config.from_ini(f"[kernel_tuning]\n{off}")
