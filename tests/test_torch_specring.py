"""The port's shared-memory ring transport (engine/specring.py) against the
JAX package's.

- **Port runs of the JAX tests.** Every test of tests/test_specring.py
  (the codec, the ring, the ring transport end to end with its SIGKILL
  recoveries, ``[spec] workers=auto``) runs again as a twin of its module
  with every name of the JAX package the port's, its workloads those of
  the port's twin of tests/test_parallel_spec.py. Each run's assertions
  must hold.
- **One wire.** On hypothesis-drawn wire shapes, ``encode_msg`` gives the
  same bytes in both packages, and each package decodes the other's
  bytes to the same value; a record written into one package's ring is
  read by the other's, slot header and all.
- **One config.** ``[spec]`` parses to the JAX Config's values and the
  port's Config no longer refuses it.
"""

from __future__ import annotations

import os

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import stellard_tpu.engine.specring as jax_ring
import stellard_tpu.node.config as jax_config
import stellard_tpu_torch.engine.specring as port_ring
import stellard_tpu_torch.node.config as port_config
from test_torch_consensus import cases
from test_torch_specexec import twin

# the port's twin of test_parallel_spec first: the ring tests import their
# workloads from it
twin("test_parallel_spec", extra=(
    ('signature_backend="cpu",', 'signature_backend="cpu", hash_backend="cpu",'),))
PT = twin("test_specring", extra=(
    ("from test_parallel_spec import", "from test_parallel_spec__port import"),))


@pytest.mark.parametrize("cname,mname,kw", cases(PT, skip=("TestWorkersAuto",
                                                         "TestCodec.test_roundtrip")))
def test_port_runs_the_jax_test(cname, mname, kw):
    getattr(getattr(PT, cname)(), mname)(**kw)


@pytest.mark.parametrize("obj", PT.TestCodec.test_roundtrip.pytestmark[0].args[1])
def test_port_codec_roundtrip(obj):
    """TestCodec.test_roundtrip's cases on the port, each also encoded to
    the JAX package's bytes."""
    PT.TestCodec().test_roundtrip(obj)
    assert port_ring.encode_msg(obj) == jax_ring.encode_msg(obj)


@pytest.mark.parametrize("cname,mname,kw", cases(PT, skip=tuple(
    c for c in vars(PT) if c.startswith("Test") and c != "TestWorkersAuto")))
def test_port_runs_the_jax_workers_auto_test(cname, mname, kw, caplog):
    method = getattr(getattr(PT, cname)(), mname)
    if "caplog" in method.__code__.co_varnames[:method.__code__.co_argcount]:
        kw = dict(kw, caplog=caplog)
    method(**kw)


# -- one wire --------------------------------------------------------------------

# ints: the wire's width is 255 bytes, signed; the sampled ones sit on
# either side of it (the widest that encode, the narrowest that raise)
_scalars = (st.none() | st.booleans() | st.integers(min_value=-(2**80), max_value=2**80)
            | st.sampled_from([2**2039 - 1, 2**2039, -(2**2039), -(2**2039) - 1])
            | st.floats(allow_nan=True) | st.binary(max_size=64) | st.text(max_size=32))
_hashable = st.recursive(
    _scalars, lambda inner: st.tuples(inner, inner) | st.frozensets(inner, max_size=4),
    max_leaves=8)
wire = st.recursive(
    _scalars,
    lambda inner: (st.lists(inner, max_size=5) | st.tuples(inner, inner, inner)
                   | st.dictionaries(_hashable, inner, max_size=4)
                   | st.sets(_hashable, max_size=4) | st.frozensets(_hashable, max_size=4)),
    max_leaves=24)


def canon(obj):
    """A comparable image of a decoded value: its type at every level, a
    float by its repr (a NaN equals a NaN, -0.0 is not 0.0), a set by its
    sorted elements (a decoded set may iterate in another order)."""
    t = type(obj)
    if t in (set, frozenset):
        return t.__name__, sorted(repr(canon(x)) for x in obj)
    if t in (list, tuple):
        return t.__name__, [canon(x) for x in obj]
    if t is dict:
        return "dict", [(canon(k), canon(v)) for k, v in obj.items()]
    return t.__name__, repr(obj)


@settings(max_examples=300, deadline=None)
@given(wire)
def test_codec_bytes_equal_across_packages(obj):
    try:
        want = jax_ring.encode_msg(obj)
    except ValueError:  # an int wider than 255 bytes: both refuse it
        with pytest.raises(ValueError):
            port_ring.encode_msg(obj)
        return
    got = port_ring.encode_msg(obj)
    assert got == want
    from_jax, from_port = port_ring.decode_msg(want), jax_ring.decode_msg(got)
    assert canon(from_jax) == canon(obj) == canon(from_port)
    assert port_ring.encode_msg(from_jax) == jax_ring.encode_msg(from_jax)


SHAPES = [
    ("win", 3, {"seq": 1000, "close_time": 530_000_030, "fees": [10, 200_000_000]}),
    ("exec", 3, [(0, 1, b"\x01" * 32, [b"k" * 32], [], None, True)],
     [(0, b"\x12\x00\x00" + b"\x00" * 60, True, "submit", 0)]),
    ("resb", 3, [(0, 1.5, 2.25, None, (0, 0, True, {b"k" * 32: None}, [], [(b"k" * 32, b"v")],
                                      (), b"meta", 7, 10, "submit", True), 0)]),
    ("r", 3, b"k" * 32), ("rr", None), ("sr", b"t" * 32), ("end", 3), ("stop",),
]


@pytest.mark.parametrize("writer,reader", [(jax_ring, port_ring), (port_ring, jax_ring)],
                         ids=["jax-to-port", "port-to-jax"])
def test_one_package_reads_the_others_ring(writer, reader):
    """A ring written by one package's RingConn is read by the other's
    ring over the same segment: the slot header, crc and sequence agree."""
    r, w = writer.ring_pipe(capacity=1 << 12)
    other = reader._Ring(r._ring.shm, r._ring.cap)
    try:
        for _ in range(3):  # wraps the 4 KiB ring
            for msg in SHAPES:
                w.send(msg)
                assert reader.decode_msg(other.pop()) == msg
                assert os.read(r._fd, 1) == b"\x01"  # the doorbell
        assert other.pop() is None
    finally:
        other.buf = None
        r.close()
        w.destroy()


@pytest.mark.parametrize("fault,reason", [("payload", "crc mismatch"),
                                          ("doorbell", "doorbell rang on an empty ring")])
def test_a_torn_slot_keeps_its_reason(fault, reason):
    """A torn slot raises TornSlotError from recv, is counted, and its
    reason stays on the channel (``torn_error``) for the pool's failure
    report."""
    r, w = port_ring.ring_pipe(capacity=1 << 12)
    try:
        if fault == "payload":
            w.send(("end", 3))
            r._ring.buf[port_ring._DATA_OFF + port_ring._HDR.size] ^= 0xFF
        else:
            os.write(w._fd, b"\x01")  # a doorbell byte with no record
        with pytest.raises(port_ring.TornSlotError, match=reason):
            r.recv()
        assert r.counters["torn_slots"] == 1 and reason in r.torn_error
    finally:
        r.close()
        w.destroy()


@pytest.mark.parametrize("text", ["[spec]\nworkers=4", "[spec]\nworkers=auto",
                                  "[spec]\nworkers=2\nmode=thread\nmax_retries=5\n"
                                  "drain_timeout_s=2.5\ntransport=pipe"])
def test_spec_section_parses_to_the_jax_values(text):
    port, jax = port_config.Config.from_ini(text), jax_config.Config.from_ini(text)
    for name in ("spec_workers", "spec_mode", "spec_max_retries", "spec_drain_timeout_s",
                 "spec_transport"):
        assert getattr(port, name) == getattr(jax, name), name
    assert port_config.resolve_spec_workers(port.spec_workers, cpu_count=6) == \
        jax_config.resolve_spec_workers(jax.spec_workers, cpu_count=6)


def test_kernel_tuning_still_refused():
    with pytest.raises(ValueError, match="not part of this package"):
        port_config.Config.from_ini("[spec]\nworkers=4\n[kernel_tuning]\nKERNEL_TUNING.json")
