"""The device width of the port's crypto planes, twin of
tests/test_mesh_plane.py.

Each class of the JAX test runs here on both packages: the port over N
CPU shards (an explicit device list of N CPU devices, the kernels'
plain versions on each shard), the JAX package over its 8 virtual CPU
devices (tests/conftest.py). The mesh axis parses to the same canonical
values; a JAX INI's ``mesh=`` parses in the port to what it parses to
in the JAX package; widths 1/2/4/8 give byte-identical flags and
digests; the host / 1-device / N-device cost models choose as the JAX
ones do on the same observations; the planes build, route and collapse
their arms as the JAX planes do.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import stellard_tpu.crypto.backend as jb
import stellard_tpu.node.verifyplane as jvp
import stellard_tpu_torch.crypto.backend as tb
import stellard_tpu_torch.node.verifyplane as tvp
import stellard_tpu_torch.parallel.mesh as tmesh
from stellard_tpu.node.config import Config as JaxConfig
from stellard_tpu.ops import ed25519_ref as ref
from stellard_tpu.protocol.keys import KeyPair
from stellard_tpu_torch.node.config import Config as PortConfig

CPU8 = [torch.device("cpu")] * 8


def make_reqs(n: int, corrupt: set = frozenset(), seed: int = 9):
    """tests/test_mesh_plane.py's requests, as (JAX, port) request lists
    and the oracle's verdicts."""
    rng = np.random.default_rng(seed)
    keys = [KeyPair.from_seed(rng.bytes(32)) for _ in range(8)]
    triples, want = [], []
    for i in range(n):
        k = keys[i % 8]
        m = rng.bytes(32)
        s = bytearray(k.sign(m))
        if i in corrupt:
            s[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        triples.append((k.public, m, bytes(s)))
        want.append(ref.verify(k.public, m, bytes(s)))
    return ([jb.VerifyRequest(*t) for t in triples], [tb.VerifyRequest(*t) for t in triples],
            np.array(want))


def outcome(fn, *args):
    """fn(*args), or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as exc:  # noqa: BLE001 — compared by type
        return type(exc)


class TestMeshAxisParsing:
    VALUES = (None, "", "off", 0, "0", 1, "1", "4", " AUTO ", "auto", "16", "many", "-2",
              "1.5", -1)

    def test_parse_mesh_canonical_forms(self):
        for v in self.VALUES:
            assert outcome(tb.parse_mesh, v) == outcome(jb.parse_mesh, v), v
        assert tb.parse_mesh(" AUTO ") == "auto" and tb.parse_mesh(None) == "0"

    def test_parse_mesh_rejects_garbage(self):
        for v in ("many", "-2", "1.5"):
            with pytest.raises(ValueError):
                tb.parse_mesh(v)

    def test_resolve_width_clamps_and_floors(self):
        for mesh in ("0", "1", "2", "3", "4", "6", "8", "16", "auto"):
            for visible in (0, 1, 2, 6, 8):
                for pow2 in (False, True):
                    assert (tb.resolve_mesh_width(mesh, visible, pow2)
                            == jb.resolve_mesh_width(mesh, visible, pow2)), (mesh, visible, pow2)

    def test_mesh_wants_width(self):
        for v in ("auto", "2", "0", "1", None, "8"):
            assert tb.mesh_wants_width(v) == jb.mesh_wants_width(v), v


def port_ini(text: str) -> str:
    """The JAX INI with the port's device backend named."""
    return text.replace("type=tpu", "type=cuda")


class TestConfigRoundTrip:
    def test_mesh_round_trips_both_sections(self):
        text = ("[signature_backend]\ntype=tpu\nmesh=4\nrouting=device\n"
                "[hash_backend]\ntype=tpu\nmesh=auto\nmin_device_nodes=32\n"
                "[paths]\nmesh=2\n")
        j, p = JaxConfig.from_ini(text), PortConfig.from_ini(port_ini(text))
        for key in ("verify_mesh", "hash_mesh", "paths_mesh", "verify_routing",
                    "hash_min_device_nodes"):
            assert getattr(p, key) == getattr(j, key), key
        assert (p.verify_mesh, p.hash_mesh, p.paths_mesh) == ("4", "auto", "2")

    def test_mesh_zero_and_defaults(self):
        for text in ("[signature_backend]\ntype=tpu\nmesh=0\n", "[signature_backend]\ntype=tpu\n",
                     "[hash_backend]\ntype=tpu\nmesh=OFF\n", ""):
            j, p = JaxConfig.from_ini(text), PortConfig.from_ini(port_ini(text))
            assert (p.verify_mesh, p.hash_mesh, p.paths_mesh) == \
                (j.verify_mesh, j.hash_mesh, j.paths_mesh), text
        assert PortConfig().verify_mesh == PortConfig().hash_mesh == "auto"

    def test_mesh_on_host_backend_is_loud(self):
        for text in ("[signature_backend]\ntype=cpu\nmesh=4\n",
                     "[hash_backend]\ntype=cpu\nmesh=auto\n"):
            for cfg in (JaxConfig, PortConfig):
                with pytest.raises(ValueError, match="meaningless"):
                    cfg.from_ini(text)
        assert PortConfig.from_ini("[signature_backend]\ntype=cpu\nmesh=0\n").verify_mesh == "0"

    def test_bad_mesh_and_routing_rejected(self):
        for text in ("[signature_backend]\ntype=tpu\nmesh=lots\n", "[paths]\nmesh=-1\n",
                     "[hash_backend]\ntype=tpu\nrouting=maybe\n"):
            for cfg, t in ((JaxConfig, text), (PortConfig, port_ini(text))):
                with pytest.raises(ValueError):
                    cfg.from_ini(t)

    def test_verify_backend_opts_for_the_device(self):
        text = "[signature_backend]\ntype=tpu\nmesh=2\nmax_batch=512\n"
        j, p = JaxConfig.from_ini(text), PortConfig.from_ini(port_ini(text))
        assert j.verify_backend_opts() == {"mesh": "2", "max_batch": 512}
        assert p.verify_backend_opts() == {"mesh": "2", "max_batch": 512, "device": "cuda"}


class TestFactoryOptionValidation:
    def test_unknown_verifier_option_fails_loudly(self):
        with pytest.raises(ValueError, match="bogus"):
            tb.make_verifier("cpu", bogus=1)
        with pytest.raises(ValueError, match="threads"):
            tb.make_verifier("cuda", threads=4)
        # K1 takes any batch and the mesh cuts uneven shards: no pad floor
        with pytest.raises(ValueError, match="min_batch"):
            tb.make_verifier("cuda", min_batch=8)

    def test_unknown_hasher_option_fails_loudly(self):
        with pytest.raises(ValueError, match="mesh"):
            tb.make_hasher("cpu", mesh="4")

    def test_accepted_options_pass(self):
        v = tb.make_verifier("cuda", mesh="2", max_batch=64, device="cpu", devices=CPU8)
        assert isinstance(v, tb.CudaVerifier)
        assert (v.mesh, v.n_devices, v.max_batch) == ("2", 2, 64)
        h = tb.make_hasher("cuda", mesh="0", device="cpu")
        assert (h.mesh, h.n_devices) == ("0", 1)

    def test_bad_mesh_fails_at_build_not_first_batch(self):
        with pytest.raises(ValueError):
            tb.make_verifier("cuda", mesh="wide", device="cpu")
        with pytest.raises(ValueError):
            tb.make_hasher("cuda", mesh="-1", device="cpu")


class TestVerifierWidthIdentity:
    """Width is config, not code path: at every width the port's verdicts
    are the JAX sharded program's at that width, byte for byte, on a
    ragged batch with a bad signature in every shard of the widest
    mesh; the provenance reports the same width."""

    # 61 signatures: one corrupt in every shard of 8 (58 shares the
    # shard of the JAX program's pad rows)
    CORRUPT = {0, 9, 17, 26, 33, 42, 49, 58}

    @pytest.mark.parametrize("width", [1, 2, 4, 8])
    def test_every_width_matches_jax_and_reference(self, width):
        jreqs, treqs, want = make_reqs(61, self.CORRUPT)
        # the JAX test's construction (the same program and shapes)
        jv = jb.TpuVerifier(min_batch=8, max_batch=64, mesh=str(width))
        tv = tb.CudaVerifier(max_batch=64, mesh=str(width), device="cpu", devices=CPU8)
        got_jax, got = jv.verify_batch(jreqs), tv.verify_batch(treqs)
        assert got.tobytes() == got_jax.tobytes()
        assert np.array_equal(got, want)
        assert not got[sorted(self.CORRUPT)].any()
        assert tv.n_devices == jv.n_devices == width
        assert tv.kernel_selected == f"plain@{width}"
        jd, td = jv.describe(), tv.describe()
        for key in ("mesh_requested", "mesh_width", "devices_visible", "max_batch"):
            assert td[key] == jd[key], key

    def test_width_request_clamps_to_visible(self):
        _j, treqs, want = make_reqs(20, {3})
        v = tb.CudaVerifier(mesh="16", device="cpu", devices=CPU8)
        assert v.n_devices == len(jax.devices()) == 8
        assert np.array_equal(v.verify_batch(treqs), want)

    def test_mesh_zero_is_width_one_same_path(self):
        _j, treqs, want = make_reqs(20, {0, 9})
        v = tb.CudaVerifier(mesh="0", device="cpu", devices=CPU8)
        assert np.array_equal(v.verify_batch(treqs), want)
        assert (v.n_devices, v.kernel_selected) == (1, "plain@1")
        # no devices list: the one CPU, whatever the width asked for
        assert tb.CudaVerifier(mesh="auto", device="cpu").n_devices == 1

    def test_describe_reports_provenance(self):
        v = tb.CudaVerifier(mesh="2", device="cpu", devices=CPU8)
        d = v.describe()
        assert (d["mesh_requested"], d["mesh_width"], d["devices_visible"]) == ("2", 2, 8)
        assert (d["kernel"], d["platform"]) == ("plain@2", "cpu")


def packed(seed: int, n: int):
    rng = np.random.default_rng(seed)
    msgs = [b"MIN\0" + rng.bytes(int(rng.integers(1, 500))) for _ in range(n)]
    offsets = [0]
    for m in msgs:
        offsets.append(offsets[-1] + len(m))
    return b"".join(msgs), offsets


class TestHashPlaneIdentity:
    def test_packed_flat_identity_every_width(self):
        """hash_packed through the watched plane, forced device, a ragged
        37-message buffer: the port at every width equals hashlib and the
        JAX plane at that width."""
        buf, offsets = packed(13, 37)
        want = jb.CpuHasher().hash_packed(buf, offsets)
        for width in ("0", "2", "8", "auto"):
            j = jb.make_watched_hasher("tpu", mesh=width, routing="device", min_device_nodes=0)
            t = tb.make_watched_hasher("cuda", mesh=width, routing="device", min_device_nodes=0,
                                       device="cpu", devices=CPU8)
            assert t.hash_packed(buf, offsets) == j.hash_packed(buf, offsets) == want, width
            assert t.device_nodes == j.device_nodes == 37
            assert t.inner.n_devices == {"0": 1, "2": 2, "8": 8, "auto": 8}[width]

    def test_tree_hash_parity_vs_host(self):
        """A whole SHAMap sealed through the meshed watched hasher (K2
        and K3 per shard, the digest buffer on the first device): the
        root of the host-hashed JAX map, one readback a tree."""
        from stellard_tpu.state.shamap import SHAMap as JMap, SHAMapItem as JItem, TNType as JT
        from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem, TNType

        r = np.random.default_rng(17)
        items = [(r.bytes(32), r.bytes(90)) for _ in range(60)]
        jm = JMap(JT.ACCOUNT_STATE)
        for k, v in items:
            jm.set_item(JItem(k, v))
        for width in ("4", "8"):
            meshed = tb.make_watched_hasher("cuda", mesh=width, routing="device",
                                            min_device_nodes=0, device="cpu", devices=CPU8)
            m = SHAMap(TNType.ACCOUNT_STATE, hash_batch=meshed)
            for k, v in items:
                m.set_item(SHAMapItem(k, v))
            assert m.get_hash() == jm.get_hash(), width
            inner = meshed.inner
            assert inner.n_devices == int(width) and inner.tree_calls >= 1
            assert inner.tree_transfers.readbacks == inner.tree_calls
            assert meshed.device_nodes > 0

    def test_tree_hash_shards_off_the_buffer_device(self, monkeypatch):
        """Shards on another device than the digest buffer's ("cpu:1"..
        stand for other cards): leaf shards hash there and copy their
        rows back, inner shards read only the child digests they need.
        The root is the JAX map's, one readback a tree."""
        from stellard_tpu.state.shamap import SHAMap as JMap, SHAMapItem as JItem, TNType as JT
        from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem, TNType

        r = np.random.default_rng(23)
        items = [(r.bytes(32), r.bytes(int(r.integers(40, 300)))) for _ in range(300)]
        jm = JMap(JT.ACCOUNT_STATE)
        for k, v in items:
            jm.set_item(JItem(k, v))
        devices = ["cpu", "cpu:1", "cpu:2", "cpu:3"]
        remote = []  # the devices whose digests were copied back
        ordered = tmesh._ordered
        monkeypatch.setattr(tmesh, "_ordered",
                            lambda src, dst: (remote.append(str(src)), ordered(src, dst)))
        h = tb.make_watched_hasher("cuda", mesh="4", routing="device", min_device_nodes=0,
                                   device="cpu", devices=devices)
        m = SHAMap(TNType.ACCOUNT_STATE, hash_batch=h)
        for k, v in items:
            m.set_item(SHAMapItem(k, v))
        assert m.get_hash() == jm.get_hash()
        assert h.inner.n_devices == 4 and h.inner.tree_calls >= 1
        assert set(remote) == {"cpu:1", "cpu:2", "cpu:3"}
        assert h.inner.tree_transfers.readbacks == h.inner.tree_calls

    def test_non_pow2_width_rounds_down(self):
        h = tb.CudaHasher(mesh="3", device="cpu", devices=CPU8)
        assert h.prefix_hash_batch([0x1234], [b"x"]) == jb.CpuHasher().prefix_hash_batch(
            [0x1234], [b"x"])
        assert h.n_devices == 2 == jb.resolve_mesh_width("3", 8, pow2=True)


def both_cost_models(**kw):
    return jb._HashCostModel(**kw), tb._HashCostModel(**kw)


class TestThreeArmCostModel:
    """The same observations through both packages' models: the same
    choices, step by step, and the same snapshots."""

    def _script(self, steps, **kw):
        models = both_cost_models(**kw)
        for step in steps:
            out = [getattr(m, step[0])(*step[1:]) for m in models]
            assert out[0] == out[1], step
        assert models[0].get_json() == models[1].get_json()
        return models[1]

    def test_explores_then_routes_cheapest(self):
        m = self._script([
            ("choose", 100), ("observe", "dev1", 100, 100.0), ("choose", 100),
            ("observe", "dev1", 100, 4.0), ("choose", 100),
            ("observe", "devN", 100, 100.0), ("observe", "devN", 100, 12.0),
            ("choose", 100), ("observe", "host", 100, 100.0), ("choose", 100),
            ("observe", "dev1", 5000, 80.0), ("observe", "devN", 5000, 20.0),
            ("observe", "dev1", 5000, 80.0), ("observe", "devN", 5000, 20.0),
            ("choose", 5000),
        ], reexplore_every=8, arms=("dev1", "devN"))
        assert m.choose(100) == "dev1" and m.choose(5000) == "devN"

    def test_small_batches_stay_on_host(self):
        m = self._script([("choose", 63), ("choose", 64)], reexplore_every=8,
                         min_device_nodes=64, arms=("dev1", "devN"))
        assert m.choose(63) == "host"

    def test_losing_arm_reexplored_bounded(self):
        steps = [("observe", a, 100, x) for a, ms in (("dev1", 10.0), ("devN", 30.0))
                 for x in (999.0, ms)]
        steps += [("observe", "host", 100, 10000.0)] + [("choose", 100)] * 11
        self._script(steps, reexplore_every=5, arms=("dev1", "devN"))

    def test_hopeless_arm_never_reexplored(self):
        steps = [("observe", a, 100, x) for a, ms in (("dev1", 1.0), ("devN", 50.0))
                 for x in (999.0, ms)]
        steps += [("observe", "host", 100, 200.0)] + [("choose", 100)] * 20
        m = self._script(steps, reexplore_every=3, arms=("dev1", "devN"))
        assert m.choose(100) == "dev1"

    def test_get_json_snapshots_all_arms(self):
        m = self._script([("observe", "dev1", 10, 5.0), ("observe", "devN", 10, 7.0)],
                         reexplore_every=8, arms=("dev1", "devN"))
        j = m.get_json()
        assert set(j["arms"]) == {"dev1", "devN"} and j["buckets"] == j["arms"]["devN"]

    def test_legacy_single_arm_shims(self):
        m = self._script([("observe_device", 100, 999.0), ("observe_device", 100, 5.0),
                          ("observe_host", 100, 1000.0), ("use_device", 100)],
                         reexplore_every=8)
        assert m.use_device(100)


class TestLatencyModelArms:
    def test_route_picks_cheapest_arm(self):
        models = [M(min_device_batch=8, device_arms=("dev1", "devN"))
                  for M in (jvp._LatencyModel, tvp._LatencyModel)]
        for m in models:
            m.observe_cpu(100, 50.0)  # 0.5 ms/sig
            for arm, small, big in (("dev1", 2.0, 60.0), ("devN", 10.0, 12.0)):
                for _ in range(2):
                    m.observe_device(16, small, arm=arm)
                    m.observe_device(1024, big, arm=arm)
        for n in (4, 16, 1024, 5000):
            assert models[0].route(n) == models[1].route(n), n
        assert [models[1].route(n) for n in (16, 1024, 4)] == ["dev1", "devN", "cpu"]
        assert models[0].get_json() == models[1].get_json()

    def test_legacy_use_device_still_works(self):
        models = [M(min_device_batch=64) for M in (jvp._LatencyModel, tvp._LatencyModel)]
        for m in models:
            m.observe_cpu(100, 10.0)
            for _ in range(2):
                m.observe_device(256, 50.0)
        for n in (200, 1000):
            assert models[0].use_device(n) == models[1].use_device(n), n
        assert not models[1].use_device(200) and models[1].use_device(1000)


def fake_mesh_verifier(module):
    """tests/test_mesh_plane.py's fake device backend, for either
    package's registry."""

    class FakeMeshVerifier(module.BatchVerifier):
        name = "fake-mesh-twin"

        def __init__(self, mesh="auto", **_):
            self.mesh = mesh
            self.n_devices = 1 if mesh == "0" else 4
            self.calls: list[int] = []

        def verify_batch(self, batch):
            self.calls.append(len(batch))
            return np.ones(len(batch), bool)

    return FakeMeshVerifier


# a name of its own: tests/test_mesh_plane.py registers "fake-mesh"
jb.register_verifier("fake-mesh-twin", fake_mesh_verifier(jb), options=("mesh",))
tb.register_verifier("fake-mesh-twin", fake_mesh_verifier(tb), options=("mesh",))
PLANES = ((jvp.VerifyPlane, jb), (tvp.VerifyPlane, tb))


def garbage_reqs(module, n):
    return [module.VerifyRequest(b"\x01" * 32, b"\x02" * 32, b"\x03" * 64)] * n


def plane_of(cls, **kw):
    # the JAX plane's routing default is its env's (cost); the port's
    # constructor default is cost too
    return cls(backend="fake-mesh-twin", window_ms=1.0, **kw)


class TestPlaneDualArms:
    def test_plane_builds_and_routes_both_arms(self):
        seen = []
        for cls, mod in PLANES:
            plane = plane_of(cls, backend_opts={"mesh": "4"}, min_device_batch=8,
                             routing="cost")
            try:
                wide, one = plane.verifier, plane._one_chip
                assert one is not None and one.mesh == "0"
                assert plane.model.device_arms == ("dev1", "devN")
                m = plane.model
                m.observe_cpu(100, 50.0)
                for arm, small, big in (("dev1", 2.0, 60.0), ("devN", 10.0, 12.0)):
                    for _ in range(2):
                        m.observe_device(16, small, arm=arm)
                        m.observe_device(1024, big, arm=arm)
                plane.verify_many(garbage_reqs(mod, 16))
                assert one.calls == [16] and wide.calls == []
                plane.verify_many(garbage_reqs(mod, 1024))
                assert wide.calls == [1024]
                j = plane.get_json()
                seen.append((j["arms"], j["backend"], j["device_sigs"], j["cpu_sigs"]))
            finally:
                plane.stop()
        assert seen[0] == seen[1]
        assert seen[1][0] == {"dev1": {"batches": 1, "sigs": 16},
                              "devN": {"batches": 1, "sigs": 1024}}

    def test_arms_collapse_when_wide_resolves_single(self):
        # the JAX verifier resolves its width at first use, and the
        # plane collapses its arms there
        plane = plane_of(jvp.VerifyPlane, backend_opts={"mesh": "4"}, min_device_batch=8)
        try:
            plane.verifier.n_devices = 1  # "mesh wider than the box"
            assert plane._device_arms() == ("devN",)
            assert plane._one_chip is None
        finally:
            plane.stop()
        # the port's resolves it when built: no one-card verifier, one arm
        plane = tvp.VerifyPlane(backend="cuda", min_device_batch=8,
                                backend_opts={"mesh": "4", "device": "cpu", "devices": ["cpu"]})
        try:
            assert plane.verifier.n_devices == 1
            assert plane._one_chip is None and plane.model.device_arms == ("device",)
        finally:
            plane.stop()

    def test_forced_device_routing(self):
        for cls, mod in PLANES:
            plane = plane_of(cls, backend_opts={"mesh": "4"}, min_device_batch=8,
                             routing="device")
            try:
                plane.verify_many(garbage_reqs(mod, 32))
                assert plane.verifier.calls == [32]
                plane.verify_many(garbage_reqs(mod, 4))  # below the floor: cpu
                assert plane.verifier.calls == [32]
                assert plane.get_json()["routing"] == "device"
            finally:
                plane.stop()

    def test_bad_routing_rejected(self):
        for cls, _mod in PLANES:
            with pytest.raises(ValueError, match="routing"):
                cls(backend="cpu", routing="sometimes")

    def test_no_mesh_opts_keeps_single_arm(self):
        for cls, _mod in PLANES:
            plane = plane_of(cls)
            try:
                assert plane._one_chip is None and plane.model.device_arms == ("device",)
            finally:
                plane.stop()

    def test_cuda_plane_on_cpu_shards(self):
        """The port's own backend: a mesh of 4 CPU shards and its
        one-shard arm, each verifying the oracle's verdicts through the
        plane; at width 1 the arms collapse."""
        _j, treqs, want = make_reqs(24, {1, 13})
        plane = tvp.VerifyPlane(backend="cuda", routing="device", min_device_batch=1,
                                backend_opts={"mesh": "4", "device": "cpu", "devices": CPU8[:4]})
        try:
            assert plane.model.device_arms == ("dev1", "devN")
            assert plane._one_chip.n_devices == 1 and plane.verifier.n_devices == 4
            assert np.array_equal(plane.verify_many(treqs), want)
            assert plane.get_json()["arms"]["devN"] == {"batches": 1, "sigs": 24}
            assert plane.get_json()["mesh"]["mesh_width"] == 4
        finally:
            plane.stop()
        plane = tvp.VerifyPlane(backend="cuda", backend_opts={"mesh": "auto", "device": "cpu"})
        try:
            assert plane.model.device_arms == ("device",) and plane._one_chip is None
        finally:
            plane.stop()


class TestSyncSubmitRidesThePlane:
    def test_process_transaction_counts_through_verify_plane(self):
        """An RPC submit (NetworkOPs.process_transaction) verifies through
        the routed plane in both packages' nodes: a good signature and a
        tampered one each count once."""
        import stellard_tpu as jpk
        import stellard_tpu_torch as tpk

        got = []
        for pk in (jpk, tpk):
            from importlib import import_module

            Config = import_module(f"{pk.__name__}.node.config").Config
            Node = import_module(f"{pk.__name__}.node.node").Node
            formats = import_module(f"{pk.__name__}.protocol.formats")
            sf = import_module(f"{pk.__name__}.protocol.sfields")
            STAmount = import_module(f"{pk.__name__}.protocol.stamount").STAmount
            sttx = import_module(f"{pk.__name__}.protocol.sttx")
            keys = import_module(f"{pk.__name__}.protocol.keys")
            TER = import_module(f"{pk.__name__}.protocol.ter").TER
            n = Node(Config(signature_backend="cpu", hash_backend="cpu",
                            kernel_tuning="none")).setup()
            try:
                master = keys.KeyPair.from_passphrase("masterpassphrase")
                dest = keys.KeyPair.from_passphrase("plane-sync").account_id

                def pay(seq):
                    tx = sttx.SerializedTransaction.build(
                        formats.TxType.ttPAYMENT, master.account_id, seq, 10,
                        {sf.sfAmount: STAmount.from_drops(250_000_000),
                         sf.sfDestination: dest})
                    tx.sign(master)
                    return tx

                before = n.verify_plane.verified
                ter, applied = n.ops.process_transaction(pay(1))
                blob = bytearray(pay(2).serialize())
                blob[-5] ^= 0x40
                ter2, applied2 = n.ops.process_transaction(
                    sttx.SerializedTransaction.from_bytes(bytes(blob)))
                got.append((int(ter), applied, ter2 == TER.temINVALID, applied2,
                            n.verify_plane.verified - before, n.verify_plane.cpu_sigs >= 1))
            finally:
                n.stop()
        assert got[0] == got[1]
        assert got[1][1] and got[1][2:] == (True, False, 2, True)


class FakeDevHasher:
    """tests/test_mesh_plane.py's fake device hasher (the port's
    BatchHasher surface)."""

    name = "cuda"

    def __init__(self, n_devices=8):
        self.n_devices = n_devices
        self.calls = 0
        self.device_nodes = 0
        self.host_nodes = 0

    def prefix_hash_batch(self, prefixes, payloads):
        from stellard_tpu_torch.utils.hashes import prefix_hash

        self.calls += 1
        self.device_nodes += len(prefixes)
        return [prefix_hash(p, d) for p, d in zip(prefixes, payloads)]


class TestWatchdogThreeWay:
    def _mk(self, routing="cost"):
        wide, one, host = FakeDevHasher(8), FakeDevHasher(1), tb.CpuHasher()
        w = tb.WatchdogHasher(wide, host, inner_one=one, min_device_nodes=0, routing=routing)
        return w, wide, one, host

    def test_cost_routes_three_ways(self):
        w, wide, one, _ = self._mk()
        m = w._flat
        for arm, small, big in (("dev1", 1.0, 50.0), ("devN", 9.0, 5.0)):
            m.observe(arm, 16, 999.0)
            m.observe(arm, 16, small)
            m.observe(arm, 2048, 999.0)
            m.observe(arm, 2048, big)
        m.observe("host", 16, 160.0)  # 10 ms/node: the devices win
        w.prefix_hash_batch([0x1234] * 16, [b"x" * 40] * 16)
        assert one.calls == 1 and wide.calls == 0
        w.prefix_hash_batch([0x1234] * 2048, [b"x" * 40] * 2048)
        assert wide.calls == 1
        j = w.get_json()
        assert j["arms"] == ["dev1", "devN"]
        assert set(j["flat_model"]["arms"]) == {"dev1", "devN"}

    def test_forced_device_uses_widest_arm(self):
        w, wide, one, _ = self._mk(routing="device")
        w.prefix_hash_batch([0x1234] * 4, [b"x" * 40] * 4)
        assert wide.calls == 1 and one.calls == 0
        assert w.get_json()["routing"] == "device"

    def test_arms_collapse_when_wide_is_single(self):
        # the JAX watchdog collapses at its first routing; the port's
        # hasher never builds the one-card arm when the wide one resolves
        # to one device
        jw = jb.WatchdogHasher(FakeDevHasher(1), jb.CpuHasher(), inner_one=FakeDevHasher(1),
                               min_device_nodes=0)
        assert jw._live_arms() == ("devN",) and jw.inner_one is None
        w = tb.make_watched_hasher("cuda", mesh="8", device="cpu", devices=["cpu"])
        assert w.inner.n_devices == 1
        assert w.inner_one is None and w._arm_names == ("device",)

    def test_counters_sum_both_arms(self):
        w, _wide, one, _ = self._mk(routing="device")
        w.prefix_hash_batch([0x1234] * 4, [b"x" * 40] * 4)
        one.device_nodes += 3  # as if the one-device arm also ran
        assert w.device_nodes == 7
        w.device_nodes = 0
        assert w.device_nodes == 0

    def test_make_watched_hasher_arm_construction(self):
        w = tb.make_watched_hasher("cuda", mesh="8", device="cpu", devices=CPU8)
        assert isinstance(w, tb.WatchdogHasher)
        assert w.inner_one is not None and w.inner_one.n_devices == 1
        assert w._arm_names == ("dev1", "devN")
        assert tb.make_watched_hasher("cuda", mesh="0", device="cpu").inner_one is None
        # auto on one device: no one-card arm is built
        w1 = tb.make_watched_hasher("cuda", device="cpu")
        assert w1._arm_names == ("device",) and w1.inner_one is None
        assert isinstance(tb.make_watched_hasher("cpu"), tb.CpuHasher)
        jw = jb.make_watched_hasher("tpu", mesh="8")
        assert (jw.inner_one is not None) == (w.inner_one is not None)
