"""The port's protocol/ and host utils/ against the JAX package.

The vectors of tests/test_golden_vectors.py (TestReferenceIdentityVectors,
TestHashPrefixVectors, TestWireFormatVectors) and tests/test_protocol.py
(TestSerializer, TestSTAmount, TestSTObject, TestKeys, TestTER) run
through both packages (the `P` fixture), and the two packages' outputs
are compared byte for byte: amounts (IOU normalization, arithmetic,
rounding), objects, and the Payment blobs of the JAX package's
testkit (signing hash, txid, re-serialization). Tolerance: zero.
"""

from __future__ import annotations

import hashlib
import importlib
import random
import types

import pytest

from stellard_tpu.testkit.workloads import TxFactory

PACKAGES = ("stellard_tpu", "stellard_tpu_torch")

MASTER_PASSPHRASE = "masterpassphrase"
MASTER_SEED_B58 = "s3q5ZGX2ScQK2rJ4JATp7rND6X5npG3De8jMbB7tuvm2HAVHcCN"
MASTER_NODE_PUBLIC_B58 = "nfbbWHgJqzqfH1cfRpMdPRkJ19cxTsdHkBtz1SLJJQfyf9Ax6vd"
MASTER_ACCOUNT_PUBLIC_B58 = "pGreoXKYybde1keKZwDCv8m5V1kT6JH37pgnTUVzdMkdygTixG8"
MASTER_ACCOUNT_ID_B58 = "ganVp9o5emfzpwrG5QVUXqMv8AgLcdvySb"
HP_TXN_ID = 0x54584E00
HP_TX_SIGN = 0x53545800


def sha512half(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()[:32]


def _ns(root: str) -> types.SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    proto = mod("protocol")
    ns = types.SimpleNamespace(**{k: getattr(proto, k) for k in dir(proto)
                                  if not k.startswith("_")})
    ns.root = root
    ns.sf = mod("protocol.sfields")
    ns.keys = mod("protocol.keys")
    ns.SerializedTransaction = mod("protocol.sttx").SerializedTransaction
    ns.hashes = mod("utils.hashes")
    ns.base58 = mod("utils.base58")
    ns.ripemd160 = mod("utils.ripemd160").ripemd160
    return ns


NS = {root: _ns(root) for root in PACKAGES}
J, T = NS["stellard_tpu"], NS["stellard_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def P(request) -> types.SimpleNamespace:
    return NS[request.param]


def _golden_payment(P, seq: int, drops: int, sign: bool = True):
    kp = P.KeyPair.from_passphrase(MASTER_PASSPHRASE)
    dst = P.KeyPair.from_passphrase("golden-dst")
    tx = P.SerializedTransaction.build(
        P.TxType.ttPAYMENT, kp.account_id, seq, 10,
        {P.sf.sfAmount: P.STAmount.from_drops(drops), P.sf.sfDestination: dst.account_id},
    )
    if sign:
        tx.sign(kp)
    return kp, dst, tx


# -- tests/test_golden_vectors.py, through both packages ------------------


class TestReferenceIdentityVectors:
    def test_masterpassphrase_identity_strings(self, P):
        kp = P.KeyPair.from_passphrase(MASTER_PASSPHRASE)
        assert kp.human_seed == MASTER_SEED_B58
        assert kp.human_node_public == MASTER_NODE_PUBLIC_B58
        assert kp.human_account_public == MASTER_ACCOUNT_PUBLIC_B58
        assert kp.human_account_id == MASTER_ACCOUNT_ID_B58

    def test_account_id_derivation_chain(self, P):
        kp = P.KeyPair.from_passphrase(MASTER_PASSPHRASE)
        h = hashlib.new("ripemd160", hashlib.sha256(kp.public).digest())
        assert kp.account_id == h.digest() == P.hashes.hash160(kp.public)

    def test_master_signature_of_zero_message_frozen(self, P):
        sig = P.KeyPair.from_passphrase(MASTER_PASSPHRASE).sign(b"\x00" * 32)
        assert sig.hex() == (
            "a8ed8e346d6b27a090ec4f74efda79af4a29e6ce967e3ceefc0580225dee8d58"
            "322c8fbc70fbb0374a1999128041746171cefaa983936e7cdaa4f5f995c46602"
        )

    def test_signing_without_the_wheel_is_byte_equal(self, monkeypatch):
        """The port signs through ops/ed25519_ref when `cryptography` is
        absent: same key, same signature as the JAX package."""
        kp = T.KeyPair.from_passphrase(MASTER_PASSPHRASE)
        monkeypatch.setattr(T.keys, "HAVE_CRYPTOGRAPHY", False)
        ref = T.KeyPair.from_passphrase(MASTER_PASSPHRASE)
        jkp = J.KeyPair.from_passphrase(MASTER_PASSPHRASE)
        assert ref.public == kp.public == jkp.public
        msg = sha512half(b"no wheel")
        assert ref.sign(msg) == jkp.sign(msg)
        assert T.verify_signature(ref.public, msg, ref.sign(msg))


class TestHashPrefixVectors:
    def test_sha512half_empty_frozen(self, P):
        assert P.hashes.sha512_half(b"").hex() == (
            "cf83e1357eefb8bdf1542850d66d8007d620e4050b5715dc83f4a921d36ce9ce"
        )

    def test_prefix_hash_is_prefix_concat(self, P):
        inner = (3).to_bytes(4, "big") + b"\x00" * 32
        expected = sha512half((0x12345600).to_bytes(4, "big") + inner)
        assert P.hashes.prefix_hash(0x12345600, inner) == expected

    def test_txid_uses_txn_prefix(self, P):
        _kp, _dst, tx = _golden_payment(P, 1, 1_000_000)
        assert tx.txid() == sha512half(HP_TXN_ID.to_bytes(4, "big") + tx.serialize())


class TestWireFormatVectors:
    @pytest.mark.parametrize("n", [0, 1, 2, 100, 192, 193, 300, 12480, 12481, 20000])
    def test_vl_length_encoding_goldens(self, P, n):
        if n <= 192:
            want = bytes([n])
        elif n <= 12480:
            want = bytes([193 + ((n - 193) >> 8), (n - 193) & 0xFF])
        else:
            want = bytes([241 + ((n - 12481) >> 16), ((n - 12481) >> 8) & 0xFF,
                          (n - 12481) & 0xFF])
        s = P.Serializer()
        s.add_vl(b"\x7a" * n)
        assert s.data() == want + b"\x7a" * n

    def test_payment_blob_hand_assembled(self, P):
        kp, dst, tx = _golden_payment(P, 7, 5_000_000)

        def fh(type_id: int, field_id: int) -> bytes:
            if type_id < 16 and field_id < 16:
                return bytes([(type_id << 4) | field_id])
            if type_id < 16:
                return bytes([type_id << 4, field_id])
            if field_id < 16:
                return bytes([field_id, type_id])
            return bytes([0, type_id, field_id])

        native = 0x4000000000000000
        expected = b"".join([
            fh(1, 2), (0).to_bytes(2, "big"),
            fh(2, 4), (7).to_bytes(4, "big"),
            fh(6, 1), (native | 5_000_000).to_bytes(8, "big"),
            fh(6, 8), (native | 10).to_bytes(8, "big"),
            fh(7, 3), bytes([32]), kp.public,
            fh(7, 4), bytes([64]), tx.signature,
            fh(8, 1), bytes([20]), kp.account_id,
            fh(8, 3), bytes([20]), dst.account_id,
        ])
        assert tx.serialize() == expected

    def test_signing_hash_prefix(self, P):
        kp, _dst, tx = _golden_payment(P, 7, 5_000_000, sign=False)
        unsigned = tx.obj.serialize(signing=True)
        assert tx.signing_hash() == sha512half(HP_TX_SIGN.to_bytes(4, "big") + unsigned)
        assert P.verify_signature(kp.public, tx.signing_hash(), kp.sign(tx.signing_hash()))


# -- tests/test_protocol.py, through both packages -----------------------


class TestHashesAndBase58:
    def test_hash160_and_ripemd160_fallback(self, P):
        h = hashlib.new("ripemd160")
        h.update(b"stellard")
        assert P.ripemd160(b"stellard") == h.digest()
        assert P.hashes.hash160(b"x") == hashlib.new(
            "ripemd160", hashlib.sha256(b"x").digest()).digest()

    def test_hash160_without_openssl_ripemd160(self, monkeypatch):
        import stellard_tpu_torch.utils.hashes as th

        want = th.hash160(b"pubkey")

        def no_ripemd(name, *a, **k):
            raise ValueError(f"unsupported hash type {name}")

        monkeypatch.setattr(th.hashlib, "new", no_ripemd)
        assert th.hash160(b"pubkey") == want

    def test_base58_roundtrips(self, P):
        b = P.base58
        for payload in (b"", b"\x00\x00\x01", bytes(range(40))):
            assert b.b58_decode(b.b58_encode(payload)) == payload
        enc = b.b58check_encode(0, b"\x07" * 20)
        assert b.b58check_decode(enc, 0)[1] == b"\x07" * 20
        assert enc == J.base58.b58check_encode(0, b"\x07" * 20)
        with pytest.raises(ValueError):
            b.b58check_decode(enc[:-1] + ("h" if enc[-1] != "h" else "j"), 0)


class TestSerializer:
    def test_integers_big_endian(self, P):
        s = P.Serializer()
        s.add8(0xAB)
        s.add16(0x1234)
        s.add32(0xDEADBEEF)
        s.add64(0x0102030405060708)
        assert s.data() == bytes.fromhex("ab1234deadbeef0102030405060708")

    def test_vl_length_boundaries(self, P):
        assert P.encode_vl_length(0) == b"\x00"
        assert P.encode_vl_length(193) == bytes([193, 0])
        assert P.encode_vl_length(12481) == bytes([241, 0, 0])
        assert P.encode_vl_length(918744) == bytes([254, 0xD4, 0x17])
        with pytest.raises(ValueError):
            P.encode_vl_length(918745)

    def test_field_id_roundtrip(self, P):
        for t, n in [(1, 1), (2, 15), (2, 16), (14, 1), (15, 1), (16, 3), (17, 16), (19, 255)]:
            s = P.Serializer()
            s.add_field_id(t, n)
            assert P.BinaryParser(s.data()).read_field_id() == (t, n)
            js = J.Serializer()
            js.add_field_id(t, n)
            assert s.data() == js.data()


def _amount_cases():
    """(kind, args) amounts: natives, canonical and non-canonical IOUs."""
    rng = random.Random(7)
    cases = [("drops", (d,)) for d in (0, 1, 10**6, 10**17 - 1, -5, -(10**12))]
    for mant, off, neg in [(10**15, 0, False), (9999999999999999, 80, False),
                           (10**15, -96, True), (123456789, -5, False), (1, 0, False),
                           (0, 0, False)]:
        cases.append(("iou", (mant, off, neg)))
    for _ in range(40):
        cases.append(("iou", (rng.randrange(1, 10**18), rng.randrange(-90, 60),
                              rng.random() < 0.3)))
    return cases


def _amount(P, kind, args):
    if kind == "drops":
        return P.STAmount.from_drops(*args)
    return P.STAmount.from_iou(P.currency_from_iso("USD"), b"\x07" * 20, *args)


def _wire(P, a) -> bytes:
    s = P.Serializer()
    a.serialize(s)
    return s.data()


class TestSTAmount:
    def test_wire_equal_across_packages_and_roundtrips(self, P):
        for kind, args in _amount_cases():
            a = _amount(P, kind, args)
            w = _wire(P, a)
            assert w == _wire(J, _amount(J, kind, args)), (kind, args)
            b = P.STAmount.deserialize(P.BinaryParser(w))
            assert b == a and (b.mantissa, b.offset, b.negative) == (
                a.mantissa, a.offset, a.negative)

    def test_arithmetic_equal_across_packages(self):
        usd = b"\x00" * 12 + b"USD" + b"\x00" * 5
        iou = [c for c in _amount_cases() if c[0] == "iou"]
        for (_k1, a1), (_k2, a2) in zip(iou, iou[1:] + iou[:1]):
            got = []
            for P in (J, T):
                x, y = _amount(P, "iou", a1), _amount(P, "iou", a2)
                ops = [lambda: x + y, lambda: x - y,
                       lambda: P.STAmount.multiply(x, y, usd, b"\x01" * 20),
                       lambda: P.STAmount.divide(x, y, usd, b"\x01" * 20)]
                row = []
                for op in ops:
                    try:
                        r = op()
                        row.append((_wire(P, r), r.value_text()))
                    except (ValueError, ZeroDivisionError) as exc:  # overflow: the same error
                        row.append((type(exc).__name__, str(exc)))
                got.append(row)
            assert got[0] == got[1], (a1, a2)

    def test_native_wire_positive_bit(self, P):
        assert _wire(P, P.STAmount.from_drops(1)) == (1 | (1 << 62)).to_bytes(8, "big")
        assert _wire(P, P.STAmount.from_drops(-1)) == (1).to_bytes(8, "big")

    def test_canonicalization_and_rounding(self, P):
        usd = P.currency_from_iso("USD")
        a = P.STAmount.from_iou(usd, b"\x01" * 20, 1, 0)
        assert a.mantissa == 10**15 and a.offset == -15 and a.value_text() == "1"
        one = P.STAmount.from_iou(usd, b"\x01" * 20, 10**15, -15)
        three = P.STAmount.from_iou(usd, b"\x01" * 20, 3 * 10**15, -15)
        q = P.STAmount.divide(one, three, usd, b"\x01" * 20)
        assert q.mantissa == 3333333333333333 and q.offset == -16
        assert P.STAmount.multiply(three, three, usd, b"\x01" * 20).value_text() == "9"
        b = P.STAmount.from_iou(usd, b"\x01" * 20, 10**15 + 5, -15)
        c = P.STAmount.from_iou(usd, b"\x01" * 20, 10**15 - 2, -15, negative=True)
        assert (b + c).is_zero() and (b + c).offset == -100

    def test_json_forms(self, P):
        assert P.STAmount.from_json("1e3").drops() == 1000
        assert P.STAmount.from_json("1000000").drops() == 1000000
        with pytest.raises(ValueError):
            P.STAmount.from_json("1.5")
        j = {"value": "2.5", "currency": "USD", "issuer": P.encode_account_id(b"\x09" * 20)}
        a = P.STAmount.from_json(j)
        assert a.value_text() == "2.5" and a.to_json() == J.STAmount.from_json(j).to_json()
        assert P.iso_from_currency(P.currency_from_iso("USD")) == "USD"

    def test_compare(self, P):
        assert P.STAmount.from_drops(5) < P.STAmount.from_drops(6)
        a = P.STAmount.from_json({"value": "1", "currency": "USD"})
        b = P.STAmount.from_json({"value": "10", "currency": "USD"})
        assert a < b and b > a and a == P.STAmount.from_json({"value": "1.0", "currency": "USD"})


def _payment_obj(P):
    obj = P.STObject()
    obj[P.sf.sfTransactionType] = int(P.TxType.ttPAYMENT)
    obj[P.sf.sfAccount] = b"\x01" * 20
    obj[P.sf.sfDestination] = b"\x02" * 20
    obj[P.sf.sfAmount] = P.STAmount.from_drops(10**6)
    obj[P.sf.sfFee] = P.STAmount.from_drops(10)
    obj[P.sf.sfSequence] = 1
    obj[P.sf.sfSigningPubKey] = b"\x03" * 32
    obj[P.sf.sfTxnSignature] = b"\x04" * 64
    return obj


def _rich_obj(P):
    """A Payment with an inner array and a path set."""
    usd = P.currency_from_iso("USD")
    obj = _payment_obj(P)
    memo = P.STObject({P.sf.sfMemoType: b"hi", P.sf.sfMemoData: b"there"})
    obj[P.sf.sfMemos] = P.STArray([(P.sf.sfMemo, memo)])
    obj[P.sf.sfPaths] = P.STPathSet([
        [P.PathElement(account=b"\x05" * 20), P.PathElement(currency=usd, issuer=b"\x06" * 20)],
        [P.PathElement(account=b"\x07" * 20)],
    ])
    return obj


class TestSTObject:
    def test_roundtrip_and_wire_equal(self, P):
        for make in (_payment_obj, _rich_obj):
            obj = make(P)
            data = obj.serialize()
            assert data == make(J).serialize()
            assert obj.serialize(signing=True) == make(J).serialize(signing=True)
            assert P.STObject.from_bytes(data) == obj
            assert P.STObject.from_bytes(data).to_json() == J.STObject.from_bytes(data).to_json()

    def test_canonical_order_independent_of_insertion(self, P):
        a = _payment_obj(P)
        b = P.STObject()
        for f, v in reversed(list(a.fields())):
            b[f] = v
        assert a.serialize() == b.serialize()
        assert a.serialize()[0] == 0x12

    def test_signing_serialization_omits_signature(self, P):
        obj = _payment_obj(P)
        no_sig = obj.copy()
        del no_sig[P.sf.sfTxnSignature]
        assert obj.serialize(signing=True) == no_sig.serialize()

    def test_template_validation(self, P):
        obj = _payment_obj(P)
        fmt = P.TX_FORMATS[int(P.TxType.ttPAYMENT)]
        assert P.validate_against(obj, fmt) == []
        del obj[P.sf.sfDestination]
        assert any("Destination" in p for p in P.validate_against(obj, fmt))


class TestKeys:
    def test_keys_equal_across_packages(self, P):
        for phrase in ("alice", "bob", "carol"):
            k = P.KeyPair.from_passphrase(phrase)
            j = J.KeyPair.from_passphrase(phrase)
            assert (k.seed, k.public, k.account_id, k.human_account_id) == (
                j.seed, j.public, j.account_id, j.human_account_id)
            assert P.decode_account_id(k.human_account_id) == k.account_id
            assert P.passphrase_to_seed(phrase) == P.hashes.sha512_half(phrase.encode())

    def test_sign_verify_and_non_canonical_s(self, P):
        k = P.KeyPair.from_passphrase("dave")
        h = P.hashes.sha512_half(b"message")
        sig = k.sign(h)
        assert sig == J.KeyPair.from_passphrase("dave").sign(h)
        assert P.verify_signature(k.public, h, sig)
        assert not P.verify_signature(k.public, P.hashes.sha512_half(b"other"), sig)
        bad = bytearray(sig)
        bad[0] ^= 1
        assert not P.verify_signature(k.public, h, bytes(bad))
        s = int.from_bytes(sig[32:], "little") + P.keys.ED25519_L
        if s < 1 << 256:
            assert not P.verify_signature(k.public, h, sig[:32] + s.to_bytes(32, "little"))

    def test_host_verifies_are_counted(self):
        k = T.KeyPair.from_passphrase("erin")
        h = sha512half(b"m")
        before = T.keys.host_verifies
        T.verify_signature(k.public, h, k.sign(h))
        assert T.keys.host_verifies == before + 1


class TestTER:
    def test_codes_and_ranges_equal(self, P):
        assert {t.name: int(t) for t in P.TER} == {t.name: int(t) for t in J.TER}
        assert P.TER.tesSUCCESS.is_tes and P.TER.tesSUCCESS.applied
        assert P.TER.tecPATH_DRY.is_tec and P.TER.tecPATH_DRY.applied
        assert P.TER.temBAD_SIGNATURE.is_tem and not P.TER.temBAD_SIGNATURE.applied
        assert P.TER.terPRE_SEQ.is_ter and P.TER.tefPAST_SEQ.is_tef
        assert P.TER.telINSUF_FEE_P.is_tel


# -- testkit Payments parsed by both -------------------------------------


def _factory_blobs() -> list[bytes]:
    fac = TxFactory(seed=3, n_accounts=6)
    rng = random.Random(3)
    blobs = []
    for i in range(24):
        src = fac.accounts[i % 6]
        dst = fac.accounts[(i + 1 + rng.randrange(5)) % 6].account_id
        blobs.append(fac.payment(src, dst, rng.randrange(1, 10**9)).serialize())
    blobs.append(fac.iou_payment(fac.accounts[0], fac.accounts[1].account_id, 5).serialize())
    return blobs


def test_testkit_payments_parse_equal():
    for blob in _factory_blobs():
        tj = J.SerializedTransaction.from_bytes(blob)
        tt = T.SerializedTransaction.from_bytes(blob)
        assert tt.signing_hash() == tj.signing_hash()
        assert tt.txid() == tj.txid()
        assert tt.serialize() == blob
        assert tt.obj.serialize() == tj.obj.serialize() == blob
        assert tt.passes_local_checks() == tj.passes_local_checks()
        assert (tt.account, tt.sequence, tt.fee.drops(), int(tt.tx_type)) == (
            tj.account, tj.sequence, tj.fee.drops(), int(tj.tx_type))
        assert tt.check_sign() and tj.check_sign()
