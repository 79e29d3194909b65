#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellard_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the ledger close's device plane and then a standalone node's
closes through the entry points a node calls, at the sizes a close
really has, and checks every result:

1. device   — the card's name and power limit; builds the three CUDA
              kernels (one nvcc each, started together) and prints
              ptxas' registers and spills.
2. kernels  — K1 (Ed25519 verify) on the adversarial corpus and 4,096
              random lanes, K2 (masked SHA-512) on 4,096 messages at
              every ladder size, against their plain PyTorch versions
              on the card, exactly; K1 also against the RFC 8032
              oracle, K2 against hashlib.
3. flood    — 32,768 signatures (4,096 distinct signed pairs tiled,
              ~1% planted corruptions) through VerifyPlane(backend=
              "cuda", routing="device").verify_many in two 16,384
              chunks, then 4,096 submit() futures: every verdict as
              expected, device share 1.0, no wedge.
4. seal     — a 1,000,000-leaf state SHAMap and a 32,768-leaf
              transaction SHAMap sealed by CudaHasher.hash_tree, then a
              3,000-write / 300-delete delta re-sealed: every root equal
              to the hashlib root, one readback per tree.
5. close    — a standalone node under a payment flood (CLOSE_SIZES):
              1,000,000 AccountRoots resumed through
              LedgerMaster.load_ledger, then 4 closes of 4,096 signed
              Payments (~2% creating accounts, ~1% with a bad
              signature). Each close verifies its batch once on the
              verify plane (K1), applies every payment to the open
              ledger and closes it (close_and_advance, both trees sealed
              by CudaHasher: K2, K3). Every verdict and TER as expected,
              no host signature check, K1 launched in every close, one
              readback per sealed tree, and every ledger hash and
              results digest equal to the JAX package's on the same
              blobs (START_HASH, CLOSE_HASHES, CLOSE_DIGESTS; recomputed
              by tests/test_torch_close.py's slow test:
              JAX_PLATFORMS=cpu python -m pytest tests/test_torch_close.py -m slow -q -s).
              Then K1 against its plain version on a close's batch.
6. times    — every kernel against its plain version again, exactly, at
              the shapes the main path gave it: K1 on both flood
              chunks, K2 on every leaf of the
              state and transaction trees, K3 on the state tree's widest
              inner level; each kernel and plain version timed with CUDA
              events on those inputs, with its bound. K1 is timed again
              on the first chunk with every S non-canonical and with
              every key undecodable, which stop each lane before and
              after the decode: the split of its time by phase.

Launch counts are zeroed just before phases 3-4 and read just after, and
again around phase 5; the kernels line shows the sum, the launches of
the main path alone. Any failed check exits non-zero without the final
line. Without a CUDA device, or without the package beside it, the
script exits non-zero at once.
"""

from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

N_DISTINCT = 4096
N_FLOOD = 32768
CHUNK = 16384
N_SUBMIT = 4096
N_STATE = 1_000_000
N_TX = N_FLOOD
N_DELTA = 3000
N_DEL = N_DELTA // 10
K2_LANES = 4096  # per ladder size, kernel-vs-plain comparison

# H100 SXM: 64 INT32 lanes per SM per clock; HBM3 at 3.35 TB/s (NVIDIA
# data sheet)
INT32_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12

# the least 32-bit integer operations per unit of work. A field multiply
# of two 255-bit operands needs, in any schoolbook layout, at least the
# 8 x 8 = 64 products of 32x32->64 bits that eight 32-bit limbs give
# (radix-2^51 limbs give 25 wider products, no fewer 32-bit ones), each
# 2 INT32 issue slots (lo and hi): 128 ops; a squaring 36 products (8
# squares, 28 cross products): 72. Adds and carries are not counted, so
# the count holds for any limb layout; Karatsuba or tensor-core products
# would need a new count.
# A SHA-512 block, with 3-input logic (LOP3), 3-input adds (IADD3) and
# funnel shifts, each one op per 32-bit half: a round is Sigma0 + Sigma1 (3
# rotates + 1 xor3 = 8 each), ch and maj (2 each), t1's 5-term add (4),
# a's 3-term add and e's add (2 each) = 28; a schedule step is sigma0 +
# sigma1 (8 each) and a 4-term add (4) = 20; the final state adds 16
FE_MUL_OPS = 64 * 2
FE_SQ_OPS = 36 * 2
SHA_BLOCK_OPS = 80 * 28 + 64 * 20 + 16
# (field multiplies, field squarings) of K1 per signature, by phase
# (csrc/ed25519_verify.cu). The chain to a^(2^250-1) squares 249 times.
CHAIN_250 = (10, 249)
# y^2, v, v^3, v^7, x, v*x^2, T; pow_p58 is the chain, 2 squarings and
# a multiply (the conditional multiply by sqrt(-1) is not counted)
DECODE = (8 + CHAIN_250[0] + 1, 4 + CHAIN_250[1] + 2)
# the 8-entry table of -A for signed digits (fewer than the 15 entries
# that unsigned nibbles need): 4 doublings (4M + 4S), 3 cached additions
# (8M), 8 cached conversions (1M)
TABLE = (4 * 4 + 3 * 8 + 8, 4 * 4)
WALK_DOUBLES = (256 * 4, 256 * 4)
ADD = (8, 0)
# 1/Z (the chain and 5 squarings and a multiply), then x and y
ENCODE = (CHAIN_250[0] + 1 + 2, CHAIN_250[1] + 5)


def fe_ops(muls_sqs) -> int:
    muls, sqs = muls_sqs
    return muls * FE_MUL_OPS + sqs * FE_SQ_OPS


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int):
    """(mean ms of fn() over reps launches by CUDA events, warmed once;
    the result of the last call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def max_abs_err(a, b) -> int:
    import torch

    a = a.view(torch.int32).to(torch.int64) if a.dtype == torch.uint32 else a.to(torch.int64)
    b = b.view(torch.int32).to(torch.int64) if b.dtype == torch.uint32 else b.to(torch.int64)
    return int((a - b).abs().max().item()) if a.numel() else 0


# --------------------------------------------------------------------------
# inputs


def sign_pairs(n: int, seed: int):
    """n distinct (key, 32-byte signing hash) pairs signed by the oracle."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref as ref

    rng = np.random.default_rng(seed)
    pubs, msgs, sigs = [], [], []
    for _ in range(n):
        sk = rng.bytes(32)
        pk = ref.derive_public(sk)
        m = rng.bytes(32)
        pubs.append(pk)
        msgs.append(m)
        sigs.append(ref.sign(sk, pk, m))
    return pubs, msgs, sigs


def plant(pubs, msgs, sigs, seed: int):
    """~1% corruptions of six kinds at spread positions; returns the
    expected verdicts (the oracle's, for every planted lane)."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref as ref

    n = len(pubs)
    rng = np.random.default_rng(seed)
    expect = np.ones(n, bool)
    ident = (1).to_bytes(32, "little")
    kinds = ["r_bitflip", "s_bitflip", "key_bitflip", "other_message",
             "s_plus_l", "small_order_forgery"]
    positions = np.linspace(7, n - 1, num=n // 100).astype(int)
    counts = dict.fromkeys(kinds, 0)
    for j, i in enumerate(positions):
        kind = kinds[j % len(kinds)]
        s = bytearray(sigs[i])
        if kind == "r_bitflip":
            s[int(rng.integers(32))] ^= 1 << int(rng.integers(8))
        elif kind == "s_bitflip":
            s[32] ^= 1 << int(rng.integers(8))  # low byte: S stays < l
        elif kind == "key_bitflip":
            p = bytearray(pubs[i])
            p[int(rng.integers(32))] ^= 1 << int(rng.integers(8))
            pubs[i] = bytes(p)
        elif kind == "other_message":
            msgs[i] = rng.bytes(32)
        elif kind == "s_plus_l":
            v = int.from_bytes(s[32:], "little") + ref.L
            if v < 1 << 256:
                s[32:] = v.to_bytes(32, "little")
        else:
            pubs[i] = ident
            s[:] = ident + bytes(32)
        sigs[i] = bytes(s)
        expect[i] = ref.verify(pubs[i], msgs[i], sigs[i])
        counts[kind] += 1
    return expect, counts


def k1_ops(batch: dict) -> int:
    """32-bit integer multiply ops K1's function needs on these inputs:
    lanes with a non-canonical S stop at once; lanes whose key does not
    decode stop after the decode; the walk adds once per nonzero digit of
    each scalar, in whichever 4-bit form has fewer: unsigned nibbles or
    signed digits in [-8, 7]."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref as ref
    from stellard_tpu_torch.ops.ed25519 import _nibbles_le, _signed_digits_le

    sc = np.asarray(batch["s_canonical"], bool)
    a = np.asarray(batch["a_words"]).astype("<u4").tobytes()
    decodes = np.array([
        bool(sc[i]) and ref.pt_decompress(a[32 * i : 32 * i + 32]) is not None
        for i in range(len(sc))
    ])
    nonzero = 0
    for key in ("s_bytes", "h_bytes"):
        b = np.asarray(batch[key], np.uint8)[decodes]
        nonzero += int(np.minimum((_nibbles_le(b) != 0).sum(1),
                                  (_signed_digits_le(b) != 0).sum(1)).sum())
    return (int(sc.sum()) * fe_ops(DECODE)
            + int(decodes.sum()) * (fe_ops(TABLE) + fe_ops(WALK_DOUBLES) + fe_ops(ENCODE))
            + nonzero * fe_ops(ADD))


def bound_ms(ops: float, nbytes: float, int32_rate: float) -> tuple[float, str]:
    t_ops = ops / int32_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def undecodable_key(seed: int) -> bytes:
    """32 bytes that are no point's encoding (no square root of x^2)."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref as ref

    rng = np.random.default_rng(seed)
    while True:
        key = rng.bytes(32)
        if ref.pt_decompress(key) is None:
            return key


def state_items(n: int, seed: int):
    """AccountRoot-sized state leaves: 32-byte keys, 110-130-byte data."""
    import numpy as np

    from stellard_tpu_torch.state.shamap import SHAMapItem

    rng = np.random.default_rng(seed)
    sizes = rng.integers(110, 131, n)
    blob = rng.bytes(int(sizes.sum()))
    ends = np.cumsum(sizes)
    items = []
    start = 0
    for i in range(n):
        key = hashlib.sha256(b"state:%d" % i).digest()
        items.append(SHAMapItem(key, blob[start : ends[i]]))
        start = int(ends[i])
    return items


def tx_items(n: int, seed: int):
    """tx+meta-sized transaction leaves: 400-455-byte data."""
    import numpy as np

    from stellard_tpu_torch.state.shamap import SHAMapItem

    rng = np.random.default_rng(seed)
    return [
        SHAMapItem(hashlib.sha512(b"tx:%d" % i).digest()[:32],
                   rng.bytes(int(rng.integers(400, 456))))
        for i in range(n)
    ]


def seal_both(m, cuda_hasher, cpu_hasher) -> dict:
    """Seal m's dirty nodes on the card, then again with hashlib from the
    same dirty set; the two roots must be equal."""
    from stellard_tpu_torch.state.shamap import _collect_unhashed, compute_hashes

    dirty = [node for level in _collect_unhashed(m.root) for node in level]
    t0 = time.perf_counter()
    compute_hashes(m.root, cuda_hasher)
    t_cuda = time.perf_counter() - t0
    root_cuda = m.root._hash
    for node in dirty:
        node._hash = None
    t0 = time.perf_counter()
    compute_hashes(m.root, cpu_hasher)
    t_cpu = time.perf_counter() - t0
    require(m.root._hash == root_cuda, "seal root differs from the hashlib root")
    return {"dirty_nodes": len(dirty), "root": root_cuda.hex(),
            "seal_ms": t_cuda * 1e3, "seal_phases_ms": dict(cuda_hasher.last_tree_ms),
            "hashlib_seal_ms": t_cpu * 1e3}


def widest_inner_level(root):
    """The inner nodes of the depth with the most of them, in a sealed
    tree."""
    from stellard_tpu_torch.state.shamap import Inner

    levels, frontier = [], [root]
    while frontier:
        inners = [n for n in frontier if isinstance(n, Inner)]
        if not inners:
            break
        levels.append(inners)
        frontier = [c for n in inners for c in n.children if c is not None]
    return max(levels, key=len)


def k3_inputs(inners, device, prefix: int):
    """buf rows = every child's digest; child_rows point at them."""
    import numpy as np
    import torch

    from stellard_tpu_torch.ops.treehash import build_inner_template

    n = len(inners)
    template = build_inner_template(n, prefix)
    child_rows = np.full((n, 16), -1, np.int32)
    digests = []
    for i, node in enumerate(inners):
        for c, child in enumerate(node.children):
            if child is not None:
                child_rows[i, c] = len(digests)
                digests.append(child._hash)
    buf = np.frombuffer(b"".join(digests), ">u4").astype(np.uint32).reshape(-1, 8)
    buf = np.concatenate([buf, np.zeros((n, 8), np.uint32)])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    want = np.frombuffer(b"".join(nd._hash for nd in inners), ">u4").astype(np.uint32)
    return up(buf), up(template), up(child_rows), len(digests), want.reshape(n, 8)


# --------------------------------------------------------------------------
# the close phase: a payment flood through the node's own entry points


def close_workload(n_accounts: int, n_senders: int, n_closes: int,
                   per_close: int, seed: int) -> dict:
    """Seeded inputs of the close phase, as plain bytes and ints:

    - ``accounts``: n_accounts 20-byte account IDs, the first n_senders
      those of keys made from the 32-byte ``sender_seeds``;
    - ``closes``: per close, per_close Payments, the senders in turn
      (each with its next sequence and a fee of 10 drops): ~97% to an
      existing account (1-100 STR), ~2% to a new account (250 STR, above
      the 200 STR reserve), ~1% with a planted bad signature; each entry
      is (blob, kind, expected verdict).

    Signed with the port's protocol/keys.py; a planted signature's
    verdict is the RFC 8032 oracle's."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref
    from stellard_tpu_torch.protocol.formats import TxType
    from stellard_tpu_torch.protocol.keys import KeyPair
    from stellard_tpu_torch.protocol.sfields import sfAmount, sfDestination, sfTxnSignature
    from stellard_tpu_torch.protocol.stamount import STAmount
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    rng = np.random.default_rng(seed)
    sender_seeds = [rng.bytes(32) for _ in range(n_senders)]
    keys = [KeyPair.from_seed(sd) for sd in sender_seeds]
    raw = rng.bytes(20 * (n_accounts - n_senders))
    accounts = [k.account_id for k in keys] + [
        raw[i : i + 20] for i in range(0, len(raw), 20)]
    seqs = [1] * n_senders
    closes = []
    for _ in range(n_closes):
        entries = []
        for p in range(per_close):
            i = p % n_senders
            key = keys[i]
            u = rng.random()
            kind = "bad_sig" if u < 0.01 else "new_account" if u < 0.03 else "existing"
            if kind == "new_account":
                dst, drops = rng.bytes(20), 250_000_000
            else:
                j = i
                while j == i:
                    j = int(rng.integers(n_accounts))
                dst, drops = accounts[j], int(rng.integers(1_000_000, 100_000_001))
            tx = SerializedTransaction.build(
                TxType.ttPAYMENT, key.account_id, seqs[i], 10,
                {sfAmount: STAmount.from_drops(drops), sfDestination: dst})
            tx.sign(key)
            good = True
            if kind == "bad_sig":
                sig = bytearray(tx.signature)
                sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
                tx.obj[sfTxnSignature] = bytes(sig)
                good = ed25519_ref.verify(key.public, tx.signing_hash(), bytes(sig))
            if good:
                seqs[i] += 1  # a rejected payment does not use its sequence
            entries.append((tx.serialize(), kind, good))
        closes.append(entries)
    return {"accounts": accounts, "sender_seeds": sender_seeds, "closes": closes}


# the closed ledger the close phase resumes from (load_ledger); each
# close k then closes at START_CLOSE_TIME + 30 * (k + 1), resolution 30
START_SEQ = 1000
START_CLOSE_TIME = 530_000_000
START_PARENT_HASH = hashlib.sha512(b"chip_smoke close phase parent").digest()[:32]
ACCOUNT_BALANCE = 10_000 * 1_000_000  # drops


# the close phase's sizes, and what the JAX package's LedgerMaster gives
# on the same inputs (recomputed by tests/test_torch_close.py's slow test:
# JAX_PLATFORMS=cpu python -m pytest tests/test_torch_close.py -m slow -q -s)
CLOSE_SIZES = dict(n_accounts=1_000_000, n_senders=4096, n_closes=4, per_close=4096,
                   seed=21)
START_HASH = "f51dc4a4014269ecee84a89e79f4ce0b18024d30b4b5abc10796acb5cab71fec"
CLOSE_HASHES = [
    "20ff96546196b21842d980b1e8b8b146fdeb0dee3915014c0ee5f87ee5049179",
    "7a1b8bb8babe185d3274b5bb55b9d4c7c67f0ce6b1e13bdb3ceaa9ac3014085f",
    "b27b6b870c9db21480cd5a6e900a58d56268f53879df22ffb473b32a4114f45b",
    "421046184ab6c8c88bf987869e27afb77bd90fe275acfc3c8e3dee74636cc9a5",
]
CLOSE_DIGESTS = [
    "33f90d045925ee1b65d4dbc53570f1c37b454af26fb207b41a1f1d74a3cf7f9a",
    "05094a6b6dc5d0ac66bba7c278b8d4fe4fe0d196dcb6ed796588ca16bc02cc8b",
    "c0bdbcf88e395df8b73d448490687eb5c5dd5bd61b8330be1f4ec5052f8b3a1b",
    "423d0fb8893b6026977160d3fc0edb0c0114c29b20859cbba4709e41e69bb2fc",
]


def start_header() -> dict:
    return {"seq": START_SEQ, "parent_hash": START_PARENT_HASH,
            "close_time": START_CLOSE_TIME, "parent_close_time": START_CLOSE_TIME - 30,
            "close_resolution": 30}


def account_root_items(accounts):
    """(key, data, node type) state leaves: one AccountRoot a 20-byte ID
    (Sequence 1, ACCOUNT_BALANCE drops, as the genesis root's fields).
    Every entry differs only in its Account bytes, so one serialized
    template is spliced; the first entry is checked against STObject."""
    from stellard_tpu_torch.protocol.formats import LedgerEntryType
    from stellard_tpu_torch.protocol.sfields import (
        sfAccount, sfBalance, sfFlags, sfLedgerEntryType, sfOwnerCount,
        sfPreviousTxnID, sfPreviousTxnLgrSeq, sfSequence)
    from stellard_tpu_torch.protocol.stamount import STAmount
    from stellard_tpu_torch.protocol.stobject import STObject
    from stellard_tpu_torch.state import indexes
    from stellard_tpu_torch.state.shamap import TNType

    def sle(account: bytes) -> bytes:
        o = STObject()
        o[sfLedgerEntryType] = int(LedgerEntryType.ltACCOUNT_ROOT)
        o[sfAccount] = account
        o[sfBalance] = STAmount.from_drops(ACCOUNT_BALANCE)
        o[sfSequence] = 1
        o[sfFlags] = 0
        o[sfOwnerCount] = 0
        o[sfPreviousTxnID] = b"\x00" * 32
        o[sfPreviousTxnLgrSeq] = 0
        return o.serialize()

    marker = b"\xa5" * 20
    head, tail = sle(marker).split(marker)
    require(head + accounts[0] + tail == sle(accounts[0]), "AccountRoot template")
    t = int(TNType.ACCOUNT_STATE)
    return [(indexes.account_root_index(a), head + a + tail, t) for a in accounts]


def results_digest(open_ters, close_results) -> str:
    """SHA-256 over (txid, TER) of every submission in order, then of
    every closed transaction in txid order; TERs as 4-byte signed ints."""
    h = hashlib.sha256()
    for txid, ter in open_ters:
        h.update(txid + int(ter).to_bytes(4, "big", signed=True))
    for txid in sorted(close_results):
        h.update(txid + int(close_results[txid]).to_bytes(4, "big", signed=True))
    return h.hexdigest()


class GcClock:
    """Wall ms the cyclic garbage collector ran (gc.callbacks), and how
    many of its runs were full (generation 2) collections."""

    def __init__(self):
        self.ms = 0.0
        self.full = 0
        self._t0 = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.full += info["generation"] == 2
            self._t0 = None


def run_closes(wl: dict, hash_batch, verify_many, on_close=None) -> list[dict]:
    """The port's standalone node over the workload: the start ledger
    through LedgerMaster.load_ledger, then per close one batched verify
    of its transactions (node/ledgertools._reverify_memoized, verdicts
    memoized and flagged SF_SIGGOOD), do_transaction on each in
    OPEN_LEDGER|RETRY mode and close_and_advance. Returns per close the
    ledger hash, the results digest, the verdicts, the TERs and times."""
    from stellard_tpu_torch.engine.engine import TxParams
    from stellard_tpu_torch.interop import ledger_from_items
    from stellard_tpu_torch.node.hashrouter import HashRouter
    from stellard_tpu_torch.node.ledgermaster import LedgerMaster

    t0 = time.perf_counter()
    start = ledger_from_items(start_header(), account_root_items(wl["accounts"]),
                              hash_batch=hash_batch)
    t1 = time.perf_counter()
    router = HashRouter()
    lm = LedgerMaster(hash_batch=hash_batch, router=router)
    lm.load_ledger(start)  # seals the whole state tree
    t2 = time.perf_counter()
    out = [{"build_state_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3,
            "hash": start.hash().hex()}]
    mode = TxParams.OPEN_LEDGER | TxParams.RETRY
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    try:
        for k, entries in enumerate(wl["closes"]):
            out.append(_one_close(lm, router, verify_many, entries, k, mode, gc_clock))
            if on_close is not None:
                on_close(k, lm.closed_ledger())
    finally:
        gc.callbacks.remove(gc_clock)
    return out


def _one_close(lm, router, verify_many, entries, k: int, mode, gc_clock) -> dict:
    """Close k of run_closes: verify, open apply, close_and_advance."""
    from stellard_tpu_torch.node.ledgertools import _reverify_memoized
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    gc_ms, gc_full = gc_clock.ms, gc_clock.full
    ta = time.perf_counter()
    txs = [SerializedTransaction.from_bytes(blob) for blob, _kind, _good in entries]
    verdicts = _reverify_memoized(txs, verify_many, router)
    tb = time.perf_counter()
    open_ters = [(tx.txid(), lm.do_transaction(tx, mode)[0]) for tx in txs]
    tc = time.perf_counter()
    ledger, results = lm.close_and_advance(START_CLOSE_TIME + 30 * (k + 1), 30)
    td = time.perf_counter()
    last = lm.last_close
    return {
        "seq": ledger.seq, "hash": ledger.hash().hex(),
        "digest": results_digest(open_ters, results),
        "verdicts": verdicts, "open_ters": [int(t) for _, t in open_ters],
        "close_ters": {txid: int(t) for txid, t in results.items()},
        "wall_ms": (td - ta) * 1e3, "parse_verify_ms": (tb - ta) * 1e3,
        "apply_ms": (tc - tb) * 1e3, "close_ms": (td - tc) * 1e3,
        "seal_tx_ms": last["seal_tx_ms"], "seal_tx_nodes": last["seal_tx_nodes"],
        "seal_state_ms": last["seal_state_ms"],
        "seal_state_nodes": last["seal_state_nodes"],
        "gc_ms": gc_clock.ms - gc_ms, "gc_full_collections": gc_clock.full - gc_full,
    }


# --------------------------------------------------------------------------


def run(dev) -> None:
    """All phases on `dev` (main() passes the first CUDA device)."""
    import numpy as np
    import torch

    from stellard_tpu_torch.crypto.backend import CpuHasher, CudaHasher, VerifyRequest
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.ops import build, ed25519_cuda, ed25519_ref, treehash
    from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref
    from stellard_tpu_torch.ops.ed25519_cases import adversarial_cases
    from stellard_tpu_torch.ops.sha512 import digest_to_bytes
    from stellard_tpu_torch.state.shamap import SHAMap, SHAMapItem, TNType
    from stellard_tpu_torch.utils.hashes import HP_INNER_NODE

    t_start = time.perf_counter()

    # 1. device and build ---------------------------------------------------
    name_power = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(dev)
    int32_rate = props.multi_processor_count * INT32_PER_SM_CLOCK * clock_mhz * 1e6
    print(name_power, flush=True)
    emit("device", name=torch.cuda.get_device_name(dev), nvidia_smi=name_power,
         sms=props.multi_processor_count, max_sm_clock_mhz=clock_mhz,
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    build.build([ed25519_cuda.LIB, treehash.LIB])
    build_s = time.perf_counter() - t0
    ptxas = {
        lib: [ln.strip() for ln in log.splitlines()
              if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        for lib, log in build.PTXAS_LOG.items()
    }
    emit("build", seconds=build_s, ptxas=ptxas)

    # 2. K1 and K2 against their plain versions -----------------------------
    pubs, msgs, sigs = sign_pairs(N_DISTINCT, seed=1)
    cases = adversarial_cases(seed=11)
    kinds, c_pubs, c_msgs, c_sigs = (list(t) for t in zip(*cases))
    lanes_p, lanes_m, lanes_s = list(pubs), list(msgs), list(sigs)
    expect_lanes, _ = plant(lanes_p, lanes_m, lanes_s, seed=2)
    cmp_batch = prepare_batch(c_pubs + lanes_p, c_msgs + lanes_m, c_sigs + lanes_s)
    cmp_t = to_tensors(cmp_batch, dev)
    got = ed25519_cuda.verify(**cmp_t)
    plain = verify_kernel_ref(**cmp_t)
    torch.cuda.synchronize()
    oracle = np.array([ed25519_ref.verify(p, m, s) for p, m, s in zip(c_pubs, c_msgs, c_sigs)])
    k1_err = max_abs_err(got, plain)
    got_np = got.cpu().numpy()
    require(k1_err == 0, "K1 differs from its plain version")
    require(np.array_equal(got_np[: len(cases)], oracle), "K1 differs from the oracle")
    require(np.array_equal(got_np[len(cases):], expect_lanes), "K1 lane verdicts wrong")
    emit("k1_vs_plain", lanes=int(got.numel()), corpus=len(cases),
         corpus_accepts=int(oracle.sum()), max_abs_err=k1_err, equal=True)

    rng = np.random.default_rng(3)
    k2_err = 0
    for ladder in treehash.LEAF_BLOCK_LADDER:
        msgs_k2 = [rng.bytes(int(x)) for x in rng.integers(0, ladder * 128 - 16, K2_LANES)]
        blocks, nblocks = treehash.pad_leaf_batch(msgs_k2, ladder)
        bt, nt = torch.from_numpy(blocks).to(dev), torch.from_numpy(nblocks).to(dev)
        st = treehash.sha512_blocks_masked(bt, nt)
        st_plain = treehash.sha512_blocks_masked_ref(bt, nt)
        err = max_abs_err(st, st_plain)
        host = st.cpu().numpy()
        ok_hashlib = all(digest_to_bytes(host[i]) == hashlib.sha512(msg).digest()
                         for i, msg in enumerate(msgs_k2))
        require(err == 0 and ok_hashlib, f"K2 wrong at ladder {ladder}")
        k2_err = max(k2_err, err)
        emit("k2_vs_plain", ladder=ladder, lanes=K2_LANES, max_abs_err=err,
             equal_hashlib=ok_hashlib)

    # 3-4. the main path, counted ----------------------------------------------
    state = SHAMap(TNType.ACCOUNT_STATE)
    t0 = time.perf_counter()
    base_items = state_items(N_STATE, seed=4)
    state.bulk_update(base_items)
    txmap = SHAMap(TNType.TX_MD)
    txmap.bulk_update(tx_items(N_TX, seed=5))
    build_tree_s = time.perf_counter() - t0
    reps = N_FLOOD // N_DISTINCT
    f_pubs, f_msgs, f_sigs = pubs * reps, msgs * reps, sigs * reps
    expect, planted = plant(f_pubs, f_msgs, f_sigs, seed=6)
    reqs = [VerifyRequest(p, m, s) for p, m, s in zip(f_pubs, f_msgs, f_sigs)]
    plane = VerifyPlane(backend="cuda", routing="device", max_batch=CHUNK,
                        backend_opts={"max_batch": CHUNK, "device": dev})
    cuda_hasher = CudaHasher(device=dev)
    cpu_hasher = CpuHasher()

    ed25519_cuda.launches = 0
    for k in treehash.launches:
        treehash.launches[k] = 0
    try:
        t0 = time.perf_counter()
        verdicts = plane.verify_many(reqs)
        flood_s = time.perf_counter() - t0
        futs = [plane.submit(r) for r in reqs[:N_SUBMIT]]
        fut_verdicts = np.array([f.result(timeout=600) for f in futs])
        seals = {"state": seal_both(state, cuda_hasher, cpu_hasher)}
        seals["tx"] = seal_both(txmap, cuda_hasher, cpu_hasher)
        # bench.py's delta: half overwrite existing keys, half are new;
        # the deletes hit keys the sets do not touch
        sets = [
            SHAMapItem(
                base_items[i].tag if i % 2 == 0 else hashlib.sha256(b"new:%d" % i).digest(),
                hashlib.sha512(b"delta:%d" % i).digest() * 2,
            )
            for i in range(N_DELTA)
        ]
        deletes = [base_items[N_STATE - 1 - i].tag for i in range(N_DEL)]
        state.bulk_update(sets, deletes)
        seals["delta"] = seal_both(state, cuda_hasher, cpu_hasher)
    finally:
        plane.stop()
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}

    pj = plane.get_json()
    require(np.array_equal(verdicts, expect), "flood verdicts wrong")
    require(np.array_equal(fut_verdicts, expect[:N_SUBMIT]), "submit() verdicts wrong")
    require(pj["device_share"] == 1.0, f"device share {pj['device_share']}")
    require(not pj["device_wedged"], "the device plane wedged")
    require(launches["ed25519_verify"] > 0, "K1 never launched on the main path")
    emit("flood", signatures=N_FLOOD, distinct=N_DISTINCT, planted=planted,
         accepted=int(verdicts.sum()), rejected=int((~verdicts).sum()),
         seconds=flood_s, sigs_per_s=N_FLOOD / flood_s,
         device_share=pj["device_share"], device_wedged=pj["device_wedged"],
         device_batches=pj["device_batches"], submit_futures=N_SUBMIT,
         transfers=pj["transfers"])
    tt = cuda_hasher.tree_transfers
    require(tt.readbacks == cuda_hasher.tree_calls == 3,
            f"readbacks {tt.readbacks} != tree calls {cuda_hasher.tree_calls}")
    require(cuda_hasher.device_nodes > 0, "no node was hashed on the card")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched on the main path")
    emit("seal", state_leaves=N_STATE, tx_leaves=N_TX, delta_writes=N_DELTA,
         delta_deletes=N_DEL, tree_build_s=build_tree_s, seals=seals,
         tree_calls=cuda_hasher.tree_calls, readbacks=tt.readbacks,
         device_nodes=cuda_hasher.device_nodes, host_nodes=cuda_hasher.host_nodes)
    emit("launches", **launches)

    # 5. the close phase, counted on its own ----------------------------------
    close = close_phase(dev, name_power)

    # 6. K3 against plain, and times -----------------------------------------
    inners = widest_inner_level(state.root)
    buf, template, child_rows, nkids, want = k3_inputs(inners, dev, HP_INNER_NODE)
    off = nkids
    buf_plain = buf.clone()
    treehash.tree_inner_level(buf, template, child_rows, off)
    treehash.tree_inner_level_ref(buf_plain, template, child_rows, off)
    k3_err = max_abs_err(buf, buf_plain)
    require(k3_err == 0, "K3 differs from its plain version")
    require(np.array_equal(buf[off:].cpu().numpy(), want), "K3 differs from the tree")
    emit("k3_vs_plain", nodes=len(inners), children=nkids, max_abs_err=k3_err,
         equal_tree=True)

    # K1 against its plain version on the flood's chunks, the shapes the
    # main path launched it at (the first chunk's calls are the timed ones)
    prep_ms, k1_main_err = [], 0
    for lo in range(0, N_FLOOD, CHUNK):
        sl = slice(lo, lo + CHUNK)
        t0 = time.perf_counter()
        host = prepare_batch(f_pubs[sl], f_msgs[sl], f_sigs[sl])
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        tens = to_tensors(host, dev)
        if lo == 0:
            chunk_host, chunk_tens = host, tens
            k1_ms, got = cuda_ms(lambda: ed25519_cuda.verify(**tens), reps=10)
            k1_plain_ms, plain = cuda_ms(lambda: verify_kernel_ref(**tens), reps=1)
        else:
            got, plain = ed25519_cuda.verify(**tens), verify_kernel_ref(**tens)
        err = max_abs_err(got, plain)
        require(err == 0, f"K1 differs from its plain version on flood chunk {lo}")
        require(np.array_equal(got.cpu().numpy(), expect[sl]),
                f"K1 verdicts wrong on flood chunk {lo}")
        k1_main_err = max(k1_main_err, err)
        emit("k1_vs_plain_main", chunk_start=lo, lanes=int(got.numel()),
             max_abs_err=err, equal=True)
    k1_err = max(k1_err, k1_main_err, close["k1_max_abs_err"])
    k1_b, k1_by = bound_ms(k1_ops(chunk_host), 130 * CHUNK, int32_rate)

    # K1's phases: the same chunk with every S non-canonical (each lane
    # stops before its decode) and with every key undecodable (each lane
    # stops after it). Its final inversion is the same exponentiation as
    # the decode's, one thread a signature.
    bad_key = undecodable_key(seed=7)
    stop_before = to_tensors(
        dict(chunk_host, s_canonical=np.zeros_like(chunk_host["s_canonical"])), dev)
    stop_after = to_tensors(dict(chunk_host, a_words=np.tile(
        np.frombuffer(bad_key, chunk_host["a_words"].dtype), (CHUNK, 1))), dev)
    k1_before_ms, got_before = cuda_ms(lambda: ed25519_cuda.verify(**stop_before), reps=10)
    k1_after_ms, got_after = cuda_ms(lambda: ed25519_cuda.verify(**stop_after), reps=10)
    require(not got_before.any().item() and not got_after.any().item(),
            "K1 accepted a lane with a non-canonical S or an undecodable key")
    emit("k1_phases", chunk=CHUNK, full_ms=k1_ms, stop_before_decode_ms=k1_before_ms,
         stop_after_decode_ms=k1_after_ms)
    del chunk_tens, stop_before, stop_after

    # K2 against its plain version on every leaf of the state tree (all in
    # one launch, as the state seal ran them) and of the transaction tree;
    # the state leaves' calls are the timed ones
    for tree, m in (("state", state), ("tx", txmap)):
        blocks_np, nblocks_np = leaf_blocks(m)
        bt = torch.from_numpy(blocks_np).to(dev)
        nt = torch.from_numpy(nblocks_np).to(dev)
        leaf_buf = torch.zeros((len(nblocks_np), 8), dtype=torch.uint32, device=dev)
        leaf = lambda: treehash.tree_leaf_body(leaf_buf, bt, nt, 0)  # noqa: E731
        masked_ref = lambda: treehash.sha512_blocks_masked_ref(bt, nt)  # noqa: E731
        if tree == "state":
            k2_shape = list(blocks_np.shape)
            k2_ms, _ = cuda_ms(leaf, reps=10)
            k2_plain_ms, st_plain = cuda_ms(masked_ref, reps=1)
            k2_b, k2_by = bound_ms(int(nblocks_np.sum()) * SHA_BLOCK_OPS,
                                   blocks_np.nbytes + nblocks_np.nbytes
                                   + 32 * len(nblocks_np), int32_rate)
        else:
            leaf()
            st_plain = masked_ref()
        err = max_abs_err(leaf_buf, st_plain[:, :8])
        require(err == 0, f"K2 differs from its plain version on the {tree} leaves")
        k2_err = max(k2_err, err)
        emit("k2_vs_plain_main", tree=tree, shape=list(blocks_np.shape),
             max_abs_err=err, equal=True)
        del bt, nt, leaf_buf, st_plain

    # K3 at the state tree's widest inner level
    k3_ms, _ = cuda_ms(lambda: treehash.tree_inner_level(buf, template, child_rows, off),
                       reps=10)
    k3_plain_ms, _ = cuda_ms(
        lambda: treehash.tree_inner_level_ref(buf_plain, template, child_rows, off), reps=1)
    n3 = len(inners)
    k3_b, k3_by = bound_ms(n3 * 5 * SHA_BLOCK_OPS,
                           template.numel() * 4 + child_rows.numel() * 4
                           + 32 * nkids + 32 * n3, int32_rate)

    emit("times", card=name_power, host_prep_ms_per_chunk=prep_ms, chunk=CHUNK,
         flood_sigs_per_s=N_FLOOD / flood_s,
         seal_ms={k: v["seal_ms"] for k, v in seals.items()},
         hashlib_seal_ms={k: v["hashlib_seal_ms"] for k, v in seals.items()},
         k1_shape=[CHUNK], k2_shape=k2_shape, k3_nodes=n3,
         int32_ops_per_s=int32_rate, total_s=time.perf_counter() - t_start)
    kernels = [
        dict(name="ed25519_verify", route="cuda",
             source="stellard_tpu_torch/csrc/ed25519_verify.cu",
             replaces="stellard_tpu/ops/ed25519_pallas.py:107",
             launches=launches["ed25519_verify"] + close["launches"]["ed25519_verify"],
             max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_b, bound_by=k1_by,
             library_ms=None),
        dict(name="sha512_masked", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/ops/treehash_jax.py:49",
             launches=launches["sha512_masked"] + close["launches"]["sha512_masked"],
             max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_b, bound_by=k2_by,
             library_ms=None),
        dict(name="tree_inner_level", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/parallel/mesh.py:149",
             launches=launches["tree_inner_level"] + close["launches"]["tree_inner_level"],
             max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_b, bound_by=k3_by,
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def close_phase(dev, name_power: str) -> dict:
    """The standalone node under a payment flood (CLOSE_SIZES): 4 closes
    of 4,096 signed Payments over 1,000,000 AccountRoots, each close one
    batched verify on the card (K1), the transactor engine's open apply
    and close, and both trees sealed by CudaHasher (K2, K3). Every
    verdict, TER, ledger hash and results digest is checked; the launch
    counts are this phase's alone."""
    import numpy as np

    from stellard_tpu_torch.crypto.backend import CudaHasher
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.ops import ed25519_cuda, treehash
    from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref
    from stellard_tpu_torch.protocol import keys
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction
    from stellard_tpu_torch.protocol.ter import TER

    t0 = time.perf_counter()
    wl = close_workload(**CLOSE_SIZES)
    inputs_s = time.perf_counter() - t0
    hasher = CudaHasher(device=dev)
    plane = VerifyPlane(backend="cuda", routing="device", backend_opts={"device": dev})
    k1_per_close = []

    def on_close(_k, _ledger):
        k1_per_close.append(ed25519_cuda.launches)

    ed25519_cuda.launches = 0
    for k in treehash.launches:
        treehash.launches[k] = 0
    keys.host_verifies = 0
    try:
        t0 = time.perf_counter()
        out = run_closes(wl, hasher, plane.verify_many, on_close)
        closes_s = time.perf_counter() - t0
    finally:
        plane.stop()
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
    host_verifies = keys.host_verifies

    start, closes = out[0], out[1:]
    pj = plane.get_json()
    n_pay = sum(len(c) for c in wl["closes"])
    for k, (c, entries) in enumerate(zip(closes, wl["closes"])):
        kinds = [kind for _b, kind, _g in entries]
        require(c["verdicts"] == [g for _b, _k, g in entries], f"close {k}: verdicts wrong")
        want = [int(TER.temINVALID) if kd == "bad_sig" else int(TER.tesSUCCESS)
                for kd in kinds]
        require(c["open_ters"] == want, f"close {k}: open-ledger TERs wrong")
        require(len(c["close_ters"]) == len(kinds) - kinds.count("bad_sig")
                and set(c["close_ters"].values()) == {int(TER.tesSUCCESS)},
                f"close {k}: closed TERs wrong")
        require(c["hash"] == CLOSE_HASHES[k], f"close {k}: ledger hash {c['hash']} "
                f"differs from the JAX package's {CLOSE_HASHES[k]}")
        require(c["digest"] == CLOSE_DIGESTS[k], f"close {k}: results digest differs")
    require(start["hash"] == START_HASH, "start ledger hash differs from the JAX package's")
    require(host_verifies == 0, f"{host_verifies} host signature verifications on the close path")
    require(pj["device_share"] == 1.0, f"close phase device share {pj['device_share']}")
    require(all(b - a >= 1 for a, b in zip([0] + k1_per_close, k1_per_close)),
            f"K1 was not launched in every close: {k1_per_close}")
    tt = hasher.tree_transfers
    require(tt.readbacks == hasher.tree_calls, f"readbacks {tt.readbacks} != tree calls "
            f"{hasher.tree_calls}")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the close phase")

    # K1 against its plain version at the shape the close gave it (one
    # close's batch, outside the counted run)
    txs = [SerializedTransaction.from_bytes(b) for b, _k, _g in wl["closes"][0]]
    tens = to_tensors(prepare_batch([tx.signing_pub_key for tx in txs],
                                    [tx.signing_hash() for tx in txs],
                                    [tx.signature for tx in txs]), dev)
    got, plain = ed25519_cuda.verify(**tens), verify_kernel_ref(**tens)
    k1_err = max_abs_err(got, plain)
    require(k1_err == 0, "K1 differs from its plain version on a close's batch")
    require(got.cpu().numpy().tolist() == closes[0]["verdicts"], "K1 verdicts on a close's batch")

    summary = {
        "card": name_power, "accounts": CLOSE_SIZES["n_accounts"],
        "senders": CLOSE_SIZES["n_senders"], "closes": len(closes), "payments": n_pay,
        "payments_per_s": n_pay / sum(c["wall_ms"] for c in closes) * 1e3,
        "inputs_s": inputs_s, "build_state_ms": start["build_state_ms"],
        "load_ms": start["load_ms"], "phase_s": closes_s,
        "per_close": [{key: c[key] for key in (
            "seq", "wall_ms", "parse_verify_ms", "apply_ms", "close_ms", "seal_state_ms",
            "seal_state_nodes", "seal_tx_ms", "seal_tx_nodes", "gc_ms",
            "gc_full_collections")} for c in closes],
        "kinds": {kd: sum(kind == kd for c in wl["closes"] for _b, kind, _g in c)
                  for kd in ("existing", "new_account", "bad_sig")},
        "hashes_equal_jax": True, "host_verifies": host_verifies,
        "device_share": pj["device_share"], "device_batches": pj["device_batches"],
        "tree_calls": hasher.tree_calls, "readbacks": tt.readbacks,
        "k1_launches_per_close": np.diff([0] + k1_per_close).tolist(),
        "launches": launches,
    }
    emit("close", **summary)
    return {"launches": launches, "k1_max_abs_err": k1_err}


def leaf_blocks(m):
    """Every leaf message of m (prefix ‖ data ‖ tag), padded to the one
    ladder size they all fit, as the seal hands them to K2."""
    import numpy as np

    from stellard_tpu_torch.ops.treehash import ladder_buckets, pad_packed
    from stellard_tpu_torch.state.shamap import encode_nodes

    buf, offsets = encode_nodes(list(m.leaves()))
    off = np.asarray(offsets, np.int64)
    lengths = np.diff(off)
    oversized, buckets = ladder_buckets(lengths)
    require(len(oversized) == 0 and len(buckets) == 1, "leaves span ladder sizes")
    return pad_packed(buf, off[:-1], lengths, buckets[0][0])

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import stellard_tpu_torch
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing beside this script: {exc}",
              file=sys.stderr)
        return 2
    if Path(stellard_tpu_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: stellard_tpu_torch was not imported from this checkout",
              file=sys.stderr)
        return 2
    try:
        run(torch.device("cuda", 0))
    except Exception as exc:  # noqa: BLE001 — report the failed phase, exit non-zero
        emit("failed", error=f"{type(exc).__name__}: {exc}")
        import traceback

        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
