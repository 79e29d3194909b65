#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellard_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the ledger close's device plane, then a standalone node's
closes and its order book and path searches, then the catch-up replay of
the chain it saved, through the entry points a node calls, at the sizes
a close really has, and checks every result:

1. device   — the card's name and power limit; builds the four CUDA
              kernels (one nvcc a source, started together) and prints
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
              ledger (each accept also speculated once in close mode)
              and closes it as the JAX node does by default
              (close_and_advance: the recorded deltas spliced, the
              building tree pre-hashed between closes by the seal
              drainer and adopted, both trees sealed by CudaHasher on
              two threads beside the txdb rows: K2, K3), then persists
              it through the close pipeline (ClosePipeline: the node
              store, a file-backed txdb and a file-backed CLF, whose
              first commit imports the whole resumed state). Every
              verdict and TER as expected, no host signature check, K1
              launched in every close, the drainer and both seal threads
              launching K2/K3, no error absorbed by the close's helpers,
              one readback per sealed tree, and every ledger hash and
              results digest, every close's splice split and adoption
              and its persisted txdb rows and CLF equal to the JAX
              package's on the same blobs (START_HASH, CLOSE_HASHES,
              CLOSE_DIGESTS, DELTAS, TXDB_DIGESTS, CLF_DIGESTS;
              recomputed by tests/test_torch_close.py's slow test:
              JAX_PLATFORMS=cpu python -m pytest tests/test_torch_close.py -m slow -q -s).
              Then K1 against its plain version on a close's batch.
6. book     — the order book on the same chain (BOOK_SIZES, BASELINE
              configs #2 and #3): 16 gateways issuing 32 IOUs (four set a
              TransferRate), 2,048 traders with two trust lines each,
              1,024 of them with a regular key; then 4,096 issuing
              payments; then two closes of 4,096 transactions (offer
              asks and bids on overlapping price ladders over 32 IOU/STR
              and 32 IOU/IOU markets, cancels, AccountSets signed with
              the regular key, cross-currency path payments, merges, ~1%
              bad signatures). Each close verified by K1, applied by the
              port's transactors, closed and persisted as in the close
              phase, and the path plane's live book index advanced; then
              the close pipeline is drained, and 64 path searches run
              on the last ledger, pre-ranked by K4 through
              PathPlane(evaluator=make_path_evaluator(routing="device"))
              with the prune floor BOOK_PRUNE_FLOOR. Every verdict as
              expected, every ledger hash and results digest, splice
              split, adoption, persisted digest and the digest of the
              path answers equal to the JAX package's (BOOK_HASHES,
              BOOK_DIGESTS, PATHS_DIGEST, from the same slow test), no
              host signature check, one readback per sealed tree, K1-K4
              launched. Then K4 against its plain version on every batch
              it ranked. The start ledger is saved to an on-disk segstore
              node store (the JAX node's defaults) before the first
              close, each of the 8 closed ledgers by the close
              pipeline's node-store stage; the close_pipeline line gives
              each ledger's stage times.
7. times    — every kernel against its plain version again, exactly, at
              the shapes the main path gave it: K1 on both flood
              chunks, K2 on every leaf of the
              state and transaction trees, K3 on the state tree's widest
              inner level, K4 on a 1,048,576 x 8 rate matrix (identity
              and saturating rows among rates near 1.0, also held to the
              NumPy host arm); each kernel and plain version timed with
              CUDA events on those inputs, with its bound. K4's kernel
              time is taken on raw launches cycling over four such
              matrices (134 MB, more than the L2), its wrapper's per-call
              time apart. K1 is timed again on the first chunk with
              every S non-canonical and with every key undecodable,
              which stop each lane before and after the decode: the
              split of its time by phase.
8. replay   — catch-up replay (BASELINE config #5) of that chain: the
              store's records and each save's node count equal to the
              JAX package's (STORE_DIGEST, SAVE_NODES, from the same slow
              test); a forged copy of 1006 (one signature bit flipped in
              its tx map) saved beside it; the store closed and reopened
              from disk; then node/ledgertools.replay_range over 1005,
              1006, the forged 1006 and 1007 — every signature of the
              span in one verify_many on the card (K1), each ledger
              loaded eagerly with its parent, re-applied and sealed by
              CudaHasher (K2, K3). Every real ledger's replayed hash and
              closed results equal to its close's and to the JAX
              package's (CLOSE_RESULT_DIGESTS, BOOK_RESULT_DIGESTS), no
              host signature check, no node hashed on the host but
              leaves too long for K2's block ladder and empty inner
              nodes, one readback per sealed tree; K1 rejects exactly
              the forged lane and the forged ledger alone fails. The
              span is cut from the 8 saved ledgers to 3 to fit the time
              limit (PERF.md §4). The store is removed at the end.

Launch counts are zeroed just before phases 3-4 and read just after, and
again around phase 5, around phase 6 and around phase 8's replay; the
kernels line shows the sum, the launches of the main path alone, and
for K2 and K3 the close and book phases' launches by who made them (the
seal drainer, the two seal threads, the closing thread). Any
failed check exits non-zero without the final line. Without a CUDA device, or without the package
beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import shutil
import subprocess
import sys
import threading
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
K4_ROWS = 1 << 20  # K4's timed matrix: 1,048,576 candidate paths
K4_ROTATE = 4  # distinct K4 matrices its kernel-only time cycles over (134 MB, > L2)
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
# K4, per hop: the 32x32->64 product (lo and hi: 2), the funnel shift
# that takes bits 16..47 (1), the compare of the high bits (1) and the
# saturating select (1)
K4_HOP_OPS = 5
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


def raw_launch_ms(fn, args: list, reps: int) -> float:
    """Mean ms of a C launcher called `reps` times back to back, cycling
    over the prepared argument tuples `args`, by CUDA events (warmed once
    on each); every call's error code must be 0."""
    import torch

    errs = [fn(*a) for a in args]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        errs.append(fn(*args[i % len(args)]))
    end.record()
    end.synchronize()
    require(not any(errs), f"a raw launch failed: CUDA error {max(errs)}")
    return start.elapsed_time(end) / reps


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


def launches_by_role(*phases) -> dict:
    """K2's and K3's launches in the close and book phases (each a
    treehash.launches_by_thread), by who launched them: the seal drainer,
    the close's two seal threads, or the closing thread itself."""
    out = {k: {"drainer": 0, "seal": 0, "close_thread": 0}
           for k in ("sha512_masked", "tree_inner_level")}
    for by_thread in phases:
        for name, per in by_thread.items():
            role = ("drainer" if name == "seal-drain" else
                    "seal" if name.startswith("seal-hash-") else "close_thread")
            for k, n in per.items():
                out[k][role] += n
    return out


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
    return {"accounts": accounts, "sender_seeds": sender_seeds, "closes": closes,
            "next_seqs": seqs}


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


def close_results_digest(close_results) -> str:
    """The close half of results_digest: SHA-256 over (txid, TER) of
    every closed transaction in txid order. `close_results` maps txids
    (bytes, or hex as replay_ledger reports them) to TERs."""
    h = hashlib.sha256()
    for txid, ter in sorted((bytes.fromhex(t) if isinstance(t, str) else t, r)
                            for t, r in close_results.items()):
        h.update(txid + int(ter).to_bytes(4, "big", signed=True))
    return h.hexdigest()


def save_counted(ledger, db) -> dict:
    """Ledger.save into `db` (either package's node store), with what it
    wrote: tree nodes the store did not hold yet plus the header, the
    bytes its backend appended (segstore) and the wall ms."""
    n0 = len(db.flushed)
    b0 = getattr(db.backend, "bytes_appended", 0)
    t0 = time.perf_counter()
    h = ledger.save(db)
    ms = (time.perf_counter() - t0) * 1e3
    return {"seq": ledger.seq, "hash": h.hex(), "nodes": len(db.flushed) - n0 + 1,
            "bytes": getattr(db.backend, "bytes_appended", 0) - b0, "ms": ms}


def segstore_records(backend):
    """Every (key, type, blob) record of a segstore backend (either
    package's), read back through its segment door."""
    import struct

    for meta in backend.segments():
        _meta, raw = backend.fetch_segment(meta["id"])
        off = 0
        while off + 37 <= len(raw):
            body_len = struct.unpack_from("<I", raw, off)[0]
            yield raw[off + 5 : off + 37], raw[off + 37], raw[off + 38 : off + 37 + body_len]
            off += 37 + body_len


def store_digest(records) -> str:
    """SHA-256 over (key, type, blob length, blob) of every record, in
    key order."""
    h = hashlib.sha256()
    for key, type_, blob in sorted(records):
        h.update(key + bytes([type_]) + len(blob).to_bytes(4, "big"))
        h.update(blob)
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


class StageClock:
    """A tracer for the close pipeline that keeps the ms of each
    ``persist.*`` span by ledger sequence (the pipeline's own stage
    clock); it records no spans of its own."""

    enabled = False

    def __init__(self):
        self.ms: dict[int, dict[str, float]] = {}
        self._lock = threading.Lock()

    def complete(self, name: str, _cat: str, t0: float, t1: float, seq=None, **_attrs):
        if name.startswith("persist.") and seq is not None:
            with self._lock:
                self.ms.setdefault(seq, {})[name[len("persist."):]] = (t1 - t0) * 1e3

    def span(self, *_a, **_kw):
        return contextlib.nullcontext()

    def instant(self, *_a, **_kw) -> None:
        pass

    def sampled(self, _txid) -> bool:
        return False


def txdb_digest(txdb, seq: int) -> str:
    """SHA-256 over one ledger's txdb rows (either package's
    TxDatabase): its Ledgers header row, its Transactions rows and its
    AccountTransactions rows, each table in key order."""
    h = hashlib.sha256()
    with txdb._lock:
        for sql in (
            "SELECT * FROM Ledgers WHERE LedgerSeq = ? ORDER BY LedgerHash",
            "SELECT * FROM Transactions WHERE LedgerSeq = ? ORDER BY TransID",
            "SELECT * FROM AccountTransactions WHERE LedgerSeq = ? "
            "ORDER BY TransID, Account, TxnSeq",
        ):
            rows = txdb._conn.execute(sql, (seq,)).fetchall()
            h.update(len(rows).to_bytes(4, "big"))
            for row in rows:
                h.update(repr(row).encode())
    return h.hexdigest()


def clf_digest(clf) -> str:
    """SHA-256 over a CLF mirror (either package's CLFMirror): its
    StoreState (the LCL hash and header) and its accounts, trustlines
    and offers tables, each in key order."""
    h = hashlib.sha256()
    for sql in ("SELECT * FROM StoreState ORDER BY StateName",
                "SELECT * FROM accounts ORDER BY account_id",
                "SELECT * FROM trustlines ORDER BY index_hex",
                "SELECT * FROM offers ORDER BY index_hex"):
        rows = clf.db.query(sql)
        h.update(len(rows).to_bytes(4, "big"))
        for row in rows:
            h.update(repr(row).encode())
    return h.hexdigest()


def close_delta(lm, before: dict) -> dict:
    """What one close of either package's LedgerMaster did with its
    speculation: the spliced / fallback / invalidated counts (from the
    snapshot ``before`` it of ``lm.delta_stats``) and the incremental
    seal's adoption outcome ("none" when the close had no speculation)."""
    after = lm.delta_stats.snapshot()
    out = {k: after[k] - before.get(k, 0) for k in ("spliced", "fallback", "invalidated")}
    out["seal_adopt"] = (lm.last_close.get("seal_adopt")
                         if after["closes"] > before.get("closes", 0) else "none")
    return out


class ChainPersist:
    """The JAX node's persistence of its closes (its node/node.py wiring
    of ``persist_prep`` and the close pipeline) around either package's
    classes: ``lm.persist_prep`` builds the txdb rows beside the threaded
    seal, and every closed ledger goes through a ``pipeline_cls`` whose
    stages are ``save_stage`` (the node store), the txdb (header and rows
    in one transaction) and the CLF commit against its parent. After
    each ledger is persisted, its txdb rows and the whole CLF are
    digested on the pipeline's worker (``digests``, by sequence)."""

    def __init__(self, lm, pipeline_cls, txdb, clf, build_tx_rows, results_from_meta,
                 save_stage, depth: int = 8):
        self.lm, self.txdb, self.clf = lm, txdb, clf
        self.digests: dict[int, dict] = {}
        self._landed = threading.Condition()
        self._submitted = self._failed = 0
        self.clock = StageClock()
        lm.persist_prep = build_tx_rows

        def txdb_stage(ledger, results):
            rows = getattr(ledger, "persist_rows", None)
            if rows is None:
                rows = build_tx_rows(ledger, results)
            else:
                ledger.persist_rows = None
            txdb.save_ledger(ledger, rows)

        def clf_stage(ledger):
            clf.commit_ledger_close(ledger, lm.get_ledger_by_hash(ledger.parent_hash))

        self.pipeline = pipeline_cls(
            save_stage=save_stage, txdb_stage=txdb_stage, clf_stage=clf_stage,
            recover_results=results_from_meta, depth=depth, tracer=self.clock)

    def submit(self, ledger, results) -> None:
        seq = ledger.seq
        self._submitted += 1

        def done(_results):
            dg = {"txdb": txdb_digest(self.txdb, seq), "clf": clf_digest(self.clf)}
            with self._landed:
                self.digests[seq] = dg
                self._landed.notify_all()

        def failed():
            with self._landed:
                self._failed += 1
                self._landed.notify_all()

        self.pipeline.submit_close(ledger, results, done=done, on_failed=failed)

    def flush(self) -> None:
        """Wait until every ledger submitted so far is persisted and
        digested (the pipeline's ``done`` runs after its own flush
        returns) or has failed."""
        require(self.pipeline.flush(timeout=3600), "the close pipeline did not drain")
        with self._landed:
            require(self._landed.wait_for(
                lambda: len(self.digests) + self._failed >= self._submitted, timeout=3600),
                "a persisted ledger was never digested")

    def stop(self) -> None:
        """Drain the pipeline (every queued ledger persisted first) and
        stop its worker."""
        self.flush()
        require(self.pipeline.stop(timeout=3600), "the close pipeline did not stop")


def run_closes(wl: dict, hash_batch, verify_many, on_close=None,
               on_start=None, setup=None) -> tuple[list[dict], dict]:
    """The port's standalone node over the workload: the start ledger
    through LedgerMaster.load_ledger (then ``on_start(start)`` and
    ``setup(lm)``), then per close one batched verify of its
    transactions (node/ledgertools._reverify_memoized, verdicts memoized
    and flagged SF_SIGGOOD), do_transaction on each in OPEN_LEDGER|RETRY
    mode and close_and_advance (then ``on_close(k, ledger, results)``).
    Returns per close the ledger hash, the results digest, the verdicts,
    the TERs, what the delta replay did and the times, and the node
    (``lm``, ``router``) for the book phase to go on with."""
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
    if on_start is not None:
        on_start(start)
    if setup is not None:
        setup(lm)
    mode = TxParams.OPEN_LEDGER | TxParams.RETRY
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    try:
        for k, entries in enumerate(wl["closes"]):
            rec = _one_close(lm, router, verify_many, entries, k, mode, gc_clock)
            out.append(rec)
            if on_close is not None:
                on_close(k, lm.closed_ledger(), rec["results"])
    finally:
        gc.callbacks.remove(gc_clock)
    return out, {"lm": lm, "router": router}


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
    before = lm.delta_stats.snapshot()
    ledger, results = lm.close_and_advance(START_CLOSE_TIME + 30 * (k + 1), 30)
    td = time.perf_counter()
    last = lm.last_close
    return {
        "seq": ledger.seq, "hash": ledger.hash().hex(), "results": results,
        "digest": results_digest(open_ters, results),
        "close_digest": close_results_digest(results),
        "delta": close_delta(lm, before),
        "verdicts": verdicts, "open_ters": [int(t) for _, t in open_ters],
        "close_ters": {txid: int(t) for txid, t in results.items()},
        "wall_ms": (td - ta) * 1e3, "parse_verify_ms": (tb - ta) * 1e3,
        "apply_ms": (tc - tb) * 1e3, "close_ms": (td - tc) * 1e3,
        "close_apply_ms": last["apply_ms"], "close_seal_ms": last["seal_ms"],
        "seal_tx_ms": last["seal_tx_ms"], "seal_tx_nodes": last["seal_tx_nodes"],
        "seal_state_ms": last["seal_state_ms"],
        "seal_state_nodes": last["seal_state_nodes"],
        "gc_ms": gc_clock.ms - gc_ms, "gc_full_collections": gc_clock.full - gc_full,
    }


# --------------------------------------------------------------------------
# the book phase: the order book on the same chain (BASELINE configs #2, #3)

ISO_CODES = ("USD", "EUR", "JPY", "GBP", "CNY", "BTC", "AUD", "CHF")
# TransferRate of the first gateways (parts per billion: 1.002-1.010)
TRANSFER_RATES = (1_002_000_000, 1_005_000_000, 1_008_000_000, 1_010_000_000)


def book_workload(wl: dict, n_gateways: int, n_traders: int, n_regular: int,
                  per_close: int, n_merges: int, n_requests: int, seed: int) -> dict:
    """Seeded inputs of the book phase, on the senders of close_workload
    `wl` after its closes (their next sequences in ``wl["next_seqs"]``):

    - the first n_gateways senders are gateways; gateway g issues two
      currency codes (ISO_CODES in turn, so every code has several
      issuers): IOU j = (code j % 8, gateway j // 2), 2 * n_gateways IOUs,
      each with a mid price of 0.5 + 0.05 j STR;
    - the next n_traders senders are traders: trader t trusts IOU
      a = t % n_iou and a + 1, so it can trade a/STR, (a+1)/STR and the
      IOU/IOU market a/(a+1): n_iou IOU/STR and n_iou IOU/IOU markets;
    - the rest are plain accounts; 2 * n_merges of them merge pairwise.

    ``closes`` holds four closes of (blob, kind, expected verdict):

    1. setup: TransferRate AccountSets by the first gateways, the
       traders' TrustSets (two each), and SetRegularKey by the first
       n_regular traders;
    2. one issuing Payment a trust line, gateway to trader;
    3-4. per_close transactions each: half the merges, then ~40% asks
       and ~40% bids on price ladders around the mid that overlap (some
       rest, some cross fully or in part), ~12% OfferCancel of a live
       offer, ~4% AccountSet (a TransferRate) signed with the trader's
       regular key, ~2% cross-currency Payments with a SendMax and an
       explicit path through the STR books, ~2% more asks; ~1% of all
       carry a corrupted signature (temINVALID, their sequence unused).

    ``requests`` holds n_requests path searches on the last ledger:
    (source, destination, delivered amount, SendMax or None)."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref
    from stellard_tpu_torch.protocol.formats import TxType
    from stellard_tpu_torch.protocol.keys import KeyPair
    from stellard_tpu_torch.protocol.sfields import (
        sfAmount, sfDestination, sfLimitAmount, sfOfferSequence, sfPaths,
        sfRegularKey, sfSendMax, sfTakerGets, sfTakerPays, sfTransferRate,
        sfTxnSignature)
    from stellard_tpu_torch.protocol.stamount import STAmount, currency_from_iso
    from stellard_tpu_torch.protocol.stobject import PathElement, STPathSet
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    rng = np.random.default_rng(seed)
    keys = [KeyPair.from_seed(sd) for sd in wl["sender_seeds"]]
    seqs = list(wl["next_seqs"])
    n_iou = 2 * n_gateways
    gw = list(range(n_gateways))
    tr = list(range(n_gateways, n_gateways + n_traders))
    plain = list(range(n_gateways + n_traders, len(keys)))
    require(len(plain) >= 2 * n_merges and n_regular <= n_traders, "book sizes")
    reg_keys = {t: KeyPair.from_seed(rng.bytes(32)) for t in tr[:n_regular]}
    code = [currency_from_iso(ISO_CODES[j % len(ISO_CODES)]) for j in range(n_iou)]
    issuer = [keys[gw[j // 2]].account_id for j in range(n_iou)]
    mid = [0.5 + 0.05 * j for j in range(n_iou)]
    # the second line: the next IOU (another code) for even traders; for
    # odd ones the same code from another gateway (market makers that
    # bridge gateways), when there are more IOUs than codes
    same = len(ISO_CODES) if n_iou > len(ISO_CODES) else 1
    held = {t: ((t - tr[0]) % n_iou,
                ((t - tr[0]) % n_iou + (same if (t - tr[0]) % 2 else 1)) % n_iou)
            for t in tr}
    xrp = b"\x00" * 20

    def iou(j: int, units: float) -> STAmount:
        return STAmount.from_iou(code[j], issuer[j], int(round(units * 100)), -2)

    def drops(units_str: float) -> STAmount:
        return STAmount.from_drops(int(round(units_str * 1_000_000)))

    def tx_of(who: int, tx_type, fields: dict, signer=None):
        tx = SerializedTransaction.build(tx_type, keys[who].account_id, seqs[who], 10, fields)
        tx.sign(signer or keys[who])
        return tx

    def entry(who: int, tx, kind: str, corrupt: bool = False):
        good = True
        if corrupt:
            sig = bytearray(tx.signature)
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            tx.obj[sfTxnSignature] = bytes(sig)
            good = ed25519_ref.verify(tx.signing_pub_key, tx.signing_hash(), bytes(sig))
            kind = "bad_sig" if not good else kind
        if good:
            seqs[who] += 1
        return (tx.serialize(), kind, good), good

    # 1. setup
    setup = []
    for g, rate in zip(gw, TRANSFER_RATES):
        setup.append(entry(g, tx_of(g, TxType.ttACCOUNT_SET, {sfTransferRate: rate}),
                           "transfer_rate")[0])
    for t in tr:
        for j in held[t]:
            setup.append(entry(t, tx_of(t, TxType.ttTRUST_SET, {
                sfLimitAmount: STAmount.from_iou(code[j], issuer[j], 1_000_000, 0)}),
                "trust_set")[0])
        if t in reg_keys:
            setup.append(entry(t, tx_of(t, TxType.ttREGULAR_KEY_SET, {
                sfRegularKey: reg_keys[t].account_id}), "regular_key_set")[0])
    # 2. issuance
    issue = []
    for t in tr:
        for j in held[t]:
            g = gw[j // 2]
            issue.append(entry(g, tx_of(g, TxType.ttPAYMENT, {
                sfDestination: keys[t].account_id,
                sfAmount: iou(j, int(rng.integers(1000, 5001)))}), "issue")[0])
    # 3-4. the order book
    live: list[tuple[int, int]] = []  # (trader, offer sequence)
    merges = [(plain[i], plain[i + n_merges]) for i in range(n_merges)]
    closes = [setup, issue]
    for c in range(2):
        entries = []
        for src, dst in merges[c * n_merges // 2 : (c + 1) * n_merges // 2]:
            entries.append(entry(src, tx_of(src, TxType.ttACCOUNT_MERGE, {
                sfDestination: keys[dst].account_id}), "account_merge")[0])
        for k in range(per_close - len(entries)):
            t = tr[(c * per_close + k) % n_traders]
            a, b = held[t]
            u = rng.random()
            corrupt = rng.random() < 0.01
            if u < 0.12 and live:
                owner, oseq = live.pop(int(rng.integers(len(live))))
                e, ok = entry(owner, tx_of(owner, TxType.ttOFFER_CANCEL,
                                           {sfOfferSequence: oseq}), "offer_cancel", corrupt)
                if not ok:
                    live.append((owner, oseq))
                entries.append(e)
                continue
            if 0.12 <= u < 0.16 and t in reg_keys:
                entries.append(entry(t, tx_of(t, TxType.ttACCOUNT_SET, {
                    sfTransferRate: 1_000_000_000 + int(rng.integers(0, 7)) * 1_000_000},
                    signer=reg_keys[t]), "regular_key_account_set", corrupt)[0])
                continue
            if 0.16 <= u < 0.18:
                # pay a trader who holds an IOU this one does not, in that
                # IOU, spending this one's IOU a through the STR books
                v = tr[int(rng.integers(n_traders))]
                cj = held[v][0] if held[v][0] not in held[t] else held[v][1]
                if v == t or cj in held[t]:
                    cj, v = None, None
                if v is not None:
                    units = int(rng.integers(1, 21))
                    fields = {sfDestination: keys[v].account_id, sfAmount: iou(cj, units),
                              sfSendMax: iou(a, units * mid[cj] / mid[a] * 1.5),
                              sfPaths: STPathSet([[PathElement(currency=xrp),
                                                   PathElement(currency=code[cj],
                                                               issuer=issuer[cj])]])}
                    entries.append(entry(t, tx_of(t, TxType.ttPAYMENT, fields),
                                         "cross_payment", corrupt)[0])
                    continue
            # an offer: IOU/STR on a or b, or the IOU/IOU market a/(a+1)
            ask = u < 0.58 or u >= 0.98
            m = int(rng.integers(3))
            units = int(rng.integers(1, 51))
            step = int(rng.integers(-2, 8)) * 0.002
            if m < 2:
                j = (a, b)[m]
                price = mid[j] * (1 + step if ask else 1 - step)
                pays, gets = ((drops(units * price), iou(j, units)) if ask
                              else (iou(j, units), drops(units * price)))
            else:
                price = mid[a] / mid[b] * (1 + step if ask else 1 - step)
                pays, gets = ((iou(b, units * price), iou(a, units)) if ask
                              else (iou(a, units), iou(b, units * price)))
            oseq = seqs[t]
            e, ok = entry(t, tx_of(t, TxType.ttOFFER_CREATE,
                                   {sfTakerPays: pays, sfTakerGets: gets}),
                          "offer_ask" if ask else "offer_bid", corrupt)
            if ok:
                live.append((t, oseq))
            entries.append(e)
        closes.append(entries)
    # path searches on the last ledger
    requests = []
    while len(requests) < n_requests:
        t, v = (tr[int(i)] for i in rng.integers(n_traders, size=2))
        cj = held[v][int(rng.integers(2))]
        if t == v or cj in held[t]:
            continue
        if same > 1 and len(requests) % 4 < 2 and code[cj] != code[held[t][0]]:
            continue  # half the searches: the same currency, another issuer
        amount = iou(cj, int(rng.integers(1, 11)))
        send_max = iou(held[t][0], 10_000) if len(requests) % 2 else None
        requests.append((keys[t].account_id, keys[v].account_id, amount, send_max))
    return {"closes": closes, "requests": requests, "n_iou": n_iou}


def paths_digest(answers) -> str:
    """SHA-256 over every request's answers (either package's objects):
    per alternative its paths' (account, currency, issuer) elements and
    the wire bytes of its source and delivered amounts."""
    h = hashlib.sha256()
    for alts in answers:
        h.update(len(alts).to_bytes(4, "big"))
        for alt in alts:
            for path in alt["paths"]:
                h.update(b"P")
                for e in path:
                    for part in (e.account, e.currency, e.issuer):
                        h.update(b"-" if part is None else part)
            h.update(b"S" + alt["source_amount"].wire_bytes())
            h.update(b"D" + alt["delivered"].wire_bytes())
    return h.hexdigest()


def run_book(node: dict, bwl: dict, verify_many, plane, first_close: int,
             on_close=None) -> dict:
    """The book phase on the node run_closes left: the order book's
    closes (verify, open apply, close_and_advance as the close phase,
    then ``plane.note_close``), then every path search of ``bwl`` on the
    last ledger as the node's path_find door makes it (books from the
    plane's live index, candidates pre-ranked by the plane)."""
    from stellard_tpu_torch.engine.engine import TxParams
    from stellard_tpu_torch.paths import find_paths

    lm, router = node["lm"], node["router"]
    t0 = time.perf_counter()
    plane.note_close(lm.closed_ledger())  # the first advance: a full scan
    index_ms = (time.perf_counter() - t0) * 1e3
    mode = TxParams.OPEN_LEDGER | TxParams.RETRY
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    closes = []
    try:
        for k, entries in enumerate(bwl["closes"]):
            rec = _one_close(lm, router, verify_many, entries, first_close + k, mode,
                             gc_clock)
            t1 = time.perf_counter()
            plane.note_close(lm.closed_ledger())
            rec["index_ms"] = (time.perf_counter() - t1) * 1e3
            closes.append(rec)
            if on_close is not None:
                on_close(k, lm.closed_ledger(), rec["results"])
        ledger = lm.closed_ledger()
        candidates = []
        pre_rank = plane.make_pre_rank(ledger)

        def counted(les, cands):
            candidates.append(len(cands))
            return pre_rank(les, cands)

        t2 = time.perf_counter()
        answers = [
            find_paths(ledger, src, dst, amount, send_max=send_max,
                       books=plane.books_if_current(ledger), pre_rank=counted)
            for src, dst, amount, send_max in bwl["requests"]
        ]
        paths_ms = (time.perf_counter() - t2) * 1e3
    finally:
        gc.callbacks.remove(gc_clock)
    return {"closes": closes, "index_ms": index_ms, "answers": answers,
            "paths_digest": paths_digest(answers), "paths_ms": paths_ms,
            "candidates": candidates, "gc_ms_paths": gc_clock.ms
            - sum(c["gc_ms"] for c in closes)}


# --------------------------------------------------------------------------


def run(dev) -> None:
    """All phases on `dev` (main() passes the first CUDA device)."""
    import numpy as np
    import torch

    from stellard_tpu_torch.crypto.backend import CpuHasher, CudaHasher, VerifyRequest
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.ops import build, ed25519_cuda, ed25519_ref, pathq, treehash
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
    build.build([ed25519_cuda.LIB, treehash.LIB, pathq.LIB])
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

    # 5. the close phase, counted on its own; the chain saved as it closes ---
    saver = ChainSaver(STORE_DIR)
    close = close_phase(dev, name_power, saver)

    # 6. the book phase on the same chain, counted on its own -----------------
    book = book_phase(dev, name_power, close, saver)
    close_launches, close_k1_err = close["launches"], close["k1_max_abs_err"]
    roles = launches_by_role(close["by_thread"], book["by_thread"])
    close_digests = close["close_digests"] + book["close_digests"]
    del close

    # 7. K3 and K4 against plain, and times -----------------------------------
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
    k1_err = max(k1_err, k1_main_err, close_k1_err)
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

    # K4 on a 1,048,576 x 8 matrix: against its plain version and the host
    # arm, exactly; timed. Bound: each rate read once and each composite
    # written once; per hop one 32x32->64 product (2 INT32 issue slots), a
    # funnel shift, a compare and a select (5 slots)
    k4_np = k4_matrix(K4_ROWS, seed=41)
    k4_t = torch.from_numpy(k4_np).to(dev)
    k4_wrapper_ms, k4_got = cuda_ms(lambda: pathq.path_quality(k4_t), reps=20)
    k4_plain_ms, k4_plain = cuda_ms(lambda: pathq.path_quality_ref(k4_t), reps=3)
    k4_err = max_abs_err(k4_got, k4_plain)
    require(k4_err == 0, "K4 differs from its plain version on the 1,048,576-row matrix")
    require(np.array_equal(k4_got.cpu().numpy(), pathq.path_quality_host(k4_np)),
            "K4 differs from the host arm on the 1,048,576-row matrix")
    k4_err = max(k4_err, book["k4_max_abs_err"])
    rows, hops = k4_np.shape
    k4_b, k4_by = bound_ms(rows * hops * K4_HOP_OPS, rows * hops * 4 + rows * 4, int32_rate)
    # the kernel alone: raw launches with pointers and stream prepared
    # outside the timed window, rotating over K4_ROTATE distinct matrices
    # that together exceed the L2, so that each launch reads HBM
    mats = [k4_t] + [torch.from_numpy(k4_matrix(K4_ROWS, seed=41 + i)).to(dev)
                     for i in range(1, K4_ROTATE)]
    outs = [torch.empty(rows, dtype=torch.uint32, device=dev) for _ in mats]
    stream = torch.cuda.current_stream(dev).cuda_stream
    k4_args = [(m.data_ptr(), o.data_ptr(), rows, hops, 1, stream) for m, o in zip(mats, outs)]
    k4_ms = raw_launch_ms(pathq.launcher(), k4_args, reps=40)
    for m, o in zip(mats, outs):
        err = max_abs_err(o, pathq.path_quality_ref(m))
        require(err == 0, "K4's raw launch differs from its plain version")
        k4_err = max(k4_err, err)
    emit("k4_vs_plain", rows=rows, hops=hops, max_abs_err=k4_err, equal_host=True,
         saturated_rows=int((k4_got == pathq.Q16_MAX).sum().item()),
         kernel_ms=k4_ms, wrapper_ms=k4_wrapper_ms, rotated_matrices=len(mats),
         rotated_mb=sum(m.numel() * 4 for m in mats) / 1e6)
    del k4_t, k4_got, k4_plain, mats, outs

    # 8. catch-up replay of the saved chain, counted on its own; the seal
    # phase's trees go first (a smaller heap for the collector)
    del state, txmap, base_items, sets, deletes, inners, buf, buf_plain, template, child_rows
    replay = replay_phase(dev, name_power, saver, close_digests)
    del saver

    emit("times", card=name_power, host_prep_ms_per_chunk=prep_ms, chunk=CHUNK,
         flood_sigs_per_s=N_FLOOD / flood_s,
         seal_ms={k: v["seal_ms"] for k, v in seals.items()},
         hashlib_seal_ms={k: v["hashlib_seal_ms"] for k, v in seals.items()},
         k1_shape=[CHUNK], k2_shape=k2_shape, k3_nodes=n3, k4_shape=[rows, hops],
         int32_ops_per_s=int32_rate, total_s=time.perf_counter() - t_start)
    phases = (launches, close_launches, book["launches"], replay["launches"])
    main_launches = lambda name: sum(ph.get(name, 0) for ph in phases)  # noqa: E731
    kernels = [
        dict(name="ed25519_verify", route="cuda",
             source="stellard_tpu_torch/csrc/ed25519_verify.cu",
             replaces="stellard_tpu/ops/ed25519_pallas.py:107",
             launches=main_launches("ed25519_verify"),
             max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_b, bound_by=k1_by,
             library_ms=None),
        dict(name="sha512_masked", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/ops/treehash_jax.py:49",
             launches=main_launches("sha512_masked"), launches_by_role=roles["sha512_masked"],
             max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_b, bound_by=k2_by,
             library_ms=None),
        dict(name="tree_inner_level", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/parallel/mesh.py:149",
             launches=main_launches("tree_inner_level"), launches_by_role=roles["tree_inner_level"],
             max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_b, bound_by=k3_by,
             library_ms=None),
        dict(name="path_quality", route="cuda",
             source="stellard_tpu_torch/csrc/path_quality.cu",
             replaces="stellard_tpu/ops/pathq_jax.py:68",
             launches=main_launches("path_quality"), max_abs_err=k4_err,
             ms=k4_ms, plain_ms=k4_plain_ms, bound_ms=k4_b, bound_by=k4_by,
             library_ms=None, wrapper_ms=k4_wrapper_ms),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def close_phase(dev, name_power: str, saver) -> dict:
    """The standalone node under a payment flood (CLOSE_SIZES): 4 closes
    of 4,096 signed Payments over 1,000,000 AccountRoots, each close one
    batched verify on the card (K1), the transactor engine's open apply
    and speculation, and the JAX node's default close: the recorded
    deltas spliced, the building tree pre-hashed by the seal drainer
    and adopted, both trees sealed by CudaHasher on two threads (K2,
    K3) beside the txdb rows, then persisted through the close pipeline
    (``saver``, a ChainSaver: node store, txdb, CLF). Every verdict, TER,
    ledger hash, results digest, splice count, adoption and persisted
    digest is checked; the launch counts are this phase's alone. The
    start ledger is saved to the node store before the closes."""
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

    def on_close(k, ledger, results):
        k1_per_close.append(ed25519_cuda.launches)
        saver.persist.submit(ledger, results)

    ed25519_cuda.launches = 0
    treehash.reset_launches()
    keys.host_verifies = 0
    nodes0 = hasher.device_nodes
    try:
        t0 = time.perf_counter()
        out, node = run_closes(wl, hasher, plane.verify_many, on_close,
                               on_start=saver.save, setup=saver.attach)
        closes_s = time.perf_counter() - t0
    finally:
        plane.stop()
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
    by_thread = {k: dict(v) for k, v in treehash.launches_by_thread.items()}
    host_verifies = keys.host_verifies
    tree = node["lm"].tree_json()
    t0 = time.perf_counter()
    saver.persist.flush()
    flush_ms = (time.perf_counter() - t0) * 1e3

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
    check_default_close(closes, 0, saver, "close phase")
    require(host_verifies == 0, f"{host_verifies} host signature verifications on the close path")
    require(pj["device_share"] == 1.0, f"close phase device share {pj['device_share']}")
    require(all(b - a >= 1 for a, b in zip([0] + k1_per_close, k1_per_close)),
            f"K1 was not launched in every close: {k1_per_close}")
    tt = hasher.tree_transfers
    require(tt.readbacks == hasher.tree_calls, f"readbacks {tt.readbacks} != tree calls "
            f"{hasher.tree_calls}")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the close phase")
    check_seal_threads(tree, {}, by_thread, hasher.device_nodes - nodes0, "close phase")

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
        "load_ms": start["load_ms"], "phase_s": closes_s, "pipeline_flush_ms": flush_ms,
        "per_close": [{key: c[key] for key in PER_CLOSE_KEYS} for c in closes],
        "kinds": {kd: sum(kind == kd for c in wl["closes"] for _b, kind, _g in c)
                  for kd in ("existing", "new_account", "bad_sig")},
        "hashes_equal_jax": True, "host_verifies": host_verifies,
        "device_share": pj["device_share"], "device_batches": pj["device_batches"],
        "tree_calls": hasher.tree_calls, "readbacks": tt.readbacks,
        "k1_launches_per_close": np.diff([0] + k1_per_close).tolist(),
        "launches": launches, "launches_by_thread": by_thread,
    }
    emit("close", **summary)
    emit("delta", of="close", per_close=[dict(c["delta"], seq=c["seq"]) for c in closes],
         tree=tree)
    return {"launches": launches, "by_thread": by_thread, "k1_max_abs_err": k1_err,
            "wl": wl, "node": node, "hasher": hasher,
            "close_digests": [c["close_digest"] for c in closes]}


# the book phase's sizes (BASELINE configs #2 and #3 on the close phase's
# chain), and the path plane's prune floor for both packages: the
# JAX node's `[paths] prune_floor` knob (its default is 64, and no search
# of this graph reaches 64 candidates; see PERF.md)
BOOK_SIZES = dict(n_gateways=16, n_traders=2048, n_regular=1024, per_close=4096,
                  n_merges=16, n_requests=64, seed=31)
BOOK_PRUNE_FLOOR = 32
# what the JAX package gives on the same blobs (recomputed by
# tests/test_torch_close.py's slow test, with CLOSE_*)
BOOK_HASHES = [
    "609aaf605b5d694d75af4fbaf3591c7de6df681ee34ec02d58e50c93a908e09a",
    "11944a7086f9b19fb6eb7e5341cdefe9d38aac53207ce4db14671f9caf70d96d",
    "3b2d55bcb84b98cbe6498a312012c10ba310aa2799ed1e81a06078840dd9ed1c",
    "e70b269d6a4651cde3d40f04da9ee180230a94327b42da6dff1ec29aa17d0e52",
]
BOOK_DIGESTS = [
    "f3988b0ce045cd379c1c13800ea1df98f714c72e7d6d4913c19388d8f8d2c261",
    "f9cb231bc438d5ff433f7a498032465d15dd6b2c1346f32e1dfe47b5e70f33a5",
    "68ff64f7593af429f904333b825242380210aceab6dd55417e1a20ee39dc995f",
    "4fc5989d720f705e3d7440daf7d978391ee301dc106e047a2dfcecd419f721bc",
]
PATHS_DIGEST = "ce09b9dbd40e98226cd326b620dac943c828fb4d9c34e7a83362750e09dec1c4"

# the replay phase: per closed ledger the close half of results_digest
# (the closed transactions' TERs, which a replay must reproduce), the
# digest of the store that saved the start ledger and the 8 closed
# ledgers as they closed, and the nodes each of those 9 saves wrote — as
# the JAX package gives them (the same slow test)
CLOSE_RESULT_DIGESTS = [
    "8092f9844179c91af2e0d99f8ffaf4394cab7c8de2e587396a60b578a43e5620",
    "f53266ed4abd871d7122276142f9b9e3f3f2dee2270c80b5157b6b4dc0db8ceb",
    "0b8555c13ce03a6f34847fb10bac4c12a7cc0a454e1aa2c72f6c428e98101798",
    "1d16b8f73584c16a5ebf58c5465dce68da15d8d14ff3a9fcb0e7fb0ca6e61da2",
]
BOOK_RESULT_DIGESTS = [
    "94b11782b4dd00341623bbbe3c92467f4820787b7b621423c34b09dea66fd199",
    "68be128af5bb3e4e48ebc9f741c0b4d5fd2e787b1df0562ce7cd4cc93a1844a8",
    "72e9b9ae547341f50d73617ab014d525683b06ddce418c0546d53a20a505035e",
    "8f982dd2d435ed945772262f73f16aea60f0f82d3d3e94a6a66e99a7ddfd959b",
]
STORE_DIGEST = "c64a11c53559b9db4008fe73165a5c32c62465fba9a3c7f088ef4bf863834252"
SAVE_NODES = [1359552, 30294, 30126, 30351, 30238, 32564, 19245, 35487, 37569]


# the default close of the 8 closes (the close phase's 4, then the book
# phase's 4), as the JAX package's closes them on the same blobs with its
# node's persistence (the same slow test): per close the delta replay's
# (spliced, fallback, invalidated, incremental-seal adoption), and the
# digests of its txdb rows and of the whole CLF once it is persisted
DELTAS = [
    [4008, 39, 39, "adopted"],
    [4007, 28, 28, "adopted"],
    [4020, 26, 26, "adopted"],
    [4010, 40, 40, "adopted"],
    [4, 5120, 5120, "rejected"],
    [28, 4068, 4068, "adopted"],
    [60, 3995, 4196, "rejected"],
    [132, 3919, 4126, "rejected"],
]
TXDB_DIGESTS = [
    "b8b24df7544a4dde64a0cf134d2841f9ec522feb0cf9d2935918f919c51b187d",
    "9496fb3723f4a2d0d99dba309cf22730eb62017f093cdf341756cfedcde62f21",
    "b9473ca1da31ed3d446dd55b7a24d28c6d70fd6a6c24d145643c48e8f18c2cf4",
    "9a8cdff97a610246e254c6a01eb79fa9f317600837e134f5ff305e553b704982",
    "9b22a4cf11a9443f30796bca98c31de251efd5828d07e7529ce6738ccf5bf750",
    "4e3d5c39a887c80b8516526aa8c65dc953aa0ecb77891668f92c137d86c4aaf1",
    "a7997080fad6c3fd03c252e200389ba2102577792c835315f7816d8095c979c4",
    "6d3d0e209e3384cd2e848517674a57b5125a9fee1a5a688900d8c0b231e5de04",
]
CLF_DIGESTS = [
    "c569572d058d8402fbd174385418ea53aa48a531b018d3c54a8b5f3d51c8f896",
    "f5fc1200fe9469d5cac61dc26d1ea04b3396b1d8470c125cf0064a1721ebd18e",
    "e78fdd667a1a8b4ef50cd0bb02903710324e2783914ef999ddf2cf5f37d232b5",
    "6ff16e31d558db86f0140d093751943731c6a1aecb4e8971b4746cb2a3eb286e",
    "e446a6f43683b4e8f738107c0b3cf823e42ece87085f77b22f4aac625c83d5a5",
    "d7b08274793b212c1f15a77ae4617c7a669ac08073a66805628406814d76f2f5",
    "9bc9b82a9ebbd40e37b15bc376a42163be386707d1fcceaa24a38e58cc82b82d",
    "aef9284b8cff4f0877d4de6a4213f91d1e21aaf9fe6c8f0e8165fd35b91739d9",
]
# what one close records of itself, in the close and book lines
PER_CLOSE_KEYS = ("seq", "wall_ms", "parse_verify_ms", "apply_ms", "close_ms",
                  "close_apply_ms", "close_seal_ms", "seal_state_ms", "seal_state_nodes",
                  "seal_tx_ms", "seal_tx_nodes", "gc_ms", "gc_full_collections")
# errors the default close's helpers (drainer, seal threads, persist rows,
# fold, speculation, adoption) counted and absorbed: each must stay 0
ABSORBED = ("drain_errors", "seal_thread_errors", "persist_prep_errors", "fold_errors",
            "spec_errors", "adopt_errors")


def check_default_close(closes: list, first: int, saver, what: str) -> None:
    """Each close's splice split and adoption, and its persisted txdb
    rows and CLF, equal to the JAX package's (closes[i] is close
    first + i of the 8)."""
    for i, c in enumerate(closes):
        k = first + i
        d = c["delta"]
        got = [d["spliced"], d["fallback"], d["invalidated"], d["seal_adopt"]]
        require(got == DELTAS[k], f"{what}, close {c['seq']}: delta replay {got} differs "
                f"from the JAX package's {DELTAS[k]}")
        dg = saver.persist.digests.get(c["seq"])
        require(dg is not None, f"{what}, close {c['seq']}: not persisted")
        require(dg["txdb"] == TXDB_DIGESTS[k], f"{what}, close {c['seq']}: txdb rows differ "
                "from the JAX package's")
        require(dg["clf"] == CLF_DIGESTS[k], f"{what}, close {c['seq']}: CLF differs from "
                "the JAX package's")


def check_seal_threads(tree: dict, tree0: dict, by_thread: dict, device_nodes: int,
                       what: str) -> None:
    """The drainer pre-hashed on the card and the seal ran on its two
    threads on the card, and no helper absorbed an error, over a phase
    (``tree``, ``tree0``: LedgerMaster.tree_json after and before it;
    ``by_thread``: treehash.launches_by_thread of the phase)."""
    grew = {k: tree[k] - tree0.get(k, 0) for k in ("drains", "drained_nodes") + ABSORBED}
    require(grew["drains"] >= 1, f"{what}: the seal drainer never ran")
    require(all(grew[k] == 0 for k in ABSORBED),
            f"{what}: errors absorbed by the close's helpers {grew}")
    drainer = sum(by_thread.get("seal-drain", {}).values())
    seal = sum(n for name, per in by_thread.items() if name.startswith("seal-hash-")
               for n in per.values())
    require(drainer >= 1, f"{what}: the drainer launched no K2/K3 on the card")
    require(seal >= 1, f"{what}: the seal threads launched no K2/K3 on the card")
    require(device_nodes > 0, f"{what}: no node hashed on the card")


def host_only_nodes(root) -> int:
    """The nodes of a tree's unhashed set that K2/K3 do not take: leaves
    whose message needs more SHA-512 blocks than K2's ladder's largest,
    and inner nodes with no child."""
    from stellard_tpu_torch.ops.treehash import LEAF_BLOCK_LADDER
    from stellard_tpu_torch.state.shamap import Inner, _collect_unhashed, encode_nodes

    nodes = [node for level in _collect_unhashed(root) for node in level]
    leaves = [node for node in nodes if not isinstance(node, Inner)]
    empty = sum(1 for node in nodes if isinstance(node, Inner) and not any(node.children))
    _buf, off = encode_nodes(leaves)
    blocks = [(b - a + 17 + 127) // 128 for a, b in zip(off, off[1:])]
    return empty + sum(1 for nb in blocks if nb > LEAF_BLOCK_LADDER[-1])


def _expect_open_ters(entries) -> list[int]:
    """In an open ledger every well-signed transaction of the book phase
    passes its checks; a corrupted signature answers temINVALID."""
    from stellard_tpu_torch.protocol.ter import TER

    return [int(TER.temINVALID) if kind == "bad_sig" else int(TER.tesSUCCESS)
            for _b, kind, _g in entries]


def book_phase(dev, name_power: str, close: dict, saver) -> dict:
    """The order book on the close phase's chain (BOOK_SIZES): four
    closes of book_workload — every signature verified on the card (K1),
    every transaction applied by the port's transactors and closed by
    the default close (splices, the drainer's pre-hash, both trees
    sealed by CudaHasher on two threads: K2, K3), persisted through the
    close pipeline, the path plane's live book index advanced after each
    — then the path searches on the last ledger, pre-ranked by K4
    through PathPlane(evaluator=make_path_evaluator(routing="device")).
    Every verdict, ledger hash, results digest, splice count, adoption,
    persisted digest and the digest of the path answers is checked
    against the JAX package's; the launch counts are this phase's alone.
    The pipeline is drained after the last close, before the searches,
    and stopped after them; then K4 is held against its plain version on
    every batch the plane gave it."""
    import numpy as np
    import torch

    from stellard_tpu_torch.crypto.backend import PathQualityEvaluator
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.ops import ed25519_cuda, pathq, treehash
    from stellard_tpu_torch.paths.plane import PathPlane
    from stellard_tpu_torch.protocol import keys

    t0 = time.perf_counter()
    bwl = book_workload(close["wl"], **BOOK_SIZES)
    inputs_s = time.perf_counter() - t0
    hasher = close["hasher"]
    lm = close["node"]["lm"]
    calls0, readbacks0 = hasher.tree_calls, hasher.tree_transfers.readbacks
    nodes0, tree0 = hasher.device_nodes, lm.tree_json()
    plane = VerifyPlane(backend="cuda", routing="device", backend_opts={"device": dev})
    batches = []

    class Recording(PathQualityEvaluator):
        """The device evaluator, keeping each batch it was given."""

        def evaluate(self, rates):
            batches.append(np.array(rates, dtype=np.uint32))
            return super().evaluate(rates)

    evaluator = Recording(routing="device", device=dev)
    paths = PathPlane(evaluator=evaluator, prune_floor=BOOK_PRUNE_FLOOR)
    k1_per_close = []

    ed25519_cuda.launches = 0
    pathq.launches = 0
    treehash.reset_launches()
    keys.host_verifies = 0

    drain_ms = []

    def on_close(k, ledger, results):
        k1_per_close.append(ed25519_cuda.launches)
        saver.persist.submit(ledger, results)
        if k == len(bwl["closes"]) - 1:
            # the last close: the pipeline drains before the path searches,
            # whose Python would otherwise hold the GIL the worker waits on
            t = time.perf_counter()
            saver.persist.flush()
            drain_ms.append((time.perf_counter() - t) * 1e3)

    try:
        t0 = time.perf_counter()
        res = run_book(close["node"], bwl, plane.verify_many, paths,
                       first_close=len(CLOSE_HASHES), on_close=on_close)
        phase_s = time.perf_counter() - t0
    finally:
        plane.stop()
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches,
                "path_quality": pathq.launches}
    by_thread = {k: dict(v) for k, v in treehash.launches_by_thread.items()}
    host_verifies = keys.host_verifies
    tree = lm.tree_json()
    t0 = time.perf_counter()
    saver.persist.stop()
    lm.stop_seal_drainer()
    stop_ms = (time.perf_counter() - t0) * 1e3

    pj, pp, ev = plane.get_json(), paths.get_json(), evaluator.get_json()
    for k, (c, entries) in enumerate(zip(res["closes"], bwl["closes"])):
        require(c["verdicts"] == [g for _b, _k, g in entries], f"book close {k}: verdicts")
        require(c["open_ters"] == _expect_open_ters(entries),
                f"book close {k}: open-ledger TERs wrong")
        require(c["hash"] == BOOK_HASHES[k], f"book close {k}: ledger hash {c['hash']} "
                f"differs from the JAX package's {BOOK_HASHES[k]}")
        require(c["digest"] == BOOK_DIGESTS[k], f"book close {k}: results digest differs")
    check_default_close(res["closes"], len(CLOSE_HASHES), saver, "book phase")
    check_seal_threads(tree, tree0, by_thread, hasher.device_nodes - nodes0, "book phase")
    pipe = saver.persist.pipeline.get_json()
    require(pipe["persisted"] == len(CLOSE_HASHES) + len(BOOK_HASHES) and pipe["failed"] == 0,
            f"close pipeline persisted {pipe['persisted']}, failed {pipe['failed']}")
    require(saver.clf.last_closed_hash.hex() == BOOK_HASHES[-1],
            "the CLF's last closed ledger is not the chain's last close")
    require(res["paths_digest"] == PATHS_DIGEST,
            f"path answers digest {res['paths_digest']} differs from the JAX package's")
    require(host_verifies == 0, f"{host_verifies} host signature verifications in the book phase")
    require(pj["device_share"] == 1.0, f"book phase device share {pj['device_share']}")
    require(all(b - a >= 1 for a, b in zip([0] + k1_per_close, k1_per_close)),
            f"K1 was not launched in every book close: {k1_per_close}")
    require(hasher.tree_transfers.readbacks - readbacks0 == hasher.tree_calls - calls0,
            "book phase: not one readback per sealed tree")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the book phase")
    require(pp["prune_batches"] > 0, "no path search was pre-ranked")
    require(launches["path_quality"] == ev["device_batches"] == pp["prune_batches"]
            and ev["host_batches"] == 0, "K4 did not rank every pruned search")

    # K4 against its plain version on every batch the plane gave it
    k4_err = 0
    for rates in batches:
        t = torch.from_numpy(rates).to(dev)
        got, plain = pathq.path_quality(t), pathq.path_quality_ref(t)
        err = max_abs_err(got, plain)
        require(err == 0 and np.array_equal(got.cpu().numpy(), pathq.path_quality_host(rates)),
                "K4 differs from its plain version on a pre-rank batch")
        k4_err = max(k4_err, err)

    kinds: dict = {}
    for entries in bwl["closes"][2:]:
        for _b, kind, _g in entries:
            kinds[kind] = kinds.get(kind, 0) + 1
    summary = {
        "card": name_power, "sizes": BOOK_SIZES, "prune_floor": BOOK_PRUNE_FLOOR,
        "inputs_s": inputs_s, "phase_s": phase_s, "index_first_advance_ms": res["index_ms"],
        "per_close": [{key: c[key] for key in PER_CLOSE_KEYS + ("index_ms",)}
                      | {"transactions": len(e)}
                      for c, e in zip(res["closes"], bwl["closes"])],
        "book_kinds": kinds, "requests": len(bwl["requests"]),
        "paths_ms": res["paths_ms"], "paths_gc_ms": res["gc_ms_paths"],
        "candidates": res["candidates"], "answers": [len(a) for a in res["answers"]],
        "k4_batch_rows": [len(b) for b in batches],
        "hashes_equal_jax": True, "paths_digest_equal_jax": True,
        "host_verifies": host_verifies, "device_share": pj["device_share"],
        "k1_launches_per_close": np.diff([0] + k1_per_close).tolist(),
        "tree_calls": hasher.tree_calls - calls0,
        "readbacks": hasher.tree_transfers.readbacks - readbacks0,
        "paths_plane": {k: pp[k] for k in ("prune_batches", "pruned_candidates",
                                           "prune_floor", "prune_keep")},
        "index": pp["index"], "evaluator": ev, "launches": launches,
        "launches_by_thread": by_thread,
    }
    emit("book", **summary)
    emit("delta", of="book", per_close=[dict(c["delta"], seq=c["seq"])
                                           for c in res["closes"]],
         tree={k: v - tree0[k] if k in lm.tree_stats else v for k, v in tree.items()})
    clock = saver.persist.clock.ms
    emit("close_pipeline", card=name_power, depth_limit=pipe["depth_limit"],
         peak_depth=pipe["depth_hwm"], persisted=pipe["persisted"], failed=pipe["failed"],
         backpressure_waits=pipe["backpressure_waits"], backpressure_ms=pipe["backpressure_ms"],
         drain_after_closes_ms=drain_ms[0], stop_ms=stop_ms,
         per_ledger=[dict(clock.get(seq, {}), seq=seq) for seq in sorted(clock)],
         clf=saver.clf.get_json(), txdb=saver.txdb.counts())
    # the pipeline's stages hold the chain's LedgerMaster, and with it
    # every closed ledger: drop them before the replay loads its own
    saver.persist = None
    return {"launches": launches, "by_thread": by_thread, "k4_max_abs_err": k4_err,
            "close_digests": [c["close_digest"] for c in res["closes"]]}


# the replay phase (BASELINE config #5): the on-disk store the chain is
# saved to (git-ignored, removed at the end); the span replayed, the book
# phase's first 3 ledgers (1005-1007: every transactor), cut from the 8
# ledgers saved to fit the smoke's time limit (PERF.md §4); and the
# ledger forged with a bad signature, a copy of 1006 (the issuance
# close) replayed in the same span right after the real one
STORE_DIR = HERE / "build" / "chip_smoke_store"
REPLAY_FIRST = len(CLOSE_HASHES)  # index of 1005 among the closed ledgers
REPLAY_LEDGERS = 3
FORGE_SEQ = START_SEQ + REPLAY_FIRST + 2


class ChainSaver:
    """The chain's storage under ``path``, as the JAX node keeps it: an
    on-disk segstore node store (``nodestore/``; the JAX node's
    defaults: durability fsync, 5 ms group commit, 64 MB segments), a
    file-backed txdb (``txdb.db``) and a file-backed CLF (``clf.db``).
    ``save`` writes one ledger to the node store (save_counted) — the
    start ledger directly, each closed ledger as the close pipeline's
    node-store stage; ``attach(lm)`` wires the chain's LedgerMaster to
    the port's close pipeline over the three (``persist``, a
    ChainPersist). Keeps the ledger FORGE_SEQ for the replay phase's
    forgery."""

    def __init__(self, path: Path):
        from stellard_tpu_torch.node.txdb import TxDatabase
        from stellard_tpu_torch.nodestore import make_database
        from stellard_tpu_torch.state.clf import CLFMirror, LedgerSqlDatabase

        shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)
        self.path = path
        self.db_path = path / "nodestore"
        self.db = make_database(type="segstore", path=str(self.db_path))
        self.txdb = TxDatabase(str(path / "txdb.db"))
        self.clf = CLFMirror(LedgerSqlDatabase(str(path / "clf.db")))
        self.persist = None
        self.kept = None
        self.saves: list[dict] = []

    def save(self, ledger) -> None:
        records0 = self.db.backend.records
        rec = save_counted(ledger, self.db)
        rec["records"] = self.db.backend.records - records0
        self.saves.append(rec)
        if ledger.seq == FORGE_SEQ:
            self.kept = ledger

    def attach(self, lm) -> None:
        from stellard_tpu_torch.node.closepipeline import ClosePipeline
        from stellard_tpu_torch.node.node import _results_from_meta, build_tx_rows

        self.persist = ChainPersist(lm, ClosePipeline, self.txdb, self.clf, build_tx_rows,
                                    _results_from_meta, save_stage=self.save)

    def close_sql(self) -> None:
        self.txdb.close()
        self.clf.db.close()


def forge_ledger(ledger):
    """A copy of the closed `ledger` with one bit of one transaction's
    signature flipped in its tx map (the low bit of R, which no verifier
    may accept): the item re-keyed by the forged blob's txid, its
    metadata kept, every header field but the tx tree's hash as it was.
    -> (forged ledger, forged txid)."""
    from stellard_tpu_torch.protocol.sfields import sfTxnSignature
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    entries = list(ledger.tx_entries())
    txid, blob, meta = entries[len(entries) // 2]
    tx = SerializedTransaction.from_bytes(blob)
    sig = bytearray(tx.signature)
    sig[0] ^= 1
    tx.obj[sfTxnSignature] = bytes(sig)
    forged = ledger.snapshot()
    forged.tx_map.del_item(txid)
    return forged, forged.add_transaction(tx.serialize(), meta)


def replay_phase(dev, name_power: str, saver: ChainSaver, close_digests: list) -> dict:
    """Catch-up replay (BASELINE config #5) of the chain the close and
    book phases saved as they closed. The store is held to the JAX
    package's (STORE_DIGEST over its records, SAVE_NODES per save), a
    forged copy of 1006 (one signature bit flipped) is saved beside the
    chain, and the store is closed and reopened from disk, as a
    restarting node does. Then node/ledgertools.replay_range over 1005,
    1006, the forged 1006 and 1007: one verify_many for the whole span on
    the card (K1), each ledger loaded eagerly with its parent,
    re-applied by the transactors and sealed by CudaHasher (K2, K3).
    Every real ledger replays to its hash, with its close's results and
    the nodes its close hashed on the host; K1 rejects exactly the
    forged lane, and the forged ledger alone fails. The launch counts
    are this phase's alone; the store is removed at the end."""
    import resource

    import numpy as np

    from stellard_tpu_torch.crypto.backend import CudaHasher
    from stellard_tpu_torch.node.ledgertools import replay_range
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.nodestore import make_database
    from stellard_tpu_torch.ops import ed25519_cuda, ed25519_ref, treehash
    from stellard_tpu_torch.protocol import keys
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction
    from stellard_tpu_torch.protocol.ter import TER

    class TreeCounts(CudaHasher):
        """CudaHasher noting, per sealed tree, the nodes it hashed on
        the host, and the nodes that only the host may hash: leaves too
        long for K2's block ladder and empty inner nodes, counted from
        the tree before it is hashed."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.host_per_tree: list[int] = []
            self.host_only_per_tree: list[int] = []

        def hash_tree(self, root):
            self.host_only_per_tree.append(host_only_nodes(root))
            before = self.host_nodes
            n = super().hash_tree(root)
            self.host_per_tree.append(self.host_nodes - before)
            return n

    chain = CLOSE_HASHES + BOOK_HASHES
    saves = saver.saves
    first, last = REPLAY_FIRST, REPLAY_FIRST + REPLAY_LEDGERS
    try:
        db = saver.db
        require([s["hash"] for s in saves[1:]] == chain,
                "the saved ledgers are not the closed chain")
        require([s["nodes"] for s in saves] == [s["records"] for s in saves],
                "a save's node count differs from the records it appended")
        require([s["nodes"] for s in saves] == SAVE_NODES,
                f"nodes written per save {[s['nodes'] for s in saves]} differ from "
                f"the JAX package's {SAVE_NODES}")
        t0 = time.perf_counter()
        records = list(segstore_records(db.backend))
        require(len(records) == db.backend.count() == sum(SAVE_NODES),
                "the store's records are not the saves' nodes")
        digest = store_digest(records)
        digest_ms = (time.perf_counter() - t0) * 1e3
        del records
        require(digest == STORE_DIGEST,
                f"store digest {digest} differs from the JAX package's {STORE_DIGEST}")
        require(saver.kept is not None, f"ledger {FORGE_SEQ} was not kept")
        forged, forged_txid = forge_ledger(saver.kept)
        forged_hash = forged.hash()
        forged_save = save_counted(forged, db)
        forged_txids = [t for t, _b, _m in forged.tx_entries()]
        forged_tx = SerializedTransaction.from_bytes(forged.get_transaction(forged_txid)[0])
        saver.kept = forged = None
        store = db.get_json()["backend_stats"]
        db.close()

        # a restart: the store reopens from disk, and the replay reads it
        db = make_database(type="segstore", path=str(saver.db_path))
        reopened = db.get_json()["backend_stats"]
        require(reopened["opened_from_checkpoint"] and reopened["objects"] == store["objects"],
                "the store did not reopen from its checkpoint")
        hasher = TreeCounts(device=dev)
        plane = VerifyPlane(backend="cuda", routing="device", backend_opts={"device": dev})
        batches: list = []

        def verify_many(reqs):
            flags = np.asarray(plane.verify_many(reqs), bool)
            batches.append(flags)
            return flags

        real = [bytes.fromhex(h) for h in chain[first:last]]
        forged_at = FORGE_SEQ - START_SEQ - first
        span = real[:forged_at] + [forged_hash] + real[forged_at:]
        gc_clock = GcClock()
        ed25519_cuda.launches = 0
        for k in treehash.launches:
            treehash.launches[k] = 0
        keys.host_verifies = 0
        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        gc.collect()
        gc.callbacks.append(gc_clock)
        try:
            stats = replay_range(db, span, hash_batch=hasher, verify_many=verify_many)
            fetched = db.get_json()
        finally:
            gc.callbacks.remove(gc_clock)
            plane.stop()
            db.close()
        launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
        host_verifies = keys.host_verifies
        rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    finally:
        saver.db.close()
        saver.close_sql()
        shutil.rmtree(saver.path, ignore_errors=True)

    per = stats["ledgers"]
    ok = [s["ok"] for s in per]
    require(ok == [i != forged_at for i in range(len(span))],
            f"span verdicts {ok}: every ledger must replay but the forged one")
    per_real = per[:forged_at] + per[forged_at + 1:]
    require([s["replayed_hash"] for s in per_real] == chain[first:last],
            "a replayed hash differs from the chain's")
    got = [close_results_digest(s["results"]) for s in per_real]
    require(got == close_digests[first:last],
            "a replayed ledger's results differ from its close's")
    require(got == (CLOSE_RESULT_DIGESTS + BOOK_RESULT_DIGESTS)[first:last],
            "replayed results differ from the JAX package's")
    require(len(batches) == 1, f"{len(batches)} verify_many calls for one span")
    n_span = stats["tx_count"]
    lane = sum(s["tx_count"] for s in per[:forged_at]) + forged_txids.index(forged_txid)
    require(len(batches[0]) == n_span and np.flatnonzero(~batches[0]).tolist() == [lane],
            "K1 did not reject exactly the forged lane of the span")
    require(not ed25519_ref.verify(forged_tx.signing_pub_key, forged_tx.signing_hash(),
                                   forged_tx.signature), "the oracle accepts the forgery")
    require(per[forged_at]["results"][forged_txid.hex()] == int(TER.temINVALID),
            "the forged transaction did not answer temINVALID")
    require(launches["ed25519_verify"] >= 1, "K1 did not verify the span")
    require(host_verifies == 0, f"{host_verifies} host signature verifications in replay")
    pj = plane.get_json()
    require(pj["device_share"] == 1.0, f"replay device share {pj['device_share']}")
    tt = hasher.tree_transfers
    require(tt.readbacks == hasher.tree_calls == 2 * len(span),
            f"readbacks {tt.readbacks}, tree calls {hasher.tree_calls}")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the replay phase")
    # the host hashes only what K2/K3 cannot: in every sealed tree, its
    # leaves too long for K2's block ladder and its empty inner nodes
    host_per = [sum(hasher.host_per_tree[2 * i: 2 * i + 2]) for i in range(len(span))]
    require(hasher.host_per_tree == hasher.host_only_per_tree,
            f"host-hashed nodes per sealed tree {hasher.host_per_tree} differ from the "
            f"nodes K2/K3 cannot hash {hasher.host_only_per_tree}")

    n_loads = 2 * len(span)
    summary = {
        "card": name_power, "span": [s["ledger_seq"] for s in per], "forged_at": forged_at,
        "txs": n_span, "elapsed_s": stats["elapsed_s"], "tx_per_s": stats["tx_per_s"],
        "targets_load_ms": stats["load_s"] * 1e3,
        "parent_load_ms": [s["load_s"] * 1e3 for s in per],
        "eager_load_ms_mean": (stats["load_s"] + sum(s["load_s"] for s in per)) * 1e3 / n_loads,
        "apply_seal_ms": [s["elapsed_s"] * 1e3 for s in per],
        "seal_ms": [s["seal_s"] * 1e3 for s in per],
        "node_fetches": fetched["cache_hits"] + fetched["backend_fetches"],
        "k1_batch": n_span, "gc_ms": gc_clock.ms, "gc_full_collections": gc_clock.full,
        "peak_rss_mb": [rss0 / 1024, rss1 / 1024],
        "saves": [{k: s[k] for k in ("seq", "nodes", "bytes", "ms")} for s in saves],
        "store_digest_ms": digest_ms, "store_bytes": store["disk_bytes"],
        "store_objects": store["objects"], "segments": store["segments"],
        "fsyncs": store["fsyncs"], "native_index": store["native_index"],
        "durability": store["durability"], "reopen_replayed_records": reopened["replayed_records"],
        "forged": {"seq": FORGE_SEQ, "hash": forged_hash.hex(), "lane": lane,
                   "nodes": forged_save["nodes"]},
        "host_verifies": host_verifies, "device_share": pj["device_share"],
        "tree_calls": hasher.tree_calls, "readbacks": tt.readbacks,
        "host_nodes_per_ledger": host_per, "device_nodes": hasher.device_nodes,
        "hashes_equal_jax": True, "store_equal_jax": True, "launches": launches,
    }
    emit("replay", **summary)
    return {"launches": launches}


def k4_matrix(n: int, seed: int):
    """[n, MAX_HOPS] u32 rates: rates near 1.0 as real books give, with
    identity rows, saturating rows and full-range random rows mixed in."""
    import numpy as np

    from stellard_tpu_torch.ops.pathq import Q16_MAX, Q16_ONE
    from stellard_tpu_torch.paths.quality import MAX_HOPS

    rng = np.random.default_rng(seed)
    r = rng.integers(Q16_ONE - 8000, Q16_ONE + 8000, (n, MAX_HOPS)).astype(np.uint32)
    r[::16] = Q16_ONE
    r[1::16] = Q16_MAX
    r[2::16] = rng.integers(0, 2**32, (len(r[2::16]), MAX_HOPS), dtype=np.uint64)
    return r


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
