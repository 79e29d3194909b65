#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellard_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the ledger close's device plane and times the kernels, then a
standalone node's closes and its order book and path searches, then the
catch-up replay of the chain it saved and a node resumed lazily on it;
meanwhile a second process of this script (`--side`, SideRun) runs a
4-validator consensus net in process and a 4-validator private net over
TCP, and once the close phase has returned a third (`--side-scenarios`)
runs the scenario kit's fault matrix and chaos over real processes. All
of it goes through the entry points a node calls, at the sizes a close
really has, and every result is checked. In the order of the list below,
except that phase 9 runs after phase 4, phases 5-6 in the side process
while phase 7 runs (which joins it before it times K1), phase 7 starts
when the side does, and phase 11 runs in the third process beside
phases 8 and 10 (joined after the resume step):

1. device   — the card's name and power limit; builds the four CUDA
              kernels (one nvcc a source, started together) and prints
              ptxas' registers and spills; beside them (g++, under a
              build lock of its own) the port's host libraries from
              native/src/*.cc: the node store, the host crypto (K1's h
              prep, the `native` verifier) and the
              `_stser` extension (the STObject codec, the SHAMap pack
              and merge), so that no later process compiles one. The
              `native` line gives each arm, native or why not, what
              `cpu` resolves to, the libraries and `g++ --version`.
2. kernels  — K1 (Ed25519 verify) on the adversarial corpus and 4,096
              random lanes, K2 (masked SHA-512) on 4,096 messages at
              every ladder size, against their plain PyTorch versions
              on the card, exactly; K1 also against the RFC 8032
              oracle, K2 against hashlib.
3. flood    — 32,768 signatures (4,096 distinct signed pairs tiled,
              ~1% planted corruptions) through VerifyPlane(backend=
              "cuda", routing="device").verify_many in two 16,384
              chunks, then 4,096 submit() futures: every verdict as
              expected, device share 1.0, no wedge. Two steps follow
              the seal, each with its own line, wall and launch counts:
              mesh — entry.dryrun_multichip (verify_and_count: K1 with
              its count epilogue a shard, the counts summed on the card;
              planted R/S/A corruptions in every second shard, a ragged
              batch padded with zero rows, 64 mesh-hashed payloads
              against hashlib) at the visible cards' width and over
              MESH_SHARDS shards on this one card (not four cards), K1's
              counted launches and K2's one a shard; verify_and_count
              on a flood chunk at both widths, the same flags, equal to
              K1's plain version, the totals to flags.sum(); timed.
              point — K1 with STELLARD_VERIFY_CHECK=point's final check
              against its plain version on the corpus with 4,096 lanes
              and on a flood chunk, the flood's 32,768 through the
              verifier's sharded call in point mode with the bytes
              check's verdicts; K1's point, bytes and bytes-with-count
              ms at 16,384 with their bounds.
              host_verify — K1's host prep (h) by the native library
              held byte-equal to hashlib's on all 32,768 signatures; the
              `native` and `openssl` host verifiers against K1's verdicts
              on the adversarial corpus and a flood chunk, equal (every
              verifier of the port rejects a key whose y encoding is
              >= p), each timed on the chunk.
4. seal     — a 1,000,000-leaf state SHAMap and a 32,768-leaf
              transaction SHAMap sealed by CudaHasher.hash_tree, then a
              3,000-write / 300-delete delta re-sealed: every root equal
              to the hashlib root, one readback per tree. Then K3 on the
              state tree's widest inner level and K2 on every leaf of both
              trees against their plain versions, exactly, and timed with
              CUDA events (with their bounds); then the trees are dropped.
5. consensus — BASELINE config #4 (CONSENSUS_SIZES): the port's SimNet
              of 4 validators, all on the UNL, quorum 3, full mesh,
              latency one step of 1,000 ms, idle interval 4, messages as
              real wire frames; one VerifyPlane("cuda", routing="device",
              min_device_batch=1), prewarmed, and one WatchdogHasher over
              a CudaHasher serve all four (each node's verify_many and
              hash_batch, its LedgerMaster's and its InboundLedgers').
              A warm-up to seq 2 (funding a second sender), 4 rounds of
              512 payments of 250 STR from the master account to 16
              destinations submitted at validator 0 (~1% preceded by a
              copy with one signature bit flipped, refused by the door
              and never relayed), each round run until all four validated
              its ledger; a relay burst of 64 of the second sender's
              payments (one badly signed) in one delivery to each
              validator (K1 at batch 64 through prefetch_tx_sigs); a
              forged validation and a forged proposal from validator 3
              to validator 0. Every relayed transaction, proposal and
              validation verified by K1 at batch 1, every tx set and
              ledger sealed by K2/K3. Every validated hash (the same on
              all four), closed results digest, round count, defense
              counter, net counter and the digest of every frame sent
              equal to the JAX package's SimNet on the same workload
              (CONSENSUS_HASHES, CONSENSUS_RESULTS, CONSENSUS_COUNTERS;
              recomputed by
              JAX_PLATFORMS=cpu python -m pytest tests/test_torch_consensus_workload.py -m slow -q -s);
              device share 1.0, no host signature check, one readback a
              tree; then every request the plane was given through K1's
              plain version on the card in one batch: the same verdicts.
              The consensus line gives each round's wall ms (p50, p90),
              payments/s and K1's launches by batch.
6. tcp      — BASELINE config #4 as operators run it (TCP_SIZES): four
              validators over localhost TCP with [peer_ssl] require, each
              from testkit.tcpnet.validator_config's private-net INI
              (quorum 3, UNL and [ips] of the other three) with type=cuda
              planes, clock speed 1 and admission caps that never bind;
              validator 0 a Node in this process, validators 1-3
              `python -m stellard_tpu_torch --start` children spawned
              first (the kernels built here before). A warm-up funds a
              second sender, validated on all four; then 4 rounds of 250
              STR payments: 512 of the master account's consecutive
              sequences at validator 0's HTTP `submit` (~1% preceded by a
              badly signed copy the door refuses) and 256 of the second
              sender's at validator 2's, from two client threads; the
              latter reach validators 0, 1 and 3 as relayed frames,
              verified a socket read at a time (K1 at the read's batch).
              Each round until every destination's balance is its due on
              all four. Every validated hash the same on every validator
              holding it; every good payment tesSUCCESS through `tx` on
              the children, every bad copy temINVALID and never found;
              the balances and sequences of every account equal on all
              four and to the JAX package's (TCP_BALANCES_DIGEST, from
              tests/test_torch_tcp_workload.py); device share 1.0 on all
              four, and no host signature check but the hellos'; on
              validator 0 one readback a tree, and every K1 request it
              made equal to K1's plain version. Validator 3's node store
              is a segstore that deletes online and seals what it
              retires into history shards. A follower ([node]
              mode=follower, dialing the four) and an archive (mode=
              archive, pinned to validator 3, [archive] rescan_s=5) join
              as two more children on the card: the follower's ledgers
              are the validators', its balances TCP_BALANCES_DIGEST, its
              device share 1.0, its K1 launches and arrival-hash K2
              batches in the rounds above 0, and its RpcSub (a `url`
              subscription to a sink in this process) pushes every
              ledgerClosed in order with no gap; the archive imports
              every shard validator 3 sealed by the last round within
              60 s, condemns no peer, and its ledgers below its verified
              floor are the validators'. Each node's health watchdog is
              reported (validator 0's, the follower's, the close node's)
              and every flight dump must parse. `--only tcp` runs this
              phase alone.
7. close    — the port's standalone Node under a payment flood
              (CLOSE_SIZES), built from a config beside the chain's store
              (NODE_CONFIG with PORT_NODE_DEVICE: both crypto planes on
              the card at the default width mesh=auto, which get_counts
              must report as every visible card, K1 for a single
              signature, admission caps that
              never bind) and CLOSE_NODE_SPEC ([spec] workers=4
              mode=process transport=ring drain_timeout_s=120: the
              parallel speculation
              executor's Block-STM pool of four fork workers over
              shared-memory rings, forked before the node starts a
              thread or touches the card, speculating every submit and
              committing in index order), its K1 prewarm joined by
              serve(): 1,000,000
              AccountRoots resumed through its LedgerMaster.load_ledger,
              then 4 closes of 4,096 signed Payments (~2% creating
              accounts, ~1% with a bad signature), each payment a
              `tx_blob` sent to the HTTP `submit` door one at a time over
              one keep-alive connection (its signature verified by K1 at
              batch 1, admitted by the TxQ, applied to the open ledger
              and speculated once in close mode), each close a
              `ledger_accept` at a pinned close time (the JAX node's
              default close: the recorded deltas spliced, the building
              tree pre-hashed between closes by the seal drainer and
              adopted, both trees sealed on two threads beside the txdb
              rows, through the node's WatchdogHasher: K2, K3), then
              persisted by the node's close pipeline (its segstore node
              store, file-backed txdb and CLF, whose first commit imports
              the whole resumed state). A WebSocket client on the
              `ledger` stream must see every close's hash; the last close
              runs between the `profile` RPC's start and stop, and its
              trace gives the card's busy share of it. Then the read
              RPCs (`ledger_closed`, `account_info`, `tx`, `account_tx`)
              and `get_counts`, whose `spec` block must show the pool
              as configured and active, every dispatched transaction
              committed, no worker death, committer error, execution
              error, forced drain or torn ring slot, and the pool not
              failed over to serial (again after the book phase; after
              the node stops, each worker exited 0 and no ring segment
              is left in /dev/shm). The `spec` line gives, per close of
              this phase and the book's, the pool's counter growth, the
              close's wait on it (the spec.drain span), the door's ms a
              payment split into verify, open apply and the rest,
              payments/s and the largest record put on the ring. Every
              answer's TER as expected, no host
              signature check, K1 launched once a submit at batch 1,
              device share 1.0, nothing wedged, the drainer and both seal
              threads launching K2/K3 (counted by the role of the thread
              that called the watchdog), no error absorbed by the close's
              helpers, one readback per sealed tree, and every ledger
              hash and results digest, every close's splice split and
              adoption, its persisted txdb rows and CLF, and the read
              answers equal to the JAX package's node driven the same
              way on the same blobs (START_HASH, CLOSE_HASHES,
              CLOSE_DIGESTS, DELTAS, TXDB_DIGESTS, CLF_DIGESTS,
              READ_DIGESTS; recomputed by tests/test_torch_close.py's
              slow test:
              JAX_PLATFORMS=cpu python -m pytest tests/test_torch_close.py -m slow -q -s).
              Then K1 against its plain version on a close's batch and
              at batch sizes 1-33 (good, bad S, non-canonical S,
              undecodable key), and timed at batch 1.
8. book     — the order book on the same chain (BOOK_SIZES, BASELINE
              configs #2 and #3): 16 gateways issuing 32 IOUs (four set a
              TransferRate), 2,048 traders with two trust lines each,
              1,024 of them with a regular key; then 4,096 issuing
              payments; then two closes of 4,096 transactions (offer
              asks and bids on overlapping price ladders over 32 IOU/STR
              and 32 IOU/IOU markets, cancels, AccountSets signed with
              the regular key, cross-currency path payments, merges, ~1%
              bad signatures). Each close verified by K1 on the node's
              verify plane, applied by the port's transactors and
              speculated on the node's pool (the conflict-heavy traffic
              its validate/abort/retry machinery exists for), closed
              and persisted as in the close phase, and the node's path
              plane's live book index advanced; then the close pipeline
              is drained, and 32 path searches run on the last ledger,
              pre-ranked by K4 through the node's path plane (its
              evaluator routing=device, the prune floor
              BOOK_PRUNE_FLOOR), 4 of them again through its
              `ripple_path_find` door, each answer equal to the direct
              one. Every verdict as
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
9. times    — K1 and K4 against their plain versions again, exactly, at
              the shapes the main path gave them: K1 on both flood
              chunks, K4 on a 1,048,576 x 8 rate matrix (identity
              and saturating rows among rates near 1.0, also held to the
              NumPy host arm); each kernel and plain version timed with
              CUDA events on those inputs, with its bound. K4's kernel
              time is taken on raw launches cycling over four such
              matrices (134 MB, more than the L2), its wrapper's per-call
              time apart. K1 is timed again on the first chunk with
              every S non-canonical and with every key undecodable,
              which stop each lane before and after the decode: the
              split of its time by phase.
10. replay  — catch-up replay (BASELINE config #5) of that chain: the
              store's records and each save's node count equal to the
              JAX package's (STORE_DIGEST, SAVE_NODES, from the same slow
              test); a forged copy of 1006 (one signature bit flipped in
              its tx map) saved beside it; the store closed and reopened
              from disk; then node/ledgertools.replay_range over 1005,
              1006 and the forged 1006 — every signature of the
              span in one verify_many on the card (K1), each ledger
              loaded eagerly with its parent, re-applied and sealed by
              CudaHasher (K2, K3). Every real ledger's replayed hash and
              closed results equal to its close's and to the JAX
              package's (CLOSE_RESULT_DIGESTS, BOOK_RESULT_DIGESTS), no
              host signature check, no node hashed on the host but
              leaves too long for K2's block ladder and empty inner
              nodes, one readback per sealed tree; K1 rejects exactly
              the forged lane and the forged ledger alone fails. The
              span is cut from the 8 saved ledgers to 2 to fit the time
              limit (PERF.md §4).
              resume: the port's Node restarted on the same store with
              [start_up] load and its path plane off (RESUME_CONFIG,
              RESUME_SIZES): the lazy resume reads the
              header and two roots; 256 account_info reads at 1008 and
              64 at 1005 (a cold, lazy historical load) through HTTP;
              512 payments of the close workload's shape, each a submit
              (K1 at batch 1), closed by one ledger_accept on a tree
              whose clean subtrees are stubs (K2, K3) and saved into
              the same store. The read answers, the ledger's hash and
              results and the nodes its save wrote equal to the JAX
              node's resumed the same way (RESUME_*, from the same slow
              test); nodes faulted, none inside a seal; no host
              signature check; the host hashes only what K2/K3 cannot.
              The store is removed at the end.
11. scenarios — the scenario kit (testkit/), in its own process
              (`--side-scenarios T0`, its output in
              build/chip_smoke_scenarios.out/.err, printed at the join):
              every MATRIX scenario at SCENARIO_SEED and every corpus
              entry at its own seed through testkit.run_simnet(device=
              cuda) — byzantine validators and relay flooders,
              partitions and rotating kills, cold catch-up over segments
              and history shards, archive backfill from a garbage peer,
              follower trees, the TxQ under fee gaming, the thread-mode
              speculation pool, and the mesh leg hashing every honest
              validator's trees on K2 across the visible cards. Each
              converges on one hash and its scorecard (less the spec
              pool's counters and the mesh's resolved width) is the JAX
              package's (SCENARIO_CARDS, recomputed by
              JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scenario_matrix.py -m slow -q -s);
              chaos_spec2's final hash is chaos's; mesh_hash's mesh leg
              active, not wedged, at the cards' width, K2 launched. Then
              testkit.tcpnet.run_tcp(scenario_chaos(seed=1), backend=
              "cuda"): four `python -m stellard_tpu_torch` validators on
              the card over TCP, validators 0 and 2 killed (steps 14 and
              54) and revived 5 steps later (each revived process builds
              its CUDA context and runs K1's prewarm again), the workload
              submitted over the doors; one hash, 2 kills, 0 errors,
              every transaction submitted. The `scenarios` line gives
              each scenario's wall ms and match, the `scenario_tcp` line
              the boot s, each revive's s until its door answers, the
              validated seqs and the walls; the children's logs stay in
              build/chip_smoke_scenario_tcp/.

Launch counts are zeroed just before phases 3-4 and read just after, and
again around the flood phase's mesh step and the point step's drive of
the flood, phases 5 and 6 (in the side process; validator 0's
launches), 7, 8, 10's replay and its resume step, and phase 11 (in its
process: K2 in the mesh leg; the run_tcp children's counts are reported
in its line, not summed); the kernels line shows the sum, the launches of the main path alone,
and for K2 and K3 the consensus, tcp, close and book phases' launches by
who made them (the seal drainer, the two seal threads, the
closing or consensus thread). Any
failed check exits non-zero without the final line. Without a CUDA device, or without the package
beside it, the script exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Optional

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
# the point check in its place: R's decode, then Xr*Z and Yr*Z
POINT_CHECK = (DECODE[0] + 2, DECODE[1])


def fe_ops(muls_sqs) -> int:
    muls, sqs = muls_sqs
    return muls * FE_MUL_OPS + sqs * FE_SQ_OPS


T_IMPORT = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase, with ``at_s``: seconds since the script
    started, so the lines give the phases' walls."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_IMPORT}), flush=True)


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


def once_ms(fn):
    """(ms of one call of fn() by CUDA events, unwarmed; its result): for
    the plain versions, whose one call at the main path's shapes takes
    seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


# a spin of this many SM cycles (~50 ms at the H100's 1.7-2.0 GHz SM
# clock) queued ahead of raw_launch_ms's timed launches
HOLD_CYCLES = 100_000_000


def raw_launch_ms(fn, args: list, reps: int) -> float:
    """Mean ms of a C launcher called `reps` times back to back, cycling
    over the prepared argument tuples `args`, by CUDA events (warmed once
    on each); every call's error code must be 0. A spin of HOLD_CYCLES
    on the stream is queued before the start event, so the host has
    issued every timed launch before the card reaches the first: they
    run back to back, and the host's gap between two launches is not
    timed."""
    import torch

    errs = [fn(*a) for a in args]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
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


def k1_ops(batch: dict, check: str = "bytes") -> int:
    """32-bit integer multiply ops K1's function needs on these inputs:
    lanes with a non-canonical S stop at once; lanes whose key does not
    decode stop after the decode; the walk adds once per nonzero digit of
    each scalar, in whichever 4-bit form has fewer: unsigned nibbles or
    signed digits in [-8, 7]. The final check is the inversion and
    encode (``bytes``) or R's decode and two products (``point``)."""
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
            + int(decodes.sum()) * (fe_ops(TABLE) + fe_ops(WALK_DOUBLES)
                                    + fe_ops(POINT_CHECK if check == "point" else ENCODE))
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


def native_line() -> dict:
    """The `native` line: each host arm, native or why not, the libraries
    and the compiler; -> the arms."""
    from stellard_tpu_torch import native
    from stellard_tpu_torch.crypto.backend import make_verifier
    from stellard_tpu_torch.protocol import keys

    arms = native.arms()
    try:
        gxx = subprocess.run([native._compiler() or "g++", "--version"], capture_output=True,
                             text=True, timeout=30).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as exc:
        gxx = f"unavailable: {exc}"
    emit("native", h_prep=arms["h_prep"], host_verify=make_verifier("cpu").impl,
         codec=arms["codec"], pack=arms["pack"], merge=arms["merge"],
         have_cryptography=keys.HAVE_CRYPTOGRAPHY, libraries=arms["libraries"], gxx=gxx)
    return arms


def python_prep_ms(pubs, msgs, sigs, native_batch: dict) -> dict:
    """The Python mirror's host prep of one chunk, for the record: h alone
    (``_h_scalars``) and the whole ``prepare_batch``, ms; its arrays
    equal to the native arm's."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519

    r_packed = b"".join(s[:32] for s in sigs)
    t0 = time.perf_counter()
    ed25519._h_scalars(r_packed, pubs, msgs)
    h_ms = (time.perf_counter() - t0) * 1e3
    native_prep = ed25519._native_prep
    ed25519._native_prep = lambda: None
    try:
        t0 = time.perf_counter()
        mirror = ed25519.prepare_batch(pubs, msgs, sigs)
        prep_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ed25519._native_prep = native_prep
    require(all(np.array_equal(mirror[k], native_batch[k]) for k in mirror),
            "the Python host prep differs from the native one")
    return {"h_ms": h_ms, "prepare_batch_ms": prep_ms}


def host_verify_step(name_power: str, arms: dict, cases, k1_cases, flood, flood_verdicts) -> dict:
    """The flood's native h held to hashlib's on all 32,768 signatures; the
    ``native`` and ``openssl`` host verifiers held to K1's verdicts on the
    adversarial corpus and on one flood chunk; ``native`` timed on the
    chunk. A `host_verify` line."""
    import numpy as np

    from stellard_tpu_torch.crypto.backend import VerifyRequest, make_verifier
    from stellard_tpu_torch.native import Ed25519HostPrep
    from stellard_tpu_torch.ops import ed25519

    t0 = time.perf_counter()
    pubs, msgs, sigs = flood
    out = {}
    if arms["h_prep"]:
        r_packed = b"".join(s[:32] for s in sigs)
        h_native = Ed25519HostPrep().h_batch(r_packed, b"".join(pubs), msgs, len(pubs))
        require(np.array_equal(h_native, ed25519._h_scalars(r_packed, pubs, msgs)),
                "the native h differs from hashlib's on the flood")
        out["h_equal_on"] = len(pubs)
    corpus = [VerifyRequest(p, m, s) for _k, p, m, s in cases]
    chunk = [VerifyRequest(p, m, s) for p, m, s in zip(pubs[:CHUNK], msgs[:CHUNK], sigs[:CHUNK])]
    names = ["openssl"] + (["native"] if arms["native_verify"] else [])
    for reqs, k1, what in ((corpus, k1_cases, "corpus"),
                           (chunk, flood_verdicts[:CHUNK], "chunk")):
        for name in names:
            verifier = make_verifier(name)
            t1 = time.perf_counter()
            got = verifier.verify_batch(reqs)
            ms = (time.perf_counter() - t1) * 1e3
            require(np.array_equal(got, k1), f"the {name} host verifier differs from K1 "
                    f"on the {what}: lanes {np.nonzero(got != k1)[0][:8].tolist()}")
            out[f"{name}_{what}"] = {"lanes": len(reqs), "accepted": int(got.sum()),
                                     "k1_accepts_rejected": int((k1 & ~got).sum()),
                                     "ms": ms, "sigs_per_s": len(reqs) / (ms / 1e3)}
    out["seconds"] = time.perf_counter() - t0
    emit("host_verify", card=name_power, **out)
    return out


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

    from stellard_tpu_torch.protocol.keys import KeyPair

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
            entry = payment_entry(rng, key, seqs[i], kind, dst, drops)
            if entry[2]:
                seqs[i] += 1  # a rejected payment does not use its sequence
            entries.append(entry)
        closes.append(entries)
    return {"accounts": accounts, "sender_seeds": sender_seeds, "closes": closes,
            "next_seqs": seqs}


def payment_entry(rng, key, seq: int, kind: str, dst: bytes, drops: int) -> tuple:
    """One Payment of the close workload: `drops` from `key`'s account
    at `seq` to `dst`, a fee of 10 drops, signed; a ``bad_sig`` one with
    one bit of its signature flipped (drawn from `rng`), its verdict the
    RFC 8032 oracle's. -> (blob, kind, expected verdict)."""
    from stellard_tpu_torch.ops import ed25519_ref
    from stellard_tpu_torch.protocol.formats import TxType
    from stellard_tpu_torch.protocol.sfields import sfAmount, sfDestination, sfTxnSignature
    from stellard_tpu_torch.protocol.stamount import STAmount
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    tx = SerializedTransaction.build(
        TxType.ttPAYMENT, key.account_id, seq, 10,
        {sfAmount: STAmount.from_drops(drops), sfDestination: dst})
    tx.sign(key)
    good = True
    if kind == "bad_sig":
        sig = bytearray(tx.signature)
        sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
        tx.obj[sfTxnSignature] = bytes(sig)
        good = ed25519_ref.verify(key.public, tx.signing_hash(), bytes(sig))
    return tx.serialize(), kind, good


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


def sorted_rows(query, table: str, key_cols: tuple, where: str = "", args: tuple = ()) -> list:
    """The rows of ``table`` (``where`` and ``args`` select them), as
    ``SELECT * ... ORDER BY key_cols`` gives them (hex and ASCII text,
    integers; the key's ties are equal rows), through ``query(sql,
    args) -> rows``. They come in one step, as one JSON array (blobs as
    hex): sqlite3 releases the GIL at every step, and a persist worker
    stepping once a row beside a busy thread waits up to 5 ms a row for
    it back (utils/sqlrows.py)."""
    cols = [r[1] for r in query(f"PRAGMA table_info({table})", ())]
    exprs = ",".join(f"CASE typeof({c}) WHEN 'blob' THEN json_array(hex({c})) ELSE {c} END"
                     for c in cols)
    [(doc,)] = query(f"SELECT json_group_array(json_array({exprs})) FROM {table}{where}", args)
    rows = [tuple(bytes.fromhex(v[0]) if isinstance(v, list) else v for v in r)
            for r in json.loads(doc)]
    at = [cols.index(c) for c in key_cols]
    rows.sort(key=lambda r: [r[i] for i in at])
    return rows


def txdb_digest(txdb, seq: int) -> str:
    """SHA-256 over one ledger's txdb rows (either package's
    TxDatabase): its Ledgers header row, its Transactions rows and its
    AccountTransactions rows, each table in key order."""
    h = hashlib.sha256()
    with txdb._lock:
        query = lambda sql, args: txdb._conn.execute(sql, args).fetchall()  # noqa: E731
        for table, key in (("Ledgers", ("LedgerHash",)), ("Transactions", ("TransID",)),
                           ("AccountTransactions", ("TransID", "Account", "TxnSeq"))):
            rows = sorted_rows(query, table, key, " WHERE LedgerSeq = ?", (seq,))
            h.update(len(rows).to_bytes(4, "big"))
            for row in rows:
                h.update(repr(row).encode())
    return h.hexdigest()


def clf_digest(clf) -> str:
    """SHA-256 over a CLF mirror (either package's CLFMirror): its
    StoreState (the LCL hash and header) and its accounts, trustlines
    and offers tables, each in key order."""
    h = hashlib.sha256()
    for table, key in (("StoreState", "StateName"), ("accounts", "account_id"),
                       ("trustlines", "index_hex"), ("offers", "index_hex")):
        rows = sorted_rows(clf.db.query, table, (key,))
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
    digested on the pipeline's worker (``digests``, by sequence), and its
    stage ms kept (``clock.ms``, by sequence)."""

    def __init__(self, lm, pipeline_cls, txdb, clf, build_tx_rows, results_from_meta,
                 save_stage, depth: int = 8):
        self._begin(lm, txdb, clf)
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
        self._persisted0 = 0
        self._persist_close = lambda ledger, results: self.pipeline.submit_close(
            ledger, results, done=lambda res: self.note(ledger, res))

    @classmethod
    def of_node(cls, node, on_persisted=None) -> "ChainPersist":
        """The same digests around a node's own persistence, through its
        public surface: each closed ledger reaches ``Node.on_persisted``
        once its node-store, txdb and CLF writes have committed (on the
        close pipeline's worker, before the next ledger's writes start);
        then ``on_persisted(ledger, stage_ms)`` runs (the stage ms from
        ``ClosePipeline.last_stage_ms``) and the digests are taken. A
        ledger closed on the node's LedgerMaster directly is handed to
        ``Node.persist_close`` by ``submit``."""
        self = cls.__new__(cls)
        self._begin(node.ledger_master, node.txdb, node.clf)
        self.pipeline = node.close_pipeline
        self._persisted0 = self.pipeline.persisted
        self._persist_close = node.persist_close
        self._on_persisted = on_persisted
        node.on_persisted.append(self.note)
        return self

    def _begin(self, lm, txdb, clf) -> None:
        self.lm, self.txdb, self.clf = lm, txdb, clf
        self.digests: dict[int, dict] = {}
        self.errors: list[str] = []
        self._landed = threading.Condition()
        self._on_persisted = None
        self.clock = StageClock()

    def note(self, ledger, _results) -> None:
        """One persisted ledger: its stage ms, ``on_persisted``, its
        digests. An error here is kept (``flush`` fails on it)."""
        seq = ledger.seq
        try:
            stage_ms = getattr(self.pipeline, "last_stage_ms", None)
            if stage_ms is not None:  # a node's pipeline; else the StageClock has them
                with self.clock._lock:
                    self.clock.ms[seq] = dict(stage_ms)
            if self._on_persisted is not None:
                self._on_persisted(ledger, self.clock.ms.get(seq, {}))
            dg = {"txdb": txdb_digest(self.txdb, seq), "clf": clf_digest(self.clf)}
        except Exception as exc:  # noqa: BLE001 — reported by flush
            with self._landed:
                self.errors.append(f"ledger {seq}: {exc!r}")
                self._landed.notify_all()
            return
        with self._landed:
            self.digests[seq] = dg
            self._landed.notify_all()

    def submit(self, ledger, results) -> None:
        self._persist_close(ledger, results)

    def flush(self) -> None:
        """Wait until every ledger persisted so far is digested (the
        pipeline's ``done`` runs after its own flush returns). A ledger
        that failed to persist is not waited for: its digests are
        missing, and the checks that read them fail."""
        require(self.pipeline.flush(timeout=3600), "the close pipeline did not drain")
        with self._landed:
            require(self._landed.wait_for(
                lambda: len(self.digests) + len(self.errors)
                >= self.pipeline.persisted - self._persisted0, timeout=3600),
                "a persisted ledger was never digested")
        require(not self.errors, f"digesting persisted ledgers failed: {self.errors}")

    def stop(self) -> None:
        """Drain the pipeline (every queued ledger persisted first) and
        stop its worker."""
        self.flush()
        require(self.pipeline.stop(timeout=3600), "the close pipeline did not stop")


def run_closes(wl: dict, hash_batch, verify_many, on_close=None,
               on_start=None, setup=None) -> tuple[list[dict], dict]:
    """The close phase without the node's doors, its LedgerMaster driven
    by hand (the CPU tests hold the door's closes to it): the start ledger
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
# the standalone node and its doors: the close phase's payment flood enters
# through HTTP `submit` and is closed by `ledger_accept`

# the node's config, beside its store (either package's Config.from_ini
# reads it): the segstore node store, the file-backed txdb (and the CLF
# beside it), admission caps that never bind (bench.py's _drive_node:
# shedding and queueing depend on timing, and the closes must be the
# workload's), the path plane's prune floor, and ephemeral doors
NODE_CONFIG = """
[standalone]
1

[node_db]
type=segstore
path={store}/nodestore

[database_path]
{store}/txdb.db

[txq]
min_cap=1000000
max_cap=1000000

[rpc_port]
0

[websocket_port]
0
{extra}
"""
# this package's node on the card, its routing defaults written out:
# every door's single signature to K1 (the JAX default sends batches
# under 64 to the host), every tree to K2/K3, and the path plane
# pre-ranking on K4 with the book phase's floor (the JAX defaults,
# min_device_batch 256 and cost routing, would send every batch of 34-50
# candidates to the host)
PORT_NODE_DEVICE = """
[signature_backend]
type=cuda
device={dev}
routing=device
min_device_batch=1

[hash_backend]
type=cuda
device={dev}
routing=device
min_device_nodes=0

[paths]
routing=device
min_device_batch=1
prune_floor={floor}
"""


# the close node's speculation pool (phases 7 and 8): four fork workers
# over the shared-memory rings, fixed at 4 rather than auto so the run is
# the same on every host (the top of the JAX bench's worker counts); the
# resume step's node, the SimNet and the TCP net keep the serial inline
# path of [spec] workers=1. The book's conflict-heavy windows (4,096-5,120
# transactions, nearly each aborted once) take 12-32 s to commit on the
# pool, past the default 10 s drain, which would complete them serially
# (as the JAX pool does on the same windows on a CPU); at 120 s the pool
# commits them, and a hung worker still forces a drain and fails the run
CLOSE_NODE_SPEC = """
[spec]
workers=4
mode=process
transport=ring
drain_timeout_s=120
"""
SPEC_WORKERS = 4


def node_config_text(store: Path, extra: str) -> str:
    return NODE_CONFIG.format(store=store, extra=extra)


class HttpRpc:
    """One keep-alive HTTP connection to a node's JSON-RPC door."""

    def __init__(self, port: int, timeout: float = 3600):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)

    def call(self, method: str, **params) -> dict:
        body = json.dumps({"method": method, "params": [params]})
        self.conn.request("POST", "/", body, {"Content-Type": "application/json"})
        return json.loads(self.conn.getresponse().read())["result"]

    def close(self) -> None:
        self.conn.close()


class WsClient:
    """A minimal RFC 6455 client of a node's WebSocket door, whose
    reader thread keeps every stream message it receives."""

    def __init__(self, port: int):
        import base64
        import os
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=3600)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            "GET / HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += self.sock.recv(4096)
        require(b"101" in buf.split(b"\r\n")[0], "the WebSocket door refused the upgrade")
        self.messages: list[dict] = []
        self._responses: list[dict] = []
        self._cv = threading.Condition()
        self._reader = threading.Thread(target=self._read_loop, name="ws-client",
                                        daemon=True)
        self._reader.start()

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("closed")
            out += chunk
        return out

    def _read_loop(self) -> None:
        import struct

        try:
            while True:
                b1, b2 = self._read_exact(2)
                n = b2 & 0x7F
                if n == 126:
                    (n,) = struct.unpack(">H", self._read_exact(2))
                elif n == 127:
                    (n,) = struct.unpack(">Q", self._read_exact(8))
                payload = self._read_exact(n)
                if b1 & 0x0F != 0x1:
                    continue  # only text frames carry JSON
                msg = json.loads(payload)
                with self._cv:
                    (self._responses if msg.get("type") == "response"
                     else self.messages).append(msg)
                    self._cv.notify_all()
        except (ConnectionError, OSError):
            pass

    def call(self, command: str, **params) -> dict:
        import os
        import struct

        payload = json.dumps(dict(params, command=command, id=1)).encode()
        mask = os.urandom(4)
        n = len(payload)
        head = bytes([0x81]) + (bytes([0x80 | n]) if n < 126
                                else bytes([0x80 | 126]) + struct.pack(">H", n))
        self.sock.sendall(head + mask + bytes(b ^ mask[i & 3] for i, b in enumerate(payload)))
        with self._cv:
            require(self._cv.wait_for(lambda: self._responses, timeout=600),
                    f"no WebSocket answer to {command}")
            return self._responses.pop(0)

    def wait_for(self, pred, timeout: float) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: pred(self.messages), timeout=timeout)

    def close(self) -> None:
        import socket

        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        self.sock.close()
        self._reader.join(timeout=10)


class Timed:
    """Wrap ``obj.name`` (an instance's method) to add its wall ms to
    ``ms``; ``restore()`` puts the method back."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.ms = obj, name, 0.0
        orig = getattr(obj, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self.ms += (time.perf_counter() - t0) * 1e3

        setattr(obj, name, timed)

    def restore(self) -> None:
        delattr(self.obj, self.name)


def busy_share(trace_path: str, wall_ms: float) -> dict:
    """The share of a profiled window's host wall ms in which the card ran
    a kernel, from the torch.profiler Chrome trace of that window: the
    union of its kernel events' intervals (kernels that overlap count
    once), over ``wall_ms``."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in events if e.get("cat") == "kernel" and "ts" in e)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return {"kernel_events": len(spans), "busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "busy_share": busy / 1e3 / wall_ms}


def drive_node_closes(node, wl: dict, profile_close: Optional[int] = None) -> dict:
    """The close phase through a serving node's doors (either package's
    Node, its chain already resumed): for each close k, the clock pinned
    to START_CLOSE_TIME + 30 (k + 1) (bench.py's pin), every blob of the
    close submitted as a `tx_blob` to the HTTP `submit` door one at a
    time, in the workload's order, over one keep-alive connection, then
    `ledger_accept`. A WebSocket client subscribed to the `ledger` stream
    keeps what it is sent. With ``profile_close``, that close runs
    between the `profile` RPC's start and stop. Returns per close the
    ledger hash, the results digest, the answers' TERs, what the delta
    replay did and the times: the submits' wall, and within it the
    verify plane's and the open apply's (LedgerMaster.do_transaction,
    through the TxQ) ms, then the ledger_accept's; and, with the node's
    speculation pool, its counters' growth over the close and the wait
    of the close on it (LedgerMaster._drain_spec, the `spec.drain` span)."""
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    lm = node.ledger_master
    ex = getattr(node, "spec_executor", None)
    closed: list = []
    node.ops.on_ledger_closed.append(lambda led, res: closed.append((led, res)))
    http = HttpRpc(node.http_server.port)
    ws = WsClient(node.ws_server.port)
    sub = ws.call("subscribe", streams=["ledger"])
    require(sub.get("status") == "success", f"ledger stream subscription failed: {sub}")
    apply, verify = Timed(lm, "do_transaction"), Timed(node.verify_plane, "verify_many")
    drain = Timed(lm, "_drain_spec")
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    out, profile = [], None
    try:
        for k, entries in enumerate(wl["closes"]):
            when = START_CLOSE_TIME + 30 * (k + 1)
            node.ops.network_time = lambda when=when: when
            blobs = [blob.hex().upper() for blob, _kind, _good in entries]
            txids = [SerializedTransaction.from_bytes(blob).txid() for blob, _k, _g in entries]
            gc_ms, gc_full = gc_clock.ms, gc_clock.full
            apply.ms = verify.ms = drain.ms = 0.0
            before = lm.delta_stats.snapshot()
            spec0 = ex.counters.snapshot() if ex is not None else None
            if k == profile_close:
                profile = http.call("profile", action="start")
                require("error" not in profile and profile.get("dir"), f"profile start: {profile}")
            ta = time.perf_counter()
            answers = [http.call("submit", tx_blob=b) for b in blobs]
            tb = time.perf_counter()
            accept = http.call("ledger_accept")
            tc = time.perf_counter()
            if k == profile_close:
                stop = http.call("profile", action="stop")
                require("error" not in stop and stop.get("trace"), f"profile stop: {stop}")
                profile = {"trace": stop["trace"]}
            require(accept.get("ledger_current_index") == START_SEQ + k + 2,
                    f"ledger_accept: {accept}")
            ledger, results = closed[-1]
            open_ters = [(txid, int(a["engine_result_code"])) for txid, a in zip(txids, answers)]
            last = lm.last_close
            out.append({
                "seq": ledger.seq, "hash": ledger.hash().hex(), "ledger": ledger,
                "results": results, "digest": results_digest(open_ters, results),
                "close_digest": close_results_digest(results),
                "delta": close_delta(lm, before),
                "engine_results": [a["engine_result"] for a in answers],
                "open_ters": [t for _, t in open_ters],
                "close_ters": {txid: int(t) for txid, t in results.items()},
                "wall_ms": (tc - ta) * 1e3, "submit_ms": (tb - ta) * 1e3,
                "door_ms_per_tx": (tb - ta) * 1e3 / len(entries),
                "verify_ms": verify.ms, "apply_ms": apply.ms, "close_ms": (tc - tb) * 1e3,
                "spec_drain_ms": drain.ms, "spec": spec_growth(ex, spec0),
                # (the JAX package's LedgerMaster keeps no per-tree seal times)
                **{key: last.get(key) for key in (
                    "seal_tx_ms", "seal_tx_nodes", "seal_state_ms", "seal_state_nodes")},
                "close_apply_ms": last["apply_ms"], "close_seal_ms": last["seal_ms"],
                "gc_ms": gc_clock.ms - gc_ms, "gc_full_collections": gc_clock.full - gc_full,
            })
        require(ws.wait_for(lambda m: sum(x.get("type") == "ledgerClosed" for x in m)
                            >= len(out), timeout=60),
                "the ledger stream did not deliver every close")
    finally:
        gc.callbacks.remove(gc_clock)
        apply.restore()
        verify.restore()
        drain.restore()
        http.close()
        ws.close()
    stream = [m["ledger_hash"].lower() for m in ws.messages if m.get("type") == "ledgerClosed"]
    return {"closes": out, "stream": stream, "profile": profile}


def read_back(node, wl: dict) -> dict:
    """The read RPCs after the close phase, through the HTTP door:
    `ledger_closed`, `account_info` of 8 seeded accounts, `tx` of 8
    seeded transactions and `account_tx` of one sender -> each answer's
    digest (read_digest) and the closed ledger's hash."""
    import numpy as np

    from stellard_tpu_torch.protocol.keys import encode_account_id
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    rng = np.random.default_rng(READ_SEED)
    n_senders = len(wl["sender_seeds"])
    accounts = [wl["accounts"][int(i)] for i in rng.integers(n_senders, size=4)] + [
        wl["accounts"][int(i)] for i in rng.integers(n_senders, len(wl["accounts"]), size=4)]
    flat = [blob for c in wl["closes"] for blob, _k, good in c if good]
    txids = [SerializedTransaction.from_bytes(flat[int(i)]).txid()
             for i in rng.integers(len(flat), size=8)]
    http = HttpRpc(node.http_server.port)
    try:
        closed = http.call("ledger_closed")
        answers = {
            "account_info": [http.call("account_info", account=encode_account_id(a),
                                       ledger_index="closed") for a in accounts],
            "tx": [http.call("tx", transaction=t.hex().upper()) for t in txids],
            "account_tx": http.call("account_tx", account=encode_account_id(accounts[0]),
                                    ledger_index_min=-1, ledger_index_max=-1),
        }
    finally:
        http.close()
    return {"ledger_closed": closed.get("ledger_hash", "").lower(),
            "digests": {k: read_digest(v) for k, v in answers.items()}, "answers": answers}


def read_digest(answer) -> str:
    """SHA-256 of an RPC answer's JSON (keys sorted)."""
    return hashlib.sha256(json.dumps(answer, sort_keys=True).encode()).hexdigest()


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

    from stellard_tpu_torch import native
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
    # the host libraries (g++) in a thread beside the kernels (nvcc), so
    # that no process started later compiles them; each takes a file lock
    # of its own in the build directory, so neither waits for the other
    host_build = threading.Thread(target=native.build_all, name="native-build")
    host_build.start()
    build.build([ed25519_cuda.LIB, treehash.LIB, pathq.LIB])
    build_s = time.perf_counter() - t0
    host_build.join()
    ptxas = {
        lib: [ln.strip() for ln in log.splitlines()
              if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        for lib, log in build.PTXAS_LOG.items()
    }
    emit("build", seconds=build_s, ptxas=ptxas)
    arms = native_line()

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

    # the flood phase's device width and K1's point check, each counted on
    # its own
    chunks = [prepare_batch(f_pubs[lo : lo + CHUNK], f_msgs[lo : lo + CHUNK],
                            f_sigs[lo : lo + CHUNK]) for lo in range(0, N_FLOOD, CHUNK)]
    mesh = mesh_step(dev, name_power, chunks[0], int32_rate)
    point = point_step(dev, name_power, cmp_batch, np.concatenate([oracle, expect_lanes]),
                       chunks, verdicts, int32_rate)
    del chunks
    host_verify = host_verify_step(name_power, arms, cases, got_np[: len(cases)],
                                   (f_pubs, f_msgs, f_sigs), verdicts)

    # K2 and K3 against their plain versions on the seal phase's trees, and
    # their times; then the trees go (a smaller heap for the collector)
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

    del state, txmap, base_items, sets, deletes, inners, buf, buf_plain, template, child_rows

    # 5. K1 and K4 against plain, and times, before the other processes start
    # to use the card -------------------------------------------------------
    # K1 against its plain version on the flood's chunks, the shapes the
    # main path launched it at (the first chunk's calls are the timed ones)
    prep_ms, k1_main_err = [], 0
    for lo in range(0, N_FLOOD, CHUNK):
        sl = slice(lo, lo + CHUNK)
        t0 = time.perf_counter()
        host = prepare_batch(f_pubs[sl], f_msgs[sl], f_sigs[sl])
        prep_ms.append((time.perf_counter() - t0) * 1e3)
        if lo == 0:
            mirror_prep = python_prep_ms(f_pubs[sl], f_msgs[sl], f_sigs[sl], host)
        tens = to_tensors(host, dev)
        if lo == 0:
            # the plain version's flags and time on this chunk are the
            # mesh step's (one call, by CUDA events)
            chunk_host, chunk_tens = host, tens
            k1_ms, got = cuda_ms(lambda: ed25519_cuda.verify(**tens), reps=10)
            k1_plain_ms, plain = mesh["plain_ms"], mesh["plain_flags"]
        else:
            got, plain = ed25519_cuda.verify(**tens), verify_kernel_ref(**tens)
        err = max_abs_err(got, plain)
        require(err == 0, f"K1 differs from its plain version on flood chunk {lo}")
        require(np.array_equal(got.cpu().numpy(), expect[sl]),
                f"K1 verdicts wrong on flood chunk {lo}")
        k1_main_err = max(k1_main_err, err)
        emit("k1_vs_plain_main", chunk_start=lo, lanes=int(got.numel()),
             max_abs_err=err, equal=True)
    k1_err = max(k1_err, k1_main_err)
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
         kernel_ms=k4_ms, bound_ms=k4_b, ms_over_bound=k4_ms / k4_b,
         wrapper_ms=k4_wrapper_ms, rotated_matrices=len(mats),
         rotated_mb=sum(m.numel() * 4 for m in mats) / 1e6)
    del k4_t, k4_got, k4_plain, mats, outs

    # 6-7. the consensus and tcp phases in a process of their own (SideRun),
    # each counted on its own there, while this one drives the chain ---------
    side = SideRun()
    scenario_side = None
    try:
        # 8. the close phase, counted on its own; the chain saved as it
        # closes; it joins the side process before it times K1
        saver = ChainSaver(STORE_DIR)
        close = close_phase(dev, name_power, saver, int32_rate, before_timing=side.join)

        # 11. the scenario kit in a third process (SideRun), counted on its
        # own, beside the book, the replay and the resume
        scenario_side = SideRun("--side-scenarios", "chip_smoke_scenarios", SCENARIOS_JOIN_S,
                                "the scenarios phase")

        # 9. the book phase on the same chain, counted on its own -------------
        book = book_phase(dev, name_power, close, saver)
        sides = side.join()
        consensus, tcp = sides["consensus"], sides["tcp"]
        close_launches, close_k1_err = close["launches"], close["k1_max_abs_err"]
        k1_batch1 = close["k1_batch1"]
        roles = launches_by_role(consensus["by_thread"], tcp["by_thread"], close["by_thread"],
                                 book["by_thread"])
        close_digests = close["close_digests"] + book["close_digests"]
        k1_err = max(k1_err, close_k1_err, consensus["k1_max_abs_err"], tcp["k1_max_abs_err"])
        k4_err = max(k4_err, book["k4_max_abs_err"])
        del close

        # 10. catch-up replay of the saved chain, then a node resumed lazily
        # on it, each counted on its own; the store is removed at the end
        try:
            replay = replay_phase(dev, name_power, saver, close_digests)
            resume = resume_step(dev, name_power, saver)
        finally:
            shutil.rmtree(saver.path, ignore_errors=True)
        del saver
        scenarios = scenario_side.join()["scenarios"]
    finally:
        side.stop()
        if scenario_side is not None:
            scenario_side.stop()

    emit("times", card=name_power, host_prep_ms_per_chunk=prep_ms, chunk=CHUNK,
         h_prep="native" if arms["h_prep"] else "python", python_prep=mirror_prep,
         host_verify=host_verify,
         flood_sigs_per_s=N_FLOOD / flood_s,
         seal_ms={k: v["seal_ms"] for k, v in seals.items()},
         hashlib_seal_ms={k: v["hashlib_seal_ms"] for k, v in seals.items()},
         k1_shape=[CHUNK], k2_shape=k2_shape, k3_nodes=n3, k4_shape=[rows, hops],
         int32_ops_per_s=int32_rate, total_s=time.perf_counter() - t_start)
    phases = (launches, consensus["launches"], tcp["launches"], close_launches,
              book["launches"], replay["launches"], resume["launches"], scenarios["launches"])
    main_launches = lambda name: sum(ph.get(name, 0) for ph in phases)  # noqa: E731
    kernels = [
        dict(name="ed25519_verify", route="cuda",
             source="stellard_tpu_torch/csrc/ed25519_verify.cu",
             replaces="stellard_tpu/ops/ed25519_pallas.py:107",
             launches=main_launches("ed25519_verify"),
             max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_b, bound_by=k1_by,
             library_ms=None),
        # the same kernel at the RPC door's shape: one signature a submit
        # (its launches are the close phase's and the resume step's
        # batch-1 launches, a part of the row above's)
        dict(name="ed25519_verify (batch 1)", route="cuda",
             source="stellard_tpu_torch/csrc/ed25519_verify.cu",
             replaces="stellard_tpu/ops/ed25519_pallas.py:107",
             launches=k1_batch1["launches"] + resume["k1_batch1"],
             max_abs_err=close_k1_err,
             ms=k1_batch1["ms"], plain_ms=k1_batch1["plain_ms"],
             bound_ms=k1_batch1["bound_ms"], bound_by=k1_batch1["bound_by"],
             library_ms=None),
        # the same kernel with the point final check (STELLARD_VERIFY_CHECK=
        # point); its launches are the point step's drive of the flood
        dict(name="ed25519_verify (point)", route="cuda",
             source="stellard_tpu_torch/csrc/ed25519_verify.cu",
             replaces="stellard_tpu/ops/ed25519_pallas.py:107",
             launches=point["launches"], max_abs_err=point["max_abs_err"],
             ms=point["point_ms"], plain_ms=point["plain_ms"], bound_ms=point["bound_ms"],
             bound_by=point["bound_by"], library_ms=None),
        # K1 with its count epilogue, one launch a shard, the shards'
        # counts summed on the first device; its launches are the mesh
        # step's two dry runs, its times at width 1 on a flood chunk
        dict(name="verify_and_count", route="cuda",
             source="stellard_tpu_torch/csrc/ed25519_verify.cu",
             replaces="stellard_tpu/parallel/mesh.py:166",
             launches=mesh["counted_k1_launches"], max_abs_err=mesh["max_abs_err"],
             ms=mesh["ms"], plain_ms=mesh["plain_ms"], bound_ms=mesh["bound_ms"],
             bound_by=mesh["bound_by"], library_ms=None),
        dict(name="sha512_masked", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/ops/treehash_jax.py:49",
             launches=main_launches("sha512_masked"), launches_by_role=roles["sha512_masked"],
             launches_scenarios=scenarios["launches"]["sha512_masked"],
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


MESH_SHARDS = 4  # the mesh step's second run: four shards on the one card


def mesh_step(dev, name_power: str, chunk: dict, int32_rate: float) -> dict:
    """The device width (the flood phase's `mesh` line): the port's
    ``entry.dryrun_multichip`` (verify_and_count with K1's count
    epilogue, planted R/S/A corruptions, a ragged batch padded with zero
    rows, 64 mesh-hashed payloads against hashlib) at the width of the
    visible cards and again over MESH_SHARDS shards placed on this one
    card, counted on its own: K1's counted launches and K2's are one a
    shard. Then verify_and_count on the flood's first chunk at width 1
    and over the shards on the card: the same flags at both widths,
    equal to K1's plain version, and both totals (the count epilogue)
    equal to its plain version, flags.sum(); timed at width 1."""
    import numpy as np
    import torch

    from stellard_tpu_torch.entry import dryrun_multichip
    from stellard_tpu_torch.ops import ed25519_cuda, treehash
    from stellard_tpu_torch.ops.ed25519 import to_tensors, verify_kernel_ref
    from stellard_tpu_torch.parallel import make_mesh, verify_and_count

    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    ed25519_cuda.reset_launches()
    treehash.reset_launches()
    runs = [dryrun_multichip(n_cards, device="cuda"),
            dryrun_multichip(MESH_SHARDS, device=[dev] * MESH_SHARDS)]
    counted, k2 = ed25519_cuda.variant_launches["count"], treehash.launches["sha512_masked"]
    require(counted == 2 * (n_cards + MESH_SHARDS),
            f"{counted} counted K1 launches for two dry runs at widths {n_cards} and "
            f"{MESH_SHARDS}: not one a shard")
    require(k2 == n_cards + MESH_SHARDS, f"{k2} K2 launches for the dry runs' hashing")

    tens = to_tensors(chunk, dev)
    step1 = verify_and_count(make_mesh([dev]))
    stepn = verify_and_count(make_mesh([dev] * MESH_SHARDS))
    vac_ms, (flags1, total1) = cuda_ms(lambda: step1(**tens), reps=10)
    flagsn, totaln = stepn(**tens)
    plain_ms, (pflags, ptotal) = once_ms(
        lambda: (lambda f: (f, f.sum(dtype=torch.int32)))(verify_kernel_ref(**tens)))
    err = max(max_abs_err(flags1, pflags), max_abs_err(flagsn, pflags),
              abs(int(total1) - int(ptotal)), abs(int(totaln) - int(ptotal)))
    require(err == 0, "verify_and_count differs from its plain version on the flood chunk")
    require(torch.equal(flags1, flagsn), "flags differ across widths")
    bound, by = bound_ms(k1_ops(chunk), 130 * len(chunk["s_canonical"]) + 4, int32_rate)
    out = {"card": name_power, "visible_cards": n_cards, "shards_on_one_card": MESH_SHARDS,
           "dry_runs": [{k: v for k, v in r.items() if k != "flags"} for r in runs],
           "counted_k1_launches": counted, "k2_launches": k2,
           "chunk": len(chunk["s_canonical"]), "total": int(total1),
           "total_shards": int(totaln), "flags_equal_across_widths": True,
           "max_abs_err": err, "ms": vac_ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": by, "wall_s": time.perf_counter() - t0}
    emit("mesh", **out)
    # the plain K1 flags of the flood's first chunk, which K1's own
    # comparison on that chunk (phase 9) takes instead of a second call
    return {**out, "plain_flags": pflags}


def point_step(dev, name_power: str, cmp_batch: dict, cmp_expect, chunks: list,
               verdicts, int32_rate: float) -> dict:
    """K1's point check (the flood phase's `point` line): against the
    plain point version on the adversarial corpus with 4,096 flood
    lanes, and on the flood's first chunk; then the flood's two chunks
    driven through the verifier's sharded call in point mode, counted
    on their own, with the bytes mode's verdicts. Timed at 16,384 beside
    the bytes check and the bytes check with the count epilogue, each
    with its bound (k1_ops recounted for the mode)."""
    import numpy as np
    import torch

    from stellard_tpu_torch.ops import ed25519_cuda
    from stellard_tpu_torch.ops.ed25519 import to_tensors, verify_kernel_ref
    from stellard_tpu_torch.parallel import make_mesh, sharded_verify_kernel

    t0 = time.perf_counter()
    cmp_t = to_tensors(cmp_batch, dev)
    got = ed25519_cuda.verify(**cmp_t, check="point")
    err = max_abs_err(got, verify_kernel_ref(**cmp_t, check="point"))
    require(err == 0, "K1's point check differs from its plain version on the corpus")
    require(np.array_equal(got.cpu().numpy(), cmp_expect),
            "K1's point check differs from the oracle on the corpus and lanes")
    tens = [to_tensors(c, dev) for c in chunks]
    point_ms, got0 = cuda_ms(lambda: ed25519_cuda.verify(**tens[0], check="point"), reps=10)
    plain_ms, plain0 = once_ms(lambda: verify_kernel_ref(**tens[0], check="point"))
    err = max(err, max_abs_err(got0, plain0))
    require(err == 0, "K1's point check differs from its plain version on the flood chunk")
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    bytes_ms, _ = cuda_ms(lambda: ed25519_cuda.verify(**tens[0], check="bytes"), reps=10)
    counted_ms, _ = cuda_ms(lambda: ed25519_cuda.verify(**tens[0], check="bytes", count=count),
                            reps=10)
    # the warm-up call and ten timed ones, each adding the chunk's accepts
    require(int(count) == 11 * int(verdicts[:CHUNK].sum()), "the count epilogue miscounted")

    # the flood through the verifier's own sharded call, in point mode
    ed25519_cuda.reset_launches()
    point = sharded_verify_kernel(make_mesh([dev]), check="point")
    flood = np.concatenate([point(**t).cpu().numpy() for t in tens])
    launches = ed25519_cuda.variant_launches["point"]
    require(launches == len(chunks), f"{launches} point-mode launches for {len(chunks)} chunks")
    require(np.array_equal(flood, verdicts), "the point check's flood verdicts differ from "
            "the bytes check's")
    bound_p, by_p = bound_ms(k1_ops(chunks[0], "point"), 130 * CHUNK, int32_rate)
    bound_b, _ = bound_ms(k1_ops(chunks[0], "bytes"), 130 * CHUNK, int32_rate)
    out = {"card": name_power, "corpus_and_lanes": int(got.numel()),
           "flood": int(flood.size), "accepted": int(flood.sum()), "equal_bytes_mode": True,
           "launches": launches, "max_abs_err": err, "chunk": CHUNK,
           "point_ms": point_ms, "bytes_ms": bytes_ms, "bytes_count_ms": counted_ms,
           "plain_ms": plain_ms, "bound_ms": bound_p, "bound_by": by_p,
           "bytes_bound_ms": bound_b, "wall_s": time.perf_counter() - t0}
    emit("point", **out)
    return out


def close_phase(dev, name_power: str, saver, int32_rate: float,
                before_timing=None) -> dict:
    """The standalone node under a payment flood (CLOSE_SIZES), through
    its doors. The port's Node is built from a config beside the chain's
    store (node_config_text, PORT_NODE_DEVICE: every crypto plane on the
    card, admission caps that never bind), which starts its verify
    plane's K1 prewarm; the 1,000,000 AccountRoots are resumed through
    its LedgerMaster.load_ledger and saved to its store; serve() waits
    for the prewarm, opens the HTTP and WebSocket doors and freezes the
    heap so far out of the collector's scans (the node's collector
    policy, utils/gcpolicy.py). Then 4 closes
    of 4,096 signed Payments, each payment a `submit` through HTTP (its
    signature verified by K1 at batch 1, admitted by the TxQ, applied to
    the open ledger and speculated), each close a `ledger_accept` (the
    JAX node's default close: the recorded deltas spliced, the building
    tree pre-hashed by the seal drainer and adopted, both trees sealed on
    two threads through the node's WatchdogHasher: K2, K3), persisted
    through the node's close pipeline (node store, txdb, CLF; ``saver``
    counts and digests). The last close runs between `profile` start
    and stop: the card's busy share of it. Every verdict, TER, ledger
    hash, results digest, splice count, adoption, persisted digest, the
    `ledger` stream's hashes and the read RPCs' answers are checked; the
    launch counts are this phase's alone. Then ``before_timing()``, if
    given (run() passes SideRun.join: the other users of the card end
    first), and K1 against its plain version on a close's batch and at
    batch sizes 1-33, timed at batch 1."""
    import numpy as np

    from stellard_tpu_torch.interop import ledger_from_items
    from stellard_tpu_torch.node.config import Config
    from stellard_tpu_torch.node.node import Node
    from stellard_tpu_torch.ops import ed25519_cuda, treehash
    from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref
    from stellard_tpu_torch.protocol import keys
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction
    from stellard_tpu_torch.protocol.ter import TER
    from stellard_tpu_torch.utils import devicewatch

    t0 = time.perf_counter()
    wl = close_workload(**CLOSE_SIZES)
    inputs_s = time.perf_counter() - t0

    ed25519_cuda.launches = 0
    ed25519_cuda.launches_by_batch.clear()
    treehash.reset_launches()
    keys.host_verifies = 0
    devicewatch.reset_call_stats()
    t_node = time.perf_counter()
    cfg = Config.from_ini(node_config_text(
        saver.path, PORT_NODE_DEVICE.format(dev=dev, floor=BOOK_PRUNE_FLOOR) + CLOSE_NODE_SPEC))
    wire = WireMax()  # restored by book_phase, once the node has stopped
    node = Node(cfg)  # forks the speculation pool, then starts the K1 prewarm
    hasher = node.hasher.inner  # the CudaHasher behind the watchdog
    t1 = time.perf_counter()
    start = ledger_from_items(start_header(), account_root_items(wl["accounts"]),
                              hash_batch=node.hasher)
    t2 = time.perf_counter()
    node.ledger_master.load_ledger(start)  # seals the whole state tree
    t3 = time.perf_counter()
    saver.attach_node(node)
    saver.save(start)
    node.serve()  # waits for the prewarm; freezes the start-up heap
    t4 = time.perf_counter()
    frozen = gc.get_freeze_count()
    prewarm_k1 = dict(ed25519_cuda.launches_by_batch)
    res = drive_node_closes(node, wl, profile_close=len(wl["closes"]) - 1)
    closes_s = time.perf_counter() - t4
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
    by_batch = dict(ed25519_cuda.launches_by_batch)
    by_thread = {k: dict(v) for k, v in treehash.launches_by_thread.items()}
    host_verifies = keys.host_verifies
    watchdog = dict(devicewatch.call_stats)
    tree = node.ledger_master.tree_json()
    t0 = time.perf_counter()
    saver.persist.flush()
    flush_ms = (time.perf_counter() - t0) * 1e3
    reads = read_back(node, wl)
    http = HttpRpc(node.http_server.port)
    counts = http.call("get_counts")
    http.close()
    # the config's default width, auto: every visible card, reported by
    # both planes
    import torch

    widths = {plane: {k: counts["crypto"][plane]["mesh"][k]
                      for k in ("mesh_requested", "mesh_width", "devices_visible")}
              for plane in ("verify", "hash")}
    n_cards = torch.cuda.device_count()
    require(cfg.verify_mesh == cfg.hash_mesh == "auto"
            and all(w == {"mesh_requested": "auto", "mesh_width": n_cards,
                          "devices_visible": n_cards} for w in widths.values()),
            f"get_counts reports the widths {widths} for {n_cards} visible cards")

    closes = res["closes"]
    n_pay = sum(len(c) for c in wl["closes"])
    for k, (c, entries) in enumerate(zip(closes, wl["closes"])):
        kinds = [kind for _b, kind, _g in entries]
        want = [int(TER.temINVALID) if kd == "bad_sig" else int(TER.tesSUCCESS)
                for kd in kinds]
        require(c["open_ters"] == want, f"close {k}: submit answers' TERs wrong")
        require([r != "temINVALID" for r in c["engine_results"]]
                == [g for _b, _k, g in entries], f"close {k}: verdicts wrong")
        require(len(c["close_ters"]) == len(kinds) - kinds.count("bad_sig")
                and set(c["close_ters"].values()) == {int(TER.tesSUCCESS)},
                f"close {k}: closed TERs wrong")
        require(c["hash"] == CLOSE_HASHES[k], f"close {k}: ledger hash {c['hash']} "
                f"differs from the JAX package's {CLOSE_HASHES[k]}")
        require(c["digest"] == CLOSE_DIGESTS[k], f"close {k}: results digest differs")
    require(start.hash().hex() == START_HASH, "start ledger hash differs from the JAX package's")
    require(res["stream"] == CLOSE_HASHES,
            f"the ledger stream's hashes {res['stream']} are not the closes'")
    check_default_close(closes, 0, saver, "close phase")
    require(reads["ledger_closed"] == CLOSE_HASHES[-1], "ledger_closed is not the last close")
    require(reads["digests"] == READ_DIGESTS,
            f"read RPC answers {reads['digests']} differ from the JAX node's {READ_DIGESTS}")
    require(host_verifies == 0, f"{host_verifies} host signature verifications on the close path")
    vp, hj = counts["verify_plane"], counts["crypto"]["hash"]
    require(vp["device_share"] == 1.0 and vp["cpu_sigs"] == 0,
            f"close phase device share {vp['device_share']}")
    require(not vp["device_wedged"] and not hj["wedged"], "a device plane wedged")
    require(all(counts["tree"][k] == 0 for k in ABSORBED),
            f"errors absorbed by the close's helpers {counts['tree']}")
    require(node.verify_plane.prewarm_error is None, "the K1 prewarm failed")
    n_batch1 = by_batch.get(1, 0) - prewarm_k1.get(1, 0)
    require(n_batch1 == n_pay, f"{n_batch1} K1 launches at batch 1 for {n_pay} submits")
    tt = hasher.tree_transfers
    require(tt.readbacks == hasher.tree_calls, f"readbacks {tt.readbacks} != tree calls "
            f"{hasher.tree_calls}")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the close phase")
    check_seal_threads(tree, {}, by_thread, hasher.device_nodes, "close phase")
    prof_wall = closes[-1]["wall_ms"]
    busy = busy_share(res["profile"]["trace"], prof_wall)
    other_wall = float(np.mean([c["wall_ms"] for c in closes[:-1]]))
    if before_timing is not None:
        before_timing()

    # K1 against its plain version at the shapes the close gave it: one
    # close's batch (the harness's shape, and the prewarm's 4,096), and
    # every door's single signature -- batches of 1-33 over a good
    # signature, a bad S, a non-canonical S and an undecodable key
    txs = [SerializedTransaction.from_bytes(b) for b, _k, _g in wl["closes"][0]]
    tens = to_tensors(prepare_batch([tx.signing_pub_key for tx in txs],
                                    [tx.signing_hash() for tx in txs],
                                    [tx.signature for tx in txs]), dev)
    got, plain = ed25519_cuda.verify(**tens), verify_kernel_ref(**tens)
    k1_err = max_abs_err(got, plain)
    require(k1_err == 0, "K1 differs from its plain version on a close's batch")
    require(got.cpu().numpy().tolist() == [g for _b, _k, g in wl["closes"][0]],
            "K1 verdicts on a close's batch")
    k1_small = k1_small_batches(dev)
    k1_err = max(k1_err, k1_small["max_abs_err"])
    one = to_tensors(prepare_batch([txs[0].signing_pub_key], [txs[0].signing_hash()],
                                   [txs[0].signature]), dev)
    b1_ms, _ = cuda_ms(lambda: ed25519_cuda.verify(**one), reps=50)
    b1_plain_ms, _ = cuda_ms(lambda: verify_kernel_ref(**one), reps=1)
    b1_bound, b1_by = bound_ms(k1_ops(prepare_batch(
        [txs[0].signing_pub_key], [txs[0].signing_hash()], [txs[0].signature])),
        130, int32_rate)

    per_close = [{key: c[key] for key in DOOR_CLOSE_KEYS} for c in closes]
    door = HttpRpc(node.http_server.port)
    try:
        close_health = health_report("close-node", door.call("health"))
    finally:
        door.close()
    summary = {
        "card": name_power, "accounts": CLOSE_SIZES["n_accounts"],
        "senders": CLOSE_SIZES["n_senders"], "closes": len(closes), "payments": n_pay,
        "payments_per_s": n_pay / sum(c["wall_ms"] for c in closes) * 1e3,
        "inputs_s": inputs_s, "node_ms": (t1 - t_node) * 1e3, "build_state_ms": (t2 - t1) * 1e3,
        "load_ms": (t3 - t2) * 1e3, "serve_ms": (t4 - t3) * 1e3,
        "frozen_objects": frozen, "phase_s": closes_s,
        "pipeline_flush_ms": flush_ms, "per_close": per_close,
        "kinds": {kd: sum(kind == kd for c in wl["closes"] for _b, kind, _g in c)
                  for kd in ("existing", "new_account", "bad_sig")},
        "hashes_equal_jax": True, "stream_hashes_equal": True, "reads_equal_jax": True,
        "host_verifies": host_verifies, "device_share": vp["device_share"],
        "device_batches": vp["device_batches"], "verify_device_quantiles":
        vp["latency_histogram_ms"]["device_quantiles"],
        "tree_calls": hasher.tree_calls, "readbacks": tt.readbacks,
        "k1_launches_by_batch": {str(k): v for k, v in sorted(by_batch.items())},
        "k1_prewarm_launches": sum(prewarm_k1.values()), "k1_batch1_submits": n_batch1,
        "watchdog_calls": watchdog["calls"], "watchdog_start_ms": watchdog["start_ms"],
        "launches": launches, "launches_by_thread": by_thread,
        "txq": counts["txq"], "mesh": widths, "health": close_health,
    }
    emit("close", **summary)
    emit("door", card=name_power, per_close=[
        {"seq": c["seq"], "submit_ms": c["submit_ms"], "door_ms_per_tx": c["door_ms_per_tx"],
         "verify_ms": c["verify_ms"], "open_apply_ms": c["apply_ms"],
         "door_only_ms_per_tx": (c["submit_ms"] - c["verify_ms"] - c["apply_ms"])
         / len(e), "ledger_accept_ms": c["close_ms"]}
        for c, e in zip(closes, wl["closes"])],
        k1_batch1_ms=b1_ms, k1_batch1_plain_ms=b1_plain_ms, k1_batch1_bound_ms=b1_bound,
        k1_small_batches=k1_small["sizes"])
    spec = counts["spec"]
    emit("spec", of="close", card=name_power, workers=spec["workers"], mode=spec["mode"],
         transport=spec["transport"], payments_per_s=summary["payments_per_s"],
         per_close=[{"seq": c["seq"], "counters": c["spec"], "drain_ms": c["spec_drain_ms"],
                     "door_ms_per_tx": c["door_ms_per_tx"],
                     "verify_ms_per_tx": c["verify_ms"] / len(e),
                     "open_apply_ms_per_tx": c["apply_ms"] / len(e),
                     "door_only_ms_per_tx": (c["submit_ms"] - c["verify_ms"] - c["apply_ms"])
                     / len(e), "payments_per_s": len(e) / c["wall_ms"] * 1e3}
                    for c, e in zip(closes, wl["closes"])],
         totals={k: spec[k] for k in SPEC_COUNTERS}, ring=spec["ring"],
         max_record_bytes=dict(wire.by_kind))
    check_spec_pool(spec, node.spec_executor, "close phase")
    emit("busy", card=name_power, seq=closes[-1]["seq"], **busy,
         profiled_close_wall_ms=prof_wall, other_closes_mean_wall_ms=other_wall,
         profiler_overhead=prof_wall / other_wall - 1.0)
    emit("delta", of="close", per_close=[dict(c["delta"], seq=c["seq"]) for c in closes],
         tree=tree)
    return {"launches": launches, "by_thread": by_thread, "k1_max_abs_err": k1_err,
            "wl": wl, "node": node, "hasher": hasher, "wire": wire,
            "close_digests": [c["close_digest"] for c in closes],
            "k1_batch1": dict(ms=b1_ms, plain_ms=b1_plain_ms, bound_ms=b1_bound,
                              bound_by=b1_by, launches=n_batch1)}


def k1_small_batches(dev) -> dict:
    """K1 against its plain version and the RFC 8032 oracle at the batch
    sizes the door gives it and around a warp's edge (1, 2, 3, 4, 31, 32,
    33), each batch cycling through a good signature, one with a bad S,
    one with a non-canonical S (S + l) and one under an undecodable key.
    The plain version, lane by lane as K1 is, runs once on the 33 lanes:
    each batch is their prefix (a plain call costs seconds at any batch)."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_cuda, ed25519_ref
    from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref

    pubs, msgs, sigs = sign_pairs(33, seed=71)
    bad_key = undecodable_key(seed=72)
    lanes = []
    for i, (p, m, sg) in enumerate(zip(pubs, msgs, sigs)):
        kind = i % 4
        if kind == 1:
            sg = sg[:32] + bytes([sg[32] ^ 1]) + sg[33:]
        elif kind == 2:
            sg = sg[:32] + (int.from_bytes(sg[32:], "little") + ed25519_ref.L).to_bytes(
                32, "little")
        elif kind == 3:
            p = bad_key
        lanes.append((p, m, sg))
    ps, ms, ss = (list(t) for t in zip(*lanes))
    plain = verify_kernel_ref(**to_tensors(prepare_batch(ps, ms, ss), dev))
    oracle = [ed25519_ref.verify(p, m, sg) for p, m, sg in lanes]
    err, sizes = 0, {}
    for n in (1, 2, 3, 4, 31, 32, 33):
        got = ed25519_cuda.verify(**to_tensors(prepare_batch(ps[:n], ms[:n], ss[:n]), dev))
        e = max_abs_err(got, plain[:n])
        require(e == 0 and got.cpu().numpy().tolist() == oracle[:n],
                f"K1 differs from its plain version or the oracle at batch {n}")
        err = max(err, e)
        sizes[str(n)] = int(np.sum(oracle[:n]))
    require(sizes["4"] == 1, "the small-batch lanes are not one good signature in four")
    return {"max_abs_err": err, "sizes": sizes}


# --------------------------------------------------------------------------
# the consensus phase: BASELINE config #4, a 4-validator UNL net


# 4 measured rounds of 512 payments (8 until the tcp phase took over the
# 4-validator measurement; PERF.md §4), a relay burst of 64 transactions
# in one delivery
CONSENSUS_SIZES = dict(n_rounds=4, per_round=512, n_burst=64, bad_share=0.01, seed=37)
CONSENSUS_DESTS = 16
PAYMENT_DROPS = 250_000_000  # 250 STR: the first payment to a destination creates it
FUND_DROPS = 100_000 * 1_000_000  # the relay burst's sender
# what the JAX package's SimNet gives on the same workload (recomputed by
# tests/test_torch_consensus.py's slow test): the validated hash and the
# closed results' digest at every seq from 2, each validator's rounds and
# defense counters, the net's counters and the disputed transactions that
# accept() re-checked on the host
CONSENSUS_HASHES = [
    "a7b90b2b0049a9a758d22cd7682699ae0b25f6c140596011c929ebbf1bb7fcab",
    "0bffe0d686ce2acfa55fe6c27e737aa9ee1b99659cb25ee2772118a9e9e1bf64",
    "6fba4dd20f5416ffa52e61bed787d9265fc06925cb3eaeb40b288de433c193b2",
    "cef416c0ef9d8feb96a868bd97485e9dbe769ad2959e0e242b718d786fa204cc",
    "bb8e6f40d118f6280467ac1936de9e506f6ad4e07cc58c2b0d5c6468afce831a",
    "4ecfcc70338f996a34a0d9391ec43c0fff8e4a7e23382de98d5454ae97cdaa8b",
]
CONSENSUS_RESULTS = [
    "2eabfade20812835ec436dd68ae5c609c852dabedd31d01131e8e4840d64993e",
    "d5f69f31f9cd2b00ad5beca0197b1cd0fd3cdc73976807a91bde32e0e051dbb8",
    "dc07709cb39fd7243457ec582e6c5ce9223f7d0c441cb6c4040f66b5caa8c2ee",
    "7e2de966096783aa4983c9883f8c6aa0f2ac1a1464f7c4df421531ffbeff25f4",
    "0a6a47e071136b1125bcf23648d2922e59640cf58089ed649065848a94878bac",
    "b90e3e86e3708c37dc23890db5eaad2c48ce92e37c63f23b05c97365e6ab84c7",
]
CONSENSUS_COUNTERS = {
    "rounds_completed": [6, 6, 6, 6],
    "defense": [{"bad_proposal_sig": 1, "bad_validation_sig": 1}, {}, {}, {}],
    "net_stats": {"sent": 6369, "dropped_link": 0, "dropped_fault": 0, "dropped_down": 0,
                  "duplicated": 0, "delayed": 0},
    "dispute_rechecks": 0,
    "frames": "eab570af7745cc8649a3affea7562e0e4c4d11571a85ad05aa068ee34ce855cf",
}


def signed_payment(key, seq: int, dst: bytes, drops: int):
    """A Payment of ``drops`` from ``key``'s account at sequence ``seq``,
    fee 10, signed with the port's protocol/keys.py."""
    from stellard_tpu_torch.protocol.formats import TxType
    from stellard_tpu_torch.protocol.sfields import sfAmount, sfDestination
    from stellard_tpu_torch.protocol.stamount import STAmount
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    tx = SerializedTransaction.build(
        TxType.ttPAYMENT, key.account_id, seq, 10,
        {sfAmount: STAmount.from_drops(drops), sfDestination: dst})
    tx.sign(key)
    return tx


def flipped_blob(key, tx, rng) -> bytes:
    """``tx`` with one bit of its signature's R flipped (the byte and bit
    drawn from ``rng``), serialized; bad by the RFC 8032 oracle."""
    from stellard_tpu_torch.ops import ed25519_ref
    from stellard_tpu_torch.protocol.sfields import sfTxnSignature

    sig = bytearray(tx.signature)
    sig[int(rng.integers(32))] ^= 1 << int(rng.integers(8))  # within R
    require(not ed25519_ref.verify(key.public, tx.signing_hash(), bytes(sig)),
            "a flipped signature verifies")
    tx.obj[sfTxnSignature] = bytes(sig)
    return tx.serialize()


def consensus_workload(n_rounds: int, per_round: int, n_burst: int, bad_share: float,
                       seed: int) -> dict:
    """Seeded inputs of the consensus phase, as bytes, in the shape of
    bench.py's ``_payments``: Payments of 250 STR from the master account
    to 16 destinations with consecutive sequences, the first payment to
    each destination creating it.

    - ``fund``: the master's sequence 1, funding the relay burst's sender
      (submitted in the warm-up);
    - ``rounds``: per measured round, per_round (blob, bad) pairs with
      the master's sequences from 2; ``bad`` is None or, for a share
      ``bad_share`` of them, a copy with one bit of the signature's R
      flipped, to be submitted just before the good one;
    - ``burst``: n_burst payments of the funded sender for one delivery,
      its sequences from 1, except lane ``bad_lane``: a copy of its
      sequence n_burst payment with one signature bit flipped (the good
      twin is never sent);
    - ``flip``: the (byte, bit) of the signature flipped in the forged
      validation and proposal.

    Signed with the port's protocol/keys.py; every flipped copy is bad by
    the RFC 8032 oracle."""
    import numpy as np

    from stellard_tpu_torch.protocol.keys import KeyPair

    rng = np.random.default_rng(seed)
    master = KeyPair.from_passphrase("masterpassphrase")
    sender = KeyPair.from_seed(rng.bytes(32))
    dests = [KeyPair.from_passphrase(f"bench-dest-{i}").account_id
             for i in range(CONSENSUS_DESTS)]
    pay = signed_payment

    def flipped(key, tx) -> bytes:
        return flipped_blob(key, tx, rng)

    fund = pay(master, 1, sender.account_id, FUND_DROPS).serialize()
    rounds, seq = [], 2
    for _ in range(n_rounds):
        entries = []
        for _p in range(per_round):
            dst = dests[(seq - 2) % CONSENSUS_DESTS]
            good = pay(master, seq, dst, PAYMENT_DROPS).serialize()
            bad = flipped(master, pay(master, seq, dst, PAYMENT_DROPS)) \
                if rng.random() < bad_share else None
            entries.append((good, bad))
            seq += 1
        rounds.append(entries)
    burst = [pay(sender, s, dests[s % CONSENSUS_DESTS], PAYMENT_DROPS).serialize()
             for s in range(1, n_burst)]
    bad_lane = int(rng.integers(n_burst))
    burst.insert(bad_lane, flipped(sender, pay(
        sender, n_burst, dests[n_burst % CONSENSUS_DESTS], PAYMENT_DROPS)))
    flip = (int(rng.integers(32)), int(rng.integers(8)))
    return {"fund": fund, "rounds": rounds, "burst": burst, "bad_lane": bad_lane,
            "flip": flip}


def port_consensus_names():
    """The port's names that run_consensus drives (a test passes the JAX
    package's own to run the same workload there)."""
    from types import SimpleNamespace

    from stellard_tpu_torch.consensus.consensus import LedgerConsensus
    from stellard_tpu_torch.consensus.validation import STValidation
    from stellard_tpu_torch.node.hashrouter import SF_BAD, SF_SIGGOOD
    from stellard_tpu_torch.overlay import wire
    from stellard_tpu_torch.overlay.simnet import SimNet
    from stellard_tpu_torch.protocol.sfields import sfSignature
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction
    from stellard_tpu_torch.protocol.ter import TER

    return SimpleNamespace(SimNet=SimNet, LedgerConsensus=LedgerConsensus,
                           STValidation=STValidation, wire=wire, sfSignature=sfSignature,
                           SerializedTransaction=SerializedTransaction, TER=TER,
                           SF_BAD=SF_BAD, SF_SIGGOOD=SF_SIGGOOD)


def disputes_to_recheck(rnd) -> int:
    """The disputed transactions LedgerConsensus.accept is about to
    re-check with a host ``check_sign`` before re-applying them (those
    neither in the agreed set nor in its own open ledger; the
    reference's own behaviour, consensus/consensus.py accept)."""
    if not rnd.disputes:
        return 0
    agreed = rnd.acquired.get(
        rnd.our_position.tx_set_hash if rnd.our_position else b"", rnd.our_set)
    skip = {tx.txid() for tx in agreed.transactions()} if agreed else set()
    skip |= rnd._pre_close_open_ids
    return sum(1 for d in rnd.disputes.values() if d.txid not in skip and d.blob)


@contextlib.contextmanager
def counting_dispute_rechecks(consensus_cls, counter: list):
    """Count disputes_to_recheck over every accept() of `consensus_cls`
    while the context lasts."""
    accept = consensus_cls.accept

    def counted(rnd, *args, **kwargs):
        counter[0] += disputes_to_recheck(rnd)
        return accept(rnd, *args, **kwargs)

    consensus_cls.accept = counted
    try:
        yield counter
    finally:
        consensus_cls.accept = accept


def forged(ns, obj, flip) -> bytes:
    """A real validation or proposal with one bit of its signature
    flipped, framed for the wire."""
    byte, bit = flip
    sig = bytearray(obj.signature)
    sig[byte] ^= 1 << bit
    if isinstance(obj, ns.STValidation):
        copy = ns.STValidation.from_bytes(obj.serialize())
        copy.obj[ns.sfSignature] = bytes(sig)
        return ns.wire.frame(ns.wire.ValidationMessage(copy.serialize()))
    msg = ns.wire.ProposeSet.from_proposal(obj)
    msg.signature = bytes(sig)
    return ns.wire.frame(msg)


def run_consensus(ns, wl: dict, verify_many=None, hasher=None, on_start=None) -> dict:
    """BASELINE config #4 on `ns`'s SimNet (port_consensus_names, or a
    test's JAX names): 4 validators, all on the UNL, quorum 3, full mesh,
    latency 1 step of 1,000 ms, idle interval 4 (the SimNet defaults
    bench.py's bench_consensus_close runs). ``verify_many`` and
    ``hasher``, when given, serve all four validators (their nodes'
    ``verify_many``; ``hash_batch`` of each node, LedgerMaster and
    InboundLedgers, wired before start as bench.py wires the plane);
    ``on_start`` is called with the net before it starts.

    - warm-up: the sender's funding at validator 0, then until every
      validator has validated seq 2;
    - measured rounds: each round's payments at validator 0 through
      ``submit_client_tx``, a bad copy first through the node's own
      ``submit`` (the door refuses it, so it is never relayed), then
      until all four have validated the next seq;
    - the relay burst: one delivery of all its TxMessages to each
      validator (from the next validator), then until the burst's good
      payments are in a validated ledger on all four;
    - a forged validation and a forged proposal (validator 3's latest,
      one signature bit flipped) from validator 3 to validator 0, then
      two steps.

    Returns every validated hash from seq 2 (the same on all four), the
    closed results' digests, the counters, the verdicts of the planted
    traffic and the wall ms of each measured round."""
    net = ns.SimNet(4)
    accepted = {}  # (nid, seq) -> (hash, closed results digest)
    note = net.on_ledger_accepted

    def on_accepted(nid, ledger):
        note(nid, ledger)
        accepted[(nid, ledger.seq)] = (ledger.hash().hex(),
                                       close_results_digest(ledger.apply_results))

    net.on_ledger_accepted = on_accepted
    frames = hashlib.sha256()  # every frame sent, with its ends
    send = net.send

    def sent_frame(src, dst, data):
        frames.update(b"%d>%d:%d:" % (src, dst, len(data)) + data)
        return send(src, dst, data)

    net.send = sent_frame
    latest = {}  # validator 3's last validation and proposal

    def keep(kind, send):
        def sent(obj):
            latest[kind] = obj
            return send(obj)
        return sent

    v0, v3 = net.validators[0], net.validators[3]
    v3.send_validation = keep("validation", v3.send_validation)
    v3.propose = keep("proposal", v3.propose)
    for v in net.validators:
        if verify_many is not None:
            v.node.verify_many = verify_many
        if hasher is not None:
            v.node.hash_batch = v.node.lm.hash_batch = v.node.inbound.hash_batch = hasher
    if on_start is not None:
        on_start(net)
    parse = ns.SerializedTransaction.from_bytes
    rechecks = [0]
    out = {"round_ms": [], "submit_ms": [], "bad_copy_ters": [], "steps": {}}
    try:
        with counting_dispute_rechecks(ns.LedgerConsensus, rechecks):
            net.start()
            v0.submit_client_tx(parse(wl["fund"]))
            require(net.run_until(lambda: net.all_validated_at_least(2), 30),
                    "the warm-up did not validate seq 2")
            out["steps"]["warmup"] = net.time_ms // net.step_ms
            base = v0.node.lm.validated.seq
            for r, entries in enumerate(wl["rounds"]):
                t0 = time.perf_counter()
                for good, bad in entries:
                    if bad is not None:
                        sent = net.net_stats["sent"]
                        ter, _ = v0.node.submit(parse(bad))
                        require(net.net_stats["sent"] == sent, "a bad copy was relayed")
                        out["bad_copy_ters"].append(int(ter))
                    v0.submit_client_tx(parse(good))
                t1 = time.perf_counter()
                target = base + r + 1
                require(net.run_until(lambda: net.all_validated_at_least(target), 120),
                        f"round {r}: seq {target} was not validated by all four")
                out["round_ms"].append((time.perf_counter() - t0) * 1e3)
                out["submit_ms"].append((t1 - t0) * 1e3)
            # the relay burst: every validator gets it in one delivery
            data = b"".join(ns.wire.frame(ns.wire.TxMessage(b)) for b in wl["burst"])
            for v in net.validators:
                net.send(net.validators[(v.nid + 1) % 4].nid, v.nid, data)
            burst_ids = [parse(b).txid() for b in wl["burst"]]
            good_ids = [t for i, t in enumerate(burst_ids) if i != wl["bad_lane"]]

            def burst_validated():
                for v in net.validators:
                    lm = v.node.lm
                    if lm.validated is None:
                        return False
                    closed = set()
                    for seq in range(base + 1, lm.validated.seq + 1):
                        led = lm.get_ledger_by_seq(seq)
                        closed |= set(getattr(led, "apply_results", {}) or {})
                    if not set(good_ids) <= closed:
                        return False
                return True

            require(net.run_until(burst_validated, 60), "the burst was not validated")
            out["burst_verdicts"] = [
                ["good" if f & ns.SF_SIGGOOD else "bad" if f & ns.SF_BAD else None
                 for f in map(v.node.router.get_flags, burst_ids)]
                for v in net.validators]
            # forged validation and proposal from validator 3 to validator 0
            net.send(v3.nid, v0.nid, forged(ns, latest["validation"], wl["flip"]))
            net.send(v3.nid, v0.nid, forged(ns, latest["proposal"], wl["flip"]))
            net.step(2)
            out["steps"]["end"] = net.time_ms // net.step_ms
    finally:
        for v in net.validators:
            v.node.lm.stop_seal_drainer()
    final = min(net.validated_seqs())
    hashes, results = [], []
    for seq in range(2, final + 1):
        got = {v.node.lm.ledger_history.get(seq) for v in net.validators}
        require(len(got) == 1 and None not in got,
                f"seq {seq}: the validators' validated hashes differ")
        h = got.pop().hex()
        digests = {accepted[(v.nid, seq)][1] for v in net.validators
                   if accepted.get((v.nid, seq), (None,))[0] == h}
        require(len(digests) == 1, f"seq {seq}: the closed results differ")
        hashes.append(h)
        results.append(digests.pop())
    out.update(
        net=net, hashes=hashes, results=results, base=base,
        counters={
            "rounds_completed": [v.node.rounds_completed for v in net.validators],
            "defense": [{k: n for k, n in v.node.defense.snapshot().items() if n}
                        for v in net.validators],
            "net_stats": dict(net.net_stats),
            "dispute_rechecks": rechecks[0],
            "frames": frames.hexdigest(),
        })
    return out


def consensus_phase(dev, name_power: str, int32_rate: float) -> dict:
    """BASELINE config #4 on the card: run_consensus on the port's SimNet
    (CONSENSUS_SIZES) with one VerifyPlane("cuda", routing="device",
    min_device_batch=1), prewarmed, and one WatchdogHasher over a
    CudaHasher serving all four validators: every submitted and relayed
    transaction, every proposal and every validation verified by K1
    (batch 1, and the relay burst's batch through prefetch_tx_sigs),
    every tx set and every validator's ledgers sealed by K2/K3. Checked:
    every validated hash, closed results digest, counter and the digest
    of every frame sent equal to the JAX package's (CONSENSUS_*); the bad
    copies, the burst's bad lane and the two forgeries rejected; device
    share 1.0 and no host signature check (the disputes accept()
    re-checks, none in the constants, go to the plane); one readback a
    tree; then every
    request the plane was given, in one batch, through K1's plain version
    on the card: the same verdict on every lane. The launch counts are
    this phase's alone."""
    import numpy as np

    from stellard_tpu_torch.crypto.backend import make_watched_hasher
    from stellard_tpu_torch.node.verifyplane import VerifyPlane
    from stellard_tpu_torch.ops import ed25519_cuda, treehash
    from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref
    from stellard_tpu_torch.protocol import keys
    from stellard_tpu_torch.protocol.ter import TER

    t0 = time.perf_counter()
    wl = consensus_workload(**CONSENSUS_SIZES)
    inputs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane = VerifyPlane(backend="cuda", routing="device", min_device_batch=1, max_batch=256,
                        backend_opts={"device": dev})
    plane.start_prewarm().join()
    require(plane.prewarm_error is None, f"the K1 prewarm failed: {plane.prewarm_error}")
    plane.device_sigs = plane.cpu_sigs = plane.verified = 0
    hasher = make_watched_hasher("cuda", routing="device", min_device_nodes=0, device=dev)
    cuda_hasher = hasher.inner
    prewarm_ms = (time.perf_counter() - t0) * 1e3
    record = []  # every request the plane was given, with its verdict

    def verify_many(reqs):
        out = plane.verify_many(reqs)
        record.append((list(reqs), np.asarray(out, bool).copy()))
        return out

    verified = {"LedgerProposal": 0, "STValidation": 0}

    def on_start(net):
        for v in net.validators:
            def counted(objs, _verify=v.node._verify):
                for o in objs:
                    verified[type(o).__name__] += 1
                return _verify(objs)
            v.node._verify = counted

    gc.collect()
    gc_clock = GcClock()
    ed25519_cuda.launches = 0
    ed25519_cuda.launches_by_batch.clear()
    treehash.reset_launches()
    keys.host_verifies = 0
    gc.callbacks.append(gc_clock)
    t_run = time.perf_counter()
    try:
        out = run_consensus(port_consensus_names(), wl, verify_many=verify_many,
                            hasher=hasher, on_start=on_start)
    finally:
        gc.callbacks.remove(gc_clock)
        plane.stop()
    phase_s = time.perf_counter() - t_run
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
    by_batch = dict(ed25519_cuda.launches_by_batch)
    by_thread = {k: dict(v) for k, v in treehash.launches_by_thread.items()}
    host_verifies = keys.host_verifies
    pj = plane.get_json()

    n_bad = sum(bad is not None for entries in wl["rounds"] for _g, bad in entries)
    want_burst = ["bad" if i == wl["bad_lane"] else "good" for i in range(len(wl["burst"]))]
    require(out["hashes"] == CONSENSUS_HASHES,
            f"validated hashes {out['hashes']} differ from the JAX package's")
    require(out["results"] == CONSENSUS_RESULTS, "closed results differ from the JAX package's")
    require(out["counters"] == CONSENSUS_COUNTERS,
            f"counters {out['counters']} differ from the JAX package's {CONSENSUS_COUNTERS}")
    require(out["bad_copy_ters"] == [int(TER.temINVALID)] * n_bad,
            f"bad copies answered {out['bad_copy_ters']}")
    require(out["burst_verdicts"] == [want_burst] * 4, "the relay burst's verdicts are wrong")
    require(pj["device_share"] == 1.0 and pj["cpu_sigs"] == 0,
            f"consensus device share {pj['device_share']}")
    require(not pj["device_wedged"] and not hasher.device_wedged, "a device plane wedged")
    require(host_verifies == 0,
            f"{host_verifies} host signature verifications on the consensus path")
    tt = cuda_hasher.tree_transfers
    require(tt.readbacks == cuda_hasher.tree_calls,
            f"readbacks {tt.readbacks} != tree calls {cuda_hasher.tree_calls}")
    require(launches["ed25519_verify"] == len(record),
            f"{launches['ed25519_verify']} K1 launches for {len(record)} plane calls")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the consensus phase")
    require(by_batch.get(CONSENSUS_SIZES["n_burst"], 0) == 4,
            "the relay burst was not verified in one K1 launch on each validator")

    # every request of the phase through K1's plain version on the card,
    # in one batch: the verdict the plane gave on every lane
    reqs = [r for rs, _v in record for r in rs]
    got = np.concatenate([v for _r, v in record])
    host = prepare_batch([r.public for r in reqs], [r.signing_hash for r in reqs],
                         [r.signature for r in reqs])
    tens = to_tensors(host, dev)
    plain = verify_kernel_ref(**tens).cpu().numpy().astype(bool)
    k1_err = int(np.abs(plain.astype(np.int64) - got.astype(np.int64)).max())
    require(k1_err == 0, "K1's verdicts in the consensus phase differ from its plain version")

    round_ms = sorted(out["round_ms"])
    n_pay = sum(len(e) for e in wl["rounds"])
    batch1 = by_batch.get(1, 0)
    emit("consensus", card=name_power, validators=4, quorum=3,
         rounds=len(round_ms), payments=n_pay, bad_copies=n_bad,
         burst=len(wl["burst"]), round_ms=out["round_ms"], submit_ms=out["submit_ms"],
         round_p50_ms=round_ms[len(round_ms) // 2],
         round_p90_ms=round_ms[min(len(round_ms) - 1, (len(round_ms) * 9) // 10)],
         payments_per_s=n_pay / sum(round_ms) * 1e3, phase_s=phase_s, inputs_s=inputs_s,
         prewarm_ms=prewarm_ms, collector_ms=gc_clock.ms, full_collections=gc_clock.full,
         validated_seqs=len(out["hashes"]) + 1, steps=out["steps"],
         hashes_equal_jax=True, counters=out["counters"],
         k1_launches_batch1=batch1, k1_launches_batched=launches["ed25519_verify"] - batch1,
         k1_launches_by_batch={str(k): v for k, v in sorted(by_batch.items())},
         k2_k3_by_role=launches_by_role(by_thread),
         proposals_verified=verified["LedgerProposal"],
         validations_verified=verified["STValidation"],
         lanes_held_to_plain=len(reqs), device_share=pj["device_share"],
         host_verifies=host_verifies, dispute_rechecks=out["counters"]["dispute_rechecks"],
         tree_calls=cuda_hasher.tree_calls, readbacks=tt.readbacks,
         device_nodes=cuda_hasher.device_nodes, host_nodes=cuda_hasher.host_nodes,
         verify_device_quantiles=pj["latency_histogram_ms"]["device_quantiles"])
    return {"launches": launches, "by_thread": by_thread, "k1_max_abs_err": k1_err}


# --------------------------------------------------------------------------
# the tcp phase: BASELINE config #4 as operators run it, a 4-validator
# private net over localhost TCP


# 4 rounds, each of 512 payments from the master account at validator
# 0's door and 256 from a second sender at validator 2's, submitted
# together (consensus_workload's shape, bench.py's ``_payments``)
TCP_SIZES = dict(n_rounds=4, per_round=512, per_relay=256, bad_share=0.01, seed=53)
TX_FEE = 10  # drops, every payment's fee
# the balances and sequences of the master account, the 16 destinations
# and the second sender after every good payment of TCP_SIZES, as the
# JAX package's node gives them (tests/test_torch_tcp_workload.py);
# which ledger a payment lands in does not move them
TCP_BALANCES_DIGEST = "3bb0b2a110af3dbb3b88ec929c9652b0861d1ad9c14a3b94d3ab50390f57a63e"
TCP_DIR = HERE / "build" / "chip_smoke_tcp"
# what the phase adds to testkit.tcpnet.validator_config's INI (beside
# type=cuda and clock speed 1, its arguments): admission caps that never
# bind, as in the close phase (the default soft cap of 256 a ledger would
# queue, then shed, part of a round's 768 payments)
TCP_INI_EXTRA = """
[txq]
min_cap=1000000
max_cap=1000000
"""
TCP_START_S = 300  # the children's start: torch, CUDA, the built kernels, K1's prewarm
TCP_ROUND_S = 180
TCP_SLOW_S = 40  # a wait this long prints the net's state (a `tcp_slow` line)
TCP_CHILDREN = (1, 2, 3)
# the fleet roles that join the net as children beside validators 1-3,
# each with its index among the phase's ports (after the validators')
TCP_FLEET = {"follower": 4, "archive": 5}
# the validator that deletes online and seals what it retires into
# history shards (a segstore node store in place of the memory one), and
# the archive's upstream
TCP_SEALER = 3
TCP_MEMORY_DB = "[node_db]\ntype=memory\n"
TCP_ARCHIVE_RESCAN_S = 5
TCP_ARCHIVE_WAIT_S = 60  # the archive's import, after the last round


def tcp_node_ini(name: str) -> str:
    """What every node of the tcp phase adds to its INI: its flight
    recorder's dumps in TCP_DIR."""
    return f"\n[health]\nflight_dir={TCP_DIR / ('flight-' + name)}\n"


def tcp_sealer_db(path: Path) -> str:
    """The sealing validator's node store: a segstore that deletes online
    (4 ledgers kept) and seals what it retires into history shards."""
    return f"[node_db]\ntype=segstore\npath={path}\nonline_delete=4\nshards=1\n"


def tcp_fleet_config(mode: str, keys, peer_ports, peer_port: int, rpc_port: int, ws_port: int,
                     upstream=None, backend: str = "cuda") -> str:
    """A follower's or an archive's INI on the tcp phase's net: the
    validators' UNL and quorum, [peer_ssl] require, a memory node store,
    both crypto sections ``type=backend``, clock speed 1, and no
    validation key. It dials every validator, or with ``upstream`` (a
    peer port) only that one ([node] upstream=). An archive's shards go
    to TCP_DIR, and it rescans its upstream's manifest every
    TCP_ARCHIVE_RESCAN_S."""
    unl = "\n".join(k.human_node_public for k in keys)
    if upstream is None:
        node = f"[node]\nmode={mode}\n\n[ips]\n" + "\n".join(
            f"127.0.0.1 {p}" for p in peer_ports)
    else:
        node = f"[node]\nmode={mode}\nupstream=127.0.0.1 {upstream}"
    archive = (f"\n[archive]\npath={TCP_DIR / 'archive-shards'}\n"
               f"rescan_s={TCP_ARCHIVE_RESCAN_S}\n" if mode == "archive" else "")
    return f"""
[standalone]
0

{TCP_MEMORY_DB}
[signature_backend]
type={backend}

[hash_backend]
type={backend}

[validators]
{unl}

[validation_quorum]
3

[peer_port]
{peer_port}

[peer_ssl]
require

{node}

[clock_speed]
1

[rpc_port]
{rpc_port}

[websocket_port]
{ws_port}
{archive}"""


def tcp_workload(n_rounds: int, per_round: int, per_relay: int, bad_share: float,
                 seed: int) -> dict:
    """Seeded inputs of the tcp phase, as bytes, in consensus_workload's
    shape: Payments of 250 STR to its 16 destinations, each account's
    sequences consecutive, the first payment to each destination
    creating it.

    - ``fund``: the master's sequence 1, funding the second sender with
      what its payments spend (the warm-up);
    - ``rounds``: per round, ``door``: per_round (blob, bad) pairs of the
      master's next sequences, ``bad`` None or, for a share ``bad_share``,
      a copy with one bit of the signature's R flipped, submitted just
      before the good one; ``relay``: per_relay payments of the second
      sender's next sequences; ``dest_drops``: each destination's
      balance once the round is validated;
    - ``accounts``: the master account, the destinations and the second
      sender, whose balances and sequences the phase holds to
      TCP_BALANCES_DIGEST.

    A close often cuts a round's burst of one account's sequences; the
    rest is re-applied to the next open ledger in sequence order.

    Signed with the port's protocol/keys.py; every flipped copy is bad by
    the RFC 8032 oracle."""
    import numpy as np

    from stellard_tpu_torch.protocol.keys import KeyPair

    rng = np.random.default_rng(seed)
    master = KeyPair.from_passphrase("masterpassphrase")
    sender = KeyPair.from_seed(rng.bytes(32))
    dests = [KeyPair.from_passphrase(f"bench-dest-{i}").account_id
             for i in range(CONSENSUS_DESTS)]
    # the second sender's spend, and the reserve with room
    need = n_rounds * per_relay * (PAYMENT_DROPS + TX_FEE) + 300 * 1_000_000
    fund = signed_payment(master, 1, sender.account_id, need).serialize()
    rounds, seq, sender_seq = [], 2, 1
    received = [0] * CONSENSUS_DESTS
    for _ in range(n_rounds):
        door = []
        for _p in range(per_round):
            d = (seq - 2) % CONSENSUS_DESTS
            good = signed_payment(master, seq, dests[d], PAYMENT_DROPS).serialize()
            bad = flipped_blob(master, signed_payment(master, seq, dests[d], PAYMENT_DROPS),
                               rng) if rng.random() < bad_share else None
            door.append((good, bad))
            received[d] += 1
            seq += 1
        relay = []
        for _p in range(per_relay):
            d = sender_seq % CONSENSUS_DESTS
            relay.append(signed_payment(sender, sender_seq, dests[d], PAYMENT_DROPS).serialize())
            received[d] += 1
            sender_seq += 1
        rounds.append({"door": door, "relay": relay, "dest_drops": dict(zip(
            dests, (n * PAYMENT_DROPS for n in received)))})
    return {"fund": fund, "sender": sender.account_id, "rounds": rounds,
            "accounts": [master.account_id, *dests, sender.account_id]}


def balances_digest(rows) -> str:
    """SHA-256 over (account id, balance in drops, sequence) rows, in the
    order given."""
    h = hashlib.sha256()
    for account, balance, sequence in rows:
        h.update(account + int(balance).to_bytes(8, "big") + int(sequence).to_bytes(4, "big"))
    return h.hexdigest()


def tcp_account(rpc, account):
    """An account's root in a validator's last validated ledger (its
    `account_info` door), None while the ledger holds none."""
    from stellard_tpu_torch.protocol.keys import encode_account_id

    info = rpc.call("account_info", account=encode_account_id(account),
                    ledger_index="validated")
    require("account_data" in info or info.get("error") == "actNotFound",
            f"account_info answered {info}")
    return info.get("account_data")


def tcp_balances(rpc, accounts) -> list:
    """(account id, balance, sequence) of each account in a validator's
    last validated ledger; (0, 0) for an account it does not hold."""
    rows = []
    for account in accounts:
        data = tcp_account(rpc, account) or {}
        rows.append((account, int(data.get("Balance", 0)), int(data.get("Sequence", 0))))
    return rows


class TcpNet:
    """Validators 1-3 of the tcp phase and its follower and archive:
    ``python -m stellard_tpu_torch --conf <ini> --start`` children, each
    logging to TCP_DIR; ``check`` fails the smoke, with the tail of every
    log, once one has exited."""

    def __init__(self, inis: dict):
        from stellard_tpu_torch.testkit import tcpnet

        self.logs = {k: TCP_DIR / f"{tcp_name(k)}.log" for k in inis}
        self.printed = False
        self.procs = {k: tcpnet.spawn_validator(str(ini), stdout=self.logs[k].open("w"))
                      for k, ini in inis.items()}

    def tails(self) -> str:
        return "\n".join(f"--- {tcp_name(k)} ---\n{log.read_text()[-3000:]}"
                         for k, log in self.logs.items())

    def print_tails(self) -> None:
        """Print every child's log tail, once (the phase clears the logs'
        directory at its next start)."""
        if not self.printed:
            self.printed = True
            print(self.tails(), flush=True)

    def check(self) -> None:
        dead = {tcp_name(k): p.poll() for k, p in self.procs.items() if p.poll() is not None}
        if dead:
            self.print_tails()
            raise SmokeFailure(f"tcp children exited: {dead}")

    def stop(self) -> dict:
        """SIGTERM each child (the node drains and stops), SIGKILL one
        that has not ended in 60 s; returns their exit codes."""
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        codes = {}
        for i, p in self.procs.items():
            try:
                codes[i] = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                codes[i] = p.wait()
        return codes


def tcp_name(key) -> str:
    """A tcp phase node's name: ``validator-<i>``, ``follower``, ``archive``."""
    return key if isinstance(key, str) else f"validator-{key}"


class LedgerSink:
    """A local HTTP listener for a node's ``subscribe`` with ``url=``
    (its RpcSub POSTs each event as a JSON-RPC ``event`` request): keeps
    every event it is sent, in arrival order."""

    def __init__(self):
        import http.server

        events = self.events = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", "0"))))
                events.append(body["params"][0])
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, name="rpcsub-sink",
                         daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_port}/"

    def ledgers(self) -> list:
        return [e for e in self.events if e.get("type") == "ledgerClosed"]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def fleet_planes(name: str, counts: dict, counts0: dict) -> dict:
    """A follower's or an archive's planes over the rounds, from its
    get_counts before (``counts0``) and after them: no host signature
    check but the hellos', no signature on the host side of its plane,
    and the K1/K2 launches and arrival-hash batches of the rounds."""
    vp, hv = counts["verify_plane"], counts["host_verifies"]
    require(vp["cpu_sigs"] == 0 and hv["total"] == hv["handshakes"],
            f"the {name} checked signatures on the host: {vp['cpu_sigs']} plane, "
            f"{hv['total']} in all, {hv['handshakes']} handshakes")
    k, k0 = counts["kernels"], counts0["kernels"]
    acq, acq0 = counts["acquisition"], counts0["acquisition"]
    return {"device_share": vp["device_share"], "device_batches": vp["device_batches"],
            "verified": vp["verified"], "host_verifies": hv,
            "k1_launches": k["ed25519_verify"] - k0["ed25519_verify"],
            "k2_launches": k["sha512_masked"] - k0["sha512_masked"],
            "k3_launches": k["tree_inner_level"] - k0["tree_inner_level"],
            "arrival_hash_batches": acq["hash_batches"] - acq0["hash_batches"],
            "arrival_hashed_nodes": acq["hashed_nodes"] - acq0["hashed_nodes"],
            "peers": counts.get("peers")}


def health_report(who: str, answer: dict) -> dict:
    """A node's `health` answer, reported (its status is not gated): the
    watchdog must have evaluated at least one snapshot, and every flight
    dump the node wrote must parse as JSON."""
    h, flight = answer["health"], answer["flight"]
    require(answer["enabled"] and h["evaluations"] >= 1,
            f"{who}'s health watchdog evaluated no snapshot: {h}")
    reasons = []
    for path in flight["dumps"]:
        with open(path, encoding="utf-8") as f:
            dump = json.load(f)
        require(bool(dump.get("reason")) and "spans" in dump, f"{who}'s flight dump {path}")
        reasons.append(dump["reason"])
    out = {"node": who, "status": h["status"], "reasons": h["reasons"],
           "transitions": h["transitions"], "evaluations": h["evaluations"],
           "ewma_close_gap_s": h["ewma_close_gap_s"], "closed_seq": h["closed_seq"],
           "validated_seq": h["validated_seq"], "dumps": len(flight["dumps"]),
           "dump_reasons": reasons}
    emit("health", **out)
    return out


class ValidatedView:
    """What each validator has validated, read through its doors."""

    def __init__(self, rpcs: dict):
        self.rpcs = rpcs
        self.funded = {i: set() for i in rpcs}
        self.top = dict.fromkeys(rpcs, 0)

    def tip(self, i) -> tuple:
        """(seq, hash) of validator i's last validated ledger."""
        v = self.rpcs[i].call("server_info")["info"].get("validated_ledger", {})
        self.top[i] = v.get("seq", 0)
        return self.top[i], v.get("hash")

    def funded_all(self, accounts) -> bool:
        """Whether every one of ``accounts`` exists in every validator's
        last validated ledger (each validator asked from the first
        account not yet seen there)."""
        for i, rpc in self.rpcs.items():
            for account in accounts:
                if account in self.funded[i]:
                    continue
                if tcp_account(rpc, account) is None:
                    return False
                self.funded[i].add(account)
        return True

    def balances_are(self, want: dict) -> bool:
        """Whether every validator's last validated ledger holds each
        account of ``want`` at its balance in drops."""
        for rpc in self.rpcs.values():
            for account, drops in want.items():
                data = tcp_account(rpc, account)
                if data is None or int(data["Balance"]) != drops:
                    return False
        return True

    def ledger_hash(self, i, seq: int):
        """Validator i's hash at ``seq``, None where it holds no such
        ledger (a catch-up adopts the tip, not every ledger before it)."""
        answer = self.rpcs[i].call("ledger", ledger_index=seq)
        return answer["ledger"]["hash"] if "ledger" in answer else None


def tcp_phase(dev, name_power: str, int32_rate: float) -> dict:
    """BASELINE config #4 as operators run it: four validators over
    localhost TCP on one card, each from testkit.tcpnet.validator_config's
    INI (quorum 3, UNL and [ips] of the other three, [peer_ssl] require,
    a memory node store) with type=cuda planes, clock speed 1 and
    TCP_INI_EXTRA. Validator 0 is a Node in this process (its K1, K2 and
    K3 launches counted here, every K1 request it makes recorded);
    validators 1-3 are `python -m stellard_tpu_torch --start` children,
    spawned first (validator 0 starts once their doors answer, so the
    four begin their rounds together). The warm-up funds tcp_workload's
    second sender at validator 0's HTTP `submit`; then each round submits
    the master account's payments at validator 0 (a bad copy before ~1% of them,
    which the door refuses) and the second sender's at validator 2, from
    two client threads at once — the second sender's payments reach
    validators 0, 1 and 3 as relayed TCP frames, verified a socket read
    at a time — until all four have validated all of them.

    Checked: the same validated hash on all four at every seq from 2;
    every good payment validated tesSUCCESS, read through `tx` on the
    children that keep their history; every bad copy answered temINVALID at the door, never
    relayed by validator 0 and never found; the balances and sequences of
    every account the same on all four and equal to the JAX package's
    (TCP_BALANCES_DIGEST); device share 1.0 and no host signature check
    but the hellos' session signatures on every validator (the disputes
    accept() re-checks go to the plane in one batch); on validator 0 one
    readback a tree, no error absorbed by the close, K1, K2 and K3
    launched, and every K1
    request it made through K1's plain version on the card: the same
    verdict on every lane. A child that exits, or a net that does not
    form or validate in time, fails the smoke.

    The fleet roles join the net: validator 3 deletes online into
    history shards (tcp_sealer_db), a follower and an archive are two
    more children (tcp_fleet_config); the follower's ledgers, balances,
    planes and RpcSub, and the archive's import of validator 3's shards
    and its deep ledgers, are checked, and the health watchdogs of
    validator 0 and the follower reported (health_report)."""
    import http.client

    import numpy as np

    from stellard_tpu_torch.consensus.consensus import LedgerConsensus
    from stellard_tpu_torch.node.config import Config
    from stellard_tpu_torch.node.node import Node
    from stellard_tpu_torch.ops import ed25519_cuda, treehash
    from stellard_tpu_torch.ops.ed25519 import prepare_batch, to_tensors, verify_kernel_ref
    from stellard_tpu_torch.protocol import keys
    from stellard_tpu_torch.protocol.keys import KeyPair
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction
    from stellard_tpu_torch.protocol.ter import TER
    from stellard_tpu_torch.testkit import tcpnet

    t_phase = time.perf_counter()
    wl = tcp_workload(**TCP_SIZES)
    inputs_s = time.perf_counter() - t_phase
    shutil.rmtree(TCP_DIR, ignore_errors=True)
    TCP_DIR.mkdir(parents=True)
    ports = tcpnet.free_ports(18)
    peer_ports, rpc_ports, ws_ports = ports[:6], ports[6:12], ports[12:]
    vkeys = [KeyPair.from_passphrase(f"tcp-val-{i}") for i in range(4)]
    inis = {}
    for i in range(4):
        text = tcpnet.validator_config(
            i, vkeys, peer_ports[:4], rpc_ports[i], ws_ports[i], quorum=3, speed=1.0,
            backend="cuda") + TCP_INI_EXTRA + tcp_node_ini(tcp_name(i))
        if i == TCP_SEALER:
            require(TCP_MEMORY_DB in text, "the private-net INI's node store")
            text = text.replace(TCP_MEMORY_DB, tcp_sealer_db(TCP_DIR / f"validator-{i}-ns"))
        inis[i] = TCP_DIR / f"validator-{i}.cfg"
        inis[i].write_text(text)
    for name, k in TCP_FLEET.items():
        inis[name] = TCP_DIR / f"{name}.cfg"
        inis[name].write_text(tcp_fleet_config(
            name, vkeys, peer_ports[:4], peer_ports[k], rpc_ports[k], ws_ports[k],
            upstream=peer_ports[TCP_SEALER] if name == "archive" else None)
            + TCP_INI_EXTRA + tcp_node_ini(name))
    parse = SerializedTransaction.from_bytes

    t0 = time.perf_counter()
    net = TcpNet({k: inis[k] for k in (*TCP_CHILDREN, *TCP_FLEET)})
    node = None
    rpcs: dict = {}
    fleet: dict = {}
    sink = LedgerSink()
    run_errors: list = []
    try:
        # validator 0 starts once every child's door answers (a node opens
        # its doors after K1's prewarm), so the four validators begin their
        # rounds together: two that join late take the first ledgers by
        # switching, and the net then waits for a quorum (ROADMAP Queue C)
        children_up = time.monotonic() + TCP_START_S
        for k in (*TCP_CHILDREN, *TCP_FLEET):
            port = rpc_ports[TCP_FLEET.get(k, k)]
            while True:
                net.check()
                try:
                    tcpnet.rpc(port, "server_info", timeout=10)
                    break
                except (OSError, ValueError):
                    if time.monotonic() > children_up:
                        print(net.tails(), flush=True)
                        raise SmokeFailure(f"tcp phase: {tcp_name(k)} did not start within "
                                           f"{TCP_START_S} s") from None
                    time.sleep(0.5)
        children_s = time.perf_counter() - t0
        node = Node(Config.from_ini(inis[0].read_text())).setup().serve()
        v0_start_s = time.perf_counter() - t0
        plane, overlay = node.verify_plane, node.overlay
        record = []  # every request validator 0 gave its plane, with the verdicts
        plane_verify = plane.verify_many

        def verify_many(reqs):
            out = plane_verify(reqs)
            if len(reqs):
                record.append((list(reqs), np.asarray(out, bool).copy()))
            return out

        plane.verify_many = verify_many  # the door's plane checks
        overlay.node.verify_many = verify_many  # relayed txs, proposals, validations
        relayed = set()  # txids validator 0 relayed from its door
        broadcast = overlay.broadcast_tx

        def broadcast_tx(tx, except_ids=None):
            relayed.add(tx.txid())
            return broadcast(tx, except_ids)

        node.ops.relay_tx = broadcast_tx

        def run_node():
            try:
                node.run()
            except BaseException as exc:  # noqa: BLE001 — the phase raises it
                run_errors.append(exc)

        threading.Thread(target=run_node, name="tcp-validator-0", daemon=True).start()
        rpcs.update({i: HttpRpc(rpc_ports[i], timeout=120) for i in range(4)})
        fleet.update({name: HttpRpc(rpc_ports[k], timeout=120) for name, k in TCP_FLEET.items()})
        seen = ValidatedView(rpcs)
        answers, bad_ters = [], []  # the doors' engine_result for each submit

        def alive() -> None:
            net.check()
            require(not run_errors, f"validator 0 failed: {run_errors!r}")
            require(overlay.device_error is None,
                    f"the card failed under validator 0's overlay: {overlay.device_error!r}")

        def wait(pred, timeout: float, what: str) -> None:
            t_wait = time.monotonic()
            deadline, slow = t_wait + timeout, t_wait + TCP_SLOW_S
            while True:
                alive()
                try:
                    if pred():
                        return
                    if slow is not None and time.monotonic() > slow:
                        # a wait this long is a stall of the net: its
                        # state, once, for the report
                        slow = None
                        for i in rpcs:
                            seen.tip(i)
                        emit("tcp_slow", waiting_for=what, after_s=time.monotonic() - t_wait,
                             **tcp_diagnostics())
                except (OSError, http.client.HTTPException):
                    # a door not up yet: new connections
                    for i in range(4):
                        rpcs[i].close()
                        rpcs[i] = HttpRpc(rpc_ports[i], timeout=120)
                    for name, k in TCP_FLEET.items():
                        fleet[name].close()
                        fleet[name] = HttpRpc(rpc_ports[k], timeout=120)
                if time.monotonic() > deadline:
                    print(net.tails(), flush=True)
                    emit("tcp_stalled", **tcp_diagnostics())
                    got = {t: answers.count(t) for t in set(answers)}
                    raise SmokeFailure(f"tcp phase: no {what} within {timeout} s; validated "
                                       f"seqs {seen.top}, submits answered {got}")
                time.sleep(0.05)

        def tcp_diagnostics() -> dict:
            """Each validator's overlay, admission and consensus state,
            and the first seq whose validated hashes differ, for a
            failure's report."""
            out = {}
            for i in range(4):
                try:
                    c = rpcs[i].call("get_counts")
                    ci = rpcs[i].call("consensus_info")
                    out[str(i)] = {
                        "peers": c.get("peers"),
                        "squelch": {k: v for k, v in c.get("squelch", {}).items()
                                    if not isinstance(v, dict)},
                        "resource": {k: v for k, v in c.get("resource", {}).get(
                            "peers", {}).items() if k != "entries"},
                        "txq": {k: v for k, v in c.get("txq", {}).items()
                                if isinstance(v, int)},
                        "byzantine": {k: v for k, v in c.get("byzantine", {}).items() if v},
                        "consensus": {k: v for k, v in ci.get("info", ci).items()
                                      if k not in ("peer_positions", "disputes")},
                        "validated_top": seen.top.get(i)}
                except (OSError, KeyError, ValueError) as exc:
                    out[str(i)] = repr(exc)
            for name in TCP_FLEET:
                try:
                    c = fleet[name].call("get_counts")
                    out[name] = {"peers": c.get("peers"), "follower": c.get("follower"),
                                 "archive": c.get("archive"),
                                 "shards": c.get("history_shards")}
                except (OSError, KeyError, ValueError) as exc:
                    out[name] = repr(exc)
            return out

        def submit_all(port: int, entries, out: list, bad_out: list) -> None:
            """Submit (good, bad) pairs in order at the door on ``port``
            (the bad copy first), keeping the answers."""
            client = HttpRpc(port, timeout=120)
            try:
                for good, bad in entries:
                    if bad is not None:
                        bad_out.append(client.call("submit", tx_blob=bad.hex())
                                       .get("engine_result"))
                    out.append(client.call("submit", tx_blob=good.hex()).get("engine_result"))
            finally:
                client.close()

        # the net forms: every validator has its three validator peers
        # (and the follower or the archive beside them), the follower
        # dials the four, the archive its upstream
        wait(lambda: overlay.peer_count() >= 3 and all(
            rpcs[i].call("server_info")["info"]["peers"] >= 3 for i in TCP_CHILDREN)
            and fleet["follower"].call("server_info")["info"]["peers"] == 4
            and fleet["archive"].call("server_info")["info"]["peers"] == 1,
            TCP_START_S, "net of four validators, a follower and an archive")
        join_s = time.perf_counter() - t0
        # an RpcSub on the follower: its `ledger` stream pushed to the sink
        sub = fleet["follower"].call("subscribe", url=sink.url, streams=["ledger"])
        require(sub.get("status") == "success", f"the follower's url subscribe: {sub}")
        fleet0 = {name: c.call("get_counts") for name, c in fleet.items()}

        gc.collect()
        gc_clock = GcClock()
        ed25519_cuda.launches = 0
        ed25519_cuda.launches_by_batch.clear()
        treehash.reset_launches()
        keys.host_verifies = 0
        handshakes0 = overlay.handshake_verifies
        calls0 = len(record)
        rechecks = [0]
        round_ms, submit_ms = [], []
        gc.callbacks.append(gc_clock)
        t_run = time.perf_counter()
        try:
            with counting_dispute_rechecks(LedgerConsensus, rechecks):
                # the warm-up: the second sender funded, validated on all four
                submit_all(rpc_ports[0], [(wl["fund"], None)], answers, bad_ters)
                wait(lambda: seen.funded_all([wl["sender"]]), TCP_ROUND_S,
                     "the second sender's funding validated")
                warmup_s = time.perf_counter() - t_run
                for r_i, rnd in enumerate(wl["rounds"]):
                    t_round = time.perf_counter()
                    threads = [
                        threading.Thread(target=submit_all, name="tcp-client-0", args=(
                            rpc_ports[0], rnd["door"], answers, bad_ters)),
                        threading.Thread(target=submit_all, name="tcp-client-2", args=(
                            rpc_ports[2], [(b, None) for b in rnd["relay"]], answers, [])),
                    ]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    submit_ms.append((time.perf_counter() - t_round) * 1e3)
                    wait(lambda: seen.balances_are(rnd["dest_drops"]), TCP_ROUND_S,
                         f"round {r_i} validated")
                    round_ms.append((time.perf_counter() - t_round) * 1e3)
        finally:
            gc.callbacks.remove(gc_clock)
        run_s = time.perf_counter() - t_run
        launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
        by_batch = dict(ed25519_cuda.launches_by_batch)
        by_thread = {k: dict(v) for k, v in treehash.launches_by_thread.items()}
        host_verifies = keys.host_verifies
        handshakes = overlay.handshake_verifies - handshakes0

        # the archive imports every shard the sealing validator sealed by
        # the end of the rounds, within TCP_ARCHIVE_WAIT_S of the last one
        t_last = time.perf_counter()
        sealed = rpcs[TCP_SEALER].call("get_counts").get("history_shards")
        require(sealed is not None and sealed["shards"] > 0,
                f"validator {TCP_SEALER} sealed no history shard by the end of the rounds: "
                f"{sealed}")
        sealed_lo, sealed_hi = sealed["range"]

        def archived() -> bool:
            # a validator's stored history has a gap where it adopted a tip
            # without the ledgers before it, and so do its shards: every
            # shard, its range and its contiguous floor
            hs = fleet["archive"].call("get_counts").get("history_shards") or {}
            return (hs.get("shards", 0) >= sealed["shards"] and bool(hs.get("range"))
                    and hs["range"][0] <= sealed_lo and hs["range"][1] >= sealed_hi
                    and hs["contiguous_floor"] >= sealed["contiguous_floor"])

        wait(archived, TCP_ARCHIVE_WAIT_S, f"the archive's import of validator "
             f"{TCP_SEALER}'s shards {sealed_lo}-{sealed_hi}")
        archive_wait_s = time.perf_counter() - t_last

        # the same validated tip on all four, and every validated hash
        # from seq 2 the same on every validator that holds that ledger
        wait(lambda: len({seen.tip(i) for i in rpcs}) == 1, TCP_ROUND_S,
             "common validated tip")
        common, _tip_hash = seen.tip(0)
        not_held = 0
        val_hash = {}  # seq -> the validated hash, validator 0's where it holds it
        for seq in range(2, common + 1):
            got = [seen.ledger_hash(i, seq) for i in rpcs]
            not_held += got.count(None)
            held = set(got) - {None}
            require(len(held) == 1, f"seq {seq}: the validators' validated hashes differ: {got}")
            val_hash[seq] = (got[0] or held.pop()).lower()
        # every good payment validated tesSUCCESS, read through `tx` on
        # validators 1 and 2 (each half of them, at once: the sealing
        # validator deletes its older history), every bad copy on 1-3
        good_ids = [parse(wl["fund"]).txid()] + [
            parse(b).txid() for rnd in wl["rounds"]
            for b in [g for g, _b in rnd["door"]] + rnd["relay"]]
        bad_ids = [parse(b).txid() for rnd in wl["rounds"] for _g, b in rnd["door"]
                   if b is not None]
        found: dict = {}

        def read_txs(i, ids):
            client = HttpRpc(rpc_ports[i], timeout=120)
            try:
                for txid in ids:
                    res = client.call("tx", transaction=txid.hex().upper())
                    found[txid] = (res.get("validated"),
                                   res.get("meta", {}).get("TransactionResult"),
                                   res.get("error"))  # the result's code
            finally:
                client.close()

        t_read = time.perf_counter()
        keep = [i for i in TCP_CHILDREN if i != TCP_SEALER]
        readers = [threading.Thread(target=read_txs, args=(i, good_ids[k::len(keep)] + bad_ids))
                   for k, i in enumerate(keep)]
        readers.append(threading.Thread(target=read_txs, args=(TCP_SEALER, bad_ids)))
        for t in readers:
            t.start()
        for t in readers:
            t.join()
        not_success = [t.hex() for t in good_ids
                       if found.get(t, (None, None))[:2] != (True, int(TER.tesSUCCESS))]
        require(not not_success, f"{len(not_success)} good payments not validated "
                                 f"tesSUCCESS, e.g. {not_success[:3]}")
        require(all(found[t][2] == "txnNotFound" for t in bad_ids), "a child knows a bad copy")
        require(not (set(bad_ids) & relayed), "validator 0 relayed a bad copy")
        require(bad_ters == ["temINVALID"] * len(bad_ids), f"bad copies answered {bad_ters}")
        counts = {t: answers.count(t) for t in set(answers)}
        require(counts == {"tesSUCCESS": len(good_ids)}, f"good submits answered {counts}")
        # the balances and sequences, the same everywhere and the JAX package's
        digests = [None] * 4

        def read_balances(i):
            client = HttpRpc(rpc_ports[i], timeout=120)
            try:
                digests[i] = balances_digest(tcp_balances(client, wl["accounts"]))
            finally:
                client.close()

        readers = [threading.Thread(target=read_balances, args=(i,)) for i in range(4)]
        for t in readers:
            t.start()
        for t in readers:
            t.join()
        read_s = time.perf_counter() - t_read
        require(len(set(digests)) == 1, f"the validators' balances differ: {digests}")
        require(digests[0] == TCP_BALANCES_DIGEST,
                f"balances digest {digests[0]} differs from the JAX package's")
        # device share on every validator; each child's planes
        children = {}
        for i in TCP_CHILDREN:
            c = rpcs[i].call("get_counts")
            vp = c["verify_plane"]
            require(vp["device_share"] == 1.0 and vp["cpu_sigs"] == 0,
                    f"validator {i}'s device share {vp['device_share']}")
            hv = c["host_verifies"]
            require(hv["total"] == hv["handshakes"],
                    f"validator {i}: {hv['total']} host signature checks, "
                    f"{hv['handshakes']} handshakes")
            children[str(i)] = {
                "verify_plane": {k: vp.get(k) for k in (
                    "batches", "verified", "device_batches", "device_sigs", "cpu_sigs",
                    "device_share", "device_wedged")},
                "hasher": {k: v for k, v in c["crypto"]["hash"].items()
                           if isinstance(v, (int, float, str))},
                "host_verifies": c.get("host_verifies"), "peers": c.get("peers")}
        pj = plane.get_json()
        require(pj["device_share"] == 1.0 and pj["cpu_sigs"] == 0,
                f"validator 0's device share {pj['device_share']}")
        require(not pj["device_wedged"] and not node.hasher.device_wedged,
                "a device plane of validator 0 wedged")
        require(host_verifies == handshakes,
                f"validator 0: {host_verifies} host signature checks, {handshakes} "
                f"handshakes")
        cuda_hasher = node.hasher.inner
        tt = cuda_hasher.tree_transfers
        require(tt.readbacks == cuda_hasher.tree_calls,
                f"validator 0: readbacks {tt.readbacks} != tree calls {cuda_hasher.tree_calls}")
        require(launches["ed25519_verify"] > 0 and launches["sha512_masked"] > 0
                and launches["tree_inner_level"] > 0,
                "K1, K2 or K3 never launched on validator 0 in the tcp phase")
        tree = node.ledger_master.tree_json()
        absorbed = {k: tree.get(k, 0) for k in ABSORBED}
        require(not any(absorbed.values()), f"validator 0's close absorbed errors: {absorbed}")

        # the follower: at the common tip, every ledger it adopted is the
        # validators', its balances the JAX package's, its planes on the card
        fc = fleet["follower"]
        wait(lambda: fc.call("server_info")["info"].get("validated_ledger", {}).get(
            "seq", 0) >= common, TCP_ROUND_S, "the follower at the common tip")
        adopted = 0
        for seq in range(2, common + 1):
            answer = fc.call("ledger", ledger_index=seq)
            if "ledger" in answer:
                require(answer["ledger"]["hash"].lower() == val_hash[seq],
                        f"the follower's ledger {seq} is not the validators'")
                adopted += 1
        require(adopted > 0, "the follower adopted no validated ledger")
        follower_digest = balances_digest(tcp_balances(fc, wl["accounts"]))
        require(follower_digest == TCP_BALANCES_DIGEST,
                f"the follower's balances digest {follower_digest} differs from the JAX "
                f"package's")
        follower = fleet_planes("follower", fc.call("get_counts"), fleet0["follower"])
        require(follower["device_share"] == 1.0, f"the follower's device share {follower}")
        require(follower["k1_launches"] > 0 and follower["arrival_hash_batches"] > 0
                and follower["k2_launches"] > 0,
                f"the follower launched no K1 or arrival-hash K2 in the rounds: {follower}")
        follower.update(adopted=adopted, balances_digest=follower_digest)

        # its RpcSub: every ledgerClosed to the tip, in seq order, no gap,
        # the validators' hashes, no event dropped
        wait(lambda: any(e["ledger_index"] >= common for e in sink.ledgers()), TCP_ROUND_S,
             "the follower's RpcSub at the common tip")
        pushed = sink.ledgers()
        seqs = [e["ledger_index"] for e in pushed]
        require(seqs == list(range(seqs[0], seqs[0] + len(seqs))),
                f"the follower's RpcSub pushed ledgers out of order or with a gap: {seqs}")
        require([e["seq"] for e in sink.events] == list(range(1, len(sink.events) + 1)),
                "the follower's RpcSub dropped an event")
        for e in pushed:
            if e["ledger_index"] in val_hash:
                require(e["ledger_hash"].lower() == val_hash[e["ledger_index"]],
                        f"the follower pushed ledger {e['ledger_index']} with another hash")
        rpcsub = {"events": len(sink.events), "ledgers": len(pushed), "first": seqs[0],
                  "last": seqs[-1], "checked": sum(q in val_hash for q in seqs)}

        # the archive: no peer condemned, a verified floor, and its ledgers
        # below the floor the validators'
        ac = fleet["archive"].call("get_counts")
        backfill, shards = ac["archive"]["backfill"], ac["history_shards"]
        require(backfill["garbage_peers"] == 0 and backfill["import_rejects"] == 0,
                f"the archive condemned a peer: {backfill}")
        floor = shards["contiguous_floor"]
        require(floor > 0, f"the archive's verified floor is {floor}")
        # every ledger it answers in the sealed range is the validators',
        # and it answers every one at or below its floor
        deep = []
        for seq in range(max(2, sealed_lo), sealed_hi + 1):
            answer = fleet["archive"].call("ledger", ledger_index=seq)
            if seq <= floor or "ledger" in answer:
                require(answer.get("ledger", {}).get("hash", "").lower() == val_hash[seq],
                        f"the archive's ledger {seq} (floor {floor}): {answer}")
                deep.append(seq)
        require(any(q <= floor for q in deep), f"no ledger at or below the archive's floor "
                                               f"{floor} to read")
        archive = fleet_planes("archive", ac, fleet0["archive"])
        archive.update(
            sealed_by_validator=sealed, imported=backfill["imported"],
            duplicates=backfill["duplicates"], bytes=backfill["bytes"],
            requests=backfill["requests"], contiguous_floor=floor,
            deep_ledgers_checked=len(deep), import_wait_s=archive_wait_s,
            ledgers_ingested=ac["follower"]["ledgers_ingested"])

        # health, reported: validator 0 and the follower
        health = [health_report("validator-0", rpcs[0].call("health")),
                  health_report("follower", fc.call("health"))]
    except BaseException:
        # any failed check: the children's logs, while they still run
        net.print_tails()
        raise
    finally:
        try:
            for client in [*rpcs.values(), *fleet.values()]:
                client.close()
            sink.close()
            if node is not None:
                node.stop()
        finally:
            codes = net.stop()
    if run_errors or any(c != 0 for c in codes.values()):
        net.print_tails()
    require(not run_errors, f"validator 0 failed: {run_errors!r}")
    require(all(c == 0 for c in codes.values()), f"tcp children exited {codes}")
    # one K1 launch a plane call, counted once validator 0 has stopped:
    # the net goes on validating while the checks above read it
    require(ed25519_cuda.launches == len(record) - calls0,
            f"{ed25519_cuda.launches} K1 launches for {len(record) - calls0} plane calls")

    # every request validator 0 gave its plane, through K1's plain version
    # on the card in one batch: the verdict the plane gave on every lane
    reqs = [q for rs, _v in record for q in rs]
    got = np.concatenate([v for _r, v in record])
    host = prepare_batch([q.public for q in reqs], [q.signing_hash for q in reqs],
                         [q.signature for q in reqs])
    plain = verify_kernel_ref(**to_tensors(host, dev)).cpu().numpy().astype(bool)
    k1_err = int(np.abs(plain.astype(np.int64) - got.astype(np.int64)).max())
    require(k1_err == 0, "K1's verdicts on validator 0 differ from its plain version")

    n_door = sum(len(rnd["door"]) for rnd in wl["rounds"])
    n_relay = sum(len(rnd["relay"]) for rnd in wl["rounds"])
    ordered = sorted(round_ms)
    emit("tcp", card=name_power, validators=4, quorum=3, peer_ssl="require",
         rounds=len(round_ms), payments=n_door + n_relay, door_payments=n_door,
         relayed_payments=n_relay, bad_copies=len(bad_ids), senders=2,
         round_ms=round_ms, submit_ms=submit_ms, round_p50_ms=ordered[len(ordered) // 2],
         round_p90_ms=ordered[min(len(ordered) - 1, (len(ordered) * 9) // 10)],
         payments_per_s=(n_door + n_relay) / sum(round_ms) * 1e3,
         phase_s=time.perf_counter() - t_phase, inputs_s=inputs_s,
         children_start_s=children_s, validator0_start_s=v0_start_s, join_s=join_s,
         warmup_s=warmup_s, run_s=run_s,
         read_back_s=read_s, collector_ms=gc_clock.ms, full_collections=gc_clock.full,
         validated_seqs=common - 1, ledgers_not_held=not_held, hashes_equal=True,
         balances_digest=digests[0],
         k1_launches_by_batch={str(k): v for k, v in sorted(by_batch.items())},
         k1_launches=launches["ed25519_verify"], k2_launches=launches["sha512_masked"],
         k3_launches=launches["tree_inner_level"], k2_k3_by_role=launches_by_role(by_thread),
         lanes_held_to_plain=len(reqs), device_share=pj["device_share"],
         host_verifies=host_verifies, handshake_verifies=handshakes,
         dispute_rechecks=rechecks[0], tree_calls=cuda_hasher.tree_calls,
         readbacks=tt.readbacks, verify_device_quantiles=pj["latency_histogram_ms"][
             "device_quantiles"], children=children, child_exit_codes=codes,
         follower=follower, archive=archive, rpcsub=rpcsub, health=health,
         sealed_shards=sealed)
    shutil.rmtree(TCP_DIR, ignore_errors=True)
    return {"launches": launches, "by_thread": by_thread, "k1_max_abs_err": k1_err}


# the read RPCs after the close phase (read_back): the seed that picks
# their accounts and transactions, and the digest of each kind of answer
# as the JAX package's node gives it on the same blobs (the same slow test)
READ_SEED = 23
READ_DIGESTS = {
    "account_info": "34febc30d3ad796ae7a80f7f3b797fb2774e6f045b0bed24ad205a653344db62",
    "tx": "d4c61aff023ed2b21876ef9955af1a251de75c8660cc146b5e95915e913aad03",
    "account_tx": "02149f1e49889ee558312c066d93b48870c71cc487eb8c6bc4ce65c7cf10c873",
}


# the book phase's sizes (BASELINE configs #2 and #3 on the close phase's
# chain), and the path plane's prune floor for both packages: the
# JAX node's `[paths] prune_floor` knob (its default is 64, and no search
# of this graph reaches 64 candidates; see PERF.md)
BOOK_SIZES = dict(n_gateways=16, n_traders=2048, n_regular=1024, per_close=4096,
                  n_merges=16, n_requests=32, seed=31)
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
PATHS_DIGEST = "9552a096365238c439e6175295c0b4b03a5168ff60dc9226cd766beb97066536"

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
# what one close through the node's doors records of itself (the close
# line): the submits' wall, the verify plane's and the open apply's ms
# within it, then the ledger_accept's
DOOR_CLOSE_KEYS = ("seq", "wall_ms", "submit_ms", "verify_ms", "apply_ms", "close_ms",
                   "close_apply_ms", "close_seal_ms", "seal_state_ms", "seal_state_nodes",
                   "seal_tx_ms", "seal_tx_nodes", "gc_ms", "gc_full_collections")
# errors the default close's helpers (drainer, seal threads, persist rows,
# fold, speculation, adoption) counted and absorbed: each must stay 0
ABSORBED = ("drain_errors", "seal_thread_errors", "persist_prep_errors", "fold_errors",
            "spec_errors", "adopt_errors")


# the speculation pool's counters (engine/specexec.py SpecExecutor); those
# that mean a broken pool must stay 0 on the card, the others (retries,
# validation_aborts, serial_fallbacks, no_records: the book's crossings
# are expected to abort) are reported
SPEC_COUNTERS = ("windows", "dispatched", "executed", "committed", "retries",
                 "validation_aborts", "serial_fallbacks", "exec_errors", "no_records",
                 "drains_forced", "reads_served", "deltas_sent", "worker_deaths",
                 "committer_errors")
SPEC_BROKEN = ("worker_deaths", "committer_errors", "exec_errors", "drains_forced")


def spec_growth(ex, before: Optional[dict]) -> Optional[dict]:
    """How far each of a speculation pool's counters grew since the
    snapshot ``before`` (None without a pool)."""
    if ex is None or before is None:
        return None
    after = ex.counters.snapshot()
    return {k: after[k] - before[k] for k in SPEC_COUNTERS}


class WireMax:
    """The largest record this process puts on the pool's wire, by message
    kind (engine/specring.encode_msg wrapped: the parent's side, whose
    `exec` chunks carry the committed deltas a retry ships); ``restore()``
    unwraps."""

    def __init__(self):
        from stellard_tpu_torch.engine import specring

        self.mod, self.orig, self.by_kind = specring, specring.encode_msg, {}

        def encode(obj):
            out = self.orig(obj)
            kind = obj[0] if type(obj) is tuple and obj else "?"
            if len(out) > self.by_kind.get(kind, 0):
                self.by_kind[kind] = len(out)
            return out

        specring.encode_msg = encode

    def restore(self) -> None:
        self.mod.encode_msg = self.orig


def check_spec_pool(spec: dict, ex, what: str) -> None:
    """The close node's pool, from get_counts' `spec` block (``spec``) and
    the executor (``ex``): the configured pool, running; every dispatched
    transaction committed; no worker death, committer error, execution
    error, forced drain or torn ring slot; not failed over to serial."""
    got = (spec["workers"], spec["mode"], spec["transport"], spec["active"])
    require(got == (SPEC_WORKERS, "process", "ring", True),
            f"{what}: the speculation pool is {got}")
    require(spec["dispatched"] > 0 and spec["committed"] == spec["dispatched"],
            f"{what}: {spec['committed']} committed of {spec['dispatched']} dispatched")
    # each worker as the parent sees it: alive, its exit code (negative:
    # the signal that ended it), the last torn slot's reason on either ring
    workers = [(w.alive, w.proc.exitcode, getattr(w.res, "torn_error", None),
                getattr(w.cmd, "torn_error", None)) for w in ex._procs]
    require(all(spec[k] == 0 for k in SPEC_BROKEN),
            f"{what}: the pool broke: {({k: spec[k] for k in SPEC_BROKEN})}; "
            f"workers {workers}; ring {spec['ring']}")
    torn = [w.res.counters["torn_slots"] + w.cmd.counters["torn_slots"] for w in ex._procs]
    require(spec["ring"]["torn_slots"] == 0 and torn == [0] * SPEC_WORKERS,
            f"{what}: torn ring slots {torn}; workers {workers}")
    require(ex.can_accept and all(w.alive for w in ex._procs),
            f"{what}: the pool failed over to the serial path")


def check_spec_stopped(procs: list, segments: list) -> dict:
    """After Node.stop(): every worker of the pool exited with code 0 and
    every ring segment it used is unlinked (no /dev/shm name left)."""
    codes = [w.proc.exitcode for w in procs]
    require(codes == [0] * SPEC_WORKERS, f"the pool's workers exited with {codes}")
    left = [name for name in segments if os.path.exists(f"/dev/shm/{name}")]
    require(not left, f"ring segments left in /dev/shm: {left}")
    return {"exit_codes": codes, "segments_unlinked": len(segments)}


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


# the book phase's searches that also go through the node's
# ripple_path_find door, spread evenly over BOOK_SIZES' requests
DOOR_PATH_FINDS = 4


def door_path_finds(node, ledger, requests, answers) -> dict:
    """DOOR_PATH_FINDS of the path searches through the node's HTTP
    `ripple_path_find` door, on ``ledger`` (by hash), each answer's
    alternatives held to the direct search's (``answers``) in the door's
    JSON form."""
    from stellard_tpu_torch.protocol.keys import encode_account_id
    from stellard_tpu_torch.protocol.stobject import STPathSet

    stride = max(1, len(requests) // DOOR_PATH_FINDS)
    picks = list(range(0, len(requests), stride))[:DOOR_PATH_FINDS]
    http = HttpRpc(node.http_server.port)
    equal = 0
    try:
        for i in picks:
            src, dst, amount, send_max = requests[i]
            params = {"ledger_hash": ledger.hash().hex().upper(),
                      "source_account": encode_account_id(src),
                      "destination_account": encode_account_id(dst),
                      "destination_amount": amount.to_json()}
            if send_max is not None:
                params["send_max"] = send_max.to_json()
            got = http.call("ripple_path_find", **params)
            want = [{"paths_computed": STPathSet(a["paths"]).to_json(),
                     "source_amount": a["source_amount"].to_json()} for a in answers[i]]
            require(got.get("alternatives") == want,
                    f"ripple_path_find of request {i} differs from the direct search: {got}")
            equal += 1
    finally:
        http.close()
    return {"requests": picks, "equal": equal}


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

    from stellard_tpu_torch.ops import ed25519_cuda, pathq, treehash
    from stellard_tpu_torch.protocol import keys

    t0 = time.perf_counter()
    bwl = book_workload(close["wl"], **BOOK_SIZES)
    inputs_s = time.perf_counter() - t0
    hasher = close["hasher"]
    node = close["node"]
    lm = node.ledger_master
    calls0, readbacks0 = hasher.tree_calls, hasher.tree_transfers.readbacks
    nodes0, tree0 = hasher.device_nodes, lm.tree_json()
    # the node's own planes: its verify plane (K1) and its path plane,
    # whose evaluator (K4, routing=device) keeps each batch it is given
    plane, paths = node.verify_plane, node.path_plane
    evaluator = paths.evaluator
    require(evaluator.routing == "device" and paths.prune_floor == BOOK_PRUNE_FLOOR,
            "the node's path plane is not the book phase's")
    batches = []
    evaluator.batch_observers.append(lambda rates: batches.append(np.array(rates)))
    ev0, pp0 = evaluator.get_json(), paths.get_json()
    k1_per_close = []

    ed25519_cuda.launches = 0
    pathq.launches = 0
    treehash.reset_launches()
    keys.host_verifies = 0

    drain_ms = []
    # the pool's counters and the closes' waits on it, close by close
    ex = node.spec_executor
    spec_drain = Timed(lm, "_drain_spec")
    spec_rows, spec_prev = [], [ex.counters.snapshot(), 0.0]

    def on_close(k, ledger, results):
        spec_rows.append({"seq": ledger.seq, "counters": spec_growth(ex, spec_prev[0]),
                          "drain_ms": spec_drain.ms - spec_prev[1]})
        spec_prev[:] = [ex.counters.snapshot(), spec_drain.ms]
        k1_per_close.append(ed25519_cuda.launches)
        saver.persist.submit(ledger, results)
        if k == len(bwl["closes"]) - 1:
            # the last close: the pipeline drains before the path searches,
            # whose Python would otherwise hold the GIL the worker waits on
            t = time.perf_counter()
            saver.persist.flush()
            drain_ms.append((time.perf_counter() - t) * 1e3)

    t0 = time.perf_counter()
    try:
        res = run_book({"lm": lm, "router": node.hash_router}, bwl, plane.verify_many, paths,
                       first_close=len(CLOSE_HASHES), on_close=on_close)
    finally:
        spec_drain.restore()
    phase_s = time.perf_counter() - t0
    # 4 of the searches again, through the node's `ripple_path_find` door
    t0 = time.perf_counter()
    door = door_path_finds(node, lm.closed_ledger(), bwl["requests"], res["answers"])
    door_paths_ms = (time.perf_counter() - t0) * 1e3
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches,
                "path_quality": pathq.launches}
    by_thread = {k: dict(v) for k, v in treehash.launches_by_thread.items()}
    host_verifies = keys.host_verifies
    tree = lm.tree_json()
    http = HttpRpc(node.http_server.port)
    spec = http.call("get_counts")["spec"]
    http.close()
    emit("spec", of="book", card=name_power, workers=spec["workers"], mode=spec["mode"],
         transport=spec["transport"],
         per_close=[dict(row, wall_ms=c["wall_ms"], transactions=len(e),
                         open_apply_ms_per_tx=c["apply_ms"] / len(e),
                         transactions_per_s=len(e) / c["wall_ms"] * 1e3)
                    for row, c, e in zip(spec_rows, res["closes"], bwl["closes"])],
         totals={k: spec[k] for k in SPEC_COUNTERS}, ring=spec["ring"],
         max_record_bytes=dict(close["wire"].by_kind))
    check_spec_pool(spec, ex, "book phase")
    t0 = time.perf_counter()
    saver.persist.stop()
    lm.stop_seal_drainer()
    stop_ms = (time.perf_counter() - t0) * 1e3

    pj, pp, ev = plane.get_json(), paths.get_json(), evaluator.get_json()
    # the plane's and evaluator's counters of this phase alone (the
    # node's plane also ranked during the close phase's closes)
    pp["prune_batches"] -= pp0["prune_batches"]
    for key in ("device_batches", "host_batches"):
        ev[key] -= ev0[key]
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
    require(door["equal"] == len(door["requests"]) == DOOR_PATH_FINDS,
            "a ripple_path_find answer differs from the direct search's")

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
        "door_path_finds": door["requests"], "door_paths_ms": door_paths_ms,
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
    # the node stops (its pool, doors, planes and stores; the CLF's
    # database closes beside it) and drops the chain: the replay loads
    # its own. The pool's workers must exit 0 and leave no ring segment.
    procs = list(ex._procs)
    segments = [conn._ring.shm.name for w in procs for conn in (w.cmd, w.res)]
    t0 = time.perf_counter()
    node.stop()
    node_stop_ms = (time.perf_counter() - t0) * 1e3
    stopped = check_spec_stopped(procs, segments)
    close["wire"].restore()
    emit("spec_stop", card=name_power, node_stop_ms=node_stop_ms, **stopped)
    saver.close_sql()
    saver.persist = None
    close["node"] = None
    return {"launches": launches, "by_thread": by_thread, "k4_max_abs_err": k4_err,
            "close_digests": [c["close_digest"] for c in res["closes"]]}


# the replay phase (BASELINE config #5): the on-disk store the chain is
# saved to (git-ignored, removed at the end); the span replayed, the book
# phase's first 2 ledgers (1005-1006: trust lines, regular keys and the
# issuance), cut from the 8 ledgers saved to fit the smoke's time limit
# (PERF.md §4); and the ledger forged with a bad signature, a copy of
# 1006 (the issuance close) replayed in the same span right after the
# real one
STORE_DIR = HERE / "build" / "chip_smoke_store"
REPLAY_FIRST = len(CLOSE_HASHES)  # index of 1005 among the closed ledgers
REPLAY_LEDGERS = 2
FORGE_SEQ = START_SEQ + REPLAY_FIRST + 2


class ChainSaver:
    """The chain's storage under ``path``: the node's own (its config,
    node_config_text, puts them there), an on-disk segstore node store
    (``nodestore/``; the JAX node's defaults: durability fsync, 5 ms
    group commit, 64 MB segments), a file-backed txdb (``txdb.db``) and
    the CLF beside it (``txdb.db.clf``). ``save`` writes one ledger to
    the node store (save_counted) — the start ledger directly, each
    closed ledger as the node's close pipeline's node-store stage;
    ``attach_node`` takes the node's stores and wraps its persistence
    (``persist``, a ChainPersist). Keeps the ledger FORGE_SEQ for the
    replay phase's forgery."""

    def __init__(self, path: Path):
        shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)
        self.path = path
        self.db_path = path / "nodestore"
        self.db = self.txdb = self.clf = None
        self.persist = None
        self.kept = None
        self.saves: list[dict] = []

    def attach_node(self, node) -> None:
        """Take a node's stores (its config puts them under ``path``:
        node_config_text) and follow its persistence
        (ChainPersist.of_node): each closed ledger's node-store save is
        counted, and its txdb rows and the CLF digested, once persisted."""
        require(Path(node.config.node_db_path) == self.db_path,
                "the node's store is not the chain's")
        self.db, self.txdb, self.clf = node.nodestore, node.txdb, node.clf
        self._mark = self._marks()
        self.persist = ChainPersist.of_node(node, on_persisted=self.note_saved)

    def _marks(self) -> tuple[int, int, int]:
        """The store's nodes written, bytes appended and records so far."""
        return (len(self.db.flushed), getattr(self.db.backend, "bytes_appended", 0),
                self.db.backend.records)

    def save(self, ledger) -> None:
        """Save ``ledger`` (the start ledger) into the chain's store and
        count what it wrote (save_counted)."""
        records0 = self.db.backend.records
        rec = save_counted(ledger, self.db)
        rec["records"] = self.db.backend.records - records0
        self._keep(ledger, rec)

    def note_saved(self, ledger, stage_ms: dict) -> None:
        """Count what the node's close pipeline wrote to the store for
        ``ledger``, as save_counted counts a save: it runs once that
        ledger is persisted and before the next one's writes start, so
        the store's counters moved by this ledger's save alone."""
        nodes, nbytes, records = self._marks()
        rec = {"seq": ledger.seq, "hash": ledger.hash().hex(),
               "nodes": nodes - self._mark[0] + 1, "bytes": nbytes - self._mark[1],
               "ms": stage_ms.get("nodestore"), "records": records - self._mark[2]}
        self._keep(ledger, rec)

    def _keep(self, ledger, rec: dict) -> None:
        self.saves.append(rec)
        self._mark = self._marks()
        if ledger.seq == FORGE_SEQ:
            self.kept = ledger

    def close_sql(self) -> None:
        """Close the CLF's database (the node closes its txdb and store
        when it stops)."""
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
    1006 and the forged 1006: one verify_many for the whole span on
    the card (K1), each ledger loaded eagerly with its parent,
    re-applied by the transactors and sealed by CudaHasher (K2, K3).
    Every real ledger replays to its hash, with its close's results and
    the nodes its close hashed on the host; K1 rejects exactly the
    forged lane, and the forged ledger alone fails. The launch counts
    are this phase's alone. The store stays for the resume step
    (resume_step)."""
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
        # the node stopped and closed its store: catch-up opens it again
        db = make_database(type="segstore", path=str(saver.db_path))
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
        # the store holds every record listed: the forged copy's save
        # below writes only what it lacks, as the node that wrote them
        # would (a store opened afresh knows none of its nodes)
        db.flushed.update(key for key, _t, _b in records)
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
        heap_objects = len(gc.get_objects())  # what the collector scans at the start
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
        db.close()

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
        "heap_objects_at_start": heap_objects,
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


# --------------------------------------------------------------------------
# the resume step (the out-of-core state), at the end of the replay phase:
# a port Node resumes the chain's store lazily from its CLF pointer (the
# book phase's last ledger, 1008), answers account_info through HTTP for
# `reads` of the close workload's accounts at that ledger and for
# `history_reads` at RESUME_HISTORY_SEQ (a cold, lazy historical load),
# then closes `payments` payments of the close workload's shape, each an
# HTTP `submit` (K1 at batch 1), with one `ledger_accept` (splice, drainer
# and two seal threads on a tree whose clean subtrees are stubs: K2, K3)
# and its close pipeline's save into the same store. Its senders are the
# plain accounts the book phase leaves alone (resume_first_sender)
RESUME_SIZES = dict(payments=512, reads=256, history_reads=64, seed=43)
RESUME_HISTORY_SEQ = START_SEQ + 5
# the resumed node's config: the chain's own, loading its last ledger,
# with the path plane off. With it on, the first close after a restart
# rebuilds the plane's book index by reading every state entry, as the
# JAX node's does: on a lazy tree that faults all 1.36 M nodes, 232.6 s
# of the close on the card's host (PERF.md §5), which would carry the
# smoke past its time limit
RESUME_CONFIG = "\n[start_up]\nload\n\n[paths]\nenabled=0\n"
# a lazy resume reads the header and the two roots: a handful of store
# fetches, against the 1,359,552 nodes of an eager load
RESUME_FETCHES_MAX = 8
# what the JAX node gives, resumed the same way on the same chain
# (tests/test_torch_close.py's slow test): the closed ledger's hash, the
# results digest, the read answers' digests and the nodes its save wrote
RESUME_HASH = "6c24f0680b3d6f38096b088becbd74e8ee206d626e1e5060d9ec2b24b2b44ae4"
RESUME_DIGEST = "fdf3bfe2d56b81ea0f63da54d6875db9c3bf4081c522708cf3dd4787b8935ad5"
RESUME_READ_DIGESTS = {
    "resumed": "24ede08728a404baa6b2d476e95d72606062a5d7a2cd02ffbe503a82e7f6267e",
    "history": "22ca28db60e2e6b5ceadcd0a8ffa5457b525d101bde09b7c4174cadd23fc2342",
}
RESUME_SAVE_NODES = 4582


def resume_first_sender(book_sizes: dict) -> int:
    """The first sender the book phase leaves alone: after its gateways,
    its traders and the plain accounts it merges."""
    return book_sizes["n_gateways"] + book_sizes["n_traders"] + 2 * book_sizes["n_merges"]


def resume_workload(wl: dict, first_sender: int, payments: int, reads: int,
                    history_reads: int, seed: int) -> dict:
    """Seeded inputs of the resume step, on the close workload `wl`'s
    chain: ``payments`` Payments in the close workload's shape (~2% to a
    new account, ~1% with a planted bad signature; payment_entry) from
    the senders from ``first_sender`` on in turn, at their next
    sequences after the close phase, each to one of the accounts that
    never sent (they exist on every ledger of the chain); and the
    accounts whose account_info is read at the resumed ledger
    (``reads``) and at RESUME_HISTORY_SEQ (``history``)."""
    import numpy as np

    from stellard_tpu_torch.protocol.keys import KeyPair

    rng = np.random.default_rng(seed)
    n_senders = len(wl["sender_seeds"])
    keys = [KeyPair.from_seed(sd) for sd in wl["sender_seeds"][first_sender:]]
    seqs = list(wl["next_seqs"][first_sender:])
    dests = wl["accounts"][n_senders:]
    entries = []
    for p in range(payments):
        i = p % len(keys)
        u = rng.random()
        kind = "bad_sig" if u < 0.01 else "new_account" if u < 0.03 else "existing"
        if kind == "new_account":
            dst, drops = rng.bytes(20), 250_000_000
        else:
            dst = dests[int(rng.integers(len(dests)))]
            drops = int(rng.integers(1_000_000, 100_000_001))
        entry = payment_entry(rng, keys[i], seqs[i], kind, dst, drops)
        if entry[2]:
            seqs[i] += 1
        entries.append(entry)
    pick = lambda n: [wl["accounts"][int(j)]  # noqa: E731
                      for j in rng.integers(len(wl["accounts"]), size=n)]
    return {"entries": entries, "reads": pick(reads), "history": pick(history_reads)}


class ResumeProbe:
    """What a resumed node's step does to its lazy trees and its hasher,
    in either package: every node faulted from the store (``shamap``'s
    NodeSource._load) by stage (``stage``, set by drive_resume), and those
    faulted inside a seal (on a ``seal-`` thread of the LedgerMaster, or
    within a ``hash_tree`` call of ``hasher``); and per ``hash_tree``
    call (the port's CudaHasher, whatever thread it runs on) the nodes
    it hashed on the host and the nodes K2/K3 cannot take, counted from
    its tree's unhashed set before it ran (host_only_nodes)."""

    def __init__(self, shamap, hasher=None):
        self.stage = "boot"
        self.faults: dict[str, int] = {}
        self.seal_faults = 0
        self.trees: list[tuple[int, int]] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        self._undo = []
        source = shamap.NodeSource
        load = source._load

        def counted_load(src, h):
            in_seal = (getattr(self._local, "host", None) is not None
                       or threading.current_thread().name.startswith("seal-"))
            with self._lock:
                self.faults[self.stage] = self.faults.get(self.stage, 0) + 1
                self.seal_faults += in_seal
            return load(src, h)

        source._load = counted_load
        self._undo.append(lambda: setattr(source, "_load", load))
        if hasher is not None:
            tree, count = hasher.hash_tree, hasher._count_nodes

            def count_nodes(host, device):
                if getattr(self._local, "host", None) is not None:
                    self._local.host += host
                return count(host, device)

            def hash_tree(root, *a, **kw):
                only = host_only_nodes(root)
                self._local.host = 0
                try:
                    return tree(root, *a, **kw)
                finally:
                    with self._lock:
                        self.trees.append((self._local.host, only))
                    self._local.host = None

            hasher._count_nodes, hasher.hash_tree = count_nodes, hash_tree

            def unwrap():
                del hasher._count_nodes, hasher.hash_tree

            self._undo.append(unwrap)

    def restore(self) -> None:
        for undo in self._undo:
            undo()


def boot_resumed(node_cls, config_cls, text: str):
    """A node of either package built from the config `text` (with
    RESUME_CONFIG) and set up: it resumes its chain from the store.
    -> (node, {node_ms, load_ms, fetches}): the store's fetches at boot
    (its cache hits and backend fetches)."""
    t0 = time.perf_counter()
    node = node_cls(config_cls.from_ini(text))
    t1 = time.perf_counter()
    node.setup()
    t2 = time.perf_counter()
    db = node.nodestore.get_json()
    return node, {"node_ms": (t1 - t0) * 1e3, "load_ms": (t2 - t1) * 1e3,
                  "fetches": db["cache_hits"] + db["backend_fetches"]}


def drive_resume(node, rwl: dict, probe: ResumeProbe, close_index: int,
                 history_seq: int) -> dict:
    """The resume step through a serving node's doors (either package's
    Node, resumed lazily and served): account_info of ``rwl["reads"]``
    at the resumed ledger and of ``rwl["history"]`` at ``history_seq``,
    every payment a `submit`, then `ledger_accept`
    with the clock pinned to the close's time (START_CLOSE_TIME + 30
    (close_index + 1)), and the close pipeline drained. -> the resumed
    and closed ledgers, the results digest, the answers' TERs, the read
    digests, the nodes the save wrote (tree nodes and the header), the
    faults by stage and the times."""
    from stellard_tpu_torch.protocol.keys import encode_account_id
    from stellard_tpu_torch.protocol.sttx import SerializedTransaction

    lm = node.ledger_master
    resumed = lm.closed_ledger()
    closed: list = []
    node.ops.on_ledger_closed.append(lambda led, res: closed.append((led, res)))
    http = HttpRpc(node.http_server.port)
    times = {}
    try:
        t0 = time.perf_counter()
        probe.stage = "reads"
        reads = [http.call("account_info", account=encode_account_id(a),
                           ledger_index=resumed.seq) for a in rwl["reads"]]
        t1 = time.perf_counter()
        probe.stage = "history"
        history = [http.call("account_info", account=encode_account_id(a),
                             ledger_index=history_seq) for a in rwl["history"]]
        t2 = time.perf_counter()
        when = START_CLOSE_TIME + 30 * (close_index + 1)
        node.ops.network_time = lambda: when
        flushed0 = len(node.nodestore.flushed)
        probe.stage = "submits"
        blobs = [blob for blob, _k, _g in rwl["entries"]]
        answers = [http.call("submit", tx_blob=b.hex().upper()) for b in blobs]
        t3 = time.perf_counter()
        probe.stage = "close"
        accept = http.call("ledger_accept")
        t4 = time.perf_counter()
        require(accept.get("ledger_current_index") == resumed.seq + 2,
                f"resume ledger_accept: {accept}")
        probe.stage = "persist"
        require(node.close_pipeline.flush(timeout=3600), "the close pipeline did not drain")
        t5 = time.perf_counter()
        probe.stage = "done"
        times = {"reads_ms": (t1 - t0) * 1e3, "history_reads_ms": (t2 - t1) * 1e3,
                 "submits_ms": (t3 - t2) * 1e3, "ledger_accept_ms": (t4 - t3) * 1e3,
                 "persist_ms": (t5 - t4) * 1e3}
    finally:
        http.close()
    ledger, results = closed[-1]
    txids = [SerializedTransaction.from_bytes(b).txid() for b in blobs]
    open_ters = [(txid, int(a["engine_result_code"])) for txid, a in zip(txids, answers)]
    return {
        "resumed": (resumed.seq, resumed.hash().hex()), "seq": ledger.seq,
        "hash": ledger.hash().hex(), "digest": results_digest(open_ters, results),
        "open_ters": [t for _, t in open_ters],
        "close_ters": {txid: int(t) for txid, t in results.items()},
        "read_digests": {"resumed": read_digest(reads), "history": read_digest(history)},
        "read_errors": [r for r in reads + history if "error" in r][:3],
        "nodes": len(node.nodestore.flushed) - flushed0 + 1,
        "faults": dict(probe.faults), "seal_faults": probe.seal_faults, **times,
    }


def resume_step(dev, name_power: str, saver: ChainSaver) -> dict:
    """The resume step (see RESUME_SIZES) on the chain's store, after
    the replay phase closed it: the port's Node from the chain's own
    config with RESUME_CONFIG boots with a handful of store
    fetches, serves (K1's prewarm), answers the reads and closes the
    payments. Its ledger hash, results digest, read answers and saved
    nodes equal the JAX node's; nodes faulted, none of them in a seal;
    no host verify, device share 1.0; K1, K2 and K3 launched, K1 once a
    submit; the host hashed only what K2/K3 cannot; one readback a tree.
    The launch counts are this step's alone."""
    from stellard_tpu_torch.node.config import Config
    from stellard_tpu_torch.node.node import Node
    from stellard_tpu_torch.ops import ed25519_cuda, treehash
    from stellard_tpu_torch.protocol import keys
    from stellard_tpu_torch.protocol.ter import TER
    from stellard_tpu_torch.state import shamap

    rwl = resume_workload(close_workload(**CLOSE_SIZES), resume_first_sender(BOOK_SIZES),
                          **RESUME_SIZES)
    # a restarted node is a new process: its hot-node cache starts empty.
    # This process's still holds the replay's eager loads, whose whole
    # subtrees a lazy fault would take (both packages' NodeSource takes
    # any cached node), and a save would then rewrite them
    shamap.inner_node_cache().clear()
    ed25519_cuda.launches = 0
    ed25519_cuda.launches_by_batch.clear()
    treehash.reset_launches()
    keys.host_verifies = 0
    cache = shamap.inner_node_cache()
    faults0 = cache.faults
    text = node_config_text(saver.path, PORT_NODE_DEVICE.format(
        dev=dev, floor=BOOK_PRUNE_FLOOR) + RESUME_CONFIG)
    node = probe = None
    try:
        node, boot = boot_resumed(Node, Config, text)
        boot["faults"] = cache.faults - faults0
        hasher = node.hasher.inner  # the CudaHasher behind the watchdog
        probe = ResumeProbe(shamap, hasher)
        t0 = time.perf_counter()
        node.serve()  # waits for K1's prewarm
        serve_ms = (time.perf_counter() - t0) * 1e3
        prewarm_k1 = dict(ed25519_cuda.launches_by_batch)
        calls0, readbacks0 = hasher.tree_calls, hasher.tree_transfers.readbacks
        t0 = time.perf_counter()
        res = drive_resume(node, rwl, probe, len(CLOSE_HASHES) + len(BOOK_HASHES),
                           RESUME_HISTORY_SEQ)
        step_ms = (time.perf_counter() - t0) * 1e3
        launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches}
        by_batch = dict(ed25519_cuda.launches_by_batch)
        host_verifies = keys.host_verifies
        vp = node.verify_plane.get_json()
        tree = node.ledger_master.tree_json()
        last_close = dict(node.ledger_master.last_close)
        tree_calls = hasher.tree_calls - calls0
        readbacks = hasher.tree_transfers.readbacks - readbacks0
        cache_json = cache.get_json()
    finally:
        if probe is not None:
            probe.restore()
        if node is not None:
            node.stop()

    entries = rwl["entries"]
    want = [int(TER.temINVALID) if kind == "bad_sig" else int(TER.tesSUCCESS)
            for _b, kind, _g in entries]
    chain = CLOSE_HASHES + BOOK_HASHES
    require(res["resumed"] == (START_SEQ + len(chain), chain[-1]),
            f"the node resumed {res['resumed']}, not the book phase's last ledger")
    require(boot["fetches"] <= RESUME_FETCHES_MAX,
            f"the lazy resume fetched {boot['fetches']} nodes from the store")
    require(not res["read_errors"], f"account_info answered {res['read_errors']}")
    require(res["read_digests"] == RESUME_READ_DIGESTS,
            f"read answers {res['read_digests']} differ from the JAX node's")
    require(res["open_ters"] == want, "resume: submit answers' TERs wrong")
    require(len(res["close_ters"]) == sum(g for _b, _k, g in entries)
            and set(res["close_ters"].values()) == {int(TER.tesSUCCESS)},
            "resume: closed TERs wrong")
    require(res["hash"] == RESUME_HASH,
            f"resumed close hash {res['hash']} differs from the JAX package's {RESUME_HASH}")
    require(res["digest"] == RESUME_DIGEST, "resumed close: results digest differs")
    require(res["nodes"] == RESUME_SAVE_NODES,
            f"the resumed close's save wrote {res['nodes']} nodes, the JAX node's "
            f"{RESUME_SAVE_NODES}")
    require(sum(res["faults"].values()) > 0, "the resumed node faulted no node")
    require(res["seal_faults"] == 0, f"{res['seal_faults']} nodes faulted inside a seal")
    require(host_verifies == 0, f"{host_verifies} host signature verifications on resume")
    require(vp["device_share"] == 1.0, f"resume device share {vp['device_share']}")
    n_batch1 = by_batch.get(1, 0) - prewarm_k1.get(1, 0)
    require(n_batch1 == len(entries), f"{n_batch1} K1 launches at batch 1 for "
            f"{len(entries)} submits")
    require(launches["sha512_masked"] > 0 and launches["tree_inner_level"] > 0,
            "K2 or K3 never launched in the resume step")
    require(probe.trees and all(host == only for host, only in probe.trees),
            f"host-hashed nodes per sealed tree {probe.trees} differ from the nodes "
            "K2/K3 cannot hash")
    require(readbacks == tree_calls > 0, f"resume readbacks {readbacks}, tree calls "
            f"{tree_calls}")
    require(all(tree[k] == 0 for k in ABSORBED),
            f"errors absorbed by the resumed close's helpers {tree}")
    emit("resume", card=name_power, boot=boot, serve_ms=serve_ms, step_ms=step_ms,
         resumed_seq=res["resumed"][0], closed_seq=res["seq"],
         payments=len(entries), reads=len(rwl["reads"]), history_reads=len(rwl["history"]),
         history_seq=RESUME_HISTORY_SEQ,
         **{k: res[k] for k in ("reads_ms", "history_reads_ms", "submits_ms",
                                "ledger_accept_ms", "persist_ms", "faults", "seal_faults",
                                "nodes")},
         close=last_close,
         cache={k: cache_json[k] for k in ("resident_bytes", "limit_bytes", "size",
                                           "hits", "misses", "faults", "evictions")},
         tree_calls=tree_calls, readbacks=readbacks,
         host_nodes_per_tree=[h for h, _o in probe.trees],
         host_verifies=host_verifies, device_share=vp["device_share"],
         k1_batch1_submits=n_batch1, hashes_equal_jax=True, reads_equal_jax=True,
         launches=launches)
    return {"launches": launches, "k1_batch1": n_batch1}


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

# -- the scenario kit (phase 11) ----------------------------------------------

# every MATRIX scenario at this seed, and every corpus entry at its own
SCENARIO_SEED = 7
# name -> (digest of the scorecard less its wall-clock `spec` block and its
# mesh's resolved `width`, final hash), as the JAX package's run_simnet
# gives them on the CPU at 8 host devices, re-applying in the port's order
# (jax_reapply_parity); recomputed by
# JAX_PLATFORMS=cpu python -m pytest tests/test_torch_scenario_matrix.py -m slow -q -s
SCENARIO_CARDS = {
    "partition_kills": (
        "902951e04a6bd26c52ac29db79f3ef92e785b83399d970af8fad183869b9f4ee",
        "f5f278ec7779bcf927aecb89173ac398184a251beb0c9e4a6ef4d5f222d55f9a"),
    "chaos": (
        "f4c728f1e5759a8434df918259049abaf0ac0b4afe396f7b4dccaba5a13a36eb",
        "a09bf4267afe91b8907d2bbfe6ac496cdcb569600d4b6a7207e39af97b7b7f64"),
    "chaos_spec2": (
        "1f3ccb74bc7a3ac3fe09519d31636f1c16cc6bbce73eb1a460f0f3245fbf4475",
        "a09bf4267afe91b8907d2bbfe6ac496cdcb569600d4b6a7207e39af97b7b7f64"),
    "byzantine": (
        "9ac2c33f0328716cabcc74e184bb964a63c9be83c91d82a9344ba3c934ddd8e3",
        "a9401b03b87570761aeac556fc5ec9e5430415e471e28e2449ea24f16ca909b2"),
    "cold_catchup": (
        "2939808248b00939feaaae751ab6e13702c714318b9f4394d8870d7501be4840",
        "c272d38a1e38adef31a49451e19304ad9a8b929a9c0332bc24a1aa5e53cfd19f"),
    "shard_cold_catchup": (
        "5a6adf009b4a270eae2d0dc947e1a20a06d70e5ce0107482ef598a3dcccff399",
        "8020e754af85e046dd38d05f5b76a87f4662e75fdbc6e4417217f0140a86f36f"),
    "archive_backfill": (
        "bd74977ab9c5538407e8a04d2474f0d18367913a7681961df96d3dfbc93f1328",
        "8020e754af85e046dd38d05f5b76a87f4662e75fdbc6e4417217f0140a86f36f"),
    "hot_account": (
        "04306815a92efc02cef68dfccf592a12584ec476b18ce54fac1909430a65db75",
        "763cb5ce3612f245bfb3ff2a3328e52c7140d28d94fc6714d034ec57766a03ac"),
    "order_books": (
        "00a33de38919b0343e65b0d69b7c14afa98ff627f644bce2ececa995ebf5c625",
        "a448a05b49b68b86017a97aa52dbb75a3206f5a53313104955eaabf383fd80a8"),
    "follower_partition": (
        "70db0735e0ec3f30438c26e5c1163a9047e60f8319e4466e6b8b0ea383ff0f92",
        "6757b82ef01ba2c1868f033b7a30742897d19eac5efc2dc60fd07391d7a99c71"),
    "follower_tree": (
        "ee04d59e11477b66f2c8c8b7430e98f1d1f5cea07fc18152d3b9b525c4f2b29d",
        "b47544b52a3b8f13d3064b5c10229382337f09ad990478ef40250c28a4acaccd"),
    "mesh_hash": (
        "2355e59f3c7bc944c38e2d05c3775a53b33388a848af2cba9494d9082359b73c",
        "01027236e94031079e96489c5cdbba01c0c1748609bf344cef9b3c4be654d091"),
    "fee_gaming": (
        "0b3090317d1c44a407a4a8b7b43cfa2064413f6619b505d152e1b6d4bedb737b",
        "b998a1d87994cac10bced3ea5047504ec94217deec95e4dd98d3f688d1610cf4"),
    "flood_survival": (
        "4cd6758adec3e295780d64a323445037acbcabc6829754f0fe67333c1c2b3386",
        "15c684166a15044166da977ef8fa82ab3f637dffe3ffd17092b1e4a238fd0820"),
    "squelch_rotation_flood": (
        "90bf4f02508af0347929ff63b376eff57450fc5ef9d3a033c233a46ba20dcaed",
        "fa9baaf9e3c4fcbfbe023715bde6cc13be1471fe6df42b5f8bb1912c45af01e1"),
    "fuzz_committed_floor_6997bab0": (
        "6336e1d1ae14f27b2fe6bc27c664602f9426181cda9f374d57877e9153cc8d9e",
        "c2408b1836ef26b441afcc2a31986fa807cf778da649b4519576c5f5d6ae27e8"),
    "fuzz_committed_floor_e715bfd6": (
        "3035a0200577f78af385757a820f2d7942eb9900a0cf3c01eda528f071b295b9",
        "467c092b21301abf1578c0412a8556a21d8cf8bdd63caedbf0ec2e93b50e7f81"),
    "fuzz_convergence_3364bc2e": (
        "ef933ffa31db7836dee17eef112016114165c68d454a1f6cbe77c9c627413d4f",
        "6304fa211e3cf9476757ceab3b283d23b4f4bad69152d41be9afcb3bfee58ae7"),
    "fuzz_single_hash_6859444c": (
        "42d1c88ba2842756abeba29cfc01b307559c073d5576ae8d8ab97cbf239c8778",
        "f24cbc6156e31bfb3cd6935168d971dfd4a8464b662a11ef0463dfffde6252b7"),
    "fuzz_single_hash_history_c08731d2": (
        "1012dedcf549423561870631f8c574f6f87c1ade7aa806878302c40186616acb",
        "3380838566137497db24b18c447cb4930b9c5b88f492973805bd6334cba084a8"),
}
# scenarios whose scorecard is wall-clock beyond `spec` (the splice counts
# follow the thread pool's timing): held by hash identity with another
# scenario at the same seed, as search._strip_nondeterministic allows
SCENARIO_SAME_HASH = {"chaos_spec2": "chaos"}
SCENARIO_TCP_SEED = 1
SCENARIO_TCP_DIR = HERE / "build" / "chip_smoke_scenario_tcp"


def scenario_digest(card: dict) -> str:
    """A run_simnet scorecard's digest as the smoke holds it: without the
    spec pool's counters and the mesh's resolved width (the JAX tests see
    8 host devices, the card 1)."""
    out = {k: v for k, v in card.items() if k != "spec"}
    if out.get("mesh") is not None:
        out["mesh"] = {k: v for k, v in out["mesh"].items() if k != "width"}
    return hashlib.sha256(json.dumps(out, sort_keys=True).encode()).hexdigest()


def scenarios_phase(dev, name_power: str) -> dict:
    """The port's scenario kit on the card (in its own process, beside the
    book, the replay and the resume). Every matrix scenario at
    SCENARIO_SEED and every corpus entry at its own seed through
    ``testkit.run_simnet(device=dev)``: each converges on one hash, its
    scorecard digest is the JAX package's (SCENARIO_CARDS), chaos_spec2's
    final hash chaos's; mesh_hash's mesh leg hashes on K2 across the
    visible cards (its width), active and not wedged. Then
    ``testkit.tcpnet.run_tcp(scenario_chaos(seed=1), backend="cuda")``:
    four validator children on the card, two killed and revived, every
    transaction of the workload submitted, one hash, no error; their logs
    in SCENARIO_TCP_DIR. Launches are this process's (K2 in the mesh
    leg); the children's launch counts are reported, not summed."""
    import torch

    from stellard_tpu_torch.ops import ed25519_cuda, pathq, treehash
    from stellard_tpu_torch.testkit import MATRIX, build_scenario, load_corpus, run_simnet
    from stellard_tpu_torch.testkit.scenarios import scenario_chaos
    from stellard_tpu_torch.testkit.tcpnet import run_tcp
    from stellard_tpu_torch.testkit.workloads import TxFactory, build_spec_workload

    t_phase = time.perf_counter()
    ed25519_cuda.reset_launches()
    treehash.reset_launches()
    pathq.launches = 0
    names = list(MATRIX) + list(load_corpus())
    require(sorted(names) == sorted(SCENARIO_CARDS),
            f"scenarios {sorted(set(names) ^ set(SCENARIO_CARDS))} lack a JAX constant")
    rows, hashes = {}, {}
    for name in names:
        scn = build_scenario(name, SCENARIO_SEED)
        k2_before = treehash.launches["sha512_masked"]
        t0 = time.perf_counter()
        card = run_simnet(scn, device=dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        digest = scenario_digest(card)
        want_digest, want_hash = SCENARIO_CARDS[name]
        hashes[name] = card["final_hash"]
        require(card["converged"] and card["single_hash"],
                f"scenario {name} did not converge on one hash: {card['validated_seqs']}")
        row = {"wall_ms": wall_ms, "final_seq": card["final_seq"],
               "digest_equal": digest == want_digest}
        if name in SCENARIO_SAME_HASH:
            row["match"] = "hash"
        else:
            require(digest == want_digest, f"scenario {name}'s scorecard differs from the "
                    f"JAX package's: {digest} (final hash {card['final_hash']})")
            row["match"] = "digest"
        require(card["final_hash"] == want_hash,
                f"scenario {name}'s final hash {card['final_hash']} is not {want_hash}")
        if scn.mesh_width:
            mesh = card["mesh"]
            k2 = treehash.launches["sha512_masked"] - k2_before
            require(mesh["device_active"] and not mesh["wedged"],
                    f"scenario {name}'s mesh leg: {mesh}")
            require(mesh["width"] == torch.cuda.device_count(),
                    f"scenario {name}'s mesh width {mesh['width']} for "
                    f"{torch.cuda.device_count()} cards")
            require(k2 > 0, f"scenario {name} launched K2 no time")
            row.update(mesh=mesh, k2_launches=k2)
        if card.get("spec"):
            row["spec"] = card["spec"]
        rows[name] = row
    for name, other in SCENARIO_SAME_HASH.items():
        require(hashes[name] == hashes[other],
                f"{name}'s final hash {hashes[name]} is not {other}'s {hashes[other]}")
    simnet_s = time.perf_counter() - t_phase
    emit("scenarios", card=name_power, seed=SCENARIO_SEED, scenarios=len(rows),
         matrix=len(MATRIX), corpus=len(rows) - len(MATRIX), all_match=True,
         wall_s=simnet_s, rows=rows)

    # chaos over real processes on the card
    scn = scenario_chaos(seed=SCENARIO_TCP_SEED)
    workload = build_spec_workload(scn.workload)(
        TxFactory(seed=scn.seed), random.Random(0x301C ^ scn.seed), scn)
    shutil.rmtree(SCENARIO_TCP_DIR, ignore_errors=True)
    timeline: dict = {}
    t0 = time.perf_counter()
    card = run_tcp(scn, backend="cuda", mesh_timeout=TCP_START_S,
                   log_dir=str(SCENARIO_TCP_DIR), timeline=timeline)
    tcp_s = time.perf_counter() - t0
    require(card["converged"] and card["single_hash"],
            f"chaos over TCP did not converge on one hash: {card['validated_seqs']}")
    require(card["kills"] == 2 and card["errors"] == 0,
            f"chaos over TCP: {card['kills']} kills, {card['errors']} errors")
    require(card["submitted"] == len(workload),
            f"chaos over TCP submitted {card['submitted']} of {len(workload)}")
    require(all(r["door_s"] is not None for r in timeline["revive_door_s"]),
            f"a revived validator's door never answered: {timeline['revive_door_s']}")
    emit("scenario_tcp", card=name_power, scenario=card["scenario"], seed=card["seed"],
         validators=scn.n_validators, steps=card["steps"], kills=card["kills"],
         submitted=card["submitted"], errors=card["errors"], converged=card["converged"],
         single_hash=card["single_hash"], final_seq=card["final_seq"],
         validated_seqs=card["validated_seqs"], fault_digest=card["fault_digest"],
         boot_s=timeline["boot_s"], revive_door_s=timeline["revive_door_s"],
         steps_s=timeline["steps_s"], tail_s=timeline["tail_s"], wall_s=tcp_s,
         children_kernels=timeline["kernels"], logs=str(SCENARIO_TCP_DIR))
    launches = {"ed25519_verify": ed25519_cuda.launches, **treehash.launches,
                "path_quality": pathq.launches}
    emit("scenarios_done", phase_s=time.perf_counter() - t_phase, simnet_s=simnet_s,
         tcp_s=tcp_s, launches=launches)
    return {"launches": launches}


SIDE_JOIN_S = 700  # the consensus and tcp phases take 120-180 s on the card's host
# the scenarios process runs beside the book, the replay and the resume
# (434 s in PR 14's run C); it is joined after the resume, and waited for
# at most this long from then
SCENARIOS_JOIN_S = 600


class SideRun:
    """Phases in another process of this script (``flag T0``), started in
    a process group of its own (its children with it), its output and
    errors into ``build/<name>.out`` and ``.err``: they run while this
    process drives the close chain, which is host-bound. ``--side`` runs
    the consensus and tcp phases, ``--side-scenarios`` the scenarios
    phase. ``join`` waits for it (at most ``join_s``), prints what it
    printed, fails the smoke if it failed and returns its phases'
    results (its last line's ``side`` object); ``stop`` ends what is left
    of its group."""

    def __init__(self, flag: str = "--side", name: str = "chip_smoke_side",
                 join_s: float = SIDE_JOIN_S, what: str = "the consensus and tcp phases"):
        self.out_path = HERE / "build" / f"{name}.out"
        self.err_path = HERE / "build" / f"{name}.err"
        self.join_s, self.what = join_s, what
        self.out_path.parent.mkdir(parents=True, exist_ok=True)
        self.out, self.err = self.out_path.open("w"), self.err_path.open("w")
        self.proc = subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), flag, repr(T_IMPORT)],
            cwd=HERE, stdout=self.out, stderr=self.err, start_new_session=True)
        self.result = None

    def join(self) -> dict:
        if self.result is None:
            try:
                rc = self.proc.wait(timeout=self.join_s)
            except subprocess.TimeoutExpired:
                rc = None
            self.out.close()
            self.err.close()
            lines = self.out_path.read_text().splitlines()
            sys.stderr.write(self.err_path.read_text())
            sys.stderr.flush()
            last = json.loads(lines.pop()) if rc == 0 and lines else {}
            if lines:
                print("\n".join(lines), flush=True)
            require(rc == 0 and "side" in last, f"the process of {self.what} ended with {rc}")
            self.result = last["side"]
        return self.result

    def stop(self) -> None:
        """SIGTERM what is left of the side's process group (a node drains
        and stops), then SIGKILL; each waits up to 30 s for the group to
        empty."""
        import signal

        for sig in (signal.SIGTERM, signal.SIGKILL):
            self.proc.poll()  # reaps the side itself once it has ended
            try:
                os.killpg(self.proc.pid, sig)
            except ProcessLookupError:
                break  # nothing of its group is left
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                self.proc.poll()
                try:
                    os.killpg(self.proc.pid, 0)
                except ProcessLookupError:
                    break
                time.sleep(0.5)
        self.proc.wait()
        self.out.close()
        self.err.close()


def card_and_build(dev) -> tuple[str, float]:
    """The card's name and power limit and its INT32 rate; the kernels
    built (at once when this process's parent has built them)."""
    import torch

    from stellard_tpu_torch.ops import build, ed25519_cuda, pathq, treehash

    name_power = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(dev)
    t0 = time.perf_counter()
    build.build([ed25519_cuda.LIB, treehash.LIB, pathq.LIB])
    emit("build", seconds=time.perf_counter() - t0)
    return name_power, props.multi_processor_count * INT32_PER_SM_CLOCK * clock_mhz * 1e6


def run_side(dev) -> None:
    """The consensus and tcp phases (``--side T0``, from SideRun), each
    counted on its own; the last line gives their results to the
    parent."""
    name_power, int32_rate = card_and_build(dev)
    consensus = consensus_phase(dev, name_power, int32_rate)
    tcp = tcp_phase(dev, name_power, int32_rate)
    print(json.dumps({"side": {"consensus": consensus, "tcp": tcp}}), flush=True)


def run_side_scenarios(dev) -> None:
    """The scenarios phase (``--side-scenarios T0``, from SideRun),
    counted on its own; the last line gives its result to the parent."""
    name_power, _int32_rate = card_and_build(dev)
    scenarios = scenarios_phase(dev, name_power)
    print(json.dumps({"side": {"scenarios": scenarios}}), flush=True)


def run_tcp_alone(dev) -> None:
    """The tcp phase alone (``--only tcp``): the card, the kernels built
    in this process first, then tcp_phase; no final ok line."""
    name_power, int32_rate = card_and_build(dev)
    print(name_power, flush=True)
    tcp_phase(dev, name_power, int32_rate)


def run_scenarios_alone(dev) -> None:
    """The scenarios phase alone (``--only scenarios``), as run_tcp_alone."""
    name_power, _int32_rate = card_and_build(dev)
    print(name_power, flush=True)
    scenarios_phase(dev, name_power)


def main() -> int:
    global T_IMPORT
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
    args = sys.argv[1:]
    alone = {"tcp": run_tcp_alone, "scenarios": run_scenarios_alone}
    only = alone.get(args[1]) if len(args) == 2 and args[0] == "--only" else None
    sides = {"--side": run_side, "--side-scenarios": run_side_scenarios}
    side = sides.get(args[0]) if len(args) == 2 else None
    if args and not (only or side):
        print("usage: chip_smoke.py [--only tcp|scenarios]", file=sys.stderr)
        return 2
    try:
        if only is not None:
            only(torch.device("cuda", 0))
        elif side is not None:
            T_IMPORT = float(args[1])  # the parent's start: one at_s clock
            side(torch.device("cuda", 0))
        else:
            run(torch.device("cuda", 0))
    except Exception as exc:  # noqa: BLE001 — report the failed phase, exit non-zero
        emit("failed", error=f"{type(exc).__name__}: {exc}")
        import traceback

        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
