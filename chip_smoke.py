#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stellard_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the ledger close's device plane through the entry points a node
calls, at the sizes a close really has, and checks every result:

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
5. times    — every kernel against its plain version again, exactly, at
              the shapes the main path gave it: K1 on both flood
              chunks, K2 on every leaf of the state and transaction
              trees, K3 on the state tree's widest inner level; each
              kernel and plain version timed with CUDA events on those
              inputs, with its bound.

Launch counts are zeroed just before phases 3-4 and read just after, so
the kernels line shows the launches of the main path alone. Any failed
check exits non-zero without the final line. Without a CUDA device, or
without the package beside it, the script exits non-zero at once.
"""

from __future__ import annotations

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

# the least 32-bit integer operations per unit of work, counted from the
# kernels' source. A 64x64->128-bit product is 4 32x32->64 partial
# products of 2 IMADs each. A radix-2^51 field multiply needs 25 such
# products and a squaring 15 (5 squares and 10 doubled cross products):
# >= 200 and >= 120 multiply ops, their adds and carries not counted.
# A SHA-512 block, with 3-input logic (LOP3), 3-input adds (IADD3) and
# funnel shifts, each one op per 32-bit half: a round is Sigma0 + Sigma1 (3
# rotates + 1 xor3 = 8 each), ch and maj (2 each), t1's 5-term add (4),
# a's 3-term add and e's add (2 each) = 28; a schedule step is sigma0 +
# sigma1 (8 each) and a 4-term add (4) = 20; the final state adds 16
FE_MUL_OPS = 25 * 4 * 2
FE_SQ_OPS = 15 * 4 * 2
SHA_BLOCK_OPS = 80 * 28 + 64 * 20 + 16
# (field multiplies, field squarings) of K1 per signature, by phase
# (csrc/ed25519_verify.cu). The chain to a^(2^250-1) squares 249 times.
CHAIN_250 = (10, 249)
# y^2, v, v^3, v^7, x, v*x^2, T; pow_p58 is the chain, 2 squarings and
# a multiply (the conditional multiply by sqrt(-1) is not counted)
DECODE = (8 + CHAIN_250[0] + 1, 4 + CHAIN_250[1] + 2)
# -A cached, 7 doublings (4M + 4S), 7 cached additions (8M), 15 cached
TABLE = (1 + 7 * 4 + 7 * 8 + 15, 7 * 4)
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
    decode stop after the decode; the walk adds once per nonzero
    nibble."""
    import numpy as np

    from stellard_tpu_torch.ops import ed25519_ref as ref

    sc = np.asarray(batch["s_canonical"], bool)
    a = np.asarray(batch["a_words"]).astype("<u4").tobytes()
    decodes = np.array([
        bool(sc[i]) and ref.pt_decompress(a[32 * i : 32 * i + 32]) is not None
        for i in range(len(sc))
    ])
    s = np.asarray(batch["s_bytes"])
    h = np.asarray(batch["h_bytes"])
    nonzero = ((s & 0xF) != 0).sum(1) + ((s >> 4) != 0).sum(1)
    nonzero += ((h & 0xF) != 0).sum(1) + ((h >> 4) != 0).sum(1)
    return (int(sc.sum()) * fe_ops(DECODE)
            + int(decodes.sum()) * (fe_ops(TABLE) + fe_ops(WALK_DOUBLES) + fe_ops(ENCODE))
            + int(nonzero[decodes].sum()) * fe_ops(ADD))


def bound_ms(ops: float, nbytes: float, int32_rate: float) -> tuple[float, str]:
    t_ops = ops / int32_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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

    # 5. K3 against plain, and times -----------------------------------------
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
            chunk_host = host
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
    k1_err = max(k1_err, k1_main_err)
    k1_b, k1_by = bound_ms(k1_ops(chunk_host), 130 * CHUNK, int32_rate)

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
             launches=launches["ed25519_verify"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_b, bound_by=k1_by,
             library_ms=None),
        dict(name="sha512_masked", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/ops/treehash_jax.py:49",
             launches=launches["sha512_masked"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_b, bound_by=k2_by,
             library_ms=None),
        dict(name="tree_inner_level", route="cuda",
             source="stellard_tpu_torch/csrc/sha512.cu",
             replaces="stellard_tpu/parallel/mesh.py:149",
             launches=launches["tree_inner_level"], max_abs_err=k3_err,
             ms=k3_ms, plain_ms=k3_plain_ms, bound_ms=k3_b, bound_by=k3_by,
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(name_power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


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
