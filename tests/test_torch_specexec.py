"""The port's parallel speculation executor (engine/specexec.py) against
the JAX package's.

- **Port runs of the JAX tests.** Every test of tests/test_parallel_spec.py
  runs again as a twin of its module in which every name of the JAX
  package is the port's (test_torch_consensus.port_twin's reading; the
  port's Node there has both crypto planes on the host, which its
  config otherwise puts on the card). Each run's assertions must hold.
- **Byte identity across the packages.** Each of the JAX tests' adversarial
  workloads (hot-account bursts, a dependent sequence chain, offer
  crossings with cancels, a tec claim with a held promotion, a seeded
  random mix) closed by the port's LedgerMaster on its pool, at workers 2
  and 4 in manual, thread and process modes over both transports, gives
  the ledger hashes and per-transaction results of the JAX package's
  serial close (tolerance zero: these are bytes).
- **Seeded schedules.** The manual mode's seeded schedules give the port
  the JAX package's counters after every close (dispatched, committed,
  retries, validation aborts, serial fallbacks and the rest).
- **The node.** A port Node and a JAX Node on the host, each at [spec]
  workers=1 and at workers=4 mode=process transport=ring, take the close
  phase of chip_smoke.py cut to 2,000 accounts and 2 closes of 512 HTTP
  submits: the same hashes, results digests, splice splits, adoptions,
  persisted rows, store and read answers in all four runs.
"""

from __future__ import annotations

import random
import sys
import types
from pathlib import Path

import pytest

import chip_smoke as cs
import test_parallel_spec as JT
from test_torch_close import JAX_NODE, run_node_closes
from test_torch_consensus import cases

TESTS = Path(__file__).resolve().parent


def twin(name: str, extra: tuple = ()) -> types.ModuleType:
    """tests/<name>.py with every name of the JAX package the port's (its
    source with ``stellard_tpu`` read as ``stellard_tpu_torch``), and each
    (old, new) of ``extra`` replaced after that."""
    twin_name = f"{name}__port"
    if twin_name in sys.modules:
        return sys.modules[twin_name]
    path = TESTS / f"{name}.py"
    src = path.read_text().replace("stellard_tpu.", "stellard_tpu_torch.").replace(
        "from stellard_tpu import", "from stellard_tpu_torch import")
    for old, new in extra:
        assert old in src, old
        src = src.replace(old, new)
    mod = types.ModuleType(twin_name)
    mod.__file__ = str(path)
    sys.modules[twin_name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


# the port's node puts both crypto planes on the card unless told not to
PT = twin("test_parallel_spec", extra=(
    ('signature_backend="cpu",', 'signature_backend="cpu", hash_backend="cpu",'),))


@pytest.mark.parametrize("cname,mname,kw", cases(PT))
def test_port_runs_the_jax_test(cname, mname, kw):
    getattr(getattr(PT, cname)(), mname)(**kw)


def test_every_jax_class_has_a_twin():
    classes = {c for c in vars(JT) if c.startswith("Test")}
    assert classes == {"TestByteIdentity", "TestProcessTransport", "TestRetryMachinery",
                       "TestKillSwitch", "TestFoldOrdering", "TestCloseInfoCounters",
                       "TestCounterSurfaces"}
    assert {p.values[0] for p in cases(PT)} == classes


# -- byte identity and schedules across the packages --------------------------


def random_mix(m, seed: int) -> list:
    """TestByteIdentity.test_randomized_differential's workload for `seed`,
    built with module `m`'s names."""
    rng = random.Random(seed * 1000)
    accounts = [m.KeyPair.from_passphrase(f"pr-{seed}-{i}") for i in range(5)]
    fund = [m.payment(m.MASTER, 1 + i, a.account_id, 3_000_000_000)
            for i, a in enumerate(accounts)]
    seqs = {a.account_id: 1 for a in accounts}
    work = []
    for _ in range(30):
        kp = rng.choice(accounts)
        dest = rng.choice([a.account_id for a in accounts if a is not kp])
        work.append(m.payment(kp, seqs[kp.account_id], dest,
                              rng.choice([210_000_000, 1_000_000])))
        seqs[kp.account_id] += 1
    return [fund, work]


WORKLOADS = {
    "hot_account_burst": lambda m: m.hot_account_burst(),
    "dependent_chain": lambda m: m.dependent_chain(),
    "offer_book": lambda m: m.offer_book(),
    "tec_and_promotion": lambda m: m.tec_and_promotion(),
    "random_mix_2": lambda m: random_mix(m, 2),
}


def run(m, phases, workers: int = 1, mode: str = "manual", seed=None, max_retries: int = 3,
        step_prob: float = 0.6, transport: str = "ring") -> dict:
    """Module `m`'s run_workload (its LedgerMaster, SpecExecutor and
    seeded manual schedule), keeping the executor's counters after every
    close. -> hashes (hex), results, delta_stats, counters per close."""
    lm = m.LedgerMaster()
    ex = None
    if workers > 1:
        ex = lm.spec_executor = m.SpecExecutor(workers=workers, mode=mode,
                                               max_retries=max_retries, transport=transport)
    rng = random.Random(seed)
    lm.start_new_ledger(m.MASTER.account_id, close_time=1000)
    hashes, results, counters = [], [], []
    try:
        for i, phase in enumerate(phases):
            for tx in phase:
                ter, _ok = lm.do_transaction(m.fresh(tx), m.OPEN)
                if ter == m.TER.terPRE_SEQ:
                    lm.add_held_transaction(m.fresh(tx))
                if ex is not None and mode == "manual" and rng.random() < step_prob:
                    spec = getattr(lm.current, "_spec_state", None)
                    session = getattr(spec, "_exec_session", None)
                    if session is not None:
                        cand = [t.index for t in session.tasks if t.state == m.PENDING]
                        if cand:
                            ex.step(session, rng.choice(cand))
                            ex.pump(session)
            closed, res = lm.close_and_advance(2000 + i * 30, 30)
            hashes.append(closed.hash().hex())
            results.append(sorted((txid.hex(), int(ter)) for txid, ter in res.items()))
            if ex is not None:
                counters.append(ex.counters.snapshot())
        return {"hashes": hashes, "results": results, "delta": dict(lm.delta_stats),
                "counters": counters, "json": ex.get_json() if ex is not None else None}
    finally:
        lm.stop_seal_drainer()
        if ex is not None:
            ex.stop()


_SERIAL: dict = {}


def jax_serial(workload: str) -> dict:
    if workload not in _SERIAL:
        _SERIAL[workload] = run(JT, WORKLOADS[workload](JT))
    return _SERIAL[workload]


CONFIGS = [(2, "manual", "ring"), (4, "manual", "ring"), (2, "thread", "ring"),
           (4, "thread", "ring"), (2, "process", "ring"), (2, "process", "pipe"),
           (4, "process", "ring"), (4, "process", "pipe")]


@pytest.mark.parametrize("workers,mode,transport", CONFIGS,
                         ids=[f"{m}{w}-{t}" for w, m, t in CONFIGS])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_port_pool_gives_the_jax_serial_close(workload, workers, mode, transport):
    """The port's pool closes each workload to the JAX package's serial
    hashes and results, with nothing lost: every dispatched transaction
    committed or kept without a record, and no worker lost."""
    want = jax_serial(workload)
    got = run(PT, WORKLOADS[workload](PT), workers=workers, mode=mode, seed=11,
              transport=transport)
    assert got["hashes"] == want["hashes"]
    assert got["results"] == want["results"]
    j = got["json"]
    assert (j["workers"], j["mode"], j["transport"], j["active"]) == (workers, mode,
                                                                      transport, True)
    assert j["dispatched"] == j["committed"] + j["no_records"]
    assert j["worker_deaths"] == j["committer_errors"] == 0
    if mode == "process" and transport == "ring":
        assert j["ring"]["msgs_sent"] > 0 and j["ring"]["torn_slots"] == 0


SCHEDULES = [
    # (workers, seed, max_retries, step_prob)
    (2, 11, 3, 0.6), (4, 11, 3, 0.6), (4, 99, 3, 0.6), (4, 3, 0, 0.6), (4, 3, 2, 0.6),
    (2, 1, 3, 0.0), (2, 23, 3, 1.0),
]


@pytest.mark.parametrize("workers,seed,max_retries,step_prob", SCHEDULES,
                         ids=[f"w{w}-s{s}-r{r}-p{p}" for w, s, r, p in SCHEDULES])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_seeded_schedules_give_the_jax_trajectories(workload, workers, seed, max_retries,
                                                    step_prob):
    """One seeded manual schedule through both packages: the same hashes,
    results and splice counts, and the same executor counters after every
    close."""
    kw = dict(workers=workers, mode="manual", seed=seed, max_retries=max_retries,
              step_prob=step_prob)
    jax = run(JT, WORKLOADS[workload](JT), **kw)
    port = run(PT, WORKLOADS[workload](PT), **kw)
    assert port["hashes"] == jax["hashes"] == jax_serial(workload)["hashes"]
    assert port["results"] == jax["results"]
    assert port["delta"] == jax["delta"]
    assert port["counters"] == jax["counters"]
    assert port["json"] == jax["json"]


def test_the_schedules_exercise_the_abort_paths():
    """Anti-vacuity: over the seeded schedules above, the manual mode
    aborts, retries, falls back to serial and forces a drain."""
    seen = {"validation_aborts": 0, "retries": 0, "serial_fallbacks": 0, "drains_forced": 0}
    for workers, seed, max_retries, step_prob in SCHEDULES:
        j = run(PT, WORKLOADS["hot_account_burst"](PT), workers=workers, seed=seed,
                max_retries=max_retries, step_prob=step_prob)["json"]
        for k in seen:
            seen[k] += j[k]
    assert all(v > 0 for v in seen.values()), seen


# -- the node ------------------------------------------------------------------

NODE_SIZES = dict(n_accounts=2000, n_senders=64, n_closes=2, per_close=512, seed=5)
# both packages' nodes with their crypto planes on the host (the JAX
# node's config of tests/test_torch_close.py, which the port's parses too)
POOL = "\n[spec]\nworkers=4\nmode=process\ntransport=ring\n"


@pytest.fixture(scope="module")
def node_runs(tmp_path_factory):
    wl = cs.close_workload(**NODE_SIZES)
    tmp = tmp_path_factory.mktemp("spec_nodes")
    out = {}
    for root in ("stellard_tpu", "stellard_tpu_torch"):
        for label, extra in (("serial", ""), ("pool", POOL)):
            res = run_node_closes(root, wl, tmp / f"{root}-{label}", JAX_NODE + extra)
            ex = res["node"].spec_executor
            res["spec"] = ex.get_json()
            res["exit_codes"] = [w.proc.exitcode for w in ex._procs]
            out[root, label] = res
    return out


def test_node_pool_closes_equal_across_packages_and_worker_counts(node_runs):
    keys = ("hash", "digest", "close_digest", "delta", "open_ters", "close_ters")
    ref = node_runs["stellard_tpu", "serial"]
    for run_key, res in node_runs.items():
        assert [{k: c[k] for k in keys} for c in res["closes"]] == \
            [{k: c[k] for k in keys} for c in ref["closes"]], run_key
        assert res["start"] == ref["start"] and res["stream"] == ref["stream"], run_key
        assert res["reads"]["digests"] == ref["reads"]["digests"], run_key
        assert res["persist"].digests == ref["persist"].digests, run_key
        assert res["store"] == ref["store"], run_key
    # anti-vacuity: each close spliced speculated records
    for c in ref["closes"]:
        assert c["delta"]["spliced"] > 0


def test_node_pool_ran_and_stopped_clean(node_runs):
    """The pool nodes of both packages speculated every submit on their
    four workers over the rings, lost nothing, and their workers exited
    0 at Node.stop(); the serial nodes kept the inline path."""
    for root in ("stellard_tpu", "stellard_tpu_torch"):
        serial, pool = node_runs[root, "serial"]["spec"], node_runs[root, "pool"]["spec"]
        assert not serial["active"] and serial["dispatched"] == 0
        assert (pool["workers"], pool["mode"], pool["transport"]) == (4, "process", "ring")
        assert pool["dispatched"] == pool["committed"] > 0
        assert all(pool[k] == 0 for k in cs.SPEC_BROKEN), pool
        assert pool["ring"]["torn_slots"] == 0
        assert node_runs[root, "pool"]["exit_codes"] == [0] * 4
        for c in node_runs[root, "pool"]["closes"]:
            assert c["spec"]["dispatched"] == c["spec"]["committed"] > 0
        assert node_runs[root, "serial"]["closes"][0]["spec"]["dispatched"] == 0
    assert node_runs["stellard_tpu_torch", "pool"]["closes"][0]["spec_drain_ms"] >= 0
