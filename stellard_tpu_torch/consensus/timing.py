"""Consensus timing rules.

Reference: src/ripple_app/ledger/LedgerTiming.{h,cpp}. The constants are
protocol-level — every validator must make the same close/agree decisions
from the same inputs or the network splits, so they are reproduced
exactly (LedgerTiming.h:26-84, LedgerTiming.cpp:29-165).

All durations here are plain ints: seconds for intervals/resolutions,
milliseconds where the name says `_ms`.
"""

from __future__ import annotations

__all__ = [
    "LEDGER_IDLE_INTERVAL",
    "LEDGER_VAL_INTERVAL",
    "LEDGER_EARLY_INTERVAL",
    "LEDGER_MIN_CONSENSUS_MS",
    "LEDGER_MIN_CLOSE_MS",
    "LEDGER_GRANULARITY_MS",
    "LEDGER_TIME_ACCURACY",
    "CLOSE_RESOLUTIONS",
    "AV_CT_CONSENSUS_PCT",
    "should_close",
    "have_consensus",
    "next_close_resolution",
    "avalanche_threshold",
]

# ledger may sit idle this many seconds before an (empty) close
LEDGER_IDLE_INTERVAL = 15
# a validation stays "current" this long past its signing time
LEDGER_VAL_INTERVAL = 300
# tolerate validations timestamped up to this far in the future
LEDGER_EARLY_INTERVAL = 180
# minimum consensus participation window (ms)
LEDGER_MIN_CONSENSUS_MS = 3000
# minimum open time before a close may be proposed (ms)
LEDGER_MIN_CLOSE_MS = 2000
# cadence of the consensus timer (ms)
LEDGER_GRANULARITY_MS = 1000
# initial close-time resolution (seconds)
LEDGER_TIME_ACCURACY = 30
# resolution is re-examined on these ledger-seq strides
LEDGER_RES_INCREASE = 8
LEDGER_RES_DECREASE = 1

# close-time resolution ladder (seconds); first/last repeated so the
# increase/decrease walk can never run off the end
# (reference: LedgerTimeResolution[], LedgerTiming.cpp:29)
CLOSE_RESOLUTIONS = (10, 10, 20, 30, 60, 90, 120, 120)

# avalanche vote-switching schedule: once `time_pct` (percent of the
# previous round's duration) has elapsed, a disputed tx needs `vote_pct`
# percent of proposers voting yes for us to vote yes
# (reference: AV_* in LedgerTiming.h:70-84)
AV_INIT_CONSENSUS_PCT = 50
AV_MID_CONSENSUS_TIME = 50
AV_MID_CONSENSUS_PCT = 65
AV_LATE_CONSENSUS_TIME = 85
AV_LATE_CONSENSUS_PCT = 70
AV_STUCK_CONSENSUS_TIME = 200
AV_STUCK_CONSENSUS_PCT = 95

# percent of proposers that must agree on a (rounded) close time
AV_CT_CONSENSUS_PCT = 75

# percent agreement (including ourselves) that locks in consensus
CONSENSUS_PCT = 80
# percent of target proposers already closed that forces our close
CLOSE_PROPOSERS_PCT = 75


def should_close(
    any_transactions: bool,
    target_proposers: int,
    proposers_closed: int,
    since_last_close_ms: int,
    open_ms: int,
    idle_interval: int = LEDGER_IDLE_INTERVAL,
) -> bool:
    """Decide whether the open ledger should close now
    (reference: ContinuousLedgerTiming::shouldClose, LedgerTiming.cpp:34-91).

    `target_proposers` is how many proposers we expect this round
    (last round's count); `proposers_closed` is how many have already
    proposed a close for this ledger.
    """
    if target_proposers > 0 and (
        proposers_closed * 100
    ) // target_proposers >= CLOSE_PROPOSERS_PCT:
        return True  # most of the network has closed already — follow
    if open_ms <= LEDGER_MIN_CLOSE_MS:
        return False  # give submitters a minimum window
    if not any_transactions:
        return since_last_close_ms >= idle_interval * 1000
    return True


def have_consensus(
    target_proposers: int,
    current_proposers: int,
    current_agree: int,
    since_consensus_ms: int = 10**9,
    prev_round_ms: int = 0,
) -> bool:
    """Decide whether our position has won
    (reference: ContinuousLedgerTiming::haveConsensus,
    LedgerTiming.cpp:95-141). `current_agree` counts proposers whose
    position matches ours; we count ourselves on top.

    When fewer than 3/4 of last round's proposers are present we only
    *slow down* (wait one previous-round-time plus the minimum window, as
    the reference does) — a hard wait would deadlock the network forever
    after a validator crash, since the straggler count never recovers
    until a round completes.
    """
    # truncating division exactly as the reference: for 3 proposers the
    # bar is 2, so a healthy small net (2 of 3 peers present) does NOT
    # slow down — only a real shortfall does
    if current_proposers < (target_proposers * 3) // 4 and (
        since_consensus_ms < prev_round_ms + LEDGER_MIN_CONSENSUS_MS
    ):
        return False  # give stragglers one extra round-time to appear
    in_consensus = (current_agree * 100 + 100) // (current_proposers + 1)
    return in_consensus >= CONSENSUS_PCT


def next_close_resolution(
    previous_resolution: int, previous_agree: bool, ledger_seq: int
) -> int:
    """Adapt close-time resolution: tighten while the network agrees on
    close times, loosen when it doesn't
    (reference: getNextLedgerTimeResolution, LedgerTiming.cpp:144-165).
    """
    assert ledger_seq > 0
    i = CLOSE_RESOLUTIONS.index(previous_resolution, 1)
    if not previous_agree and ledger_seq % LEDGER_RES_DECREASE == 0:
        return CLOSE_RESOLUTIONS[i + 1]  # coarser
    if previous_agree and ledger_seq % LEDGER_RES_INCREASE == 0:
        return CLOSE_RESOLUTIONS[i - 1]  # finer
    return previous_resolution


def avalanche_threshold(time_pct: int) -> int:
    """Required yes-percentage for a disputed tx given round progress
    (percent of the previous round's converge time)
    (reference: DisputedTx::updateVote, DisputedTx.cpp)."""
    if time_pct < AV_MID_CONSENSUS_TIME:
        return AV_INIT_CONSENSUS_PCT
    if time_pct < AV_LATE_CONSENSUS_TIME:
        return AV_MID_CONSENSUS_PCT
    if time_pct < AV_STUCK_CONSENSUS_TIME:
        return AV_LATE_CONSENSUS_PCT
    return AV_STUCK_CONSENSUS_PCT
