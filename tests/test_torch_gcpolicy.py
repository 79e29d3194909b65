"""The port's collector policy (``utils/gcpolicy.py``): a serving node
and a catch-up replay run the process with the policy's thresholds, a
serving node freezes its start-up heap, and the last holder to let go
puts back what it found. The JAX package has no such policy: it changes
when the collector runs, never a result.
"""

from __future__ import annotations

import gc

import pytest

from stellard_tpu_torch.node.node import Node
from stellard_tpu_torch.utils import gcpolicy
from test_torch_txq import CpuConfig

FOUND = (1234, 11, 12)


@pytest.fixture
def found_thresholds(monkeypatch):
    """The process at FOUND thresholds with nothing frozen and no hold
    (a node an earlier test left serving keeps its own); put back as it
    was after the test."""
    before = gc.get_threshold()
    monkeypatch.setattr(gcpolicy, "_holders", 0)
    monkeypatch.setattr(gcpolicy, "_saved", gcpolicy._saved)
    gc.unfreeze()
    gc.set_threshold(*FOUND)
    try:
        yield
    finally:
        gc.set_threshold(*before)


def test_holds_nest_and_the_last_release_puts_back(found_thresholds):
    gcpolicy.hold()
    assert gc.get_threshold() == gcpolicy.THRESHOLDS and gc.get_freeze_count() == 0
    gcpolicy.hold(freeze=True)
    assert gc.get_freeze_count() > 0
    gcpolicy.release()
    assert gc.get_threshold() == gcpolicy.THRESHOLDS and gc.get_freeze_count() > 0
    gcpolicy.release()
    assert gc.get_threshold() == FOUND and gc.get_freeze_count() == 0


def test_held_block_puts_back_on_error(found_thresholds):
    with pytest.raises(ZeroDivisionError):
        with gcpolicy.held():
            assert gc.get_threshold() == gcpolicy.THRESHOLDS
            1 / 0
    assert gc.get_threshold() == FOUND


def test_a_serving_node_holds_the_policy_until_it_stops(found_thresholds):
    node = Node(CpuConfig(standalone=True)).setup()
    try:
        assert gc.get_threshold() == FOUND  # set up, not serving
        node.serve()
        assert gc.get_threshold() == gcpolicy.THRESHOLDS
        assert gc.get_freeze_count() > 0  # its start-up heap
    finally:
        node.stop()
    assert gc.get_threshold() == FOUND and gc.get_freeze_count() == 0
    node.stop()  # a second stop lets go of nothing more
    assert gc.get_threshold() == FOUND


def test_a_replay_runs_under_the_policy(found_thresholds, monkeypatch):
    from stellard_tpu_torch.node import ledgertools

    seen = []
    monkeypatch.setattr(ledgertools, "_replay_range",
                        lambda *a: seen.append(gc.get_threshold()) or {"ok": True})
    assert ledgertools.replay_range(None, []) == {"ok": True}
    assert seen == [gcpolicy.THRESHOLDS] and gc.get_threshold() == FOUND
