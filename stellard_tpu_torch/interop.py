"""Carry data from the JAX package's plain outputs into the port.

Every function takes plain numpy arrays, bytes and ints — what a JAX
``prepare_batch(..., device_put=False)`` returns, or the header fields
and items read off a JAX ledger and its SHAMaps — so this module never
imports ``stellard_tpu``.
"""

from __future__ import annotations

import numpy as np

from .ops.ed25519 import to_tensors
from .state.ledger import Ledger
from .state.shamap import SHAMap, SHAMapItem, TNType
from .utils.device import resolve_device

# the JAX prep's key names on its raw 32-byte wire -> the port's
_KEYS = {
    "a_words": "a_words",
    "r_words": "r_words",
    "s_windows": "s_bytes",
    "h_digits": "h_bytes",
    "s_canonical": "s_canonical",
}


def batch_from_numpy(d: dict, device="cuda") -> dict:
    """A JAX prepare_batch dict (raw wire: S and h as [B, 32] u8) ->
    the port's K1 input tensors on `device`."""
    out = {}
    for src, dst in _KEYS.items():
        arr = np.asarray(d[src])
        if dst in ("s_bytes", "h_bytes") and arr.shape[-1] != 32:
            raise ValueError(
                f"{src}: expected the raw 32-byte wire, got shape {arr.shape}"
            )
        out[dst] = arr
    out["a_words"] = out["a_words"].astype(np.uint32)
    out["r_words"] = out["r_words"].astype(np.uint32)
    out["s_bytes"] = out["s_bytes"].astype(np.uint8)
    out["h_bytes"] = out["h_bytes"].astype(np.uint8)
    out["s_canonical"] = out["s_canonical"].astype(bool)
    return to_tensors(out, resolve_device(device))


def shamap_from_items(items, leaf_type: TNType = TNType.ACCOUNT_STATE,
                      hash_batch=None) -> SHAMap:
    """(key, data, node type) tuples -> the port's SHAMap holding them
    (the tree is canonical in its key set, so insertion order does not
    matter)."""
    m = SHAMap(leaf_type) if hash_batch is None else SHAMap(leaf_type, hash_batch=hash_batch)
    by_type: dict[TNType, list] = {}
    for key, data, t in items:
        by_type.setdefault(TNType(int(t)), []).append(SHAMapItem(bytes(key), bytes(data)))
    for t, group in by_type.items():
        m.bulk_update(group, leaf_type=t)
    return m


# Ledger constructor arguments a header dict may carry (the names of
# state.ledger.parse_header's fields)
_HEADER_ARGS = ("seq", "parent_hash", "tot_coins", "fee_pool", "inflation_seq",
                "close_time", "parent_close_time", "close_resolution", "close_flags")


def ledger_from_items(header: dict, state_items, tx_items=(),
                      hash_batch=None) -> Ledger:
    """A closed ledger of the port from plain values read off another
    ledger: `header` holds the fields ``parse_header`` names (``seq``,
    ``parent_hash``, ``tot_coins``, ...; ``account_hash`` and
    ``tx_hash``, when present, must equal the rebuilt trees' roots), and
    `state_items` / `tx_items` are (key, data, node type) leaves. With
    the same header and leaves its ``hash()`` equals the source
    ledger's."""
    kw = {"hash_batch": hash_batch} if hash_batch is not None else {}
    led = Ledger(
        **{k: header[k] for k in _HEADER_ARGS if k in header},
        state_map=shamap_from_items(state_items, TNType.ACCOUNT_STATE, hash_batch),
        tx_map=shamap_from_items(tx_items, TNType.TX_MD, hash_batch),
        **kw,
    )
    led.closed = True
    for key, m in (("account_hash", led.state_map), ("tx_hash", led.tx_map)):
        if key in header and m.get_hash() != bytes(header[key]):
            raise ValueError(f"{key} of the rebuilt tree differs from the header's")
    return led
