"""Pathfinder: search for viable payment paths.

Reference: src/ripple_app/paths/Pathfinder.cpp (937 LoC). Search is
driven by the cost-ranked path-class table (`initPathTable`,
Pathfinder.cpp:872): every payment classifies into one of five types by
its source/destination currencies, and each type owns an ordered list
of (cost, shape) entries where a shape is a node-class string — s =
source, a = account hop, b = any order book, x = book to XRP, f = book
into the destination currency, d = destination. Shapes whose cost
exceeds the caller's search level are skipped (PATH_SEARCH knobs,
ripple_core/functional/Config.h:62-65), which is how the reference
scales search effort under load. Shape expansion mirrors
`Pathfinder::addLink` (Pathfinder.cpp:631+): account hops are gated on
line credit / authorization / no-ripple pairs and ranked by the
`getPathsOut` utility count with the 10-per-node (50 from the source)
candidate caps; book hops never revisit an (currency, issuer) node and
append the book issuer's account node.

Candidates found by the shape search are then validated by actually
trial-executing each strand on a sandboxed LedgerEntrySet — the flow
engine is its own liquidity oracle, which replaces the reference's
separate PathState liquidity estimation.
"""

from __future__ import annotations

from typing import Optional

from ..engine.flags import (
    lsfHighAuth,
    lsfHighNoRipple,
    lsfLowAuth,
    lsfLowNoRipple,
    lsfRequireAuth,
)
from ..protocol.formats import LedgerEntryType
from ..protocol.sfields import (
    sfBalance,
    sfFlags,
    sfHighLimit,
    sfLedgerEntryType,
    sfLowLimit,
)
from ..protocol.stamount import ACCOUNT_ZERO, STAmount
from ..protocol.stobject import PathElement
from ..state import indexes
from ..state.entryset import LedgerEntrySet
from .flow import CURRENCY_XRP, PathError, execute_strand, plan_strand
from .orderbook import OrderBookDB

__all__ = [
    "find_paths",
    "build_path_set",
    "account_lines_of",
    "PATH_SEARCH_DEFAULT",
    "PATH_SEARCH_FAST",
    "PATH_SEARCH_MAX",
]

# Search-level knobs (reference: Config.h:62-65 DEFAULT_PATH_SEARCH*).
PATH_SEARCH_FAST = 2
PATH_SEARCH_DEFAULT = 7
PATH_SEARCH_MAX = 10

# The path-class table (reference: Pathfinder::initPathTable,
# Pathfinder.cpp:872-934). Keys are payment types (classified from the
# source asset and destination amount); rows are (cost, shape).
_PATH_TABLE: dict[str, list[tuple[int, str]]] = {
    "xrp_to_xrp": [],  # default path only
    "xrp_to_iou": [
        (1, "sfd"), (3, "sfad"), (5, "sfaad"), (6, "sbfd"),
        (8, "sbafd"), (9, "sbfad"), (10, "sbafad"),
    ],
    "iou_to_xrp": [
        (1, "sxd"), (2, "saxd"), (6, "saaxd"), (7, "sbxd"),
        (8, "sabxd"), (9, "sabaxd"),
    ],
    "iou_to_same": [
        (1, "sad"), (1, "sfd"), (4, "safd"), (4, "sfad"), (5, "saad"),
        (5, "sxfd"), (6, "sxfad"), (6, "safad"), (6, "saxfd"),
        (6, "saxfad"), (7, "saaad"),
    ],
    "iou_to_iou": [
        (1, "sfad"), (1, "safd"), (3, "safad"), (4, "sxfd"),
        (5, "saxfd"), (5, "sxfad"), (6, "saxfad"), (7, "saafd"),
        (8, "saafad"), (9, "safaad"),
    ],
}

# Candidate caps per expansion node (reference: Pathfinder::addLink
# count clamp — 10 per interior node, 50 fanning out of the source).
_MAX_CANDIDATES = 10
_MAX_CANDIDATES_SOURCE = 50
# Global safety bounds: the trial-execution liquidity check costs a
# sandboxed strand run per candidate, so the complete set and the live
# partial frontier are both capped (the reference bounds its cheaper
# PathState estimation with filterPaths instead).
_MAX_COMPLETE = 128
_MAX_PARTIALS = 512


def account_lines_of(
    les: LedgerEntrySet, account_id: bytes, currency: Optional[bytes] = None
) -> list[dict]:
    """[{peer, currency, balance(signed, our perspective), our_limit,
    peer_limit, no_ripple(peer side)}] from the owner directory."""
    out = []
    for entry_idx in les.dir_entries(indexes.owner_dir_index(account_id)):
        sle = les.peek(entry_idx)
        if sle is None or sle.get(sfLedgerEntryType) != int(
            LedgerEntryType.ltRIPPLE_STATE
        ):
            continue
        low = sle[sfLowLimit]
        high = sle[sfHighLimit]
        if currency is not None and low.currency != currency:
            continue
        is_low = low.issuer == account_id
        peer = high.issuer if is_low else low.issuer
        balance = sle[sfBalance]
        bal = balance if is_low else -balance
        flags = sle.get(sfFlags, 0)
        peer_no_ripple = bool(
            flags & (lsfHighNoRipple if is_low else lsfLowNoRipple)
        )
        our_no_ripple = bool(
            flags & (lsfLowNoRipple if is_low else lsfHighNoRipple)
        )
        # Has the enumerated account authorized the peer to hold its
        # issuances? (relevant when the enumerated account is an
        # lsfRequireAuth issuer; reference: RippleState::getAuth via the
        # addLink credit gate)
        auth_by_us = bool(flags & (lsfLowAuth if is_low else lsfHighAuth))
        out.append(
            {
                "peer": peer,
                "currency": low.currency,
                "balance": bal,
                "our_limit": low if is_low else high,
                "peer_limit": high if is_low else low,
                "peer_no_ripple": peer_no_ripple,
                "our_no_ripple": our_no_ripple,
                "auth_by_us": auth_by_us,
            }
        )
    return out


def _source_assets(
    les: LedgerEntrySet, src: bytes, send_max: Optional[STAmount]
) -> list[tuple[bytes, bytes]]:
    """(currency, issuer) pairs the source can spend. A SendMax pins the
    spendable asset (reference: Pathfinder only considers the SendMax
    currency when present)."""
    if send_max is not None:
        if send_max.is_native:
            return [(CURRENCY_XRP, ACCOUNT_ZERO)]
        if send_max.issuer != src:
            return [(send_max.currency, send_max.issuer)]
        # SendMax issuer == source account: "any of my <currency>" —
        # every line the source holds in that currency is spendable
        # (reference: STAmount issuer-of-self convention in RippleCalc)
        out = [
            (line["currency"], line["peer"])
            for line in account_lines_of(les, src, send_max.currency)
            if line["balance"].signum() > 0 or line["peer_limit"].signum() > 0
        ]
        return out or [(send_max.currency, src)]
    assets: list[tuple[bytes, bytes]] = [(CURRENCY_XRP, ACCOUNT_ZERO)]
    for line in account_lines_of(les, src):
        if line["balance"].signum() > 0 or line["peer_limit"].signum() > 0:
            assets.append((line["currency"], line["peer"]))
    return assets


class _Partial:
    """One incomplete path during shape expansion: the elements emitted
    so far plus the node the path currently ends on (reference: the
    STPath + pathEnd pair addLink works from)."""

    __slots__ = (
        "elems", "end_acct", "end_cur", "end_iss", "no_ripple_in", "seen",
    )

    def __init__(self, elems, end_acct, end_cur, end_iss, no_ripple_in,
                 seen):
        self.elems: tuple[PathElement, ...] = elems
        self.end_acct = end_acct
        self.end_cur = end_cur
        self.end_iss = end_iss
        # did the account we're standing on set NoRipple on the link we
        # entered through? (reference: Pathfinder::isNoRippleOut pairs
        # this with the out-link's flag)
        self.no_ripple_in = no_ripple_in
        # (account, currency, issuer) triples of visited path nodes
        # (reference: STPath::hasSeen) — the same ACCOUNT may be
        # revisited in a different currency, which is what lets a path
        # continue THROUGH the destination in the wrong currency and
        # still complete later
        self.seen: frozenset = seen


class _Search:
    """Shape-table expansion over one ledger (reference:
    Pathfinder::getPaths / addLink / getPathsOut). One instance per
    find_paths call; caches line walks, paths-out counts, and expanded
    shape prefixes (the reference's mPaths memo) across shapes."""

    def __init__(self, les, books, src, dst, dst_amount):
        self.les = les
        self.books = books
        self.src = src
        self.dst = dst
        self.c_d = dst_amount.currency
        self.dst_native = dst_amount.is_native
        self._lines: dict[bytes, list[dict]] = {}
        self._po: dict[tuple[bytes, bytes], int] = {}
        self._auth: dict[bytes, bool] = {}
        self._prefix: dict[tuple, list[_Partial]] = {}
        # path key -> (elements, source asset) — uniqued completes
        # (reference: mCompletePaths.addUniquePath)
        self.complete: dict[tuple, tuple[list[PathElement], tuple]] = {}

    # -- caches ---------------------------------------------------------

    def lines_of(self, acct: bytes, currency: bytes) -> list[dict]:
        all_lines = self._lines.get(acct)
        if all_lines is None:
            all_lines = account_lines_of(self.les, acct)
            self._lines[acct] = all_lines
        return [l for l in all_lines if l["currency"] == currency]

    def _requires_auth(self, acct: bytes) -> bool:
        cached = self._auth.get(acct)
        if cached is None:
            sle = self.les.peek(indexes.account_root_index(acct))
            cached = bool(
                sle is not None and sle.get(sfFlags, 0) & lsfRequireAuth
            )
            self._auth[acct] = cached
        return cached

    @staticmethod
    def _has_credit(line: dict, require_auth: bool) -> bool:
        """Can value ripple from the enumerated account to this peer?
        (reference: addLink's 'path has no credit' gate)"""
        bal = line["balance"]
        if bal.signum() > 0:
            return True
        peer_limit = line["peer_limit"]
        if peer_limit.signum() <= 0:
            return False
        if (-bal) >= peer_limit:
            return False
        if require_auth and not line["auth_by_us"]:
            return False
        return True

    def paths_out(self, currency: bytes, acct: bytes) -> int:
        """Utility rank for candidate account hops (reference:
        Pathfinder::getPathsOut — viable out-line count, destination
        lines in the destination currency weighted 10000)."""
        key = (currency, acct)
        cached = self._po.get(key)
        if cached is not None:
            return cached
        if self.les.peek(indexes.account_root_index(acct)) is None:
            self._po[key] = 0
            return 0
        require_auth = self._requires_auth(acct)
        count = 0
        for line in self.lines_of(acct, currency):
            if not self._has_credit(line, require_auth):
                continue
            if currency == self.c_d and line["peer"] == self.dst:
                count += 10000
            elif line["peer_no_ripple"]:
                pass  # not a useful path out
            else:
                count += 1
        self._po[key] = count
        return count

    # -- completion -----------------------------------------------------

    def _add_complete(self, elems: tuple, asset: tuple) -> None:
        if len(self.complete) >= _MAX_COMPLETE:
            return
        key = (
            tuple((e.account, e.currency, e.issuer) for e in elems),
            asset,
        )
        if key not in self.complete and elems:
            self.complete[key] = (list(elems), asset)

    # -- expansion steps ------------------------------------------------

    def _add_accounts(
        self, partials: list[_Partial], asset: tuple, last: bool
    ) -> list[_Partial]:
        out: list[_Partial] = []
        for p in partials:
            if p.end_cur == CURRENCY_XRP:
                # an account step on XRP can only be the destination
                # (reference: addLink afADD_ACCOUNTS bOnSTR branch)
                if self.dst_native and p.elems:
                    self._add_complete(p.elems, asset)
                continue
            require_auth = self._requires_auth(p.end_acct)
            cands: list[tuple[int, bytes, dict]] = []
            for line in self.lines_of(p.end_acct, p.end_cur):
                peer = line["peer"]
                if (peer, p.end_cur, peer) in p.seen:
                    continue
                if not self._has_credit(line, require_auth):
                    continue
                if p.no_ripple_in and line["our_no_ripple"]:
                    continue  # can't ripple through a NoRipple pair
                if peer == self.dst:
                    if p.end_cur == self.c_d:
                        if p.elems:
                            self._add_complete(p.elems, asset)
                    elif not last:
                        # destination in the wrong currency: always
                        # worth continuing through (reference: the
                        # 100000-priority candidate)
                        cands.append((100000, peer, line))
                elif peer == self.src:
                    continue  # going back to the source is bad
                elif not last:
                    rank = self.paths_out(p.end_cur, peer)
                    if rank:
                        cands.append((rank, peer, line))
            if last or not cands:
                continue
            cands.sort(key=lambda c: (-c[0], c[1]))
            cap = (
                _MAX_CANDIDATES_SOURCE
                if p.end_acct == self.src
                else _MAX_CANDIDATES
            )
            for _, peer, line in cands[:cap]:
                out.append(
                    _Partial(
                        p.elems + (PathElement(account=peer),),
                        peer,
                        p.end_cur,
                        peer,
                        line["peer_no_ripple"],
                        p.seen | {(peer, p.end_cur, peer)},
                    )
                )
        return out

    def _add_books(
        self,
        partials: list[_Partial],
        asset: tuple,
        to_xrp: bool,
        dest_only: bool,
    ) -> list[_Partial]:
        out: list[_Partial] = []
        for p in partials:
            for b in sorted(
                self.books.books_taking(p.end_cur, p.end_iss),
                key=lambda b: (b.out_currency, b.out_issuer),
            ):
                if to_xrp and b.out_currency != CURRENCY_XRP:
                    continue
                if dest_only and b.out_currency != self.c_d:
                    continue
                if (b.out_currency, b.out_issuer) == asset:
                    continue  # matchesOrigin: don't convert back
                if b.out_currency == CURRENCY_XRP:
                    xrp_key = (ACCOUNT_ZERO, CURRENCY_XRP, ACCOUNT_ZERO)
                    if xrp_key in p.seen:
                        continue
                    elems = p.elems + (PathElement(currency=CURRENCY_XRP),)
                    if self.dst_native:
                        self._add_complete(elems, asset)
                    else:
                        out.append(
                            _Partial(
                                elems, ACCOUNT_ZERO, CURRENCY_XRP,
                                ACCOUNT_ZERO, False, p.seen | {xrp_key},
                            )
                        )
                    continue
                iss_key = (b.out_issuer, b.out_currency, b.out_issuer)
                if iss_key in p.seen:
                    continue  # already seen this issuer node
                book_el = PathElement(
                    currency=b.out_currency, issuer=b.out_issuer
                )
                if b.out_issuer == self.dst and b.out_currency == self.c_d:
                    self._add_complete(p.elems + (book_el,), asset)
                    continue
                # append the book and its out-issuer's account node
                # (reference: addLink's assembleAdd of the issuer)
                out.append(
                    _Partial(
                        p.elems
                        + (book_el, PathElement(account=b.out_issuer)),
                        b.out_issuer,
                        b.out_currency,
                        b.out_issuer,
                        False,
                        p.seen | {iss_key},
                    )
                )
        return out

    # -- shape driver ---------------------------------------------------

    def run_shape(self, shape: str, asset: tuple) -> None:
        """Expand one shape string left to right, memoizing prefixes so
        'saxfd' reuses the 'saxf' work 'saxfad' did (reference: the
        mPaths map in Pathfinder::getPaths)."""
        c_s, i_s = asset
        for end in range(1, len(shape) + 1):
            prefix = shape[:end]
            memo_key = (asset, prefix)
            if memo_key in self._prefix:
                continue
            cls = prefix[-1]
            if cls == "s":
                # the source node: path expansion starts on the source
                # account for native/self-issued assets, else on the
                # issuer (reference: mSource construction,
                # Pathfinder.cpp:120-125)
                if c_s == CURRENCY_XRP or i_s == self.src:
                    start_acct = self.src
                else:
                    start_acct = i_s
                # seed the seen-set with the start node's triple so the
                # search never loops back through the start issuer in
                # the SAME currency; the currency-aware triple still
                # lets it reappear as a book's out-issuer in another
                # currency (reference: STPath::hasSeen semantics)
                partials = [
                    _Partial(
                        (), start_acct, c_s,
                        i_s if c_s != CURRENCY_XRP else ACCOUNT_ZERO,
                        False, frozenset({(start_acct, c_s, start_acct)}),
                    )
                ]
            else:
                parents = self._prefix[(asset, prefix[:-1])]
                if cls == "a":
                    partials = self._add_accounts(parents, asset, False)
                elif cls == "d":
                    partials = self._add_accounts(parents, asset, True)
                elif cls == "b":
                    partials = self._add_books(parents, asset, False, False)
                elif cls == "x":
                    partials = self._add_books(parents, asset, True, False)
                elif cls == "f":
                    partials = self._add_books(parents, asset, False, True)
                else:
                    raise ValueError(f"unknown path node class {cls!r}")
            # frontier bound: a hostile trust-line graph must not make
            # one RPC call expand without limit
            self._prefix[memo_key] = partials[:_MAX_PARTIALS]


def _payment_type(c_s: bytes, c_d: bytes) -> str:
    if c_s == CURRENCY_XRP and c_d == CURRENCY_XRP:
        return "xrp_to_xrp"
    if c_s == CURRENCY_XRP:
        return "xrp_to_iou"
    if c_d == CURRENCY_XRP:
        return "iou_to_xrp"
    if c_s == c_d:
        return "iou_to_same"
    return "iou_to_iou"


def _candidate_paths(
    les: LedgerEntrySet,
    src: bytes,
    dst: bytes,
    dst_amount: STAmount,
    send_max: Optional[STAmount],
    books: OrderBookDB,
    level: int = PATH_SEARCH_DEFAULT,
) -> list[tuple[list[PathElement], tuple[bytes, bytes]]]:
    """(path, source asset) candidates from the cost-ranked shape table
    (reference: Pathfinder::findPaths' mPathTable walk gated on
    iLevel)."""
    c_d = dst_amount.currency
    search = _Search(les, books, src, dst, dst_amount)
    candidates: list[tuple[list[PathElement], tuple[bytes, bytes]]] = []
    seen: set[tuple] = set()

    # Shape search starts from the SOURCE ACCOUNT with the issuer-of-
    # self placeholder unless a SendMax pins a foreign issuer
    # (reference: mSource construction, Pathfinder.cpp:120-125) — the
    # 'a' step's line walk is what discovers explicit gateway hops.
    if send_max is None:
        search_assets = [(CURRENCY_XRP, ACCOUNT_ZERO)] + sorted(
            {
                (line["currency"], src)
                for line in account_lines_of(les, src)
                if line["balance"].signum() > 0
                or line["peer_limit"].signum() > 0
            }
        )
    elif send_max.is_native:
        search_assets = [(CURRENCY_XRP, ACCOUNT_ZERO)]
    else:
        search_assets = [(send_max.currency, send_max.issuer)]

    for c_s, i_s in search_assets:
        ptype = _payment_type(c_s, c_d)
        for cost, shape in _PATH_TABLE[ptype]:
            if cost > level:
                continue
            search.run_shape(shape, (c_s, i_s))

    # the default path (src → [issuer] → dst) rides along as the empty
    # candidate, probed per concrete holding so the issuer ripple is
    # exact (reference: RippleCalc always tries default paths)
    for c_s, i_s in _source_assets(les, src, send_max):
        if _payment_type(c_s, c_d) == "iou_to_same":
            key = ((), (c_s, i_s))
            if key not in seen:
                seen.add(key)
                candidates.append(([], (c_s, i_s)))

    for elems, asset in search.complete.values():
        key = (
            tuple((e.account, e.currency, e.issuer) for e in elems),
            asset,
        )
        if key not in seen:
            seen.add(key)
            candidates.append((elems, asset))
    return candidates


def find_paths(
    ledger,
    src: bytes,
    dst: bytes,
    dst_amount: STAmount,
    send_max: Optional[STAmount] = None,
    max_paths: int = 4,
    books: Optional[OrderBookDB] = None,
    include_partial: bool = False,
    level: int = PATH_SEARCH_DEFAULT,
    pre_rank=None,
) -> list[dict]:
    """Liquidity-checked alternatives, best quality first:
    [{"paths": [path], "source_amount": STAmount, "delivered": STAmount}]
    (the shape `ripple_path_find` renders; reference:
    Pathfinder::findPaths + getJson). With include_partial, strands that
    deliver only part of the target are appended after the full
    alternatives (for build_path payment construction). `level` bounds
    which shape-table rows are searched (reference: iLevel vs
    CostedPath cost; PATH_SEARCH_FAST for quick answers under load,
    PATH_SEARCH_DEFAULT normally)."""
    les = LedgerEntrySet(ledger)
    # source account must exist; a missing destination only works for a
    # funding-size native delivery (reference: findPaths' sleSrc/sleDest
    # guards, Pathfinder.cpp:149-155)
    if les.peek(indexes.account_root_index(src)) is None:
        return []
    if les.peek(indexes.account_root_index(dst)) is None and not (
        dst_amount.is_native
    ):
        return []
    if books is None:
        books = OrderBookDB.for_ledger(ledger)
    level = max(1, min(int(level), PATH_SEARCH_MAX))
    candidates = _candidate_paths(
        les, src, dst, dst_amount, send_max, books, level=level
    )
    # liquidity-plane hook (paths/plane.py): an estimated-quality
    # pre-pass over the candidate set BEFORE the expensive per-candidate
    # trial executions. Pure reordering never changes output (results
    # re-sort by exact cost below); pruning is the hook's contract to
    # apply only above its floor.
    if pre_rank is not None and candidates:
        candidates = pre_rank(les, candidates)

    results = []
    partials = []
    for path, (a_c, a_i) in candidates:
        try:
            hops = plan_strand(src, dst, dst_amount, a_c, a_i, path)
        except PathError:
            continue
        sandbox = les.duplicate()
        budget = (
            STAmount.from_drops(2**62)
            if a_c == CURRENCY_XRP
            else STAmount.from_iou(a_c, a_i, 10**17, 60)
        )
        try:
            spent, delivered = execute_strand(
                sandbox, src, hops, dst_amount, budget,
                ledger.parent_close_time,
            )
        except PathError:
            continue
        if delivered < dst_amount:
            if delivered.signum() > 0:
                # single strand covers only part of the target: not
                # an RPC "alternative", but a payment combining
                # several such strands may still succeed — kept for
                # build_path_set (reference: Pathfinder keeps
                # partial-liquidity paths for build_path payments)
                partials.append({
                    "paths": [path],
                    "source_amount": spent,
                    "delivered": delivered,
                })
            continue
        results.append(
            {"paths": [path], "source_amount": spent,
             "delivered": delivered, "_currency": a_c}
        )

    def cost_key(r):
        """Exact-rational cost ordering (float rounding must never flip
        two near-equal alternatives — the reference compares exact
        STAmount rates)."""
        from fractions import Fraction

        a = r["source_amount"]
        if a.is_native:
            return Fraction(a.mantissa)
        return Fraction(a.mantissa) * Fraction(10) ** a.offset

    results.sort(key=cost_key)
    # one alternative per source currency, carrying the path SET
    # (reference: RipplePathFind runs findPaths once per source currency
    # and renders one alternative with up to max_paths paths_computed);
    # first-in-cost-order is the alternative's headline source_amount.
    # The DEFAULT path is never rendered (the payment engine always tries
    # it unless tfNoRippleDirect — Payment.do_apply inserts it; reference
    # Pathfinder drops bDefaultPath from paths_computed) but it still
    # anchors the alternative's existence and source_amount quote.
    by_currency: dict[bytes, dict] = {}
    for r in results:
        cur = r.pop("_currency")
        r["paths"] = [p for p in r["paths"] if p]
        g = by_currency.get(cur)
        if g is None:
            by_currency[cur] = r
        elif len(g["paths"]) < max_paths:
            g["paths"].extend(
                p for p in r["paths"] if p not in g["paths"]
            )
    results = list(by_currency.values())
    if include_partial:
        def quality_key(r):
            """Partials rank primarily by how much of the TARGET they
            cover (delivered is always in the dst denomination, so it is
            comparable across strands); delivered-per-spent breaks ties,
            with native spends scaled from drops to whole-STR units so
            an XRP-spending strand is not penalized 10^6x against an
            IOU-spending one (spend-asset values remain a heuristic —
            there is no universal exchange rate to rank with)."""
            from fractions import Fraction

            d, s = r["delivered"], r["source_amount"]
            dv = Fraction(d.mantissa) * Fraction(10) ** (0 if d.is_native else d.offset)
            sv = Fraction(s.mantissa) * Fraction(10) ** (-6 if s.is_native else s.offset)
            return (-dv, -(dv / sv) if sv else Fraction(0))

        partials.sort(key=quality_key)
        # one entry per path SHAPE (the same path probed with several
        # source assets yields duplicates; keep its best-quality probe)
        seen_shapes: set[tuple] = set()
        uniq = []
        for r in partials:
            key = tuple(
                (e.account, e.currency, e.issuer)
                for p in r["paths"]
                for e in p
            )
            if key not in seen_shapes:
                seen_shapes.add(key)
                uniq.append(r)
        head = results[:max_paths]
        return head + uniq[: max_paths - len(head)]
    return results[:max_paths]


def build_path_set(
    ledger,
    src: bytes,
    dst: bytes,
    dst_amount: STAmount,
    send_max: Optional[STAmount] = None,
    max_paths: int = 4,
    level: int = PATH_SEARCH_DEFAULT,
) -> list[list[PathElement]]:
    """Paths to ATTACH to a payment (the JS client's build_path /
    reference Pathfinder usage from TransactionSign): full-liquidity
    alternatives first, then partial-liquidity strands the flow engine
    can combine with the default path to split a delivery no single
    strand covers. The empty default path is excluded — the Payment
    transactor always adds it (unless tfNoDirectRipple)."""
    alts = find_paths(
        ledger, src, dst, dst_amount, send_max=send_max,
        max_paths=max_paths, include_partial=True, level=level,
    )
    out: list[list[PathElement]] = []
    seen: set[tuple] = set()
    for alt in alts:
        for path in alt["paths"]:
            if not path:
                continue  # default path: transactor's job
            key = tuple((e.account, e.currency, e.issuer) for e in path)
            if key not in seen:
                seen.add(key)
                out.append(path)
    return out[:max_paths]
