"""K2's one-launch design as a numpy model, against the plain scans.

``csrc/forward.cu`` ``plan_kernel`` splits the sorted lanes into runs, a
block each, stages each run in tiles and scans a tile by warps of 32 lanes
over several items, with ballots; a run hands the lanes after it a
summary (its last write and the fwd of its last group), the blocks
compose the earlier blocks' summaries across one grid barrier, and every
write lane decides the ``win`` byte of the write before it.  The model
below follows that decomposition lane for lane, at small tile and run
sizes so that hot keys cross runs, tiles and warps, and is held exactly
to ``plan_scans_plain`` (``fwd`` and ``win``), with every ``win`` byte
written exactly once.
"""

import numpy as np
import pytest
import torch

from deneva_tpu_torch.ops import forward

CONST, FROM_LW, PASS = 0, 1, 2
IDENT = (-1, 0, 0, PASS, 0)          # (lw, lkey, lrank, kind, val)
BIG = 2**31 - 1


def compose(a, b):
    lw = b[:3] if b[0] >= 0 else a[:3]
    if b[3] == CONST:
        tail = (CONST, b[4])
    elif b[3] == PASS:
        tail = a[3:]
    elif a[0] >= 0:
        tail = (CONST, a[2] if a[1] == b[4] else -1)
    else:
        tail = (FROM_LW, b[4])
    return tuple(lw) + tuple(tail)


def as_prefix(a):
    return a if a[3] == CONST else a[:3] + (CONST, -1)


def last_bit(m):
    return m.bit_length() - 1


class Model:
    """plan_kernel at ``warps`` warps of at most ``items`` items a tile
    (as few as cover the tile), runs of ``run`` lanes a block."""

    def __init__(self, words, run, warps, items):
        self.w = [int(v) for v in words]
        self.n, self.run = len(self.w), run
        self.warps, self.items = warps, items
        self.tile = warps * 32 * items
        self.key = [v >> 32 for v in self.w]
        self.rank = [(v >> 1) & 0x7FFFFFFF for v in self.w]
        self.fwd = [None] * self.n
        self.win = [None] * self.n
        self.win_writes = [0] * self.n

    def front(self, s, length):
        items = -(-length // (32 * self.warps))
        span = 32 * items
        wm = [[0] * items for _ in range(self.warps)]
        hm = [[0] * items for _ in range(self.warps)]
        wl, hl = [-1] * self.warps, [-1] * self.warps
        for g in range(self.warps):
            for u in range(items):
                for lane in range(32):
                    li = g * span + 32 * u + lane
                    if li >= length:
                        continue
                    i = s + li
                    if self.w[i] & 1:
                        wm[g][u] |= 1 << lane
                    if i == 0 or self.w[i] >> 1 != self.w[i - 1] >> 1:
                        hm[g][u] |= 1 << lane
                base = g * span + 32 * u
                if wm[g][u]:
                    wl[g] = base + last_bit(wm[g][u])
                if hm[g][u]:
                    hl[g] = base + last_bit(hm[g][u])
        wcarry, last = [], -1
        for g in range(self.warps):
            wcarry.append(last)
            if wl[g] >= 0:
                last = wl[g]
        st = {"s": s, "len": length, "wm": wm, "hm": hm, "wcarry": wcarry,
              "hl": hl, "span": span}
        run = list(IDENT)
        tlw = max(wl)
        if tlw >= 0:
            run[:3] = [s + tlw, self.key[s + tlw], self.rank[s + tlw]]
        tlh = max(hl)
        if tlh >= 0:
            e = self.before(st, tlh)
            k = self.key[s + tlh]
            if e >= 0:
                run[3:] = [CONST, self.rank[s + e] if self.key[s + e] == k
                           else -1]
            else:
                run[3:] = [FROM_LW, k]
        return st, tuple(run)

    def before(self, st, li):
        span = st["span"]
        g, u, lane = li // span, (li % span) // 32, li % 32
        m = st["wm"][g][u] & ((1 << lane) - 1)
        if m:
            return g * span + 32 * u + last_bit(m)
        for v in range(u - 1, -1, -1):
            if st["wm"][g][v]:
                return g * span + 32 * v + last_bit(st["wm"][g][v])
        return st["wcarry"][g]

    def set_win(self, i, v):
        self.win[i] = v
        self.win_writes[i] += 1

    def back(self, pre, st):
        s, length = st["s"], st["len"]

        def resolve(e, k):
            if e >= 0:
                return self.rank[s + e] if self.key[s + e] == k else -1
            return pre[2] if pre[0] >= 0 and pre[1] == k else -1
        part = [resolve(self.before(st, g), self.key[s + g]) if g >= 0 else 0
                for g in st["hl"]]
        for g in range(self.warps):
            earlier = [k for k in range(g) if st["hl"][k] >= 0]
            ch = part[earlier[-1]] if earlier else pre[4]
            cw = st["wcarry"][g]
            for u in range(st["span"] // 32):
                base = g * st["span"] + 32 * u
                wm, hm = st["wm"][g][u], st["hm"][g][u]
                hf, es = [0] * 32, [0] * 32
                for lane in range(32):
                    below = wm & ((1 << lane) - 1)
                    es[lane] = base + last_bit(below) if below else cw
                    li = base + lane
                    if li < length and (hm >> lane) & 1:
                        hf[lane] = resolve(es[lane], self.key[s + li])
                for lane in range(32):
                    li = base + lane
                    if li >= length:
                        continue
                    i = s + li
                    upto = hm & ((2 << lane) - 1)
                    self.fwd[i] = hf[last_bit(upto)] if upto else ch
                    e, k = es[lane], self.key[i]
                    x = (wm >> lane) & 1
                    if not x:
                        self.set_win(i, 0)
                    else:
                        p = s + e if e >= 0 else pre[0]
                        pk = self.key[s + e] if e >= 0 else pre[1]
                        if p >= 0:
                            self.set_win(p, int(pk != k))
                    if i == self.n - 1:
                        lw = i if x else (s + e if e >= 0 else pre[0])
                        if lw >= 0:
                            self.set_win(lw, 1)
                if hm:
                    ch = hf[last_bit(hm)]
                if wm:
                    cw = base + last_bit(wm)

    def plan(self):
        blocks = -(-self.n // self.run)
        runs, staged = [], []
        for b in range(blocks):          # phase 1
            s0, e0 = b * self.run, min(self.n, (b + 1) * self.run)
            mine, tiles = IDENT, []
            for s in range(s0, e0, self.tile):
                st, r = self.front(s, min(self.tile, e0 - s))
                mine = compose(mine, r)
                tiles.append((st, r))
            runs.append(mine)
            staged.append(tiles)
        for b in range(blocks):          # the grid barrier, then phase 2
            pre = IDENT
            for r in runs[:b]:
                pre = compose(pre, r)
            pre = as_prefix(pre)
            for st, r in staged[b]:
                self.back(pre, st)
                pre = as_prefix(compose(pre, r))
        return self


def _words(n, seed, hot=None, hot_writes="every"):
    """Sorted words of n lanes; with ``hot`` = (lo, hi) the lanes [lo, hi)
    all carry one key, their writes as ``hot_writes`` says: in its first
    or last 64 lanes only, none, or throughout."""
    g = np.random.default_rng(seed)
    k = np.sort(g.integers(0, max(2, n // 6), n)).astype(np.int64)
    k[g.random(n) < 0.03] = BIG
    k = np.sort(k)
    r = g.integers(1, max(2, n // 3), n).astype(np.int64)
    w = g.random(n) < 0.5
    if hot is not None:
        lo, hi = hot
        k[:lo] = np.minimum(k[:lo], 99)
        k[lo:hi] = 100
        k[hi:] = np.maximum(k[hi:], 101)
        k = np.sort(k)
        r[lo:hi] = 1 + np.arange(hi - lo)      # the segment keeps its order
        w[lo:hi] = {"first": np.arange(hi - lo) < 64,
                    "last": np.arange(hi - lo) >= hi - lo - 64,
                    "none": np.zeros(hi - lo, bool),
                    "every": g.random(hi - lo) < 0.3}[hot_writes]
    w &= k != BIG
    words = np.sort((k << 32) | (r << 1) | w)
    if hot is not None:
        seg = words[hot[0]:hot[1]]
        assert bool(((seg >> 32) == 100).all())
        assert bool((seg & 1).any()) == (hot_writes != "none")
    return words


def _check(words, run, warps, items):
    m = Model(words, run, warps, items).plan()
    want = forward.plan_scans_plain(torch.from_numpy(words))
    assert m.fwd == want.fwd.tolist()
    assert m.win == [int(v) for v in want.win.tolist()]
    assert all(c == 1 for c in m.win_writes)


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 255, 256, 257, 1000])
@pytest.mark.parametrize("run,warps,items", [(64, 1, 1), (128, 2, 2),
                                             (96, 2, 1), (1000, 2, 2)])
def test_plan_model_matches_plain(n, run, warps, items):
    _check(_words(n, n + run), run, warps, items)


@pytest.mark.parametrize("writes", ["first", "last", "none", "every"])
@pytest.mark.parametrize("run,warps,items", [(128, 2, 2), (256, 1, 2)])
def test_plan_model_hot_key_across_runs(writes, run, warps, items):
    """One key over more than three runs (and several tiles and warps of
    each), its writes only in its first lanes, only in its last, none,
    or throughout."""
    n = 2000
    _check(_words(n, 7, hot=(300, 300 + 4 * run + 37), hot_writes=writes),
           run, warps, items)
