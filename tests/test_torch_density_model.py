"""K13b's cooperative launch as a numpy model on the CPU, against the plain
conflict density and ``deneva_tpu``'s.

``csrc/audit.cu`` ``density_kernel`` runs the density in one launch of
three phases separated by two grid barriers.  The model keeps the state
the kernel keeps and follows its rules (not its threads):

* Warp task q holds rows [q rpw, q rpw + rpw) of A <= 32 lanes each, row
  r of the task on lanes [r A, r A + A) (rpw = 32 // A); a row of more
  than 32 lanes is a task of its own, walked 32 lanes at a time.  Warp
  gw of the grid takes the tasks gw, gw + nw, ...; the host sizes the
  grid to the tasks and to the occupancy (``fit``).
* A lane's own counts are its row's valid lanes on its bucket (a walk of
  the row's buckets by shuffles), writes and all; in the direct regime a
  warp-group is the warp's valid lanes on one bucket (a match on the
  bucket), kept by its lowest lane.
* Count phase: dense (k <= 8,192, and a block's lanes at least k / 8
  and fewer than 2^16), the grid zeroes every bucket's word and each
  lane that writes or touches adds (write << 16 | touch) into its
  block's table.  Direct (or asked for), the group's lowest lane zeroes
  its bucket's word.  The grid zeroes out[].
* Add phase: dense, one (writes << 32 | touches) add a bucket and block;
  direct, one a warp-group.
* Verdict phase: each valid lane reads its bucket's word, takes out its
  row's own counts, applies  w_oth > 0 | (w & u_oth > 0)  and counts into
  its owner's slot (owners outside [0, P) nowhere) in its block's counts,
  which the block adds to out[].

The histogram and out[] start as garbage: only the phases' own clears
make the result right.  The model must equal ``conflict_density_plain``
and the reference's ``conflict_density`` on both arms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.cc import AccessBatch as JBatch
from deneva_tpu.cc import build_incidence as j_build_incidence
from deneva_tpu.cc import conflict_density as j_density
from deneva_tpu.config import Config as JConfig
from deneva_tpu_torch.cc import AccessBatch, base
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.ops.hashing import bucket_hash, combine_key

DENSE_MAX_K = 8192          # the kernel's kDenseMaxK
SLOT_BITS = 6               # own / group counts of at most 32 lanes


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain density and the model run many small torch ops: one
    intra-op thread keeps them from contending with the other test
    workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(keys_of_lanes):
    """For each of 32 lanes, the mask of lanes with an equal key (a
    ``__match_any_sync``)."""
    out = np.zeros(32, dtype=np.int64)
    for ln, key in enumerate(keys_of_lanes):
        out[ln] = sum(1 << m for m, k2 in enumerate(keys_of_lanes)
                      if k2 == key)
    return out


def _popc(x):
    return bin(int(x)).count("1")


def model_density(arr, owner, k, p, arm, *, threads=512, fit=6,
                  force=None, seed=0):
    """K13b's launch on numpy lanes: int32[p]."""
    b, a = arr["keys"].shape
    bk = bucket_hash(combine_key(torch.from_numpy(arr["table_ids"]),
                                 torch.from_numpy(arr["keys"])),
                     k, family=0).numpy().astype(np.int64)
    wide = a > 32
    rpw = 32 // a if 1 <= a <= 32 else 1
    rows = b if a else 0
    tasks = rows if wide else -(-rows // rpw)
    per_block = threads // 32
    grid = min(fit, max(1, -(-tasks // per_block)))
    block_lanes = -(-tasks // (grid * per_block)) * per_block * \
        (a if wide else 32)
    dense = k <= DENSE_MAX_K and block_lanes < 65536 and \
        8 * block_lanes >= k
    if force is not None:
        dense = force == "dense" and k <= DENSE_MAX_K
    nw = grid * per_block
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 2**63, size=k, dtype=np.uint64)
    out = rng.integers(-9, 9, size=p)

    def read(row, i, inside):
        if not (inside and arr["active"][row] and arr["valid"].flat[i]):
            return dict(v=False, w=False, u=False, bk=-1, o=-1)
        w = bool(arr["is_write"].flat[i])
        u = (not arm) or w or bool(arr["is_read"].flat[i])
        return dict(v=True, w=w, u=u, bk=int(bk.flat[i]),
                    o=int(owner.flat[i]))

    def task(q, c=0):
        """A warp's 32 lanes of task q (chunk c of a wide row), with the
        matches: own counts, group counts, the group's lead."""
        lanes = []
        for ln in range(32):
            if wide:
                s = c * 32 + ln
                lanes.append(read(q, q * a + s, s < a) | dict(r=0))
            else:
                r, pos = ln // a, ln % a
                row = q * rpw + r
                lanes.append(read(row, row * a + pos, r < rpw and row < rows)
                             | dict(r=r))
        same = _groups([(x["r"], x["bk"]) if x["v"] else ("x", ln)
                        for ln, x in enumerate(lanes)])
        peers = _groups([x["bk"] if x["v"] else ("x", ln)
                         for ln, x in enumerate(lanes)])
        wb = sum(1 << ln for ln, x in enumerate(lanes) if x["w"])
        ub = sum(1 << ln for ln, x in enumerate(lanes) if x["u"])
        for ln, x in enumerate(lanes):
            x["own_w"], x["own_u"] = _popc(same[ln] & wb), _popc(same[ln])
            x["sw"], x["su"] = _popc(peers[ln] & wb), _popc(peers[ln] & ub)
            x["lead"] = x["v"] and (peers[ln] & -peers[ln]) == 1 << ln
            for f in ("own_w", "own_u", "sw", "su"):
                assert x[f] < 1 << SLOT_BITS
        return lanes

    def warp_tasks_of(gw):
        for q in range(gw, tasks, nw):
            for c in range(-(-a // 32) if wide else 1):
                yield q, c

    covered = np.zeros(b, dtype=np.int64)
    # count phase: the grid zeroes out[]; each block its P counts
    out[:] = 0
    if dense:
        hist[:] = 0
    tabs = {}
    for blk in range(grid):
        tab = np.zeros(k if dense else 0, dtype=np.int64)
        for gw in range(blk * per_block, (blk + 1) * per_block):
            for q, c in warp_tasks_of(gw):
                for x in task(q, c):
                    if dense and (x["w"] or x["u"]):
                        tab[x["bk"]] += int(x["w"]) << 16 | int(x["u"])
                    elif not dense and x["lead"]:
                        hist[x["bk"]] = 0
                if not wide:
                    rr = np.arange(q * rpw, min(q * rpw + rpw, rows))
                    covered[rr] += 1
                elif c == 0:
                    covered[q] += 1
        if dense:
            # a block's 16-bit fields never carry
            assert ((tab >> 16) < 1 << 16).all()
            assert ((tab & 0xFFFF) < 1 << 16).all()
            tabs[blk] = tab
    assert (covered == (1 if a else 0)).all()
    # grid barrier; add phase
    for blk in range(grid):
        if dense:
            t = tabs[blk]
            nz = np.flatnonzero(t)
            hist[nz] += ((t[nz] >> 16).astype(np.uint64) << np.uint64(32)) \
                | (t[nz] & 0xFFFF).astype(np.uint64)
            continue
        for gw in range(blk * per_block, (blk + 1) * per_block):
            for q, c in warp_tasks_of(gw):
                for x in task(q, c):
                    if x["lead"] and x["sw"] | x["su"]:
                        hist[x["bk"]] += np.uint64(x["sw"] << 32 | x["su"])
    # no count carries into the high word
    live = arr["valid"] & arr["active"][:, None]
    assert all(int(h) & 0xFFFFFFFF < 2**31 for h in hist[np.unique(bk[live])])
    # grid barrier; verdict phase
    for blk in range(grid):
        cnt = np.zeros(p, dtype=np.int64)
        for gw in range(blk * per_block, (blk + 1) * per_block):
            for q, c in warp_tasks_of(gw):
                lanes = task(q, c)
                if wide:
                    # the verdict walks the row again for its own counts
                    row = [read(q, q * a + s, True) for s in range(a)]
                    for x in lanes:
                        eq = [y for y in row if y["v"] and y["bk"] == x["bk"]]
                        x["own_u"] = len(eq)
                        x["own_w"] = sum(y["w"] for y in eq)
                for x in lanes:
                    if not x["v"]:
                        continue
                    h = int(hist[x["bk"]])
                    w_oth = (h >> 32) - x["own_w"]
                    u_oth = (h & 0xFFFFFFFF) - x["own_u"]
                    if (w_oth > 0 or (x["w"] and u_oth > 0)) \
                            and 0 <= x["o"] < p:
                        cnt[x["o"]] += 1
        out += cnt
    return out.astype(np.int32)


def _np_batch(rng, b, a, n_keys):
    keys = rng.integers(0, n_keys, (b, a)).astype(np.int32)
    if a > 1:
        # a txn revisiting its own key
        keys[: b // 4, 1] = keys[: b // 4, 0]
    return dict(table_ids=rng.integers(0, 2, (b, a)).astype(np.int32),
                keys=keys, is_read=rng.random((b, a)) < 0.7,
                is_write=rng.random((b, a)) < 0.5,
                valid=rng.random((b, a)) < 0.9,
                ts=np.arange(b, dtype=np.int32),
                rank=rng.permutation(b).astype(np.int32),
                active=rng.random(b) < 0.85)


def _references(arr, owner, k, p, arm):
    """(plain, reference) density of a numpy batch on one arm."""
    t = AccessBatch(**{f: torch.from_numpy(v) for f, v in arr.items()})
    plain = base.conflict_density_plain(Config(part_cnt=p,
                                               conflict_buckets=k),
                                        t, torch.from_numpy(owner), arm)
    jb = JBatch(**{f: jnp.asarray(v) for f, v in arr.items()})
    inc = j_build_incidence(jb, k, True) if arm else None
    ref = j_density(JConfig(part_cnt=p, conflict_buckets=k), jb,
                    jnp.asarray(owner), inc)
    return plain.numpy(), np.asarray(ref)


def _check(arr, owner, k, p, forces=(None, "direct", "dense"), **kw):
    """The model in the host's regime and in each of ``forces`` against
    the plain version, which is held to the reference, on both arms."""
    for arm in (False, True):
        plain, ref = _references(arr, owner, k, p, arm)
        np.testing.assert_array_equal(plain, ref)
        for force in forces:
            got = model_density(arr, owner, k, p, arm, force=force, **kw)
            np.testing.assert_array_equal(got, plain)


# (b, a, k, p): ragged B, rows within and across a warp, k from 8 to the
# router's 2^18, P up to 1,024; the edge batches reuse these shapes
SHAPES = {1: (37, 1, 8, 1), 10: (101, 10, 8192, 4), 16: (64, 16, 8, 1024),
          17: (45, 17, 1 << 18, 4), 33: (23, 33, 8192, 1024)}


@pytest.mark.parametrize("a", sorted(SHAPES))
def test_model_matches_plain_and_reference(a):
    b, _, k, p = SHAPES[a]
    rng = np.random.default_rng(b * a + p)
    arr = _np_batch(rng, b, a, 40 * b)
    # owners inside and outside [0, P)
    owner = rng.integers(-1, p + 1, (b, a)).astype(np.int32)
    # a grid of few small blocks: warps take tasks past their 4 slots
    _check(arr, owner, k, p, threads=64, fit=2)


@pytest.mark.parametrize("a", [1, 10, 17, 33])
def test_model_edge_batches(a):
    b, _, k, p = SHAPES[a]
    rng = np.random.default_rng(a)
    # every lane invalid: nothing counts, and out[] is still cleared
    arr = _np_batch(rng, b, a, 20)
    arr["valid"][:] = False
    owner = np.zeros((b, a), np.int32)
    for force in (None, "direct", "dense"):
        assert not model_density(arr, owner, k, p, True, threads=64,
                                 fit=3, force=force).any()
    # inactive rows touch nothing
    arr = _np_batch(rng, b, a, 20)
    arr["active"][::2] = False
    _check(arr, owner, k, p, threads=64, fit=3)
    # one hot bucket that every block touches, written in every row
    arr = _np_batch(rng, b, a, 5000)
    arr["keys"][:, 0] = 7
    arr["table_ids"][:, 0] = 0
    arr["is_write"][:, 0] = True
    arr["valid"][:, 0] = True
    arr["active"][:] = True
    owner = (arr["keys"] % max(p, 2) - 1).astype(np.int32)
    _check(arr, owner, k, p, threads=64, fit=4)


def test_model_regime_choice():
    """The host's regime (dense where a block's lanes are at least k / 8,
    else direct) gives the plain answer, one block or many."""
    b, a, k, p = SHAPES[10]
    rng = np.random.default_rng(3)
    arr = _np_batch(rng, b, a, 30)
    owner = (arr["keys"] % p).astype(np.int32)
    for fit in (1, 40):
        _check(arr, owner, k, p, forces=(None,), threads=512, fit=fit)
