#!/usr/bin/env python3
"""Drive deneva_tpu_torch on one NVIDIA card and hold every kernel to its plain version.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

The deployment is YCSB at the Deneva paper's per-node scale and width:
2^24 rows (Deneva's ``2097152*8`` rows per node, ``Config``'s default),
10 requests per txn, 50% writes, zipf theta 0.9, one partition, in two
table modes: fingerprint (ten uint32 columns, 0.67 GB) and full row
(``sim_full_row``: ten 100-byte fields, 16.8 GB on the card).  Two
paths drive it:

* forwarding — ``CC_ALG=TPU_BATCH`` with ``epoch_batch =
  max_txn_in_flight = 65536`` (K1-K4);
* sweep — ``bench.py``'s OCC comparator: ``CC_ALG=OCC`` (and the NOCC
  oracle) at ``epoch_batch=1024`` over a partial pool of
  ``max_txn_in_flight=100000``, ``conflict_buckets=8192``, dual hashing
  (K4, K5+K6, K7, K8, K10).

Phases (any error or mismatch exits non-zero and prints no result):

1. device    — card name, count, ``nvidia-smi`` name and power limit.
2. build     — nvcc builds every kernel from ``deneva_tpu_torch/csrc``;
               prints the ``-Xptxas -v`` register / shared-memory lines.
3. kernels   — each kernel against its plain PyTorch version on the card,
               exactly, at its path's shapes: K1-K4 at N = 655,360 lanes
               and 2^24 rows (K3 in both modes); K5+K6, K7, K8 at B =
               1024 generated zipf-0.9 txns and K = 8192, K10 over the
               committed write lanes and once at N >= capacity.  Times by
               CUDA events, beside the plain version's, the bound and a
               one-call PyTorch yardstick where there is one.
4. epochs    — per mode and path: 3 epochs through the kernels equal 3
               through the plain versions leaf by leaf; one more kernel
               epoch equals a numpy oracle (forwarding: serial execution
               in rank order; OCC: Kung-Robinson serial validation over
               the same hashed buckets, exact-key conflict freedom of the
               committed set, the serial apply of its writes).
5. simulate  — ``run_simulation`` (warmup 1 s, measure 3 s): TPU_BATCH in
               both modes, OCC and NOCC in fingerprint mode; the
               ``[summary]`` numbers and committed txn/s, the TPU_BATCH /
               OCC ratio (``bench.py``'s ``vs_baseline``); with counts
               zeroed just before each run, every kernel's launches equal
               its per-epoch count on that path (``PATH_LAUNCHES``) times
               the epochs run; OCC must commit and abort.
6. report    — one ``{"kernels": [...]}`` line, then as the last line
               ``{"ok": true, "device": {...}}``.

``--profile`` adds, before the report, a profile of 50 epochs per
forwarding mode and of OCC in fingerprint mode: host and wall time per
epoch, device time by kernel and the device's idle share.

Without a CUDA device, or in a directory without the package, it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = 1 << 24
BATCH = 65536
REQ = 10
THETA = 0.9
OCC_BATCH = 1024                # bench.py's OCC comparator point
OCC_POOL = 100000
BUCKETS = 8192
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory rate
ALU_OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 rate
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor-core rate
THREEFRY_OPS = 120              # integer ops of one 20-round hash
MASK32 = 0xFFFFFFFF

# kernel -> (source, the reference function it replaces)
KERNELS = {
    "K1_sort_lanes": ("deneva_tpu_torch/csrc/forward.cu",
                      "deneva_tpu/ops/forward.py:243"),
    "K2_plan_scans": ("deneva_tpu_torch/csrc/forward.cu",
                      "deneva_tpu/ops/forward.py:191"),
    "K3_forward_execute": ("deneva_tpu_torch/csrc/ycsb.cu",
                           "deneva_tpu/workloads/ycsb.py:78"),
    "K4a_threefry_split": ("deneva_tpu_torch/csrc/prng.cu",
                           "deneva_tpu/engine/step.py:218"),
    "K4b_ycsb_generate": ("deneva_tpu_torch/csrc/ycsb.cu",
                          "deneva_tpu/ops/sampling.py:54"),
    "K5K6_build_incidence": ("deneva_tpu_torch/csrc/conflict.cu",
                             "deneva_tpu/ops/conflict.py:47"),
    "K7_overlap": ("deneva_tpu_torch/csrc/conflict.cu",
                   "deneva_tpu/ops/conflict.py:63"),
    "K8_first_fit": ("deneva_tpu_torch/csrc/conflict.cu",
                     "deneva_tpu/ops/conflict.py:96"),
    "K10_last_writer": ("deneva_tpu_torch/csrc/scatter.cu",
                        "deneva_tpu/ops/scatter.py:33"),
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` by CUDA events.  A
    sleep kernel holds the stream while the host enqueues the calls, so
    the events time the device's work and not the host's launch gaps."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = time.perf_counter() - t
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0, 2 * host * iters + 0.01) * 2e9))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(rec: dict, nbytes: float, ops: float,
          ops_per_s: float = ALU_OPS_PER_S) -> None:
    """The least time the card could take: bytes over the memory rate or
    operations over their peak rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    rec.update(bytes=int(nbytes), ops=int(ops), bound_ms=max(tb, to),
               bound_by="bytes" if tb >= to else "operations")


def config(full: bool, **kw):
    from deneva_tpu_torch.config import Config
    args = [f"--synth_table_size={ROWS}", f"--epoch_batch={BATCH}",
            f"--max_txn_in_flight={BATCH}", f"--req_per_query={REQ}",
            "--write_perc=0.5", "--read_perc=0.5", f"--zipf_theta={THETA}",
            "--cc_alg=TPU_BATCH", f"--sim_full_row={full}",
            "--field_per_tuple=10", "--tup_size=100", "--seed=7"]
    args += [f"--{k}={v}" for k, v in kw.items()]
    return Config.from_args(args)


def occ_config(full: bool, alg: str = "OCC", **kw):
    """bench.py's OCC comparator: YCSB zipf 0.9, 50% writes, 10 requests,
    ``epoch_batch=1024`` over a pool of 100,000 txns, 8192 buckets, dual
    hashing — at 2^24 rows."""
    return config(full, cc_alg=alg, epoch_batch=OCC_BATCH,
                  max_txn_in_flight=OCC_POOL, conflict_buckets=BUCKETS,
                  conflict_exact=True, **kw)


# launches per epoch of each kernel on each path (kernels missing from a
# path's map launch zero times there)
PATH_LAUNCHES = {
    "TPU_BATCH": {"K1_sort_lanes": 1, "K2_plan_scans": 1,
                  "K3_forward_execute": 1, "K4a_threefry_split": 1,
                  "K4b_ycsb_generate": 1},
    # both hash families share one K5+K6 launch
    "OCC": {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
            "K5K6_build_incidence": 1, "K7_overlap": 1, "K8_first_fit": 1,
            "K10_last_writer": 1},
    "NOCC": {"K4a_threefry_split": 1, "K4b_ycsb_generate": 1,
             "K10_last_writer": 1},
}


@contextlib.contextmanager
def plain_path(wl):
    """Route one engine's epochs through the plain PyTorch versions (the
    comparison side of phase 4 and of tests/test_torch_cuda.py; the
    package itself has no such switch).  A kernel added to the main path
    is swapped here."""
    from deneva_tpu_torch.ops import conflict, forward, prng, scatter
    from deneva_tpu_torch.workloads import ycsb
    swaps = [(forward, "sort_lanes", lambda k, r, w: forward.sort_lanes_plain(
                  k, r, w).values),
             (forward, "plan_scans", forward.plan_scans_plain),
             (prng, "split", prng.split_plain),
             (ycsb, "_forward_execute_f0", ycsb._forward_execute_f0_plain),
             (conflict, "hashed_incidence", conflict.hashed_incidence_plain),
             (conflict, "overlap", conflict.overlap_plain),
             (conflict, "first_fit", conflict.first_fit_plain),
             (scatter, "last_writer", scatter.last_writer_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    wl.generate = wl.generate_plain
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        del wl.generate


def max_abs(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# -- numpy oracle (the value law re-derived from its definition) ---------

def np_fingerprint(k, v):
    k = np.asarray(k).astype(np.uint32)
    v = np.asarray(v).astype(np.uint32)
    return ((k * np.uint32(2654435761)) ^ (v * np.uint32(0x9E3779B9))) \
        | np.uint32(1)


def np_bytes(k, v, nb):
    fp = np_fingerprint(k, v)
    i = np.arange(nb, dtype=np.uint32)
    coef = i * np.uint32(2654435761) + np.uint32(0x9E3779B9)
    return (((fp[:, None] * coef) >> np.uint32(13))
            & np.uint32(0xFF)).astype(np.uint8)


def oracle_epoch(eng, state, dev):
    """One kernel epoch checked against serial execution in rank order."""
    from deneva_tpu_torch.workloads.ycsb import TABLE
    full = eng.cfg.sim_full_row
    start = state.db[TABLE].columns["F0"].clone()
    pre = {k: int(state.stats[k]) for k in
           ("read_checksum", "write_cnt", "total_txn_commit_cnt")}
    state = eng.step(state)
    torch.cuda.synchronize()
    keys = state.pool.queries.keys.cpu().numpy().astype(np.int64)
    isw = state.pool.queries.is_write.cpu().numpy()
    seq = state.pool.seq.cpu().numpy().astype(np.int64)
    lk = keys.reshape(-1)
    lw = isw.reshape(-1)
    comp = (lk << 32) | np.repeat(seq, keys.shape[1])
    wc = np.sort(comp[lw])
    rk, rc = lk[~lw], comp[~lw]
    # the latest writer strictly before each read, by binary search
    pos = np.searchsorted(wc, rc, side="left") - 1
    prev = wc[np.maximum(pos, 0)]
    fwd = np.where((pos >= 0) & ((prev >> 32) == rk), prev & MASK32, -1)
    start_rows = start[torch.from_numpy(rk).to(dev)].cpu().numpy()
    if full:
        vals = np.where((fwd >= 0)[:, None],
                        np_bytes(rk, np.maximum(fwd, 0), start.shape[1]),
                        start_rows)
    else:
        vals = np.where(fwd >= 0, np_fingerprint(rk, np.maximum(fwd, 0)),
                        start_rows.view(np.uint32))
    cks = int(vals.astype(np.uint64).sum()) & MASK32
    wkey = wc >> 32
    last = np.r_[wkey[1:] != wkey[:-1], True]
    win_k, win_r = wkey[last], wc[last] & MASK32
    new = np_bytes(win_k, win_r, start.shape[1]) if full \
        else np_fingerprint(win_k, win_r).view(np.int32)
    expect = start
    expect[torch.from_numpy(win_k).to(dev)] = torch.from_numpy(new).to(dev)
    got = state.db[TABLE].columns["F0"]
    if not torch.equal(got, expect):
        fail("oracle: table differs from serial execution in rank order")
    d = {k: (int(state.stats[k]) - pre[k]) & MASK32 for k in pre}
    if d["read_checksum"] != cks:
        fail(f"oracle: checksum {d['read_checksum']} != serial {cks}")
    if d["write_cnt"] != int(lw.sum()) or d["total_txn_commit_cnt"] != BATCH:
        fail(f"oracle: counters {d}")
    return state, int(len(win_k)), int(len(rk))


def np_bucket(keys, family: int, k: int):
    """bucket_hash(combine_key(0, keys), k, family), re-derived in numpy."""
    mult = (2654435761, 2246822519, 3266489917, 668265263)[family]
    with np.errstate(over="ignore"):
        h = np.asarray(keys).astype(np.uint32) * np.uint32(2654435761)
        h ^= np.uint32(mult)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return (h & np.uint32(k - 1)).astype(np.int64)


def occ_oracle_epoch(eng, state, dev):
    """One OCC kernel epoch against Kung-Robinson serial validation in
    rank order over the same hashed buckets, in numpy: every txn the
    sweep decided gets the serial verdict; no two committed txns share an
    exact key that either writes; table rows [0, capacity) equal the
    epoch-start rows with the committed writes applied serially; the
    read checksum, write and commit counts match."""
    import dataclasses

    from deneva_tpu_torch.workloads.ycsb import TABLE
    cfg, be = eng.cfg, eng.backend
    seen = {}

    def capture(cfg_, cc_state, batch, inc):
        v, st = be.validate(cfg_, cc_state, batch, inc)
        seen["batch"], seen["verdict"] = batch, v
        return v, st
    full = cfg.sim_full_row
    start = state.db[TABLE].columns["F0"].clone()
    pre = {k: int(state.stats[k]) for k in
           ("read_checksum", "write_cnt", "total_txn_commit_cnt")}
    eng.backend = dataclasses.replace(be, validate=capture)
    try:
        state = eng.step(state)
    finally:
        eng.backend = be
    torch.cuda.synchronize()
    bt, v = seen["batch"], seen["verdict"]
    keys = bt.keys.cpu().numpy().astype(np.int64)
    isw = bt.is_write.cpu().numpy()
    rank = bt.rank.cpu().numpy()
    act = bt.active.cpu().numpy()
    win, lose = v.commit.cpu().numpy(), v.abort.cpu().numpy()
    b, k = len(rank), cfg.conflict_buckets
    rows = np.repeat(np.arange(b), keys.shape[1])

    def dense(cols, lanes):
        m = np.zeros((b, k), np.float32)
        m[rows[lanes.reshape(-1)], cols.reshape(-1)[lanes.reshape(-1)]] = 1
        return m
    conflict_m = np.ones((b, b), bool)
    lanes = act[:, None] & np.ones_like(isw)
    for f in (0, 1):
        bk = np_bucket(keys, f, k)
        conflict_m &= dense(bk, lanes) @ dense(bk, lanes & isw).T > 0
    admitted = np.zeros(b, bool)
    for i in np.lexsort((np.arange(b), rank)):
        if act[i] and not (conflict_m[i] & admitted).any():
            admitted[i] = True
    decided = win | lose
    if (win & ~admitted).any() or (lose & admitted).any():
        fail("OCC oracle: a decided txn differs from serial validation "
             f"({int((win & ~admitted).sum())} commits, "
             f"{int((lose & admitted).sum())} aborts)")
    committed = win & act
    ck = keys[committed]
    cw = isw[committed]
    # exact keys: no committed j before committed i (by rank, lane) has
    # W_j ∩ (R_i ∪ W_i) ≠ ∅ — a written key's one writer is its last
    # accessor
    pos = np.empty(b, np.int64)
    pos[np.lexsort((np.arange(b), rank))] = np.arange(b)
    lane_pos = np.broadcast_to(pos[committed][:, None], ck.shape)
    for key in np.unique(ck[cw]):
        at = ck == key
        if lane_pos[at & cw].min() != lane_pos[at].max():
            fail(f"OCC oracle: committed txns conflict on key {key}")
    # serial apply in rank order: each written key holds its last writer's
    crank = np.broadcast_to(rank[committed][:, None], ck.shape)
    wk, wr = ck[cw], crank[cw]
    o = np.lexsort((wr, wk))
    wk, wr = wk[o], wr[o]
    last = np.r_[wk[1:] != wk[:-1], True]
    win_k, win_r = wk[last], wr[last]
    new = np_bytes(win_k, win_r, start.shape[1]) if full \
        else np_fingerprint(win_k, win_r).view(np.int32)
    expect = start.clone()
    expect[torch.from_numpy(win_k).to(dev)] = torch.from_numpy(new).to(dev)
    cap = eng.workload.n_rows
    got = state.db[TABLE].columns["F0"]
    if not torch.equal(got[:cap], expect[:cap]):
        fail("OCC oracle: table differs from the serial apply")
    reads = ck[~cw]
    vals = start[torch.from_numpy(reads).to(dev)].cpu().numpy()
    cks = int(vals.astype(np.uint64).sum() if full
              else vals.view(np.uint32).astype(np.uint64).sum()) & MASK32
    d = {k_: (int(state.stats[k_]) - pre[k_]) & MASK32 for k_ in pre}
    if d["read_checksum"] != cks:
        fail(f"OCC oracle: checksum {d['read_checksum']} != serial {cks}")
    if d["write_cnt"] != int(cw.sum()) \
            or d["total_txn_commit_cnt"] != int(committed.sum()):
        fail(f"OCC oracle: counters {d}")
    return state, {"active": int(act.sum()), "commit": int(win.sum()),
                   "abort": int(lose.sum()),
                   "undecided": int((act & ~decided).sum()),
                   "written_keys": int(len(win_k))}


# -- phases ---------------------------------------------------------------

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(f"[card] {card}", flush=True)
    return {"kind": name, "count": count, "card": card}


def phase_build() -> float:
    from deneva_tpu_torch import kernels
    t = time.monotonic()
    kernels.library()
    secs = time.monotonic() - t
    print(f"[build] {secs:.1f} s", flush=True)
    for ln in kernels.ptxas_lines(kernels.build_log):
        print(f"[ptxas] {ln}", flush=True)
    return secs


def phase_kernels(dev, rec: dict, card: str) -> None:
    from deneva_tpu_torch.ops import forward, prng
    from deneva_tpu_torch.workloads import ycsb
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    n = BATCH * REQ
    wl = YCSBWorkload(config(False), device=dev)
    key = prng.key_from_seed(11, dev)

    # K4a
    a, b = prng.split(key), prng.split_plain(key)
    if not torch.equal(a, b):
        fail("K4a split differs from plain")
    rec["K4a_threefry_split"].update(
        max_abs_err=max_abs(a, b), ms=cuda_ms(lambda: prng.split(key)),
        plain_ms=cuda_ms(lambda: prng.split_plain(key)), library_ms=None)
    bound(rec["K4a_threefry_split"], 16 + 32, 2 * THREEFRY_OPS)

    # K4b, at theta 0.9 and theta 0.  Exact: kernel and plain version both
    # take the zipf power as f64 pow rounded to f32 (the off-by-one
    # allowance of the tests is for XLA's f32 pow, which neither matches).
    gk = prng.split(key)[1]
    q, qp = wl.generate(gk, BATCH), wl.generate_plain(gk, BATCH)
    if not torch.equal(q.is_write, qp.is_write):
        fail("K4b write flags differ from plain")
    dk = (q.keys.to(torch.int64) - qp.keys.to(torch.int64)).abs()
    if int(dk.max()) != 0:
        fail(f"K4b zipf keys: {int((dk != 0).sum())} differ from plain, "
             f"max {int(dk.max())}")
    wl0 = YCSBWorkload(config(False, zipf_theta=0.0), device=dev)
    q0, q0p = wl0.generate(gk, BATCH), wl0.generate_plain(gk, BATCH)
    if not (torch.equal(q0.keys, q0p.keys)
            and torch.equal(q0.is_write, q0p.is_write)):
        fail("K4b at theta 0 differs from plain")
    rec["K4b_ycsb_generate"].update(
        max_abs_err=int(dk.max()),
        ms=cuda_ms(lambda: wl.generate(gk, BATCH)),
        plain_ms=cuda_ms(lambda: wl.generate_plain(gk, BATCH), iters=5),
        library_ms=None)
    bound(rec["K4b_ycsb_generate"], 16 + 5 * n, n * (2 * THREEFRY_OPS + 40))

    # K1 on the generated lanes, ranks as the pool stamps them
    k = q.keys.reshape(-1).contiguous()
    r = (1 + torch.arange(BATCH, dtype=torch.int32, device=dev)
         ).repeat_interleave(REQ)
    w = q.is_write.reshape(-1).contiguous()
    words = forward.sort_lanes(k, r, w)
    words_p = forward.sort_lanes_plain(k, r, w).values
    if not torch.equal(words, words_p):
        fail("K1 sorted words differ from plain")
    packed = forward.pack_lanes(k, r, w)
    rec["K1_sort_lanes"].update(
        max_abs_err=max_abs(words, words_p),
        ms=cuda_ms(lambda: forward.sort_lanes(k, r, w)),
        plain_ms=cuda_ms(lambda: forward.sort_lanes_plain(k, r, w)),
        library_ms=cuda_ms(lambda: torch.sort(packed)))
    bound(rec["K1_sort_lanes"], 17 * n, n * np.log2(n))

    # K2
    plan = forward.plan_scans(words)
    plan_p = forward.plan_scans_plain(words)
    err = 0
    for f in ("keys", "rank", "is_read", "is_write", "fwd", "win"):
        x, y = getattr(plan, f), getattr(plan_p, f)
        if not torch.equal(x, y):
            fail(f"K2 plan field {f} differs from plain")
        err = max(err, max_abs(x, y))
    rec["K2_plan_scans"].update(
        max_abs_err=err, ms=cuda_ms(lambda: forward.plan_scans(words)),
        plain_ms=cuda_ms(lambda: forward.plan_scans_plain(words), iters=5),
        library_ms=None)
    bound(rec["K2_plan_scans"], 23 * n, 8 * n)
    print(f"[K2] reads={int(plan.is_read.sum())} "
          f"forwarded={int((plan.is_read & (plan.fwd >= 0)).sum())} "
          f"winners={int(plan.win.sum())}", flush=True)

    # K3, both table modes, on the F0 column at 2^24 rows
    for full in (False, True):
        cfg = config(full, field_per_tuple=1)
        wlm = YCSBWorkload(cfg, device=dev)
        tab = wlm.load()["MAIN_TABLE"]
        f0 = tab.columns["F0"]
        f0p = f0.clone()
        slots = wlm.index.lookup(plan.keys)
        _, cks, wcnt = ycsb._forward_execute_f0(f0, plan, slots,
                                                tab.capacity, mono=True)
        _, cksp, wcntp = ycsb._forward_execute_f0_plain(
            f0p, plan_p, slots, tab.capacity, mono=True)
        if not (torch.equal(f0, f0p) and int(cks) == int(cksp)
                and int(wcnt) == int(wcntp)):
            fail(f"K3 ({'full row' if full else 'fingerprint'}) differs "
                 "from plain")
        err = max(max_abs(f0, f0p), abs(int(cks) - int(cksp)))
        row = f0.shape[1] if full else 4
        gathered = plan.is_read & (plan.fwd < 0)
        n_rows_read = int(torch.unique(slots[gathered]).numel())
        nbytes = 19 * n + row * (n_rows_read + int(plan.win.sum())) + 8
        name = f"K3_forward_execute[{'full_row' if full else 'fingerprint'}]"
        rec[name].update(
            max_abs_err=err,
            ms=cuda_ms(lambda: ycsb._forward_execute_f0(
                f0, plan, slots, tab.capacity, mono=True)),
            plain_ms=cuda_ms(lambda: ycsb._forward_execute_f0_plain(
                f0p, plan_p, slots, tab.capacity, mono=True), iters=5),
            library_ms=None)
        bound(rec[name], nbytes, n * 12 * (row // 4))
        del f0, f0p, tab, wlm
        torch.cuda.empty_cache()
    for nm, v in rec.items():
        if v:
            print_kernel(nm, v, card)


def lw_library(slots, order, mask, capacity):
    """``last_writer`` as one stable torch.sort (the reference's sort
    tournament with its unsort folded into a scatter): the word
    ``slot << 33 | (order - INT32_MIN) << 1 | mask`` orders lanes by
    (slot, order, masked last); equal words keep lane order, so each
    slot's tail is its winner.  ``chip_smoke``'s yardstick only."""
    s = torch.where(mask, slots, capacity).to(torch.int64)
    o = torch.where(mask, order, -2**31).to(torch.int64) + 2**31
    word = (s << 33) | (o << 1) | mask.to(torch.int64)
    perm = torch.sort(word, stable=True).indices
    ss = s[perm]
    tail = torch.ones_like(mask)
    tail[:-1] = ss[1:] != ss[:-1]
    win = torch.empty_like(mask)
    win[perm] = tail
    return win & mask


def phase_sweep_kernels(dev, rec: dict, card: str) -> None:
    """K5+K6, K7, K8 and K10 against their plain versions at the OCC
    comparator's shapes: B = 1024 txns of 10 zipf-0.9 requests, K = 8192,
    both families; K10 over the epoch's committed write lanes, and once
    in the arena regime (N >= capacity)."""
    from deneva_tpu_torch.ops import conflict, prng, scatter
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    b, k = OCC_BATCH, BUCKETS
    n = b * REQ
    wl = YCSBWorkload(occ_config(False), device=dev)
    q = wl.generate(prng.split(prng.key_from_seed(13, dev))[1], b)
    tid = torch.zeros_like(q.keys)
    valid = torch.ones_like(q.is_write)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    rank = 1 + torch.arange(b, dtype=torch.int32, device=dev)
    args = (tid, q.keys, ~q.is_write, q.is_write, valid, active, None, k, 2,
            ("u", "w"))

    # K5+K6: bit-exact bf16 counts and family-0 bucket ids
    (f1, f2), b1 = conflict.hashed_incidence(*args)
    (p1, p2), b1p = conflict.hashed_incidence_plain(*args)
    if not torch.equal(b1, b1p):
        fail("K5+K6 bucket ids differ from plain")
    for fam, pfam in ((f1, p1), (f2, p2)):
        for nm in ("u", "w"):
            if not torch.equal(fam[nm].view(torch.int16),
                               pfam[nm].view(torch.int16)):
                fail(f"K5+K6 view {nm} differs from plain")
    rec["K5K6_build_incidence"].update(
        max_abs_err=max(max_abs(b1, b1p), max(
            float((fam[nm].float() - pfam[nm].float()).abs().max())
            for fam, pfam in ((f1, p1), (f2, p2)) for nm in ("u", "w"))),
        ms=cuda_ms(lambda: conflict.hashed_incidence(*args)),
        plain_ms=cuda_ms(lambda: conflict.hashed_incidence_plain(*args),
                         iters=5), library_ms=None)
    # lanes in (table, key, 3 flags) + active; out: 4 count rows + ids
    bound(rec["K5K6_build_incidence"], 11 * n + b + 4 * b * k * 2 + 4 * n,
          2 * 12 * n)

    # K7: both families, and one torch.matmul per family as the yardstick
    ins = (f1["u"], f1["w"], f2["u"], f2["w"])
    uw = conflict.overlap(*ins)
    uw_p = conflict.overlap_plain(*ins)
    if not torch.equal(uw, uw_p):
        fail("K7 overlap differs from plain")

    def lib():
        return (torch.matmul(ins[0], ins[1].T) > 0) \
            & (torch.matmul(ins[2], ins[3].T) > 0)
    if not torch.equal(lib(), uw):
        fail("K7 overlap differs from torch.matmul")
    # the product the data needs: per family, sum over buckets of
    # (rows touching it) x (rows writing it) multiply-adds
    need = sum(float((a.float().sum(0) * c.float().sum(0)).sum())
               for a, c in ((ins[0], ins[1]), (ins[2], ins[3])))
    rec["K7_overlap"].update(
        max_abs_err=max_abs(uw, uw_p), ms=cuda_ms(lambda: conflict.overlap(
            *ins)), plain_ms=cuda_ms(lambda: conflict.overlap_plain(*ins)),
        library_ms=cuda_ms(lib))
    bound(rec["K7_overlap"], 4 * b * k * 2 + b * b, 2 * need)
    print(f"[K7] conflict pairs {int(uw.sum())} of {b * b}; dense product "
          f"{4 * b * b * k} ops, data needs {int(2 * need)}", flush=True)

    # K8 on that conflict matrix, at the config's 24 rounds
    rounds = occ_config(False).sweep_rounds
    ff = conflict.first_fit(uw, rank, active, rounds)
    ff_p = conflict.first_fit_plain(uw, rank, active, rounds)
    for x, y, nm in zip(ff, ff_p, ("win", "lose", "undecided")):
        if not torch.equal(x, y):
            fail(f"K8 {nm} differs from plain")
    edges = int(conflict.earlier_edges(uw, rank, active).sum())
    rec["K8_first_fit"].update(
        max_abs_err=max(max_abs(x, y) for x, y in zip(ff, ff_p)),
        ms=cuda_ms(lambda: conflict.first_fit(uw, rank, active, rounds)),
        plain_ms=cuda_ms(lambda: conflict.first_fit_plain(
            uw, rank, active, rounds), iters=5), library_ms=None)
    # one sequential pass over the edges decides the lex-first MIS
    bound(rec["K8_first_fit"], b * b + 5 * b + 3 * b, 2 * edges)
    print(f"[K8] win={int(ff[0].sum())} lose={int(ff[1].sum())} "
          f"undecided={int(ff[2].sum())} edges={edges}", flush=True)

    # K10 over the committed write lanes, and in the arena regime
    wmask = (q.is_write & ff[0][:, None]).reshape(-1)
    cases = {"epoch": (q.keys.reshape(-1).contiguous(),
                       rank[:, None].expand(b, REQ).reshape(-1), wmask,
                       ROWS)}
    g = torch.Generator(device=dev).manual_seed(3)
    na, cap = 1 << 17, 1 << 16
    cases["arena"] = (
        torch.randint(0, cap + 1, (na,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(-2**31, 2**31 - 1, (na,), generator=g, device=dev,
                      dtype=torch.int32) // 4096,
        torch.rand(na, generator=g, device=dev) < 0.7, cap)
    err = 0
    for nm, (sl, od, mk, cp) in cases.items():
        w = scatter.last_writer(sl, od, mk, cp)
        for other, fn in (("plain", scatter.last_writer_plain),
                          ("sort yardstick", lw_library)):
            if not torch.equal(w, fn(sl, od, mk, cp)):
                fail(f"K10 ({nm}) differs from {other}")
        err = max(err, max_abs(w, scatter.last_writer_plain(sl, od, mk, cp)))
        print(f"[K10] {nm}: N={sl.numel()} capacity={cp} "
              f"winners={int(w.sum())}", flush=True)
    sl, od, mk, cp = cases["epoch"]
    rec["K10_last_writer"].update(
        max_abs_err=err,
        ms=cuda_ms(lambda: scatter.last_writer(sl, od, mk, cp)),
        plain_ms=cuda_ms(lambda: scatter.last_writer_plain(sl, od, mk, cp)),
        library_ms=cuda_ms(lambda: lw_library(sl, od, mk, cp)))
    bound(rec["K10_last_writer"], 10 * n, 4 * n)
    for nm in ("K5K6_build_incidence", "K7_overlap", "K8_first_fit",
               "K10_last_writer"):
        print_kernel(nm, rec[nm], card)


def print_kernel(nm: str, v: dict, card: str) -> None:
    print(f"[kernel] {nm} ms={v['ms']:.4f} plain_ms={v['plain_ms']:.4f} "
          f"library_ms={v['library_ms']} bytes={v['bytes']} "
          f"ops={v['ops']} bound_ms={v['bound_ms']:.6f} "
          f"({v['bound_by']}; 3.35 TB/s, 67 Tops/s, 989 bf16 Tflop/s; "
          f"card {card})", flush=True)


def phase_epochs(dev, full: bool) -> None:
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    cfg = config(full)
    wl_k = YCSBWorkload(cfg, device=dev)
    wl_p = YCSBWorkload(cfg, device=dev)
    eng_k, eng_p = Engine(cfg, wl_k), Engine(cfg, wl_p)
    t = time.monotonic()
    sk = eng_k.init_state()
    sp = copy.deepcopy(sk)
    sk = eng_k.run(sk, 3)
    with plain_path(wl_p):
        sp = eng_p.run(sp, 3)
    torch.cuda.synchronize()
    lk, lp = state_leaves(sk), state_leaves(sp)
    for path, x in lk.items():
        if not torch.equal(x, lp[path]):
            fail(f"epochs ({'full row' if full else 'fingerprint'}): leaf "
                 f"{path} differs between kernel and plain epochs")
    del sp, lp
    torch.cuda.empty_cache()
    sk, n_win, n_read = oracle_epoch(eng_k, sk, dev)
    print(f"[epochs] {'full_row' if full else 'fingerprint'}: 3 kernel "
          f"epochs == 3 plain epochs ({len(lk)} leaves); oracle epoch ok "
          f"(reads={n_read} written_keys={n_win}) "
          f"in {time.monotonic() - t:.1f} s", flush=True)


def phase_sweep_epochs(dev, full: bool) -> None:
    """OCC at the comparator's settings: 3 kernel epochs equal 3 plain
    epochs leaf by leaf (table rows but the trash row, which takes the
    losers' writes in an unspecified order), then one kernel epoch
    against the numpy Kung-Robinson oracle."""
    from deneva_tpu_torch.convert import state_leaves
    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    mode = "full_row" if full else "fingerprint"
    cfg = occ_config(full)
    wl_k = YCSBWorkload(cfg, device=dev)
    wl_p = YCSBWorkload(cfg, device=dev)
    eng_k, eng_p = Engine(cfg, wl_k), Engine(cfg, wl_p)
    t = time.monotonic()
    sk = eng_k.init_state()
    sp = copy.deepcopy(sk)
    sk = eng_k.run(sk, 3)
    with plain_path(wl_p):
        sp = eng_p.run(sp, 3)
    torch.cuda.synchronize()
    lk, lp = state_leaves(sk), state_leaves(sp)
    cap = cfg.synth_table_size
    for path, x in lk.items():
        y = lp[path]
        same = torch.equal(x, y) if not (path.startswith("db/") and x.ndim
                                         and x.shape[0] > cap) \
            else torch.equal(x[:cap], y[:cap]) \
            and torch.equal(x[cap + 1:], y[cap + 1:])
        if not same:
            fail(f"OCC epochs ({mode}): leaf {path} differs between kernel "
                 "and plain epochs")
    del sp, lp
    torch.cuda.empty_cache()
    sk, n = occ_oracle_epoch(eng_k, sk, dev)
    print(f"[occ-epochs] {mode}: 3 kernel epochs == 3 plain epochs "
          f"({len(lk)} leaves); oracle epoch ok ({n}) "
          f"in {time.monotonic() - t:.1f} s", flush=True)


def phase_simulate(dev, cfg, path: str, label: str, card: str
                   ) -> tuple[dict, dict]:
    """``run_simulation`` with every launch count zeroed just before it;
    each kernel must launch its per-epoch count on ``path`` times the
    epochs run."""
    from deneva_tpu_torch import kernels
    from deneva_tpu_torch.engine.driver import run_simulation
    from deneva_tpu_torch.stats import parse_summary
    ks = kernels.all_kernels()
    for k in ks.values():
        k.launches = 0
    st = run_simulation(cfg, device=dev)
    counts = {nm: k.launches for nm, k in ks.items()}
    fields = parse_summary(st.summary_line())
    commits = fields["total_txn_commit_cnt"]
    aborts = fields["total_txn_abort_cnt"]
    if commits <= 0 or (aborts > 0) != (path == "OCC"):
        fail(f"simulate {label}: commits {commits} aborts {aborts}")
    for nm, c in counts.items():
        want = PATH_LAUNCHES[path].get(nm, 0) * st.epochs_run
        if c != want:
            fail(f"simulate {label}: {nm} launched {c} times in "
                 f"{st.epochs_run} epochs, expected {want}")
    print(f"[simulate] {label}: {fields['tput']:.1f} committed txn/s on "
          f"{card}; epochs={st.epochs_run} commits={commits} "
          f"aborts={aborts} abort_rate={fields['abort_rate']} "
          f"unique_aborts={fields['unique_txn_abort_cnt']}", flush=True)
    return counts, fields


def phase_profile(dev, cfg, mode: str) -> None:
    """Where an epoch's time goes (``--profile`` only): host enqueue time
    and wall time per epoch, device time by kernel, and the device's idle
    share.  The profiler slows the host, so the idle share is taken
    against the unprofiled wall time per epoch; the share against the
    profiled window is printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deneva_tpu_torch.engine.step import Engine
    from deneva_tpu_torch.workloads.ycsb import YCSBWorkload
    eng = Engine(cfg, YCSBWorkload(cfg, device=dev))
    st = eng.run(eng.init_state(), 20)
    torch.cuda.synchronize()
    n = 200
    t = time.perf_counter()
    st = eng.run(st, n)
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"[profile] {mode}: host {host / n * 1e3:.4f} ms/epoch, wall "
          f"{wall / n * 1e3:.4f} ms/epoch ({n} epochs, no profiler)",
          flush=True)
    m = 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        st = eng.run(st, m)
        torch.cuda.synchronize()
        window = time.perf_counter() - t
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    if not by_name:
        print(f"[profile] {mode}: no device events recorded (not measured)",
              flush=True)
        return
    busy = sum(v[0] for v in by_name.values())
    ours = ("radix_", "pack_kernel", "scan_", "plan_kernel", "read_fp",
            "write_fp", "read_row", "write_row", "generate_kernel",
            "threefry_split", "incidence_kernel", "overlap_kernel",
            "pack_edges", "first_fit", "insert_kernel", "mark_kernel")
    mine = sum(v[0] for k, v in by_name.items()
               if any(o in k for o in ours))
    print(f"[profile] {mode}: device busy {busy / m / 1e3:.4f} ms/epoch "
          f"(hand kernels {mine / m / 1e3:.4f}, other {(busy - mine) / m / 1e3:.4f}"
          f", {sum(v[1] for v in by_name.values()) / m:.1f} device ops/epoch)"
          f"; idle share {1 - busy / m / (wall / n * 1e6):.4f} against the "
          f"unprofiled wall ({1 - busy / (window * 1e6):.4f} against the "
          f"profiled wall of {window / m * 1e3:.4f} ms/epoch)", flush=True)
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[profile]   {v[0] / m:9.2f} us/epoch  {v[1] / m:5.1f}x  "
              f"{k[:90]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import deneva_tpu_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.monotonic()
    info = phase_device()
    phase_build()
    rec = {nm: {} for nm in ("K1_sort_lanes", "K2_plan_scans",
                             "K3_forward_execute[fingerprint]",
                             "K3_forward_execute[full_row]",
                             "K4a_threefry_split", "K4b_ycsb_generate",
                             "K5K6_build_incidence", "K7_overlap",
                             "K8_first_fit", "K10_last_writer")}
    phase_kernels(dev, rec, info["card"])
    phase_sweep_kernels(dev, rec, info["card"])
    for full in (False, True):
        phase_epochs(dev, full)
        torch.cuda.empty_cache()
    for full in (False, True):
        phase_sweep_epochs(dev, full)
        torch.cuda.empty_cache()
    launches: dict[str, int] = {}
    tput = {}
    runs = [("TPU_BATCH", False, config(False, warmup_secs=1.0,
                                        done_secs=3.0)),
            ("TPU_BATCH", True, config(True, warmup_secs=1.0,
                                       done_secs=3.0)),
            ("OCC", False, occ_config(False, warmup_secs=1.0,
                                      done_secs=3.0)),
            ("NOCC", False, occ_config(False, "NOCC", warmup_secs=1.0,
                                       done_secs=3.0))]
    for path, full, cfg in runs:
        mode = "full_row" if full else "fingerprint"
        counts, fields = phase_simulate(dev, cfg, path, f"{path} {mode}",
                                        info["card"])
        tput[(path, mode)] = fields["tput"]
        for nm, c in counts.items():
            key = f"{nm}[{mode}]" if nm == "K3_forward_execute" else nm
            launches[key] = launches.get(key, 0) + c
        torch.cuda.empty_cache()
    print(f"[vs_baseline] TPU_BATCH / OCC committed txn/s (fingerprint) = "
          f"{tput[('TPU_BATCH', 'fingerprint')] / tput[('OCC', 'fingerprint')]:.2f}"
          f" ({tput[('TPU_BATCH', 'fingerprint')]:.1f} / "
          f"{tput[('OCC', 'fingerprint')]:.1f}; NOCC "
          f"{tput[('NOCC', 'fingerprint')]:.1f})", flush=True)
    if "--profile" in sys.argv:
        for label, cfg in (("fingerprint", config(False)),
                           ("full_row", config(True)),
                           ("OCC fingerprint", occ_config(False))):
            phase_profile(dev, cfg, label)
            torch.cuda.empty_cache()
    out = []
    for nm, v in rec.items():
        if launches[nm] == 0:
            fail(f"{nm} was never launched on the main path")
        src, repl = KERNELS[nm.split("[")[0]]
        out.append({"name": nm, "route": "cuda", "source": src,
                    "replaces": repl, "launches": launches[nm],
                    "max_abs_err": v["max_abs_err"], "ms": v["ms"],
                    "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                    "bound_by": v["bound_by"],
                    "library_ms": v["library_ms"]})
    print(f"[done] {time.monotonic() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
