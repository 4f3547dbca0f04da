"""Port parity of TPC-C's batched table writes: `DeviceTable.scatter_add`
(K14c) and `DeviceTable.append` (K14d), plain versions, against
``deneva_tpu.storage.table.DeviceTable`` on the CPU, exactly.

* ``scatter_add`` with heavy duplicates: float32 values uniform in
  [1, 5000) onto 4 rows holding 300000.0 (the reference adds a slot's
  lanes in lane order onto the old value; a segmented sum rounds
  differently, which the test checks it would catch), int32 columns, and
  masked, negative, trash and out-of-range lanes, which add nothing.
* ``append`` on ring and non-ring tables: across a wrap, at capacity,
  and with a ring cursor that wraps at 2^31; rows, ``row_cnt`` and the
  returned slots.

Rows ``[0, capacity)`` compare; the reference's trash row takes the
dropped lanes in an unspecified order, the port's takes none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.storage.catalog import parse_schema as j_parse
from deneva_tpu.storage.table import DeviceTable as JTable
from deneva_tpu_torch.storage.catalog import parse_schema
from deneva_tpu_torch.storage.table import DeviceTable, fill_columns

SCHEMA = ("TABLE=T\n\t8,double,F\n\t8,int64_t,I\n\t8,double,G\n"
          "\t8,string,S\n")


def _tables(cap, ring=False):
    j = JTable.create(j_parse(SCHEMA).table("T"), cap, ring=ring)
    t = DeviceTable.create(parse_schema(SCHEMA).table("T"), cap, "cpu",
                           ring=ring)
    return j, t


def _same_rows(j, t, cap):
    for name, col in j.columns.items():
        want = np.asarray(col)[:cap]
        have = t.columns[name].numpy()[:cap]
        if want.dtype == np.uint32:
            have = have.view(np.uint32)
        np.testing.assert_array_equal(have, want, err_msg=name)
        assert not t.columns[name][cap + 1:].any(), name   # padded rows


@pytest.mark.parametrize("n,cap,seed", [(2048, 4, 0), (2048, 64, 1),
                                        (300, 1000, 2), (1, 4, 3)])
def test_scatter_add_matches_reference_under_duplicates(n, cap, seed):
    rng = np.random.default_rng(seed)
    j, t = _tables(cap)
    init = {"F": np.full(cap, 300000.0, np.float32),
            "G": rng.uniform(-50, 50, cap).astype(np.float32),
            "I": rng.integers(0, 1000, cap).astype(np.int32)}
    j = j._replace(columns={**j.columns, **{
        k: j.columns[k].at[:cap].set(jnp.asarray(v))
        for k, v in init.items()}})
    fill_columns(t, cap, {k: torch.from_numpy(v) for k, v in init.items()})
    slots = rng.integers(-2, cap + 3, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    vals = {"F": rng.uniform(1, 5000, n).astype(np.float32),
            "G": -rng.uniform(1, 5000, n).astype(np.float32),
            "I": rng.integers(-3, 7, n).astype(np.int32)}
    j = j.scatter_add(jnp.asarray(slots),
                      {k: jnp.asarray(v) for k, v in vals.items()},
                      mask=jnp.asarray(mask))
    t.scatter_add(torch.from_numpy(slots),
                  {k: torch.from_numpy(v) for k, v in vals.items()},
                  mask=torch.from_numpy(mask))
    _same_rows(j, t, cap)
    if n == 2048 and cap == 4:
        # lane order matters: a pairwise sum per row, added once, rounds
        # differently on some row
        live = mask & (slots >= 0) & (slots < cap)
        seg = np.array([init["F"][r] + np.sum(vals["F"][live & (slots == r)])
                        for r in range(cap)], np.float32)
        assert (seg != t.columns["F"][:cap].numpy()).any()


def test_scatter_add_int_only_and_unmasked():
    rng = np.random.default_rng(7)
    j, t = _tables(16)
    slots = rng.integers(0, 17, 500).astype(np.int32)   # 16 is the trash
    v = rng.integers(-2**20, 2**20, 500).astype(np.int32)
    j = j.scatter_add(jnp.asarray(slots), {"I": jnp.asarray(v)})
    t.scatter_add(torch.from_numpy(slots), {"I": torch.from_numpy(v)})
    _same_rows(j, t, 16)


@pytest.mark.parametrize("ring", [False, True])
def test_append_matches_reference_across_wrap_and_capacity(ring):
    rng = np.random.default_rng(11)
    cap = 37
    j, t = _tables(cap, ring=ring)
    for step in range(6):
        n = 16
        mask = rng.random(n) < 0.7
        rows = {"F": rng.uniform(0, 1, n).astype(np.float32),
                "I": rng.integers(0, 100, n).astype(np.int32),
                "S": rng.integers(0, 2**32, n, dtype=np.uint64
                                  ).astype(np.uint32)}
        j, jslots = j.append({k: jnp.asarray(v) for k, v in rows.items()},
                             jnp.asarray(mask))
        trows = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                     else v) for k, v in rows.items()}
        t, tslots = t.append(trows, torch.from_numpy(mask))
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        assert int(t.row_cnt) == int(j.row_cnt), step
        _same_rows(j, t, cap)
    # 6 x ~11 rows: the ring wrapped, the plain table filled up
    assert int(t.row_cnt) > cap if ring else int(t.row_cnt) == cap


def test_append_ring_cursor_wraps_at_int32():
    """A ring's cursor runs free in int32: past 2^31 it wraps negative
    and the slots take a floor modulo, in both packages.  The capacity is
    a power of two, so the slots run on across the wrap without a repeat
    (another capacity would make one call write a slot twice, in an
    order neither package defines)."""
    cap = 16
    j, t = _tables(cap, ring=True)
    start = 2**31 - 5
    j = j._replace(row_cnt=jnp.int32(start))
    t.row_cnt.fill_(start)
    mask = np.ones(12, bool)
    mask[[3, 7, 9]] = False          # 9 rows: fewer than the capacity
    rows = {"I": np.arange(12, dtype=np.int32)}
    j, jslots = j.append({"I": jnp.asarray(rows["I"])}, jnp.asarray(mask))
    t, tslots = t.append({"I": torch.from_numpy(rows["I"])},
                         torch.from_numpy(mask))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    assert int(t.row_cnt) == int(j.row_cnt) < 0
    _same_rows(j, t, cap)


@pytest.mark.parametrize("case,ring", [
    ("none_inserted", False), ("none_inserted", True),
    ("all_inserted", False), ("all_inserted", True),
    ("one_lane", False), ("one_lane", True), ("fills_up", False)])
def test_append_edge_cases_match_reference(case, ring):
    """A mask with no lane set, with every lane set, a single lane, and
    a plain table that fills up inside one call: slots, ``row_cnt`` and
    rows as the reference's."""
    rng = np.random.default_rng(len(case) + ring)
    cap = 37
    j, t = _tables(cap, ring=ring)
    start = {"fills_up": 30, "one_lane": 36}.get(case, 20)
    j = j._replace(row_cnt=jnp.int32(start))
    t.row_cnt.fill_(start)
    n = 1 if case == "one_lane" else 16
    mask = np.full(n, case != "none_inserted")
    rows = {"F": rng.uniform(0, 1, n).astype(np.float32),
            "I": rng.integers(0, 100, n).astype(np.int32)}
    j, jslots = j.append({k: jnp.asarray(v) for k, v in rows.items()},
                         jnp.asarray(mask))
    t, tslots = t.append({k: torch.from_numpy(v) for k, v in rows.items()},
                         torch.from_numpy(mask))
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    assert int(t.row_cnt) == int(j.row_cnt)
    _same_rows(j, t, cap)
    if case == "fills_up":     # 7 rows fit, 9 drop, the cursor clamps
        assert int(t.row_cnt) == cap and (tslots.numpy() == cap).sum() == 9


# -- scatter_add_many: Payment's three tables in one K14c launch -------------

PAYMENT = ("TABLE=WAREHOUSE\n\t8,double,W_YTD\n"
           "TABLE=DISTRICT\n\t8,double,D_YTD\n\t8,int64_t,D_NEXT_O_ID\n"
           "TABLE=CUSTOMER\n\t8,double,C_BALANCE\n\t8,double,C_YTD_PAYMENT\n"
           "\t8,int64_t,C_PAYMENT_CNT\n")
# rows per warehouse: 1, 10 districts, 10 x 3 customers (few, so the
# customer slots repeat)
PAY_ROWS = {"WAREHOUSE": 1, "DISTRICT": 10, "CUSTOMER": 30}


def _payment_tables(wh, rng, striped=False):
    js, ts = {}, {}
    for name, per in PAY_ROWS.items():
        cap = wh * per
        j = JTable.create(j_parse(PAYMENT).table(name), cap)
        t = DeviceTable.create(parse_schema(PAYMENT).table(name), cap, "cpu",
                               striped=striped)
        init = {c: (np.full(cap, 300000.0, np.float32) if c != "C_BALANCE"
                    else rng.uniform(-50, 50, cap).astype(np.float32))
                if np.asarray(j.columns[c]).dtype == np.float32
                else rng.integers(0, 1000, cap).astype(np.int32)
                for c in j.columns}
        js[name] = j._replace(columns={**j.columns, **{
            c: j.columns[c].at[:cap].set(jnp.asarray(v))
            for c, v in init.items()}})
        ts[name] = fill_columns(t, cap, {c: torch.from_numpy(v)
                                         for c, v in init.items()})
    return js, ts


def _payment_lanes(wh, n, rng):
    """Slots of each table (a few negative, past capacity, or the trash
    row), the mask and the added values, Payment's columns."""
    w = rng.integers(0, wh, n)
    dk = w * 10 + rng.integers(0, 10, n)
    slots = {"WAREHOUSE": w, "DISTRICT": dk,
             "CUSTOMER": dk * 3 + rng.integers(0, 3, n)}
    for name, s in slots.items():
        cap = wh * PAY_ROWS[name]
        odd = rng.random(n)
        s = np.where(odd < 0.02, -1, np.where(odd < 0.04, cap + 2,
                     np.where(odd < 0.06, cap, s)))
        slots[name] = s.astype(np.int32)
    mask = rng.random(n) < 0.6
    amt = rng.uniform(1, 5000, n).astype(np.float32)
    amt = np.where(mask, amt, 0).astype(np.float32)
    vals = {"WAREHOUSE": {"W_YTD": amt}, "DISTRICT": {"D_YTD": amt},
            "CUSTOMER": {"C_BALANCE": -amt, "C_YTD_PAYMENT": amt,
                         "C_PAYMENT_CNT": mask.astype(np.int32)}}
    return slots, mask, vals


@pytest.mark.parametrize("wh,n,seed,tables,striped", [
    (1, 2048, 0, ("WAREHOUSE", "DISTRICT", "CUSTOMER"), False),
    (4, 2048, 1, ("WAREHOUSE", "DISTRICT", "CUSTOMER"), False),
    (4, 300, 2, ("DISTRICT", "CUSTOMER"), False),
    (64, 2048, 3, ("WAREHOUSE", "DISTRICT", "CUSTOMER"), True)])
def test_scatter_add_many_matches_reference_calls(wh, n, seed, tables,
                                                  striped):
    """`scatter_add_many`'s plain route against the reference's
    `DeviceTable.scatter_add` per table (W, D, C order) under duplicate
    slots: rows [0, capacity) exact, float bits included, and the trash
    and pad rows untouched."""
    from deneva_tpu_torch.storage import table
    rng = np.random.default_rng(seed)
    js, ts = _payment_tables(wh, rng, striped)
    slots, mask, vals = _payment_lanes(wh, n, rng)
    for name in tables:
        js[name] = js[name].scatter_add(
            jnp.asarray(slots[name]),
            {c: jnp.asarray(v) for c, v in vals[name].items()},
            mask=jnp.asarray(mask))
    table.scatter_add_many(
        [(ts[name], torch.from_numpy(slots[name]),
          {c: torch.from_numpy(v) for c, v in vals[name].items()})
         for name in tables], torch.from_numpy(mask))
    for name in tables:
        cap = ts[name].capacity
        _same_rows(js[name], ts[name], cap)
        assert not any(v[cap].any() for v in ts[name].columns.values())


def test_scatter_add_many_through_mesh_views():
    """Through `McTableView` (four owner-major blocks): each shard's
    launch adds its own rows, and the stacked rows equal the reference's
    three one-table adds."""
    from deneva_tpu_torch.storage import table
    from deneva_tpu_torch.storage.table import mc_stacked_rows, to_mc_layout
    from deneva_tpu_torch.workloads.mc import McTableView
    wh, d, n = 4, 4, 1024
    rng = np.random.default_rng(5)
    js, ts = _payment_tables(wh, rng)
    slots, mask, vals = _payment_lanes(wh, n, rng)
    tm = {name: to_mc_layout(t, d, PAY_ROWS[name]) for name, t in ts.items()}
    for name in PAY_ROWS:
        js[name] = js[name].scatter_add(
            jnp.asarray(slots[name]),
            {c: jnp.asarray(v) for c, v in vals[name].items()},
            mask=jnp.asarray(mask))
    for me in range(d):
        table.scatter_add_many(
            [(McTableView(tm[name], me), torch.from_numpy(slots[name]),
              {c: torch.from_numpy(v) for c, v in vals[name].items()})
             for name in PAY_ROWS], torch.from_numpy(mask))
    for name in PAY_ROWS:
        at = mc_stacked_rows(tm[name])
        for c, col in js[name].columns.items():
            want = np.asarray(col)[:tm[name].capacity]
            have = tm[name].columns[c][at].numpy()
            np.testing.assert_array_equal(have.view(np.int32),
                                          want.view(np.int32), err_msg=c)


def test_scatter_add_many_refuses_four_tables_and_shared_columns():
    from deneva_tpu_torch.storage import table
    rng = np.random.default_rng(9)
    _, ts = _payment_tables(2, rng)
    slots, mask, vals = _payment_lanes(2, 64, rng)
    calls = [(ts[name], torch.from_numpy(slots[name]),
              {c: torch.from_numpy(v) for c, v in vals[name].items()})
             for name in PAY_ROWS]
    with pytest.raises(ValueError, match="at most 3"):
        table.scatter_add_many(calls + calls[:1], torch.from_numpy(mask))
    with pytest.raises(ValueError, match="twice"):
        table.scatter_add_many(calls[:2] + calls[1:2],
                               torch.from_numpy(mask))
