"""The partial pool of ``deneva_tpu_torch`` against ``deneva_tpu`` on the
CPU: refill's cumsum compaction, select's top-B by ``seq`` and update's
slot scatters with backoff, for 5 epochs, every pool leaf and the
selected ``slots`` themselves exactly.  Fewer than B slots are runnable
in several epochs, so the ties among non-runnable slots (all keyed
INT32_MAX) decide which slots fill the batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deneva_tpu.engine.pool import TxnPool as JPool
from deneva_tpu.workloads.ycsb import YCSBQuery as JQuery
from deneva_tpu_torch import convert
from deneva_tpu_torch.engine.pool import TxnPool
from deneva_tpu_torch.workloads.ycsb import YCSBQuery


@pytest.mark.parametrize("p,b,g,backoff,fresh", [(64, 16, 12, True, True),
                                                 (40, 8, 5, False, False),
                                                 (24, 16, 16, True, True)])
def test_partial_pool_matches_reference(p, b, g, backoff, fresh):
    rng = np.random.default_rng(p + b + g)
    jpool, tpool = JPool(p, b, g, backoff=backoff), TxnPool(p, b, g, backoff)
    assert not jpool.full_pool and not tpool.full_pool
    js = jpool.create(JQuery(jnp.zeros((p, 4), jnp.int32),
                             jnp.zeros((p, 4), bool)))
    ts = tpool.create(YCSBQuery(torch.zeros(p, 4, dtype=torch.int32),
                                torch.zeros(p, 4, dtype=torch.bool)), "cpu")
    short = 0
    for epoch in range(5):
        keys = rng.integers(0, 1000, (g, 4)).astype(np.int32)
        isw = rng.random((g, 4)) < 0.5
        je, te = jnp.int32(epoch), torch.tensor(epoch, dtype=torch.int32)
        js, jadm = jpool.refill(js, JQuery(jnp.asarray(keys),
                                           jnp.asarray(isw)), je)
        ts, tadm = tpool.refill(ts, YCSBQuery(torch.from_numpy(keys),
                                              torch.from_numpy(isw)), te)
        assert int(jadm) == int(tadm)
        jslots, jact, jq = jpool.select(js, je)
        tslots, tact, tq = tpool.select(ts, te)
        assert tslots.dtype == torch.int32
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
        np.testing.assert_array_equal(tq.keys.numpy(), np.asarray(jq.keys))
        short += int(tact.sum()) < b
        # aborts: most of the batch, so backoff leaves slots not runnable
        commit = rng.random(b) < 0.25
        abort = ~commit & (rng.random(b) < 0.8)
        js = jpool.update(js, jslots, jact, jnp.asarray(commit),
                          jnp.asarray(abort), je, fresh)
        ts = tpool.update(ts, tslots, tact, torch.from_numpy(commit),
                          torch.from_numpy(abort), te, fresh)
        for f in convert.POOL_FIELDS:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
        for f in convert.QUERY_FIELDS:
            np.testing.assert_array_equal(
                getattr(ts.queries, f).numpy(),
                np.asarray(getattr(js.queries, f)), f)
    assert short >= 1
