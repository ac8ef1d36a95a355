"""``vq_tpu_torch.ivf_pool`` against ``vq_tpu.ivf_pool`` on the same seeded
numpy batches. Everything here is integer bookkeeping and copies, so
every comparison is exact: chains, ``slot_ids``, ``pos``, list lengths,
``cap``, ``maxc``, the search chains, ``to_flat``, ``gather_rows``,
``stats``, and the virtual bucket gathers ``take_list_ids`` /
``take_list_payload``. The port allocates chunks in one vectorised step;
equal chains prove it hands out the JAX loop's ids in the JAX loop's
order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu import ivf_pool as jpool
from vq_tpu_torch import ivf_pool as tpool

_NLIST, _M = 12, 3


def _batches(seed, sizes=(300, 7, 1000, 1, 450)):
    """Skewed list assignments (Zipf-like: list 0 takes about a third of
    the rows, some lists stay empty) and u8 payload rows."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, _NLIST + 1) ** 1.2
    p[[4, 9]] = 0.0
    p /= p.sum()
    for nb in sizes:
        lists = rng.choice(_NLIST, nb, p=p).astype(np.int32)
        codes = rng.integers(0, 256, (nb, _M)).astype(np.uint8)
        yield lists, codes


def _pools(seed, *, chunk_rows=256, max_list_size=None, reserve=None, sizes=(300, 7, 1000, 1, 450)):
    jp = jpool.ChunkPool({"codes": ((_M,), jnp.uint8)}, _NLIST,
                         chunk_rows=chunk_rows, max_list_size=max_list_size)
    tp = tpool.ChunkPool({"codes": ((_M,), torch.uint8)}, _NLIST,
                         chunk_rows=chunk_rows, max_list_size=max_list_size)
    if reserve is not None:
        jp.reserve(reserve)
        tp.reserve(reserve)
    appended = []
    for lists, codes in _batches(seed, sizes):
        jp.append(jnp.asarray(lists), {"codes": jnp.asarray(codes)})
        tp.append(torch.from_numpy(lists), {"codes": torch.from_numpy(codes)})
        appended.append(codes)
    return jp, tp, np.concatenate(appended)


_CONFIGS = {
    "default": dict(),
    "small_chunks": dict(chunk_rows=16),
    "max_list_size": dict(max_list_size=100),
    "tiny_cap": dict(max_list_size=5),
    "reserved": dict(chunk_rows=32, reserve=4000),
    "one_batch": dict(chunk_rows=8, sizes=(2000,)),
}


@pytest.fixture(scope="module", params=sorted(_CONFIGS))
def pools(request):
    return _pools(50, **_CONFIGS[request.param])


def test_layout_matches_jax(pools):
    jp, tp, _ = pools
    n = jp.n_rows
    assert tp.n_rows == n and tp.ch == jp.ch
    np.testing.assert_array_equal(tp.lens_h, jp.lens_h)
    np.testing.assert_array_equal(tp._chains_h, jp._chains_h)
    np.testing.assert_array_equal(tp.slot_ids.numpy(), np.asarray(jp.slot_ids))
    np.testing.assert_array_equal(tp.pos.numpy()[:n], np.asarray(jp.pos)[:n])
    assert (tp.cap, tp.maxc) == (jp.cap, jp.maxc)
    assert tp.stats() == jp.stats()


def test_search_view_matches_jax(pools):
    jp, tp, _ = pools
    np.testing.assert_array_equal(tp.chains_search().numpy(), np.asarray(jp.chains_search()))
    np.testing.assert_array_equal(tp.data["codes"].numpy(), np.asarray(jp.data["codes"]))


def test_to_flat_and_gather_match_jax(pools):
    jp, tp, _ = pools
    np.testing.assert_array_equal(
        tp.to_flat()["codes"].numpy(), np.asarray(jp.to_flat()["codes"])
    )
    ids = np.random.default_rng(51).integers(0, jp.n_rows, 40).astype(np.int32)
    np.testing.assert_array_equal(
        tp.gather_rows("codes", torch.from_numpy(ids)).numpy(),
        np.asarray(jp.gather_rows("codes", jnp.asarray(ids))),
    )


def test_to_flat_holds_the_batches_in_order(pools):
    """Row id i is the i-th row appended, whatever list it went to."""
    _, tp, appended = pools
    np.testing.assert_array_equal(tp.to_flat()["codes"].numpy(), appended)


@pytest.mark.parametrize("probe_shape", [(5,), (3, 4)])
def test_take_list_ids_and_payload_match_jax(pools, probe_shape):
    jp, tp, _ = pools
    pl = np.random.default_rng(52).integers(0, _NLIST, probe_shape).astype(np.int32)
    jch, tch = jp.chains_search(), tp.chains_search()
    want_ids = np.asarray(jpool.take_list_ids(jp.slot_ids, jch, jnp.asarray(pl), jp.cap))
    got_ids = tpool.take_list_ids(tp.slot_ids, tch, torch.from_numpy(pl), tp.cap)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    want_pay = np.asarray(jpool.take_list_payload(jp.data["codes"], jch, jnp.asarray(pl)))
    got_pay = tpool.take_list_payload(tp.data["codes"], tch, torch.from_numpy(pl))
    np.testing.assert_array_equal(got_pay.numpy(), want_pay)


def test_recycled_chunks_are_handed_out_first():
    """The free list is popped from its end before fresh ids, as the JAX
    loop pops it (free lists fill once removal is ported)."""
    jp = jpool.ChunkPool({"codes": ((_M,), jnp.uint8)}, _NLIST, chunk_rows=8)
    tp = tpool.ChunkPool({"codes": ((_M,), torch.uint8)}, _NLIST, chunk_rows=8)
    for p in (jp, tp):
        p._tail = 10
        p._n_chunks = 0
        p._free = [3, 7, 1]
    lists, codes = next(_batches(53, sizes=(60,)))
    jp.append(jnp.asarray(lists), {"codes": jnp.asarray(codes)})
    tp.append(torch.from_numpy(lists), {"codes": torch.from_numpy(codes)})
    np.testing.assert_array_equal(tp._chains_h, jp._chains_h)
    assert tp._free == jp._free and tp._tail == jp._tail
    np.testing.assert_array_equal(tp.slot_ids.numpy(), np.asarray(jp.slot_ids))


def test_empty_pool_and_empty_batch():
    tp = tpool.ChunkPool({"codes": ((_M,), torch.uint8)}, _NLIST)
    jp = jpool.ChunkPool({"codes": ((_M,), jnp.uint8)}, _NLIST)
    assert (tp.cap, tp.maxc) == (jp.cap, jp.maxc) == (8, 0)
    tp.append(torch.zeros(0, dtype=torch.int32), {"codes": torch.zeros(0, _M, dtype=torch.uint8)})
    assert tp.n_rows == 0 and tp.stats() == jp.stats()
    np.testing.assert_array_equal(tp.chains_search().numpy(), np.asarray(jp.chains_search()))
