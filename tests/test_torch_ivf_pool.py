"""``vq_tpu_torch.ivf_pool`` against ``vq_tpu.ivf_pool`` on the same seeded
numpy batches. Everything here is integer bookkeeping and copies, so
every comparison is exact: chains, ``slot_ids``, ``pos``, list lengths,
``cap``, ``maxc``, the search chains, ``to_flat``, ``gather_rows``,
``stats``, and the virtual bucket gathers ``take_list_ids`` /
``take_list_payload``. The port allocates chunks in one vectorised step;
equal chains prove it hands out the JAX loop's ids in the JAX loop's
order. The mutations (``append(row_ids=)``, ``free_lists``,
``relabel_lists``, ``remove``) are held the same way after every step of
each scenario, the free list and uint32 payloads included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu import ivf_pool as jpool
from vq_tpu_torch import ivf_pool as tpool
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import default_device
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


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
    loop pops it."""
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


# ---------------------------------------------------------------------------
# Mutations: append(row_ids=), free_lists, relabel_lists, remove — the
# scenarios of tests/test_ivf_pool.py:114-226 and seeded random sequences,
# both pools compared after every step.
# ---------------------------------------------------------------------------

_W = 2  # uint32 words a row, the binary index's payload


def _mut_pools(nlist, chunk_rows):
    jp = jpool.ChunkPool({"codes": ((_M,), jnp.uint8), "words": ((_W,), jnp.uint32),
                          "sqn": ((), jnp.float32)}, nlist, chunk_rows=chunk_rows)
    tp = tpool.ChunkPool({"codes": ((_M,), torch.uint8), "words": ((_W,), torch.uint32),
                          "sqn": ((), torch.float32)}, nlist, chunk_rows=chunk_rows)
    return jp, tp


def _rows(rng, nb):
    return {"codes": rng.integers(0, 256, (nb, _M)).astype(np.uint8),
            "words": rng.integers(0, 2 ** 32, (nb, _W), dtype=np.uint64).astype(np.uint32),
            "sqn": rng.random(nb, dtype=np.float32)}


def assert_pools_equal(jp, tp):
    """Every piece of the two pools' state, exactly."""
    n = jp.n_rows
    assert (tp.n_rows, tp.nlist, tp._tail, tp._n_chunks) == (n, jp.nlist, jp._tail, jp._n_chunks)
    assert tp._free == jp._free
    np.testing.assert_array_equal(tp.lens_h, jp.lens_h)
    np.testing.assert_array_equal(tp._chains_h, jp._chains_h)
    np.testing.assert_array_equal(tp.slot_ids.numpy(), np.asarray(jp.slot_ids))
    np.testing.assert_array_equal(tp.pos.numpy()[:n], np.asarray(jp.pos)[:n])
    for name in jp.specs:  # with equal slots and pos, equal rows in id order too
        np.testing.assert_array_equal(tp.data[name].numpy(), np.asarray(jp.data[name]))
    np.testing.assert_array_equal(tp.chains_search().numpy(), np.asarray(jp.chains_search()))
    assert (tp.cap, tp.maxc) == (jp.cap, jp.maxc) and tp.stats() == jp.stats()


class _Both:
    """One operation on both pools, then the comparison; ``lists`` tracks
    every row's list on the host, as an index's ``_flat_lists`` does."""

    def __init__(self, nlist, chunk_rows):
        self.jp, self.tp = _mut_pools(nlist, chunk_rows)
        self.lists = np.zeros((0,), np.int32)
        self.versions = [self.tp.version]
        self.recycled = 0  # the most chunks the free list held


    def _check(self, mutated=True):
        assert_pools_equal(self.jp, self.tp)
        assert self.tp.version > self.versions[-1] or not mutated  # every mutation bumps it
        self.versions.append(self.tp.version)
        self.recycled = max(self.recycled, len(self.tp._free))

    def append(self, lists, pay, row_ids=None):
        lists = np.asarray(lists, np.int32)
        kw_j = {} if row_ids is None else {"row_ids": jnp.asarray(row_ids, jnp.int32)}
        kw_t = {} if row_ids is None else {"row_ids": torch.from_numpy(np.asarray(row_ids))}
        self.jp.append(jnp.asarray(lists), {k: jnp.asarray(v) for k, v in pay.items()}, **kw_j)
        self.tp.append(torch.from_numpy(lists), {k: torch.from_numpy(v) for k, v in pay.items()},
                       **kw_t)
        if row_ids is None:
            self.lists = np.concatenate([self.lists, lists])
        else:
            self.lists[np.asarray(row_ids)] = lists
        self._check()

    def move(self, from_lists, remap, new_nlist, rng):
        """The rebalance sequence: gather the rows of ``from_lists``, free
        those lists, relabel, and append the rows back under their ids to
        random new lists."""
        rows = np.where(np.isin(self.lists, from_lists))[0]
        pay_j = {k: self.jp.gather_rows(k, jnp.asarray(rows, jnp.int32)) for k in self.jp.specs}
        pay_t = {k: self.tp.gather_rows(k, torch.from_numpy(rows)) for k in self.tp.specs}
        for p in (self.jp, self.tp):
            p.free_lists(np.asarray(from_lists))
            p.relabel_lists(np.asarray(remap, np.int32), new_nlist)
        self._check()
        kept = np.asarray(remap) >= 0
        self.lists = np.where(np.isin(self.lists, from_lists), -1,
                              np.asarray(remap)[np.maximum(self.lists, 0)]).astype(np.int32)
        assert (self.lists[~np.isin(np.arange(self.lists.size), rows)] >= 0).all() and kept.any()
        new = rng.integers(0, new_nlist, rows.size).astype(np.int32)
        self.jp.append(jnp.asarray(new), pay_j, row_ids=jnp.asarray(rows, jnp.int32))
        self.tp.append(torch.from_numpy(new), pay_t, row_ids=torch.from_numpy(rows))
        self.lists[rows] = new
        self._check(mutated=rows.size > 0)

    def remove(self, removed):
        removed = np.unique(np.asarray(removed, np.int64))
        self.jp.remove(removed, self.lists)
        self.tp.remove(removed, self.lists)
        self.lists = np.delete(self.lists, removed)
        self._check()


def _scenario_remove_renumbers(rng):
    b = _Both(4, 8)
    b.append(rng.integers(0, 4, 50), _rows(rng, 50))
    b.remove([0, 7, 8, 33, 49])
    return b


def _scenario_remove_then_append(rng):
    b = _Both(2, 8)
    b.append(np.zeros(64, np.int32), _rows(rng, 64))
    b.remove(np.arange(32))  # list 0 halved: its chunks recycle
    b.append(np.ones(16, np.int32), _rows(rng, 16))
    return b


def _scenario_relabel_move(rng):
    b = _Both(4, 8)
    b.append(np.asarray([0] * 20 + [1] * 3 + [2] * 10 + [3] * 2), _rows(rng, 35))
    b.move([0, 3], [0, 1, 2, -1], 4, rng)  # split 0, retire 3
    b.move([2], [0, 1, 2, 3], 6, rng)  # two new lists
    return b


def _scenario_random(rng, steps=6, nlist=6):
    b = _Both(nlist, 8)
    for step in range(steps):
        n = b.lists.size
        op = step % 4 if n > 10 else 0
        if op == 1:
            b.remove(rng.choice(n, n // 4, replace=False))
        elif op == 2:
            src = np.unique(rng.choice(b.tp.nlist, 2))
            b.move(src, np.arange(b.tp.nlist), b.tp.nlist + 1, rng)
        elif op == 3 and (b.tp.lens_h == 0).any():
            empty = np.where(b.tp.lens_h == 0)[0][:1]  # retire one empty list
            live = np.setdiff1d(np.arange(b.tp.nlist), empty)
            remap = np.full(b.tp.nlist, -1)
            remap[live] = np.arange(live.size)
            b.move(empty, remap, live.size, rng)
        else:
            nb = (16, 48)[step % 2]
            b.append(rng.integers(0, b.tp.nlist, nb), _rows(rng, nb))
    return b


_SCENARIOS = {
    "remove_renumbers_and_repacks": _scenario_remove_renumbers,
    "remove_then_append_recycles_chunks": _scenario_remove_then_append,
    "relabel_and_rebalance_style_move": _scenario_relabel_move,
    "random_ops": _scenario_random,
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_mutations_match_jax_step_by_step(name):
    """Both pools equal after every append, ``append(row_ids=)``,
    ``free_lists``, ``relabel_lists`` and ``remove``: chains, lengths,
    ``slot_ids``, ``pos``, the free list, the pool tensors (uint32 words
    included) and ``stats``."""
    b = _SCENARIOS[name](np.random.default_rng(7))
    assert b.recycled > 0  # chunks went through the free list
    tail = np.random.default_rng(8).integers(0, b.lists.size, 9)
    np.testing.assert_array_equal(b.tp.gather_rows("words", torch.from_numpy(tail)).numpy(),
                                  np.asarray(b.jp.gather_rows("words", jnp.asarray(tail))))


def test_relabel_refuses_a_list_that_still_holds_rows():
    """The port checks what the JAX pool assumes: a retired list is empty."""
    tp = tpool.ChunkPool({"codes": ((_M,), torch.uint8)}, 3, chunk_rows=8)
    tp.append(torch.tensor([0, 2, 2], dtype=torch.int32), {"codes": torch.zeros(3, _M, dtype=torch.uint8)})
    with pytest.raises(InvalidParameter, match="retired"):
        tp.relabel_lists(np.array([0, 1, -1]), 2)
    tp.relabel_lists(np.array([0, -1, 1]), 2)  # list 1 is empty
    assert tp.lens_h.tolist() == [1, 2] and tp.chains_search().shape[0] == 2


def test_every_mutation_drops_the_device_chains():
    """R3 (the JAX package's shard cache goes stale after a relabel): the
    port's cached device chains are dropped by every mutation and
    ``version`` counts them, so caches key on a counter."""
    tp = tpool.ChunkPool({"codes": ((_M,), torch.uint8)}, 4, chunk_rows=8)
    lists = torch.tensor([0, 0, 1, 3] * 5, dtype=torch.int32)
    tp.append(lists, {"codes": torch.zeros(20, _M, dtype=torch.uint8)})
    seen = [tp.version]
    before = tp.chains_search().clone()
    tp.free_lists([3])
    assert tp._chains_dev is None and tp.version > seen[-1]
    seen.append(tp.version)
    assert bool((tp.chains_search()[3] == -1).all()) and not torch.equal(before, tp.chains_search())
    tp.relabel_lists(np.array([1, 0, 2, -1]), 3)
    assert tp.version > seen[-1] and torch.equal(tp.chains_search()[1], before[0])
