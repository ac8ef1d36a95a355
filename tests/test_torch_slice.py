"""The whole PQ slice, JAX package against port, at a small size: a JAX
``ProductQuantizer`` carried into the port through ``convert``, then both
packages' ``PQIndex.add`` and ``search`` (with and without rerank) on the
same corpus, and checkpoints loaded across packages in both directions.
d = 32, m = 4; k = 64 gives u8 codes, k = 16 auto-packed 4-bit codes.
The IVF-PQ path likewise: a JAX ``IVFPQIndex`` trained at the IVF
benchmark's width (d = 128, PQ 8 x 16 here, 16 lists), carried across,
``add`` and ``search`` in both packages (ADC distances within rtol 1e-5 /
atol 1e-4, reranked ones within rtol 1e-5 / atol 1e-3).
IVF-Flat (f32 and bf16 rows) and IVF-SQ (residual SQ8) likewise, at
d = 128 with 16 lists: a JAX index carried across through
``from_state``, ``add`` in both packages, searches at nprobe 2 and 16
held with the near-tie-aware check of ``test_torch_ivf_flat`` (values
within rtol 1e-5 / atol 1e-3), and the port's checkpoint searched by the
JAX package.
Search parity uses the tie-aware tiers of ``test_torch_pq``. Reranked
distances are exact distances in the expanded form
``||q||^2 + ||c||^2 - 2 q.c``, whose fp32 error between two summation
orders is about 1e-6 * (||q||^2 + ||c||^2), near 7e-4 in d^2 at this
data's norms; with every reranked distance above 0.5 that is held at an
absolute 1e-3 on the distances.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import vq_tpu
import vq_tpu_torch
from vq_tpu_torch.convert import from_state, state_of
from test_torch_pq import assert_search_parity
from vq_tpu_torch.models.base import default_device


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


_RERANK_TOL = {"rtol": 1e-5, "atol": 1e-3}  # expanded-form exact distances


@pytest.fixture(scope="module", params=[64, 16], ids=["u8", "packed4"])
def slice_setup(request):
    k = request.param
    rng = np.random.default_rng(20 + k)
    centres = rng.standard_normal((40, 32)).astype(np.float32) * 3
    corpus = (centres[rng.integers(0, 40, 3000)]
              + rng.standard_normal((3000, 32)).astype(np.float32))
    queries = corpus[rng.integers(0, 3000, 9)] + 0.1
    jpq = vq_tpu.ProductQuantizer(corpus[:1500], 4, k, max_iters=6, seed=5)
    tpq = from_state("pq", {"distance": jpq.distance_metric},
                     {"codebooks": np.asarray(jpq.codebooks)})
    jidx = vq_tpu.PQIndex(jpq, keep_corpus=True)
    tidx = vq_tpu_torch.PQIndex(tpq, keep_corpus=True)
    for part in (corpus[:1000], corpus[1000:]):  # two adds: appends concatenate
        jidx.add(part)
        tidx.add(part)
    return jidx, tidx, queries, k


def test_convert_carries_codebooks(slice_setup):
    jidx, tidx, _, k = slice_setup
    np.testing.assert_array_equal(
        tidx.pq.codebooks.numpy(), np.asarray(jidx.pq.codebooks)
    )
    assert tidx.pack_bits == jidx.pack_bits == (4 if k == 16 else 8)


def test_add_codes_match(slice_setup):
    jidx, tidx, _, _ = slice_setup
    np.testing.assert_array_equal(tidx._codes.numpy(), np.asarray(jidx._codes))


@pytest.mark.parametrize("k,rerank", [(10, 0), (10, 50), (1, 0), (5, 200)])
def test_search_matches_jax(slice_setup, k, rerank):
    jidx, tidx, q, _ = slice_setup
    want = jidx.search(q, k=k, rerank=rerank)
    got = tidx.search(q, k=k, rerank=rerank)
    assert_search_parity(got, want, **(_RERANK_TOL if rerank else {}))


def test_reconstruct_matches_jax(slice_setup):
    jidx, tidx, _, _ = slice_setup
    ids = np.array([0, 7, 2999, 1500])
    np.testing.assert_array_equal(
        tidx.reconstruct(ids).numpy(), np.asarray(jidx.reconstruct(ids))
    )


def test_jax_checkpoint_loads_in_port(slice_setup, tmp_path):
    jidx, _, q, _ = slice_setup
    path = jidx.save(str(tmp_path / "jax_index"))
    loaded = vq_tpu_torch.PQIndex.load(path)
    assert loaded.ntotal == jidx.ntotal and loaded.pack_bits == jidx.pack_bits
    assert_search_parity(
        loaded.search(q, k=10, rerank=30), jidx.search(q, k=10, rerank=30),
        **_RERANK_TOL,
    )


def test_port_checkpoint_loads_in_jax(slice_setup, tmp_path):
    jidx, tidx, q, _ = slice_setup
    path = tidx.save(str(tmp_path / "port_index"))
    loaded = vq_tpu.PQIndex.load(path)
    np.testing.assert_array_equal(np.asarray(loaded._codes), tidx._codes.numpy())
    assert_search_parity(tidx.search(q, k=10), loaded.search(q, k=10))
    pq_path = vq_tpu_torch.save(str(tmp_path / "port_pq"), tidx.pq)
    jpq = vq_tpu.utils.load(pq_path)
    np.testing.assert_array_equal(np.asarray(jpq.codebooks), tidx.pq.codebooks.numpy())


def test_state_round_trip(slice_setup):
    _, tidx, q, _ = slice_setup
    again = from_state(*state_of(tidx))
    assert torch.equal(again._codes, tidx._codes)
    assert torch.equal(again._corpus, tidx._corpus)
    ids, d = again.search(q, k=10)
    want_ids, want_d = tidx.search(q, k=10)
    assert torch.equal(ids, want_ids) and torch.equal(d, want_d)


def test_remove_and_merge_match_jax(slice_setup):
    jidx, tidx, q, _ = slice_setup
    jpq, tpq = jidx.pq, tidx.pq
    ja, jb = vq_tpu.PQIndex(jpq), vq_tpu.PQIndex(jpq)
    ta, tb = vq_tpu_torch.PQIndex(tpq), vq_tpu_torch.PQIndex(tpq)
    corpus = tidx._corpus.numpy()
    for a, b in ((ja, jb), (ta, tb)):
        a.add(corpus[:1200])
        b.add(corpus[1200:2000])
        assert a.remove_ids([0, 5, 5, 1199]) == 3
        assert a.merge_from(b) == 800 and b.ntotal == 0
    np.testing.assert_array_equal(ta._codes.numpy(), np.asarray(ja._codes))
    assert_search_parity(ta.search(q, k=10), ja.search(q, k=10))


def test_ivf_path_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    centres = rng.normal(0, 2.0, (20, 128)).astype(np.float32)
    corpus = (centres[rng.integers(0, 20, 2500)]
              + rng.normal(0, 0.3, (2500, 128))).astype(np.float32)
    queries = corpus[rng.integers(0, 2500, 8)] + 0.02
    jidx = vq_tpu.IVFPQIndex.train(corpus[:1200], nlist=16, num_subspaces=8,
                                   num_centroids=16, max_iters=6, keep_corpus=True)
    tidx = from_state(*_jax_ivf_state(jidx, tmp_path))
    jidx.add(corpus)
    tidx.add(corpus)
    np.testing.assert_array_equal(tidx._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    for nprobe, rerank in ((2, 0), (16, 0), (4, 40)):
        assert_search_parity(
            tidx.search(queries, k=10, nprobe=nprobe, rerank=rerank),
            jidx.search(queries, k=10, nprobe=nprobe, rerank=rerank),
            **(_RERANK_TOL if rerank else {"rtol": 1e-5, "atol": 1e-4}),
        )
    back = vq_tpu.IVFPQIndex.load(tidx.save(str(tmp_path / "port_ivf")))
    assert_search_parity(tidx.search(queries, k=10, nprobe=4),
                         back.search(queries, k=10, nprobe=4), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["flat-float32", "flat-bfloat16", "sq"])
def test_ivf_flat_and_sq_paths_match_jax(kind, tmp_path):
    from test_torch_ivf_flat import assert_probe_parity

    rng = np.random.default_rng(22)
    centres = rng.normal(0, 2.0, (20, 128)).astype(np.float32)
    corpus = (centres[rng.integers(0, 20, 2500)]
              + rng.normal(0, 0.3, (2500, 128))).astype(np.float32)
    queries = corpus[rng.integers(0, 2500, 8)] + 0.02
    if kind == "sq":
        jidx = vq_tpu.IVFSQIndex.train(corpus[:1200], 16, max_iters=6)
    else:
        jidx = vq_tpu.IVFFlatIndex.train(corpus[:1200], 16, max_iters=6,
                                         store_dtype=kind.split("-")[1])
    tidx = from_state(*_jax_ivf_state(jidx, tmp_path))
    jidx.add(corpus)
    tidx.add(corpus)
    np.testing.assert_array_equal(tidx._flat_lists.numpy(), np.asarray(jidx._flat_lists))
    for nprobe in (2, 16):
        assert_probe_parity(tidx.search(queries, k=10, nprobe=nprobe),
                            jidx.search(queries, k=10, nprobe=nprobe))
    back = type(jidx).load(tidx.save(str(tmp_path / "port_ivf")))
    assert_probe_parity(tidx.search(queries, k=10, nprobe=4), back.search(queries, k=10, nprobe=4))


def _jax_ivf_state(jidx, tmp_path):
    """The trained (still empty) JAX index as ``(kind, config, arrays)``,
    read back from its own checkpoint."""
    from vq_tpu_torch.utils.serialize import _from_npz

    return _from_npz(jidx.save(str(tmp_path / "jax_ivf_trained")))


def test_port_imports_no_jax():
    code = (
        "import sys, vq_tpu_torch, vq_tpu_torch.ops._build, "
        "vq_tpu_torch.convert, vq_tpu_torch.utils, "
        "vq_tpu_torch.benchmarks.mpacked_encode, vq_tpu_torch.benchmarks.adc_vmem_bench, "
        "vq_tpu_torch.benchmarks.pq_scan_ab, vq_tpu_torch.models.bq, vq_tpu_torch.models.tsvq, "
        "vq_tpu_torch.utils.datasets, vq_tpu_torch.utils.metrics, vq_tpu_torch.cli.common, "
        "vq_tpu_torch.cli.eval_bq, vq_tpu_torch.cli.eval_sq, vq_tpu_torch.cli.eval_pq, "
        "vq_tpu_torch.cli.eval_tsvq\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'vq_tpu', 'benchmarks') "
        "or m.startswith(('jax.', 'vq_tpu.', 'benchmarks.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_port_doctests():
    import doctest
    import importlib
    import pkgutil

    names = ["vq_tpu_torch"] + [
        info.name for info in pkgutil.walk_packages(vq_tpu_torch.__path__, "vq_tpu_torch.")
    ]
    attempted = 0
    for name in names:
        res = doctest.testmod(importlib.import_module(name), verbose=False)
        assert res.failed == 0, f"{res.failed} doctest(s) failed in {name}"
        attempted += res.attempted
    assert attempted > 0
