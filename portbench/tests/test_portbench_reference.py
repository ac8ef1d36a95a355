"""The plain reference held to NumPy brute force at tiny sizes."""

import numpy as np
import pytest
import torch

from portbench.reference import ivfpq


@pytest.fixture
def parts():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(600, 16)).astype(np.float32)
    coarse = rng.normal(size=(12, 16)).astype(np.float32)
    cb = rng.normal(scale=0.5, size=(4, 8, 4)).astype(np.float32)
    q = rng.normal(size=(20, 16)).astype(np.float32)
    return x, coarse, cb, q


def np_encode(x, coarse, cb):
    x, coarse, cb = (a.astype(np.float64) for a in (x, coarse, cb))
    lists = ((x[:, None] - coarse[None]) ** 2).sum(-1).argmin(1)
    res = x.astype(np.float64) - coarse[lists]
    m, k, s = cb.shape
    codes = np.stack([((res[:, None, j * s:(j + 1) * s] - cb[j][None]) ** 2).sum(-1).argmin(1)
                      for j in range(m)], 1)
    recon = coarse[lists] + np.concatenate([cb[j][codes[:, j]] for j in range(m)], 1)
    return lists, codes, recon


def test_encode_matches_brute_force(parts):
    x, coarse, cb, _ = parts
    lists, codes, recon = np_encode(x, coarse, cb)
    enc = ivfpq.Encoded(torch.from_numpy(x), torch.from_numpy(coarse), torch.from_numpy(cb))
    assert (enc.lists.numpy() == lists).all() and (enc.codes.numpy() == codes).all()
    np.testing.assert_allclose(enc.recon.numpy(), recon, rtol=1e-6, atol=1e-6)
    assert ivfpq.recon_gap(torch.from_numpy(x), enc.recon, enc) == pytest.approx(0, abs=1e-9)
    wrong = enc.recon.clone()
    wrong[3] += 1.0
    assert ivfpq.recon_gap(torch.from_numpy(x), wrong, enc) > 0.1


def test_search_matches_brute_force(parts):
    x, coarse, cb, q = parts
    lists, _, recon = np_encode(x, coarse, cb)
    nprobe, k = 3, 5
    probed = np.argsort(((q[:, None] - coarse[None]) ** 2).sum(-1), 1, kind="stable")[:, :nprobe]
    d = ((q[:, None].astype(np.float64) - recon[None]) ** 2).sum(-1)
    d[~(lists[None, None, :] == probed[:, :, None]).any(1)] = np.inf
    want = np.sort(d, 1)[:, :k]
    t = [torch.from_numpy(a) for a in (x, coarse, cb, q)]
    enc = ivfpq.Encoded(*t[:3])
    ids, dists = ivfpq.search(t[3], enc, t[1], nprobe, k)
    np.testing.assert_allclose(dists.numpy(), want, rtol=1e-9)
    dg, mg, bad = ivfpq.search_gaps(t[3], ids, dists, enc, t[1], nprobe, k)
    assert dg < 1e-12 and mg < 1e-12 and bad == 0
    dropped = dists.clone()
    dropped[:, -1] += 10.0  # a k-th answer far worse than the reference's
    assert ivfpq.search_gaps(t[3], ids, dropped, enc, t[1], nprobe, k)[1] > 0.1
    moved = ids.clone()
    moved[:, 0] = (moved[:, 0] + 1) % x.shape[0]
    assert ivfpq.search_gaps(t[3], moved, dists, enc, t[1], nprobe, k)[0] > 0.01


def np_step(x, cb):
    """One Lloyd step per subspace in NumPy: an empty cluster keeps its
    centroid."""
    m, k, s = cb.shape
    new = cb.astype(np.float64).copy()
    for j in range(m):
        xj = x[:, j * s:(j + 1) * s].astype(np.float64)
        lab = ((xj[:, None] - new[j][None]) ** 2).sum(-1).argmin(1)
        for c in range(k):
            if (lab == c).any():
                new[j, c] = xj[lab == c].mean(0)
    return new


def test_lloyd_step_matches_numpy(parts):
    x, _, cb, _ = parts
    got, empty = ivfpq.lloyd_step(torch.from_numpy(x), torch.from_numpy(cb), block=128)
    np.testing.assert_allclose(got.numpy(), np_step(x, cb), rtol=1e-9, atol=1e-12)
    assert not empty.any()


def test_lloyd_step_keeps_an_empty_centroid():
    x = torch.tensor([[0.0], [0.1], [10.0]])
    got, empty = ivfpq.lloyd_step(x, torch.tensor([[0.0], [10.0], [100.0]]))
    assert got[0, :, 0].tolist() == pytest.approx([0.05, 10.0, 100.0])
    assert empty.tolist() == [[False, False, True]]


def test_train_matches_numpy(parts):
    x = parts[0]
    rng = np.random.default_rng(3)
    coarse_rows = rng.permutation(600)[:12]
    pq_rows = np.stack([rng.permutation(600)[:8] for _ in range(4)])
    coarse, cb = ivfpq.train(torch.from_numpy(x), torch.from_numpy(coarse_rows),
                             torch.from_numpy(pq_rows), 3)
    want = [x[coarse_rows][None].astype(np.float64)]
    for _ in range(3):
        want.append(np_step(x, want[-1]))
    assert len(coarse) == 4
    for got, w in zip(coarse, want):
        np.testing.assert_allclose(got.numpy(), w[0], rtol=1e-9, atol=1e-12)
    lists = ((x[:, None].astype(np.float64) - want[-1][0][None]) ** 2).sum(-1).argmin(1)
    res = x.astype(np.float64) - want[-1][0][lists]
    np.testing.assert_allclose(ivfpq.residuals(torch.from_numpy(x), coarse[-1]).numpy(), res,
                               rtol=1e-12, atol=1e-12)
    w = np.stack([res[pq_rows[j], j * 4:(j + 1) * 4] for j in range(4)])
    for got in cb:
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-9, atol=1e-12)
        w = np_step(res, w)


def test_step_gap(parts):
    x, _, cb, _ = parts
    xt, start = torch.from_numpy(x), torch.from_numpy(cb).double()
    path = [start]
    for _ in range(3):
        path.append(ivfpq.lloyd_step(xt, path[-1])[0])
    assert ivfpq.step_gap(xt, path) == (0.0, 0)
    assert ivfpq.step_gap(xt, [start] * 4)[0] == pytest.approx(1.0)  # left at its start
    off = [p.clone() for p in path]
    off[3][1, 3] += 0.1  # one centroid off at the last step
    want = (0.2 ** 2 / 3) ** 0.5 / float((path[1] - start).norm())
    assert ivfpq.step_gap(xt, off)[0] == pytest.approx(want)
    coarse = [start[0], path[1][0]]  # [k, d]: one subspace
    assert ivfpq.step_gap(xt[:, :4], coarse)[0] == 0.0
