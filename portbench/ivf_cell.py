"""What the IVF-PQ cells share: the set-up (data from the seed, the
program's trainers from starts the benchmark draws, an ``IVFPQIndex``
over what they trained, ``add``), the faults a test can plant in the
program, and the comparison with the plain reference."""

from __future__ import annotations

import contextlib

import torch

from portbench import data
from portbench.reference import ivfpq as ref

FAULTS = ("state_unchanged", "answer_altered", "code_altered")


def device_scope(b):
    if b.device == "cpu":
        import vq_tpu_torch

        return vq_tpu_torch.default_device("cpu")
    return contextlib.nullcontext()


def sync(b) -> None:
    if b.device == "cuda":
        torch.cuda.synchronize()


def plant(b) -> None:
    """Plants ``b.fault`` in the program (the tests' and the chip's fault
    runs; never in the benchmark's own runs)."""
    if b.fault is None:
        return
    if b.fault not in FAULTS:
        raise SystemExit(f"portbench: unknown fault {b.fault!r} for this cell")
    import vq_tpu_torch as vt
    import vq_tpu_torch.ivf as ivf

    if b.fault == "state_unchanged":  # the trainers return their start
        lloyd, pq_train = vt.lloyd, vt.pq_train
        vt.lloyd = lambda *a, **kw: lloyd(*a, **{**kw, "max_iters": 0})
        vt.pq_train = lambda *a, **kw: pq_train(*a, **{**kw, "max_iters": 0})
    elif b.fault == "answer_altered":  # one answer a query moved to another row
        search = ivf.IVFPQIndex.search

        def altered(self, *a, **kw):
            ids, d = search(self, *a, **kw)
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % self.ntotal
            return ids, d

        ivf.IVFPQIndex.search = altered
    elif b.fault == "code_altered":  # one subspace's code of every row moved
        encode = ivf.ProductQuantizer.encode

        def altered_encode(self, x, *a, **kw):
            c = encode(self, x, *a, **kw).clone()
            c[:, 0] = (c[:, 0].to(torch.int64) + 1).remainder(self.num_centroids).to(c.dtype)
            return c

        ivf.ProductQuantizer.encode = altered_encode


def start_rows(cfg: dict, n_train: int, device):
    """The trainers' starts, as faiss draws its k-means starts: ``nlist``
    distinct rows of the training sample for the coarse centres, and for
    each subspace ``pq_k`` distinct rows, whose residuals' sub-vectors
    start the codebooks. Drawn from the configuration's ``data_seed``, so
    every run trains the same index -> ``(coarse_rows [nlist], pq_rows
    [m, k])``."""
    g = data.generator(int(cfg["generator"]["data_seed"]), 5, device)
    coarse = torch.randperm(n_train, generator=g, device=device)[:cfg["nlist"]]
    pq = torch.stack([torch.randperm(n_train, generator=g, device=device)[:cfg["pq_k"]]
                      for _ in range(cfg["pq_m"])])
    return coarse, pq


def build(b):
    """The set-up: the data on the device; the program's trainers from the
    drawn starts, one Lloyd iteration a call so that the reference can
    follow each step: ``lloyd`` (``eps=0``: every iteration runs, as
    faiss runs them), then ``pq_train`` on the residuals, as
    ``IVFPQIndex.train`` trains; an ``IVFPQIndex`` over what they reached;
    ``add`` of the base rows in the cell's blocks. Returns ``(index, base,
    queries, train, starts, paths)``, ``paths`` the coarse centres' and
    the codebooks' start and steps."""
    import vq_tpu_torch as vt

    cfg = b.config
    plant(b)
    base, queries, train = data.ivf_data(cfg, b.seed, b.device)
    starts = start_rows(cfg, train.shape[0], train.device)
    iters = int(cfg["train_iters"])
    coarse = [train[starts[0]]]
    for _ in range(iters):
        km = vt.lloyd(train, cfg["nlist"], max_iters=1, eps=0.0, init_centroids=coarse[-1])
        coarse.append(km.centroids)
    res = train - coarse[-1][km.assignments.to(torch.int64)]
    cb = [ref.subvectors(res, starts[1])]
    for _ in range(iters):
        cb.append(vt.pq_train(res, cfg["pq_m"], cfg["pq_k"], max_iters=1, init_codebooks=cb[-1]))
    idx = vt.IVFPQIndex(coarse[-1],
                        vt.ProductQuantizer(codebooks=cb[-1], distance="squared_euclidean"))
    add_blocks(idx, base, cfg["add_blocks"])
    sync(b)
    return idx, base, queries, train, starts, (coarse, cb)


def add_blocks(idx, base, blocks: int) -> None:
    step = -(-base.shape[0] // blocks)
    for lo in range(0, base.shape[0], step):
        idx.add(base[lo:lo + step])


def reconstruct_all(idx, n: int, block: int = 131_072) -> torch.Tensor:
    """The program's reconstruction of every row, by its public
    ``reconstruct``."""
    dev = idx.coarse.device
    return torch.cat([idx.reconstruct(torch.arange(lo, min(lo + block, n), device=dev))
                      .to(torch.float32) for lo in range(0, n, block)])


class Side:
    """What one side built: the program, or the control in its place. The
    path of its coarse centres and of its codebooks (start and steps), the
    rows it stores as they read back (``recon``) and how many it stores."""

    def __init__(self, paths, recon, stored: int):
        self.coarse_path, self.pq_path = paths
        self.coarse, self.codebooks = self.coarse_path[-1], self.pq_path[-1]
        self.recon, self.stored = recon, stored


def program_side(idx, paths, n: int) -> Side:
    """The program's side: its trainers' steps, and the rows read back
    through its public ``reconstruct``."""
    return Side(paths, reconstruct_all(idx, n), idx.ntotal)


def control_side(b, base, train, starts) -> tuple:
    """The control: the reference in float32 with TF32 products in the
    program's place, from the same starts -> ``(Side, its index)``."""
    with tf32():
        paths = ref.train(train, starts[0], starts[1], int(b.config["train_iters"]),
                          torch.float32)
        enc = ref.Encoded(base, paths[0][-1], paths[1][-1], dtype=torch.float32)
    return Side(paths, enc.recon, base.shape[0]), enc


def index_checks(b, side: Side, base, train):
    """The numbers that hold a side's training and stored rows to the
    reference -> ``(checks, encoded)``: ``coarse_step_gap`` and
    ``pq_step_gap``, how far each trainer's steps stray from Lloyd's from
    the same centroids (the codebooks' on the residuals to the side's
    coarse centres); ``recon_gap`` of every stored row against the reference's
    encode with the side's (so judged) centres and codebooks, which it
    returns for the search's checks."""
    lim = b.limits
    coarse_gap, e1 = ref.step_gap(train, side.coarse_path)
    pq_gap, e2 = ref.step_gap(ref.residuals(train, side.coarse), side.pq_path)
    if e1 or e2:
        b.log(f"training: {e1} coarse and {e2} codebook centroids left empty over the steps")
    checks = [("rows_stored_gap", float(abs(side.stored - base.shape[0])), 0.0),
              ("coarse_step_gap", coarse_gap, lim["coarse_step_gap"]),
              ("pq_step_gap", pq_gap, lim["pq_step_gap"])]
    enc = ref.Encoded(base, side.coarse, side.codebooks)
    checks.append(("recon_gap", ref.recon_gap(base, side.recon, enc), lim["recon_gap"]))
    return checks, enc


def report_quality(b, q, ids, base, enc, coarse, k: int, nprobe: int) -> None:
    """Logs recall@k of the judged answers against exact search over the
    base rows, and the list sizes' imbalance."""
    hits = 0
    for lo in range(0, q.shape[0], 1024):
        d = _sqdist_blocks(q[lo:lo + 1024], base)
        gt = torch.topk(d, k, dim=1, largest=False).indices
        hits += int((ids[lo:lo + 1024, :, None].to(gt.device) == gt[:, None, :]).any(-1).sum())
    mx, fac = imbalance(enc.lists, coarse.shape[0])
    b.log(f"recall@{k} at nprobe {nprobe}: {hits / (q.shape[0] * k):.4f} over {q.shape[0]} "
          f"queries; list sizes max/mean {mx:.3f}, imbalance factor {fac:.4f}")


def _sqdist_blocks(q, base, block: int = 262_144):
    return torch.cat([ref.sqdist(q.to(torch.float32), base[lo:lo + block])
                      for lo in range(0, base.shape[0], block)], dim=1)


def probe_counters(batches, enc, coarse, nprobe: int, codebooks) -> dict:
    """What K7's bound needs, summed over the window's calls: the live rows
    of the lists each call probes (each list once), the live rows of its
    (query, list) pairs, and the pairs; the list sizes are the reference's.
    ``batches`` holds ``(queries, calls)``: each distinct batch and how
    many of the window's calls sent it."""
    sizes = torch.bincount(enc.lists, minlength=coarse.shape[0]).to(torch.float64)
    code_rows = pair_rows = pairs = 0.0
    for qb, times in batches:
        _, probed = ref.probe_lists(qb.to(coarse.device), coarse, nprobe, torch.float32)
        code_rows += times * float((probed.any(0).to(torch.float64) * sizes).sum())
        pair_rows += times * float((probed.to(torch.float64) * sizes[None]).sum())
        pairs += times * float(probed.sum())
    m, kk, _ = codebooks.shape
    return {"k7.code_rows": code_rows, "k7.pair_rows": pair_rows, "k7.pairs": pairs,
            "pq.m": m, "pq.k": kk}


@contextlib.contextmanager
def tf32():
    """The control's precision: float32 products on TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def imbalance(lists: torch.Tensor, nlist: int) -> tuple:
    """``(max / mean, faiss's imbalance factor)`` of the list sizes."""
    sizes = torch.bincount(lists, minlength=nlist).to(torch.float64)
    return (float(sizes.max() / sizes.mean()),
            float(nlist * (sizes ** 2).sum() / sizes.sum() ** 2))
