"""Tree-structured vector quantization — the port of ``vq_tpu.models.tsvq``.

A binary tree of centroids, flattened into ``centroids [nodes, d]``,
``left [nodes]`` and ``right [nodes]`` (-1 = none) in depth-first
preorder, and a greedy root-to-leaf descent.

**Build.** Each node's centroid is the mean of its rows; it splits on the
dimension of largest summed squared deviation (NaN sums excluded; all NaN
-> dimension 0, the first of equal sums otherwise) at the median of that
dimension's non-NaN values (an even count averages the two middle ones);
``value <= median`` goes left, so NaN rows go right; a child is built
only when its part is non-empty and smaller than its parent. Two build
functions give that tree:

* :func:`tsvq_build` (``build="host"``): the JAX package's numpy
  recursion, copied, so its trees are the JAX host build's, bit for bit.
* :func:`tsvq_build_batched` (``build="device"``): level by level on the
  data's device, every node of a level at once. Its sums run in one fixed
  order on any device (no float atomics, which would move split
  dimensions near ties from run to run): each node's rows in ascending
  row order, added 32 at a time from +0.0, then the partials 32 at a time
  likewise, until one is left. Medians come from one sort of
  ``(node, orderable key)`` pairs, so NaN sorts last whatever its sign.
  Its means and summed deviations differ from the host build's numpy
  sums by rounding alone, so the trees agree except at float near ties.

**Traversal** (:meth:`TSVQ.encode`): at a node with two children the
distances to both child centroids are compared under the quantizer's
metric, ``dl <= dr`` going left; a node with one child descends into it;
a leaf stays. The port holds one traversal, the JAX package's gather
form: each row's two child centroids gathered, squared-L2 distances as
``sum((x - c)^2)`` (:func:`vq_tpu_torch.ops.distance.rowwise`), in row
blocks. The JAX package's TPU forms (scores matmul, level slices) are not
bit-identical to it (``ROADMAP.md``, R2) and are not ported. Summation
orders differ between packages and devices, so leaf ids agree except
where ``dl`` and ``dr`` are a float near tie (:func:`descent_gaps`).

``quantize`` emits the leaf centroid as f16 and ``dequantize`` casts it
back to f32 with a dimension check.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vq_tpu_torch.errors import DimensionMismatch, InvalidParameter
from vq_tpu_torch.models.base import (
    Quantizer,
    as_batch_f32,
    as_tensor,
    check_training_matrix,
    resolve_device,
)
from vq_tpu_torch.ops.cuda_kernels import int_argmin, orderable_key
from vq_tpu_torch.ops.distance import Distance, Metric, _rowwise

__all__ = ["TSVQ", "TSVQTree", "tsvq_build", "tsvq_build_batched", "descent_gaps",
           "split_differences"]

_SUM_ROWS = 32  # terms a partial of the device build's fixed-order sums
_TRAVERSE_CELLS = 1 << 24  # f32 cells of one [rows, d] temporary of the descent


class TSVQTree:
    """Flattened TSVQ tree on one device: ``centroids [nodes, d]`` f32,
    ``left`` / ``right [nodes]`` int32 (-1 = none), and its depth limit.
    A tree from either build function also keeps ``splits``, each node's split as
    numpy ``(dims [nodes] int64, thresholds [nodes] f32)`` (-1 / NaN where
    a node did not split); a tree from a checkpoint has ``splits = None``."""

    def __init__(self, centroids, left, right, depth: int, *, device=None, splits=None):
        self.centroids = as_tensor(centroids, device).to(torch.float32)
        dev = self.centroids.device
        self.left = as_tensor(left, dev).to(torch.int32)
        self.right = as_tensor(right, dev).to(torch.int32)
        self.depth = int(depth)
        self.splits = splits

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    @property
    def num_nodes(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def num_leaves(self) -> int:
        return int(((self.left < 0) & (self.right < 0)).sum())

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    def to(self, device) -> "TSVQTree":
        return TSVQTree(self.centroids, self.left, self.right, self.depth,
                        device=torch.device(device), splits=self.splits)


def _check_depth(max_depth) -> int:
    max_depth = int(max_depth)
    if max_depth < 0:
        raise InvalidParameter("max_depth", "must be non-negative")
    return max_depth


# ---------------------------------------------------------------------------
# Host build: the JAX package's numpy recursion.
# ---------------------------------------------------------------------------


def _build_node(data: np.ndarray, idx: np.ndarray, max_depth: int,
                centroids: list, lefts: list, rights: list, splits: list) -> int:
    """Build the subtree over ``data[idx]``; returns its node id. Each
    node's temporaries are freed before its children are built."""
    subset = data[idx]
    centroid = subset.mean(axis=0, dtype=np.float32)
    node = len(centroids)
    centroids.append(centroid)
    lefts.append(-1)
    rights.append(-1)
    splits.append((-1, np.nan))

    n = idx.shape[0]
    if max_depth == 0 or n <= 1:
        return node

    # Summed (not mean) squared deviation per dimension, NaNs propagating.
    subset -= centroid[None, :]
    variances = np.einsum("ij,ij->j", subset, subset, dtype=np.float32)
    finite = ~np.isnan(variances)
    if finite.any():
        split_dim = int(np.argmax(np.where(finite, variances, -np.inf)))
    else:
        split_dim = 0
    del subset
    # The split column's original values: (x - c) + c can differ by an ulp.
    values_col = data[idx, split_dim]

    finite_vals = values_col[~np.isnan(values_col)]
    if finite_vals.size == 0:
        return node
    half = finite_vals.size // 2
    if finite_vals.size % 2 == 0:
        two = np.partition(finite_vals, [half - 1, half])
        median = float((two[half - 1] + two[half]) / 2.0)
    else:
        median = float(np.partition(finite_vals, half)[half])
    splits[node] = (split_dim, median)

    go_left = values_col <= median  # NaN -> False -> right
    left_idx = idx[go_left]
    right_idx = idx[~go_left]
    del values_col, go_left

    for part, children in ((left_idx, lefts), (right_idx, rights)):
        if 0 < part.shape[0] < n:
            children[node] = _build_node(data, part, max_depth - 1, centroids, lefts, rights,
                                         splits)
    return node


def _splits(pairs) -> tuple:
    dims, thresholds = zip(*pairs)
    return np.asarray(dims, np.int64), np.asarray(thresholds, np.float32)


def tsvq_build(training_data, max_depth: int, *, device=None) -> TSVQTree:
    """Build a TSVQ tree by the host recursion; the tree lands on
    ``device`` (default: the data's device, or the card for non-tensor
    input)."""
    dev = resolve_device(device, training_data)
    host = check_training_matrix(training_data, torch.device("cpu")).numpy()
    max_depth = _check_depth(max_depth)
    centroids: list = []
    lefts: list = []
    rights: list = []
    splits: list = []
    _build_node(host, np.arange(host.shape[0]), max_depth, centroids, lefts, rights, splits)
    return TSVQTree(np.stack(centroids), lefts, rights, max_depth, device=dev,
                    splits=_splits(splits))


# ---------------------------------------------------------------------------
# Device build: every node of a level at once, sums in one fixed order.
# ---------------------------------------------------------------------------


def _fixed_order_sums(term, rows: torch.Tensor, counts: torch.Tensor, d: int) -> torch.Tensor:
    """Per-node sums ``[k, d]`` of ``term(row_ids, node_ids) -> [c, d]``
    over each node's rows, in one fixed order: ``rows`` lists every node's
    rows, node by node, ``counts [k]`` of them; each node's terms are added
    ``_SUM_ROWS`` at a time from +0.0 in list order, and the partials the
    same way, round after round, until one is left a node. Every step is
    an elementwise f32 add, so any device gives the same bits."""
    dev, k = rows.device, counts.shape[0]
    out = torch.zeros((k, d), dtype=torch.float32, device=dev)
    live = counts > 0
    if not bool(live.any()):
        return out
    nodes = torch.nonzero(live)[:, 0]
    counts = counts[nodes]
    values = None  # round 0 reads term(); later rounds the partials
    while True:
        parts = -(-counts // _SUM_ROWS)
        starts = torch.cumsum(counts, 0) - counts
        part_off = torch.cumsum(parts, 0) - parts
        part_node = torch.repeat_interleave(torch.arange(nodes.shape[0], device=dev), parts)
        first = starts[part_node] + (
            torch.arange(part_node.shape[0], device=dev) - part_off[part_node]) * _SUM_ROWS
        end = (starts + counts)[part_node]
        last = int(counts.sum()) - 1
        acc = torch.zeros((part_node.shape[0], d), dtype=torch.float32, device=dev)
        for t in range(_SUM_ROWS):
            pos = first + t
            has = pos < end
            pos = pos.clamp(max=last)
            if values is None:
                add = term(rows[pos], nodes[part_node])
            else:
                add = values[pos]
            acc = torch.where(has[:, None], acc + add, acc)
        if int(parts.max()) == 1:
            out[nodes] = acc
            return out
        values, counts = acc, parts


def _level_stats(x: torch.Tensor, seg: torch.Tensor, ncap: int):
    """``(counts [ncap] int64, means [ncap, d], split_dim [ncap])`` of the
    rows in each frontier slot (``seg == ncap`` is no slot)."""
    n, d = x.shape
    counts = torch.bincount(seg, minlength=ncap + 1)[:ncap]
    rows = torch.sort(seg, stable=True)[1][: int(counts.sum())]
    sums = _fixed_order_sums(lambda r, _: x[r], rows, counts, d)
    means = sums / counts.clamp_min(1).to(torch.float32)[:, None]

    def sq_dev(r, node):
        diff = x[r] - means[node]
        return diff * diff

    devsq = _fixed_order_sums(sq_dev, rows, counts, d)
    # The first largest sum; NaN never wins, and all NaN gives dimension 0.
    split_dim = int_argmin(-devsq)[1].to(torch.int64)
    return counts, means, split_dim


def _level_medians(v: torch.Tensor, seg: torch.Tensor, counts: torch.Tensor, ncap: int):
    """``(median [ncap], valid [ncap])``: each slot's median of its non-NaN
    ``v`` (even counts average the two middle values) and their count."""
    n = v.shape[0]
    key = orderable_key(v).to(torch.int64) + (1 << 31)  # NaN above +inf, -0.0 == +0.0
    order = torch.sort((seg << 32) | key, stable=True)[1]
    sv = v[order]
    nans = torch.bincount(seg[torch.isnan(v)], minlength=ncap + 1)[:ncap]
    valid = counts - nans
    starts = torch.cumsum(counts, 0) - counts
    half = valid // 2
    lo = (starts + (half - 1).clamp_min(0)).clamp(0, n - 1)
    hi = (starts + half).clamp(0, n - 1)
    med = torch.where(valid % 2 == 0, (sv[lo] + sv[hi]) / 2.0, sv[hi])
    return med, valid


def tsvq_build_batched(training_data, max_depth: int, *, device=None) -> TSVQTree:
    """Level-synchronous TSVQ build on the data's device (``device`` moves
    non-tensor input there); the same rules, and the tree renumbered to
    the host recursion's depth-first preorder."""
    x = check_training_matrix(training_data, device).contiguous()
    max_depth = _check_depth(max_depth)
    n, _ = x.shape
    dev = x.device

    bfs_centroids: list = [None]
    bfs_children: list = [(-1, -1)]
    bfs_splits: list = [(-1, np.nan)]
    seg = torch.zeros((n,), dtype=torch.int64, device=dev)  # frontier slot a row
    frontier = [0]
    for level in range(max_depth + 1):
        ncap = len(frontier)
        counts, means, split_dim = _level_stats(x, seg, ncap)
        means_h = means.cpu().numpy()
        for f, node in enumerate(frontier):
            bfs_centroids[node] = means_h[f]
        if level == max_depth:
            break
        active = seg < ncap
        slot = seg.clamp(max=ncap - 1)
        v = torch.gather(x, 1, split_dim[slot][:, None])[:, 0]
        v = torch.where(active, v, torch.nan)
        med, valid = _level_medians(v, seg, counts, ncap)
        go_left = v <= med[slot]  # NaN (and every inactive row) -> right
        left_counts = torch.bincount(seg[go_left & active], minlength=ncap)[:ncap]
        counts_h, valid_h = counts.cpu().numpy(), valid.cpu().numpy()
        med_h, left_h = med.cpu().numpy(), left_counts.cpu().numpy()
        dims_h = split_dim.cpu().numpy()

        new_frontier: list = []
        slot_left = np.full(ncap, -1, np.int64)
        slot_right = np.full(ncap, -1, np.int64)
        for f, node in enumerate(frontier):
            cnt = int(counts_h[f])
            if cnt <= 1 or valid_h[f] == 0 or not np.isfinite(med_h[f]):
                continue  # a leaf: too small, or an all-NaN split column
            bfs_splits[node] = (int(dims_h[f]), med_h[f])
            lc = int(left_h[f])
            left_id = right_id = -1
            if 0 < lc < cnt:
                left_id = len(bfs_centroids)
                slot_left[f] = len(new_frontier)
                new_frontier.append(left_id)
                bfs_centroids.append(None)
                bfs_children.append((-1, -1))
                bfs_splits.append((-1, np.nan))
            if 0 < cnt - lc < cnt:
                right_id = len(bfs_centroids)
                slot_right[f] = len(new_frontier)
                new_frontier.append(right_id)
                bfs_centroids.append(None)
                bfs_children.append((-1, -1))
                bfs_splits.append((-1, np.nan))
            bfs_children[node] = (left_id, right_id)
        if not new_frontier:
            break
        child = torch.where(go_left, torch.as_tensor(slot_left, device=dev)[slot],
                            torch.as_tensor(slot_right, device=dev)[slot])
        seg = torch.where(active & (child >= 0), child, len(new_frontier))
        frontier = new_frontier

    order: list = []
    stack = [0]
    while stack:  # depth-first preorder, left before right
        node = stack.pop()
        order.append(node)
        left_id, right_id = bfs_children[node]
        stack.extend(c for c in (right_id, left_id) if c >= 0)
    remap = {old: new for new, old in enumerate(order)}
    lefts = [remap.get(bfs_children[old][0], -1) for old in order]
    rights = [remap.get(bfs_children[old][1], -1) for old in order]
    return TSVQTree(np.stack([bfs_centroids[old] for old in order]), lefts, rights,
                    max_depth, device=dev, splits=_splits([bfs_splits[old] for old in order]))


def split_differences(data, a: TSVQTree, b: TSVQTree) -> list:
    """Where two builds of a tree from ``data`` split a node differently:
    both trees are walked from the root while their splits agree, each
    node's rows found by replaying the splits above it; at a node whose
    splits differ, ``(node of a, dim_a, dim_b, dev_a, dev_b)`` with the
    float64 summed squared deviations of the node's rows along each
    split dimension (a float near tie has ``dev_a`` close to ``dev_b``).
    The subtrees below such a node are not compared."""
    x = check_training_matrix(data, torch.device("cpu")).numpy()
    (da, ta), (db, tb) = a.splits, b.splits
    la, ra = a.left.cpu().numpy(), a.right.cpu().numpy()
    lb, rb = b.left.cpu().numpy(), b.right.cpu().numpy()
    out = []
    stack = [(0, 0, np.arange(x.shape[0]))]
    while stack:
        na, nb, idx = stack.pop()
        if da[na] != db[nb] or not (ta[na] == tb[nb] or np.isnan(ta[na]) and np.isnan(tb[nb])):
            rows = x[idx].astype(np.float64)
            dev = ((rows - rows.mean(axis=0)) ** 2).sum(axis=0)
            out.append((int(na), int(da[na]), int(db[nb]), float(dev[max(da[na], 0)]),
                        float(dev[max(db[nb], 0)])))
            continue
        if da[na] < 0:
            continue
        go_left = x[idx, da[na]] <= ta[na]
        for ca, cb, part in ((la[na], lb[nb], idx[go_left]), (ra[na], rb[nb], idx[~go_left])):
            if ca >= 0 and cb >= 0:
                stack.append((ca, cb, part))
    return out


# ---------------------------------------------------------------------------
# Traversal.
# ---------------------------------------------------------------------------


def _find_leaves(tree: TSVQTree, x: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Leaf node id ``[n]`` int32 of each row of ``x [n, d]`` (on the
    tree's device), in row blocks of bounded temporaries."""
    n, d = x.shape
    cents, left, right = tree.centroids, tree.left.long(), tree.right.long()
    out = torch.empty((n,), dtype=torch.int32, device=x.device)
    block = max(1, _TRAVERSE_CELLS // max(d, 1))
    for r0 in range(0, n, block):
        xb = x[r0:r0 + block]
        nodes = torch.zeros((xb.shape[0],), dtype=torch.int64, device=x.device)
        for _ in range(tree.depth):
            lc, rc = left[nodes], right[nodes]
            dl = _rowwise(xb, cents[lc.clamp_min(0)], metric)
            dr = _rowwise(xb, cents[rc.clamp_min(0)], metric)
            pick_two = torch.where(dl <= dr, lc, rc)
            pick_one = torch.where(lc >= 0, lc, torch.where(rc >= 0, rc, nodes))
            nodes = torch.where((lc >= 0) & (rc >= 0), pick_two, pick_one)
        out[r0:r0 + block] = nodes.to(torch.int32)
    return out


def descent_gaps(tree: TSVQTree, x, a, b, metric="euclidean") -> np.ndarray:
    """Relative gap ``|dl - dr| / max(dl, dr, 1)`` in float64 at the node
    where the descents to leaves ``a[i]`` and ``b[i]`` part, for each row
    ``i`` where they differ (in row order); a float near tie is a small
    gap."""
    metric = Metric.parse(metric)
    a = as_tensor(a).cpu().numpy().astype(np.int64)
    b = as_tensor(b).cpu().numpy().astype(np.int64)
    rows = np.nonzero(a != b)[0]
    if rows.size == 0:
        return np.zeros((0,), np.float64)
    left, right = tree.left.cpu().numpy(), tree.right.cpu().numpy()
    parent = np.full(left.shape[0], -1, np.int64)
    for children in (left, right):
        has = children >= 0
        parent[children[has]] = np.nonzero(has)[0]

    def path(leaf):
        out = [int(leaf)]
        while parent[out[-1]] >= 0:
            out.append(int(parent[out[-1]]))
        return out[::-1]

    cents = tree.centroids.cpu().to(torch.float64)
    xs = as_tensor(x).cpu().to(torch.float64)
    gaps = []
    for i in rows:
        pa, pb = path(a[i]), path(b[i])
        depth = next(j for j in range(min(len(pa), len(pb))) if pa[j] != pb[j])
        node = pa[depth - 1]
        pair = torch.stack([cents[left[node]], cents[right[node]]])
        dl, dr = _rowwise(xs[i].expand(2, -1), pair, metric).tolist()
        gaps.append(abs(dl - dr) / max(dl, dr, 1.0))
    return np.asarray(gaps, np.float64)


class TSVQ(Quantizer):
    """Tree-structured vector quantizer: ``TSVQ(training_data, max_depth,
    distance=None)`` (Euclidean by default), or a prebuilt ``tree=``.
    ``build`` is ``"host"`` (the recursion) or ``"device"``
    (:func:`tsvq_build_batched` on ``device``); the tree lives on
    ``device`` (default: the data's, or the card for non-tensor input).

    >>> import numpy as np
    >>> data = np.array([[0., 0.], [0., 1.], [10., 0.], [10., 1.]], np.float32)
    >>> t = TSVQ(data, max_depth=1, device="cpu")
    >>> t.quantize(np.array([9.5, 0.4], np.float32)).float().tolist()
    [10.0, 0.5]
    """

    def __init__(self, training_data=None, max_depth: Optional[int] = None, distance=None, *,
                 tree: Optional[TSVQTree] = None, build: str = "host", device=None):
        self._metric = distance.metric if isinstance(distance, Distance) else Metric.parse(distance)
        if tree is not None:
            self._tree = tree if device is None else tree.to(device)
            return
        if training_data is None or max_depth is None:
            raise InvalidParameter(
                "training_data/max_depth", "required when a prebuilt tree is not given"
            )
        if build == "device":
            self._tree = tsvq_build_batched(training_data, max_depth, device=device)
        elif build == "host":
            self._tree = tsvq_build(training_data, max_depth, device=device)
        else:
            raise InvalidParameter("build", f"expected 'host' or 'device', got {build!r}")

    @property
    def tree(self) -> TSVQTree:
        return self._tree

    @property
    def device(self) -> torch.device:
        return self._tree.device

    @property
    def dim(self) -> int:
        return self._tree.dim

    @property
    def max_depth(self) -> int:
        return self._tree.depth

    @property
    def num_nodes(self) -> int:
        return self._tree.num_nodes

    @property
    def num_leaves(self) -> int:
        return self._tree.num_leaves

    @property
    def distance_metric(self) -> str:
        return self._metric.value

    @property
    def distance(self) -> Distance:
        return Distance(self._metric)

    def _rows(self, x):
        x2d, was_1d = as_batch_f32(x, self.device)
        if x2d.shape[1] != self.dim:
            raise DimensionMismatch(expected=self.dim, found=x2d.shape[1])
        return x2d, was_1d

    def encode(self, x) -> torch.Tensor:
        """Leaf node ids ``[n]`` int32 of the rows of ``x``."""
        x2d, was_1d = self._rows(x)
        nodes = _find_leaves(self._tree, x2d, self._metric)
        return nodes[0] if was_1d else nodes

    def decode(self, nodes) -> torch.Tensor:
        """Node ids (any shape) -> their f32 centroids."""
        return self._tree.centroids[as_tensor(nodes, self.device).long()]

    def quantize(self, x) -> torch.Tensor:
        """The leaf centroid of each row, as f16."""
        x2d, was_1d = self._rows(x)
        recon = self.decode(_find_leaves(self._tree, x2d, self._metric)).to(torch.float16)
        return recon[0] if was_1d else recon

    def dequantize(self, quantized) -> torch.Tensor:
        """f16 (or any) values -> f32, with a dimension check."""
        q = as_tensor(quantized)
        d = q.shape[-1] if q.ndim else 0
        if d != self.dim:
            raise DimensionMismatch(expected=self.dim, found=d)
        return q.to(torch.float32)

    def __repr__(self) -> str:
        return (
            f"TSVQ(dim={self.dim}, max_depth={self.max_depth}, "
            f"nodes={self.num_nodes}, distance={self._metric.value!r})"
        )
