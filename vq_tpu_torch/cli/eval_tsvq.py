"""TSVQ eval harness, the twin of ``vq_tpu.cli.eval_tsvq``: for each
size, a tree built by the host recursion, a timed encode on the device,
and the MSE (and recall@10 with ``--recall``) of the leaf centroids.

With synthetic rows the tree is built on the host draw
(``generate_synthetic_data(device=False)``, the JAX package's rows) and
the encode runs on rows drawn on the device with ``seed + 1``, as in the
JAX package (whose device draw differs from this one); a ``--data`` or
clustered corpus builds and encodes the same rows. The host build has no
compile to warm, so it runs once.

Run: ``python -m vq_tpu_torch.cli.eval_tsvq [--max-depth 5]``
"""

from __future__ import annotations

from vq_tpu_torch.cli.common import (
    TSVQ_DEPTH,
    BenchmarkResult,
    Timer,
    base_parser,
    block,
    emit,
    encode_ms_device,
    generate_synthetic_data,
    reconstruction_mse,
    resolve_corpus,
    windowed_recall_at_k,
)


def main(argv=None) -> list:
    """Run the sweep, print (or write) its rows, and return them."""
    p = base_parser("Benchmark tree-structured VQ")
    p.add_argument("--max-depth", type=int, default=TSVQ_DEPTH)
    p.add_argument("--distance", type=str, default="euclidean")
    p.add_argument("--recall", action="store_true", help="also compute recall@10")
    args = p.parse_args(argv)

    from vq_tpu_torch.models.base import as_tensor
    from vq_tpu_torch.models.tsvq import TSVQ

    get_data, data_tag = resolve_corpus(args)
    results = []
    for n in args.sizes:
        if data_tag == "synthetic":
            data = generate_synthetic_data(n, args.dim, args.seed, device=False)
        else:
            data = get_data(n)
            n = int(data.shape[0])  # file prefixes clamp; record the truth
        with Timer() as t_train:
            q = TSVQ(data, max_depth=args.max_depth, distance=args.distance)
            block(q.tree.centroids)
        if data_tag == "synthetic":
            data = generate_synthetic_data(n, args.dim, args.seed + 1)
        else:
            data = as_tensor(data, q.device)
        if not args.cold:
            block(q.encode(data))
        with Timer() as t_enc:
            codes = block(q.encode(data))
        recon = q.decode(codes)
        extra = {
            "max_depth": args.max_depth,
            "nodes": q.num_nodes,
            "leaves": q.num_leaves,
            "data": data_tag,
        }
        if not args.cold and (ms := encode_ms_device(q.encode, data)) is not None:
            extra["encode_ms_device"] = ms
        results.append(BenchmarkResult(
            algorithm="tsvq", num_samples=n, dim=args.dim, train_ms=t_train.ms,
            encode_ms=t_enc.ms, mse=reconstruction_mse(data, recon),
            recall_at_k=windowed_recall_at_k(data, recon, seed=args.seed) if args.recall else None,
            extra=extra,
        ))
    emit(results, args.output, args.output_append)
    return results


if __name__ == "__main__":
    main()
