"""PQ eval harness, the twin of ``vq_tpu.cli.eval_pq``: for each size,
codebooks trained on the corpus (Lloyd's algorithm, K3 on the card), a
timed encode (K4), and the MSE (and recall@10 with ``--recall``) of the
decoded codes.

Run: ``python -m vq_tpu_torch.cli.eval_pq [--m 16] [--k 256] [--max-iters 10]``
"""

from __future__ import annotations

from vq_tpu_torch.cli.common import (
    MAX_ITERS,
    PQ_K,
    PQ_M,
    BenchmarkResult,
    Timer,
    base_parser,
    block,
    emit,
    encode_ms_device,
    reconstruction_mse,
    resolve_corpus,
    windowed_recall_at_k,
)


def main(argv=None) -> list:
    """Run the sweep, print (or write) its rows, and return them."""
    p = base_parser("Benchmark product quantization")
    p.add_argument("--m", type=int, default=PQ_M, help="number of subspaces")
    p.add_argument("--k", type=int, default=PQ_K, help="centroids per subspace")
    p.add_argument("--max-iters", type=int, default=MAX_ITERS)
    p.add_argument("--distance", type=str, default="euclidean")
    p.add_argument("--recall", action="store_true", help="also compute recall@10")
    args = p.parse_args(argv)

    from vq_tpu_torch.models.base import as_tensor
    from vq_tpu_torch.models.pq import ProductQuantizer

    get_data, data_tag = resolve_corpus(args)
    results = []
    for n in args.sizes:
        data = as_tensor(get_data(n))  # one upload, outside every timed region
        n = int(data.shape[0])  # file prefixes clamp; record the truth

        def fit():
            return ProductQuantizer(data, num_subspaces=args.m, num_centroids=args.k,
                                    max_iters=args.max_iters, distance=args.distance,
                                    seed=args.seed)

        if not args.cold:  # the same seeded training, once before it is timed
            block(fit().codebooks)
        with Timer() as t_train:
            q = fit()
            block(q.codebooks)
        if not args.cold:
            block(q.encode(data))
        with Timer() as t_enc:
            codes = block(q.encode(data))
        recon = q.decode(codes)
        extra = {
            "m": args.m,
            "k": args.k,
            "code_bytes_per_vector": int(codes.shape[1]) * codes.element_size(),
            "data": data_tag,
        }
        if not args.cold and (ms := encode_ms_device(q.encode, data)) is not None:
            extra["encode_ms_device"] = ms
        results.append(BenchmarkResult(
            algorithm="pq", num_samples=n, dim=args.dim, train_ms=t_train.ms,
            encode_ms=t_enc.ms, mse=reconstruction_mse(data, recon),
            recall_at_k=windowed_recall_at_k(data, recon, seed=args.seed) if args.recall else None,
            extra=extra,
        ))
    emit(results, args.output, args.output_append)
    return results


if __name__ == "__main__":
    main()
