"""SQ eval harness, the twin of ``vq_tpu.cli.eval_sq``: for each size, the
quantizer fitted to the corpus's global range, a timed quantize, and the
MSE (and recall@10 with ``--recall``) of its dequantized codes.

Run: ``python -m vq_tpu_torch.cli.eval_sq [--levels 256] [--sizes ...]``
"""

from __future__ import annotations

from vq_tpu_torch.cli.common import (
    SQ_LEVELS,
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
    p = base_parser("Benchmark scalar quantization")
    p.add_argument("--levels", type=int, default=SQ_LEVELS)
    p.add_argument("--recall", action="store_true", help="also compute recall@10")
    args = p.parse_args(argv)

    from vq_tpu_torch.models.base import as_tensor
    from vq_tpu_torch.models.sq import ScalarQuantizer

    get_data, data_tag = resolve_corpus(args)
    results = []
    for n in args.sizes:
        data = as_tensor(get_data(n))  # one upload, outside every timed region
        n = int(data.shape[0])  # file prefixes clamp; record the truth
        if not args.cold:
            float(data.min()), float(data.max())
        with Timer() as t_train:
            q = ScalarQuantizer(float(data.min()), float(data.max()), args.levels)
        if not args.cold:
            block(q.quantize(data))
        with Timer() as t_enc:
            codes = block(q.quantize(data))
        recon = q.dequantize(codes)
        extra = {"levels": args.levels, "data": data_tag}
        if not args.cold and (ms := encode_ms_device(q.quantize, data)) is not None:
            extra["encode_ms_device"] = ms
        results.append(BenchmarkResult(
            algorithm="sq", num_samples=n, dim=args.dim, train_ms=t_train.ms,
            encode_ms=t_enc.ms, mse=reconstruction_mse(data, recon),
            recall_at_k=windowed_recall_at_k(data, recon, seed=args.seed) if args.recall else None,
            extra=extra,
        ))
    emit(results, args.output, args.output_append)
    return results


if __name__ == "__main__":
    main()
