"""BQ eval harness, the twin of ``vq_tpu.cli.eval_bq``: for each size,
times the quantizer's construction and a quantize of the corpus, reports
the MSE of its dequantized codes (and recall@10 with ``--recall``), and
times the packing of sign bits 32 to a word.

Run: ``python -m vq_tpu_torch.cli.eval_bq [--threshold 0.5] [--sizes ...]``
"""

from __future__ import annotations

from vq_tpu_torch.cli.common import (
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
    p = base_parser("Benchmark binary quantization")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--low", type=int, default=0)
    p.add_argument("--high", type=int, default=1)
    p.add_argument("--recall", action="store_true", help="also compute recall@10")
    args = p.parse_args(argv)

    from vq_tpu_torch.models.base import as_tensor
    from vq_tpu_torch.models.bq import BinaryQuantizer

    get_data, data_tag = resolve_corpus(args)
    results = []
    for n in args.sizes:
        data = as_tensor(get_data(n))  # one upload, outside every timed region
        n = int(data.shape[0])  # file prefixes clamp; record the truth
        with Timer() as t_train:
            q = BinaryQuantizer(args.threshold, args.low, args.high)
        if not args.cold:
            block(q.quantize(data))
        with Timer() as t_enc:
            codes = block(q.quantize(data))
        recon = q.dequantize(codes)
        if not args.cold:
            block(q.quantize_packed(data))
        with Timer() as t_pack:
            packed = block(q.quantize_packed(data))
        extra = {
            "pack_ms": t_pack.ms,
            "packed_bytes_per_vector": int(packed.shape[1]) * 4,
            "raw_bytes_per_vector": args.dim * 4,
            "data": data_tag,
        }
        if not args.cold and (ms := encode_ms_device(q.quantize, data)) is not None:
            extra["encode_ms_device"] = ms
        results.append(BenchmarkResult(
            algorithm="bq", num_samples=n, dim=args.dim, train_ms=t_train.ms,
            encode_ms=t_enc.ms, mse=reconstruction_mse(data, recon),
            recall_at_k=windowed_recall_at_k(data, recon, seed=args.seed) if args.recall else None,
            extra=extra,
        ))
    emit(results, args.output, args.output_append)
    return results


if __name__ == "__main__":
    main()
