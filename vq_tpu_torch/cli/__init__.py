"""Eval harnesses, twins of ``vq_tpu.cli``: one module a quantizer of the
source library (``eval_bq``, ``eval_sq``, ``eval_pq``, ``eval_tsvq``),
with the JAX package's flags and JSON rows, on the card.

Run as modules: ``python -m vq_tpu_torch.cli.eval_pq --sizes 1000 10000``.
"""
