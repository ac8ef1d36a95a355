"""The card's published peaks and the kernels' least times.

Frozen here so that a change to the program cannot move the yardstick.
NVIDIA's data sheet for the H100 SXM at 700 W, dense rates: HBM at
3.35 TB/s, 67 TFLOP/s in fp32 on the CUDA cores, 989 TFLOP/s in bf16 on
the tensor cores.

Each count reads every input byte once and writes every output byte once,
whatever a kernel reads again, and counts the work these inputs need (the
live rows of the probed lists, not their padded width).
"""

from __future__ import annotations

HBM_BPS = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12


def bound(nbytes: float, flops: float, peak: float = PEAK_F32) -> float:
    """The least time in seconds the card could take: the larger of bytes
    over HBM bandwidth and operations over ``peak``."""
    return max(nbytes / HBM_BPS, flops / peak)


def k1_assign(n: int, nlist: int, d: int) -> float:
    """K1 (``assign_kernel``): the nearest of ``nlist`` centres for ``n``
    f32 rows of width ``d``; writes a label and a distance a row."""
    return bound(n * d * 4 + nlist * d * 4 + n * 8, 2.0 * n * nlist * d)


def k4_encode(n: int, m: int, k: int, s: int) -> float:
    """K4 (exact PQ encode): ``n`` f32 rows of ``m`` subspaces of width
    ``s`` against ``k`` centroids each; writes ``m`` codes a row (int32)."""
    return bound(n * m * s * 4 + m * k * s * 4 + n * m * 4, 2.0 * n * m * k * s)


def k7_probe(code_rows: int, pair_rows: int, pairs: int, m: int, k: int) -> float:
    """K7 (IVF ADC probe): the codes of ``code_rows`` live rows (``m``
    bytes each, each chunk read once however many queries probe it), a
    ``[m, k]`` f32 table a (query, list) pair, one f32 sum written for
    each of the ``pair_rows`` live rows of the probed pairs, ``m`` adds
    each."""
    return bound(code_rows * m + pairs * m * k * 4 + pair_rows * 4, 1.0 * pair_rows * m)
