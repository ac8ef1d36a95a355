"""Builds the CUDA kernels in ``vq_tpu_torch/csrc`` on first use and loads
them with ctypes.

The sources (K1 ``assign.cu``, K2 ``lloyd.cu``, K3 ``pq_lloyd.cu``, K4 with
K4-bf16 and K4-bf16x3 ``pq_encode.cu``, K5 ``adc_topk.cu``, K6
``ivf_matvec.cu``, K7 ``ivf_probe.cu``, K8 ``adc_lookup.cu``, and the
benchmark twins' B1 ``mpacked_encode.cu`` and B2-B4 ``adc_variants.cu``)
compile with
``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds): one ``nvcc -c``
a source, all started together, then one link. The library lands in
``build/vq_tpu_torch/<hash>/`` beside the package's
checkout, keyed by a hash of the sources and flags, so an edited kernel
is rebuilt and an unchanged one is loaded as it is. Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()``.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into
one FMA; the kernels also spell every rounding out with ``__fmul_rn`` /
``__fadd_rn``, so their arithmetic matches the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "vq_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # x, x_is_bf16, cb, cc, codes, n, m, k, s, resident, stages, smem,
    # rows_per_block, stream
    "vq_pq_encode": (_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _LL, _P),
    # x, x_is_bf16, frag, ccp, codes, n, m, k, s, max_blocks, bf16x3, stream
    "vq_pq_encode_lowp": (_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P),
    # tables, codes, codes_are_u8, out, nq, m, k, n, stream
    "vq_adc_lookup": (_P, _P, _I, _P, _I, _I, _I, _LL, _P),
    # x, cb, cc, codes, minval, partials, chunk_counts, totals, offsets,
    # perm, seg_off, pseg_off, seg_cluster, psums, sums, counts, inertia,
    # n, m, k, s, resident, stages, smem, scan_rows, rows_per_chunk,
    # chunks, max_segs, vec, stream
    "vq_pq_lloyd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                    _P, _P, _LL, _I, _I, _I, _I, _I, _I, _LL, _LL, _I, _LL, _I, _P),
    # tables, codes_t, qn2, offsets, vals, ids, nq, m, k, kpad, n, tile,
    # fetch, mode, pack_bits, tab_in_smem, ntiles, stream
    "vq_adc_topk": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _I,
                    _I, _I, _I, _I, _I, _P),
    # x, x_is_bf16, c, cc, codes, dists, n, k, d, stream
    "vq_assign": (_P, _I, _P, _P, _P, _P, _LL, _I, _I, _P),
    # x, weights (null: none), c, cc, codes, dists, chunk_counts, totals,
    # offsets, perm, seg_off, pseg_off, seg_cluster, psums, pcounts, sums,
    # counts, inertia, n, k, d, rows_per_chunk, chunks, max_segs, vec,
    # stream
    "vq_lloyd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                 _P, _P, _P, _LL, _I, _I, _LL, _I, _LL, _I, _P),
    # tables, chunks, codes, codes_are_u8, out, scratch, pairs, m, kk, nc,
    # ch, n_chunks, cap, seg_len, segs, stream
    "vq_ivf_probe": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _LL,
                     _I, _I, _P),
    # chunks, scratch, pairs, nc, n_chunks, seg_len, segs, stream
    "vq_ivf_probe_plan": (_P, _P, _I, _I, _I, _I, _I, _P),
    # chunks, scratch, pairs, nc, ch, n_chunks, cap, seg_len, segs, stream
    "vq_ivf_matvec_plan": (_P, _P, _I, _I, _I, _I, _LL, _I, _I, _P),
    # lhs, chunks, payload, payload_type, out, scratch, pairs, d, nc, ch,
    # n_chunks, cap, seg_len, segs, vec, qvec, stream
    "vq_ivf_matvec": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _LL, _I, _I, _I, _I, _P),
    # x, x_is_bf16, wt, cc, codes, n, d, m, rows_per_block, stream
    "vq_mpacked_highest": (_P, _I, _P, _P, _P, _LL, _I, _I, _LL, _P),
    # x, x_is_bf16, img, cc, codes, n, d, m, kb, streamed, stages, xslots,
    # group, units, stream
    "vq_mpacked_default": (_P, _I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _I, _LL, _P),
    # slabs, codes_t, out, nq, m, ksteps, slab_bytes, n, groups, units,
    # stream
    "vq_adc_kt": (_P, _P, _P, _I, _I, _I, _I, _LL, _I, _LL, _P),
    # tables, codes_t, out, nq, m, k, n, subspaces, queries, smem, vec,
    # stream
    "vq_adc_gather": (_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I, _P),
    # tables, codes_t, out, nq, n, q_per_block, vec, stream
    "vq_adc_floor": (_P, _P, _P, _I, _LL, _I, _I, _P),
}


class NvccError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


class _Library:
    """The loaded kernel library, built at most once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None
        self.path: Optional[Path] = None
        self.log = ""

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self) -> ctypes.CDLL:
        sources = sorted(CSRC.glob("*.cu"))
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.glob("*.cu*")):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        out_dir = BUILD_ROOT / digest.hexdigest()[:16]
        lib_path = out_dir / "libvq_kernels.so"
        t0 = time.perf_counter()
        if not lib_path.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            self.log = _compile(out_dir, sources, lib_path)
        else:
            log = out_dir / "build.log"
            self.log = log.read_text() if log.exists() else ""
        self.build_seconds = time.perf_counter() - t0
        self.path = lib_path
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return lib


def _compile(out_dir: Path, sources, lib_path: Path) -> str:
    """One ``nvcc -c`` a source in parallel, then the link; returns the
    log (ptxas register and spill report included) and writes it to
    ``build.log``. Every temporary name carries the pid, and the library
    lands by an atomic rename, so concurrent builds are harmless."""
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out_dir / f"{src.stem}.{pid}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    tmp = out_dir / f"libvq_kernels.{pid}.so"
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
    log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
    failed = [c[-3] for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = ["link"]
    (out_dir / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise NvccError(f"nvcc failed on {failed}:\n{log[-4000:]}")
    os.replace(tmp, lib_path)
    return log


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise NvccError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of vq_tpu_torch are built from source on first use"
        )
    return found


LIBRARY = _Library()
