"""The benchmark twins' kernels B1 (``vq_tpu_torch.benchmarks.mpacked_encode``)
and B2-B4 (``vq_tpu_torch.benchmarks.adc_vmem_bench``) against the TPU
kernels of ``benchmarks/mpacked_encode.py`` and
``benchmarks/adc_vmem_bench.py``.

The JAX functions are loaded from the script files (nothing under
``benchmarks/`` is a package) and run in Pallas interpret mode on the CPU;
the port's wrappers run their plain versions on CPU tensors, the
arithmetic the CUDA kernels are held to on the card
(``test_torch_cuda.py``). Both get the same seeded numpy inputs.

Tolerances: B2, B3 and B4 bit for bit. B1 codes equal except at near
ties: the two candidates' scores, recomputed in float64 on the operands
the precision rounds, within 1e-5 of max(|score|, 1) (JAX's CPU dot sums
in another order than the ascending one of the port). B3 is held to JAX
on in-range codes only: for a code >= k the interpret path gives NaN
(numpy's fill mode), the port 0.0 (K8's rule).
"""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_tpu_torch.benchmarks import adc_vmem_bench as tav
from vq_tpu_torch.benchmarks import mpacked_encode as tmp
from vq_tpu_torch.errors import InvalidParameter
from vq_tpu_torch.models.base import default_device
from vq_tpu_torch.ops import cuda_kernels as ck
from test_torch_cuda import _ADC, _MPACKED
from test_torch_pq import one_torch_thread  # noqa: F401  (an autouse fixture)

_SCRIPTS = Path(__file__).resolve().parent.parent / "benchmarks"


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """The port runs on the card by default; these tests ask for the CPU."""
    with default_device("cpu"):
        yield


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}", _SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jmp():
    return _load("mpacked_encode")


@pytest.fixture(scope="module")
def jav():
    return _load("adc_vmem_bench")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def enc(jmp):
    """n = 300 rows (ragged against the 128-row block), d = 32, m = 4,
    k = 256, with the script's ``build_w`` operands."""
    rng = np.random.default_rng(60)
    x = rng.random((300, 32), dtype=np.float32)
    cb = rng.random((4, 256, 8), dtype=np.float32)
    w, cc = jmp.build_w(cb)
    return x, cb, w, cc


def _assert_codes(got, want, x, w, cc, precision):
    flips, gap, ties = tmp.near_ties(_t(x), _t(w), _t(cc), _t(got), _t(want), precision)
    assert ties, (flips, gap)


def test_build_w_matches_script(jmp, enc):
    _, cb, w, cc = enc
    tw, tcc = tmp.build_w(_t(cb))
    np.testing.assert_array_equal(tw.numpy(), w)
    np.testing.assert_allclose(tcc.numpy(), cc, rtol=1e-6)  # fp32 summation order of ||c||^2


@pytest.mark.parametrize("operand", ["build_w", "dense"])
def test_mpacked_highest_matches_jax(jmp, enc, operand):
    """Any W, not only build_w's block-diagonal one: a dense Gaussian W
    shows the twin assumes nothing about its structure."""
    x, _, w, cc = enc
    if operand == "dense":
        w = np.random.default_rng(61).standard_normal(w.shape).astype(np.float32)
    want = np.asarray(jmp.mpacked_encode(x, w, cc, 128, "highest", interpret=True))
    got = tmp.mpacked_encode(_t(x), _t(w), _t(cc), "highest")
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    _assert_codes(got.numpy(), want, x, w, cc, "highest")


def test_mpacked_highest_equals_k4_plain(enc):
    """On build_w operands B1's scores are K4's exactly: x*(-2c) is
    -2*(x*c), the zero blocks add nothing, and (-2 dot) + cc is cc - 2 dot
    (both ||c||^2 from the port's build_w, as K4 takes it)."""
    x, cb, _, _ = enc
    w, cc = tmp.build_w(_t(cb))
    got = tmp.mpacked_encode(_t(x), w, cc, "highest")
    assert torch.equal(got, ck.pq_encode_plain(_t(x), _t(cb), "highest"))


@pytest.mark.parametrize("dtype", ["bf16_valued_f32", "bf16"])
def test_mpacked_default_matches_jax(jmp, enc, dtype):
    """On the CPU JAX's DEFAULT dot of f32 is f32, so both packages get
    bf16-valued operands: f32 arrays already rounded to bf16, or true bf16
    arrays (the bf16-resident variant)."""
    x, _, w, cc = enc
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    if dtype == "bf16":
        want = np.asarray(jmp.mpacked_encode(xb, wb, cc, 128, "default", interpret=True))
        tx, tw = _t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    else:
        xv, wv = np.asarray(xb.astype(jnp.float32)), np.asarray(wb.astype(jnp.float32))
        want = np.asarray(jmp.mpacked_encode(xv, wv, cc, 128, "default", interpret=True))
        tx, tw = _t(xv), _t(wv)
    got = tmp.mpacked_encode(tx, tw, _t(cc), "default")
    _assert_codes(got.numpy(), want, tx.float().numpy(), tw.float().numpy(), cc, "default")


@pytest.mark.parametrize("block_rows", [192, 256, 512])
@pytest.mark.parametrize("shape", _MPACKED, ids=lambda s: "n%d-d%d-m%d-%s" % s)
def test_mpacked_plan_covers_every_card_shape(shape, block_rows):
    """B1's plans at each shape of the card's tests: the units cover n,
    the boxes d; a resident plan keeps a unit's four m-tiles and a whole
    subspace's boxes in shared memory, a streamed one four stages of one
    W box and two x boxes; both fit 227 KiB; a block's rows round
    ``block_rows`` up to the row unit; W is read once a unit (a tile)."""
    n, d, m, _ = shape
    p = tmp.mpacked_plan(n, d, m, block_rows)
    assert p["boxes"] * 64 == p["d_pad"] >= d > p["d_pad"] - 64
    assert p["units"] * p["rows"] >= n > (p["units"] - 1) * p["rows"]
    assert p["streamed"] == (p["d_pad"] > 192)
    if p["streamed"]:
        assert (p["rows"], p["stages"], p["x_slots"]) == (128, 4, 0)
        assert p["smem"] == 1024 + 4 * (32768 + 2 * 8192) + 16 * 4
    else:
        assert p["rows"] == 256 and p["x_slots"] in (4, 8) and p["stages"] == p["boxes"] + 1
        assert p["smem"] == (1024 + p["stages"] * 32768 + p["x_slots"] * p["boxes"] * 8192
                             + 16 * (p["stages"] + p["x_slots"]))
    assert p["smem"] <= 232_448
    assert p["group_units"] * p["rows"] >= block_rows > (p["group_units"] - 1) * p["rows"]
    assert p["hi_rows"] % 128 == 0 and p["hi_rows"] >= block_rows > p["hi_rows"] - 128
    assert p["image_bytes"] == m * p["boxes"] * 256 * 64 * 2
    assert p["w_bytes"] == p["units"] * p["image_bytes"]
    assert p["hi_w_bytes"] == -(-n // 128) * m * 256 * d * 4


def test_mpacked_plan_w_bytes_at_the_script_shape():
    """At 1M x 128 against 8 x 256: "default" reads the 512 KiB image
    once a 256-row unit, 3,907 x 512 KiB = 2.05 GB a call, with eight x
    slots (two units' m-tiles) and a ring of three boxes (a subspace and
    one ahead); "highest" reads the 1 MiB of W transposed once a 128-row
    tile, 7,813 x 1 MiB = 8.19 GB."""
    p = tmp.mpacked_plan(1_000_000, 128, 8)
    assert (p["rows"], p["x_slots"], p["stages"], p["streamed"]) == (256, 8, 3, False)
    assert p["w_bytes"] == 3907 * 8 * 2 * 32768 == 2_048_393_216
    assert p["hi_w_bytes"] == 7813 * 2048 * 128 * 4 == 8_192_524_288


@pytest.mark.parametrize("shape", [(128, 8), (40, 3), (16, 1), (300, 2)], ids=lambda s: "d%d-m%d" % s)
def test_mpacked_image_assembles_back_to_w(shape):
    """Every bf16 of :func:`mpacked_image`, read at the address the
    kernel's wgmma descriptor gives it (16-byte chunk ``p`` of column row
    ``j`` at ``p ^ (j % 8)``), is W's entry rounded to bf16; zero past d."""
    d, m = shape
    w = torch.from_numpy(_signed_wide((d, m * 256), 7))
    img = tmp.mpacked_image(w)
    boxes = -(-d // 64)
    assert img.shape == (m, boxes, 256, 8, 8) and img.dtype == torch.bfloat16
    bits = img.view(torch.int16).numpy()
    col = np.arange(256)[:, None]
    dep = np.arange(64)[None, :]
    logical = bits[:, :, col, (dep // 8) ^ (col % 8), dep % 8]  # [m, boxes, 256, 64]
    got = logical.transpose(1, 3, 0, 2).reshape(boxes * 64, m * 256)
    want = np.zeros_like(got)
    want[:d] = w.to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)


def _acc_map():
    """wgmma m64n256k16's f32 accumulator: thread ``t`` of the warpgroup
    (warp ``t // 32``, lane ``l``), register ``x`` -> (row, column):
    row 16 (t // 32) + l // 4 + 8 ((x // 2) % 2), column 8 (x // 4) +
    2 (l % 4) + x % 2 (csrc/mpacked_encode.cu, mtile_codes)."""
    t, x = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    lane = t % 32
    rows = 16 * (t // 32) + lane // 4 + 8 * ((x // 2) % 2)
    cols = 8 * (x // 4) + 2 * (lane % 4) + x % 2
    return rows, cols


def test_wgmma_accumulator_map_covers_every_cell_once():
    rows, cols = _acc_map()
    cells = rows * 256 + cols
    assert rows.min() == 0 and rows.max() == 63 and cols.min() == 0 and cols.max() == 255
    np.testing.assert_array_equal(np.sort(cells.ravel()), np.arange(64 * 256))
    # each thread holds 64 columns of each of its two rows, ascending in x
    for t in (0, 5, 37, 127):
        for h in (0, 1):
            mine = cols[t][(np.arange(128) // 2) % 2 == h]
            assert len(mine) == 64 and np.all(np.diff(mine) > 0)
            assert np.unique(rows[t][(np.arange(128) // 2) % 2 == h]).size == 1


def _quad_argmin(acc, cc):
    """The kernel's argmin of one m-tile, in numpy: each thread folds
    acc + cc over its columns 8j + fc (+1) from (NaN, 0) (the pair's
    fmin, its lower column unless only the upper is a number, taken where
    not >= the best and a number), then the quad (lanes 4g .. 4g + 3)
    keeps the lexicographic (orderable key, column) minimum."""
    rows, cols = _acc_map()
    scores = (acc + cc[None, :]).astype(np.float32)
    best = np.full((128, 2), np.nan, np.float32)
    bi = np.zeros((128, 2), np.int64)
    for t in range(128):
        for j in range(32):
            for h in range(2):
                x0 = 4 * j + 2 * h
                s0, s1 = scores[rows[t, x0], cols[t, x0]], scores[rows[t, x0 + 1], cols[t, x0 + 1]]
                lo = np.fmin(s0, s1)
                at = 8 * j if lo == s0 else 8 * j + 1
                if not (lo >= best[t, h]) and lo == lo:
                    best[t, h], bi[t, h] = lo, at
    key = ck.orderable_key(torch.from_numpy(best)).numpy()
    col = bi + 2 * (np.arange(128) % 4)[:, None]
    out = np.zeros(64, np.int64)
    for t in range(0, 128, 4):
        for h in range(2):
            k, c = min((key[q, h], col[q, h]) for q in range(t, t + 4))
            out[rows[t, 2 * h]] = c
    return out


@pytest.mark.parametrize("case", ["uniform", "ties", "nan", "signed"])
def test_quad_argmin_model_equals_int_argmin(case):
    """The register argmin over the accumulator map gives ``int_argmin``'s
    column on every row: ties (lowest column), +-0.0, NaN scores (never
    win; an all-NaN row gives 0), +-inf."""
    rng = np.random.default_rng(28)
    acc = rng.random((64, 256), dtype=np.float32)
    cc = rng.random(256, dtype=np.float32)
    if case == "ties":
        acc = np.round(acc * 4).astype(np.float32)
        cc = np.zeros(256, np.float32)
        acc[3] = 1.0
        acc[4, 200:] = -1.0
    elif case == "nan":
        acc[rng.random((64, 256)) < 0.3] = np.nan
        acc[5] = np.nan
        acc[6] = np.nan
        acc[6, 131] = np.inf
        acc[7, :] = np.inf
        acc[7, 9] = np.nan
    elif case == "signed":
        acc = np.where(rng.random((64, 256)) < 0.5, -acc, acc).astype(np.float32)
        acc[8] = 0.0
        acc[8, 17] = -0.0
        acc[9, 40] = -np.inf
        cc[:] = 0.0
    want = ck.int_argmin(torch.from_numpy(acc + cc[None, :]))[1].numpy()
    np.testing.assert_array_equal(_quad_argmin(acc, cc), want)


def _adc_inputs(k, q=5, m=4, n=1000):
    """Q = 5 (not a multiple of 8), n = 1000 (not a multiple of the
    256-row block), codes in [0, k)."""
    rng = np.random.default_rng(62 + k)
    tables = rng.random((q, m, k), dtype=np.float32)
    codes_t = rng.integers(0, k, (m, n)).astype(np.uint8)
    return tables, codes_t


_VARIANTS = {"kt": ({}, "adc_kt"), "gather": ({}, "adc_gather"),
             "gather1": ({"only": 1}, "adc_gather"), "floor": ({}, "adc_floor")}


@pytest.mark.parametrize("k", [256, 128], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_adc_variant_matches_jax(jav, variant, k):
    """k = 128 takes B3's single-gather branch on the TPU side."""
    kw, name = _VARIANTS[variant]
    tables, codes_t = _adc_inputs(k)
    want = np.asarray(getattr(jav, name)(tables, codes_t, 256, interpret=True, **kw))
    got = getattr(tav, name)(_t(tables), _t(codes_t), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [256, 128], ids=lambda k: f"k{k}")
def test_kt_and_gather_equal_k8_plain(k):
    tables, codes_t = _adc_inputs(k)
    want = ck.adc_lookup_plain(_t(tables), _t(codes_t).T)
    assert torch.equal(tav.adc_kt(_t(tables), _t(codes_t)), want)
    assert torch.equal(tav.adc_gather(_t(tables), _t(codes_t)), want)


def test_kt_code_out_of_range_adds_zero(jav):
    """B2's contract, the TPU's too: a code >= k matches no one-hot row."""
    tables, codes_t = _adc_inputs(100)
    codes_t[1, ::7] = 200
    want = np.asarray(jav.adc_kt(tables, codes_t, 256, interpret=True))
    got = tav.adc_kt(_t(tables), _t(codes_t))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ck.adc_lookup_plain(_t(tables), _t(codes_t).T))


def _signed_wide(shape, seed):
    """Signed normal f32 over +-2^[-30, 30), exact zeros and -0.0."""
    rng = np.random.default_rng(seed)
    mag = (1.0 + rng.random(shape)) * 2.0 ** rng.integers(-30, 30, shape)
    t = np.where(rng.random(shape) < 0.5, -mag, mag).astype(np.float32)
    t[rng.random(shape) < 0.05] = 0.0
    t[rng.random(shape) < 0.05] = -0.0
    return t


def test_split3_parts_sum_back_exactly():
    """``(hi + mid) + lo == t`` in f32 for signed, wide-range normal f32
    (the exactness B2's products rest on), and each part is bf16."""
    t = torch.from_numpy(_signed_wide((64, 8, 256), 3))
    hi, mid, lo = tav.split3(t)
    assert all(p.dtype == torch.bfloat16 for p in (hi, mid, lo))
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back, t.abs() * torch.sign(t) + 0.0)  # -0.0 rebuilds as +0.0
    assert torch.equal(back[t != 0], t[t != 0])


@pytest.mark.parametrize("shape", _ADC, ids=lambda s: "Q%d-m%d-k%d-n%d" % s)
def test_kt_plan_covers_every_card_shape(shape):
    """B2's plan at each shape of the card's tests: the groups cover Q,
    the units n (576 rows each), the k-steps the entries a u8 code can
    pick, the boxes the k-steps; slabs stay 1024-byte multiples (the
    swizzle's alignment) and at most 48 KB (three in the kernel's ring);
    the table bytes are every slab once a unit."""
    q, m, k, n = shape
    p = tav.kt_plan(q, m, k, n)
    assert p["entries"] == min(k, 256)
    assert p["groups"] * 32 >= q > (p["groups"] - 1) * 32
    assert p["units"] == -(-n // 576) * p["groups"]
    assert p["ksteps"] * 16 >= p["entries"] > (p["ksteps"] - 1) * 16
    assert p["boxes"] * 4 >= p["ksteps"] > (p["boxes"] - 1) * 4
    assert p["slab_bytes"] == p["boxes"] * 96 * 128 and p["slab_bytes"] % 1024 == 0
    assert p["slab_bytes"] <= 4 * 96 * 128
    assert p["table_bytes"] == p["units"] * m * p["slab_bytes"]


def test_kt_plan_table_bytes_at_the_script_shape():
    """At [128, 1M] from 8 x 256 tables: 1,737 units of 576 rows x 4
    groups, 1.5 MiB of parts a 576-row pass, 2.73 GB a call."""
    p = tav.kt_plan(128, 8, 256, 1_000_000)
    assert p["units"] == 1737 * 4
    assert p["table_bytes"] == 1737 * 3 * 128 * 8 * 256 * 2 == 2_732_064_768


@pytest.mark.parametrize("shape", [(5, 4, 256), (33, 2, 40), (64, 1, 16), (3, 3, 300)],
                         ids=lambda s: "Q%d-m%d-k%d" % s)
def test_kt_slabs_assemble_back_to_split3(shape):
    """Every bf16 of :func:`kt_slabs`, read at the address the kernel's
    wgmma descriptor gives it (16-byte chunk ``c`` of column row ``r`` at
    ``c ^ (r % 8)``), is the :func:`split3` part it stands for; the rest
    (queries past Q, entries past min(k, 256)) is zero."""
    q, m, k = shape
    tables = torch.from_numpy(_signed_wide(shape, 5))
    slabs = tav.kt_slabs(tables)
    p = tav.kt_plan(q, m, k, 1)
    g, b = p["groups"], p["boxes"]
    assert slabs.shape == (g, m, b, 96, 8, 8) and slabs.dtype == torch.bfloat16
    bits = slabs.view(torch.int16).numpy()
    col = np.arange(96)[:, None]
    ent = np.arange(64)[None, :]
    unswizzled = bits[..., col, (ent // 8) ^ (col % 8), ent % 8]  # [g, m, b, 96, 64]
    got = unswizzled.reshape(g, m, b, 3, 32, 64).transpose(3, 0, 4, 1, 2, 5)
    got = got.reshape(3, g * 32, m, b * 64)
    want = np.zeros_like(got)
    e = p["entries"]
    for i, part in enumerate(tav.split3(tables)):
        want[i, :q, :, :e] = part[:, :, :e].view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_code_out_of_range_adds_zero():
    """A code >= k adds 0.0 in B3, K8's rule. Held to the port's own
    plain versions only: the JAX function in interpret mode gives NaN
    there and TPU hardware is undefined."""
    tables, codes_t = _adc_inputs(100)
    codes_t[2, ::5] = 255
    k = tables.shape[2]
    want = np.zeros((tables.shape[0], codes_t.shape[1]), np.float32)
    for i, c in enumerate(codes_t.astype(np.int64)):  # f32 adds in subspace order
        want = want + np.where(c < k, tables[:, i, np.minimum(c, k - 1)], np.float32(0))
    got = tav.adc_gather(_t(tables), _t(codes_t))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ck.adc_lookup_plain(_t(tables), _t(codes_t).T))


def _wavefront_codes(kind, m, n, k=256):
    """``codes_t [m, n]``: random; all one code; or adversarial for a
    16-byte-entry layout like K8's: the 32 rows of every phase on distinct
    codes that are multiples of 8, so in one subspace all 8 lanes' entries
    fall in one 16-byte slot column of the banks."""
    rng = np.random.default_rng(28)
    if kind == "random":
        codes = rng.integers(0, k, (m, n))
    elif kind == "equal":
        codes = np.full((m, n), 7)
    else:
        codes = np.broadcast_to(8 * (np.arange(n) // 4 % 8) + 64 * (np.arange(n) // 32 % 4), (m, n))
    return torch.from_numpy(np.ascontiguousarray(codes).astype(np.uint8))


@pytest.mark.parametrize("m, only", [(8, 0), (8, 1), (8, 2), (7, 0), (7, 2), (3, 0), (3, 1),
                                     (1, 0)], ids=lambda v: str(v))
@pytest.mark.parametrize("kind", ["random", "equal", "adversarial"])
def test_gather_costs_one_wavefront_a_phase(kind, m, only):
    """B3's lane map at the paired tier: the two groups of a quarter-warp
    one subspace apart read opposite halves of the banks, so every phase
    of every 16-byte load takes one wavefront on any codes, odd subspace
    counts included (their idle step a row set); n = 2,053 leaves a
    ragged block step and row set."""
    n = 2053
    plan = tav.gather_plan(16, m, 256, n, only)
    assert plan["tier"] == "paired"
    waves = tav.gather_wavefronts(_wavefront_codes(kind, m, n), plan)
    s = only or m
    steps = plan["tiles"] * plan["steps"] + (s % 2 == 0)  # group 1's extra last step
    assert waves.numel() == steps * 16 * 4 * 4  # (step, warp, quarter, row) phases
    assert torch.equal(waves, torch.ones_like(waves))


@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_k8_lane_map_costs_more_than_two_wavefronts(kind):
    """The same count on K8's lane map (8 row sets of 4 rows a phase, one
    quad's 16-byte entries at a time) gives ~2.5 wavefronts a phase on
    random codes and 8 on the adversarial ones: the model tells the two
    layouts apart."""
    m, n = 8, 4096
    codes_t = _wavefront_codes(kind, m, n)
    plan = tav.gather_plan(128, m, 256, n)
    k8 = tav.gather_wavefronts(codes_t, plan, lane_map="k8")
    assert k8.numel() == n // 32 * m * 4
    mean = float(k8.double().mean())
    assert (2.0 < mean < 3.0) if kind == "random" else mean == 8.0
    b3 = tav.gather_wavefronts(codes_t, plan)
    assert torch.equal(b3, torch.ones_like(b3))


def test_gather_plan_at_the_twin_shape():
    """[128, 1M] from 8 x 256 tables: 16 queries a block in 8 groups, the
    paired tier, 4 lines of 256 x 128 bytes (128 KB, in the 227 KB
    window); only = 1 fills one subspace's half-lines, 32 KB."""
    p = tav.gather_plan(128, 8, 256, 1_000_000)
    assert (p["tier"], p["queries"], p["groups"], p["steps"]) == ("paired", 16, 8, 8)
    assert p["smem_bytes"] == 4 * 256 * 128 == 131_072 <= 227 * 1024
    assert p["tiles"] == -(-1_000_000 // 512)
    one = tav.gather_plan(128, 8, 256, 1_000_000, only=1)
    want = ("paired", 1, 2, 32_768)
    assert (one["tier"], one["subspaces"], one["steps"], one["smem_bytes"]) == want


@pytest.mark.parametrize("only", [0, 1], ids=lambda o: f"only{o}")
@pytest.mark.parametrize("shape", _ADC, ids=lambda s: "Q%d-m%d-k%d-n%d" % s)
def test_gather_plan_covers_every_card_shape(shape, only):
    """B3's plan at each shape of the card's tests: the groups cover Q in
    blocks of a multiple of 4 queries, at most 16; the paired tier
    wherever (subspaces + 1) / 2 lines of kp x 128 bytes fit the opt-in
    window (kp = k + 1 below k = 256), the device-memory tier (no shared
    bytes) elsewhere: m = 40 and 100 at k = 256, summed over all."""
    q, m, k, n = shape
    p = tav.gather_plan(q, m, k, n, only)
    s = only or m
    assert p["subspaces"] == s and p["steps"] == s + s % 2
    assert p["queries"] % 4 == 0 and 4 <= p["queries"] <= 16
    assert p["groups"] * p["queries"] >= q > (p["groups"] - 1) * p["queries"]
    assert p["kp"] == (k + 1 if k < 256 else 256)
    paired = -(-s // 2) * p["kp"] * 128
    assert p["tier"] == ("paired" if paired <= ck.SMEM_OPTIN else "device")
    assert p["smem_bytes"] == (paired if p["tier"] == "paired" else 0)
    assert (p["tier"] == "device") == (only == 0 and m in (40, 100))


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.strip()]


@pytest.mark.parametrize("twin", ["mpacked_encode", "adc_vmem_bench"])
def test_twin_main_prints_parity(capsys, twin):
    mod = {"mpacked_encode": tmp, "adc_vmem_bench": tav}[twin]
    assert mod.main(["--device", "cpu", "--n", "2000"] + (["--q", "5"] if twin == "adc_vmem_bench" else [])) == 0
    lines = _json_lines(capsys.readouterr().out)
    if twin == "mpacked_encode":
        ops = [line["op"] for line in lines]
        assert ops == ["mpacked_parity_highest", "mpacked_parity_default", "encode_shipped_fused",
                       "encode_mpacked_highest", "encode_mpacked_default", "encode_mpacked_bf16resident"]
        assert lines[0]["code_match"] == 1.0 and lines[0]["n"] == 2000
    else:
        assert [line["variant"] for line in lines] == ["xla", "old", "kt", "gather", "floor", "gather1"]
    assert all(line["parity"] for line in lines if "parity" in line)
    assert sum("parity" in line for line in lines) >= 3
    assert all(line["ms"] is None and line["device"] == "cpu" for line in lines if "ms" in line)


def test_twin_only_keeps_xla(capsys):
    tav.main(["--device", "cpu", "--n", "64", "--q", "3", "--only", "floor"])
    assert [line["variant"] for line in _json_lines(capsys.readouterr().out)] == ["xla", "floor"]


_BAD = {
    "precision": lambda: tmp.mpacked_encode(torch.zeros(4, 8), torch.zeros(8, 256), torch.zeros(256), "high"),
    "w_columns": lambda: tmp.mpacked_encode(torch.zeros(4, 8), torch.zeros(8, 200), torch.zeros(200)),
    "codes_dtype": lambda: tav.adc_gather(torch.zeros(2, 3, 4), torch.zeros(3, 9, dtype=torch.int32)),
    "only": lambda: tav.adc_gather(torch.zeros(2, 3, 4), torch.zeros(3, 9, dtype=torch.uint8), only=4),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_bad_inputs_raise(case):
    with pytest.raises(InvalidParameter):
        _BAD[case]()


def test_cpu_tensors_never_launch(enc):
    x, cb, w, cc = enc
    fns = (tmp.mpacked_encode, tav.adc_kt, tav.adc_gather, tav.adc_floor)
    before = [f.launches for f in fns]
    tmp.mpacked_encode(_t(x), _t(w), _t(cc), "default")
    tables, codes_t = _adc_inputs(16)
    for f in fns[1:]:
        f(_t(tables), _t(codes_t))
    assert [f.launches for f in fns] == before
